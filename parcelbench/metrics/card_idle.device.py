"""Share of the traced window, in %, in which no kernel, memcpy or memset
ran on the card: 1 - the union of their intervals over the window.
The device cells' reading (moves device_columns_per_s)."""


def read(trace):
    share = trace.idle_share()
    return None if share is None else 100.0 * share
