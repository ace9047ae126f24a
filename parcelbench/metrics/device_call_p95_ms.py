"""The 95th percentile, in milliseconds, of every synchronised call of the
window, each call's wall time read between two CUDA events on the card's
clock (a host-clock reading of a call this short would carry the host
clock's half a millisecond).  None without a card."""

import numpy as np


def read(run):
    if not run.card_times:
        return None
    return float(np.percentile(run.card_times, 95)) * 1e3
