"""The card's ``max_memory_allocated`` over the window, in GiB: the
program's working memory and, in device cells, the inputs it is handed.
None where no card was used."""


def read(run):
    return run.peak_bytes / 2.0 ** 30 if run.peak_bytes else None
