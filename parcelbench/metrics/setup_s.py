"""Seconds from the process's start to the window's first call: imports,
the card's start, the inputs made from the seed, the kernel library (built
on a checkout's first run only), the tables (built on its first run only)
and the warm-up calls."""


def read(run):
    return run.setup_s
