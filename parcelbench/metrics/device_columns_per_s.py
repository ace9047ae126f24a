"""Columns completed per second over the whole window, on device tensors,
each call synchronised: every call's columns over the window's length."""


def read(run):
    return len(run.times) * run.columns / run.window_s
