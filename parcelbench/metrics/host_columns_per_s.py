"""Columns completed per second over the whole window, host Dataset in to
host Dataset out: every call's columns over the window's length."""


def read(run):
    return len(run.times) * run.columns / run.window_s
