"""The share of the traced window in which no kernel or copy ran, %."""


def read(r):
    return 100.0 * (1.0 - r.busy_s / r.window_s)
