"""Kernel launches the host made in the traced window, per MSM."""


def read(r):
    return r.launches / r.msms
