"""Device time of host-to-device copies in the traced window, ms per MSM."""


def read(r):
    return r.h2d_s() * 1e3 / r.msms
