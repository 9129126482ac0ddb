"""Device time of the BPR kernels (layers/bpr.json), ms per MSM."""


def read(r):
    return r.layer_s("bpr") * 1e3 / r.msms
