"""Device time of the SMVP kernels (layers/smvp.json), ms per MSM."""


def read(r):
    return r.layer_s("smvp") * 1e3 / r.msms
