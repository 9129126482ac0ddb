"""Device time of PyTorch's own kernels (layers/plan.json: the plan's sort,
searchsorted and elementwise glue), ms per MSM."""


def read(r):
    return r.layer_s("plan") * 1e3 / r.msms
