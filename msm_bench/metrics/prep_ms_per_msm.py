"""Device time of the point prep and the Montgomery exit (layers/prep.json),
ms per MSM."""


def read(r):
    return r.layer_s("prep") * 1e3 / r.msms
