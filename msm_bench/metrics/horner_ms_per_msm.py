"""Host time in the program's msm.horner spans (the Horner across windows
and the affine conversion, with Python integers), ms per MSM."""

from msm_bench import program


def read(r):
    return program.span_ms_per_msm(r, "msm.horner")
