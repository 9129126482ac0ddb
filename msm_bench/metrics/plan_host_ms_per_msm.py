"""Host time in the program's msm.plan spans (the enqueue of the digits,
the bucket plan, the BPR order and the path's own plan), ms per MSM."""

from msm_bench import program


def read(r):
    return program.span_ms_per_msm(r, "msm.plan")
