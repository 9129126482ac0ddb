"""Host time in the program's msm.copy spans (words_to_device: the pinned
buffer's fill, the wait on its fill threads, the copies' enqueue), ms per
MSM."""

from msm_bench import program


def read(r):
    return program.span_ms_per_msm(r, "msm.copy")
