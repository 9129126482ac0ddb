"""Host time in the program's msm.set spans (a batch set's scalar copy,
then the enqueue of its plan, SMVP, BPR and exit), ms per MSM."""

from msm_bench import program


def read(r):
    return program.span_ms_per_msm(r, "msm.set")
