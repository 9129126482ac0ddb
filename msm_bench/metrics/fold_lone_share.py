"""The share of the buckets a packed finish cut into pieces that its fold
summed on one thread (unit share): the program's msm.fold_lone counter
over its msm.finish_split counter, each a mean over the finishes counted.
None where the program keeps either not."""

from msm_bench import program


def read(r):
    lone = program.counter_mean("msm.fold_lone")
    cut = program.counter_mean("msm.finish_split")
    if lone is None or cut is None:
        return None
    return lone / cut if cut else None
