"""The buckets the packed finish cut into two or more pieces, averaged
over the window's finishes (unit buckets/finish): the program's
msm.finish_split counter summed, over the finishes it counted.  None
where the program keeps no such counter."""

from msm_bench import program


def read(r):
    return program.counter_mean("msm.finish_split")
