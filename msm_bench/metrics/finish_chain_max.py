"""The longest chain of dependent adds that one thread of the packed
finish walks, averaged over the window's finishes (unit adds/finish):
the program's msm.finish_chain counter (each finish's largest node count
of a bucket) summed, over the finishes it counted.  A mean of maxima,
not the window's maximum."""

from msm_bench import program


def read(r):
    return program.counter_mean("msm.finish_chain")
