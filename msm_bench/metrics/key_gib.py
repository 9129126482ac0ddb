"""The device memory of the key a resident call's sets run over, in GiB:
the program's msm.key_bytes counter (the bytes of the table that its
resident bases hold, one value a set) averaged over the sets it counted."""

from msm_bench import program


def read(r):
    got = program.counter_mean("msm.key_bytes")
    return None if got is None else got / 2**30
