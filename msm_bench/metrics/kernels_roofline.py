"""The yardstick's least time for the traced MSMs (work.py: their inputs'
bytes and additions at the card's peaks) over the device time of every
kernel in the traced window, %.  Nothing where the card has no row in
peaks.json or no kernel ran."""


def read(r):
    kernel_s = sum(r.kernel_s.values())
    if r.least_s is None or not kernel_s:
        return None
    return 100.0 * r.least_s / kernel_s
