"""The card's peak of allocated memory from the window's start (after a reset) to the end of the
profiled calls, in GiB."""


def read(r):
    return r.peak_mem_bytes / 2 ** 30
