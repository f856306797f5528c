"""The stft_logmel kernels' share of their roofline in the train step, in %: Σ least time (the yardstick's
bound for this cell's rows) ÷ Σ device time of their launches over the profiled calls."""


def read(r):
    return r.roofline("stft_logmel")
