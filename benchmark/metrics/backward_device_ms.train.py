"""The device time of the train step's `train.backward` span (autograd's backward, and the gradient
all-reduce under a process group), ms a step.
None where `benchmark.spans` finds no span table for the profiled calls."""

from benchmark import spans


def read(r):
    return spans.device_ms(r, "train", "train.backward")
