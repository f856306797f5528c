"""The device's idle time under the `train.grad_norm` and `train.optimizer` spans, in % of the profiled
span.
None where `benchmark.spans` finds no span table for the profiled calls."""

from benchmark import spans


def read(r):
    return spans.idle_share(r, "train", "train.grad_norm", "train.optimizer")
