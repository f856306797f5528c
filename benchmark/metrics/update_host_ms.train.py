"""The host time of the train step's `train.grad_norm` and `train.optimizer` spans (the launch loops of
the gradient norm and Adafactor), ms a step.
None where `benchmark.spans` finds no span table for the profiled calls."""

from benchmark import spans


def read(r):
    return spans.host_ms(r, "train", "train.grad_norm", "train.optimizer")
