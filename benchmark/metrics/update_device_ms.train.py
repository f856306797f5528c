"""The device time of the train step's `train.grad_norm` and `train.optimizer` spans (the gradient norm,
Adafactor), ms a step.
None where `benchmark.spans` finds no span table for the profiled calls."""

from benchmark import spans


def read(r):
    return spans.device_ms(r, "train", "train.grad_norm", "train.optimizer")
