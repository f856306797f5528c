"""The device time of the train step's `train.forward` span (zero_grad, the model's forward, the CTC
loss), ms a step.
None where `benchmark.spans` finds no span table for the profiled calls."""

from benchmark import spans


def read(r):
    return spans.device_ms(r, "train", "train.forward")
