"""The device time of the train step's `train.augment` span (log-mel, waveform noise, SpecAugment), ms a step.
None where `benchmark.spans` finds no span table for the profiled calls."""

from benchmark import spans


def read(r):
    return spans.device_ms(r, "train", "train.augment")
