"""The device time of the E-Branchformer blocks' `encoder.merge` spans (each block's merge module in the
training forward), summed over the blocks, ms a step.
None where `benchmark.spans` finds no span table for the profiled calls, or no such span."""

from benchmark import spans


def read(r):
    return spans.device_ms(r, "train", "encoder.merge")
