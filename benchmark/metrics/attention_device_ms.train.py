"""The device time of the `encoder.attention` spans (each block's attention core in the training forward, from
the biased queries to the heads' output before the output projection), summed over the blocks, ms a step.
None where `benchmark.spans` finds no span table for the profiled calls, or no such span."""

from benchmark import spans


def read(r):
    return spans.device_ms(r, "train", "encoder.attention")
