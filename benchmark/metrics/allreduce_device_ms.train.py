"""The device time of the data-parallel train step's `train.all_reduce` span (the all-reduce of the flat
gradient over the ranks, and the wait for the slowest rank), ms a step, on rank 0.
None where `benchmark.spans` finds no span table for the profiled calls, or no such span."""

from benchmark import spans


def read(r):
    return spans.device_ms(r, "train", "train.all_reduce")
