"""The device time of the pass's `label.forward` span (log-mel, the eval forward, greedy decode), ms a
batch.
None where `benchmark.spans` finds no span table for the profiled calls."""

from benchmark import spans


def read(r):
    return spans.device_ms(r, "label", "label.forward")
