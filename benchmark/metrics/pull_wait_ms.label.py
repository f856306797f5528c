"""The host time of the pass's `label.pull` span, the host waiting for a batch's ids, ms a batch.
None where `benchmark.spans` finds no span table for the profiled calls."""

from benchmark import spans


def read(r):
    return spans.host_ms(r, "label", "label.pull")
