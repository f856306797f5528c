"""The device's idle time under the `label.decode` span, in % of the profiled span.
None where `benchmark.spans` finds no span table for the profiled calls."""

from benchmark import spans


def read(r):
    return spans.idle_share(r, "label", "label.decode")
