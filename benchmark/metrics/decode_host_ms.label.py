"""The host time of the pass's `label.decode` span, the rows' `WordVocab.decode_ids` into words, ms a
batch.
None where `benchmark.spans` finds no span table for the profiled calls."""

from benchmark import spans


def read(r):
    return spans.host_ms(r, "label", "label.decode")
