"""The device's idle share of the profiled calls, in %: 1 - the union of its operations' intervals over
the span from the first profiled call's start to the last one's end."""


def read(r):
    return 100.0 * (1.0 - r.trace.busy_s / r.trace.span_s)
