"""Kernels launched a step, over the profiled calls (the profiler's kernel rows)."""


def read(r):
    return r.trace.launches / r.profiled_steps
