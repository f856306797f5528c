"""The whole batch's share of the card's dense bf16 peak, in %: the yardstick's model FLOPs of a
batch at the padded shapes, times the batches of the measured window, over the window's time."""


def read(r):
    return 100.0 * r.window_calls * r.steps_per_call * r.flops_per_step / r.window_s / r.peak_flops
