"""Layers that keep float32 parameters and compute in the input's dtype,
as flax's ``dtype=`` does, plus flax's SAME padding rule."""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

# flax.linen.LayerNorm's default epsilon (torch's is 1e-5)
LAYER_NORM_EPS = 1e-6


class Linear(nn.Linear):
    """nn.Linear that casts its float32 weights to the input's dtype."""

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        bias = None if self.bias is None else self.bias.to(x.dtype)
        return F.linear(x, self.weight.to(x.dtype), bias)


class LayerNorm(nn.LayerNorm):
    """nn.LayerNorm with flax's epsilon, computing in the input's dtype."""

    def __init__(self, dim: int):
        super().__init__(dim, eps=LAYER_NORM_EPS)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        return F.layer_norm(
            x, self.normalized_shape, self.weight.to(x.dtype), self.bias.to(x.dtype), self.eps
        )


def same_padding(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax/XLA 'SAME': the odd element goes high."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2
