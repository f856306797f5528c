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


class GroupNorm(nn.Module):
    """flax.linen.GroupNorm (32 groups, epsilon 1e-6) over the channels of
    (B, T, C): each group of C/32 adjacent channels is normalised over all
    of a row's frames, padded ones included (flax's takes no mask).  As
    flax does under a lower compute dtype, the statistics (E[x²] − E[x]²,
    clipped at 0) and the normalisation run in float32 and the result is
    cast back to the input's dtype."""

    def __init__(self, channels: int, num_groups: int = 32, eps: float = LAYER_NORM_EPS):
        super().__init__()
        if channels % num_groups:
            raise ValueError(f"GroupNorm: {channels} channels do not split into {num_groups} groups")
        self.num_groups, self.eps = num_groups, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        b, t, c = x.shape
        xf = x.to(torch.promote_types(x.dtype, torch.float32)).reshape(b, t, self.num_groups, c // self.num_groups)
        mean = xf.mean(dim=(1, 3), keepdim=True)
        var = torch.clamp_min((xf * xf).mean(dim=(1, 3), keepdim=True) - mean * mean, 0.0)
        y = ((xf - mean) * torch.rsqrt(var + self.eps)).reshape(b, t, c)
        return (y * self.weight + self.bias).to(x.dtype)


def same_padding(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """(low, high) padding of flax/XLA 'SAME': the odd element goes high."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2
