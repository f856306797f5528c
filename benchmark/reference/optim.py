"""Adafactor as ``optax.adafactor(lr, multiply_by_parameter_scale=False,
momentum, clipping_threshold)`` defines it (Shazeer and Stern 2018), in
plain float32, over a module's named parameters:

1. v ← β·v + (1-β)·(g² + 1e-30) with β = 1 - t^-0.8 at step t (from 1);
   for a parameter whose two largest axes are both ≥ 128, only the mean
   over the largest axis (r) and the mean over the second largest (c) are
   kept;
2. u = g / sqrt(v), or, factored, u = g · (r / mean(r))^-1/2 · c^-1/2
   (optax's order: the two factors are formed apart, so that a row and a
   column of near-zero moments never multiply into an underflow); then u
   is divided by max(1, rms(u) / clipping_threshold);
3. u ← lr·u; momentum m ← (1-μ)·u + μ·m, and u = m (no debiasing);
4. p ← p - u."""

from __future__ import annotations

from typing import Dict, Optional, Tuple

import numpy as np
import torch


def factored_axes(shape: Tuple[int, ...]) -> Optional[Tuple[int, int]]:
    if len(shape) < 2:
        return None
    order = np.argsort(shape, kind="stable")
    return None if shape[order[-2]] < 128 else (int(order[-2]), int(order[-1]))


class Adafactor:
    def __init__(self, module: torch.nn.Module, lr: float, momentum: Optional[float], clip: Optional[float]):
        self.params = list(module.named_parameters())
        self.lr, self.momentum, self.clip = lr, momentum, clip
        self.count = 0
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, p in self.params:
            axes = factored_axes(tuple(p.shape))
            st = {"v": torch.zeros_like(p)} if axes is None else {
                "r": torch.zeros_like(p.mean(dim=axes[1])), "c": torch.zeros_like(p.mean(dim=axes[0]))}
            if momentum is not None:
                st["m"] = torch.zeros_like(p)
            self.state[name] = st

    @torch.no_grad()
    def step(self) -> None:
        t = np.float32(self.count + 1)
        decay = np.float32(1.0) - t ** np.float32(-0.8)
        keep, take = float(decay), float(np.float32(1.0) - decay)
        for name, p in self.params:
            g, st = p.grad, self.state[name]
            g2 = g * g + 1e-30
            axes = factored_axes(tuple(p.shape))
            if axes is None:
                st["v"] = keep * st["v"] + take * g2
                u = g / st["v"].sqrt()
            else:
                second, largest = axes
                st["r"] = keep * st["r"] + take * g2.mean(dim=largest)
                st["c"] = keep * st["c"] + take * g2.mean(dim=second)
                # r has lost the largest axis: the second largest sits one lower if it came after it
                mean = st["r"].mean(dim=second - 1 if second > largest else second, keepdim=True)
                u = g * (st["r"] / mean).pow(-0.5).unsqueeze(largest) * st["c"].pow(-0.5).unsqueeze(second)
            if self.clip is not None:
                u = u / torch.clamp_min(u.square().mean().sqrt() / self.clip, 1.0)
            u = self.lr * u
            if self.momentum is not None:
                st["m"] = (1.0 - self.momentum) * u + self.momentum * st["m"]
                u = st["m"]
            p.sub_(u)
        self.count += 1
