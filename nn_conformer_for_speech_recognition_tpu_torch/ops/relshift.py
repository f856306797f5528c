"""Transformer-XL relative shift, used by the plain rel-pos attention.

Port of `nn_conformer_for_speech_recognition_tpu/ops/relshift.py:rel_shift`.
"""

from __future__ import annotations

import torch
import torch.nn.functional as F


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(..., T, 2T-1) → (..., T, T): y[..., i, j] = x[..., i, j - i + T - 1]."""
    *lead, t, l = x.shape
    if l != 2 * t - 1:
        raise ValueError(f"rel_shift wants (..., T, 2T-1), got T={t}, L={l}")
    p = F.pad(x, (1, 0))  # (..., T, 2T)
    q = p.reshape(*lead, 2 * t, t)[..., 1:, :]  # (..., 2T-1, T)
    return q.reshape(*lead, t, 2 * t - 1)[..., :t]
