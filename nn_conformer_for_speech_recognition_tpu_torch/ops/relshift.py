"""Transformer-XL relative shift and its adjoint, used by the plain rel-pos
attention and its plain backward.

Port of `nn_conformer_for_speech_recognition_tpu/ops/relshift.py`
(``rel_shift``, ``rel_shift_adjoint``).
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


def rel_shift_adjoint(ds: torch.Tensor) -> torch.Tensor:
    """(..., T, T) → (..., T, 2T-1): the exact adjoint (re-binning) of
    `rel_shift`: z[..., i, l] = ds[..., i, l - (T-1) + i] where that column
    is in range, else 0."""
    *lead, t, t2 = ds.shape
    if t2 != t:
        raise ValueError(f"rel_shift_adjoint wants (..., T, T), got {t} x {t2}")
    y = F.pad(ds, (0, t - 1))  # (..., T, 2T-1)
    q = F.pad(y.reshape(*lead, 2 * t - 1, t), (0, 0, 1, 0))  # (..., 2T, T)
    return q.reshape(*lead, t, 2 * t)[..., 1:]
