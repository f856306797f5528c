"""SpecAugment, port of `nn_conformer_for_speech_recognition_tpu/ops/specaugment.py`.

Split in two so that the arithmetic can be held to the JAX package although
the random streams of the two frameworks cannot match:

* `draw_specaugment` draws, per example, the time-warp centres and shifts
  and the mask starts, widths and active counts, on the features' device
  from an explicit ``torch.Generator``;
* `apply_specaugment` applies given draws: time warp (linear interpolation
  around the centre, identity in the padding), then frequency masks, then
  time masks within the valid frames.

The draws follow the JAX package's distributions: centre
``floor(U[W, max(tau - W, W + 1)))``, shift ``round(U[-W, W])`` (0 when
``tau <= 2W + 1``), width uniform in ``[0, max(max_width, 1)]``, start
uniform in ``[0, max(axis - width, 0)]``, with the adaptive time-mask size
``floor(ps * tau)`` and multiplicity ``min(Mt, floor(pm * tau))``.

The warp's interpolation is a gather; the JAX package's one-hot matmul was
a TPU workaround.
"""

from __future__ import annotations

import dataclasses
from typing import Optional

import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import SpecAugmentConfig


@dataclasses.dataclass
class SpecAugmentDraws:
    """Per-example draws; each tensor has the batch as its first axis."""

    warp_center: torch.Tensor  # (B, time_warp_n) float32
    warp_shift: torch.Tensor  # (B, time_warp_n) float32
    freq_start: torch.Tensor  # (B, freq_mask_n) int64
    freq_width: torch.Tensor  # (B, freq_mask_n) int64
    time_start: torch.Tensor  # (B, time_mask_n) int64
    time_width: torch.Tensor  # (B, time_mask_n) int64
    time_active: torch.Tensor  # (B,) int64: masks in use (adaptive multiplicity)

    def rows(self, rows: slice) -> "SpecAugmentDraws":
        """The draws of the given rows (a data-parallel rank's share)."""
        return SpecAugmentDraws(*(getattr(self, f.name)[rows] for f in dataclasses.fields(self)))


def _randint(generator: torch.Generator, high: torch.Tensor) -> torch.Tensor:
    """Uniform integers in [0, high) elementwise, high ≥ 1 (float32)."""
    u = torch.rand(high.shape, generator=generator, device=high.device)
    return torch.minimum(torch.floor(u * high), high - 1).to(torch.int64)


def draw_specaugment(
    frame_lengths: torch.Tensor, n_mels: int, cfg: SpecAugmentConfig, generator: torch.Generator
) -> SpecAugmentDraws:
    """Draws for a batch with (B,) valid frame counts, on their device
    (``generator`` lives there too)."""
    b, dev = frame_lengths.shape[0], frame_lengths.device
    tau = frame_lengths.to(torch.float32)[:, None]
    w = float(cfg.time_warp_w)
    n_warp = cfg.time_warp_n if cfg.time_warp_w > 0 else 0
    lo = torch.full_like(tau, w)
    hi = torch.maximum(tau - w, lo + 1.0)
    u = torch.rand((b, 2, n_warp), generator=generator, device=dev)
    center = torch.floor(lo + u[:, 0] * (hi - lo))
    shift = torch.where(tau > 2.0 * w + 1.0, torch.round(-w + u[:, 1] * 2.0 * w), 0.0)

    f_width = _randint(generator, torch.full((b, cfg.freq_mask_n), max(cfg.freq_mask_f, 1) + 1.0, device=dev))
    f_start = _randint(generator, torch.clamp_min(n_mels - f_width, 0).float() + 1.0)

    t_param = torch.full_like(tau, float(cfg.time_mask_t))
    if cfg.adaptive_size:
        t_param = torch.floor(cfg.ps * tau)
    active = torch.full((b,), cfg.time_mask_n, dtype=torch.int64, device=dev)
    if cfg.adaptive_multiplicity:
        active = torch.minimum(active, torch.floor(cfg.pm * tau[:, 0]).to(torch.int64))
    t_width = _randint(generator, (torch.clamp_min(t_param, 1.0) + 1.0).expand(b, cfg.time_mask_n))
    t_start = _randint(generator, torch.clamp_min(tau - t_width, 0.0) + 1.0)
    return SpecAugmentDraws(center, shift, f_start, f_width, t_start, t_width, active)


def _time_warp(x: torch.Tensor, tau: torch.Tensor, w0: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """Warp the time axis of (B, T, F) within each row's valid length; the
    padding maps to itself."""
    t = x.shape[1]
    pos = torch.arange(t, device=x.device, dtype=torch.float32)[None, :]
    pivot = w0 + w
    left = pos * (w0 / torch.clamp_min(pivot, 1.0))
    right = w0 + (pos - pivot) * ((tau - 1.0 - w0) / torch.clamp_min(tau - 1.0 - pivot, 1.0))
    src = torch.where(pos <= pivot, left, right)
    src = torch.minimum(torch.maximum(src, torch.zeros_like(src)), tau - 1.0)
    src = torch.where(pos < tau, src, pos)  # identity in padding (after the clip)
    i0 = torch.floor(src).to(torch.int64)
    i1 = torch.clamp_max(i0 + 1, t - 1)
    frac = (src - i0.to(torch.float32))[..., None]
    f = x.shape[2]
    lo = torch.gather(x, 1, i0[..., None].expand(-1, -1, f))
    hi = torch.gather(x, 1, i1[..., None].expand(-1, -1, f))
    return (lo * (1.0 - frac) + hi * frac).to(x.dtype)


def _span_mask(size: int, start: torch.Tensor, width: torch.Tensor, active: torch.Tensor) -> torch.Tensor:
    """(B, n) spans, the first ``active`` of each row in use → (B, size)."""
    coords = torch.arange(size, device=start.device)[None, None, :]
    spans = (coords >= start[..., None]) & (coords < (start + width)[..., None])
    in_use = torch.arange(start.shape[1], device=start.device)[None, :] < active[:, None]
    return (spans & in_use[..., None]).any(dim=1)


def apply_specaugment(
    features: torch.Tensor, frame_lengths: torch.Tensor, draws: SpecAugmentDraws, cfg: SpecAugmentConfig
) -> torch.Tensor:
    """(B, T, n_mels) features → augmented features, with the given draws."""
    b, t, n_mels = features.shape
    x = features
    tau = frame_lengths.to(torch.float32)[:, None]
    if cfg.time_warp_w > 0:
        for i in range(cfg.time_warp_n):
            x = _time_warp(x, tau, draws.warp_center[:, i:i + 1], draws.warp_shift[:, i:i + 1])
    every = torch.full((b,), cfg.freq_mask_n, device=x.device)
    freq = _span_mask(n_mels, draws.freq_start, draws.freq_width, every)
    x = torch.where(freq[:, None, :], cfg.mask_value, x)
    time = _span_mask(t, draws.time_start, draws.time_width, draws.time_active)
    return torch.where(time[:, :, None], cfg.mask_value, x)


def specaugment(
    features: torch.Tensor, frame_lengths: torch.Tensor, cfg: SpecAugmentConfig, generator: torch.Generator
) -> torch.Tensor:
    """Draw and apply in one call."""
    draws = draw_specaugment(frame_lengths, features.shape[2], cfg, generator)
    return apply_specaugment(features, frame_lengths, draws, cfg)


def add_gaussian_noise(
    audio: torch.Tensor, generator: torch.Generator, std: float = 0.01, batch: Optional[int] = None,
    rows: slice = slice(None),
) -> torch.Tensor:
    """Waveform-level gaussian noise.  Where ``audio`` holds the ``rows`` of
    a global batch of ``batch`` rows (a data-parallel rank's share), the
    noise is drawn for the global batch and those rows of it are added."""
    shape = audio.shape if batch is None else (batch, audio.shape[1])
    noise = torch.randn(shape, generator=generator, device=audio.device, dtype=audio.dtype)
    return audio + std * noise[rows]
