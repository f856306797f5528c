"""Plain float32 operations of the reference, written from the published
definitions the port follows (librosa-style log-mel with Slaney mels,
SpecAugment, Graves' CTC forward recursion, the LSTM cell, Transformer-XL
relative positions).  The random draws of SpecAugment follow the program's
documented recipe, so that the reference, given the same generator seed,
draws the same masks."""

from __future__ import annotations

import dataclasses
from typing import Callable, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

NEG = -1e30


def fp8_round(x: torch.Tensor) -> torch.Tensor:
    """``x`` rounded to float8 e4m3 with one scale per tensor (its largest
    magnitude at e4m3's largest finite value, 448), back in x's dtype: an
    fp8 matmul's input.  The control's precision."""
    scale = torch.clamp_min(x.detach().abs().amax().float(), 1e-30) / 448.0
    return ((x / scale).to(torch.float8_e4m3fn).to(x.dtype)) * scale


class _Straight(torch.autograd.Function):
    """Rounds in the forward, passes the gradient through: the gradient of a
    product whose inputs were rounded (fp8 training rounds the backward's
    inputs again; `Rounding` rounds them where they enter a product)."""

    @staticmethod
    def forward(ctx, x, fn):
        return fn(x)

    @staticmethod
    def backward(ctx, g):
        return g, None


@dataclasses.dataclass(frozen=True)
class Rounding:
    """Where the configuration computes a product in its compute dtype,
    ``inputs`` rounds the product's inputs: identity for the float32
    reference, `fp8_round` for the control."""

    fn: Optional[Callable[[torch.Tensor], torch.Tensor]] = None

    def __call__(self, x: torch.Tensor) -> torch.Tensor:
        if self.fn is None:
            return x
        return _Straight.apply(x, self.fn)


# --------------------------------------------------------------- log-mel


def hz_to_mel(f):
    f = np.asarray(f, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(f >= min_log_hz, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, f / f_sp)


def mel_to_hz(m):
    m = np.asarray(m, dtype=np.float64)
    f_sp, min_log_hz = 200.0 / 3, 1000.0
    min_log_mel, logstep = min_log_hz / f_sp, np.log(6.4) / 27.0
    return np.where(m >= min_log_mel, min_log_hz * np.exp(logstep * (m - min_log_mel)), f_sp * m)


def mel_filterbank(sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float) -> np.ndarray:
    """Slaney-normalised triangles, (n_fft // 2 + 1, n_mels) float32."""
    bins = np.linspace(0.0, sample_rate / 2.0, n_fft // 2 + 1)
    hz = mel_to_hz(np.linspace(hz_to_mel(fmin), hz_to_mel(fmax), n_mels + 2))
    ramps = hz[:, None] - bins[None, :]
    lower = -ramps[:-2] / np.diff(hz)[:-1, None]
    upper = ramps[2:] / np.diff(hz)[1:, None]
    fb = np.maximum(0.0, np.minimum(lower, upper)) * (2.0 / (hz[2:] - hz[:n_mels]))[:, None]
    return fb.T.astype(np.float32)


def log_mel(audio: torch.Tensor, lengths: torch.Tensor, feat: dict) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) float32 audio → per-row min-max normalised log-mel (B, T,
    n_mels) over the valid frames (0 elsewhere) and the (B,) frame counts:
    centred frames (reflect padding), a periodic Hann window of
    ``win_length`` centred in each ``n_fft`` frame, |DFT|² against
    the Slaney filterbank, log with a floor."""
    n_fft, hop = feat["n_fft"], feat["hop_length"]
    win = feat.get("win_length") or n_fft
    dev = audio.device
    n = np.arange(n_fft)
    left = (n_fft - win) // 2  # a shorter window sits in the middle of the frame, zeros around it
    hann = np.zeros(n_fft)
    hann[left:left + win] = 0.5 - 0.5 * np.cos(2 * np.pi * np.arange(win) / win)
    window = torch.from_numpy(hann.astype(np.float32)).to(dev)
    k = np.arange(n_fft // 2 + 1)
    ang = -2.0 * np.pi * n[:, None] * k[None, :] / n_fft
    cos = torch.from_numpy(np.cos(ang).astype(np.float32)).to(dev)
    sin = torch.from_numpy(np.sin(ang).astype(np.float32)).to(dev)
    fmax = feat["fmax"] if feat.get("fmax") is not None else feat["sample_rate"] / 2.0
    fb = torch.from_numpy(mel_filterbank(feat["sample_rate"], n_fft, feat["n_mels"], feat["fmin"], fmax)).to(dev)
    t = audio.shape[1] // hop + 1
    padded = F.pad(audio[:, None, :], (n_fft // 2, n_fft // 2), mode="reflect")[:, 0]
    frames = padded[:, : (t - 1) * hop + n_fft].unfold(-1, n_fft, hop) * window
    re, im = frames @ cos, frames @ sin
    logmel = torch.log(torch.clamp_min((re * re + im * im) @ fb, feat["log_floor"]))
    frame_lengths = lengths // hop + 1
    mask = (torch.arange(t, device=dev)[None, :] < frame_lengths[:, None])[..., None]
    big = torch.finfo(logmel.dtype).max
    lo = torch.where(mask, logmel, big).amin(dim=(1, 2), keepdim=True)
    hi = torch.where(mask, logmel, -big).amax(dim=(1, 2), keepdim=True)
    return torch.where(mask, (logmel - lo) / torch.clamp_min(hi - lo, 1e-8), 0.0), frame_lengths


# ----------------------------------------------------------- SpecAugment


def _randint(gen: torch.Generator, high: torch.Tensor) -> torch.Tensor:
    u = torch.rand(high.shape, generator=gen, device=high.device)
    return torch.minimum(torch.floor(u * high), high - 1).to(torch.int64)


def specaugment(x: torch.Tensor, frame_lengths: torch.Tensor, sa: dict, gen: torch.Generator) -> torch.Tensor:
    """Draws from ``gen`` (the warp centre and shift as one (B, 2, n) uniform
    draw, then the frequency widths and starts, then the time widths and
    starts) and applies: time warp within the valid frames by linear
    interpolation, then the frequency masks, then the time masks."""
    b, t, n_mels = x.shape
    dev = x.device
    tau = frame_lengths.to(torch.float32)[:, None]
    w = float(sa["time_warp_w"])
    n_warp = sa["time_warp_n"] if sa["time_warp_w"] > 0 else 0
    lo = torch.full_like(tau, w)
    hi = torch.maximum(tau - w, lo + 1.0)
    u = torch.rand((b, 2, n_warp), generator=gen, device=dev)
    center = torch.floor(lo + u[:, 0] * (hi - lo))
    shift = torch.where(tau > 2.0 * w + 1.0, torch.round(-w + u[:, 1] * 2.0 * w), 0.0)
    f_width = _randint(gen, torch.full((b, sa["freq_mask_n"]), max(sa["freq_mask_f"], 1) + 1.0, device=dev))
    f_start = _randint(gen, torch.clamp_min(n_mels - f_width, 0).float() + 1.0)
    t_param = torch.full_like(tau, float(sa["time_mask_t"]))
    if sa["adaptive_size"]:
        t_param = torch.floor(sa["ps"] * tau)
    active = torch.full((b,), sa["time_mask_n"], dtype=torch.int64, device=dev)
    if sa["adaptive_multiplicity"]:
        active = torch.minimum(active, torch.floor(sa["pm"] * tau[:, 0]).to(torch.int64))
    t_width = _randint(gen, (torch.clamp_min(t_param, 1.0) + 1.0).expand(b, sa["time_mask_n"]))
    t_start = _randint(gen, torch.clamp_min(tau - t_width, 0.0) + 1.0)

    pos = torch.arange(t, device=dev, dtype=torch.float32)[None, :]
    for i in range(n_warp):
        w0, ws = center[:, i : i + 1], shift[:, i : i + 1]
        pivot = w0 + ws
        src = torch.where(pos <= pivot, pos * (w0 / torch.clamp_min(pivot, 1.0)),
                          w0 + (pos - pivot) * ((tau - 1.0 - w0) / torch.clamp_min(tau - 1.0 - pivot, 1.0)))
        src = torch.minimum(torch.clamp_min(src, 0.0), tau - 1.0)
        src = torch.where(pos < tau, src, pos)
        i0 = torch.floor(src).to(torch.int64)
        i1 = torch.clamp_max(i0 + 1, t - 1)
        frac = (src - i0.to(torch.float32))[..., None]
        x = (torch.gather(x, 1, i0[..., None].expand(-1, -1, n_mels)) * (1.0 - frac)
             + torch.gather(x, 1, i1[..., None].expand(-1, -1, n_mels)) * frac)

    def spans(size, start, width, in_use):
        c = torch.arange(size, device=dev)[None, None, :]
        inside = (c >= start[..., None]) & (c < (start + width)[..., None])
        used = torch.arange(start.shape[1], device=dev)[None, :] < in_use[:, None]
        return (inside & used[..., None]).any(dim=1)

    x = torch.where(spans(n_mels, f_start, f_width, torch.full((b,), sa["freq_mask_n"], device=dev))[:, None, :],
                    sa["mask_value"], x)
    return torch.where(spans(t, t_start, t_width, active)[:, :, None], sa["mask_value"], x)


# ------------------------------------------------------------------ CTC


def ctc_nll(log_probs: torch.Tensor, labels: torch.Tensor, input_lengths: torch.Tensor,
            label_lengths: torch.Tensor, blank: int) -> torch.Tensor:
    """(B,) negative log-likelihood of each row's label sequence under the
    per-frame distributions, by the forward (alpha) recursion over the
    blank-interleaved labels in log space; 0 for a row with no alignment.
    Differentiated by autograd."""
    b, l = labels.shape
    s = 2 * l + 1
    dev = log_probs.device
    ext = torch.full((b, s), blank, dtype=torch.int64, device=dev)
    ext[:, 1::2] = labels.to(torch.int64)
    prev2 = torch.cat([torch.full_like(ext[:, :2], -1), ext[:, :-2]], dim=1)
    pos = torch.arange(s, device=dev)[None, :]
    can_skip = (pos % 2 == 1) & (ext != prev2)
    ext_len = 2 * label_lengths.to(dev).to(torch.int64) + 1
    valid = pos < ext_len[:, None]
    emit = torch.gather(log_probs.float(), 2, ext[:, None, :].expand(b, log_probs.shape[1], s))
    neg = torch.full_like(emit[:, 0], NEG)
    alpha = torch.where((pos < 2) & valid, emit[:, 0], neg)
    for ti in range(1, emit.shape[1]):
        a1 = torch.cat([neg[:, :1], alpha[:, :-1]], dim=1)
        a2 = torch.where(can_skip, torch.cat([neg[:, :2], alpha[:, :-2]], dim=1), NEG)
        m = torch.maximum(torch.maximum(alpha, a1), a2)
        m_safe = torch.where(m <= NEG, 0.0, m)
        total = torch.exp(alpha - m_safe) + torch.exp(a1 - m_safe) + torch.exp(a2 - m_safe)
        new = torch.where(m <= NEG, NEG, m_safe + torch.log(torch.clamp_min(total, 1e-37))) + emit[:, ti]
        new = torch.where(valid, new, NEG)
        alpha = torch.where((ti < input_lengths.to(dev))[:, None], new, alpha)
    end = (pos == (ext_len - 1)[:, None]) | ((pos == (ext_len - 2)[:, None]) & (ext_len >= 2)[:, None])
    a_end = torch.where(end, alpha, NEG)
    m = a_end.max(dim=1).values
    dead = m <= NEG / 2
    m_safe = torch.where(dead, 0.0, m)
    ll = m_safe + torch.log(torch.clamp_min(torch.exp(a_end - m_safe[:, None]).sum(dim=1), 1e-37))
    return torch.where(dead, 0.0, -ll)


# ------------------------------------------------------------ recurrences


def lstm_direction(xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, reverse: bool) -> torch.Tensor:
    """One LSTM direction over (B, T, 4H) input projections (gates i, f, g,
    o), float32; a row's state is held through its padded steps (zero
    before a reversed row's first valid step).  (B, T, H) hidden states."""
    b, t, h4 = xw.shape
    hx = xw.new_zeros(b, h4 // 4)
    cx = xw.new_zeros(b, h4 // 4)
    hs = [None] * t
    for ti in (range(t - 1, -1, -1) if reverse else range(t)):
        i, f, g, o = (xw[:, ti] + hx @ w_hh).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * cx + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        active = (ti < lengths)[:, None]
        hx, cx = torch.where(active, h_new, hx), torch.where(active, c_new, cx)
        hs[ti] = hx
    return torch.stack(hs, dim=1)


# ------------------------------------------------------- relative positions


def sinusoidal_table(t: int, d: int) -> np.ndarray:
    """(2T-1, d) sinusoids of the distances -(T-1) .. T-1: sines, then cosines."""
    dist = np.arange(-(t - 1), t, dtype=np.float32)
    inv = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = dist[:, None] * inv[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def rel_shift(x: torch.Tensor) -> torch.Tensor:
    """(..., T, 2T-1) → (..., T, T): y[i, j] = x[i, j - i + T - 1]."""
    *lead, t, l = x.shape
    p = F.pad(x, (1, 0)).reshape(*lead, 2 * t, t)[..., 1:, :]
    return p.reshape(*lead, t, 2 * t - 1)[..., :t]


def same_padding(n: int, kernel: int, stride: int) -> Tuple[int, int]:
    """XLA 'SAME' padding (the odd element high)."""
    total = max((-(-n // stride) - 1) * stride + kernel - n, 0)
    return total // 2, total - total // 2
