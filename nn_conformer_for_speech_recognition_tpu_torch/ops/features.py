"""Log-mel spectrogram featurisation in PyTorch.

    audio (B, S) → frames (B, T, n_fft) → |rFFT|² → mel matmul → log → norm

The numpy filterbank helpers are copies of the JAX package's
(`nn_conformer_for_speech_recognition_tpu/ops/features.py`), held equal to
them by ``tests/test_torch_features.py``.  ``log_mel_spectrogram`` is the
plain PyTorch reference (rFFT as two matmuls against the DFT basis, as in
the JAX package); ``make_featurizer`` sends a CUDA tensor through the
hand-written STFT/log-mel kernel (`ops/cuda/stft_logmel.py`) and keeps the
normalisation in plain PyTorch, as the JAX package keeps it in XLA.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig


def hz_to_mel(f: np.ndarray, htk: bool = False) -> np.ndarray:
    f = np.asarray(f, dtype=np.float64)
    if htk:
        return 2595.0 * np.log10(1.0 + f / 700.0)
    # Slaney: linear below 1 kHz, log above.
    f_min, f_sp = 0.0, 200.0 / 3
    mels = (f - f_min) / f_sp
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = f >= min_log_hz
    mels = np.where(above, min_log_mel + np.log(np.maximum(f, min_log_hz) / min_log_hz) / logstep, mels)
    return mels


def mel_to_hz(m: np.ndarray, htk: bool = False) -> np.ndarray:
    m = np.asarray(m, dtype=np.float64)
    if htk:
        return 700.0 * (10.0 ** (m / 2595.0) - 1.0)
    f_min, f_sp = 0.0, 200.0 / 3
    freqs = f_min + f_sp * m
    min_log_hz = 1000.0
    min_log_mel = (min_log_hz - f_min) / f_sp
    logstep = np.log(6.4) / 27.0
    above = m >= min_log_mel
    freqs = np.where(above, min_log_hz * np.exp(logstep * (m - min_log_mel)), freqs)
    return freqs


@functools.lru_cache(maxsize=16)
def mel_filterbank(
    sample_rate: int, n_fft: int, n_mels: int, fmin: float, fmax: float, htk: bool = False
) -> np.ndarray:
    """Slaney-normalised triangular mel filterbank, shape (n_fft//2+1, n_mels)."""
    n_bins = n_fft // 2 + 1
    fft_freqs = np.linspace(0.0, sample_rate / 2.0, n_bins)
    mel_pts = np.linspace(hz_to_mel(fmin, htk), hz_to_mel(fmax, htk), n_mels + 2)
    hz_pts = mel_to_hz(mel_pts, htk)
    fdiff = np.diff(hz_pts)
    ramps = hz_pts.reshape(-1, 1) - fft_freqs.reshape(1, -1)  # (n_mels+2, n_bins)
    lower = -ramps[:-2] / fdiff[:-1].reshape(-1, 1)
    upper = ramps[2:] / fdiff[1:].reshape(-1, 1)
    fb = np.maximum(0.0, np.minimum(lower, upper))  # (n_mels, n_bins)
    enorm = 2.0 / (hz_pts[2 : n_mels + 2] - hz_pts[:n_mels])
    fb *= enorm.reshape(-1, 1)
    return fb.T.astype(np.float32)  # (n_bins, n_mels)


@functools.lru_cache(maxsize=16)
def hann_window(win_length: int, n_fft: int) -> np.ndarray:
    """Periodic Hann window, zero-padded (centered) to n_fft."""
    w = 0.5 - 0.5 * np.cos(2.0 * np.pi * np.arange(win_length) / win_length)
    if win_length < n_fft:
        pad = n_fft - win_length
        w = np.pad(w, (pad // 2, pad - pad // 2))
    return w.astype(np.float32)


@functools.lru_cache(maxsize=16)
def dft_basis(n_fft: int) -> Tuple[np.ndarray, np.ndarray]:
    """Real/imag DFT basis matrices, each (n_fft, n_fft//2+1)."""
    n_bins = n_fft // 2 + 1
    n = np.arange(n_fft).reshape(-1, 1)
    k = np.arange(n_bins).reshape(1, -1)
    ang = -2.0 * np.pi * n * k / n_fft
    return np.cos(ang).astype(np.float32), np.sin(ang).astype(np.float32)


@functools.lru_cache(maxsize=8)
def feature_constants(config: FeatureConfig, device: torch.device):
    """(window, dft_real, dft_imag, mel_fb) as contiguous float32 tensors on
    ``device``, made once per (config, device) so a call does not copy them
    again: the plain version's constants (``log_mel_spectrogram``).  The
    kernel reads the window and ``mel_fb`` row-major from here too
    (``mel_filterbank`` returns a transposed, column-major array, hence the
    copy), and its basis and mel bands from `kernel_constants`."""
    real_b, imag_b = dft_basis(config.n_fft)
    arrays = (
        hann_window(config.win_length_, config.n_fft),
        real_b,
        imag_b,
        mel_filterbank(
            config.sample_rate, config.n_fft, config.n_mels, config.fmin,
            config.fmax_, config.htk,
        ),
    )
    return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(device) for a in arrays)


# The log-mel kernel's tiles (csrc/stft_logmel.cu: kKTile basis rows, which
# its ring stages divide, and kBins bins a pass): its basis is zero-padded to them
STFT_K_TILE, STFT_BIN_TILE = 128, 64


def _round_up(x: int, m: int) -> int:
    return -(-x // m) * m


@functools.lru_cache(maxsize=16)
def folded_dft_basis(n_fft: int) -> np.ndarray:
    """`dft_basis` as the kernel multiplies by it: (2, n_fft // 2, (n_fft + 1) // 2)
    float32, the cosine rows p = 1 .. n_fft // 2, then the sine rows
    p = n_fft // 2 + 1 .. n_fft - 1 (one zero row past them for an even
    n_fft), of the bins below the Nyquist bin.  With the frame folded over
    its mirror samples, v[p] = x[p] + x[n - p] and v[n - p] = x[n - p] - x[p]
    for 0 < p < n - p, re_k = v[0] + Σ v[p]·cos and im_k = Σ v[p]·sin over
    these rows: half the products of the unfolded basis.  The even n_fft's
    Nyquist bin, Σ (−1)^p v[p] over p ≤ n_fft // 2, is the kernel's own."""
    real_b, imag_b = dft_basis(n_fft)
    half, pairs = n_fft // 2, (n_fft + 1) // 2
    folded = np.zeros((2, half, pairs), np.float32)
    folded[0] = real_b[1 : half + 1, :pairs]
    folded[1, : n_fft - 1 - half] = imag_b[half + 1 :, :pairs]
    return folded


def mel_bands(mel_fb: np.ndarray) -> np.ndarray:
    """(n_mels, 2) int32: each mel's first and last bin with a nonzero weight
    in ``mel_fb`` (n_bins, n_mels); (1, 0), an empty range, for a mel with
    none.  Slaney and HTK filters are triangles, so each bin falls in at most
    two adjacent bands and the kernel's banded sum walks ~2 × n_bins
    weights a frame instead of n_bins × n_mels."""
    bands = np.tile(np.array([1, 0], np.int32), (mel_fb.shape[1], 1))
    for m in range(mel_fb.shape[1]):
        nz = np.flatnonzero(mel_fb[:, m])
        if nz.size:
            bands[m] = nz[0], nz[-1]
    return bands


@functools.lru_cache(maxsize=8)
def kernel_constants(config: FeatureConfig, device: torch.device):
    """The log-mel kernel's own tables on ``device``, made once per (config,
    device): `folded_dft_basis` zero-padded to (2, K, N) with K a multiple of
    `STFT_K_TILE` and N of `STFT_BIN_TILE`, and the int32 `mel_bands` of the
    filterbank."""
    folded = folded_dft_basis(config.n_fft)
    basis = np.zeros((2, _round_up(folded.shape[1], STFT_K_TILE), _round_up(folded.shape[2], STFT_BIN_TILE)),
                     np.float32)
    basis[:, : folded.shape[1], : folded.shape[2]] = folded
    mel_fb = mel_filterbank(
        config.sample_rate, config.n_fft, config.n_mels, config.fmin, config.fmax_, config.htk,
    )
    return tuple(torch.from_numpy(a).to(device) for a in (basis, mel_bands(mel_fb)))


def frame_signal(audio: torch.Tensor, n_fft: int, hop: int) -> torch.Tensor:
    """Centered framing (librosa semantics): reflect-pad n_fft//2 each side,
    then T = S//hop + 1 frames of length n_fft.  (B, S) → (B, T, n_fft)."""
    num_frames = audio.shape[-1] // hop + 1
    pad = n_fft // 2
    padded = F.pad(audio[:, None, :], (pad, pad), mode="reflect")[:, 0]
    needed = (num_frames - 1) * hop + n_fft
    return padded[:, :needed].unfold(-1, n_fft, hop)


def frame_lengths_of(audio_lengths: torch.Tensor, config: FeatureConfig) -> torch.Tensor:
    return audio_lengths // config.hop_length + 1


def log_mel_spectrogram(
    audio: torch.Tensor,
    config: FeatureConfig,
    audio_lengths: Optional[torch.Tensor] = None,
) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
    """Batched log-mel features: (B, S) float32 → (B, T, n_mels) and the
    (B,) frame lengths (or None).  Plain PyTorch; the reference for the
    kernel."""
    window, real_b, imag_b, mel_fb = feature_constants(config, audio.device)
    frames = frame_signal(audio.float(), config.n_fft, config.hop_length) * window
    re = frames @ real_b
    im = frames @ imag_b
    mel = (re * re + im * im) @ mel_fb
    logmel = torch.log(torch.clamp_min(mel, config.log_floor))
    frame_lengths = None
    if audio_lengths is not None:
        frame_lengths = frame_lengths_of(audio_lengths, config)
    return normalize_features(logmel, config.normalize, frame_lengths), frame_lengths


def normalize_features(
    feats: torch.Tensor, mode: str, frame_lengths: Optional[torch.Tensor] = None
) -> torch.Tensor:
    """Per-utterance normalisation over valid frames: 'minmax' | 'meanvar' |
    'none'."""
    if mode == "none":
        return feats
    if frame_lengths is not None:
        t = feats.shape[-2]
        mask = torch.arange(t, device=feats.device)[None, :, None] < frame_lengths[:, None, None]
    else:
        mask = torch.ones_like(feats, dtype=torch.bool)
    dims = (-2, -1)
    if mode == "minmax":
        big = torch.finfo(feats.dtype).max
        mn = torch.where(mask, feats, big).amin(dim=dims, keepdim=True)
        mx = torch.where(mask, feats, -big).amax(dim=dims, keepdim=True)
        out = (feats - mn) / torch.clamp_min(mx - mn, 1e-8)
    elif mode == "meanvar":
        denom = torch.clamp_min(mask.sum(dim=dims, keepdim=True), 1)
        mean = torch.where(mask, feats, 0.0).sum(dim=dims, keepdim=True) / denom
        var = torch.where(mask, (feats - mean) ** 2, 0.0).sum(dim=dims, keepdim=True) / denom
        out = (feats - mean) * torch.rsqrt(var + 1e-8)
    else:
        raise ValueError(f"unknown normalize mode {mode!r}")
    return torch.where(mask, out, 0.0)


def make_featurizer(config: FeatureConfig):
    """Returns ``featurize(audio, audio_lengths=None) → (features,
    frame_lengths)``.

    ``config.impl`` 'auto' or 'pallas' sends the spectrogram through the
    STFT/log-mel kernel wrapper (the kernel for a CUDA tensor, its plain twin
    for a CPU one); 'xla' keeps the plain PyTorch ops on every device.
    """
    if config.impl not in ("auto", "pallas", "xla"):
        raise ValueError(
            f"FeatureConfig.impl must be 'auto', 'pallas' or 'xla', got {config.impl!r}"
        )
    if config.impl == "xla":
        def featurize_plain(audio, audio_lengths=None):
            return log_mel_spectrogram(audio, config, audio_lengths)

        return featurize_plain

    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.stft_logmel import stft_logmel

    def featurize(audio, audio_lengths=None):
        logmel = stft_logmel(audio, config)
        frame_lengths = None
        if audio_lengths is not None:
            frame_lengths = frame_lengths_of(audio_lengths, config)
        return normalize_features(logmel, config.normalize, frame_lengths), frame_lengths

    return featurize
