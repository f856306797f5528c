"""Fused STFT → power → mel → log: kernel wrapper and plain twin.

Replaces the TPU kernel
`nn_conformer_for_speech_recognition_tpu/ops/pallas/stft_logmel.py:_stft_logmel_kernel`
(called through ``stft_logmel_pallas``).  The CUDA kernel
(`csrc/stft_logmel.cu`) gives one block to each (batch row, tile of 8
frames): it reads the frames straight from the audio by index, reflecting
at both ends (no padded copy and no im2col), applies the Hann window into
shared memory, accumulates the rFFT against the DFT bases and the mel
matmul in float32, and writes log(max(mel, floor)).

What bounds it on the H100: every block streams both DFT bases
(2 × n_fft × n_bins floats, 1 MB at n_fft=512) from L2, eight frames per
pass, so at (16, 480000) the L2→SM traffic (~1.9 GB) and the float32 FMAs
(~8 GFLOP, no tensor cores) are about even.  The design keeps frames,
spectrum and mel out of device memory entirely, which the plain version
does not; more frames per block and a tensor-core DFT are later work.

The TPU kernel's 128-lane padding, its whole-row/time-tiled split and its
fallback to the reference for other geometries were TPU constraints: the
CUDA kernel takes any hop and n_fft.
"""

from __future__ import annotations

import dataclasses

import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig
from nn_conformer_for_speech_recognition_tpu_torch.ops import features as F


def stft_logmel_plain(audio: torch.Tensor, config: FeatureConfig) -> torch.Tensor:
    """(B, S) float32 audio → (B, S//hop + 1, n_mels) log-mel, plain PyTorch."""
    out, _ = F.log_mel_spectrogram(audio, dataclasses.replace(config, normalize="none"))
    return out


def stft_logmel(audio: torch.Tensor, config: FeatureConfig) -> torch.Tensor:
    """(B, S) float32 audio → (B, S//hop + 1, n_mels) log-mel (no
    normalisation).  The kernel for a CUDA tensor, the plain twin for a CPU
    one."""
    if audio.device.type == "cpu":
        return stft_logmel_plain(audio, config)
    if audio.device.type != "cuda":
        raise ValueError(f"stft_logmel: unsupported device {audio.device}")
    if audio.dim() != 2 or audio.dtype != torch.float32:
        raise ValueError(f"stft_logmel wants (B, S) float32, got {tuple(audio.shape)} {audio.dtype}")
    batch, samples = audio.shape
    n_fft, hop = config.n_fft, config.hop_length
    if samples <= n_fft // 2:
        raise ValueError(f"stft_logmel: reflect padding needs more than {n_fft // 2} samples")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    audio = audio.contiguous()
    window, dft_re, dft_im, mel_fb = F.feature_constants(config, audio.device)
    n_frames = samples // hop + 1
    n_bins = n_fft // 2 + 1
    out = torch.empty(batch, n_frames, config.n_mels, device=audio.device, dtype=torch.float32)
    err = build.library().stft_logmel_fwd(
        audio.data_ptr(), window.data_ptr(), dft_re.data_ptr(), dft_im.data_ptr(),
        mel_fb.data_ptr(), out.data_ptr(), batch, samples, n_fft, hop, n_frames,
        n_bins, config.n_mels, config.log_floor, build.stream_of(audio),
    )
    build.check(err, "stft_logmel")
    stft_logmel.launches += 1
    return out


stft_logmel.launches = 0
