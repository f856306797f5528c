"""Fused STFT → power → mel → log: kernel wrapper and plain twin.

Replaces the TPU kernel
`nn_conformer_for_speech_recognition_tpu/ops/pallas/stft_logmel.py:_stft_logmel_kernel`
(called through ``stft_logmel_pallas``).  The CUDA kernel
(`csrc/stft_logmel.cu::stft_logmel_tc_kernel`) reads the frames straight
from the audio by index, reflecting at both ends (no padded copy and no
im2col), windows them and folds each over its mirror samples in shared
memory, and takes the real DFT as two GEMMs of K = n_fft/2 (cosine rows
against the even part, sine rows against the odd part) on the tensor cores:
TF32 ``mma.sync`` in three passes (the 3×TF32 split, which keeps float32's
accuracy that the log of a power needs), float32 sums.  The power and the
mel sums stay on the chip; it writes log(max(mel, floor)).

What bounds it on the H100: not the function's bytes or operations (an
FFT needs ~70× fewer than this DFT does), but the DFT's products and
feeding them, a block barrier each basis stage.  The fold halves the
products (3 × 3.9 GFLOP of TF32 at (16, 480000) instead of 3 × 7.9 for the
unfolded DFT, and half the basis streamed from L2); a block holds 64 frames
(32 past n_fft = 512, 16 past 1024 or where a short batch would leave SMs
idle, 8 past 2305) and streams the folded float32 basis through them once
in 128-row stages (64 at 8 frames); the mel product walks each mel's band of nonzero weights only
(~2 × 257 multiply-adds a frame, not 257 × 40).  The basis and the bands
are host tables made once per (config, device)
(`ops/features.py::kernel_constants`).  PERF.md has the times.

The TPU kernel's 128-lane padding, its whole-row/time-tiled split and its
fallback to the reference for other geometries were TPU constraints: the
CUDA kernel takes any hop and any number of mels, and n_fft up to
`MAX_N_FFT` (its 8-frame tile's shared memory), raising past it.
"""

from __future__ import annotations

import dataclasses

import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig
from nn_conformer_for_speech_recognition_tpu_torch.ops import features as F

MAX_N_FFT = 5889  # csrc/stft_logmel.cu: every n_fft up to it has a tile whose rows fit shared memory


def stft_logmel_plain(audio: torch.Tensor, config: FeatureConfig) -> torch.Tensor:
    """(B, S) float32 audio → (B, S//hop + 1, n_mels) log-mel, plain PyTorch."""
    out, _ = F.log_mel_spectrogram(audio, dataclasses.replace(config, normalize="none"))
    return out


def stft_logmel_float64(audio: torch.Tensor, config: FeatureConfig) -> torch.Tensor:
    """The plain version in float64 throughout, on the same float32 tables
    widened: what the kernel and the float32 twin are each read against."""
    window, real_b, imag_b, mel_fb = (t.double() for t in F.feature_constants(config, audio.device))
    frames = F.frame_signal(audio.double(), config.n_fft, config.hop_length) * window
    re, im = frames @ real_b, frames @ imag_b
    return torch.log(torch.clamp_min((re * re + im * im) @ mel_fb, config.log_floor))


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
    if n_fft > MAX_N_FFT:
        raise ValueError(f"stft_logmel: the kernel takes n_fft ≤ {MAX_N_FFT}, got {n_fft}")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    audio = audio.contiguous()
    window, _, _, mel_fb = F.feature_constants(config, audio.device)
    basis, bands = F.kernel_constants(config, audio.device)
    n_frames = samples // hop + 1
    out = torch.empty(batch, n_frames, config.n_mels, device=audio.device, dtype=torch.float32)
    err = build.library().stft_logmel_fwd(
        audio.data_ptr(), window.data_ptr(), basis.data_ptr(), mel_fb.data_ptr(), bands.data_ptr(),
        out.data_ptr(), batch, samples, n_fft, hop, n_frames, *basis.shape[1:], config.n_mels,
        config.log_floor, build.stream_of(audio),
    )
    build.check(err, "stft_logmel")
    stft_logmel.launches += 1
    return out


stft_logmel.launches = 0


def stft_logmel_tc_plan(n_fft: int, frames: int) -> dict:
    """What the card makes of the kernel that a launch of ``frames`` frames
    (batch × frames a row) at ``n_fft`` takes: its frames a block, blocks an
    SM holds at once (the occupancy calculator, after the kernel's
    shared-memory opt-in), registers a thread, local memory a thread
    (non-zero: spills or a stack frame) and dynamic shared memory a block.
    Needs a CUDA device; launches nothing."""
    import ctypes

    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    values = [ctypes.c_int(0) for _ in range(5)]
    build.check(build.library().stft_logmel_tc_plan(n_fft, frames, *(ctypes.byref(x) for x in values)),
                f"stft_logmel_tc_plan({n_fft}, {frames})")
    keys = ("frames_per_block", "blocks_per_sm", "registers", "local_bytes", "smem_bytes")
    return dict(zip(keys, (x.value for x in values)))
