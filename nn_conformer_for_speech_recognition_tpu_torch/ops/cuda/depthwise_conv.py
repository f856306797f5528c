"""SAME-padded depthwise 1-D convolution: kernel wrapper, autograd Function
and plain twin.

Replaces the TPU kernel
`nn_conformer_for_speech_recognition_tpu/ops/pallas/depthwise_conv.py:_dw_kernel`
(called through ``depthwise_conv1d_pallas``): x (B, T, C), w (K, C) →
(B, T, C), ``out[b, t, c] = Σ_i w[i, c] · x[b, t + i − pad_lo, c]`` with
zeros outside [0, T), ``pad_lo = (K − 1) // 2`` and ``pad_hi = K − 1 −
pad_lo``.  The CUDA kernel (`csrc/depthwise_conv.cu`) takes the data as it
lies, channels-last: one block per (64 rows, 128 channels, batch row),
threads along C so that loads coalesce, the tile's halo read once into
shared memory with zero fill beyond the sequence, float32 sums, the output
rounded once to x's type.  The TPU kernel's zero-padded copy of x, its
whole-T × 128-lane tiles and its (8, 128) alignment were TPU constraints and
are not carried over; neither are the two transposes of the grouped
``conv1d`` route.

What bounds it on the H100: bytes.  x is read once and the output written
once (7.7 MB at (16, 235, 512) in bfloat16, ~2.3 µs at 3.35 TB/s) against
2·K operations an element, ~1.9 µs of the float32 rate at K = 33; the
kernel re-reads each halo row from L2 (1.5× at K = 33) and spends one
shared-memory load per multiply-add, which is what a later, faster version
would cut (wider loads, taps in registers).

The gradient follows the JAX package, which has no backward kernel here:
dx is the same kernel on the incoming gradient with the taps reversed and
the pads swapped, dw a plain float32 contraction (one call, not a loop over
K).  Rounding: the TPU kernel multiplies in the inputs' type before it adds
into float32, and its backward sums in x's type; here every product and sum
is float32, so float32 agrees with the JAX package to rounding of the sum
order and bfloat16 to a bfloat16 ulp of the result.
"""

from __future__ import annotations

from typing import Optional

import torch
import torch.nn.functional as F

# the kernel keeps the K x 128 taps and a (64 + K - 1) x 128 halo as float32 in
# one block's shared memory, 4 * 128 * (2K + 63) bytes of the 227 KiB a block may ask for
TILE_ROWS, SLAB_CHANNELS, MAX_SHARED_BYTES = 64, 128, 227 * 1024
MAX_KERNEL_SIZE = (MAX_SHARED_BYTES // (4 * SLAB_CHANNELS) - (TILE_ROWS - 1)) // 2  # 195


def _pads(k: int):
    pad_lo = (k - 1) // 2
    return pad_lo, k - 1 - pad_lo


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for bfloat16 and float32 inputs; float64 stays float64."""
    return torch.promote_types(x.dtype, torch.float32)


def depthwise_conv1d_plain(x: torch.Tensor, w: torch.Tensor, pad_lo: Optional[int] = None) -> torch.Tensor:
    """x (B, T, C), w (K, C) → (B, T, C) in x's dtype, plain PyTorch: K
    shifted multiply-adds in float32 (float64 for float64 inputs), the
    kernel's arithmetic in the kernel's order.  ``pad_lo`` zeros stand before the sequence (SAME
    padding by default) and ``K − 1 − pad_lo`` after it."""
    k, t = w.shape[0], x.shape[1]
    if pad_lo is None:
        pad_lo = _pads(k)[0]
    acc = _sum_dtype(x)
    xp = F.pad(x.to(acc), (0, 0, pad_lo, k - 1 - pad_lo))
    out = torch.zeros(x.shape, dtype=acc, device=x.device)
    for i in range(k):
        out += xp[:, i : i + t] * w[i].to(acc)
    return out.to(x.dtype)


def depthwise_conv1d_forward(
    x: torch.Tensor, w: torch.Tensor, pad_lo: Optional[int] = None, reverse_taps: bool = False
) -> torch.Tensor:
    """The convolution without an autograd graph: the kernel for CUDA
    tensors, the plain twin for CPU ones.  ``reverse_taps`` reads w from its
    last tap to its first (with ``pad_lo = K − 1 − (K − 1) // 2`` that is the
    gradient with respect to x)."""
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"depthwise_conv1d wants x (B, T, C) and w (K, C), got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"depthwise_conv1d: w is {w.dtype} on {w.device}, x is {x.dtype} on {x.device}")
    k = w.shape[0]
    if pad_lo is None:
        pad_lo = _pads(k)[0]
    if not 0 <= pad_lo < k:
        raise ValueError(f"depthwise_conv1d: pad_lo {pad_lo} outside [0, {k})")
    if x.device.type == "cpu":
        return depthwise_conv1d_plain(x, w.flip(0) if reverse_taps else w, pad_lo)
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"depthwise_conv1d wants float32 or bfloat16, got {x.dtype}")
    if k > MAX_KERNEL_SIZE:
        raise ValueError(f"depthwise_conv1d: kernel size {k} above {MAX_KERNEL_SIZE}")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    batch, t, c = x.shape
    err = build.library().depthwise_conv_fwd(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), batch, t, c, k, pad_lo, int(reverse_taps),
        int(x.dtype == torch.bfloat16), build.stream_of(x),
    )
    build.check(err, "depthwise_conv")
    depthwise_conv1d_forward.launches += 1
    return out


depthwise_conv1d_forward.launches = 0


def depthwise_conv1d_weight_grad(x: torch.Tensor, g: torch.Tensor, k: int) -> torch.Tensor:
    """dw[i, c] = Σ_{b,t} x_padded[b, t + i, c] · g[b, t, c] as one float32
    contraction over the K windows of the padded input; (K, C) float32
    (float64 for float64 inputs)."""
    pad_lo, pad_hi = _pads(k)
    acc = _sum_dtype(x)
    windows = F.pad(x.to(acc), (0, 0, pad_lo, pad_hi)).unfold(1, k, 1)  # (B, T, C, K)
    return torch.einsum("btck,btc->kc", windows, g.to(acc))


class DepthwiseConv1d(torch.autograd.Function):
    """``depthwise_conv1d_forward`` with its gradients: dx by the same
    forward (the kernel on CUDA) on the incoming gradient with the taps
    reversed and the pads swapped, dw by `depthwise_conv1d_weight_grad`."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return depthwise_conv1d_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k = w.shape[0]
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_conv1d_forward(g.contiguous(), w, pad_lo=_pads(k)[1], reverse_taps=True)
        if ctx.needs_input_grad[1]:
            dw = depthwise_conv1d_weight_grad(x, g, k).to(w.dtype)
        return dx, dw


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, T, C), w (K, C) → (B, T, C), SAME padding, in x's dtype.  The
    kernel for CUDA tensors, the plain twin for CPU ones; differentiable in
    both through `DepthwiseConv1d`."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return DepthwiseConv1d.apply(x, w)
    return depthwise_conv1d_forward(x, w)
