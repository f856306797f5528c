"""Rel-pos flash attention forward: kernel wrapper and plain twin.

Replaces the TPU kernel
`nn_conformer_for_speech_recognition_tpu/ops/pallas/attention.py:_flash_relpos_kernel`
(called through ``_flash_relpos_forward``), forward only and without the
logsumexp output, which only the backward needs.  It has no backward yet,
so the wrapper refuses inputs that need a gradient rather than return a
tensor cut off from the graph; training takes the plain (einsum) route
(`config.attention_route`).  Score:

    s[i, j] = ((q_i + u)·k_j + (q_i + v)·p[j - i + T - 1]) · scale

with keys at or beyond the row's length set to −1e30 (not −inf) and the
``l == 0 → 1`` guard, so the kernel and the plain version agree on every
row the model can produce.

The CUDA kernel (`csrc/attention_relpos.cu`) gives one block of 256 threads
to each (query tile of 32 rows, head, batch row) and walks 32-key tiles
with an online softmax in float32.  The rel-pos row ``p[j - i + T - 1]`` is
read by index from a 63-row band held in shared memory beside the key and
value tiles: the TPU kernel's lane-roll ``_skew`` is not needed.  Inputs
may be bfloat16 or float32; accumulation is float32; the output has q's
dtype.

What bounds it on the H100: float32 FMAs on the CUDA cores (two dot
products of length dh per score, one per output element per key); the
tiles are small and L2-resident, so device-memory traffic is O(B·T·H·dh).
Tensor-core (wgmma) tiles and TMA loads are later work.
"""

from __future__ import annotations

from typing import Optional

import torch

from nn_conformer_for_speech_recognition_tpu_torch.ops.relshift import rel_shift

MASK_VALUE = -1e30
HEAD_DIMS = (16, 32, 64, 128)  # the kernel's compiled head widths


def flash_relpos_attention_plain(
    qu: torch.Tensor,  # (B, T, H, dh): q + content bias u
    qv: torch.Tensor,  # (B, T, H, dh): q + position bias v
    k: torch.Tensor,
    v: torch.Tensor,
    p: torch.Tensor,  # (2T-1, H, dh) projected rel-pos table
    lengths: torch.Tensor,  # (B,) valid key counts
    scale: float,
    dropout: float = 0.0,
    keep: Optional[torch.Tensor] = None,
) -> torch.Tensor:
    """Plain PyTorch rel-pos attention (the JAX einsum path): scores in
    float32, probabilities cast to v's dtype before the value product.
    With ``dropout`` > 0 the probabilities are dropped after the cast, as
    the JAX einsum path does in training; ``keep`` (B, H, T, T) bool
    supplies the mask instead of a draw."""
    t = qu.shape[1]
    ac = torch.einsum("bihd,bjhd->bhij", qu.float(), k.float())
    bd = rel_shift(torch.einsum("bihd,lhd->bhil", qv.float(), p.float()))
    scores = (ac + bd) * scale
    valid = torch.arange(t, device=qu.device)[None, :] < lengths[:, None]
    scores = scores.masked_fill(~valid[:, None, None, :], MASK_VALUE)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    if dropout > 0.0:
        if keep is None:
            keep = torch.rand(attn.shape, device=attn.device) >= dropout
        attn = torch.where(keep, attn / (1.0 - dropout), 0.0).to(v.dtype)
    return torch.einsum("bhij,bjhd->bihd", attn, v)


def flash_relpos_attention(
    qu: torch.Tensor,
    qv: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    p: torch.Tensor,
    lengths: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """(B, T, H, dh) rel-pos attention, forward only.  The kernel for CUDA
    tensors, the plain twin for CPU ones.  Raises when autograd is
    recording and an input requires a gradient, on either device."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qu, qv, k, v, p)):
        raise RuntimeError(
            "flash_relpos_attention has no backward kernel yet (it comes with the "
            "long-form slice); train through the einsum route (config.attention_route)"
        )
    if qu.device.type == "cpu":
        return flash_relpos_attention_plain(qu, qv, k, v, p, lengths, scale)
    if qu.device.type != "cuda":
        raise ValueError(f"flash_relpos_attention: unsupported device {qu.device}")
    b, t, h, dh = qu.shape
    dtype = qu.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"flash_relpos_attention: unsupported dtype {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"flash_relpos_attention: head_dim {dh} not in {HEAD_DIMS}")
    for name, x in (("qv", qv), ("k", k), ("v", v)):
        if x.shape != qu.shape or x.dtype != dtype or x.device != qu.device:
            raise ValueError(f"flash_relpos_attention: {name} does not match qu")
    if p.shape != (2 * t - 1, h, dh) or p.dtype != dtype:
        raise ValueError(f"flash_relpos_attention: p must be {(2 * t - 1, h, dh)} {dtype}")
    if lengths.shape != (b,):
        raise ValueError("flash_relpos_attention: lengths must be (B,)")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    qu, qv, k, v, p = (x.contiguous() for x in (qu, qv, k, v, p))
    lengths = lengths.to(device=qu.device, dtype=torch.int32).contiguous()
    out = torch.empty_like(qu)
    err = build.library().attention_relpos_fwd(
        qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), b, t, h, dh, float(scale),
        int(dtype == torch.bfloat16), build.stream_of(qu),
    )
    build.check(err, "attention_relpos")
    flash_relpos_attention.launches += 1
    return out


flash_relpos_attention.launches = 0
