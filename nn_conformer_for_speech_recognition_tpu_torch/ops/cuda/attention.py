"""Flash attention, rel-pos and bias-input: kernel wrappers, plain twins and
the autograd Functions that join them.

Replaces the TPU kernels of
`nn_conformer_for_speech_recognition_tpu/ops/pallas/attention.py`:
``_flash_relpos_kernel`` (forward, with or without the logsumexp output),
``_flash_relpos_bwd_dq_kernel``, ``_flash_relpos_bwd_dkv_kernel`` and
``_flash_relpos_bwd_dband_kernel``, and the ``custom_vjp`` of
``flash_attention_relpos`` (`RelPosFlashAttention`).  Score:

    s[i, j] = ((q_i + u)·k_j + (q_i + v)·p[j - i + T - 1]) · scale

Forward: keys at or beyond the row's length get −1e30 (not −inf), with the
``l == 0 → 1`` guard, and ``lse = m + log(max(l, 1e-30))``.  Backward,
recomputed tile by tile from the saved lse (no T² tensor is kept):

    prob = exp(s − lse), exactly 0 where j >= length[b]
    ds   = prob · (dO·vᵀ − delta) · scale,   delta_i = Σ_d dO_i · O_i
    dqu = ds·k    dqv[i] = Σ_j ds[i, j] · p[j − i + T − 1]
    dk  = dsᵀ·qu  dv = probᵀ·dO
    dp[l] = Σ_b Σ_i ds[b, i, i + l − (T − 1)] · qv[b, i]

Query rows at or beyond the length are not masked in either direction.

Inputs may be bfloat16 or float32; outputs have the inputs' dtype; lse and
delta are float32.  The dtype picks the kernels, behind the same wrappers
and launch counts; a refused launch raises as any other.

bfloat16 (the main path's type) runs on the tensor cores: the forward in
`csrc/attention_relpos_tc.cu`, dq, dkv and dband in
`csrc/attention_relpos_bwd_tc.cu` (``mma.sync`` in bf16 with float32 sums,
64-row tiles brought by ``cp.async`` one tile ahead, the rel-pos term formed
over a warp's band window and skewed, or unskewed, through a per-warp
buffer; the forward's probabilities rounded to bf16 before the value
product as the TPU kernel casts them, the backward's P and ds rounded once
before the products that take them).

float32 keeps the CUDA-core kernels (`csrc/attention_relpos.cu`,
`csrc/attention_relpos_bwd.cu`): 32 × 32 tiles with 256 threads, float32
FMAs fed from shared memory, the rel-pos row read by index from a band held
there (TF32 would miss the float32 bar).  The table gradient is
deterministic on both routes: a block owns (table rows, head, batch row)
and walks the query tiles in order into a float32 partial, and a second
kernel sums the partials over the batch in order.  Device-memory traffic
is O(B·T·H·dh): the tiles are read again from L2.

The bias-input variant (`flash_attention`, `csrc/attention_bias.cu`) replaces
``_flash_kernel`` of the same TPU module and its ``custom_vjp``
(`BiasFlashAttention`): the rel-pos term arrives as an additive (B, H, T, T)
bias instead of being formed in the kernel,

    s[i, j] = (qu_i·k_j + bias[b, h, i, j]) · scale

with the same key mask and guard.  Its forward walks a row's key tiles only
up to its length: in bfloat16 on the tensor cores (``mma.sync``, 64 query
rows a block held in registers, 64-key tiles of k and v brought by
``cp.async``, the bias read straight into the score accumulator, P kept in
registers for the value product); in float32 on the CUDA cores, 32 × 32
tiles as the rel-pos kernels.  Its backward is plain einsums that recompute
the probabilities, as in the JAX package (a T² bias has a T² gradient
anyway).  No model routes through it, in either package: it is a public op
of its own.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

from nn_conformer_for_speech_recognition_tpu_torch.ops.relshift import rel_shift, rel_shift_adjoint

MASK_VALUE = -1e30
HEAD_DIMS = (16, 32, 64, 128)  # the kernels' compiled head widths


def _acc_dtype(x: torch.Tensor) -> torch.dtype:
    """The twins accumulate in float32 (float64 inputs stay float64, for
    gradient checks)."""
    return torch.float64 if x.dtype == torch.float64 else torch.float32


def _plain_scores(qu, qv, k, p, scale) -> torch.Tensor:
    """Unmasked (B, H, T, T) scores in the accumulation dtype."""
    acc = _acc_dtype(qu)
    ac = torch.einsum("bihd,bjhd->bhij", qu.to(acc), k.to(acc))
    bd = rel_shift(torch.einsum("bihd,lhd->bhil", qv.to(acc), p.to(acc)))
    return (ac + bd) * scale


def _key_mask(lengths: torch.Tensor, t: int, device: torch.device) -> torch.Tensor:
    """(B, 1, 1, T) bool: key j is valid for row b."""
    return (torch.arange(t, device=device)[None, :] < lengths.to(device)[:, None])[:, None, None, :]


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
    return_lse: bool = False,
):
    """Plain PyTorch rel-pos attention (the JAX einsum path): scores in
    float32, probabilities cast to v's dtype before the value product.
    With ``dropout`` > 0 the probabilities are dropped after the cast, as
    the JAX einsum path does in training; ``keep`` (B, H, T, T) bool
    supplies the mask instead of a draw.  With ``return_lse`` also the
    (B, H, T) float32 logsumexp of the masked scores, the twin of the
    forward kernel's second output."""
    scores = _plain_scores(qu, qv, k, p, scale)
    scores = scores.masked_fill(~_key_mask(lengths, qu.shape[1], qu.device), MASK_VALUE)
    attn = torch.softmax(scores, dim=-1).to(v.dtype)
    if dropout > 0.0:
        if keep is None:
            keep = torch.rand(attn.shape, device=attn.device) >= dropout
        attn = torch.where(keep, attn / (1.0 - dropout), 0.0).to(v.dtype)
    out = torch.einsum("bhij,bjhd->bihd", attn, v)
    return (out, torch.logsumexp(scores, dim=-1)) if return_lse else out


def attention_delta(o: torch.Tensor, g: torch.Tensor) -> torch.Tensor:
    """delta[b, h, i] = Σ_d dO·O in float32, (B, H, T); a plain reduction
    outside the kernels, as in the JAX package."""
    acc = _acc_dtype(o)
    return (g.to(acc) * o.to(acc)).sum(dim=-1).transpose(1, 2).contiguous()


def _backward_plain_from_delta(qu, qv, k, v, p, lengths, scale, lse, delta, g):
    acc = _acc_dtype(qu)
    prob = torch.exp(_plain_scores(qu, qv, k, p, scale) - lse.to(acc)[..., None])
    prob = torch.where(_key_mask(lengths, qu.shape[1], qu.device), prob, 0.0)
    g_acc = g.to(acc)
    ds = prob * (torch.einsum("bihd,bjhd->bhij", g_acc, v.to(acc)) - delta.to(acc)[..., None]) * scale
    dv = torch.einsum("bhij,bihd->bjhd", prob, g_acc)
    dqu = torch.einsum("bhij,bjhd->bihd", ds, k.to(acc))
    dk = torch.einsum("bhij,bihd->bjhd", ds, qu.to(acc))
    dbd = rel_shift_adjoint(ds)  # ds re-binned over relative distances
    dqv = torch.einsum("bhil,lhd->bihd", dbd, p.to(acc))
    dp = torch.einsum("bhil,bihd->lhd", dbd, qv.to(acc))
    return dqu.to(qu.dtype), dqv.to(qv.dtype), dk.to(k.dtype), dv.to(v.dtype), dp.to(p.dtype)


def flash_relpos_attention_backward_plain(
    qu, qv, k, v, p, lengths, scale: float, o: torch.Tensor, lse: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain twin of the three backward kernels: (dqu, dqv, dk, dv, dp) from
    the saved output ``o``, the saved ``lse`` (B, H, T) and the cotangent
    ``g``, by the recompute-from-lse recipe the kernels follow (float32
    accumulation, results cast to the inputs' dtype)."""
    return _backward_plain_from_delta(qu, qv, k, v, p, lengths, scale, lse, attention_delta(o, g), g)


def _check_inputs(what: str, qu, qv, k, v, p, lengths) -> Tuple[int, int, int, int]:
    """Raises on what the kernels do not take; returns (B, T, H, dh)."""
    if qu.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qu.device}")
    b, t, h, dh = qu.shape
    dtype = qu.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: unsupported dtype {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {dh} not in {HEAD_DIMS}")
    for name, x in (("qv", qv), ("k", k), ("v", v)):
        if x.shape != qu.shape or x.dtype != dtype or x.device != qu.device:
            raise ValueError(f"{what}: {name} does not match qu")
    if p.shape != (2 * t - 1, h, dh) or p.dtype != dtype or p.device != qu.device:
        raise ValueError(f"{what}: p must be {(2 * t - 1, h, dh)} {dtype}")
    if lengths.shape != (b,):
        raise ValueError(f"{what}: lengths must be (B,)")
    return b, t, h, dh


def _check_backward_inputs(what: str, qu, qv, k, v, p, lengths, lse, delta, g) -> Tuple[int, int, int, int]:
    b, t, h, dh = _check_inputs(what, qu, qv, k, v, p, lengths)
    if g.shape != qu.shape or g.dtype != qu.dtype or g.device != qu.device:
        raise ValueError(f"{what}: g does not match qu")
    for name, x in (("lse", lse), ("delta", delta)):
        if x.shape != (b, h, t) or x.dtype != torch.float32 or x.device != qu.device:
            raise ValueError(f"{what}: {name} must be {(b, h, t)} float32")
    return b, t, h, dh


def _lengths_i32(lengths: torch.Tensor, device: torch.device) -> torch.Tensor:
    return lengths.to(device=device, dtype=torch.int32).contiguous()


def _aligned(*tensors):
    """The tensors contiguous, and bfloat16 ones on 16-byte boundaries: the
    tensor-core kernels copy 16 bytes at a time."""
    tensors = [x.contiguous() for x in tensors]
    return [x.clone() if x.dtype == torch.bfloat16 and x.data_ptr() % 16 else x for x in tensors]


def _launch_forward(qu, qv, k, v, p, lengths, scale, with_lse: bool):
    b, t, h, dh = _check_inputs("flash_relpos_attention", qu, qv, k, v, p, lengths)
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    qu, qv, k, v, p = _aligned(qu, qv, k, v, p)
    lengths = _lengths_i32(lengths, qu.device)
    out = torch.empty_like(qu)
    lse = torch.empty(b, h, t, device=qu.device, dtype=torch.float32) if with_lse else None
    err = build.library().attention_relpos_fwd(
        qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(),
        lengths.data_ptr(), out.data_ptr(), None if lse is None else lse.data_ptr(),
        b, t, h, dh, float(scale), int(qu.dtype == torch.bfloat16), build.stream_of(qu),
    )
    build.check(err, "attention_relpos")
    return out, lse


def flash_relpos_attention_forward_lse(
    qu, qv, k, v, p, lengths, scale: float
) -> Tuple[torch.Tensor, torch.Tensor]:
    """Forward that also returns the (B, H, T) float32 logsumexp the
    backward recomputes from.  The kernel for CUDA tensors, the plain twin
    for CPU ones.  Returns graph-less tensors: `RelPosFlashAttention` is
    the differentiable entry."""
    if qu.device.type == "cpu":
        return flash_relpos_attention_plain(qu, qv, k, v, p, lengths, scale, return_lse=True)
    out, lse = _launch_forward(qu, qv, k, v, p, lengths, scale, with_lse=True)
    flash_relpos_attention_forward_lse.launches += 1
    return out, lse


def _launch_backward(symbol: str, shapes_like, qu, qv, k, v, p, lengths, scale, lse, delta, g):
    """Launches one backward kernel; its two (or one) outputs are allocated
    like ``shapes_like``."""
    b, t, h, dh = _check_backward_inputs(symbol, qu, qv, k, v, p, lengths, lse, delta, g)
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    qu, qv, k, v, p, g, lse, delta = _aligned(qu, qv, k, v, p, g, lse, delta)
    lengths = _lengths_i32(lengths, qu.device)
    outs = [torch.empty_like(x) for x in shapes_like]
    scratch = []
    if symbol == "attention_relpos_bwd_dband":  # per-batch-row float32 partials
        scratch = [torch.empty((b, *p.shape), device=p.device, dtype=torch.float32)]
    err = getattr(build.library(), symbol)(
        qu.data_ptr(), qv.data_ptr(), k.data_ptr(), v.data_ptr(), p.data_ptr(), lengths.data_ptr(),
        g.data_ptr(), lse.data_ptr(), delta.data_ptr(), *(x.data_ptr() for x in outs + scratch),
        b, t, h, dh, float(scale), int(qu.dtype == torch.bfloat16), build.stream_of(qu),
    )
    build.check(err, symbol)
    return outs


TC_KERNELS = ("fwd", "fwd_lse", "dq", "dkv", "dband")  # the bfloat16 tensor-core kernels, by `relpos_tc_plan`'s name


def relpos_tc_plan(kernel: str, head_dim: int) -> dict:
    """What the card makes of a bfloat16 tensor-core kernel (``kernel`` one
    of `TC_KERNELS`: the forward without and with lse, dq, dkv, dband) at
    ``head_dim``: blocks an SM holds at once (the occupancy calculator,
    after the kernel's shared-memory opt-in), registers a thread, local
    memory a thread (non-zero: spills or a stack frame) and dynamic shared
    memory a block.  Needs a CUDA device; launches nothing."""
    import ctypes

    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    if head_dim not in HEAD_DIMS:
        raise ValueError(f"relpos_tc_plan: head_dim {head_dim} not in {HEAD_DIMS}")
    if kernel not in TC_KERNELS:
        raise ValueError(f"relpos_tc_plan: kernel {kernel!r} not in {TC_KERNELS}")
    values = [ctypes.c_int(0) for _ in range(4)]
    if kernel.startswith("fwd"):
        plan, flag = build.library().attention_relpos_fwd_tc_plan, int(kernel == "fwd_lse")
    else:
        plan, flag = build.library().attention_relpos_bwd_tc_plan, {"dq": 0, "dband": 1, "dkv": 2}[kernel]
    build.check(plan(flag, head_dim, *(ctypes.byref(x) for x in values)), f"relpos_tc_plan({kernel}, {head_dim})")
    return dict(zip(("blocks_per_sm", "registers", "local_bytes", "smem_bytes"), (x.value for x in values)))


def flash_relpos_attention_bwd_dq(
    qu, qv, k, v, p, lengths, scale: float, lse: torch.Tensor, delta: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dqu, dqv), each (B, T, H, dh) in q's dtype.  The kernel for CUDA
    tensors, the plain twin for CPU ones."""
    if qu.device.type == "cpu":
        return _backward_plain_from_delta(qu, qv, k, v, p, lengths, scale, lse, delta, g)[0:2]
    dqu, dqv = _launch_backward("attention_relpos_bwd_dq", (qu, qv), qu, qv, k, v, p, lengths, scale, lse, delta, g)
    flash_relpos_attention_bwd_dq.launches += 1
    return dqu, dqv


def flash_relpos_attention_bwd_dkv(
    qu, qv, k, v, p, lengths, scale: float, lse: torch.Tensor, delta: torch.Tensor, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor]:
    """(dk, dv), each (B, T, H, dh).  The kernel for CUDA tensors, the
    plain twin for CPU ones."""
    if qu.device.type == "cpu":
        return _backward_plain_from_delta(qu, qv, k, v, p, lengths, scale, lse, delta, g)[2:4]
    dk, dv = _launch_backward("attention_relpos_bwd_dkv", (k, v), qu, qv, k, v, p, lengths, scale, lse, delta, g)
    flash_relpos_attention_bwd_dkv.launches += 1
    return dk, dv


def flash_relpos_attention_bwd_dband(
    qu, qv, k, v, p, lengths, scale: float, lse: torch.Tensor, delta: torch.Tensor, g: torch.Tensor
) -> torch.Tensor:
    """dp (2T-1, H, dh), the rel-pos table's gradient summed over the batch
    in a fixed order (float32 partials per batch row, then their sum; one
    launch of the wrapper runs both kernels).  The kernel for CUDA tensors,
    the plain twin for CPU ones."""
    if qu.device.type == "cpu":
        return _backward_plain_from_delta(qu, qv, k, v, p, lengths, scale, lse, delta, g)[4]
    (dp,) = _launch_backward("attention_relpos_bwd_dband", (p,), qu, qv, k, v, p, lengths, scale, lse, delta, g)
    flash_relpos_attention_bwd_dband.launches += 1
    return dp


class RelPosFlashAttention(torch.autograd.Function):
    """(qu, qv, k, v, p, lengths, scale) → out, with the backward of
    ``flash_attention_relpos``'s ``custom_vjp`` in the JAX package: the
    forward saves the inputs, the output and the lse; the backward
    recomputes the probabilities from them.  CUDA tensors go through the
    four kernels, CPU tensors through the plain twins."""

    @staticmethod
    def forward(ctx, qu, qv, k, v, p, lengths, scale):
        out, lse = flash_relpos_attention_forward_lse(qu, qv, k, v, p, lengths, scale)
        ctx.save_for_backward(qu, qv, k, v, p, lengths, out, lse)
        ctx.scale = scale
        return out

    @staticmethod
    def backward(ctx, g):
        qu, qv, k, v, p, lengths, out, lse = ctx.saved_tensors
        g = g.to(out.dtype)
        if g.device.type == "cpu":
            grads = flash_relpos_attention_backward_plain(qu, qv, k, v, p, lengths, ctx.scale, out, lse, g)
            return (*grads, None, None)
        args = (qu, qv, k, v, p, lengths, ctx.scale, lse, attention_delta(out, g), g)
        dqu, dqv = flash_relpos_attention_bwd_dq(*args)
        dk, dv = flash_relpos_attention_bwd_dkv(*args)
        dp = flash_relpos_attention_bwd_dband(*args)
        return dqu, dqv, dk, dv, dp, None, None


def flash_relpos_attention(
    qu: torch.Tensor,
    qv: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    p: torch.Tensor,
    lengths: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """(B, T, H, dh) rel-pos attention, differentiable in qu, qv, k, v and
    p.  With autograd recording and an input that needs a gradient it goes
    through `RelPosFlashAttention` (forward kernel writing the lse, then the
    three backward kernels); otherwise the forward kernel writes the output
    only.  CPU tensors run the plain twins in the same places."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qu, qv, k, v, p)):
        return RelPosFlashAttention.apply(qu, qv, k, v, p, lengths, scale)
    if qu.device.type == "cpu":
        return flash_relpos_attention_plain(qu, qv, k, v, p, lengths, scale)
    out, _ = _launch_forward(qu, qv, k, v, p, lengths, scale, with_lse=False)
    flash_relpos_attention.launches += 1
    return out


# ---------------------------------------------------------------------------
# The bias-input variant
# ---------------------------------------------------------------------------


def _masked_bias_scores(qu, k, bias, lengths, scale) -> Tuple[torch.Tensor, torch.Tensor]:
    """((B, H, T, T) scores with the masked keys at MASK_VALUE, the key
    mask), in the accumulation dtype."""
    acc = _acc_dtype(qu)
    scores = (torch.einsum("bihd,bjhd->bhij", qu.to(acc), k.to(acc)) + bias.to(acc)) * scale
    mask = _key_mask(lengths, qu.shape[1], qu.device)
    return scores.masked_fill(~mask, MASK_VALUE), mask


def flash_attention_plain(
    qu: torch.Tensor,  # (B, T, H, dh): q + content bias u
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,  # (B, H, T, T) additive; the scale multiplies it too
    lengths: torch.Tensor,  # (B,) valid key counts
    scale: float,
) -> torch.Tensor:
    """Plain PyTorch attention with an additive bias (the JAX package's
    ``flash_attention_reference``): scores and softmax in float32, the
    value product in float32, the result in qu's dtype."""
    scores, _ = _masked_bias_scores(qu, k, bias, lengths, scale)
    prob = torch.softmax(scores, dim=-1)
    return torch.einsum("bhij,bjhd->bihd", prob, v.to(prob.dtype)).to(qu.dtype)


def flash_attention_backward_plain(
    qu, k, v, bias, lengths, scale: float, g: torch.Tensor
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(dqu, dk, dv, dbias) of `flash_attention` for the cotangent ``g``, by
    the JAX package's ``_fa_bwd``: the probabilities are recomputed, masked
    columns get no gradient, and the scale is folded into dqu, dk and dbias."""
    scores, mask = _masked_bias_scores(qu, k, bias, lengths, scale)
    acc = scores.dtype
    prob = torch.softmax(scores, dim=-1)
    g_acc = g.to(acc)
    dv = torch.einsum("bhij,bihd->bjhd", prob, g_acc)
    dprob = torch.einsum("bihd,bjhd->bhij", g_acc, v.to(acc))
    ds = prob * (dprob - (dprob * prob).sum(dim=-1, keepdim=True))
    ds = torch.where(mask, ds, 0.0) * scale
    dqu = torch.einsum("bhij,bjhd->bihd", ds, k.to(acc))
    dk = torch.einsum("bhij,bihd->bjhd", ds, qu.to(acc))
    return dqu.to(qu.dtype), dk.to(k.dtype), dv.to(v.dtype), ds.to(bias.dtype)


def _check_bias_inputs(qu, k, v, bias, lengths) -> Tuple[int, int, int, int]:
    """Raises on what the bias-input kernel does not take; returns (B, T, H, dh)."""
    what = "flash_attention"
    if qu.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {qu.device}")
    b, t, h, dh = qu.shape
    dtype = qu.dtype
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"{what}: unsupported dtype {dtype}")
    if dh not in HEAD_DIMS:
        raise ValueError(f"{what}: head_dim {dh} not in {HEAD_DIMS}")
    for name, x in (("k", k), ("v", v)):
        if x.shape != qu.shape or x.dtype != dtype or x.device != qu.device:
            raise ValueError(f"{what}: {name} does not match qu")
    if bias.shape != (b, h, t, t) or bias.device != qu.device or bias.dtype not in (torch.float32, dtype):
        raise ValueError(f"{what}: bias must be {(b, h, t, t)} float32 or {dtype}")
    if lengths.shape != (b,):
        raise ValueError(f"{what}: lengths must be (B,)")
    return b, t, h, dh


def flash_attention_forward(qu, k, v, bias, lengths, scale: float) -> torch.Tensor:
    """(B, T, H, dh) attention output in qu's dtype, every query row
    computed.  The kernel for CUDA tensors, the plain twin for CPU ones.
    ``lengths >= 1`` is the contract.  Returns a graph-less tensor:
    `BiasFlashAttention` is the differentiable entry."""
    if qu.device.type == "cpu":
        return flash_attention_plain(qu, k, v, bias, lengths, scale)
    b, t, h, dh = _check_bias_inputs(qu, k, v, bias, lengths)
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    # contiguous, and on 16-byte boundaries for the bfloat16 kernel's 16-byte copies
    qu, k, v, bias = (x.contiguous() for x in (qu, k, v, bias))
    qu, k, v = (x if x.data_ptr() % 16 == 0 else x.clone() for x in (qu, k, v))
    lengths = _lengths_i32(lengths, qu.device)
    out = torch.empty_like(qu)
    err = build.library().attention_bias_fwd(
        qu.data_ptr(), k.data_ptr(), v.data_ptr(), bias.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, t, h, dh, float(scale), int(qu.dtype == torch.bfloat16), int(bias.dtype == torch.bfloat16),
        build.stream_of(qu),
    )
    build.check(err, "attention_bias")
    flash_attention_forward.launches += 1
    return out


class BiasFlashAttention(torch.autograd.Function):
    """(qu, k, v, bias, lengths, scale) → out, with the backward of
    ``flash_attention``'s ``custom_vjp`` in the JAX package: the forward
    saves its inputs, the backward is `flash_attention_backward_plain`
    (plain einsums on either device; lengths get no gradient)."""

    @staticmethod
    def forward(ctx, qu, k, v, bias, lengths, scale):
        ctx.save_for_backward(qu, k, v, bias, lengths)
        ctx.scale = scale
        return flash_attention_forward(qu, k, v, bias, lengths, scale)

    @staticmethod
    def backward(ctx, g):
        qu, k, v, bias, lengths = ctx.saved_tensors
        return (*flash_attention_backward_plain(qu, k, v, bias, lengths, ctx.scale, g), None, None)


def flash_attention(
    qu: torch.Tensor,
    k: torch.Tensor,
    v: torch.Tensor,
    bias: torch.Tensor,
    lengths: torch.Tensor,
    scale: float,
) -> torch.Tensor:
    """(B, T, H, dh) attention with an additive (B, H, T, T) bias and
    valid-length masking of the keys, differentiable in qu, k, v and bias.
    CUDA tensors go through the forward kernel (a failed build or launch
    raises), CPU tensors through the plain twin."""
    if torch.is_grad_enabled() and any(x.requires_grad for x in (qu, k, v, bias)):
        return BiasFlashAttention.apply(qu, k, v, bias, lengths, scale)
    return flash_attention_forward(qu, k, v, bias, lengths, scale)


flash_relpos_attention.launches = 0
flash_relpos_attention_forward_lse.launches = 0
flash_relpos_attention_bwd_dq.launches = 0
flash_relpos_attention_bwd_dkv.launches = 0
flash_relpos_attention_bwd_dband.launches = 0
flash_attention_forward.launches = 0
