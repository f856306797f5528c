"""CTC alpha and beta recursions: kernel wrappers, plain twins, and the
loss built on them.

Replaces the TPU kernels
`nn_conformer_for_speech_recognition_tpu/ops/pallas/ctc.py:_alpha_kernel`
(`ctc_alpha`) and `_beta_kernel` (`ctc_beta`), joined by ``_ctc_ll``'s
``custom_vjp`` there and by `CTCLogLikelihood` here; `ctc_loss_kernel` is
the counterpart of ``ctc_loss_pallas``, with the same arguments and
semantics as the plain `ops.ctc.ctc_loss`.  As in the JAX package, the
emit gather (log-probs at the blank-interleaved label ids) and its adjoint
stay outside the kernels, so labels never enter them, and the final
log-likelihood is a plain masked logsumexp (`ops.ctc.final_ll`).

Layout is (B, T, S) float32 with S = 2L+1; the TPU kernels' (T, B, S)
layout padded to 128 lanes and to a time block was a TPU constraint.  The
beta recursion starts from the end states at t = T-1 (the JAX kernel at
its last padded frame; the frames between are padding, where beta
carries), and carries that init back to each row's len-1.

The CUDA kernels (`csrc/ctc.cu`) give one block to each batch row: each
thread owns `ctc_plan`'s K consecutive states (alpha) or one state (beta)
and walks the row's T steps
from inputs staged in shared memory ahead of the chain, so S ≤ 1024
(labels of up to 511 tokens); longer labels are rejected.  What bounds
them on the H100: T dependent steps of a few exp/log per state on one SM
a row (a serial floor, `chip_smoke.ctc_serial_floor_ms`); with B=16 rows
only 16 SMs work.
"""

from __future__ import annotations

from typing import Optional

import torch

from nn_conformer_for_speech_recognition_tpu_torch.ops.ctc import (
    LOG_EPS,
    _logaddexp3,
    alpha_recursion,
    apply_reduction,
    emit_log_probs,
    extended_labels,
    final_ll,
    state_masks,
)

MAX_STATES = 1024  # the kernels' cap: labels of up to 511 tokens
# by kernel, the states a thread it is built for, and the most warps a block takes before K grows (chosen by
# timing K = 1..9 at S = 17, 201 and 801: the K sweep in PERF.md)
STATES_PER_THREAD = {"alpha": (1, 3, 5), "beta": (1,)}
MAX_WARPS = {"alpha": 9, "beta": 32}
AHEAD = 8  # frames whose inputs a thread copies ahead of the chain (the kernels' kAhead, checked at launch)


def ctc_plan(states: int, kernel: str = "alpha") -> dict:
    """The launch of the CTC ``kernel`` ("alpha" or "beta") for rows of
    ``states`` states, whatever their frames: K, the states a thread, is the
    smallest K built whose threads fit the kernel's `MAX_WARPS`.  Alpha: K =
    1 up to 288 states (the NST buckets' 17, the 30 s step's 201), 3 up to
    864 (the long-form step's 801), 5 up to 1024; beta: K = 1 throughout
    (up to 32 warps).  More warps hide more of a step's latency until the
    step's barrier and issue slots cost more than fewer states a thread
    saves, sooner for alpha than for beta, whose posterior fills the wait.
    Each thread copies its own states' inputs `AHEAD` frames ahead into a
    ring in shared memory (one array for alpha, two for beta); the block's
    shared bytes, all passed to the launch, are each warp's two edge values
    for either frame parity (the parities 32 warps apart, or the block's
    warps in alpha's launches of K > 1), then the rings.  The launch checks
    ``ahead`` and ``smem_bytes`` against its own layout."""
    if kernel not in MAX_WARPS:
        raise ValueError(f"ctc_plan: unknown kernel {kernel!r}")
    if not 1 <= states <= MAX_STATES:
        raise ValueError(f"ctc_plan: {states} states outside 1..{MAX_STATES}")
    k = next(k for k in STATES_PER_THREAD[kernel] if states <= 32 * MAX_WARPS[kernel] * k)
    warps = -(-states // (32 * k))
    rings = 1 if kernel == "alpha" else 2
    stride = warps if kernel == "alpha" and k > 1 else 32
    return dict(threads=32 * warps, warps=warps, states_per_thread=k, ahead=AHEAD,
                smem_bytes=4 * (2 * stride * 2 + rings * AHEAD * k * 32 * warps))


def ctc_alpha_plain(
    emit: torch.Tensor, can_skip: torch.Tensor, ext_len: torch.Tensor, input_lengths: torch.Tensor
) -> torch.Tensor:
    """Plain twin of the alpha kernel: (B, T, S) emit log-probs → (B, T, S)
    alpha at every frame (carried unchanged from t = input length on)."""
    valid, _ = state_masks(ext_len.to(emit.device), emit.shape[2])
    return alpha_recursion(emit, can_skip, valid, input_lengths.to(emit.device))


def ctc_beta_plain(
    emit: torch.Tensor,
    alpha: torch.Tensor,
    can_skip: torch.Tensor,
    ext_len: torch.Tensor,
    input_lengths: torch.Tensor,
    ll: torch.Tensor,
    g: torch.Tensor,
) -> torch.Tensor:
    """Plain twin of the beta kernel → demit (B, T, S) =
    g · exp(min(α + β − ll, 0)) on frames t < input length and valid
    states, 0 elsewhere."""
    b, t, s = emit.shape
    valid, fin = state_masks(ext_len.to(emit.device), s)
    lens = input_lengths.to(emit.device)[:, None]
    eps = emit.new_full((b, 2), LOG_EPS)
    beta = torch.where(fin, 0.0, LOG_EPS)
    demit = [None] * t
    for ti in range(t - 1, -1, -1):
        if ti < t - 1:
            eb = torch.where(valid, emit[:, ti + 1] + beta, LOG_EPS)
            t2 = torch.cat([eb[:, 1:], eps[:, :1]], dim=1)  # eb[s+1]
            # canskip[s+2] ? eb[s+2], LOG_EPS past S (S = 1 takes one pad)
            t3 = torch.cat([torch.where(can_skip, eb, LOG_EPS)[:, 2:], eps[:, : min(2, s)]], dim=1)
            new = torch.where(valid, _logaddexp3(eb, t2, t3), LOG_EPS)
            # the transition into t+1 exists only while t < len-1
            beta = torch.where(ti < lens - 1, new, beta)
        post = torch.exp(torch.clamp_max(alpha[:, ti] + beta - ll[:, None], 0.0))
        demit[ti] = torch.where((ti < lens) & valid, g[:, None] * post, 0.0)
    return torch.stack(demit, dim=1)


def kernel_inputs(can_skip: torch.Tensor, ext_len: torch.Tensor, input_lengths: torch.Tensor, device):
    """can_skip as uint8, ext_len and input_lengths as int32, contiguous on
    ``device``: what the kernels read.  Tensors already so come back as
    they are."""
    i32 = dict(device=device, dtype=torch.int32)
    return (can_skip.to(device=device, dtype=torch.uint8).contiguous(), ext_len.to(**i32).contiguous(),
            input_lengths.to(**i32).contiguous())


def _check(emit: torch.Tensor, can_skip: torch.Tensor, ext_len: torch.Tensor, input_lengths: torch.Tensor, what: str):
    if emit.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {emit.device}")
    if emit.dim() != 3 or emit.dtype != torch.float32:
        raise ValueError(f"{what}: emit must be (B, T, S) float32, got {tuple(emit.shape)} {emit.dtype}")
    b, t, s = emit.shape
    if s > MAX_STATES:
        raise ValueError(f"{what}: {s} states exceed {MAX_STATES} (labels longer than 511 tokens)")
    if t < 1 or s < 1:
        raise ValueError(f"{what}: emit must have frames and states, got {tuple(emit.shape)}")
    if can_skip.shape != (b, s) or ext_len.shape != (b,) or input_lengths.shape != (b,):
        raise ValueError(f"{what}: can_skip must be (B, S), ext_len and input_lengths (B,)")
    return (emit.contiguous(), *kernel_inputs(can_skip, ext_len, input_lengths, emit.device))


def ctc_alpha(
    emit: torch.Tensor, can_skip: torch.Tensor, ext_len: torch.Tensor, input_lengths: torch.Tensor
) -> torch.Tensor:
    """(B, T, S) alpha.  The kernel for CUDA tensors, the plain twin for
    CPU ones."""
    if emit.device.type == "cpu":
        return ctc_alpha_plain(emit, can_skip, ext_len, input_lengths)
    emit, can_skip, ext_len, input_lengths = _check(emit, can_skip, ext_len, input_lengths, "ctc_alpha")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    b, t, s = emit.shape
    plan = ctc_plan(s, "alpha")
    alpha = torch.empty_like(emit)
    err = build.library().ctc_alpha(
        emit.data_ptr(), can_skip.data_ptr(), ext_len.data_ptr(), input_lengths.data_ptr(), alpha.data_ptr(),
        b, t, s, plan["threads"], plan["states_per_thread"], plan["ahead"], plan["smem_bytes"], build.stream_of(emit),
    )
    build.check(err, "ctc_alpha")
    ctc_alpha.launches += 1
    return alpha


def ctc_beta(
    emit: torch.Tensor,
    alpha: torch.Tensor,
    can_skip: torch.Tensor,
    ext_len: torch.Tensor,
    input_lengths: torch.Tensor,
    ll: torch.Tensor,
    g: torch.Tensor,
) -> torch.Tensor:
    """(B, T, S) demit, the cotangent of the emit log-probs.  The kernel for
    CUDA tensors, the plain twin for CPU ones."""
    if emit.device.type == "cpu":
        return ctc_beta_plain(emit, alpha, can_skip, ext_len, input_lengths, ll, g)
    emit, can_skip, ext_len, input_lengths = _check(emit, can_skip, ext_len, input_lengths, "ctc_beta")
    b, t, s = emit.shape
    if alpha.shape != emit.shape or alpha.dtype != torch.float32:
        raise ValueError("ctc_beta: alpha must match emit")
    if ll.shape != (b,) or g.shape != (b,):
        raise ValueError("ctc_beta: ll and g must be (B,)")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    alpha = alpha.to(emit.device).contiguous()
    ll, g = (x.to(device=emit.device, dtype=torch.float32).contiguous() for x in (ll, g))
    plan = ctc_plan(s, "beta")
    demit = torch.empty_like(emit)
    err = build.library().ctc_beta(
        emit.data_ptr(), alpha.data_ptr(), can_skip.data_ptr(), ext_len.data_ptr(),
        input_lengths.data_ptr(), ll.data_ptr(), g.data_ptr(), demit.data_ptr(), b, t, s,
        plan["threads"], plan["ahead"], plan["smem_bytes"], build.stream_of(emit),
    )
    build.check(err, "ctc_beta")
    ctc_beta.launches += 1
    return demit


def ctc_kernel_attributes(kernel: str, states_per_thread: int = 1) -> dict:
    """What the card made of the build of ``kernel`` ("alpha" or "beta")
    for ``states_per_thread`` (one of `STATES_PER_THREAD`): registers a
    thread and local memory a thread (non-zero: spills or a stack frame).
    Needs a CUDA device; launches nothing."""
    import ctypes

    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    build.check(build.library().ctc_kernel_attributes(int(kernel == "beta"), states_per_thread, ctypes.byref(regs),
                                                      ctypes.byref(local)), "ctc_kernel_attributes")
    return dict(registers=regs.value, local_bytes=local.value)


class CTCLogLikelihood(torch.autograd.Function):
    """(B, T, S) emit log-probs → (B,) log-likelihood, the counterpart of
    ``_ctc_ll``: alpha forward, beta backward."""

    @staticmethod
    def forward(ctx, emit, can_skip, ext_len, input_lengths):
        if emit.device.type != "cpu":  # converted once, for both kernels
            can_skip, ext_len, input_lengths = kernel_inputs(can_skip, ext_len, input_lengths, emit.device)
        alpha = ctc_alpha(emit, can_skip, ext_len, input_lengths)
        ll = final_ll(alpha[:, -1], ext_len)
        ctx.save_for_backward(emit, alpha, can_skip, ext_len, input_lengths, ll)
        return ll

    @staticmethod
    def backward(ctx, g):
        emit, alpha, can_skip, ext_len, input_lengths, ll = ctx.saved_tensors
        return ctc_beta(emit, alpha, can_skip, ext_len, input_lengths, ll, g.float()), None, None, None


def ctc_loss_kernel(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
    zero_infinity: bool = True,
    reduction: Optional[str] = "mean",
) -> torch.Tensor:
    """`ops.ctc.ctc_loss` with the recursions in the alpha/beta kernels;
    differentiable in ``log_probs``."""
    ext, can_skip, _, ext_len = extended_labels(labels, label_lengths, blank_id)
    emit = emit_log_probs(log_probs.float(), ext)
    ll = CTCLogLikelihood.apply(emit, can_skip, ext_len, input_lengths)
    return apply_reduction(-ll, ll, label_lengths, zero_infinity, reduction)


ctc_alpha.launches = 0
ctc_beta.launches = 0
