"""One LSTM direction, forward and backward: kernel wrappers, plain twins
and the autograd Function that joins them.

Replaces the TPU kernels
`nn_conformer_for_speech_recognition_tpu/ops/pallas/lstm.py:_fwd_kernel`
(`lstm_forward`) and `_bwd_kernel` (`lstm_backward` for the BPTT
recurrence, `lstm_weight_grad` for dW_hh), joined by ``_lstm_seq``'s
``custom_vjp`` there and by `LSTMSequence` here.  Gate math matches flax's
LSTMCell (i, f, g, o order); rows freeze once t ≥ length, so padded steps
emit the carried h and the reverse direction starts at each row's own
len-1.  The input projection x·W_ih + b and its gradient stay torch ops
outside, as they are XLA outside the ``custom_vjp`` in the JAX package.

The CUDA kernels (`csrc/lstm.cu`): the forward and the backward recurrence
run all T steps in one launch each, one block per batch row and thread j
owning hidden unit j; dW_hh = Σ_t h_prevᵀ·dgates_t, which the TPU kernel
accumulates inside its recurrence, is hoisted out of it into one tiled
float32 GEMM over all B·T rows.

What bounds them on the H100: each step of either recurrence reads all of
W_hh (H × 4H float32, 1.6 MB for Conformer-M's H=320) from L2 in every
block, which exceeds one SM's 227 KB of shared memory; with B=16 only 16
of the 132 SMs work, and the T steps are strictly sequential.  A cluster
split of W_hh over distributed shared memory is later work.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch


def lstm_forward_plain(
    xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, reverse: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the forward kernel: (B, T, 4H) float32 xw,
    (H, 4H) w_hh, (B,) lengths → h and c (B, T, H) and the post-activation
    gates (B, T, 4H), which are 0 on padded steps."""
    b, t, h4 = xw.shape
    hx = xw.new_zeros(b, h4 // 4)
    cx = xw.new_zeros(b, h4 // 4)
    lengths = lengths.to(xw.device)
    hs, cs, gs = [None] * t, [None] * t, [None] * t
    for ti in (range(t - 1, -1, -1) if reverse else range(t)):
        i, f, g, o = (xw[:, ti] + hx @ w_hh).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_new = f * cx + i * g
        h_new = o * torch.tanh(c_new)
        active = (ti < lengths)[:, None]
        hx = torch.where(active, h_new, hx)
        cx = torch.where(active, c_new, cx)
        hs[ti], cs[ti] = hx, cx
        gs[ti] = torch.where(active, torch.cat([i, f, g, o], dim=-1), 0.0)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1), torch.stack(gs, dim=1)


def lstm_plain(
    xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """Plain PyTorch LSTM direction, (B, T, H) hidden states; differentiates
    through autograd (the model's plain path)."""
    return lstm_forward_plain(xw, w_hh, lengths, reverse)[0]


def _previous_in_sequence(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """x at the previous step in sequence order along T (t+1 when reverse),
    0 at the sequence start."""
    zero = torch.zeros_like(x[:, :1])
    return torch.cat([x[:, 1:], zero], dim=1) if reverse else torch.cat([zero, x[:, :-1]], dim=1)


def lstm_backward_plain(
    gout: torch.Tensor,
    gates: torch.Tensor,
    c: torch.Tensor,
    w_hh: torch.Tensor,
    lengths: torch.Tensor,
    reverse: bool = False,
) -> torch.Tensor:
    """Explicit BPTT, twin of the backward recurrence kernel: upstream
    dL/dh (B, T, H) and the forward's saved gates and c → dxw (B, T, 4H),
    the gradient of the pre-activation gates (0 on padded steps)."""
    b, t, hidden = gout.shape
    lengths = lengths.to(gout.device)
    c_prev = _previous_in_sequence(c, reverse)
    dh = gout.new_zeros(b, hidden)
    dc = gout.new_zeros(b, hidden)
    dxw = [None] * t
    for ti in (range(t) if reverse else range(t - 1, -1, -1)):
        i, f, g, o = gates[:, ti].chunk(4, dim=-1)
        th = torch.tanh(c[:, ti])
        dh_tot = dh + gout[:, ti]
        d_o = dh_tot * th * o * (1.0 - o)
        dct = dc + dh_tot * o * (1.0 - th * th)
        d_i = dct * g * i * (1.0 - i)
        d_f = dct * c_prev[:, ti] * f * (1.0 - f)
        d_g = dct * i * (1.0 - g * g)
        active = (ti < lengths)[:, None]
        dgates = torch.where(active, torch.cat([d_i, d_f, d_g, d_o], dim=-1), 0.0)
        dxw[ti] = dgates
        # a padded step carries h and c: their cotangents pass through
        dh = torch.where(active, dgates @ w_hh.t(), dh_tot)
        dc = torch.where(active, dct * f, dc)
    return torch.stack(dxw, dim=1)


def lstm_weight_grad_plain(h: torch.Tensor, dxw: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """dW_hh (H, 4H) = Σ_{b,t} h_prev[b, t]ᵀ · dxw[b, t], twin of the GEMM kernel."""
    return torch.einsum("bth,btg->hg", _previous_in_sequence(h, reverse), dxw)


def _lengths_i32(lengths: torch.Tensor, b: int, device: torch.device) -> torch.Tensor:
    if lengths.shape != (b,):
        raise ValueError("lstm: lengths must be (B,)")
    return lengths.to(device=device, dtype=torch.int32).contiguous()


def _check_hidden(w_hh: torch.Tensor, h4: int, what: str) -> int:
    hidden = h4 // 4
    if w_hh.shape != (hidden, h4) or h4 % 4 or not 1 <= hidden <= 1024 or w_hh.dtype != torch.float32:
        raise ValueError(f"{what}: w_hh must be (H, 4H) float32 with H <= 1024, got {tuple(w_hh.shape)}")
    return hidden


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")


def lstm_forward(
    xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, *, reverse: bool = False,
    save: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One LSTM direction over a padded batch → (h, c, gates): (B, T, H)
    float32 hidden states, and with ``save`` the cell states and the
    post-activation gates the backward needs (else None).  The kernel for
    CUDA tensors, the plain twin for CPU ones."""
    if xw.device.type == "cpu":
        h, c, gates = lstm_forward_plain(xw, w_hh, lengths, reverse)
        return (h, c, gates) if save else (h, None, None)
    _check_cuda(xw, "lstm_forward")
    b, t, h4 = xw.shape
    if xw.dtype != torch.float32:
        raise ValueError("lstm_forward: xw must be float32")
    hidden = _check_hidden(w_hh, h4, "lstm_forward")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    xw = xw.contiguous()
    w_hh = w_hh.to(xw.device).contiguous()
    lengths = _lengths_i32(lengths, b, xw.device)
    h = torch.empty(b, t, hidden, device=xw.device, dtype=torch.float32)
    c = torch.empty_like(h) if save else None
    gates = torch.empty_like(xw) if save else None
    err = build.library().lstm_fwd(
        xw.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(), h.data_ptr(),
        None if c is None else c.data_ptr(), None if gates is None else gates.data_ptr(),
        b, t, hidden, int(reverse), build.stream_of(xw),
    )
    build.check(err, "lstm_fwd")
    lstm_forward.launches += 1
    return h, c, gates


def lstm_backward(
    gout: torch.Tensor,
    gates: torch.Tensor,
    c: torch.Tensor,
    w_hh: torch.Tensor,
    lengths: torch.Tensor,
    *,
    reverse: bool = False,
) -> torch.Tensor:
    """BPTT recurrence → dxw (B, T, 4H) float32.  The kernel for CUDA
    tensors, the plain twin for CPU ones."""
    if gout.device.type == "cpu":
        return lstm_backward_plain(gout, gates, c, w_hh, lengths, reverse)
    _check_cuda(gout, "lstm_backward")
    b, t, h4 = gates.shape
    hidden = _check_hidden(w_hh, h4, "lstm_backward")
    for name, x, shape in (("gout", gout, (b, t, hidden)), ("c", c, (b, t, hidden))):
        if x.shape != shape or x.dtype != torch.float32:
            raise ValueError(f"lstm_backward: {name} must be {shape} float32, got {tuple(x.shape)} {x.dtype}")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    gout, gates, c = gout.contiguous(), gates.contiguous(), c.contiguous()
    w_hh_t = w_hh.t().contiguous()  # (4H, H): coalesced reads of dgates · W_hhᵀ
    lengths = _lengths_i32(lengths, b, gout.device)
    dxw = torch.empty_like(gates)
    err = build.library().lstm_bwd(
        gout.data_ptr(), gates.data_ptr(), c.data_ptr(), w_hh_t.data_ptr(), lengths.data_ptr(),
        dxw.data_ptr(), b, t, hidden, int(reverse), build.stream_of(gout),
    )
    build.check(err, "lstm_bwd")
    lstm_backward.launches += 1
    return dxw


def lstm_weight_grad(h: torch.Tensor, dxw: torch.Tensor, *, reverse: bool = False) -> torch.Tensor:
    """dW_hh (H, 4H) from the forward's h (B, T, H) and dxw (B, T, 4H).
    The GEMM kernel for CUDA tensors, the plain twin for CPU ones."""
    if h.device.type == "cpu":
        return lstm_weight_grad_plain(h, dxw, reverse)
    _check_cuda(h, "lstm_weight_grad")
    b, t, hidden = h.shape
    if dxw.shape != (b, t, 4 * hidden) or h.dtype != torch.float32 or dxw.dtype != torch.float32:
        raise ValueError("lstm_weight_grad: h must be (B, T, H) and dxw (B, T, 4H), float32")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    h, dxw = h.contiguous(), dxw.contiguous()
    dw = torch.empty(hidden, 4 * hidden, device=h.device, dtype=torch.float32)
    err = build.library().lstm_dwhh(
        h.data_ptr(), dxw.data_ptr(), dw.data_ptr(), b, t, hidden, int(reverse), build.stream_of(h),
    )
    build.check(err, "lstm_dwhh")
    lstm_weight_grad.launches += 1
    return dw


class LSTMSequence(torch.autograd.Function):
    """(xw, w_hh) → h with the backward of ``_lstm_seq`` (its
    ``custom_vjp`` in the JAX package): the forward saves h, c and the
    gates; the backward runs the recurrence, then the weight gradient."""

    @staticmethod
    def forward(ctx, xw, w_hh, lengths, reverse):
        h, c, gates = lstm_forward(xw, w_hh, lengths, reverse=reverse, save=True)
        ctx.save_for_backward(h, c, gates, w_hh, lengths)
        ctx.reverse = reverse
        return h

    @staticmethod
    def backward(ctx, gout):
        h, c, gates, w_hh, lengths = ctx.saved_tensors
        dxw = lstm_backward(gout.float(), gates, c, w_hh, lengths, reverse=ctx.reverse)
        dw = lstm_weight_grad(h, dxw, reverse=ctx.reverse) if ctx.needs_input_grad[1] else None
        return dxw, dw, None, None


def lstm(
    xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, *, reverse: bool = False
) -> torch.Tensor:
    """One LSTM direction over a padded batch, (B, T, H) float32 out,
    differentiable in ``xw`` and ``w_hh``.  With autograd recording it goes
    through `LSTMSequence` (forward kernel saving c and gates, then the
    backward kernels); otherwise the forward kernel stores h only.  CPU
    tensors run the plain twins in the same places."""
    if torch.is_grad_enabled() and (xw.requires_grad or w_hh.requires_grad):
        return LSTMSequence.apply(xw, w_hh, lengths, reverse)
    return lstm_forward(xw, w_hh, lengths, reverse=reverse)[0]


lstm_forward.launches = 0
lstm_backward.launches = 0
lstm_weight_grad.launches = 0
