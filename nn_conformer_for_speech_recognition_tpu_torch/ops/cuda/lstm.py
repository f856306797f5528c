"""One LSTM direction, forward: kernel wrapper and plain twin.

Replaces the TPU kernel
`nn_conformer_for_speech_recognition_tpu/ops/pallas/lstm.py:_fwd_kernel`
(called through ``_lstm_forward`` / ``lstm_pallas``), forward only and
returning h only (the saved gates and c serve the backward, which is not
ported yet).  Gate math matches flax's LSTMCell (i, f, g, o order); rows
freeze once t ≥ length, so padded steps emit the carried h and the reverse
direction starts at each row's own len-1.  The input projection x·W_ih + b
stays one matmul outside, as in the JAX package.

The CUDA kernel (`csrc/lstm.cu`) runs all T steps in one launch: one block
per batch row, thread j owning hidden unit j and its four gate columns, h
double-buffered in shared memory, h and c in float32.

What bounds it on the H100: each step reads all of W_hh (H × 4H float32,
1.6 MB for Conformer-M's H=320) from L2 in every block, which exceeds one
SM's 227 KB of shared memory; with B=16 only 16 of the 132 SMs work, and
the T steps are strictly sequential.  A cluster split of W_hh over
distributed shared memory is later work.
"""

from __future__ import annotations

import torch


def lstm_plain(
    xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """Plain PyTorch twin: (B, T, 4H) float32 xw, (H, 4H) w_hh, (B,) lengths
    → (B, T, H) hidden states."""
    b, t, h4 = xw.shape
    hx = xw.new_zeros(b, h4 // 4)
    cx = xw.new_zeros(b, h4 // 4)
    outs = [None] * t
    for ti in (range(t - 1, -1, -1) if reverse else range(t)):
        i, f, g, o = (xw[:, ti] + hx @ w_hh).chunk(4, dim=-1)
        c_new = torch.sigmoid(f) * cx + torch.sigmoid(i) * torch.tanh(g)
        h_new = torch.sigmoid(o) * torch.tanh(c_new)
        active = (ti < lengths)[:, None]
        hx = torch.where(active, h_new, hx)
        cx = torch.where(active, c_new, cx)
        outs[ti] = hx
    return torch.stack(outs, dim=1)


def lstm(
    xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, *, reverse: bool = False
) -> torch.Tensor:
    """One LSTM direction over a padded batch, (B, T, H) float32 out.  The
    kernel for CUDA tensors, the plain twin for CPU ones."""
    if xw.device.type == "cpu":
        return lstm_plain(xw, w_hh, lengths, reverse)
    if xw.device.type != "cuda":
        raise ValueError(f"lstm: unsupported device {xw.device}")
    b, t, h4 = xw.shape
    hidden = h4 // 4
    if xw.dtype != torch.float32 or w_hh.dtype != torch.float32:
        raise ValueError("lstm: xw and w_hh must be float32")
    if w_hh.shape != (hidden, h4) or h4 % 4 or not 1 <= hidden <= 1024:
        raise ValueError(f"lstm: w_hh must be (H, 4H) with H <= 1024, got {tuple(w_hh.shape)}")
    if lengths.shape != (b,):
        raise ValueError("lstm: lengths must be (B,)")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    xw = xw.contiguous()
    w_hh = w_hh.to(xw.device).contiguous()
    lengths = lengths.to(device=xw.device, dtype=torch.int32).contiguous()
    out = torch.empty(b, t, hidden, device=xw.device, dtype=torch.float32)
    err = build.library().lstm_fwd(
        xw.data_ptr(), w_hh.data_ptr(), lengths.data_ptr(), out.data_ptr(),
        b, t, hidden, int(reverse), build.stream_of(xw),
    )
    build.check(err, "lstm")
    lstm.launches += 1
    return out


lstm.launches = 0
