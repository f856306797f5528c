"""CTC loss, port of `nn_conformer_for_speech_recognition_tpu/ops/ctc.py`.

The plain version: the log-space forward (alpha) recursion as a float32
loop over T, with labels padded to a fixed length, the blank-interleaved
extended sequence of static length S = 2L+1, and per-example lengths only
in masks.  Its gradient comes from autograd.  The hand-written alpha/beta
kernels and their autograd Function live in `ops/cuda/ctc.py`; both share
the label machinery and the reduction below.

``zero_infinity`` follows torch's ``CTCLoss``: a row with no valid
alignment (target too long for its input) gets loss 0 and gradient 0.
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch

LOG_EPS = -1e30  # effectively log(0) without producing nan gradients


def _logaddexp3(a: torch.Tensor, b: torch.Tensor, c: torch.Tensor) -> torch.Tensor:
    m = torch.maximum(torch.maximum(a, b), c)
    m_safe = torch.where(m <= LOG_EPS, 0.0, m)
    # subtracting m_safe keeps exps ≤ 1; clamping the sum away from 0 keeps
    # log (and its gradient) finite when every operand is log(0)
    s = torch.exp(a - m_safe) + torch.exp(b - m_safe) + torch.exp(c - m_safe)
    out = m_safe + torch.log(torch.clamp_min(s, 1e-37))
    return torch.where(m <= LOG_EPS, LOG_EPS, out)


def extended_labels(
    labels: torch.Tensor, label_lengths: torch.Tensor, blank_id: int
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
    """(B, L) labels → ext (B, S) ids, can_skip (B, S) bool, valid_pos
    (B, S) bool and ext_len (B,), with S = 2L+1."""
    b, l = labels.shape
    s = 2 * l + 1
    ext = torch.full((b, s), blank_id, dtype=labels.dtype, device=labels.device)
    ext[:, 1::2] = labels
    # alpha may skip from s-2 only at a label position whose label differs
    # from the label two back
    prev2 = torch.cat([torch.full_like(ext[:, :2], -1), ext[:, :-2]], dim=1)
    pos = torch.arange(s, device=labels.device)[None, :]
    can_skip = (pos % 2 == 1) & (ext != prev2)
    ext_len = 2 * label_lengths.to(labels.device) + 1
    valid_pos = pos < ext_len[:, None]
    return ext, can_skip, valid_pos, ext_len


class EmitGather(torch.autograd.Function):
    """(B, T, V) log-probs → (B, T, S) emit at the extended labels ``ext``
    (B, S).  The forward is a gather, which selects exactly what the JAX
    package's one-hot contraction at HIGHEST precision selects.  The adjoint
    puts each state's gradient back on its vocabulary column; every blank
    state of a row lands on the one blank column, so torch's own adjoint of
    a gather (a scatter-add with atomics on CUDA) sums those S/2 terms in
    another order on every run, and two runs of a train step differ in
    their last bits.  Here the adjoint is the JAX package's: the transposed
    one-hot contraction, one batched product in float64 (exact for these
    sums whatever the matmul precision settings) rounded once, summed in a
    fixed order, so bit-equal from run to run."""

    @staticmethod
    def forward(ctx, log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
        b, t, vocab = log_probs.shape
        ctx.save_for_backward(ext)
        ctx.vocab = vocab
        index = ext.to(torch.int64)[:, None, :].expand(b, t, ext.shape[1])
        return torch.gather(log_probs, 2, index)

    @staticmethod
    def backward(ctx, g: torch.Tensor):
        (ext,) = ctx.saved_tensors
        onehot = torch.nn.functional.one_hot(ext.to(torch.int64), ctx.vocab).to(torch.float64)
        return torch.bmm(g.to(torch.float64), onehot).to(g.dtype), None


def emit_log_probs(log_probs: torch.Tensor, ext: torch.Tensor) -> torch.Tensor:
    """emit[b, t, s] = log_probs[b, t, ext[b, s]], differentiable in
    ``log_probs`` with a deterministic adjoint (`EmitGather`)."""
    return EmitGather.apply(log_probs, ext)


def alpha_recursion(
    emit: torch.Tensor, can_skip: torch.Tensor, valid_pos: torch.Tensor, input_lengths: torch.Tensor
) -> torch.Tensor:
    """(B, T, S) emit log-probs → (B, T, S) alpha at every frame: s-1
    transitions always, s-2 where ``can_skip``, invalid states at LOG_EPS,
    and alpha carried unchanged from t = input length on."""
    s = emit.shape[2]
    first = torch.arange(s, device=emit.device)[None, :] < 2
    alpha = torch.where(first & valid_pos, emit[:, 0], LOG_EPS)
    eps = torch.full_like(alpha[:, :2], LOG_EPS)
    alphas = [alpha]
    for ti in range(1, emit.shape[1]):
        shift1 = torch.cat([eps[:, :1], alpha[:, :-1]], dim=1)
        shift2 = torch.where(can_skip, torch.cat([eps, alpha[:, :-2]], dim=1)[:, :s], LOG_EPS)
        new = _logaddexp3(alpha, shift1, shift2) + emit[:, ti]
        new = torch.where(valid_pos, new, LOG_EPS)
        alpha = torch.where((ti < input_lengths)[:, None], new, alpha)
        alphas.append(alpha)
    return torch.stack(alphas, dim=1)


def state_masks(ext_len: torch.Tensor, s: int) -> Tuple[torch.Tensor, torch.Tensor]:
    """(B, S) masks of the valid states (s < ext_len) and of the end
    states {ext_len-1, ext_len-2} (only ext_len-1 for an empty label)."""
    pos = torch.arange(s, device=ext_len.device)[None, :]
    valid = pos < ext_len[:, None]
    fin = (pos == (ext_len - 1)[:, None]) | ((pos == (ext_len - 2)[:, None]) & (ext_len >= 2)[:, None])
    return valid, fin


def final_ll(alpha_last: torch.Tensor, ext_len: torch.Tensor) -> torch.Tensor:
    """Per-row log-likelihood: masked logsumexp of the last alpha over the
    end states; LOG_EPS for an impossible row."""
    _, fin = state_masks(ext_len, alpha_last.shape[1])
    a_fin = torch.where(fin, alpha_last, LOG_EPS)
    m = a_fin.max(dim=1).values
    dead = m <= LOG_EPS / 2
    m_safe = torch.where(dead, 0.0, m)
    ll = m_safe + torch.log(torch.clamp_min(torch.exp(a_fin - m_safe[:, None]).sum(dim=1), 1e-37))
    return torch.where(dead, LOG_EPS, ll)


def apply_reduction(
    nll: torch.Tensor,
    ll: torch.Tensor,
    label_lengths: torch.Tensor,
    zero_infinity: bool,
    reduction: Optional[str],
) -> torch.Tensor:
    """torch-CTCLoss reduction and ``zero_infinity`` semantics."""
    if zero_infinity:
        nll = torch.where(ll <= LOG_EPS / 2, 0.0, nll)
    if reduction is None or reduction == "none":
        return nll
    if reduction == "sum":
        return nll.sum()
    if reduction == "mean":
        # per-sequence loss / target length, then the batch mean
        return (nll / torch.clamp_min(label_lengths.to(nll.device), 1).to(nll.dtype)).mean()
    raise ValueError(f"unknown reduction {reduction!r}")


def ctc_loss(
    log_probs: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
    zero_infinity: bool = True,
    reduction: Optional[str] = "mean",
) -> torch.Tensor:
    """Connectionist Temporal Classification loss, plain recursion.

    log_probs: (B, T, V) log-softmax outputs; labels: (B, L) target ids
    (anything beyond a row's length is ignored); input_lengths and
    label_lengths: (B,).  Returns a scalar, or the (B,) per-sequence
    negative log-likelihood for ``reduction=None``.
    """
    ext, can_skip, valid_pos, ext_len = extended_labels(labels, label_lengths, blank_id)
    emit = emit_log_probs(log_probs.float(), ext)  # (B, T, S)
    alpha = alpha_recursion(emit, can_skip, valid_pos, input_lengths.to(emit.device))
    ll = final_ll(alpha[:, -1], ext_len)
    return apply_reduction(-ll, ll, label_lengths, zero_infinity, reduction)


def ctc_loss_from_logits(
    logits: torch.Tensor,
    labels: torch.Tensor,
    input_lengths: torch.Tensor,
    label_lengths: torch.Tensor,
    blank_id: int = 0,
    **kw,
) -> torch.Tensor:
    """`ctc_loss` after a log_softmax over the vocabulary."""
    return ctc_loss(
        torch.log_softmax(logits, dim=-1), labels, input_lengths, label_lengths,
        blank_id=blank_id, **kw,
    )
