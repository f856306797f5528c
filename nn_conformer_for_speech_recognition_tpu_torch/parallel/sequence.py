"""Sequence parallelism: Ulysses rel-pos attention over the data group, port
of `nn_conformer_for_speech_recognition_tpu/parallel/sequence.py`
(``ulysses_relpos_attention``, ``set_sequence_mesh``, ``sequence_mesh``,
``seq_parallel_applicable`` and its fallback counters).

The Ulysses scheme: an all-to-all exchanges a shard of the time axis (or,
in the model, of the batch rows) for a shard of the heads, each rank runs
full-length rel-pos attention on its H/n heads with the rel-pos table and
the u and v biases sliced to those heads, and a second all-to-all gives
every rank its own shard back.  `ulysses_relpos_attention` keeps the JAX
function's contract (q, k, v split over time); the model calls
`ulysses_relpos_attention_rows`, which starts from the layout a data rank
holds anyway (its rows at full length, `parallel.mesh.DataShard`) and so
needs one exchange each way instead of a rows-to-time and a time-to-heads
one.  The local attention is the rel-pos kernels (``use_kernel``) or the
einsum twin, which here, as in the JAX package, drops no attention
probabilities.

``MeshConfig.seq_parallel`` makes the trainers set the ambient layout
(`set_sequence_mesh`), which `models.conformer.RelPositionMHSA` reads on
every forward.  Every decision is counted (`fallback_stats`), and the first
fallback for each distinct reason logs a warning.
"""

from __future__ import annotations

import contextlib
import logging
from typing import Optional, Tuple

import torch

from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.attention import (
    flash_relpos_attention,
    flash_relpos_attention_plain,
)
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import Axis, Mesh, all_gather, all_to_all

_ACTIVE_SEQ: Optional[Tuple[Mesh, str]] = None


def set_sequence_mesh(mesh: Optional[Mesh], axis: str = "data") -> None:
    """Activate (or deactivate with ``mesh=None``) sequence parallelism for
    every attention layer's forward from now on."""
    global _ACTIVE_SEQ
    if mesh is None:
        _ACTIVE_SEQ = None
        return
    mesh.axis(axis)  # raises for an axis the layout lacks
    _ACTIVE_SEQ = (mesh, axis)


def active_sequence_mesh() -> Optional[Tuple[Mesh, str]]:
    return _ACTIVE_SEQ


@contextlib.contextmanager
def sequence_mesh(mesh: Optional[Mesh], axis: str = "data"):
    global _ACTIVE_SEQ
    prev = _ACTIVE_SEQ
    set_sequence_mesh(mesh, axis)
    try:
        yield
    finally:
        _ACTIVE_SEQ = prev


def _local_attention(q, k, v, p, u_bias, v_bias, lengths, scale: float, use_kernel: bool) -> torch.Tensor:
    """Full-length rel-pos attention of (B, T, h, dh) q, k, v on h heads with
    their (2T-1, h, dh) table and (h, dh) biases."""
    qu, qv = q + u_bias.to(q.dtype), q + v_bias.to(q.dtype)
    if use_kernel:
        return flash_relpos_attention(qu, qv, k, v, p, lengths, scale)
    return flash_relpos_attention_plain(qu, qv, k, v, p, lengths, scale)


def _heads(axis: Axis, h: int) -> slice:
    n = h // axis.size
    return slice(axis.rank * n, (axis.rank + 1) * n)


def ulysses_relpos_attention(
    q: torch.Tensor,  # (B, T/n, H, dh): this rank's shard of the time axis
    k: torch.Tensor,
    v: torch.Tensor,
    p: torch.Tensor,  # (2T-1, H/n, dh): this rank's heads of the projected rel-pos table
    u_bias: torch.Tensor,  # (H/n, dh): this rank's heads
    v_bias: torch.Tensor,
    lengths: torch.Tensor,  # (B,) valid frames, the same on every rank
    scale: float,
    mesh: Mesh,
    axis: str = "data",
    use_kernel: bool = False,
) -> torch.Tensor:
    """Ulysses attention with Transformer-XL relative positions, as the JAX
    function under ``shard_map``: the time axis split over ``axis``, one
    all-to-all to (B, T, H/n, dh), full-length attention on this rank's
    heads, one all-to-all back.  Returns this rank's (B, T/n, H, dh) shard;
    differentiable in q, k, v, p and the biases."""
    ax = mesh.axis(axis)
    q_f, k_f, v_f = (all_to_all(x, ax, split_dim=2, concat_dim=1) for x in (q, k, v))
    out = _local_attention(q_f, k_f, v_f, p, u_bias, v_bias, lengths, scale, use_kernel)
    return all_to_all(out, ax, split_dim=1, concat_dim=2)


def ulysses_relpos_attention_rows(
    q: torch.Tensor,  # (b, T, H, dh): this rank's rows of the global batch
    k: torch.Tensor,
    v: torch.Tensor,
    p_heads: torch.Tensor,  # (2T-1, H/n, dh): this rank's heads of the table
    u_bias: torch.Tensor,  # (H, dh): every head
    v_bias: torch.Tensor,
    lengths: torch.Tensor,  # (b,) this rank's rows' valid frames
    scale: float,
    axis: Axis,
    use_kernel: bool = False,
) -> torch.Tensor:
    """The model's route: the rows a data rank holds exchanged for its heads
    of every row (one all-to-all), full-length attention on (n·b, T, H/n,
    dh), the rows sent back (one all-to-all).  The rank's u and v heads are
    slices of the whole biases, so their gradients, like ``p_heads``', cover
    this rank's heads only and the data group's gradient sum adds each head
    once."""
    heads = _heads(axis, q.shape[2])
    q_f, k_f, v_f = (all_to_all(x, axis, split_dim=2, concat_dim=0) for x in (q, k, v))
    lengths_all = all_gather(lengths.to(torch.int32), axis)
    out = _local_attention(q_f, k_f, v_f, p_heads, u_bias[heads], v_bias[heads], lengths_all, scale, use_kernel)
    return all_to_all(out, axis, split_dim=0, concat_dim=2)


def seq_parallel_applicable(mesh: Mesh, axis: str, t: int, h: int, record: bool = True) -> bool:
    """Both all-to-alls and the head slice need exact divisibility: the
    axis larger than 1, the heads and T divisible by its size.  Falling back
    is correct (the dense path computes the same attention) but not
    silent: every decision is counted in `fallback_stats()` and the first
    fallback for each distinct reason logs a warning."""
    n = mesh.axis(axis).size
    reasons = []
    if n <= 1:
        reasons.append(f"axis {axis!r} has size {n} (need > 1)")
    if h % n != 0:
        reasons.append(f"heads {h} % mesh {n} != 0")
    if t % n != 0:
        reasons.append(f"T {t} % mesh {n} != 0")
    ok = not reasons
    if record:
        _record("seq_parallel", ok, "; ".join(reasons))
    return ok


def sequence_mesh_engaged() -> bool:
    """Whether an active sequence layout spreads over more than one rank."""
    return _ACTIVE_SEQ is not None and _ACTIVE_SEQ[0].axis(_ACTIVE_SEQ[1]).size > 1


def kernel_sharding_applicable(mesh: Mesh, axis: str, batch: int) -> bool:
    """``MeshConfig.shard_map_kernels``: the JAX package wraps its kernels
    in ``shard_map`` over ``axis`` so that each device's kernel sees its
    rows only, where the batch divides over the axis.  A rank here runs its
    kernels on its rows whatever the field says; the decision is counted
    (``fallback_stats('shard_map_kernels')``) under the JAX rule: engaged
    where the axis is larger than 1 and ``batch`` divides over it."""
    n = mesh.axis(axis).size
    reason = f"axis {axis!r} has size {n} (need > 1)" if n <= 1 else (
        f"batch {batch} % mesh {n} != 0" if batch % n else "")
    _record("shard_map_kernels", not reason, reason)
    return not reason


# ---------------------------------------------------------------------------
# fallback observability: engagement counters and one warning per reason
# ---------------------------------------------------------------------------

_LOG = logging.getLogger("nn_conformer_for_speech_recognition_tpu_torch.parallel")
_STATS: dict = {}
_WARNED: set = set()


def _record(feature: str, engaged: bool, reason: str = "") -> None:
    s = _STATS.setdefault(feature, {"engaged": 0, "fallback": 0, "reasons": {}})
    if engaged:
        s["engaged"] += 1
        return
    s["fallback"] += 1
    s["reasons"][reason] = s["reasons"].get(reason, 0) + 1
    key = (feature, reason)
    if key not in _WARNED:
        _WARNED.add(key)
        _LOG.warning("%s requested but falling back to the dense/unsharded path: %s", feature, reason)


def fallback_stats(feature: Optional[str] = None):
    """Engagement counters: {feature: {engaged, fallback, reasons: {reason:
    count}}}, for ``seq_parallel`` and ``shard_map_kernels``: a snapshot,
    which later decisions leave as it is."""
    snap = lambda s: {**s, "reasons": dict(s["reasons"])}  # noqa: E731
    if feature is not None:
        return snap(_STATS.get(feature, {"engaged": 0, "fallback": 0, "reasons": {}}))
    return {k: snap(v) for k, v in _STATS.items()}


def reset_fallback_stats() -> None:
    _STATS.clear()
    _WARNED.clear()
