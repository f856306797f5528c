"""Adafactor's update and the gradients' global norm as multi-tensor
kernels (`csrc/adafactor.cu`): the wrappers and their tables.

They replace no TPU kernel.  The JAX package leaves ``optax.adafactor``
and ``optax.global_norm`` to XLA; the port's per-tensor loops
(`train.optim.Adafactor.step`, `train.loop.optax_global_norm`) launch one
small kernel per tensor op, ~12,700 a Conformer-M step, whose host time
left the card idle.  Here one launch walks every parameter: four for
Adafactor's passes (moments, factors, clip sums, apply) and two for the
norm (partials, finish), whatever the number of parameters.

The route is decided by what the caller holds: the kernels run where every
tensor is a float32 CUDA tensor (`on_kernel_route`) and, for Adafactor, no
tensor-parallel plan splits the parameters; otherwise the per-tensor loops
run, unchanged.  Those loops are the plain twins: the CPU tests hold them
to ``optax`` and the card tests hold the kernels to them.

`AdafactorTable` is built once per optimizer: each parameter's row of
int64 fields (`META_FIELDS`) and the job lists of the four passes, each job
(kind, parameter, first element or output, count) one block.  The
pointers are read from the live tensors at every step (the gradients are
new each step; `train.checkpoint.restore_state` and a deep copy rebind the
slots), carried to the card in a fresh pinned tensor, whose reuse the
caching host allocator holds back until its copy has run.  The elementwise
slots ``v`` and ``ema`` are JAX-shaped views of memory in the port's order
(`train.optim.Adafactor` creates them so), so one linear index walks the
parameter, its gradient and both; a slot found in another layout (as the
per-tensor loop leaves it) is laid out so once (`_port_ordered`).
"""

from __future__ import annotations

import dataclasses
import functools
import math
from typing import Dict, Iterable, List, Optional, Sequence, Tuple

import numpy as np
import torch

CHUNK = 4096  # elements a block takes in an elementwise pass (the kernels' kChunk)
WARPS = 8  # outputs a block takes in a reduction, one a warp (the kernels' kWarps)
MAX_DIMS = 4

# a parameter's row of the meta table, int64 fields in the kernels' order: elements; its first chunk among all and
# its chunks; its first row and column factor in the scratch; the largest axis's length and port stride (v_row
# averages over it), the second largest's and its stride in the port's memory and inside v_row; then the walks
# (nd, MAX_DIMS sizes, MAX_DIMS strides each): a v_row entry → the port offset of its first element, a v_col
# entry → the same, a batch slice → the v_row offset of its first entry; and a port offset → (v_row index, v_col
# index), with two sets of strides
N, CHUNK0, CHUNKS, ROW0, COL0, L0, S0, L1, S1, RS1 = range(10)
WALK_ROW, WALK_COL, WALK_BATCH, WALK_ELEM = 10, 19, 28, 37
META_FIELDS = 50
# a parameter's row of the pointer table, read anew at each step: p, g, v or v_row, v_col (0: none), ema (0: none)

# job kinds, by pass: moments (UNFACTORED, ROW_SUMS, COL_SUMS), factors (BATCH_MEANS, COL_FACTORS), clip sums
# (CLIP_SUMS), apply (APPLY)
UNFACTORED, ROW_SUMS, COL_SUMS, BATCH_MEANS, COL_FACTORS, CLIP_SUMS, APPLY = range(7)
PASSES = ("moments", "factors", "clip_sums", "apply")


def on_kernel_route(tensors: Iterable[Optional[torch.Tensor]]) -> bool:
    """Whether the multi-tensor kernels take these tensors: there is at
    least one, and every one is a float32 CUDA tensor."""
    seen = False
    for t in tensors:
        if t is None or not t.is_cuda or t.dtype != torch.float32:
            return False
        seen = True
    return seen


def _contiguous_strides(shape: Sequence[int]) -> List[int]:
    strides, acc = [], 1
    for n in reversed(shape):
        strides.append(acc)
        acc *= n
    return strides[::-1]


def _walk(sizes: Sequence[int], *strides: Sequence[int]) -> List[int]:
    pad = MAX_DIMS - len(sizes)
    out = [len(sizes), *sizes, *[1] * pad]
    for s in strides:
        out += [*s, *[0] * pad]
    return out


def _split(kind: int, param: int, total: int, per_job: int = CHUNK) -> np.ndarray:
    """Jobs (kind, param, first, count) over ``total`` elements or outputs, ``per_job`` a job."""
    starts = np.arange(0, total, per_job, dtype=np.int64)
    return np.stack([np.full_like(starts, kind), np.full_like(starts, param), starts,
                     np.minimum(per_job, total - starts)], axis=1)


def _jobs(parts: List[np.ndarray], device) -> torch.Tensor:
    table = np.concatenate(parts) if parts else np.zeros((0, 4), np.int64)
    return torch.from_numpy(table.astype(np.int32)).to(device)


@dataclasses.dataclass
class AdafactorTable:
    """Adafactor's static table over ``params`` (`train.optim.Adafactor`'s
    ``(name, p, axes, dims, split)`` tuples) on their device: the meta rows,
    the four passes' job lists, the scratch sizes (chunks, v_row and v_col
    entries of all factored parameters) and each parameter's ``v``/``ema``
    strides (its JAX shape over port-ordered memory)."""

    meta: torch.Tensor
    moments: torch.Tensor
    factors: torch.Tensor
    clip_sums: torch.Tensor
    apply: torch.Tensor
    chunks: int
    rows: int
    cols: int
    slot_strides: List[Tuple[int, ...]]
    device: torch.device

    @classmethod
    def build(cls, params) -> "AdafactorTable":
        meta, strides = [], []
        jobs: Dict[str, List[np.ndarray]] = {k: [] for k in PASSES}
        chunks = rows = cols = 0
        device = params[0][1].device if params else torch.device("cpu")
        for i, (name, p, axes, dims, _) in enumerate(params):
            n = p.numel()
            if p.dim() > MAX_DIMS or n >= 2 ** 31 or not p.is_contiguous():
                raise ValueError(f"adafactor kernels: {name} {tuple(p.shape)} must be contiguous, of at most "
                                 f"{MAX_DIMS} axes and 2**31 elements")
            port = _contiguous_strides(p.shape)
            shape = [p.shape[a] for a in axes]  # the JAX layout
            js = [port[a] for a in axes]  # each JAX axis's stride in the port's memory
            strides.append(tuple(js))
            row = [0] * META_FIELDS
            n_chunks = -(-n // CHUNK)
            row[N], row[CHUNK0], row[CHUNKS] = n, chunks, n_chunks
            jobs["apply"].append(_split(APPLY, i, n))
            if dims is None:
                jobs["moments"].append(_split(UNFACTORED, i, n))
            else:
                d1, d0 = dims  # the second largest axis and the largest
                row_axes = [j for j in range(len(shape)) if j != d0]  # v_row's axes
                col_axes = [j for j in range(len(shape)) if j != d1]
                batch_axes = [j for j in range(len(shape)) if j not in dims]
                vr = dict(zip(row_axes, _contiguous_strides([shape[j] for j in row_axes])))
                vc = dict(zip(col_axes, _contiguous_strides([shape[j] for j in col_axes])))
                n_rows, n_cols = math.prod(shape[j] for j in row_axes), math.prod(shape[j] for j in col_axes)
                batches = math.prod(shape[j] for j in batch_axes)
                row[ROW0], row[COL0] = rows, cols
                row[L0], row[S0], row[L1], row[S1], row[RS1] = shape[d0], js[d0], shape[d1], js[d1], vr[d1]
                row[WALK_ROW:WALK_COL] = _walk([shape[j] for j in row_axes], [js[j] for j in row_axes])
                row[WALK_COL:WALK_BATCH] = _walk([shape[j] for j in col_axes], [js[j] for j in col_axes])
                row[WALK_BATCH:WALK_ELEM] = _walk([shape[j] for j in batch_axes], [vr[j] for j in batch_axes])
                jax_axis = [axes.index(k) for k in range(p.dim())]  # the JAX axis of each port axis
                row[WALK_ELEM:META_FIELDS] = _walk(list(p.shape), [vr.get(j, 0) for j in jax_axis],
                                                   [vc.get(j, 0) for j in jax_axis])
                jobs["moments"] += [_split(ROW_SUMS, i, n_rows, WARPS), _split(COL_SUMS, i, n_cols, WARPS)]
                jobs["factors"] += [_split(BATCH_MEANS, i, batches, WARPS), _split(COL_FACTORS, i, n_cols)]
                jobs["clip_sums"].append(_split(CLIP_SUMS, i, n))
                rows, cols = rows + n_rows, cols + n_cols
            chunks += n_chunks
            meta.append(row)
        return cls(meta=torch.tensor(meta, dtype=torch.int64).reshape(-1, META_FIELDS).to(device),
                   **{k: _jobs(v, device) for k, v in jobs.items()}, chunks=chunks, rows=rows, cols=cols,
                   slot_strides=strides, device=device)

    def launches(self, clip: bool) -> int:
        """Kernels a step launches (a pass without jobs is not launched)."""
        return sum(len(getattr(self, k)) > 0 for k in PASSES if clip or k != "clip_sums")


def _port_ordered(st: Dict[str, torch.Tensor], key: str, p: torch.Tensor, axes, strides) -> torch.Tensor:
    """``st[key]``, an elementwise slot of JAX shape; where it is not laid
    out in ``p``'s memory order (``strides``), it is copied into a tensor
    that is, which takes its place in ``st``."""
    t = st[key]
    if t.stride() != strides:
        fresh = torch.empty(p.shape, dtype=p.dtype, device=p.device).permute(axes)
        fresh.copy_(t)
        st[key] = t = fresh
    return t


def _slots(table: AdafactorTable, params, state) -> List[Tuple[torch.Tensor, ...]]:
    """Each parameter's (p, g, v or v_row, v_col or None, ema or None) as
    the kernels read them: the slots laid out (`_port_ordered`, v_row
    and v_col contiguous), a gradient that is not contiguous copied."""
    out = []
    for (name, p, axes, dims, _), strides in zip(params, table.slot_strides):
        g = p.grad
        if g is None:
            raise RuntimeError(f"Adafactor: {name} has no gradient")
        if not g.is_contiguous():
            g = g.contiguous()
        st = state[name]
        if dims is None:
            a, b = _port_ordered(st, "v", p, axes, strides), None
        else:
            for k in ("v_row", "v_col"):
                if not st[k].is_contiguous():
                    st[k] = st[k].contiguous()
            a, b = st["v_row"], st["v_col"]
        ema = _port_ordered(st, "ema", p, axes, strides) if "ema" in st else None
        out.append((p, g, a, b, ema))
    return out


def adafactor_step(table: AdafactorTable, params, state, *, lr: float, keep: float, take: float, eps: float,
                   clipping_threshold: Optional[float], momentum: Optional[float],
                   weight_decay_rate: Optional[float]) -> None:
    """One Adafactor update of every parameter in ``params`` from its
    ``.grad``, in place, by the kernels: ``state`` (the optimizer's slots by
    name) is read and written; ``keep``/``take`` are the decay and its
    complement at this step.  Every tensor must be a float32 CUDA tensor."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    slots = _slots(table, params, state)
    host = torch.tensor([0 if t is None else t.data_ptr() for row in slots for t in row], dtype=torch.int64)
    ptrs = host.pin_memory().to(table.device, non_blocking=True)
    scratch = torch.empty(table.chunks + table.rows + table.cols, dtype=torch.float32, device=table.device)
    usq = scratch.data_ptr()
    rf, cf = usq + 4 * table.chunks, usq + 4 * (table.chunks + table.rows)
    clip = clipping_threshold is not None
    err = build.library().adafactor_step(
        table.meta.data_ptr(), ptrs.data_ptr(), *(x for k in PASSES for x in (getattr(table, k).data_ptr(),
                                                                              len(getattr(table, k)))),
        usq, rf, cf, keep, take, eps, lr, int(clip), clipping_threshold if clip else 1.0, int(momentum is not None),
        momentum or 0.0, 1.0 - momentum if momentum is not None else 0.0, int(weight_decay_rate is not None),
        weight_decay_rate or 0.0, build.stream_of(scratch),
    )
    build.check(err, "adafactor")
    adafactor_step.launches += table.launches(clip)
    adafactor_step.params += len(params)


adafactor_step.launches = 0
adafactor_step.params = 0  # parameters updated by the kernels


def norm_jobs(sizes: Tuple[int, ...]) -> np.ndarray:
    """The norm's chunk jobs (0, tensor, first element, count) over tensors
    of ``sizes`` elements, in order."""
    parts = [_split(0, i, n) for i, n in enumerate(sizes)]
    return np.concatenate(parts) if parts else np.zeros((0, 4), np.int64)


@functools.lru_cache(maxsize=8)
def _norm_table(sizes: Tuple[int, ...], device: torch.device) -> torch.Tensor:
    return torch.from_numpy(norm_jobs(sizes).astype(np.int32)).to(device)


def global_norm(tensors: Sequence[torch.Tensor]) -> torch.Tensor:
    """sqrt(Σ x²) over ``tensors`` (float32 CUDA, `on_kernel_route`), a 0-d
    float32 tensor, in two launches: a float32 partial a chunk, then their
    sum in chunk order in float64 and its square root."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    tensors = [t if t.is_contiguous() else t.contiguous() for t in tensors]
    device = tensors[0].device
    jobs = _norm_table(tuple(t.numel() for t in tensors), device)
    ptrs = torch.tensor([t.data_ptr() for t in tensors], dtype=torch.int64).pin_memory().to(device, non_blocking=True)
    part = torch.empty(max(len(jobs), 1), dtype=torch.float32, device=device)
    out = torch.empty((), dtype=torch.float32, device=device)
    err = build.library().global_norm(ptrs.data_ptr(), jobs.data_ptr(), len(jobs), part.data_ptr(), out.data_ptr(),
                                      build.stream_of(out))
    build.check(err, "global_norm")
    global_norm.launches += 1 + (len(jobs) > 0)
    return out


global_norm.launches = 0

