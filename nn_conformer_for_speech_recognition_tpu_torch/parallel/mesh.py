"""Data parallelism over processes, port of the data-parallel half of
`nn_conformer_for_speech_recognition_tpu/parallel/mesh.py`.

The JAX package lays a ``('data', 'model')`` mesh over every device it
sees and shards each batch's leading axis over ``data``; GSPMD inserts the
gradient sum.  Here each process drives one card, started by ``torchrun``
(`initialize_multihost`), every process reads the same global batch and
keeps its contiguous share of the rows (`DataShard`, `batch_rows`), and the
collectives are explicit: the masked BatchNorm's sums
(`models.conformer.MaskedBatchNorm`), the loss's count of rows with a
target, and one all-reduce of the flat gradient after the backward
(`train.loop.make_feature_train_step`).  Model parallelism, sequence
parallelism and kernel sharding (``MeshConfig.model_parallel_size``,
``seq_parallel``, ``shard_map_kernels``) raise (ROADMAP Queue 1 item 13b).
"""

from __future__ import annotations

import dataclasses
import os

import torch
import torch.distributed as dist

from nn_conformer_for_speech_recognition_tpu_torch.config import MeshConfig

# host-side gathers of CPU tensors go over gloo, the card's tensors over NCCL
BACKEND = "cpu:gloo,cuda:nccl"
ITEM_13B = "ROADMAP Queue 1 item 13b, Multi-GPU"


def process_group_active() -> bool:
    """True once `initialize_multihost` (or the caller) has made a process
    group, at any world size: the data-parallel path then issues its
    collectives."""
    return dist.is_available() and dist.is_initialized()


def initialize_multihost(device: str = "cuda") -> None:
    """Joins the process group that ``torchrun`` describes (``RANK``,
    ``WORLD_SIZE``, ``LOCAL_RANK``, ``MASTER_ADDR``, ``MASTER_PORT``):
    `BACKEND` with ``device="cuda"``, after ``torch.cuda.set_device
    (LOCAL_RANK)``; gloo alone with ``device="cpu"``.  A no-op in a single
    process (no ``WORLD_SIZE`` above 1) and where a group exists."""
    world = int(os.environ.get("WORLD_SIZE", "1"))
    if world <= 1 or process_group_active():
        return
    backend = "gloo"
    if device != "cpu":
        torch.cuda.set_device(int(os.environ["LOCAL_RANK"]))
        backend = BACKEND
    dist.init_process_group(backend=backend, init_method="env://", rank=int(os.environ["RANK"]), world_size=world)


@dataclasses.dataclass(frozen=True)
class DataShard:
    """The rank's contiguous share of a batch's leading axis: the port's
    ``batch_sharding`` over ``data``.  ``DataShard()`` is the whole batch."""

    rank: int = 0
    world: int = 1

    def rows(self, batch: int) -> slice:
        """The rows of a global batch of ``batch`` that this rank holds."""
        if batch % self.world:
            raise ValueError(f"a global batch of {batch} rows does not divide over {self.world} processes")
        share = batch // self.world
        return slice(self.rank * share, (self.rank + 1) * share)


def data_shard() -> DataShard:
    """This process's `DataShard`: its rank and the world size of the
    process group, or the whole batch without one."""
    if not process_group_active():
        return DataShard()
    return DataShard(dist.get_rank(), dist.get_world_size())


def batch_rows(batch, rank: int, world: int):
    """The rank's contiguous share of ``batch`` (a `data.datasets.Batch`, of
    host arrays or tensors), as `DataShard.rows` lays it out."""
    rows = DataShard(rank, world).rows(len(batch.indices))
    return dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[rows] for f in dataclasses.fields(batch)})


def check_mesh_config(mesh_cfg: MeshConfig) -> None:
    """``MeshConfig`` keeps the JAX package's fields; all but pure data
    parallelism raise."""
    if mesh_cfg.model_parallel_size != 1 or mesh_cfg.seq_parallel or mesh_cfg.shard_map_kernels:
        raise NotImplementedError(
            f"model parallelism, seq_parallel and shard_map_kernels are not ported yet: {ITEM_13B}")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the process group whose backward sums the gradient over it:
    each rank's loss depends on the sum, so the gradient of the global loss
    with respect to one rank's term is the sum of every rank's.  The
    semantics of ``torch.distributed.nn.functional.all_reduce``, which
    warns on every call as deprecated."""

    @staticmethod
    def forward(ctx, x: torch.Tensor) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor) -> torch.Tensor:
        return _AllReduceSum.apply(grad)


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """Differentiable sum of ``x`` over the process group; ``x`` itself is
    not written."""
    return _AllReduceSum.apply(x)


def broadcast_module(module: torch.nn.Module, src: int = 0) -> None:
    """Copies rank ``src``'s parameters and buffers into every rank's
    ``module``: one broadcast a dtype, over flat buffers."""
    tensors = [t for t in (*module.parameters(), *module.buffers())]
    for dtype in sorted({t.dtype for t in tensors}, key=str):
        group = [t for t in tensors if t.dtype == dtype]
        flat = torch.cat([t.detach().reshape(-1) for t in group])
        dist.broadcast(flat, src=src)
        with torch.no_grad():
            parts = torch.split(flat, [t.numel() for t in group])
            torch._foreach_copy_(group, [part.view_as(t) for t, part in zip(group, parts)])


def is_main_process() -> bool:
    """Rank 0, or the only process."""
    return not process_group_active() or dist.get_rank() == 0


def barrier() -> None:
    """Waits for every rank (a CPU all-reduce, which gloo carries whatever
    the card's backend); a no-op without a process group."""
    if process_group_active():
        dist.all_reduce(torch.zeros(1))
