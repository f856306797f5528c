"""The ``('data', 'model')`` layout of processes and its collectives, port of
`nn_conformer_for_speech_recognition_tpu/parallel/mesh.py`.

The JAX package lays a ``('data', 'model')`` mesh over every device it
sees, shards each batch's leading axis over ``data`` and the FFN and
attention weights over ``model`` by a rule on their names, and lets GSPMD
insert the collectives.  Here each process drives one card, started by
``torchrun`` (`initialize_multihost`), and `make_mesh` lays the processes
out the same way: world size ÷ ``model_parallel_size`` data ranks, the
model axis innermost, one process group for each row and each column of
the grid (`Mesh`).  The collectives are explicit:

* data parallelism: every process reads the same global batch and keeps
  its data rank's contiguous share of the rows (`DataShard`, `batch_rows`);
  the masked BatchNorm's sums (`models.conformer.MaskedBatchNorm`), the
  loss's count of rows with a target and one all-reduce of the flat
  gradient (`train.loop.make_feature_train_step`) run over the data group;
* tensor parallelism (``model_parallel_size`` > 1): a rank stores only its
  share of each leaf that `param_split` shards (`shard_module`), and the
  model pairs the splits as Megatron-LM does, so that an FFN or an
  attention layer costs one all-reduce over the model group forward and one
  backward (`copy_to_group`, `reduce_from_group`); the replicated
  parameters' gradients are averaged over the model group after the
  backward, so that the model ranks' copies stay one;
* sequence parallelism (``seq_parallel``): `parallel.sequence`'s Ulysses
  exchange (`all_to_all`) over the data group.

The Functions take and return plain tensors, so that the hand-written
kernels' own autograd Functions run on a rank's shard as they run on the
whole.
"""

from __future__ import annotations

import dataclasses
import os
import re
from typing import Dict, List, Optional, Sequence, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nn_conformer_for_speech_recognition_tpu_torch.config import MeshConfig

# host-side gathers of CPU tensors go over gloo, the card's tensors over NCCL
BACKEND = "cpu:gloo,cuda:nccl"


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
    """This process's `DataShard` under a process group without a model
    axis: its rank and the world size, or the whole batch without one.  A
    trainer under tensor parallelism takes its data rank from its `Mesh`."""
    if not process_group_active():
        return DataShard()
    return DataShard(dist.get_rank(), dist.get_world_size())


def batch_rows(batch, rank: int, world: int):
    """The rank's contiguous share of ``batch`` (a `data.datasets.Batch`, of
    host arrays or tensors), as `DataShard.rows` lays it out."""
    rows = DataShard(rank, world).rows(len(batch.indices))
    return dataclasses.replace(batch, **{f.name: getattr(batch, f.name)[rows] for f in dataclasses.fields(batch)})


# ---------------------------------------------------------------------------
# the layout
# ---------------------------------------------------------------------------


class Axis:
    """One axis of a `Mesh`: its name, its size, this process's coordinate
    on it, and the process group of the processes that share every other
    coordinate with this one.  ``group`` is None where no collective runs
    over the axis (size 1 under tensor parallelism, or no process group);
    ``dist.group.WORLD`` where the axis is the whole world.  A deep copy
    (of a model that refers to it) is the axis itself."""

    def __init__(self, name: str, size: int, rank: int, group=None):
        self.name, self.size, self.rank, self.group = name, size, rank, group

    @property
    def spread(self) -> bool:
        """Whether collectives over this axis run."""
        return self.group is not None

    def __deepcopy__(self, memo) -> "Axis":
        return self


class Mesh:
    """The port's ``('data', 'model')`` layout: ``devices`` is the (dp, mp)
    grid of global ranks, as the JAX `make_mesh` lays out its devices; each
    process holds its `Axis` on both (``mesh.data``, ``mesh.model``).
    ``bound`` is False for a layout computed without a process group (a
    grid of one process, or a layout only read)."""

    def __init__(self, devices: np.ndarray, rank: int, axis_names: Tuple[str, str], groups: Dict[str, object],
                 bound: bool):
        self.devices, self.axis_names, self.bound = devices, axis_names, bound
        where = np.argwhere(devices == rank)
        if not len(where):
            raise ValueError(f"rank {rank} is not in the layout {devices.tolist()}")
        coords = where[0]
        self.data = Axis(axis_names[0], devices.shape[0], int(coords[0]), groups.get("data"))
        self.model = Axis(axis_names[1], devices.shape[1], int(coords[1]), groups.get("model"))

    @property
    def shape(self) -> Dict[str, int]:
        return {self.data.name: self.data.size, self.model.name: self.model.size}

    def axis(self, name: str) -> Axis:
        for a in (self.data, self.model):
            if a.name == name:
                return a
        raise ValueError(f"the layout has no axis {name!r} (axes: {self.axis_names})")

    def __deepcopy__(self, memo) -> "Mesh":
        return self


def make_mesh(config: MeshConfig = MeshConfig(), devices: Optional[Sequence[int]] = None) -> Mesh:
    """World size ÷ ``model_parallel_size`` data ranks with the model axis
    innermost, as ``np.asarray(devices).reshape(dp, mp)``.  ``devices`` are
    global ranks (every process of the group, by default).  Under a process
    group every process must call this with the same arguments: it makes
    one group for each column (a data group) and each row (a model group)
    of the grid, in the same order on every rank; with
    ``model_parallel_size`` 1 the data group is the whole world."""
    active = process_group_active()
    world = dist.get_world_size() if active else 1
    devices = list(range(world)) if devices is None else [int(d) for d in devices]
    n, mp = len(devices), config.model_parallel_size
    if mp < 1 or n % mp != 0:
        raise ValueError(f"{n} processes not divisible by model_parallel_size={mp}")
    grid = np.asarray(devices).reshape(n // mp, mp)
    names = (config.data_axis, config.model_axis)
    if not active:
        return Mesh(grid, devices[0], names, {}, bound=n == 1)
    if sorted(devices) != list(range(world)):
        raise ValueError(f"the layout must hold every one of the {world} processes once, got {devices}")
    rank = dist.get_rank()
    groups: Dict[str, object] = {}
    if mp == 1:
        groups["data"] = dist.group.WORLD
    else:
        for kind, lines in (("data", grid.T), ("model", grid)):
            for line in lines:  # every rank makes every group, in the same order
                if len(line) == 1:
                    continue
                group = dist.new_group([int(r) for r in line])
                if rank in line:
                    groups[kind] = group
    return Mesh(grid, rank, names, groups, bound=True)


def check_mesh(mesh, config: MeshConfig) -> Mesh:
    """The trainers' layout: ``mesh`` (a `Mesh` from `make_mesh`) checked
    against ``config``, or `make_mesh(config)`.  Anything else, a layout
    whose model axis is not ``config``'s, or a layout of several processes
    without a process group raises."""
    if mesh is None:
        mesh = make_mesh(config)
    if not isinstance(mesh, Mesh):
        raise TypeError(f"mesh must be the port's parallel.mesh.Mesh (from make_mesh), got {type(mesh).__name__}")
    if mesh.model.size != config.model_parallel_size:
        raise ValueError(f"the layout's model axis has size {mesh.model.size}, the configuration asks for "
                         f"model_parallel_size={config.model_parallel_size}")
    if not mesh.bound:
        raise ValueError(f"a layout of {mesh.devices.size} processes needs a process group: start one process a "
                         f"card under torchrun")
    return mesh


# ---------------------------------------------------------------------------
# the rule table: which leaves tensor parallelism splits, and on which axis
# ---------------------------------------------------------------------------


@dataclasses.dataclass(frozen=True)
class ShardSpec:
    """How a tensor of ``size`` entries along ``axis`` splits over ``parts``
    model ranks: each of ``groups`` equal runs along the axis is cut into
    ``parts`` contiguous chunks, and rank r holds chunk r of every run (one
    run: a contiguous split; the attention's fused qkv: three runs, q, k
    and v, so that a rank holds q, k and v of its own heads)."""

    axis: int
    size: int
    parts: int
    groups: int = 1

    def index(self, rank: int) -> torch.Tensor:
        run = self.size // self.groups
        chunk = run // self.parts
        return torch.cat([torch.arange(g * run + rank * chunk, g * run + (rank + 1) * chunk)
                          for g in range(self.groups)])

    def on_axis(self, axis: int) -> "ShardSpec":
        return dataclasses.replace(self, axis=axis)

    def local(self, full: torch.Tensor, rank: int) -> torch.Tensor:
        """Rank ``rank``'s share of the whole tensor ``full``."""
        if full.shape[self.axis] != self.size:
            raise ValueError(f"a tensor of {full.shape[self.axis]} entries on axis {self.axis}, expected {self.size}")
        return full.index_select(self.axis, self.index(rank).to(full.device)).contiguous()

    def whole(self, shares: List[torch.Tensor]) -> torch.Tensor:
        """The whole tensor from every rank's share, in rank order."""
        stacked = torch.cat(shares, dim=self.axis)
        index = torch.cat([self.index(r) for r in range(self.parts)]).to(stacked.device)
        return torch.empty_like(stacked).index_copy_(self.axis, index, stacked)


# the JAX rule (`_spec_for_param`): FFN, qkv and rel-pos projections split on
# their output columns, ``out_proj`` on its input rows, if that dim divides by
# mp; everything else replicated.  As the port names those leaves (Linear
# weights are (out, in)): (name pattern, the split's axis here, runs).  The
# FFN's second Dense is split on its input here, not its output as in JAX, to
# pair with the first as Megatron-LM does (one all-reduce an FFN); qkv's output
# is split by heads, not evenly, so that a rank holds q, k and v of its heads.
_RULES = (
    (re.compile(r"(^|\.)ffn[12]\.fc1\.weight$"), 0, 1),
    (re.compile(r"(^|\.)ffn[12]\.fc2\.weight$"), 1, 1),
    (re.compile(r"(^|\.)qkv\.weight$"), 0, 3),
    (re.compile(r"(^|\.)pos_proj\.weight$"), 0, 1),
    (re.compile(r"(^|\.)out_proj\.weight$"), 1, 1),
)


def param_split(name: str, shape: Sequence[int], mp: int) -> Optional[ShardSpec]:
    """The port's rule table: the `ShardSpec` of the parameter ``name`` of
    ``shape`` (the port's layout) at ``model_parallel_size`` ``mp``, or None
    where it is replicated.  Sharded or not as the JAX rule decides on the
    same leaf, at 1/mp of its entries."""
    if mp <= 1 or len(shape) < 2:
        return None
    for pattern, axis, groups in _RULES:
        if pattern.search(name):
            run = shape[axis] // groups
            return ShardSpec(axis, shape[axis], mp, groups) if run % mp == 0 and shape[axis] % groups == 0 else None
    return None


@dataclasses.dataclass
class TensorParallelPlan:
    """What `shard_module` did to a module: the model axis and each split
    parameter's `ShardSpec`, by name."""

    axis: Axis
    specs: Dict[str, ShardSpec]


def tensor_parallel_plan(module: torch.nn.Module) -> Optional[TensorParallelPlan]:
    return getattr(module, "tensor_parallel", None)


def _owner(module: torch.nn.Module, name: str) -> Tuple[torch.nn.Module, str]:
    """(the module that runs the split, the parameter's name under it): the
    module two levels up (``ffn1`` of ``ffn1.fc1.weight``, ``mhsa`` of
    ``mhsa.qkv.weight``), or the root for a top-level Linear."""
    parts = name.split(".")
    return module.get_submodule(".".join(parts[:-2])), ".".join(parts[-2:])


def _set_param(module: torch.nn.Module, name: str, value: torch.Tensor) -> None:
    parent, leaf = name.rsplit(".", 1) if "." in name else ("", name)
    owner = module.get_submodule(parent)
    setattr(owner, leaf, torch.nn.Parameter(value, requires_grad=getattr(owner, leaf).requires_grad))


def shard_module(module: torch.nn.Module, mesh: Mesh) -> Optional[TensorParallelPlan]:
    """Tensor parallelism over ``mesh.model``: replaces each parameter that
    `param_split` splits by this rank's share of its current value, tells
    each module that runs a split (``tp``) and each masked BatchNorm
    (``data_axis``) its axis, and records the plan on ``module``
    (``module.tensor_parallel``).  A split the module cannot run (heads or
    an FFN's pair that do not divide over the model axis) raises.  With a
    model axis of size 1 it only gives the BatchNorms the data axis."""
    for m in module.modules():
        if hasattr(m, "data_axis"):
            m.data_axis = mesh.data
    mp = mesh.model.size
    if mp == 1:
        return None
    if tensor_parallel_plan(module) is not None:
        raise ValueError("the module is already split over the model axis")
    specs = {name: spec for name, p in module.named_parameters() if (spec := param_split(name, p.shape, mp))}
    owners = {}
    for name in specs:
        owner, leaf = _owner(module, name)
        owners.setdefault(id(owner), (owner, set()))[1].add(leaf)
    for owner, leaves in owners.values():
        check = getattr(owner, "check_split", None)
        if check is None:
            raise ValueError(f"{type(owner).__name__} cannot run split weights {sorted(leaves)}")
        check(leaves, mp)
        owner.tp = mesh.model
    with torch.no_grad():
        for name, spec in specs.items():
            _set_param(module, name, spec.local(module.get_parameter(name).detach(), mesh.model.rank))
    plan = TensorParallelPlan(mesh.model, specs)
    module.tensor_parallel = plan
    return plan


def unshard_module(module: torch.nn.Module) -> None:
    """The inverse of `shard_module`: every split parameter gathered whole
    over the model group (every rank of it calls this)."""
    plan = tensor_parallel_plan(module)
    if plan is None:
        return
    with torch.no_grad():
        for name, spec in plan.specs.items():
            _set_param(module, name, gather_shards(module.get_parameter(name).detach(), spec, plan.axis))
    for m in module.modules():
        if getattr(m, "tp", None) is not None:
            m.tp = None
    del module.tensor_parallel


def gather_shards(local: torch.Tensor, spec: ShardSpec, axis: Axis) -> torch.Tensor:
    """The whole tensor from every model rank's share (a collective)."""
    shares = [torch.empty_like(local) for _ in range(axis.size)]
    dist.all_gather(shares, local.contiguous(), group=axis.group)
    return spec.whole(shares)


def full_state_dict(module: torch.nn.Module) -> Dict[str, torch.Tensor]:
    """``module.state_dict()`` with every split parameter gathered whole: the
    state a one-process run holds (a collective over the model group)."""
    state = module.state_dict()
    plan = tensor_parallel_plan(module)
    if plan is not None:
        state = {k: gather_shards(v, plan.specs[k], plan.axis) if k in plan.specs else v for k, v in state.items()}
    return state


def local_state_dict(module: torch.nn.Module, state: Dict[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """A whole ``state`` (a checkpoint's, a converted one) cut to this
    rank's shares for the split ``module``."""
    plan = tensor_parallel_plan(module)
    if plan is None:
        return state
    return {k: plan.specs[k].local(v, plan.axis.rank) if k in plan.specs else v for k, v in state.items()}


# ---------------------------------------------------------------------------
# collectives
# ---------------------------------------------------------------------------


def _group(axis: Optional[Axis]):
    return None if axis is None else axis.group


class _AllReduceSum(torch.autograd.Function):
    """Sum over a process group whose backward sums the gradient over it:
    each rank's loss depends on the sum, so the gradient of the global loss
    with respect to one rank's term is the sum of every rank's.  The
    semantics of ``torch.distributed.nn.functional.all_reduce``, which
    warns on every call as deprecated."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return _AllReduceSum.apply(grad, ctx.group), None


def all_reduce_sum(x: torch.Tensor, axis: Optional[Axis] = None) -> torch.Tensor:
    """Differentiable sum of ``x`` over ``axis``'s group (the world where
    ``axis`` is None); ``x`` itself is not written."""
    return _AllReduceSum.apply(x, _group(axis))


class _CopyToGroup(torch.autograd.Function):
    """Identity forward, all-reduce backward: a replicated activation (or
    parameter) entering a split computation, whose gradient each rank holds
    only its part of (Megatron-LM's f)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        ctx.group = group
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


class _ReduceFromGroup(torch.autograd.Function):
    """All-reduce forward, identity backward: the partial sums of a split
    computation made whole, after which every rank computes the same thing
    (Megatron-LM's g)."""

    @staticmethod
    def forward(ctx, x: torch.Tensor, group) -> torch.Tensor:
        out = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(out, group=group)
        return out

    @staticmethod
    def backward(ctx, grad: torch.Tensor):
        return grad, None


def copy_to_group(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _CopyToGroup.apply(x, axis.group) if axis.spread else x


def reduce_from_group(x: torch.Tensor, axis: Axis) -> torch.Tensor:
    return _ReduceFromGroup.apply(x, axis.group) if axis.spread else x


def _all_to_all(x: torch.Tensor, group, size: int, split_dim: int, concat_dim: int) -> torch.Tensor:
    # one all_to_all_single over the chunks stacked on a leading axis: the
    # single-tensor exchange every backend carries
    send = torch.stack(torch.chunk(x, size, dim=split_dim)).contiguous()
    got = torch.empty_like(send, memory_format=torch.contiguous_format)
    dist.all_to_all_single(got, send, group=group)
    return torch.cat(got.unbind(0), dim=concat_dim)


class _AllToAll(torch.autograd.Function):
    """``x`` cut into the group's size along ``split_dim``, chunk j sent to
    rank j, the chunks received concatenated along ``concat_dim`` in rank
    order (``jax.lax.all_to_all(..., tiled=True)``); the backward is the
    reverse exchange."""

    @staticmethod
    def forward(ctx, x, group, size, split_dim, concat_dim):
        ctx.args = (group, size, split_dim, concat_dim)
        return _all_to_all(x, group, size, split_dim, concat_dim)

    @staticmethod
    def backward(ctx, grad):
        group, size, split_dim, concat_dim = ctx.args
        return _all_to_all(grad, group, size, concat_dim, split_dim), None, None, None, None


def all_to_all(x: torch.Tensor, axis: Axis, split_dim: int, concat_dim: int) -> torch.Tensor:
    """Differentiable all-to-all over ``axis`` (see `_AllToAll`)."""
    if x.shape[split_dim] % axis.size:
        raise ValueError(f"{x.shape[split_dim]} entries on dim {split_dim} do not split over {axis.size} ranks")
    return _AllToAll.apply(x, axis.group, axis.size, split_dim, concat_dim)


def all_gather(x: torch.Tensor, axis: Axis, dim: int = 0) -> torch.Tensor:
    """Every rank's ``x`` concatenated along ``dim`` in rank order (not
    differentiable); ``x`` itself on an axis without collectives."""
    if not axis.spread:
        return x
    out = [torch.empty_like(x) for _ in range(axis.size)]
    dist.all_gather(out, x.contiguous(), group=axis.group)
    return torch.cat(out, dim=dim)


def all_reduce_(x: torch.Tensor, axis: Optional[Axis] = None) -> torch.Tensor:
    """In-place sum of ``x`` over ``axis``'s group (the world where None),
    outside autograd; returns ``x``."""
    dist.all_reduce(x, group=_group(axis))
    return x


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
