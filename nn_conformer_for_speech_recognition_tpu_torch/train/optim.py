"""Adafactor, Adam, AdamW and learning-rate schedules, port of
`nn_conformer_for_speech_recognition_tpu/train/optim.py`.

The JAX package calls ``optax.adafactor(learning_rate,
multiply_by_parameter_scale=False, momentum=0.9, clipping_threshold,
weight_decay_rate)``; that chain is written out here by hand (the GPU
machine has no optax, and ``torch.optim.Adafactor`` has neither momentum
nor a clipping threshold).  Per parameter, in order:

1. factored second-moment scaling, optax's ``scale_by_factored_rms``:
   decay ``1 - (step + 1) ** -0.8``, ``eps`` 1e-30 added to g², and for a
   parameter whose two largest axes are both ≥ 128 the row/column
   estimates of g² over those axes, else the full estimate;
2. ``clip_by_block_rms``: divide by ``max(1, rms(update) / threshold)``;
3. the learning rate at this step;
4. momentum, an exponential moving average that is not debiased;
5. weight decay ``rate * param``, when a rate is set;
6. the negated update is added to the parameter.

The two largest axes are picked on the JAX package's layout of each
parameter (`convert.flax_axes`), so a Linear or Conv weight, stored
transposed here, is factored over the same logical axes as in optax.

Under tensor parallelism a rank holds its share of the split parameters
(`parallel.mesh.shard_module`), and the optimizer its share of their
state.  Given the module's `parallel.mesh.TensorParallelPlan`, Adafactor
still computes optax's update of the whole parameter: it decides the
factoring on the whole parameter's shape, sums over the model group the
means that run along the split axis (a row or column second moment, the
row moments' mean) and the squares of the clipping RMS.  Adam is
elementwise and needs nothing.  ``slot_specs`` tells a checkpoint how each
slot splits, so that it can be gathered whole and cut again
(`train.checkpoint`).

`Adam` is ``optax.adam`` (b1 0.9, b2 0.999, eps 1e-8, eps_root 0, both
moments debiased) and, with a weight decay, ``optax.adamw``: the decay
``rate * param`` is added to the Adam update before the learning rate
scales it.  Both are elementwise, so their state keeps the port's layout.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Optional, Tuple, Union

import numpy as np
import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import OptimizerConfig
from nn_conformer_for_speech_recognition_tpu_torch.convert import factored_dims, flax_axes
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import ShardSpec, TensorParallelPlan, all_reduce_

Schedule = Union[float, Callable[[int], float]]
# optax.adafactor's defaults, which the JAX package keeps
DECAY_RATE = 0.8
MIN_DIM_SIZE_TO_FACTOR = 128
EPS = 1e-30


def make_schedule(cfg: OptimizerConfig) -> Schedule:
    """A constant learning rate, or the transformer schedule: linear warm-up
    from 0 over ``warmup_steps``, then ``lr * sqrt(warmup / step)``."""
    if cfg.schedule == "constant" or cfg.warmup_steps == 0:
        return cfg.learning_rate
    if cfg.schedule == "transformer":
        lr, warmup = cfg.learning_rate, cfg.warmup_steps

        def schedule(step: int) -> float:
            if step < warmup:
                return lr * step / warmup
            return lr * (warmup ** 0.5) * (step ** -0.5)

        return schedule
    raise ValueError(f"unknown schedule {cfg.schedule!r}")


def _without(axis: Optional[int], removed: int) -> Optional[int]:
    """The index of ``axis`` once ``removed`` is taken out (None: gone)."""
    if axis is None or axis == removed:
        return None
    return axis - 1 if axis > removed else axis


class Adafactor:
    """Adafactor over named parameters, updated in place from their
    ``.grad`` by `step`.  State is kept in the JAX package's layout.  With
    ``plan`` the parameters it names are this rank's shares of split ones."""

    def __init__(
        self,
        named_params: Iterable[Tuple[str, torch.nn.Parameter]],
        learning_rate: Schedule,
        *,
        clipping_threshold: Optional[float] = 1.0,
        momentum: Optional[float] = None,
        weight_decay_rate: Optional[float] = None,
        plan: Optional[TensorParallelPlan] = None,
    ):
        self.learning_rate = learning_rate
        self.clipping_threshold, self.momentum = clipping_threshold, momentum
        self.weight_decay_rate = weight_decay_rate
        self.axis = None if plan is None else plan.axis
        self.count = 0
        self.params = []
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        # {parameter: {slot: its `ShardSpec` (JAX layout), or None where every model rank holds the whole slot}}
        self.slot_specs: Dict[str, Dict[str, Optional[ShardSpec]]] = {}
        for name, p in named_params:
            axes = flax_axes(name, p.ndim)
            shape = tuple(p.shape[a] for a in axes)
            spec = None if plan is None else plan.specs.get(name)
            split = None if spec is None else axes.index(spec.axis)  # the split axis in the JAX layout
            whole = shape if spec is None else tuple(spec.size if i == split else n for i, n in enumerate(shape))
            dims = factored_dims(whole, MIN_DIM_SIZE_TO_FACTOR)  # optax decides on the whole parameter
            like = dict(device=p.device, dtype=p.dtype)
            if dims is None:
                st = {"v": torch.zeros(shape, **like)}
            else:  # second moments of the rows and of the columns
                st = {
                    "v_row": torch.zeros(tuple(np.delete(shape, dims[1])), **like),
                    "v_col": torch.zeros(tuple(np.delete(shape, dims[0])), **like),
                }
            if momentum is not None:
                st["ema"] = torch.zeros(shape, **like)
            self.params.append((name, p, axes, dims, split))
            self.state[name] = st
            on = {"v": split, "ema": split}
            if dims is not None:
                on.update(v_row=_without(split, dims[1]), v_col=_without(split, dims[0]))
            self.slot_specs[name] = {k: None if on[k] is None else spec.on_axis(on[k]) for k in st}

    def _mean(self, x: torch.Tensor, dim: int, split: Optional[int]) -> torch.Tensor:
        """Mean over ``dim`` of a tensor split along ``split`` over the model
        group: where the two agree, the mean of the ranks' equal shares'
        means."""
        m = x.mean(dim=dim)
        if split != dim:
            return m
        return all_reduce_(m, self.axis) / self.axis.size

    @torch.no_grad()
    def step(self) -> None:
        lr = self.learning_rate(self.count) if callable(self.learning_rate) else self.learning_rate
        t = np.float32(self.count + 1)
        decay = np.float32(1.0) - t ** np.float32(-DECAY_RATE)
        keep = float(decay)
        take = float(np.float32(1.0) - decay)
        for name, p, axes, dims, split in self.params:
            if p.grad is None:
                raise RuntimeError(f"Adafactor: {name} has no gradient")
            st = self.state[name]
            g = p.grad.permute(axes)
            g_sqr = g * g + EPS
            if dims is None:
                st["v"] = keep * st["v"] + take * g_sqr
                u = g * st["v"].pow(-0.5)
            else:
                d1, d0 = dims
                st["v_row"] = keep * st["v_row"] + take * self._mean(g_sqr, d0, split)
                st["v_col"] = keep * st["v_col"] + take * self._mean(g_sqr, d1, split)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = self._mean(st["v_row"], reduced_d1, _without(split, d0)).unsqueeze(reduced_d1)
                row_factor = (st["v_row"] / row_col_mean).pow(-0.5)
                col_factor = st["v_col"].pow(-0.5)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            if self.clipping_threshold is not None:
                if split is None:
                    ms = u.square().mean()
                else:  # the RMS of the whole parameter's update
                    ms = all_reduce_(u.square().sum(), self.axis) / (u.numel() * self.axis.size)
                u = u / torch.clamp_min(ms.sqrt() / self.clipping_threshold, 1.0)
            u = lr * u
            if self.momentum is not None:
                st["ema"] = (1.0 - self.momentum) * u + self.momentum * st["ema"]
                u = st["ema"]
            if self.weight_decay_rate is not None:
                u = u + self.weight_decay_rate * p.permute(axes)
            p.add_(-u.permute(tuple(np.argsort(axes))))
        self.count += 1


class Adam:
    """Adam over named parameters, updated in place from their ``.grad`` by
    `step`; ``weight_decay`` makes it AdamW.  State per parameter: the first
    and second moments ``mu`` and ``nu``."""

    def __init__(
        self,
        named_params: Iterable[Tuple[str, torch.nn.Parameter]],
        learning_rate: Schedule,
        *,
        b1: float = 0.9,
        b2: float = 0.999,
        eps: float = 1e-8,
        weight_decay: Optional[float] = None,
        plan: Optional[TensorParallelPlan] = None,
    ):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0
        self.params = []
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        self.slot_specs: Dict[str, Dict[str, Optional[ShardSpec]]] = {}  # as Adafactor's: the parameter's own
        for name, p in named_params:
            self.params.append((name, p))
            self.state[name] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}
            spec = None if plan is None else plan.specs.get(name)
            self.slot_specs[name] = {"mu": spec, "nu": spec}

    @torch.no_grad()
    def step(self) -> None:
        lr = self.learning_rate(self.count) if callable(self.learning_rate) else self.learning_rate
        t = np.float32(self.count + 1)
        # optax debiases in float32: 1 - decay ** count
        debias_mu = float(np.float32(1.0) - np.float32(self.b1) ** t)
        debias_nu = float(np.float32(1.0) - np.float32(self.b2) ** t)
        for name, p in self.params:
            if p.grad is None:
                raise RuntimeError(f"Adam: {name} has no gradient")
            st, g = self.state[name], p.grad
            st["mu"] = (1.0 - self.b1) * g + self.b1 * st["mu"]
            st["nu"] = (1.0 - self.b2) * (g * g) + self.b2 * st["nu"]
            u = (st["mu"] / debias_mu) / (torch.sqrt(st["nu"] / debias_nu) + self.eps)
            if self.weight_decay is not None:
                u = u + self.weight_decay * p
            p.add_(-(lr * u))
        self.count += 1


# optax.adamw's default weight decay
ADAMW_WEIGHT_DECAY = 1e-4


def make_optimizer(cfg: OptimizerConfig, named_params: Iterable[Tuple[str, torch.nn.Parameter]],
                   plan: Optional[TensorParallelPlan] = None):
    """The optimizer of ``cfg`` over ``named_params`` (e.g.
    ``model.named_parameters()``): 'adafactor' (the train step's), 'adam'
    (pretraining's) or 'adamw' (decay ``cfg.weight_decay``); ``plan``: the
    module's tensor-parallel plan, where it has one."""
    lr = make_schedule(cfg)
    if cfg.name == "adafactor":
        return Adafactor(
            named_params,
            lr,
            momentum=cfg.momentum,
            clipping_threshold=cfg.clip_threshold,
            weight_decay_rate=cfg.weight_decay or None,
            plan=plan,
        )
    if cfg.name == "adam":
        return Adam(named_params, lr, plan=plan)
    if cfg.name == "adamw":
        return Adam(named_params, lr, weight_decay=cfg.weight_decay, plan=plan)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
