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


class Adafactor:
    """Adafactor over named parameters, updated in place from their
    ``.grad`` by `step`.  State is kept in the JAX package's layout."""

    def __init__(
        self,
        named_params: Iterable[Tuple[str, torch.nn.Parameter]],
        learning_rate: Schedule,
        *,
        clipping_threshold: Optional[float] = 1.0,
        momentum: Optional[float] = None,
        weight_decay_rate: Optional[float] = None,
    ):
        self.learning_rate = learning_rate
        self.clipping_threshold, self.momentum = clipping_threshold, momentum
        self.weight_decay_rate = weight_decay_rate
        self.count = 0
        self.params = []
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, p in named_params:
            axes = flax_axes(name, p.ndim)
            shape = tuple(p.shape[a] for a in axes)
            dims = factored_dims(shape, MIN_DIM_SIZE_TO_FACTOR)
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
            self.params.append((name, p, axes, dims))
            self.state[name] = st

    @torch.no_grad()
    def step(self) -> None:
        lr = self.learning_rate(self.count) if callable(self.learning_rate) else self.learning_rate
        t = np.float32(self.count + 1)
        decay = np.float32(1.0) - t ** np.float32(-DECAY_RATE)
        keep = float(decay)
        take = float(np.float32(1.0) - decay)
        for name, p, axes, dims in self.params:
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
                st["v_row"] = keep * st["v_row"] + take * g_sqr.mean(dim=d0)
                st["v_col"] = keep * st["v_col"] + take * g_sqr.mean(dim=d1)
                reduced_d1 = d1 - 1 if d1 > d0 else d1
                row_col_mean = st["v_row"].mean(dim=reduced_d1, keepdim=True)
                row_factor = (st["v_row"] / row_col_mean).pow(-0.5)
                col_factor = st["v_col"].pow(-0.5)
                u = g * row_factor.unsqueeze(d0) * col_factor.unsqueeze(d1)
            if self.clipping_threshold is not None:
                u = u / torch.clamp_min(u.square().mean().sqrt() / self.clipping_threshold, 1.0)
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
    ):
        self.learning_rate = learning_rate
        self.b1, self.b2, self.eps, self.weight_decay = b1, b2, eps, weight_decay
        self.count = 0
        self.params = []
        self.state: Dict[str, Dict[str, torch.Tensor]] = {}
        for name, p in named_params:
            self.params.append((name, p))
            self.state[name] = {"mu": torch.zeros_like(p), "nu": torch.zeros_like(p)}

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


def make_optimizer(cfg: OptimizerConfig, named_params: Iterable[Tuple[str, torch.nn.Parameter]]):
    """The optimizer of ``cfg`` over ``named_params`` (e.g.
    ``model.named_parameters()``): 'adafactor' (the train step's), 'adam'
    (pretraining's) or 'adamw' (decay ``cfg.weight_decay``)."""
    lr = make_schedule(cfg)
    if cfg.name == "adafactor":
        return Adafactor(
            named_params,
            lr,
            momentum=cfg.momentum,
            clipping_threshold=cfg.clip_threshold,
            weight_decay_rate=cfg.weight_decay or None,
        )
    if cfg.name == "adam":
        return Adam(named_params, lr)
    if cfg.name == "adamw":
        return Adam(named_params, lr, weight_decay=cfg.weight_decay)
    raise ValueError(f"unknown optimizer {cfg.name!r}")
