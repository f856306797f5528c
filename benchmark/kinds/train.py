"""A ``train`` mix: the window repeats ``Trainer.train(dataset, epochs=1)``
over a ``DeviceResidentDataset``, an epoch of the corpus a call, each call
ending in the program's own pull of its losses.  The reference follows the
program's first three steps."""

from __future__ import annotations

import math
from typing import Dict

import torch

from benchmark import harness as H
from benchmark import yardstick as Y
from benchmark.reference import judge as J

MOVES = "train_audio_per_s"
TRAINING = True  # the roofline groups' least time counts the backward kernels


def flops_per_step(model: dict, vocab_size: int, batch: int, frames: int) -> float:
    return Y.train_step_flops(model, vocab_size, batch, frames)


def setup(run) -> None:
    """The resident corpus and the trainer, then the first calls, through the
    window's own call: two epochs, whose first three steps the reference
    follows.  The optimizer's step is watched meanwhile: after step 1 the
    first gradient's norm by leaf is read from its second moments, after
    step 3 the parameters."""
    H.resident_trainer(run)
    opt = run.trainer.state.optimizer
    grad, params = {}, {}

    def watched():
        type(opt).step(opt)
        if opt.count == 1:
            for name, p, axes, dims, _ in opt.params:
                st, shape = opt.state[name], p.permute(axes).shape
                # at step 1 the moments are g² + 1e-30 (decay 0): v, or the means over one axis
                total = st["v"].double().sum() if dims is None else st["v_row"].double().sum() * shape[dims[1]]
                grad[name] = float(torch.sqrt(torch.clamp_min(total - 1e-30 * p.numel(), 0.0)))
        if opt.count == 3:
            params.update({name: p.detach().to("cpu", copy=True) for name, p, *_ in opt.params})

    opt.step = watched
    try:
        run.call()
        loss12 = run.trainer.history["train_loss"][-1]
        run.call()
    finally:
        del opt.step
    run.observed = {"loss12": loss12, "grad": grad, "params3": params}


def call(run):
    """One epoch, with a new epoch offset each call, so each reshuffles."""
    return run.trainer.train(run.dataset, epochs=1, epoch_offset=run.calls - 1)


def failed(run, out) -> int:
    """The steps of a call whose loss is not finite."""
    return 0 if math.isfinite(run.trainer.history["train_loss"][-1]) else run.steps_per_call


def attempted(run, calls: int) -> int:
    return calls * run.steps_per_call


def judge(run) -> Dict[str, float]:
    weights = H.make_weights(run.cfg, run.seed, run.device)
    ref = J.reference_train(run.cfg, run.traffic, run.corpus, weights, run.seed, run.device)
    obs = run.observed
    change = {n: float((obs["params3"][n].double() - weights[n].cpu().double()).norm()) for n in obs["params3"]}
    return J.train_readings({"loss12": obs["loss12"], "grad": obs["grad"], "change": change}, ref)


def control(cell: dict, seed: int, device):
    """Yields (side, readings) for the control (the reference one precision
    down, fp8 e4m3 products for bf16) and the fault of half of each batch
    left out of the loss, each judged against the reference.  A step that
    returns its state unchanged reads 1 by ``change`` and needs no run."""
    from benchmark import traffic as T
    from benchmark.reference.ops import Rounding, fp8_round

    cfg, traffic = cell["cfg"], cell["traffic"]
    corpus = T.make_corpus(traffic, cfg, seed, device)
    weights = H.make_weights(cfg, seed, device)
    ref = J.reference_train(cfg, traffic, corpus, weights, seed, device)
    for side, kw in (("control", {"rounding": Rounding(fp8_round)}), ("fault: half the batch", {"drop_half": True})):
        yield side, J.train_readings(J.reference_train(cfg, traffic, corpus, weights, seed, device, **kw), ref)
