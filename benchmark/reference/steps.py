"""The reference's side of a training cell for any reference model, on one
process or on a data-parallel rank: `judge.reference_train` with the model
class a parameter and, under a process group, the program's data-parallel
mathematics.

``draw_weights`` is `harness.make_weights` over another reference model's
parameters: the same draw, in the order of its ``state_dict``.

``follow_steps`` follows the program's first `judge.STEPS` steps from the
same weights, audio and transcripts.  With ``world`` > 1 it runs on rank
``rank`` of a process group of ``world`` (every rank calls it), as the
port's data-parallel train step computes: every rank works out the
features of the whole global batch and its SpecAugment draws, and keeps its
contiguous share of the rows; it seeds its dropout with the program's
rank-folded seed (`train.state.TrainState.dropout_seed`); the masked
BatchNorms take the global batch's statistics (masked sum and count, then
the masked sum of squared deviations, each summed over the ranks by a
differentiable all-reduce); a rank's loss is its rows' share of the global
batch's mean; and the four shards' gradients and losses are summed over
the ranks before the update.  The sum of the shards' gradients is the
gradient of the whole batch's loss: the same mathematics in blocks that fit
a card.
"""

from __future__ import annotations

import math
from typing import Dict

import numpy as np
import torch

from benchmark.reference import judge as J
from benchmark.reference.model import BN_EPS, MaskedBatchNorm
from benchmark.reference.ops import Rounding, ctc_nll, log_mel, specaugment
from benchmark.reference.optim import Adafactor


def draw_weights(model_cls, cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """``model_cls``'s weights from ``seed``, drawn on ``device`` in one call,
    by `harness.make_weights`'s rules."""
    with torch.device("meta"):
        shapes = {n: (tuple(t.shape), t.dtype) for n, t in model_cls(cfg["model"], cfg["vocab_size"])
                  .state_dict().items()}
    normal = [n for n, (s, _) in shapes.items() if len(s) > 1 and not n.endswith(("u_bias", "v_bias"))]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(math.prod(shapes[n][0]) for n in normal), generator=gen, device=device)
    out, at = {}, 0
    for n, (s, dtype) in shapes.items():
        if n in normal:
            size = math.prod(s)
            fan_in = s[0] if n.endswith(("_w_ih", "_w_hh")) else math.prod(s[1:])
            out[n] = (draw[at:at + size].view(s) * fan_in ** -0.5).contiguous()
            at += size
        elif n.endswith(("running_var",)) or (len(s) == 1 and n.endswith("weight")):
            out[n] = torch.ones(s, dtype=dtype, device=device)
        else:
            out[n] = torch.zeros(s, dtype=dtype, device=device)
    return out


def dropout_seed(seed: int, step: int, rank: int) -> int:
    """The program's dropout seed of a step on a data rank."""
    s = (seed * 1_000_003 + step) % (2 ** 63)
    return s if rank == 0 else (s * 1_000_003 + rank) % (2 ** 63)


class _AllReduceSum(torch.autograd.Function):
    """The sum over the ranks; its gradient is the sum of the ranks' gradients."""

    @staticmethod
    def forward(ctx, x):
        import torch.distributed as dist

        y = x.clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        return _AllReduceSum.forward(ctx, g)


class GlobalMaskedBatchNorm(MaskedBatchNorm):
    """`model.MaskedBatchNorm` over the global batch of a process group."""

    def forward(self, x, mask, ctx):
        if not ctx.training:
            return super().forward(x, mask, ctx)
        all_reduce = _AllReduceSum.apply
        m = mask[..., None].to(x.dtype)
        both = all_reduce(torch.cat([(x * m).sum(dim=(0, 1)), m.sum().reshape(1)]))
        count = torch.clamp_min(both[-1], 1.0)
        mean = both[:-1] / count
        var = all_reduce((((x - mean) ** 2) * m).sum(dim=(0, 1))) / count
        return (x - mean) * torch.rsqrt(var + BN_EPS) * self.weight + self.bias


def follow_steps(model_cls, cfg: dict, traffic: dict, corpus, weights: Dict[str, torch.Tensor], seed: int, device,
                 rounding: Rounding = Rounding(), drop_half: bool = False, rank: int = 0, world: int = 1,
                 loss_steps: int = 2) -> dict:
    """As `judge.reference_train`, for ``model_cls`` and on rank ``rank`` of
    ``world``; every rank returns the same readings.  ``loss12`` is the mean
    loss of the first ``loss_steps`` steps (the program's first call); a
    step past `judge.STEPS` is a forward only, on the parameters after the
    last update."""
    import torch.distributed as dist

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = model_cls(cfg["model"], cfg["vocab_size"]).to(device)
    model.load_state_dict(weights, strict=True)
    if world > 1:
        for m in model.modules():
            if type(m) is MaskedBatchNorm:
                m.__class__ = GlobalMaskedBatchNorm
    model.train()
    opt_cfg = cfg["optimizer"]
    opt = Adafactor(model, opt_cfg["learning_rate"], opt_cfg["momentum"], opt_cfg["clip_threshold"])
    gen = torch.Generator(device=device).manual_seed(seed)
    ctx = J.Ctx(True, J.compute_dtype(cfg, device), rounding)
    losses, grad = [], {}
    batch = traffic["batch"]
    share = batch // world
    rows = slice(rank * share, (rank + 1) * share)
    for step in range(max(J.STEPS, loss_steps)):
        call, half = divmod(step, -(-len(corpus.lengths) // batch))
        idx = J.epoch_order(len(corpus.lengths), batch, seed + call)[half]
        audio, alen, targets, tlen = J.rows_of(corpus, idx, device)
        with torch.no_grad():
            feats, frame_lengths = log_mel(audio, alen, cfg["features"])
            if traffic["specaugment"]:
                feats = specaugment(feats, frame_lengths, cfg["specaugment"], gen)
        w = (tlen > 0).float()
        if drop_half:
            w[batch // 2:] = 0.0
        count = torch.clamp_min(w.sum(), 1.0)
        torch.manual_seed(dropout_seed(seed, step, rank))
        model.zero_grad(set_to_none=True)
        updates = step < J.STEPS
        with torch.set_grad_enabled(updates):
            log_probs, out_lengths = model(feats[rows], frame_lengths[rows], ctx)
            nll = ctc_nll(log_probs, targets[rows], out_lengths, tlen[rows], blank=0)
            loss = (nll / torch.clamp_min(tlen[rows], 1).float() * w[rows]).sum() / count
        if not updates:
            if world > 1:
                dist.all_reduce(loss)
            losses.append(float(loss))
            continue
        loss.backward()
        loss = loss.detach()
        if world > 1:
            params = list(model.parameters())
            flat = torch.cat([p.grad.reshape(-1) for p in params] + [loss.reshape(1)])
            dist.all_reduce(flat)
            for p, part in zip(params, torch.split(flat[:-1], [p.numel() for p in params])):
                p.grad.copy_(part.view_as(p))
            loss = flat[-1]
        losses.append(float(loss))
        if step == 0:
            grad = {n: float(p.grad.double().norm()) for n, p in model.named_parameters()}
        opt.step()
        del log_probs, nll, loss, feats
    change = {n: float((p.detach().double() - weights[n].to(device).double()).norm())
              for n, p in model.named_parameters()}
    return {"loss12": float(np.mean(losses[:loss_steps])), "grad": grad, "change": change}
