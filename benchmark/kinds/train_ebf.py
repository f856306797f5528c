"""A ``train_ebf`` mix: `kinds/train.py`'s window (``Trainer.train(dataset,
epochs=1)`` over a ``DeviceResidentDataset``, an epoch a call) over an
E-Branchformer configuration, judged against `reference/ebranchformer.py`.

The call, ``failed`` and ``attempted`` are the ``train`` kind's.  The
set-up, the weights, the model-FLOPs count, the judge and the control are
this kind's: the weights are drawn over the E-Branchformer reference's
parameters (`reference.steps.draw_weights`), and the reference follows the
program's first three steps with `reference.steps.follow_steps`, its loss
over the first call's steps (the fourth a forward only, after the third
update, as the program's fourth step sees the parameters).
"""

from __future__ import annotations

import math
from typing import Dict

from benchmark import harness as H
from benchmark import train_setup as TS
from benchmark.reference import judge as J
from benchmark.reference import steps as S
from benchmark.reference.ebranchformer import EBranchformerCTC

TRAIN = H.load_module("kinds", "train")
MOVES = TRAIN.MOVES
TRAINING = True
call, failed, attempted = TRAIN.call, TRAIN.failed, TRAIN.attempted


def ebranchformer_forward_flops(model: dict, vocab_size: int, batch: int, frames: int) -> float:
    """Matmul and conv FLOPs of one E-Branchformer-CTC forward at ``frames``
    feature frames a row, frozen from the port's ``utils/flops.py``: the
    front end and the head as `yardstick.conformer_forward_flops` counts
    them; a block's two FFNs, attention (q, k, v, scores, the rel-pos term
    and its table's projection, the value product, the output projection),
    cgMLP (d → c, the gate's depthwise conv over c/2, c/2 → d) and merge
    (the depthwise conv over 2d, 2d → d)."""
    sub, enc, dec = model["subsampling"], model["encoder"], model["decoder"]
    d = enc["d_model"]
    total = 0.0
    t, f, c_in = frames, model["n_mels"], 1
    for ch, k, st, sf in zip(sub["channels"], sub["kernel_sizes"], sub["time_strides"], sub["freq_strides"]):
        t = math.ceil(t / st)
        f = math.ceil(f / sf)
        total += batch * t * f * ch * 2 * k * k * c_in
        c_in = ch
    total += 2 * batch * t * (f * c_in) * d
    h, dh = enc["num_heads"], d // enc["num_heads"]
    ffn = 2 * (2 * batch * t * d * enc["ffn_dim"]) * 2
    qkv = 2 * batch * t * d * 3 * d
    scores = 2 * batch * h * t * t * dh
    att_v = 2 * batch * h * t * t * dh
    relpos = 2 * scores + 2 * (2 * t - 1) * d * d
    out_proj = 2 * batch * t * d * d
    half = enc["cgmlp_dim"] // 2
    cgmlp = 2 * batch * t * (d * enc["cgmlp_dim"] + half * enc["conv_kernel_size"] + half * d)
    merge = 2 * batch * t * (2 * d * enc["merge_conv_kernel"] + 2 * d * d)
    total += enc["num_blocks"] * (ffn + qkv + scores + att_v + relpos + out_proj + cgmlp + merge)
    p, lh = dec["projection_dim"], dec["lstm_hidden"]
    total += 2 * batch * t * d * p
    total += 2 * (2 * batch * t * (p + lh) * 4 * lh)
    total += 2 * batch * t * (2 * lh) * vocab_size
    return float(total)


def flops_per_step(model: dict, vocab_size: int, batch: int, frames: int) -> float:
    return 3.0 * ebranchformer_forward_flops(model, vocab_size, batch, frames)


def weights(cfg: dict, seed: int, device):
    return S.draw_weights(EBranchformerCTC, cfg, seed, device)


def setup(run) -> None:
    """`kinds/train.py`'s set-up over this kind's weights: the resident
    corpus and the trainer, then two calls, the optimizer watched."""
    TS.resident_trainer(run, weights)
    TS.first_calls(run)


def reference(cfg: dict, traffic: dict, corpus, w, seed: int, device, **kw) -> dict:
    steps = -(-len(corpus.lengths) // traffic["batch"])  # the first call's steps: the program's loss
    return S.follow_steps(EBranchformerCTC, cfg, traffic, corpus, w, seed, device, loss_steps=steps, **kw)


def judge(run) -> Dict[str, float]:
    w = weights(run.cfg, run.seed, run.device)
    return TS.readings(run, reference(run.cfg, run.traffic, run.corpus, w, run.seed, run.device), w)


def control(cell: dict, seed: int, device):
    """As `kinds/train.py`'s control, over the E-Branchformer reference: the
    reference in fp8 and the fault of half of each batch left out."""
    from benchmark import traffic as T
    from benchmark.reference.ops import Rounding, fp8_round

    cfg, traffic = cell["cfg"], cell["traffic"]
    corpus = T.make_corpus(traffic, cfg, seed, device)
    w = weights(cfg, seed, device)
    ref = reference(cfg, traffic, corpus, w, seed, device)
    for side, kw in (("control", {"rounding": Rounding(fp8_round)}), ("fault: half the batch", {"drop_half": True})):
        yield side, J.train_readings(reference(cfg, traffic, corpus, w, seed, device, **kw), ref)
