"""The reference's side of the comparison that decides ``correct``, and the
readings that compare the two sides.

Training: the reference follows the program's first three steps from the
same weights, audio and transcripts, working out again everything the
program derives (the epoch order, the features, the SpecAugment draws, the
dropout masks, the CTC targets, the Adafactor update).  Three readings:

* ``loss``: |program - reference| / |reference| of the mean loss of the
  first call's two steps, which the program reports;
* ``grad``: over the leaves, the worst |‖g_prog‖ - ‖g_ref‖| of the first
  gradient, as a share of the larger of the reference leaf's norm and the
  median leaf's; the program's norm is worked out from its optimizer's
  second moments after one step (at step 1 they hold g² exactly);
* ``change``: the same of the parameters' change after three steps, over
  the leaves whose reference gradient is at least 1e-3 of the median
  leaf's (a leaf nought to rounding moves under Adafactor by round-off);
* ``grad_median``, ``change_median``: the median leaf's gap of each.

Labelling: the program's label of each row is its greedy frame ids with
the blank and pad frames dropped.  ``label_gap`` is, over the rows, the
widest gap by which the reference's log-prob of a served word (or, for a
dropped frame, of the better of blank and pad) lies below the reference's
best at that frame, on the alignment of the label to the frames that makes
that widest gap smallest (words in order, one frame each).  A row with no
label counts as missing.
"""

from __future__ import annotations

import math
from typing import Dict, List, Optional, Sequence

import numpy as np
import torch

from benchmark.reference.model import ConformerCTC, Ctx
from benchmark.reference.ops import Rounding, ctc_nll, log_mel, specaugment
from benchmark.reference.optim import Adafactor

DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
GRAD_FLOOR = 1e-3  # leaves below this share of the median leaf's gradient norm are left out of ``change``
STEPS = 3  # the program's first steps that the reference follows


def compute_dtype(cfg: dict, device: torch.device) -> torch.dtype:
    """The configuration's compute dtype on ``device`` ('auto': bf16 on a
    card, float32 on the CPU): the dtype of the program's dropout masks."""
    name = cfg["model"]["compute_dtype"]
    if name == "auto":
        return torch.bfloat16 if device.type == "cuda" else torch.float32
    return DTYPES[name]


def epoch_order(n: int, batch: int, seed: int) -> np.ndarray:
    """(batches, batch) row indices of one shuffled epoch, -1 for padding:
    a permutation of the rows by numpy's ``default_rng(seed)``."""
    order = np.arange(n)
    np.random.default_rng(seed).shuffle(order)
    mat = np.full((-(-n // batch), batch), -1, np.int64)
    mat.reshape(-1)[:n] = order
    return mat


def rows_of(corpus, idx: np.ndarray, device) -> tuple:
    """Audio (float32, int16 / 32768), sample counts, targets and target
    lengths of rows ``idx`` (-1: a zero row)."""
    keep = idx >= 0
    rows = np.where(keep, idx, 0)
    audio = corpus.pcm[rows].astype(np.float32) / 32768.0 * keep[:, None]
    lengths = corpus.lengths[rows] * keep
    targets = np.zeros((len(idx), corpus.max_target_len), np.int64)
    tlen = np.zeros(len(idx), np.int64)
    for j, i in enumerate(rows):
        if keep[j] and corpus.ids is not None:
            ids = corpus.ids[i][: corpus.max_target_len]
            targets[j, : len(ids)] = ids
            tlen[j] = len(ids)
    to = lambda x: torch.from_numpy(np.ascontiguousarray(x)).to(device)  # noqa: E731
    return to(audio), to(lengths), to(targets), to(tlen)


def reference_train(cfg: dict, traffic: dict, corpus, weights: Dict[str, torch.Tensor], seed: int, device,
                    rounding: Rounding = Rounding(), drop_half: bool = False) -> dict:
    """Follows the first `STEPS` train steps of a run with ``seed`` (the trainer's,
    the train state's and the epoch shuffle's seed); returns the mean loss
    of the first two steps, the first gradient's norm by leaf, and the
    parameters' change by leaf after them.  ``drop_half`` leaves the
    second half of every batch out of the loss (a fault, for the limits)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = ConformerCTC(cfg["model"], cfg["vocab_size"]).to(device)
    model.load_state_dict(weights, strict=True)
    model.train()
    opt_cfg = cfg["optimizer"]
    opt = Adafactor(model, opt_cfg["learning_rate"], opt_cfg["momentum"], opt_cfg["clip_threshold"])
    gen = torch.Generator(device=device).manual_seed(seed)
    ctx = Ctx(True, compute_dtype(cfg, device), rounding)
    losses, grad = [], {}
    batch = traffic["batch"]
    for step in range(STEPS):
        call, half = divmod(step, -(-len(corpus.lengths) // batch))
        idx = epoch_order(len(corpus.lengths), batch, seed + call)[half]
        audio, alen, targets, tlen = rows_of(corpus, idx, device)
        with torch.no_grad():
            feats, frame_lengths = log_mel(audio, alen, cfg["features"])
            if traffic["specaugment"]:
                feats = specaugment(feats, frame_lengths, cfg["specaugment"], gen)
        torch.manual_seed((seed * 1_000_003 + step) % (2 ** 63))
        model.zero_grad(set_to_none=True)
        log_probs, out_lengths = model(feats, frame_lengths, ctx)
        nll = ctc_nll(log_probs, targets, out_lengths, tlen, blank=0)
        w = (tlen > 0).float()
        if drop_half:
            w[batch // 2:] = 0.0
        loss = (nll / torch.clamp_min(tlen, 1).float() * w).sum() / torch.clamp_min(w.sum(), 1.0)
        loss.backward()
        losses.append(float(loss.detach()))
        if step == 0:
            grad = {n: float(p.grad.double().norm()) for n, p in model.named_parameters()}
        opt.step()
        del log_probs, nll, loss, feats
    change = {n: float((p.detach().double() - weights[n].to(device).double()).norm())
              for n, p in model.named_parameters()}
    return {"loss12": float(np.mean(losses[:2])), "grad": grad, "change": change}


def leaf_gaps(prog: Dict[str, float], ref: Dict[str, float], leaves: Sequence[str]) -> Dict[str, float]:
    """Each leaf's |prog - ref| / max(ref, the median leaf's ref); a leaf the
    program lacks reads infinite."""
    med = float(np.median([ref[n] for n in leaves]))
    out = {}
    for n in leaves:
        p = prog.get(n)
        out[n] = math.inf if p is None or not math.isfinite(p) else abs(p - ref[n]) / max(ref[n], med, 1e-30)
    return out


def train_readings(prog: dict, ref: dict) -> Dict[str, float]:
    """``grad`` and ``change``: the worst leaf's gap; ``grad_median`` and
    ``change_median``: the median leaf's, steady from seed to seed where a
    few leaves' gradients (one reduction over millions of bf16 terms, as the
    subsampling convs' in long-form training) swing."""
    leaves = sorted(ref["grad"])
    med_grad = float(np.median([ref["grad"][n] for n in leaves]))
    moving = [n for n in leaves if ref["grad"][n] >= GRAD_FLOOR * med_grad]
    loss = abs(prog["loss12"] - ref["loss12"]) / abs(ref["loss12"]) if math.isfinite(prog["loss12"]) else math.inf
    out = {"loss": loss}
    for name, gaps in (("grad", leaf_gaps(prog["grad"], ref["grad"], leaves)),
                       ("change", leaf_gaps(prog["change"], ref["change"], moving))):
        worst = max(gaps, key=gaps.get)
        out.update({name: gaps[worst], f"{name}_median": float(np.median(list(gaps.values()))),
                    f"_{name}_leaf": worst})
    out["_left_out"] = len(leaves) - len(moving)
    return out


def reference_log_probs(cfg: dict, corpus, weights, device, rows: np.ndarray, rounding: Rounding = Rounding(),
                        block: int = 64):
    """Eval-mode log-probs of ``rows`` in blocks (eval mode is row by row):
    yields (rows, (b, T', V) float32 log-probs, (b,) lengths)."""
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    model = ConformerCTC(cfg["model"], cfg["vocab_size"]).to(device)
    model.load_state_dict(weights, strict=True)
    model.eval()
    ctx = Ctx(False, compute_dtype(cfg, device), rounding)
    with torch.no_grad():
        for i in range(0, len(rows), block):
            idx = rows[i:i + block]
            audio, alen, _, _ = rows_of(corpus, idx, device)
            feats, frame_lengths = log_mel(audio, alen, cfg["features"])
            lp, lengths = model(feats, frame_lengths, ctx, remat=False)
            yield idx, lp, lengths


def label_gaps(log_probs: torch.Tensor, lengths: torch.Tensor, labels: Sequence[Optional[List[int]]],
               blank: int = 0, pad: int = 1) -> np.ndarray:
    """(b,) per row the least, over the alignments of its label (word ids,
    blank and pad frames dropped) to its frames, of the widest gap
    best - log_prob of what each frame served; inf for a row with no label
    or one that no alignment fits."""
    b, t, _ = log_probs.shape
    dev = log_probs.device
    best = log_probs.max(dim=-1).values
    g_drop = best - torch.maximum(log_probs[..., blank], log_probs[..., pad])
    lmax = max([len(x) for x in labels if x is not None] + [0])
    ids = torch.zeros((b, max(lmax, 1)), dtype=torch.int64, device=dev)
    n_words = torch.zeros(b, dtype=torch.int64, device=dev)
    for j, x in enumerate(labels):
        if x:
            ids[j, : len(x)] = torch.tensor(x, device=dev)
            n_words[j] = len(x)
    g_word = best[:, :, None] - torch.gather(log_probs, 2, ids[:, None, :].expand(b, t, ids.shape[1]))
    inf = torch.tensor(math.inf, device=dev)
    d = torch.full((b, ids.shape[1] + 1), math.inf, device=dev)
    d[:, 0] = 0.0
    for ti in range(t):
        stay = torch.maximum(d, g_drop[:, ti, None])
        take = torch.maximum(d[:, :-1], g_word[:, ti])
        new = torch.cat([stay[:, :1], torch.minimum(stay[:, 1:], take)], dim=1)
        d = torch.where((ti < lengths)[:, None], new, d)
    out = torch.gather(d, 1, n_words[:, None])[:, 0]
    missing = torch.tensor([x is None for x in labels], device=dev)
    return torch.where(missing, inf, out).cpu().numpy()
