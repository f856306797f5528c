"""A ``label`` mix: the window repeats ``Trainer.generate_labels(dataset)``,
the NST pseudo-label pass over a ``DeviceResidentDataset`` of unlabelled
clips, each call ending in the program's own ``.cpu()`` of the ids and its
host decode into words.  The reference judges the last pass's labels."""

from __future__ import annotations

import math
from typing import Dict

import numpy as np

from benchmark import harness as H
from benchmark import yardstick as Y
from benchmark.reference import judge as J

MOVES = "label_audio_per_s"
TRAINING = False


def flops_per_step(model: dict, vocab_size: int, batch: int, frames: int) -> float:
    return Y.conformer_forward_flops(model, vocab_size, batch, frames)


def setup(run) -> None:
    """The resident corpus and the trainer, then one pass."""
    H.resident_trainer(run)
    run.labels = run.call()


def call(run):
    return run.trainer.generate_labels(run.dataset)


def failed(run, out) -> int:
    """The rows that got no label; the pass's labels are kept for the judge."""
    run.labels = out
    return len(run.corpus.lengths) - len(out)


def attempted(run, calls: int) -> int:
    return calls * len(run.corpus.lengths)



def readings(gaps: np.ndarray) -> Dict[str, float]:
    """``label_gap``: the widest gap over the rows that have a label;
    ``missing``: the rows without one."""
    missing = int(np.isinf(gaps).sum())
    return {"label_gap": float(gaps[np.isfinite(gaps)].max()) if missing < len(gaps) else math.inf,
            "missing": missing}


def judge(run) -> Dict[str, float]:
    weights = H.make_weights(run.cfg, run.seed, run.device)
    index = {w: i for i, w in enumerate(run.corpus.words)}
    rows = np.arange(len(run.corpus.lengths))
    gaps = []
    for idx, lp, lengths in J.reference_log_probs(run.cfg, run.corpus, weights, run.device, rows):
        labels = [None if int(i) not in run.labels else [index.get(w, 2) for w in run.labels[int(i)].split()]
                  for i in idx]
        gaps.append(J.label_gaps(lp, lengths, labels))
    return readings(np.concatenate(gaps))


def control(cell: dict, seed: int, device):
    """Yields (side, readings) for the control (the reference with fp8 e4m3
    products in the program's place: its greedy labels) and the fault of one
    word of every row's label altered where it is produced, each judged
    against the reference's log-probs."""
    from benchmark import traffic as T
    from benchmark.reference.ops import Rounding, fp8_round

    cfg = cell["cfg"]
    corpus = T.make_corpus(cell["traffic"], cfg, seed, device)
    weights = H.make_weights(cfg, seed, device)
    rows = np.arange(len(corpus.lengths))
    sides = {"control": [], "fault: a word altered": []}

    def greedy(lp, lengths, j):
        return [int(x) for x in lp[j, : int(lengths[j])].argmax(dim=-1).tolist() if x not in (0, 1)]

    for (idx, lp8, _), (_, lp, lengths) in zip(
            J.reference_log_probs(cfg, corpus, weights, device, rows, rounding=Rounding(fp8_round)),
            J.reference_log_probs(cfg, corpus, weights, device, rows)):
        served = [greedy(lp8, lengths, j) for j in range(len(idx))]
        own = [greedy(lp, lengths, j) for j in range(len(idx))]
        for words in own:  # the reference's own labels, one word of each altered
            if words:
                words[len(words) // 2] = 3 + (words[len(words) // 2] - 3 + 1) % (cfg["vocab_size"] - 3)
        sides["control"].append(J.label_gaps(lp, lengths, served))
        sides["fault: a word altered"].append(J.label_gaps(lp, lengths, own))
    for side, g in sides.items():
        g = np.concatenate(g)
        yield side, dict(readings(g), median_row=float(np.median(g[np.isfinite(g)])))
