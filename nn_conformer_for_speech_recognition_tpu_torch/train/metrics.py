"""Evaluation metrics: WER/CER and running means, copied from the JAX
package's ``train/metrics.py`` (``tests/test_torch_data.py`` holds them
equal on random strings).

WER is a word-level Levenshtein distance (insertions + deletions +
substitutions over the reference length).  `padded_wer` is the protocol of
the system this project was modelled on: the shorter of (hypothesis words,
reference words) is padded with ``'_'`` to equal length first.
"""

from __future__ import annotations

from typing import Sequence


def edit_distance(ref: Sequence, hyp: Sequence) -> int:
    """Levenshtein distance with O(min(len)) memory."""
    if len(ref) < len(hyp):
        ref, hyp = hyp, ref
    prev = list(range(len(hyp) + 1))
    for i, r in enumerate(ref, 1):
        cur = [i] + [0] * len(hyp)
        for j, h in enumerate(hyp, 1):
            cur[j] = min(
                prev[j] + 1,  # deletion
                cur[j - 1] + 1,  # insertion
                prev[j - 1] + (r != h),  # substitution
            )
        prev = cur
    return prev[-1]


def wer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    """Corpus WER in [0, 1]: total edits / total reference words."""
    edits, n = 0, 0
    for r, h in zip(refs, hyps):
        rw, hw = r.split(), h.split()
        edits += edit_distance(rw, hw)
        n += len(rw)
    return edits / max(n, 1)


def cer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    edits, n = 0, 0
    for r, h in zip(refs, hyps):
        edits += edit_distance(list(r), list(h))
        n += len(r)
    return edits / max(n, 1)


def padded_wer(refs: Sequence[str], hyps: Sequence[str]) -> float:
    """Pad the shorter word list with '_' to equal length, then word error
    rate × 1 (callers multiply by 100).  Padding turns length mismatches into
    substitutions against '_' instead of pure ins/del."""
    edits, n = 0, 0
    for r, h in zip(refs, hyps):
        rw, hw = r.split(), h.split()
        if len(rw) < len(hw):
            rw = rw + ["_"] * (len(hw) - len(rw))
        elif len(hw) < len(rw):
            hw = hw + ["_"] * (len(rw) - len(hw))
        edits += edit_distance(rw, hw)
        n += len(rw)
    return edits / max(n, 1)


class Mean:
    """Running mean accumulator (loss/WER per epoch)."""

    def __init__(self):
        self.total = 0.0
        self.count = 0

    def update(self, value: float, weight: int = 1) -> None:
        self.total += float(value) * weight
        self.count += weight

    def result(self) -> float:
        return self.total / max(self.count, 1)


def perplexity(mean_loss: float) -> float:
    """LM perplexity = exp(loss)."""
    import math

    return math.exp(min(mean_loss, 700.0))
