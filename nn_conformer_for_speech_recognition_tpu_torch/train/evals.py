"""Plots and diagnostic artifacts, copied from
`nn_conformer_for_speech_recognition_tpu/train/evals.py`: loss/WER-vs-epoch
curves saved as PDF and confusion-matrix heatmaps (raw and row-normalised
%).  matplotlib is imported inside the functions: a machine that only
trains need not have it."""

from __future__ import annotations

import os
from typing import Dict, List, Sequence

import numpy as np


def _ensure_dir(path: str) -> None:
    d = os.path.dirname(os.path.abspath(path))
    os.makedirs(d, exist_ok=True)


def plot_curves(
    history: Dict[str, List[float]],
    out_path: str,
    title: str = "training curves",
) -> None:
    """Loss/WER line plots per epoch."""
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    _ensure_dir(out_path)
    keys = [k for k, v in history.items() if v]
    fig, axes = plt.subplots(1, max(len(keys), 1), figsize=(5 * max(len(keys), 1), 4))
    if len(keys) <= 1:
        axes = [axes]
    for ax, k in zip(axes, keys):
        ax.plot(history[k])
        ax.set_title(k)
        ax.set_xlabel("epoch")
        ax.grid(True, alpha=0.3)
    fig.suptitle(title)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)


def confusion_heatmap(
    refs: Sequence[str],
    hyps: Sequence[str],
    labels: Sequence[str],
    out_path: str,
    normalize: bool = False,
) -> np.ndarray:
    """Single-word confusion matrix heatmap.

    The reference task is 35 one-word commands, so ref/hyp pairs map directly
    to a confusion matrix; multi-word pairs use the first word.  Returns the
    matrix; with ``normalize`` rows become percentages.
    """
    import matplotlib

    matplotlib.use("Agg")
    import matplotlib.pyplot as plt

    idx = {w: i for i, w in enumerate(labels)}
    n = len(labels)
    cm = np.zeros((n, n), np.float64)
    for r, h in zip(refs, hyps):
        rw = r.split()[0] if r.split() else ""
        hw = h.split()[0] if h.split() else ""
        if rw in idx and hw in idx:
            cm[idx[rw], idx[hw]] += 1
    if normalize:
        cm = 100.0 * cm / np.maximum(cm.sum(axis=1, keepdims=True), 1)

    _ensure_dir(out_path)
    fig, ax = plt.subplots(figsize=(max(6, n // 3), max(5, n // 3)))
    im = ax.imshow(cm, cmap="viridis")
    ax.set_xticks(range(n), labels, rotation=90, fontsize=6)
    ax.set_yticks(range(n), labels, fontsize=6)
    ax.set_xlabel("predicted")
    ax.set_ylabel("target")
    fig.colorbar(im)
    fig.tight_layout()
    fig.savefig(out_path)
    plt.close(fig)
    return cm
