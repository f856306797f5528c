"""Converts a checkpoint of the JAX package's `Trainer` into one that the
PyTorch port reads (`train/checkpoint.restore_state`, ``--checkpoint``).

    python tools/jax_checkpoint_to_torch.py SRC DST [--model conformer_m] [--seed 0]

``SRC`` is a state directory written by the JAX package's ``save_state``
(``Trainer.save``, ``train --save``) or a ``CheckpointManager`` directory,
whose newest ``step_%08d`` is taken.  It is restored with orbax, without a
template, and converted by the port's framework-free
`convert.train_state_from_flax`: the parameters and batch statistics, the
Adafactor (or Adam) state and its count, the step, and the data-iterator
cursor where one was saved.  ``DST/state.pt`` is the port's checkpoint.

The JAX PRNG key cannot cross frameworks: the port seeds its SpecAugment
generator and its dropout from ``--seed`` (and the step), as its
`TrainState` always does.  ``--model`` names the preset whose BiLSTM layout
(layers, directions) the converter needs where the checkpoint holds flax
LSTM cells (``use_pallas=False``); the packed layout needs none.

Runs where both jax with orbax and torch are installed; the port itself
never imports jax.
"""

from __future__ import annotations

import argparse
import os
import re
import sys
import warnings

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def newest_state_dir(path: str) -> str:
    """``path`` itself, or the newest ``step_%08d`` of a manager's directory."""
    steps = sorted((int(m[1]), name) for name in os.listdir(path) if (m := re.fullmatch(r"step_(\d+)", name)))
    return os.path.join(path, steps[-1][1]) if steps else path


def restore(path: str) -> dict:
    """The saved TrainState tree, as numpy arrays."""
    import jax
    import numpy as np
    import orbax.checkpoint as ocp

    with warnings.catch_warnings():
        warnings.filterwarnings("ignore", message="Sharding info not provided")
        with ocp.PyTreeCheckpointer() as ckptr:
            tree = ckptr.restore(os.path.abspath(path))
    return jax.tree.map(np.asarray, tree)


def convert(src: str, dst: str, config, seed: int = 0) -> str:
    """Writes ``dst/state.pt`` from the JAX checkpoint at ``src`` for a
    port model of ``config`` (a port `ModelConfig`); returns the path."""
    import torch

    from nn_conformer_for_speech_recognition_tpu_torch.convert import train_state_from_flax
    from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import STATE_FILE

    payload = train_state_from_flax(restore(newest_state_dir(src)), config, seed=seed)
    os.makedirs(dst, exist_ok=True)
    out = os.path.join(dst, STATE_FILE)
    torch.save(payload, out)
    return out


def main(argv=None) -> int:
    if REPO not in sys.path:
        sys.path.insert(0, REPO)
    from nn_conformer_for_speech_recognition_tpu_torch.config import MODEL_PRESETS

    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("src", help="a JAX state directory, or a CheckpointManager directory")
    ap.add_argument("dst", help="the port checkpoint directory to write")
    ap.add_argument("--model", default="conformer_s", choices=sorted(MODEL_PRESETS))
    ap.add_argument("--seed", type=int, default=0, help="the port's generator and dropout seed")
    args = ap.parse_args(argv)
    print(convert(args.src, args.dst, MODEL_PRESETS[args.model](), seed=args.seed))
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
