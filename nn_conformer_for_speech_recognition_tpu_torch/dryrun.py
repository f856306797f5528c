"""A multi-process dry run, the port's twin of the JAX package's
``__graft_entry__.dryrun_multichip``: one whole train step (featurize →
SpecAugment → forward and backward → Adafactor) of the JAX dry run's tiny
model over a ``('data', 'model')`` layout of processes, with every
kernel of the model on (``use_pallas=True``, ``attention_impl='flash'``,
``conv_impl='pallas'``, ``ctc_impl='pallas'``), then the pseudo-label pass
on the same layout.  The model axis has size 2 where the world is even and
at least 4 (tensor parallelism), else 1; ``shard_map_kernels`` is on, as
in the JAX dry run.

    torchrun --standalone --nproc-per-node 4 -m \\
        nn_conformer_for_speech_recognition_tpu_torch.dryrun [--device cpu]

Each process takes its own card (``LOCAL_RANK``) unless ``--device cpu``
asks for the CPU (gloo); rank 0 prints what ran.
"""

from __future__ import annotations

import argparse
from typing import Callable, Optional

import numpy as np
import torch
import torch.distributed as dist

from nn_conformer_for_speech_recognition_tpu_torch import config as C
from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import WordVocab
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu_torch.parallel import multihost as MH
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import (
    initialize_multihost,
    is_main_process,
    process_group_active,
)
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

SAMPLES = 4000  # a quarter second a clip


def dryrun_config() -> C.ModelConfig:
    """The JAX dry run's model: two blocks, d 32, 2 heads, FFN 64, every
    kernel pinned on (the 'auto' routes would take the library paths at
    these lengths)."""
    enc = C.ConformerConfig(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64, conv_kernel_size=7, dropout=0.1)
    dec = C.DecoderConfig(projection_dim=16, lstm_hidden=16, dropout=0.1)
    return C.ModelConfig(encoder=enc, decoder=dec, n_mels=13, subsampling=C.SubsamplingConfig(channels=(8, 8)),
                         use_pallas=True, attention_impl="flash", conv_impl="pallas")


def dryrun_multichip(device: Optional[str] = None, log: Callable[[str], None] = print) -> dict:
    """Joins the ``torchrun`` group (if any), runs one train step and the
    pseudo-label pass, checks the loss is finite and that every rank holds
    its rows' labels and the gathered labels count the batch; returns the
    layout's shape, the loss and the labels.  Rank 0 logs."""
    initialize_multihost("cpu" if device == "cpu" else "cuda")
    log = log if is_main_process() else (lambda _: None)
    world = dist.get_world_size() if process_group_active() else 1
    mp = 2 if world % 2 == 0 and world >= 4 else 1
    mesh_cfg = C.MeshConfig(model_parallel_size=mp, shard_map_kernels=True)
    feat_cfg = C.FeatureConfig(n_fft=256, hop_length=256, n_mels=13)
    b = world * 2
    train_cfg = C.TrainConfig(batch_size=b, optimizer=C.OptimizerConfig(learning_rate=1e-3), use_specaugment=True,
                              donate_state=False, ctc_impl="pallas", log_every=0)
    vocab = WordVocab(["<blank>", "<pad>", "<unk>", "yes", "no", "go", "stop"])
    trainer = Trainer(ConformerCTC(dryrun_config(), len(vocab)), vocab, feat_cfg, train_cfg, mesh_cfg,
                      device=device, log_fn=log)
    trainer.init_state(seed=0)

    rng = np.random.default_rng(0)
    audio = rng.standard_normal((b, SAMPLES)).astype(np.float32)
    alen = np.full((b,), SAMPLES, np.int32)
    targets = np.full((b, 4), vocab.pad_id, np.int32)
    targets[:, 0] = 3 + rng.integers(0, 4, size=(b,))
    tlen = np.ones((b,), np.int32)
    rows = slice(None) if trainer.shard is None else trainer.shard.rows(b)
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x[rows])).to(trainer.device)  # noqa: E731
    batch_lengths = torch.from_numpy(alen).to(trainer.device) if trainer.shard is not None else None
    step = trainer._composed_step(True, 0.0)
    trainer.state, metrics = step(trainer.state, put(audio), put(alen), put(targets), put(tlen), batch_lengths)
    loss = float(metrics["loss"])
    if not np.isfinite(loss):
        raise FloatingPointError(f"dryrun_multichip: the step's loss is {loss}")
    log(f"dryrun_multichip: mesh={trainer.mesh.shape} step ok, loss={loss:.4f}")

    ids, _ = trainer._predict_step(put(audio), put(alen))
    ids = ids.cpu().numpy()
    local = range(b)[rows]
    if ids.shape[0] != len(local):
        raise AssertionError(f"dryrun_multichip: {ids.shape[0]} rows decoded, the rank holds {len(local)}")
    labels = MH.gather_pseudo_labels({i: vocab.decode_ids(ids[r]) for r, i in enumerate(local)})
    if sorted(labels) != list(range(b)):
        raise AssertionError(f"dryrun_multichip: labels gathered for {sorted(labels)}, expected {b}")
    log(f"dryrun_multichip: pseudo-label ok, {len(labels)} labels over {trainer.mesh.data.size} data ranks "
        f"({len(local)} rows a rank)")
    return {"mesh": trainer.mesh.shape, "loss": loss, "labels": labels}


def main(argv=None) -> int:
    p = argparse.ArgumentParser(prog="nn_conformer_for_speech_recognition_tpu_torch.dryrun")
    p.add_argument("--device", default="cuda", choices=["cuda", "cpu"])
    args = p.parse_args(argv)
    try:
        dryrun_multichip(None if args.device == "cuda" else "cpu")
    finally:
        if process_group_active():
            dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    raise SystemExit(main())
