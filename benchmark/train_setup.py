"""The set-up of training kinds that bring their own weights or run on the
ranks of a process group, and their readings.

`resident_trainer` is `harness.resident_trainer`, with the same steps:
the corpus drawn from the seed, written as WAV files and a manifest, read
by the port's ``BucketedDataset`` and made resident by its
``DeviceResidentDataset``; a ``Trainer`` over the configuration; the
benchmark's weights, ``weights(cfg, seed, device)``, loaded after
``Trainer.init_state``.  Under a process group every rank draws the
same corpus, rank 0 alone writes the WAV files into a folder every rank
reads, the dataset carries the rank's ``DataShard``, and the trainer lays
its ranks out as data-parallel (``MeshConfig()``).

`first_calls` is `kinds/train.py`'s warm-up: two calls, whose first steps
the reference follows, the optimizer's step watched meanwhile; `readings`
compares them with the reference's, as `kinds/train.py`'s judge does.
"""

from __future__ import annotations

import shutil
import tempfile
import time
from typing import Dict

import torch

from benchmark import harness as H
from benchmark import traffic as T
from benchmark.reference import judge as J


def resident_trainer(run, weights) -> None:
    import torch.distributed as dist

    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, load_manifest
    from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import WordVocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import barrier, data_shard
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    cfg, traffic = run.cfg, run.traffic
    # the configuration first: a port that cannot build it fails before the corpus is drawn
    model_cfg, feat_cfg, train_cfg = H.port_configs(cfg, traffic, run.seed)
    grouped = dist.is_available() and dist.is_initialized()
    shard = data_shard() if grouped else None
    marks = [("start", time.perf_counter())]
    run.corpus = T.make_corpus(traffic, cfg, run.seed, run.device)
    marks.append(("corpus drawn", time.perf_counter()))
    sr = cfg["features"]["sample_rate"]
    folder = [tempfile.mkdtemp(prefix="bench-corpus-") if not grouped or shard.rank == 0 else None]
    try:
        if grouped:
            dist.broadcast_object_list(folder, src=0)
        manifest = f"{folder[0]}/manifest.tsv"
        if not grouped or shard.rank == 0:
            manifest = H.write_corpus(run.corpus, sr, folder[0])
        barrier()
        utts = load_manifest(manifest)
        marks.append(("WAV written", time.perf_counter()))
        vocab = WordVocab(run.corpus.words)
        pad_to = run.corpus.pcm.shape[1]
        source = BucketedDataset(utts, vocab, traffic["batch"], sample_rate=sr, bucket_boundaries=(pad_to,),
                                 max_target_len=run.corpus.max_target_len)
        run.dataset = DeviceResidentDataset(source, pad_to=pad_to, device=run.device, sharding=shard)
        barrier()
        marks.append(("resident", time.perf_counter()))
    finally:
        if folder[0] is not None and (not grouped or shard.rank == 0):
            shutil.rmtree(folder[0], ignore_errors=True)
    run.trainer = Trainer(ConformerCTC(model_cfg, len(vocab)), vocab, feat_cfg, train_cfg, log_fn=H.log,
                          device=run.device)
    run.trainer.init_state(seed=run.seed)
    run.trainer.model.load_state_dict(weights(cfg, run.seed, run.device), strict=True)
    marks.append(("trainer and weights", time.perf_counter()))
    H.log("set-up seconds: " + ", ".join(f"{name} {t - marks[i][1]:.3f}" for i, (name, t) in enumerate(marks[1:])))
    run.audio_per_call = float(run.corpus.lengths.sum()) / sr  # an epoch holds every clip once, over every rank
    run.steps_per_call = run.dataset.num_batches()


def first_calls(run) -> None:
    """Two calls through the window's own call; after step 1 the first
    gradient's norm by leaf is read from the optimizer's second moments,
    after step 3 the parameters; the first call's mean loss is kept."""
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
        loss = run.trainer.history["train_loss"][-1]
        run.call()
    finally:
        del opt.step
    run.observed = {"loss12": loss, "grad": grad, "params3": params}


def readings(run, ref: dict, weights: Dict[str, torch.Tensor]) -> Dict[str, float]:
    obs = run.observed
    change = {n: float((obs["params3"][n].double() - weights[n].cpu().double()).norm()) for n in obs["params3"]}
    return J.train_readings({"loss12": obs["loss12"], "grad": obs["grad"], "change": change}, ref)
