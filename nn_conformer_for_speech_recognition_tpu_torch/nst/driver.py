"""The Noisy Student Training loop, port of
`nn_conformer_for_speech_recognition_tpu/nst/driver.py` with its semantics
kept whole:

  1. (optional) initial supervised finetune at ``ft_lr`` with SpecAugment;
  2. per generation: pseudo-label the unlabeled split U with the current
     model (greedy inference), filter labels (empty / too long / high-unk),
     build the 'mix' manifest = supervised ∪ pseudo-labeled U, and retrain
     with SpecAugment.

Mixing is a manifest merge and every generation checkpoints, so the loop is
resumable per generation.  The trainer is left holding the best
*generation*: the model it was given is never a candidate.  Under a process
group (a data-parallel `Trainer`) every rank runs the loop on the gathered
labels, and rank 0 writes the files.
"""

from __future__ import annotations

import copy
import dataclasses
import json
import os
from typing import Dict, List, Optional

from nn_conformer_for_speech_recognition_tpu_torch.config import NSTConfig
from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import (
    BucketedDataset,
    load_manifest,
    mix_datasets,
    save_manifest,
)
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import is_main_process
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer


@dataclasses.dataclass
class GenerationResult:
    generation: int
    num_pseudo_labels: int
    num_kept: int
    val_loss: Optional[float] = None
    val_wer: Optional[float] = None
    # set by best-generation selection: the generation whose checkpoint the
    # trainer is left holding (the best NST variant, not the last)
    is_best: bool = False


def _mix_dataset_like(supervised: BucketedDataset, utts) -> BucketedDataset:
    # mirror the supervised dataset's class, so that a subclass with the same
    # constructor (a streaming corpus) yields a mix of its own kind
    cls = type(supervised) if isinstance(supervised, BucketedDataset) \
        else BucketedDataset
    return cls(
        utts,
        supervised.vocab,
        supervised.batch_size,
        sample_rate=supervised.sample_rate,
        bucket_boundaries=supervised.bucket_boundaries,
        max_target_len=supervised.max_target_len,
    )


def run_nst(
    trainer: Trainer,
    supervised: BucketedDataset,
    unlabeled: BucketedDataset,
    cfg: NSTConfig,
    val_dataset: Optional[BucketedDataset] = None,
    work_dir: Optional[str] = None,
    checkpoint_manager=None,
    resume: bool = False,
    select_best: bool = True,
) -> List[GenerationResult]:
    """Run the NST loop with an already-initialised (trained) Trainer.

    The Trainer's optimizer should already be configured at ``cfg.ft_lr``.

    ``select_best`` (and a ``val_dataset``): the loop tracks every
    generation's val WER (val loss as tie-breaker when WER is off) and
    leaves the trainer holding the BEST generation's state, not the last:
    NST generations are noisy and can regress.  With ``work_dir`` the
    per-generation scores
    persist to ``nst_history.json`` so a resumed run still selects across
    generations that completed before the kill; without ``work_dir`` the
    candidate states are kept as deep copies on the device.

    With ``checkpoint_manager``, every retrain checkpoints (incl. mid-epoch
    cursors when ``TrainConfig.checkpoint_every_steps`` is set); with
    ``resume=True`` the loop restores the newest checkpoint and continues
    EXACTLY where a killed run stopped — mid-initial-finetune,
    mid-generation-retrain (reloading that generation's saved mix manifest
    from ``work_dir`` instead of re-labeling with the advanced model), or at
    a generation boundary.  The cursor encoding: the initial finetune trains
    at epoch offset 0, generation ``g``'s retrain at offset ``100·(g+1)``.
    """
    results: List[GenerationResult] = []
    history_path = os.path.join(work_dir, "nst_history.json") if work_dir else None
    candidates: List[dict] = []  # generation, val_wer, val_loss, ckpt|state

    def _record_candidate(res: GenerationResult) -> None:
        """Register a finished generation for best-of selection.  Called
        after ``trainer.save(ckpt_gen{g})`` so the path is live; without a
        work_dir the candidate is a deep copy of the state."""
        if res.val_wer is None and res.val_loss is None:
            return
        entry = {"generation": res.generation, "val_wer": res.val_wer,
                 "val_loss": res.val_loss}
        if work_dir:
            entry["ckpt"] = os.path.join(work_dir, f"ckpt_gen{res.generation}")
        if work_dir and is_main_process():
            hist = []
            if os.path.exists(history_path):
                with open(history_path) as f:
                    hist = json.load(f)
            hist = [h for h in hist if h["generation"] != res.generation]
            hist.append({k: entry[k] for k in ("generation", "val_wer",
                                               "val_loss", "ckpt")})
            with open(history_path, "w") as f:
                json.dump(sorted(hist, key=lambda h: h["generation"]), f)
        if not work_dir:
            entry["state"] = copy.deepcopy(trainer.state)
        candidates.append(entry)

    epg = cfg.train_epochs_per_generation
    # the resume cursor encodes generation g's retrain at epoch offset
    # 100·(g+1); epochs-per-generation ≥ 100 would alias into the next
    # generation's range and silently corrupt resume
    if epg >= 100:
        raise ValueError(
            f"train_epochs_per_generation={epg} must be < 100: the NST resume "
            "cursor encodes generation g at epoch offset 100*(g+1)"
        )
    start_gen = 0
    init_epoch, init_step = 0, 0
    init_needed = cfg.initial_supervised_finetune

    if resume and checkpoint_manager is not None:
        state, it = checkpoint_manager.restore_latest_with_iterator(trainer.state)
        if state is not None:
            trainer.state = state
        if it is not None:
            e, s = it["epoch"], it["step"]
            if e < 100:  # killed during (or right after) the initial finetune
                init_epoch, init_step = e, s
                if init_epoch >= epg and init_step == 0:
                    init_needed = False
            else:
                init_needed = False
                g, within = e // 100 - 1, e % 100
                if within >= epg and s == 0:
                    start_gen = g + 1  # clean generation boundary
                else:
                    # mid-generation: finish gen g's retrain from the cursor
                    # using its saved mix manifest (labels were generated by
                    # the gen-start model, which no longer exists — the
                    # manifest is the authoritative record)
                    if not work_dir:
                        raise ValueError("mid-generation resume needs work_dir")
                    mix_path = os.path.join(work_dir, f"mix_gen{g}.tsv")
                    mixed = _mix_dataset_like(supervised, load_manifest(mix_path))
                    trainer.train(
                        mixed,
                        epg - within,
                        val_dataset=val_dataset,
                        use_specaugment=True,
                        epoch_offset=100 * (g + 1) + within,
                        start_step=s,
                        checkpoint_manager=checkpoint_manager,
                        add_noise=cfg.add_noise,
                        noise_std=cfg.noise_std,
                    )
                    res = GenerationResult(g, -1, len(mixed.utterances))
                    if val_dataset is not None and trainer.history["val_loss"]:
                        res.val_loss = trainer.history["val_loss"][-1]
                        res.val_wer = trainer.history["val_wer"][-1]
                    if work_dir:
                        trainer.save(os.path.join(work_dir, f"ckpt_gen{g}"))
                    results.append(res)
                    _record_candidate(res)
                    start_gen = g + 1
        # generations that finished before the kill left their scores (and
        # checkpoint paths) in nst_history.json — reload them so best-of
        # selection still spans the whole run
        if history_path and os.path.exists(history_path):
            done = {c["generation"] for c in candidates}
            with open(history_path) as f:
                finished = json.load(f)
            for h in finished:
                if h["generation"] < start_gen and h["generation"] not in done:
                    candidates.append(h)
            candidates.sort(key=lambda c: c["generation"])

    if init_needed:
        # gen-0 supervised finetune with SpecAugment
        trainer.train(
            supervised,
            epg - init_epoch,
            val_dataset=val_dataset,
            use_specaugment=True,
            epoch_offset=init_epoch,
            start_step=init_step,
            checkpoint_manager=checkpoint_manager,
            add_noise=cfg.add_noise,
            noise_std=cfg.noise_std,
        )

    for gen in range(start_gen, cfg.generations):
        labels: Dict[int, str] = trainer.generate_labels(unlabeled)
        pseudo = unlabeled.with_pseudo_labels(
            labels, unk_tol=cfg.unk_tolerance, max_target_len=cfg.max_target_len
        )
        mixed_utts = mix_datasets(supervised.utterances, pseudo)
        if work_dir and is_main_process():
            os.makedirs(work_dir, exist_ok=True)
            save_manifest(os.path.join(work_dir, f"mix_gen{gen}.tsv"), mixed_utts)

        mixed = _mix_dataset_like(supervised, mixed_utts)
        # student retrain: SpecAugment + (optional) waveform gaussian noise,
        # the "noisy" in noisy-student
        trainer.train(
            mixed,
            cfg.train_epochs_per_generation,
            val_dataset=val_dataset,
            use_specaugment=True,
            epoch_offset=100 * (gen + 1),
            checkpoint_manager=checkpoint_manager,
            add_noise=cfg.add_noise,
            noise_std=cfg.noise_std,
        )

        res = GenerationResult(gen, len(labels), len(pseudo))
        if val_dataset is not None and trainer.history["val_loss"]:
            res.val_loss = trainer.history["val_loss"][-1]
            res.val_wer = trainer.history["val_wer"][-1]
        if work_dir:
            trainer.save(os.path.join(work_dir, f"ckpt_gen{gen}"))
        results.append(res)
        _record_candidate(res)

    if select_best and candidates:
        def score(c):
            return (
                c["val_wer"] if c["val_wer"] is not None else float("inf"),
                c["val_loss"] if c["val_loss"] is not None else float("inf"),
                c["generation"],
            )

        best = min(candidates, key=score)
        for r in results:
            r.is_best = r.generation == best["generation"]
        if best["generation"] != candidates[-1]["generation"]:
            # the trainer currently holds the LAST generation's state;
            # restore the best one
            if "state" in best:
                trainer.state = best["state"]
            else:
                trainer.load(best["ckpt"])
    return results
