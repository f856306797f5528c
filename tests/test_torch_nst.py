"""The port's Noisy Student loop (`run_nst`) against the JAX package's.

One generation without the initial finetune, both trainers from the same
(converted) weights on the same corpus: the pseudo-labels, the count kept
by the filter and the lines of ``mix_gen0.tsv`` must be equal.  The retrain
that follows runs under SpecAugment, whose draws cannot match across the
two frameworks, so its losses are not compared.  Selection of the best
generation, the guard on epochs per generation and kill-and-resume inside
a generation (bit for bit) are tested on the port alone.
"""

import json
import os

import numpy as np
import pytest
import torch

from _torch_trainer_helpers import (
    KilledAfter,
    assert_same_state,
    jax_trainer,
    make_corpus,
    perturbed_variables,
    port_trainer,
)

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.nst.driver import run_nst as jax_run_nst
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, Utterance, load_manifest
from nn_conformer_for_speech_recognition_tpu_torch.nst import driver as D
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager

NST = dict(generations=1, train_epochs_per_generation=1, initial_supervised_finetune=False, max_target_len=12,
           unk_tolerance=0.45)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"), n_train=16, n_val=8, n_unlabeled=16)


def test_one_generation_matches_jax(corpus, tmp_path):
    _, jvocab, tvocab, jdata, tdata = corpus
    variables = perturbed_variables(jax_trainer(jvocab), np.random.default_rng(1))
    jt, tt = jax_trainer(jvocab, variables, use_specaugment=True), port_trainer(tvocab, variables, use_specaugment=True)
    ref = jax_run_nst(jt, jdata["train"], jdata["unlabeled"], C.NSTConfig(**NST), val_dataset=jdata["validation"],
                      work_dir=str(tmp_path / "jax"))
    got = D.run_nst(tt, tdata["train"], tdata["unlabeled"], TC.NSTConfig(**NST), val_dataset=tdata["validation"],
                    work_dir=str(tmp_path / "port"))
    assert len(got) == len(ref) == 1
    assert (got[0].generation, got[0].num_pseudo_labels, got[0].num_kept) == (0, 16, ref[0].num_kept)
    assert ref[0].num_pseudo_labels == 16 and 0 < got[0].num_kept < 16, "the filter kept all or nothing"
    mix, ref_mix = (open(tmp_path / name / "mix_gen0.tsv").read().split("\n") for name in ("port", "jax"))
    assert mix == ref_mix and len(mix) == 16 + got[0].num_kept
    assert got[0].is_best and ref[0].is_best and np.isfinite(got[0].val_loss) and got[0].val_wer is not None
    assert os.path.isfile(tmp_path / "port" / "ckpt_gen0" / "state.pt")
    history = json.load(open(tmp_path / "port" / "nst_history.json"))
    assert [h["generation"] for h in history] == [0] and history[0]["ckpt"].endswith("ckpt_gen0")
    assert int(tt.state.step) == int(jt.state.step) == -(-len(mix) // 8)
    assert len(tt.history["train_loss"]) == 1 and np.isfinite(tt.history["train_loss"][0])


class _ScriptedTrainer:
    """Minimal Trainer stand-in: scripted validation metrics per train(), a
    state that records how many trains ran, save and load to a file."""

    def __init__(self, script):
        self.script = list(script)
        self.calls = 0
        self.state = {"w": np.array([0.0])}
        self.history = {"val_loss": [], "val_wer": []}

    def train(self, ds, epochs, **kw):
        vl, vw = self.script[self.calls]
        self.calls += 1
        self.history["val_loss"].append(vl)
        self.history["val_wer"].append(vw)
        self.state = {"w": np.array([float(self.calls)])}

    def generate_labels(self, ds):
        return {i: "go" for i in range(len(ds.utterances))}

    def save(self, path):
        np.save(path + ".npy", np.asarray(self.state["w"]))

    def load(self, path):
        self.state = {"w": np.load(path + ".npy")}


def _fake_unlabeled(n=4):
    class FakeVocab:
        pad_id, blank_id, unk_id = 1, 0, 2

        def parse(self, s):
            return [5 for _ in s.split()]

    ds = BucketedDataset.__new__(BucketedDataset)
    ds.utterances = [Utterance(f"/x/{i}.wav", "") for i in range(n)]
    ds.vocab = FakeVocab()
    ds.max_target_len = 8
    ds.batch_size = 4
    ds.sample_rate = 16000
    ds.bucket_boundaries = []
    return ds


@pytest.mark.parametrize("use_work_dir", [True, False])
def test_nst_best_generation_selected(tmp_path, monkeypatch, use_work_dir):
    """`run_nst` leaves the trainer holding the BEST generation's state
    (validation WER), not the last: generation 2 regresses here."""
    monkeypatch.setattr(D, "_mix_dataset_like", lambda sup, utts: _fake_unlabeled())
    tr = _ScriptedTrainer(script=[(0.5, 50.0), (0.4, 30.0), (0.45, 60.0)])
    cfg = TC.NSTConfig(generations=3, train_epochs_per_generation=1, initial_supervised_finetune=False)
    work = str(tmp_path / "nst") if use_work_dir else None
    results = D.run_nst(tr, _fake_unlabeled(), _fake_unlabeled(), cfg, val_dataset=object(), work_dir=work)
    assert [r.is_best for r in results] == [False, True, False]
    assert float(np.asarray(tr.state["w"])[0]) == 2.0  # generation 1's state restored
    if use_work_dir:
        hist = json.load(open(os.path.join(work, "nst_history.json")))
        assert [h["generation"] for h in hist] == [0, 1, 2] and hist[1]["val_wer"] == 30.0


def test_nst_best_generation_noop_without_val(monkeypatch):
    """No val_dataset → no candidates → selection must not touch the state."""
    monkeypatch.setattr(D, "_mix_dataset_like", lambda sup, utts: _fake_unlabeled())
    tr = _ScriptedTrainer(script=[(0.5, 50.0), (0.4, 30.0)])
    cfg = TC.NSTConfig(generations=2, train_epochs_per_generation=1, initial_supervised_finetune=False)
    results = D.run_nst(tr, _fake_unlabeled(), _fake_unlabeled(), cfg)
    assert all(not r.is_best for r in results)
    assert float(np.asarray(tr.state["w"])[0]) == 2.0  # the last state kept


def test_best_generation_without_work_dir_keeps_deep_copies(corpus, monkeypatch):
    """With a real `Trainer` and no ``work_dir`` the candidates are deep
    copies of the train state; when an earlier generation wins, the trainer
    takes over that copy's model and goes on working with it."""
    _, _, tvocab, _, tdata = corpus
    tr = port_trainer(tvocab)
    scores = iter([(0.3, 0.2), (0.9, 0.8)])  # generation 1 regresses
    monkeypatch.setattr(tr, "evaluate", lambda ds: next(scores))
    snapshots = []
    train = tr.train
    monkeypatch.setattr(tr, "train", lambda *a, **kw: (train(*a, **kw), snapshots.append(
        {k: v.clone() for k, v in tr.model.state_dict().items()}))[0])
    cfg = TC.NSTConfig(generations=2, initial_supervised_finetune=False, max_target_len=12, unk_tolerance=1.0)
    first_model = tr.model
    results = D.run_nst(tr, tdata["train"], tdata["unlabeled"], cfg, val_dataset=tdata["validation"])
    assert [r.is_best for r in results] == [True, False]
    assert tr.model is not first_model and tr.state.model is tr.model
    assert all(torch.equal(v, snapshots[0][k]) for k, v in tr.model.state_dict().items())
    assert tr.state.step == -(-(16 + results[0].num_kept) // 8)
    assert sorted(tr.generate_labels(tdata["unlabeled"])) == list(range(16))


def test_nst_epochs_per_generation_guard(corpus):
    _, _, tvocab, _, tdata = corpus
    with pytest.raises(ValueError, match="100"):
        D.run_nst(port_trainer(tvocab), tdata["train"], tdata["unlabeled"],
                  TC.NSTConfig(generations=1, train_epochs_per_generation=100))


def test_mid_nst_generation_kill_and_resume(corpus, tmp_path, monkeypatch):
    """Kill inside generation 0's retrain; ``run_nst(resume=True)`` reloads
    the saved mix manifest and the mid-epoch cursor and finishes with the
    state of an uninterrupted run, bit for bit."""
    _, _, tvocab, _, tdata = corpus
    cfg = TC.NSTConfig(**{**NST, "unk_tolerance": 1.0})

    def fresh(name):
        return port_trainer(tvocab, dropout=0.1, use_specaugment=True, checkpoint_dir=str(tmp_path / name),
                            checkpoint_every_steps=1)

    ref = fresh("ref_ck")
    ref_results = D.run_nst(ref, tdata["train"], tdata["unlabeled"], cfg, work_dir=str(tmp_path / "ref_wd"))
    assert ref_results[0].num_kept > 0

    wd = str(tmp_path / "wd")
    killed = fresh("ck")
    mix = D._mix_dataset_like
    with monkeypatch.context() as m:
        m.setattr(D, "_mix_dataset_like", lambda sup, utts: KilledAfter(mix(sup, utts), 1))
        with pytest.raises(KeyboardInterrupt):
            D.run_nst(killed, tdata["train"], tdata["unlabeled"], cfg, work_dir=wd,
                      checkpoint_manager=CheckpointManager(str(tmp_path / "ck")))
    assert killed.state.step == 1 and len(load_manifest(os.path.join(wd, "mix_gen0.tsv"))) == 16 + ref_results[0].num_kept

    res = fresh("ck")
    results = D.run_nst(res, tdata["train"], tdata["unlabeled"], cfg, work_dir=wd,
                        checkpoint_manager=CheckpointManager(str(tmp_path / "ck")), resume=True)
    assert_same_state(res, ref)
    assert [(r.generation, r.num_pseudo_labels, r.num_kept) for r in results] == [(0, -1, 16 + ref_results[0].num_kept)]
    # resumed once more at the generation's boundary: nothing is left to do
    again = D.run_nst(res, tdata["train"], tdata["unlabeled"], cfg, work_dir=wd,
                      checkpoint_manager=CheckpointManager(str(tmp_path / "ck")), resume=True)
    assert again == [] and res.state.step == ref.state.step
