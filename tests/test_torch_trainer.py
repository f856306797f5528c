"""The port's `Trainer` against the JAX package's, and its checkpoints.

Both trainers start from the same weights (the JAX initialisation with
noise added, converted), read the same synthetic corpus in the same order
(`BucketedDataset.epoch` is held equal in ``test_torch_data.py``) and run
``use_pallas=True, conv_impl='pallas'`` in float32 with dropout 0 and
SpecAugment off, Adafactor at lr 1e-3.  Tolerances: the epoch's mean train
loss over 4 steps and the validation loss rtol 1e-4 (float32, sums in
another order, four optimizer updates apart); WER, decoded strings and
pseudo-labels equal.  The checkpoint tests run on the port alone, with
dropout 0.1 and SpecAugment on, and are exact: a resumed run must equal an
uninterrupted one bit for bit.
"""

import os

import jax
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

from nn_conformer_for_speech_recognition_tpu.train import loop as JL
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager, restore_state, save_state
from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_beam_step, make_epoch_scan_step


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


@pytest.fixture(scope="module")
def both(corpus):
    """One epoch of `train`, then `evaluate` and `generate_labels`, in both
    packages from the same weights."""
    _, jvocab, tvocab, jdata, tdata = corpus
    jt = jax_trainer(jvocab)
    variables = perturbed_variables(jt, np.random.default_rng(0))
    jt = jax_trainer(jvocab, variables)
    tt = port_trainer(tvocab, variables)
    out = {}
    for name, trainer, data in (("jax", jt, jdata), ("port", tt, tdata)):
        before = trainer.evaluate(data["validation"], return_texts=True)
        labels_before = trainer.generate_labels(data["unlabeled"])
        history = trainer.train(data["train"], epochs=1, val_dataset=data["validation"])
        out[name] = dict(before=before, labels_before=labels_before, history={k: list(v) for k, v in history.items()},
                         after=trainer.evaluate(data["validation"], wer_protocol="padded"),
                         labels=trainer.generate_labels(data["unlabeled"]), step=int(trainer.state.step))
    return out


def test_train_epoch_loss_matches_jax(both):
    got, ref = both["port"], both["jax"]
    assert got["step"] == ref["step"] == 4
    assert len(got["history"]["train_loss"]) == 1
    np.testing.assert_allclose(got["history"]["train_loss"], ref["history"]["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["history"]["val_loss"], ref["history"]["val_loss"], rtol=1e-4)
    assert got["history"]["val_wer"] == ref["history"]["val_wer"]


def test_evaluate_matches_jax(both):
    (loss, wer, refs, hyps), (ref_loss, ref_wer, ref_refs, ref_hyps) = both["port"]["before"], both["jax"]["before"]
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    assert refs == ref_refs and hyps == ref_hyps and wer == ref_wer
    assert any(hyps), "the decodes are all empty: the comparison is vacuous"
    np.testing.assert_allclose(both["port"]["after"][0], both["jax"]["after"][0], rtol=1e-4)
    assert both["port"]["after"][1] == both["jax"]["after"][1]  # the padded protocol


def test_generate_labels_matches_jax(both, corpus):
    n = len(corpus[4]["unlabeled"])
    for key in ("labels_before", "labels"):
        assert both["port"][key] == both["jax"][key]
        assert sorted(both["port"][key]) == list(range(n))
    assert any(both["port"]["labels_before"].values())


def test_generate_labels_index_map_and_dump(corpus, tmp_path):
    _, _, tvocab, _, tdata = corpus
    tr = port_trainer(tvocab)
    labels = tr.generate_labels(tdata["unlabeled"], index_map=np.arange(100, 108))
    assert sorted(labels) == list(range(100, 108))
    dump = tmp_path / "out" / "pred.txt"
    loss, wer = tr.evaluate(tdata["validation"], dump_path=str(dump))
    assert np.isfinite(loss) and 0.0 <= wer
    assert dump.read_text().startswith("pred:") and "tgt:" in dump.read_text()


def _noisy_trainer(vocab, ckpt_dir=None, every=0):
    return port_trainer(vocab, dropout=0.1, use_specaugment=True, checkpoint_dir=ckpt_dir,
                        checkpoint_every_steps=every, train_wer=True)


def test_checkpoint_roundtrip(corpus, tmp_path):
    _, _, tvocab, _, tdata = corpus
    tr = _noisy_trainer(tvocab)
    tr.train(tdata["train"], epochs=1)
    assert len(tr.history["train_wer"]) == 1 and np.isfinite(tr.history["train_wer"][0])
    tr.save(str(tmp_path / "ckpt"))
    assert os.path.isfile(tmp_path / "ckpt" / "state.pt")
    other = _noisy_trainer(tvocab)
    other.init_state(seed=1)
    assert not torch.equal(other.model.final_fc.weight, tr.model.final_fc.weight)
    other.load(str(tmp_path / "ckpt"))
    assert_same_state(other, tr)
    # both continue alike: the optimizer state, the generator and the dropout seed came along
    tr.train(tdata["train"], epochs=1, epoch_offset=1)
    other.train(tdata["train"], epochs=1, epoch_offset=1)
    assert_same_state(other, tr)


def test_checkpoint_manager_rotation_best_and_cursor(corpus, tmp_path):
    _, _, tvocab, _, _ = corpus
    tr = port_trainer(tvocab)
    mgr = CheckpointManager(str(tmp_path / "ck"), keep=2)
    assert mgr.latest() is None and mgr.restore_latest_with_iterator(tr.state) == (None, None)
    for step, metric in ((1, 0.9), (2, 0.5), (3, 0.7)):
        tr.state.step = step
        mgr.save(tr.state, metric=metric, iterator={"epoch": 0, "step": step})
    assert sorted(os.listdir(mgr.directory)) == ["best", "step_00000002", "step_00000003"]
    assert mgr.latest().endswith("step_00000003") and mgr.best_metric == 0.5
    tr.state.step = 0
    state, it = mgr.restore_latest_with_iterator(tr.state)
    assert state is tr.state and state.step == 3 and it == {"epoch": 0, "step": 3}
    assert restore_state(os.path.join(mgr.directory, "best"), tr.state).step == 2
    save_state(str(tmp_path / "plain"), tr.state)  # no cursor given
    assert restore_state(str(tmp_path / "plain"), tr.state, with_iterator=True)[1] is None
    assert mgr.restore_latest(tr.state).step == 3


def test_mid_epoch_kill_and_resume_is_bit_identical(corpus, tmp_path):
    """Kill after 3 steps of a 4-step epoch; `resume` in a fresh trainer
    completes the two epochs with parameters, batch statistics, optimizer
    state, generator state and step equal to an uninterrupted run's."""
    _, _, tvocab, _, tdata = corpus
    ds = tdata["train"]
    ref = _noisy_trainer(tvocab)
    ref.train(ds, epochs=2)

    killed = _noisy_trainer(tvocab, str(tmp_path / "ck"), every=1)
    with pytest.raises(KeyboardInterrupt):
        killed.train(KilledAfter(ds, 3), epochs=2)
    assert killed.state.step == 3

    res = _noisy_trainer(tvocab, str(tmp_path / "ck"), every=1)
    res.init_state(seed=5)  # whatever it holds is replaced
    res.resume(ds, epochs=2)
    assert_same_state(res, ref)
    assert res.state.step == 8 and len(res.history["train_loss"]) == 2
    # a second resume finds the run complete
    assert res.resume(ds, epochs=2) is res.history and res.state.step == 8
    # and one without a checkpoint just trains
    fresh = _noisy_trainer(tvocab, str(tmp_path / "empty"))
    fresh.resume(ds, epochs=1)
    assert fresh.state.step == 4


def test_encoder_only_restore_touches_encoder_and_subsampling_only(corpus, tmp_path):
    _, _, tvocab, _, tdata = corpus
    donor = _noisy_trainer(tvocab)
    donor.train(tdata["train"], epochs=1)
    donor.save(str(tmp_path / "donor"))
    tr = port_trainer(tvocab)
    tr.init_state(seed=3)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.load_encoder_only(str(tmp_path / "donor"))
    params = {n for n, _ in tr.model.named_parameters()}
    changed = {k for k, v in tr.model.state_dict().items() if not torch.equal(v, before[k])}
    taken = {k for k in params if k.startswith(("encoder.", "subsampling."))}
    assert changed == taken and taken
    donor_sd = donor.model.state_dict()
    assert all(torch.equal(tr.model.state_dict()[k], donor_sd[k]) for k in taken)
    assert tr.state.step == 0


BEAM_KNOBS = dict(beam=4, prune=3, max_label_len=6)


@pytest.fixture(scope="module")
def beam_pair(corpus):
    """A trainer of each package from the same weights, with the beam's knobs."""
    _, jvocab, tvocab, _, _ = corpus
    jt = jax_trainer(jvocab, **BEAM_KNOBS)
    variables = perturbed_variables(jt, np.random.default_rng(1))
    return jax_trainer(jvocab, variables, **BEAM_KNOBS), port_trainer(tvocab, variables, **BEAM_KNOBS)


def test_evaluate_beam_matches_jax(corpus, beam_pair):
    """`evaluate(decode='beam')` from the same weights in both packages (beam
    4, prune 3, room for 6 labels): loss rtol 1e-4 and equal to the greedy
    call's, decoded strings and WER equal."""
    _, _, _, jdata, tdata = corpus
    jt, tt = beam_pair
    ref_loss, ref_wer, ref_refs, ref_hyps = jt.evaluate(jdata["validation"], decode="beam", return_texts=True)
    loss, wer, refs, hyps = tt.evaluate(tdata["validation"], decode="beam", return_texts=True)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    assert refs == ref_refs and hyps == ref_hyps and wer == ref_wer
    assert any(hyps), "the decodes are all empty: the comparison is vacuous"
    assert loss == tt.evaluate(tdata["validation"])[0]
    with pytest.raises(ValueError, match="decode must be"):
        tt.evaluate(tdata["validation"], decode="viterbi")


def test_make_beam_step_matches_jax(corpus, beam_pair):
    """`make_beam_step` on one batch against the JAX package's: the 1-best
    tokens and lengths equal, its score atol 1e-4 (a float32 log-sum over
    the frames of two forwards that sum in another order)."""
    _, _, _, jdata, tdata = corpus
    jt, tt = beam_pair
    jbatch, tbatch = next(iter(jdata["validation"].epoch(seed=0))), next(iter(tdata["validation"].epoch(seed=0)))
    ref = jax.jit(JL.make_beam_step(jt.model, jt.feat_cfg, jt.vocab.blank_id, **BEAM_KNOBS))(
        jt.state, jbatch.audio, jbatch.audio_lengths)
    step = make_beam_step(tt.model, tt.feat_cfg, tt.vocab.blank_id, **BEAM_KNOBS)
    toks, lens, scores = step(torch.from_numpy(tbatch.audio), torch.from_numpy(tbatch.audio_lengths))
    ref_toks, ref_lens, ref_scores = (np.asarray(a) for a in ref)
    assert toks.shape == (len(tbatch.audio), BEAM_KNOBS["max_label_len"]) and ref_lens.max() > 0
    np.testing.assert_array_equal(toks.numpy(), ref_toks)
    np.testing.assert_array_equal(lens.numpy(), ref_lens)
    np.testing.assert_allclose(scores.numpy(), ref_scores, atol=1e-4)


def test_what_is_not_ported_raises(corpus):
    _, _, tvocab, _, tdata = corpus
    tr = port_trainer(tvocab)
    # the resident dataset and the epoch step take a data-parallel DataShard (ported); anything else raises
    with pytest.raises(TypeError, match="DataShard"):
        DeviceResidentDataset(tdata["train"], device="cpu", sharding=object())
    with pytest.raises(TypeError, match="DataShard"):
        make_epoch_scan_step(tr.model, tr.feat_cfg, tr.train_cfg.specaugment, 0, batch_sharding=object())
    model, cfgs = tr.model, (tr.vocab, tr.feat_cfg, tr.train_cfg)
    # sequence parallelism in one process: built, and every attention layer records its fallback
    from nn_conformer_for_speech_recognition_tpu_torch.parallel import sequence as S

    S.reset_fallback_stats()
    try:
        sp = type(tr)(model, *cfgs, mesh_cfg=TC.MeshConfig(seq_parallel=True), device="cpu")
        sp.init_state(seed=0)
        sp.generate_labels(tdata["validation"])
    finally:
        S.set_sequence_mesh(None)
    assert S.fallback_stats("seq_parallel")["reasons"] == {"axis 'data' has size 1 (need > 1)": 2}
    S.reset_fallback_stats()
    # a model axis of 2 asks for a process group of two processes; a mesh must be the port's layout
    with pytest.raises(ValueError, match="1 processes not divisible by model_parallel_size=2"):
        type(tr)(model, *cfgs, mesh_cfg=TC.MeshConfig(model_parallel_size=2), device="cpu")
    with pytest.raises(TypeError, match=r"parallel\.mesh\.Mesh"):
        type(tr)(model, *cfgs, mesh=object(), device="cpu")
    with pytest.raises(RuntimeError, match="init_state"):
        type(tr)(model, *cfgs, device="cpu").evaluate(tdata["validation"])
    with pytest.raises(ValueError, match="resume needs"):
        tr.resume(tdata["train"], 1)
    if not torch.cuda.is_available():  # the default device is the card, never a quiet CPU run
        with pytest.raises(RuntimeError, match="no CUDA device"):
            type(tr)(model, *cfgs)
