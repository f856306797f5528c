"""Training over a device-resident dataset: the port's whole-epoch route
(`Trainer.train_device_epochs`, `make_epoch_scan_step`) against its own
per-step route (`Trainer.train` over the same dataset) and against the JAX
package's `train_device_epochs`.

The two routes of the port run the same operations in the same order, so
they are held bit for bit (`torch.equal` on every loss, parameter, batch
statistic, optimizer slot and the generator), with SpecAugment and dropout
on, as the JAX package holds its own two routes (``tests/test_train.py``).
Against the JAX package both start from the same converted weights,
float32, dropout 0, SpecAugment off (their draws cannot match), as
``tests/test_torch_trainer.py`` runs: the epochs' mean train loss and the
validation loss rtol 1e-4, validation WER equal.  Everything runs on the
CPU (``device="cpu"``), where the kernels' plain twins stand in.
"""

import numpy as np
import pytest

from _torch_trainer_helpers import (
    assert_same_state,
    jax_trainer,
    make_corpus,
    perturbed_variables,
    port_trainer,
)

from nn_conformer_for_speech_recognition_tpu.data import device_cache as JDC
from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


def _resident(tdata, split="train", n=None):
    dev = DeviceResidentDataset(tdata[split], device="cpu")
    if n is not None:  # a ragged final batch (corpus % batch_size != 0)
        dev.utterances = dev.utterances[:n]
    return dev


def _noisy(vocab, **kw):
    """A trainer with dropout and SpecAugment on."""
    return port_trainer(vocab, dropout=0.1, use_specaugment=True, **kw)


def _spy_chunks(trainer):
    """Records the rows of each call of the trainer's epoch step."""
    calls = []
    key = (bool(trainer.train_cfg.use_specaugment), 0.0)
    fn = trainer._epoch_scan_fn()
    trainer._epoch_scans[key] = lambda state, *args: calls.append(args[-1].shape[0]) or fn(state, *args)
    return calls


@pytest.mark.parametrize("n", [None, 13], ids=["full", "ragged"])
def test_fused_epochs_equal_per_step(corpus, n):
    """`train_device_epochs` (one call of the epoch step an epoch) and
    `train` over the same resident dataset (one call an order row) give
    bit-equal epoch losses and state over two epochs; with 13 clips at
    batch 8 the final batch's padding rows are weighted out alike."""
    _, _, tvocab, _, tdata = corpus
    dev = _resident(tdata, n=n)
    per_step, fused = _noisy(tvocab), _noisy(tvocab)
    per_calls, fused_calls = _spy_chunks(per_step), _spy_chunks(fused)
    per_step.train(dev, epochs=2)
    fused.train_device_epochs(dev, epochs=2)
    steps = dev.num_batches()
    assert per_calls == [1] * 2 * steps and fused_calls == [steps, steps]
    assert fused.history["train_loss"] == per_step.history["train_loss"]
    assert all(np.isfinite(fused.history["train_loss"]))
    assert fused.state.step == per_step.state.step == 2 * steps
    assert_same_state(fused, per_step)


def test_matches_jax_train_device_epochs(corpus):
    """Two fused epochs with per-epoch validation, the port against the JAX
    package from the same weights."""
    _, jvocab, tvocab, jdata, tdata = corpus
    variables = perturbed_variables(jax_trainer(jvocab), np.random.default_rng(0))
    jt, tt = jax_trainer(jvocab, variables), port_trainer(tvocab, variables)
    jt.train_device_epochs(JDC.DeviceResidentDataset(jdata["train"]), epochs=2, val_dataset=jdata["validation"])
    tt.train_device_epochs(_resident(tdata), epochs=2, val_dataset=tdata["validation"])
    assert int(jt.state.step) == tt.state.step == 8
    for key in ("train_loss", "val_loss"):
        assert len(tt.history[key]) == 2
        np.testing.assert_allclose(tt.history[key], jt.history[key], rtol=1e-4, err_msg=key)
    assert tt.history["val_wer"] == jt.history["val_wer"]


def test_fused_validation_and_checkpoint(corpus, tmp_path):
    """Per-epoch validation and the epoch-end checkpoint on the fused
    route: the history's validation entries are `evaluate`'s, and the
    newest checkpoint restores the trained state."""
    _, _, tvocab, _, tdata = corpus
    tr = _noisy(tvocab)
    manager = CheckpointManager(str(tmp_path / "ckpt"), keep=2)
    tr.train_device_epochs(_resident(tdata), epochs=2, val_dataset=tdata["validation"], checkpoint_manager=manager)
    assert [len(tr.history[k]) for k in ("train_loss", "val_loss", "val_wer")] == [2, 2, 2]
    assert (tr.history["val_loss"][-1], tr.history["val_wer"][-1]) == tr.evaluate(tdata["validation"])
    restored, cursor = manager.restore_latest_with_iterator(_noisy(tvocab).state)
    assert cursor == {"epoch": 2, "step": 0}
    fresh = _noisy(tvocab)
    fresh.state = restored
    assert_same_state(fresh, tr)


class KilledAfterSave:
    """Checkpoint manager proxy that raises once it has written the
    checkpoint of ``cursor``: a process killed right after a mid-epoch
    checkpoint."""

    def __init__(self, manager, cursor):
        self._manager, self._cursor = manager, cursor

    def save(self, state, metric=None, iterator=None):
        path = self._manager.save(state, metric=metric, iterator=iterator)
        if iterator == self._cursor:
            raise KeyboardInterrupt("killed after a mid-epoch checkpoint")
        return path

    def __getattr__(self, name):
        return getattr(self._manager, name)


def test_checkpoint_chunks_then_resume(corpus, tmp_path):
    """With ``checkpoint_every_steps=2`` the fused epochs run in chunks of
    two steps and write a cursor after each, bit-equal to the unchunked
    run; a run killed after the cursor (epoch 1, step 2) and resumed from
    it (the ``start_step`` cursor, one row a call) ends bit-equal too."""
    _, _, tvocab, _, tdata = corpus
    dev = _resident(tdata)
    whole = _noisy(tvocab)
    whole.train_device_epochs(dev, epochs=2)

    chunked = _noisy(tvocab, checkpoint_every_steps=2)
    calls = _spy_chunks(chunked)
    saved = []
    manager = CheckpointManager(str(tmp_path / "chunked"), keep=10)
    save = manager.save
    manager.save = lambda state, metric=None, iterator=None: saved.append(iterator) or save(state, metric, iterator)
    chunked.train_device_epochs(dev, epochs=2, checkpoint_manager=manager)
    assert calls == [2, 2, 2, 2]
    # a cursor after each chunk, then the epoch's end
    assert saved == [{"epoch": 0, "step": 2}, {"epoch": 0, "step": 4}, {"epoch": 1, "step": 0},
                     {"epoch": 1, "step": 2}, {"epoch": 1, "step": 4}, {"epoch": 2, "step": 0}]
    assert chunked.history["train_loss"] == whole.history["train_loss"]
    assert_same_state(chunked, whole)

    manager = CheckpointManager(str(tmp_path / "killed"), keep=3)
    killed = _noisy(tvocab, checkpoint_every_steps=2)
    with pytest.raises(KeyboardInterrupt):
        killed.train_device_epochs(dev, epochs=2, checkpoint_manager=KilledAfterSave(manager, {"epoch": 1, "step": 2}))
    # the cursor given to the fused route directly
    direct = _noisy(tvocab)
    state, cursor = manager.restore_latest_with_iterator(direct.state)
    assert cursor == {"epoch": 1, "step": 2}
    direct.state = state
    direct.train_device_epochs(dev, epochs=1, epoch_offset=1, start_step=2)
    assert_same_state(direct, whole)

    resumed = _noisy(tvocab, checkpoint_every_steps=2)
    calls = _spy_chunks(resumed)
    resumed.resume(dev, epochs=2, checkpoint_manager=manager)
    assert calls == [1, 1]  # the two rows after the cursor, through `train`'s route
    assert resumed.state.step == whole.state.step == 8
    assert_same_state(resumed, whole)


def test_train_wer_fused_equals_per_step(corpus):
    """``TrainConfig.train_wer``: the epoch step emits each step's greedy
    ids, and the WER scored from them is the per-step route's."""
    _, _, tvocab, _, tdata = corpus
    dev = _resident(tdata, n=13)
    per_step, fused = _noisy(tvocab, train_wer=True), _noisy(tvocab, train_wer=True)
    per_step.train(dev, epochs=2)
    fused.train_device_epochs(dev, epochs=2)
    assert len(fused.history["train_wer"]) == 2 and all(np.isfinite(fused.history["train_wer"]))
    assert fused.history["train_wer"] == per_step.history["train_wer"]
    assert fused.history["train_loss"] == per_step.history["train_loss"]


def test_evaluate_and_labels_over_resident_data(corpus):
    """`evaluate` and `generate_labels` over a resident split (batches of
    tensors already on the trainer's device, passed through as they are)
    equal them over the host dataset."""
    _, jvocab, tvocab, _, tdata = corpus
    tr = port_trainer(tvocab, perturbed_variables(jax_trainer(jvocab), np.random.default_rng(0)))
    got, ref = tr.evaluate(_resident(tdata, "validation"), return_texts=True), tr.evaluate(tdata["validation"],
                                                                                            return_texts=True)
    assert got[1:] == ref[1:] and any(got[3])
    np.testing.assert_allclose(got[0], ref[0], rtol=1e-6)
    labels = tr.generate_labels(_resident(tdata, "unlabeled"))
    assert labels == tr.generate_labels(tdata["unlabeled"]) and any(labels.values())
    batch = next(_resident(tdata, "validation").epoch(shuffle=False))
    assert all(x is y for x, y in zip(tr._put(batch), (batch.audio, batch.audio_lengths, batch.targets,
                                                        batch.target_lengths)))
