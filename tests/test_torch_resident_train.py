"""Training over a device-resident dataset: `Trainer.train`'s resident
source (the order matrix's rows gathered on the device; also reached as
`Trainer.train_device_epochs`) against its host source over the same
batches, `make_epoch_scan_step` against the trainer's epoch, and the port
against the JAX package's `train_device_epochs`.

The two sources feed the one epoch loop the same padded batches (the host
dataset's ``make_batch`` over each row of the resident order), so they are
held bit for bit (`torch.equal` on every loss, parameter, batch statistic,
optimizer slot and the generator), with SpecAugment and dropout on.
Against the JAX package both start from the same converted weights,
float32, dropout 0, SpecAugment off (their draws cannot match), as
``tests/test_torch_trainer.py`` runs: the epochs' mean train loss and the
validation loss rtol 1e-4, validation WER equal.  Everything runs on the
CPU (``device="cpu"``), where the kernels' plain twins stand in.
"""

import numpy as np
import pytest
import torch

from _torch_trainer_helpers import (
    assert_same_state,
    jax_trainer,
    make_corpus,
    perturbed_variables,
    port_trainer,
)

from nn_conformer_for_speech_recognition_tpu.data import device_cache as JDC
from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
from nn_conformer_for_speech_recognition_tpu_torch.train import metrics as M
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_epoch_scan_step


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


class InResidentOrder:
    """The host dataset read in the resident dataset's order: each row of
    the resident ``order_matrix(seed)`` built by the host's ``make_batch``
    at its one bucket.  Within an epoch the host's own ``epoch(seed)``
    holds the same rows a batch, in another order of batches."""

    def __init__(self, host, dev):
        self._host, self._dev = host, dev

    def epoch(self, seed=None, shuffle=True):
        for row in self._dev.order_matrix(seed, shuffle):
            yield self._host.make_batch(row[row >= 0], max(self._host.bucket_boundaries))

    def num_batches(self):
        return self._dev.num_batches()

    def __getattr__(self, name):
        return getattr(self._host, name)


@pytest.fixture(scope="module")
def two_epochs(corpus):
    """{n: (host, resident dataset, trainer over host, trainer over
    resident)} after two epochs of `train` over each source: the whole
    corpus (n None), and its first 13 clips (a ragged final batch) with
    ``train_wer`` on.  The tests only read the trainers."""
    _, _, tvocab, _, tdata = corpus
    out = {}
    for n in (None, 13):
        dev = _resident(tdata, n=n)
        host = InResidentOrder(tdata["train"], dev)
        on_host, resident = _noisy(tvocab, train_wer=n is not None), _noisy(tvocab, train_wer=n is not None)
        on_host.train(host, epochs=2)
        resident.train(dev, epochs=2)
        out[n] = host, dev, on_host, resident
    return out


@pytest.mark.parametrize("n", [None, 13], ids=["full", "ragged"])
def test_resident_epochs_equal_host_epochs(corpus, two_epochs, n):
    """`train` over the resident dataset and over the host dataset's same
    batches give bit-equal epoch losses and state over two epochs; with 13
    clips at batch 8 the final batch's padding rows are weighted out
    alike."""
    tdata = corpus[4]
    host, dev, on_host, resident = two_epochs[n]
    if n is None:  # the same batches as the host dataset's own epoch, in another order
        for seed in (0, 1):
            plan = sorted(tuple(sorted(idxs)) for _, idxs in tdata["train"]._epoch_plan(seed, True))
            assert plan == sorted(tuple(sorted(row)) for row in dev.order_matrix(seed))
    steps = dev.num_batches()
    assert resident.history == on_host.history
    assert all(np.isfinite(resident.history["train_loss"]))
    assert resident.state.step == on_host.state.step == 2 * steps
    assert_same_state(resident, on_host)
    with pytest.raises(TypeError, match="device-resident"):
        on_host.train_device_epochs(host, epochs=1)


def test_epoch_scan_step_equals_train_epoch(corpus):
    """`make_epoch_scan_step` over an epoch's order, on the trainer's model
    and state, gives `train`'s losses (their weighted mean its history), the
    valid rows of each order row and the same state."""
    _, _, tvocab, _, tdata = corpus
    dev = _resident(tdata, n=13)
    trained, scanned = _noisy(tvocab), _noisy(tvocab)
    trained.train(dev, epochs=1)
    cfg, vocab = scanned.train_cfg, scanned.vocab
    epoch = make_epoch_scan_step(scanned.model, scanned.feat_cfg, cfg.specaugment, vocab.blank_id,
                                 use_specaugment=True, ctc_impl=cfg.ctc_impl, pad_id=vocab.pad_id)
    order = dev.order_matrix(seed=cfg.seed)
    scanned.state, (losses, sizes) = epoch(scanned.state, *dev.device_arrays(), torch.from_numpy(order))
    assert sizes.tolist() == (order >= 0).sum(axis=1).tolist() == [8, 5]
    mean = M.Mean()
    for loss, size in zip(losses.numpy(), sizes.tolist()):
        mean.update(float(loss), size)
    assert [mean.result()] == trained.history["train_loss"]
    assert_same_state(scanned, trained)


def test_matches_jax_train_device_epochs(corpus):
    """Two resident epochs with per-epoch validation, the port against the
    JAX package from the same weights."""
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
    """Per-epoch validation and the epoch-end checkpoint over resident
    data: the history's validation entries are `evaluate`'s, and the
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


def test_checkpoint_chunks_then_resume(corpus, two_epochs, tmp_path):
    """With ``checkpoint_every_steps=2`` the resident epochs write a cursor
    every two steps and end bit-equal to a run without checkpoints; a run
    killed after the cursor (epoch 1, step 2) and resumed from it (the
    ``start_step`` cursor) ends bit-equal too."""
    _, _, tvocab, _, tdata = corpus
    dev = _resident(tdata)
    whole = two_epochs[None][3]  # two epochs of `train` over the resident corpus, no checkpoints

    chunked = _noisy(tvocab, checkpoint_every_steps=2)
    saved = []
    manager = CheckpointManager(str(tmp_path / "chunked"), keep=10)
    save = manager.save
    manager.save = lambda state, metric=None, iterator=None: saved.append(iterator) or save(state, metric, iterator)
    chunked.train_device_epochs(dev, epochs=2, checkpoint_manager=manager)
    # a cursor every two steps, then the epoch's end
    assert saved == [{"epoch": 0, "step": 2}, {"epoch": 0, "step": 4}, {"epoch": 1, "step": 0},
                     {"epoch": 1, "step": 2}, {"epoch": 1, "step": 4}, {"epoch": 2, "step": 0}]
    assert chunked.history["train_loss"] == whole.history["train_loss"]
    assert_same_state(chunked, whole)

    manager = CheckpointManager(str(tmp_path / "killed"), keep=3)
    killed = _noisy(tvocab, checkpoint_every_steps=2)
    with pytest.raises(KeyboardInterrupt):
        killed.train_device_epochs(dev, epochs=2, checkpoint_manager=KilledAfterSave(manager, {"epoch": 1, "step": 2}))
    # the cursor given to the resident route directly
    direct = _noisy(tvocab)
    state, cursor = manager.restore_latest_with_iterator(direct.state)
    assert cursor == {"epoch": 1, "step": 2}
    direct.state = state
    direct.train_device_epochs(dev, epochs=1, epoch_offset=1, start_step=2)
    assert_same_state(direct, whole)

    resumed = _noisy(tvocab, checkpoint_every_steps=2)
    resumed.resume(dev, epochs=2, checkpoint_manager=manager)
    assert resumed.state.step == whole.state.step == 8
    assert_same_state(resumed, whole)


def test_train_wer_resident_equals_host(two_epochs):
    """``TrainConfig.train_wer``: each step emits its greedy ids, and the
    WER scored from them over the resident source is the host source's
    over the same batches."""
    _, _, on_host, resident = two_epochs[13]
    assert len(resident.history["train_wer"]) == 2 and all(np.isfinite(resident.history["train_wer"]))
    assert resident.history == on_host.history


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
