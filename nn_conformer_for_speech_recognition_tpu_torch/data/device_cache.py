"""Device-resident dataset, port of the JAX package's ``data/device_cache.py``
(``gather_rows``, ``DeviceResidentDataset``).

For a corpus that fits in device memory, the decoded audio and the targets
are uploaded once and every batch is gathered on the device
(``index_select``), so that a train step does no WAV decode, no batch
build and no host-to-device copy of audio.  ``DeviceResidentDataset``
duck-types `BucketedDataset`'s surface for `Trainer` (``epoch``,
``utterances``, ``vocab``, ``num_batches``, ``with_pseudo_labels``) and
adds ``device_arrays`` and ``order_matrix`` for the whole-epoch step
(`train.loop.Trainer.train_device_epochs`).  Its batches carry tensors on
the dataset's device, and ``indices`` as numpy.
"""

from __future__ import annotations

from typing import Dict, Iterator, List, Optional, Sequence

import numpy as np
import torch

from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import Batch, BucketedDataset, Utterance


def gather_rows(audio, alen, targets, tlen, idx):
    """One batch (rows ``idx``) of the resident tensors.  ``idx`` entries
    of -1 are batch padding: their audio, lengths and targets are zeroed,
    so the train step's ``target_lengths == 0`` row weight ignores them.
    Used per batch (`DeviceResidentDataset.epoch`) and by each step of the
    whole-epoch step (`train.loop.make_epoch_scan_step`)."""
    rows = torch.clamp_min(idx, 0)
    valid = idx >= 0
    a = audio.index_select(0, rows)
    return (
        a * valid[:, None].to(a.dtype),
        alen.index_select(0, rows) * valid,
        torch.where(valid[:, None], targets.index_select(0, rows), 0),
        tlen.index_select(0, rows) * valid,
    )


class DeviceResidentDataset:
    """All audio and targets of ``source`` resident on ``device`` (the
    first CUDA device unless the caller names another, under ``torchrun``
    the rank's card; ``device="cpu"`` for the CPU), padded to ``pad_to``
    samples (the source's largest bucket by default); batches gathered on
    the device.

    ``sharding`` (a `parallel.mesh.DataShard`, data parallelism): every
    rank holds the whole corpus, as the JAX class placed by a replicated
    sharding does, and its trainer gathers the rank's rows of each global
    batch from the one order matrix (`train.loop.make_epoch_scan_step`);
    the batch size must divide over the ranks."""

    def __init__(self, source: BucketedDataset, pad_to: Optional[int] = None, device=None, sharding=None):
        from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import DataShard
        from nn_conformer_for_speech_recognition_tpu_torch.train.loop import resolve_device

        if sharding is not None:
            if not isinstance(sharding, DataShard):
                raise TypeError(f"sharding must be a parallel.mesh.DataShard, got {type(sharding).__name__}")
            sharding.rows(source.batch_size)  # raises where the batch does not divide over the ranks

        self.device = resolve_device(device)
        self.vocab = source.vocab
        self.batch_size = source.batch_size
        self.sample_rate = source.sample_rate
        self.max_target_len = source.max_target_len
        self.utterances: List[Utterance] = list(source.utterances)
        self.bucket_boundaries = source.bucket_boundaries
        pad_to = pad_to or max(source.bucket_boundaries)

        n = len(source.utterances)
        audio = np.zeros((n, pad_to), np.float32)
        alen = np.zeros((n,), np.int32)
        targets = np.full((n, source.max_target_len), self.vocab.pad_id, np.int32)
        tlen = np.zeros((n,), np.int32)
        for i, u in enumerate(source.utterances):
            x = source._audio(i)[:pad_to]
            audio[i, : len(x)] = x
            alen[i] = len(x)
            if u.labeled:
                ids = self.vocab.parse(u.transcript)[: source.max_target_len]
                targets[i, : len(ids)] = ids
                tlen[i] = len(ids)
        self._audio_dev, self._alen_dev, self._targets_dev, self._tlen_dev = (
            torch.from_numpy(x).to(self.device) for x in (audio, alen, targets, tlen))

    def __len__(self) -> int:
        return len(self.utterances)

    def device_arrays(self):
        """(audio, alen, targets, tlen) resident on the device, for the
        whole-epoch step (`train.loop.Trainer.train_device_epochs`)."""
        return self._audio_dev, self._alen_dev, self._targets_dev, self._tlen_dev

    def order_matrix(self, seed: Optional[int] = None, shuffle: bool = True) -> np.ndarray:
        """(num_batches, batch_size) int32 index matrix for one epoch; -1
        marks batch-padding rows.  The same shuffle as `epoch` (numpy's
        ``default_rng``, as the JAX package's)."""
        n = len(self.utterances)
        order = np.arange(n)
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        mat = np.full((self.num_batches(), self.batch_size), -1, np.int32)
        mat.reshape(-1)[:n] = order
        return mat

    def num_batches(self) -> int:
        return -(-len(self.utterances) // self.batch_size)

    def set_targets(self, index_to_ids: Dict[int, Sequence[int]]) -> None:
        """Replaces the targets of the given rows (NST pseudo-labels) on the
        device: only those rows are uploaded."""
        if not index_to_ids:
            return
        rows = np.asarray(list(index_to_ids), np.int64)
        targets = np.full((len(rows), self.max_target_len), self.vocab.pad_id, np.int32)
        tlen = np.zeros((len(rows),), np.int32)
        for j, ids in enumerate(index_to_ids.values()):
            ids = list(ids)[: self.max_target_len]
            targets[j, : len(ids)] = ids
            tlen[j] = len(ids)
        rows_dev = torch.from_numpy(rows).to(self.device)
        self._targets_dev[rows_dev] = torch.from_numpy(targets).to(self.device)
        self._tlen_dev[rows_dev] = torch.from_numpy(tlen).to(self.device)

    def epoch(self, seed: Optional[int] = None, shuffle: bool = True) -> Iterator[Batch]:
        for idx in self.order_matrix(seed, shuffle):
            a, l, t, tl = gather_rows(*self.device_arrays(), torch.from_numpy(idx).to(self.device))
            yield Batch(a, l, t, tl, idx.astype(np.int64))

    def with_pseudo_labels(self, labels, unk_tol: float = 0.3, max_target_len: Optional[int] = None):
        return BucketedDataset.with_pseudo_labels(self, labels, unk_tol, max_target_len)
