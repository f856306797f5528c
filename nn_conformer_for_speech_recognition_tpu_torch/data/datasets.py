"""Manifest-based datasets with length-bucketed batching, copied from the
JAX package's ``data/datasets.py`` (numpy only; ``tests/test_torch_data.py``
holds ``BucketedDataset.epoch(seed)`` equal batch for batch, which resume
depends on).

  * a *manifest* is a TSV of ``wav_path\ttranscript`` lines (empty transcript
    for the unlabeled NST split);
  * batches carry **raw padded audio** + lengths + token targets; log-mel
    featurization runs on the device inside the train step
    (`ops/features.py`);
  * *length bucketing*: utterances are grouped into buckets and padded only
    to their bucket's boundary, so the padding waste is bounded by the
    bucket granularity;
  * NST dataset mixing is a manifest merge: supervised manifest +
    pseudo-labeled U manifest.

Manifest makers are provided for SpeechCommands directories
(label/*.wav with speaker-based splits) and LibriSpeech directories
(spk/chap/*.trans.txt).

Lengths are probed from the WAV headers and ``make_batch`` decodes its
cache misses in one batched call, both through the native decoder
(`data/native_loader`, over the repository's ``native/wavio.cpp``) where it
builds, else through ``wave`` and `data/audio.read_wav`, with the same
samples.
"""

from __future__ import annotations

import dataclasses
import os
import re
import wave
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from nn_conformer_for_speech_recognition_tpu_torch.data import native_loader
from nn_conformer_for_speech_recognition_tpu_torch.data.audio import read_wav


@dataclasses.dataclass
class Utterance:
    audio_path: str
    transcript: str  # "" for unlabeled

    @property
    def labeled(self) -> bool:
        return self.transcript != ""


def load_manifest(path: str) -> List[Utterance]:
    utts = []
    with open(path, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            parts = line.split("\t")
            utts.append(Utterance(parts[0], parts[1] if len(parts) > 1 else ""))
    return utts


def save_manifest(path: str, utts: Sequence[Utterance]) -> None:
    with open(path, "w", encoding="utf-8") as f:
        f.write("\n".join(f"{u.audio_path}\t{u.transcript}" for u in utts))


# ---------------------------------------------------------------------------
# Batching
# ---------------------------------------------------------------------------


@dataclasses.dataclass
class Batch:
    """One batch; every array has the batch's static shape.  A
    `BucketedDataset` batch holds host numpy arrays; a
    `device_cache.DeviceResidentDataset` batch holds tensors on that
    dataset's device, and ``indices`` as numpy."""

    audio: np.ndarray  # (B, S) float32, zero padded
    audio_lengths: np.ndarray  # (B,) int32; 0 for batch-padding rows
    targets: np.ndarray  # (B, L) int32, padded with pad_id
    target_lengths: np.ndarray  # (B,) int32
    # indices back into the dataset (for pseudo-label bookkeeping)
    indices: np.ndarray  # (B,) int64; -1 for batch-padding rows

    @property
    def size(self) -> int:
        return int((self.indices >= 0).sum())


class BucketedDataset:
    """In-memory audio dataset with length-bucketed static-shape batches.

    Audio is memoised after first read (SpeechCommands-scale corpora fit in
    host RAM; larger corpora should pass ``cache_audio=False``).
    """

    def __init__(
        self,
        utterances: Sequence[Utterance],
        vocab,
        batch_size: int,
        sample_rate: int = 16000,
        bucket_boundaries: Sequence[int] = (),
        max_samples: Optional[int] = None,
        max_target_len: int = 32,
        cache_audio: bool = True,
        drop_untolerable: bool = False,
        unk_tol: float = 0.3,
    ):
        self.vocab = vocab
        self.batch_size = batch_size
        self.sample_rate = sample_rate
        self.max_target_len = max_target_len
        self.cache_audio = cache_audio
        self._cache: Dict[int, np.ndarray] = {}

        self.utterances: List[Utterance] = []
        for u in utterances:
            if (
                drop_untolerable
                and u.labeled
                and hasattr(vocab, "is_tolerable")
                and not vocab.is_tolerable(u.transcript, unk_tol)
            ):
                continue  # unk-ratio filter
            self.utterances.append(u)

        self._lengths = self._probe_lengths()
        if max_samples is not None:
            keep = self._lengths <= max_samples
            self.utterances = [u for u, k in zip(self.utterances, keep) if k]
            self._lengths = self._lengths[keep]

        if not bucket_boundaries:
            hi = int(self._lengths.max()) if len(self._lengths) else sample_rate
            bucket_boundaries = [hi]
        self.bucket_boundaries = sorted(int(b) for b in bucket_boundaries)
        if len(self._lengths) and self.bucket_boundaries[-1] < self._lengths.max():
            self.bucket_boundaries.append(int(self._lengths.max()))
        self._bucket_of = np.searchsorted(
            np.asarray(self.bucket_boundaries), self._lengths
        )

    def _probe_lengths(self) -> np.ndarray:
        """Header-only length probe of every file, parallel over a thread
        pool (header reads are IO-bound and release the GIL), so init stays
        O(corpus/threads) wall-clock.  No decode, no whole-dataset cache."""
        from concurrent.futures import ThreadPoolExecutor

        n = len(self.utterances)
        if n == 0:
            return np.zeros((0,), np.int64)
        workers = min(16, max(1, n))
        with ThreadPoolExecutor(max_workers=workers) as pool:
            return np.fromiter(
                pool.map(self._audio_len, range(n), chunksize=256),
                np.int64, count=n,
            )

    def _audio_len(self, i: int) -> int:
        path = self.utterances[i].audio_path
        if native_loader.native_available():
            n, _sr = native_loader._load_native().probe(path)
            return int(n)
        with wave.open(path, "rb") as w:
            return w.getnframes()

    def _audio(self, i: int) -> np.ndarray:
        if i in self._cache:
            return self._cache[i]
        x, sr = read_wav(self.utterances[i].audio_path)
        if sr != self.sample_rate:
            raise ValueError(
                f"sample rate mismatch {sr} != {self.sample_rate}: "
                f"{self.utterances[i].audio_path}"
            )
        if self.cache_audio:
            self._cache[i] = x
        return x

    def __len__(self) -> int:
        return len(self.utterances)

    def num_batches(self) -> int:
        total = 0
        for b in range(len(self.bucket_boundaries)):
            n = int((self._bucket_of == b).sum())
            total += -(-n // self.batch_size) if n else 0
        return total

    def epoch(self, seed: Optional[int] = None, shuffle: bool = True) -> Iterator[Batch]:
        """Yield batches; within a bucket order is shuffled per epoch, and so
        is the order of the batches.  The stream is a function of ``seed``
        alone (numpy's ``default_rng``): a resumed run skips into it."""
        for b, idxs in self._epoch_plan(seed, shuffle):
            yield self.make_batch(idxs, self.bucket_boundaries[b])

    def _epoch_plan(self, seed: Optional[int], shuffle: bool) -> List[Tuple[int, np.ndarray]]:
        """The (bucket, utterance indices) of an epoch's batches, in order."""
        rng = np.random.default_rng(seed)
        order = []
        for b in range(len(self.bucket_boundaries)):
            idxs = np.nonzero(self._bucket_of == b)[0]
            if shuffle:
                rng.shuffle(idxs)
            for s in range(0, len(idxs), self.batch_size):
                order.append((b, idxs[s : s + self.batch_size]))
        if shuffle:
            rng.shuffle(order)
        return order

    def make_batch(self, idxs: np.ndarray, pad_to: int) -> Batch:
        bsz = self.batch_size
        audio = np.zeros((bsz, pad_to), np.float32)
        alen = np.zeros((bsz,), np.int32)
        targets = np.full((bsz, self.max_target_len), self.vocab.pad_id, np.int32)
        tlen = np.zeros((bsz,), np.int32)
        indices = np.full((bsz,), -1, np.int64)

        # batched native decode of the cache misses (multithreaded, GIL
        # released); the scratch is local, so that concurrent make_batch
        # calls (StreamingDataset's producer pool) are thread-safe
        scratch: Dict[int, np.ndarray] = {}
        misses = [int(i) for i in idxs if int(i) not in self._cache]
        if misses and native_loader.native_available():
            buf = np.zeros((len(misses), pad_to), np.float32)
            blen = np.zeros((len(misses),), np.int32)
            native_loader.decode_batch([self.utterances[i].audio_path for i in misses], buf, blen)
            if self.cache_audio:
                for j, i in enumerate(misses):
                    self._cache[i] = buf[j, : blen[j]].copy()
            else:
                scratch = {i: buf[j, : blen[j]] for j, i in enumerate(misses)}

        for row, i in enumerate(idxs):
            i = int(i)
            if i in self._cache:
                x = self._cache[i][:pad_to]
            elif i in scratch:
                x = scratch[i][:pad_to]
            else:
                x = self._audio(i)[:pad_to]
            audio[row, : len(x)] = x
            alen[row] = len(x)
            u = self.utterances[i]
            if u.labeled:
                ids = self.vocab.parse(u.transcript)[: self.max_target_len]
                targets[row, : len(ids)] = ids
                tlen[row] = len(ids)
            indices[row] = i
        return Batch(audio, alen, targets, tlen, indices)

    # ---- NST support ------------------------------------------------------

    def with_pseudo_labels(
        self,
        labels: Dict[int, str],
        unk_tol: float = 0.3,
        max_target_len: Optional[int] = None,
    ) -> List[Utterance]:
        """Attach decoded pseudo-label strings to (unlabeled) utterances,
        filtering empties, too-long targets and high-unk labels."""
        cap = max_target_len or self.max_target_len
        out = []
        for i, text in labels.items():
            text = text.strip()
            if not text:
                continue
            ids = self.vocab.parse(text)
            if len(ids) == 0 or len(ids) > cap:
                continue
            if ids.count(self.vocab.unk_id) / len(ids) > unk_tol:
                continue
            out.append(Utterance(self.utterances[i].audio_path, text))
        return out


def mix_datasets(
    supervised: Sequence[Utterance], pseudo_labeled: Sequence[Utterance]
) -> List[Utterance]:
    """The NST 'mix' split: supervised ∪ pseudo-labeled U, a manifest
    concat with no data copies."""
    return list(supervised) + list(pseudo_labeled)


def shard_utterances(
    utts: Sequence[Utterance], process_index: int, process_count: int
) -> List[Utterance]:
    """Static per-host file assignment for multi-host training."""
    return [u for i, u in enumerate(utts) if i % process_count == process_index]


def shard_utterances_with_indices(
    utts: Sequence[Utterance], process_index: int, process_count: int
):
    """Like `shard_utterances`, also returning the GLOBAL index of each local
    utterance — pass it as ``Trainer.generate_labels(..., index_map=...)`` so
    pseudo-labels gathered across hosts are keyed by globally-unique
    indices."""
    pairs = [
        (i, u) for i, u in enumerate(utts) if i % process_count == process_index
    ]
    return [u for _, u in pairs], np.asarray([i for i, _ in pairs], np.int64)


# ---------------------------------------------------------------------------
# Manifest makers for directory layouts
# ---------------------------------------------------------------------------


_SC_SPEAKER_RE = re.compile(r"([0-9a-f]{8})_nohash_")


def speechcommands_manifests(
    root: str,
    out_dir: str,
    unlabeled_fraction: float = 0.25,
    seed: int = 0,
) -> Dict[str, str]:
    """Build manifests from a SpeechCommands-layout directory
    (``root/<label>/<speaker>_nohash_<n>.wav``).

    Official validation/testing lists if present; the remaining train
    clips are split **by speaker** 75/25 into train / unlabeled-U.
    """
    os.makedirs(out_dir, exist_ok=True)

    def read_list(name):
        p = os.path.join(root, name)
        if os.path.exists(p):
            with open(p) as f:
                return set(l.strip() for l in f if l.strip())
        return set()

    val_set = read_list("validation_list.txt")
    test_set = read_list("testing_list.txt")

    all_utts: Dict[str, List[Tuple[str, str, str]]] = {
        "train": [], "validation": [], "test": []
    }
    for label in sorted(os.listdir(root)):
        d = os.path.join(root, label)
        if not os.path.isdir(d) or label.startswith("_"):
            continue
        for fn in sorted(os.listdir(d)):
            if not fn.endswith(".wav"):
                continue
            rel = f"{label}/{fn}"
            m = _SC_SPEAKER_RE.search(fn)
            spk = m.group(1) if m else fn
            split = (
                "validation" if rel in val_set else "test" if rel in test_set else "train"
            )
            all_utts[split].append((os.path.join(d, fn), label, spk))

    # speaker-based 75/25 train/U split
    rng = np.random.default_rng(seed)
    speakers = sorted({s for _, _, s in all_utts["train"]})
    rng.shuffle(speakers)
    n_unlab = int(len(speakers) * unlabeled_fraction)
    unlab_speakers = set(speakers[:n_unlab])

    manifests = {}
    splits: Dict[str, List[Utterance]] = {
        "train": [], "validation": [], "test": [], "unlabeled": []
    }
    for path, label, spk in all_utts["train"]:
        if spk in unlab_speakers:
            splits["unlabeled"].append(Utterance(path, ""))
        else:
            splits["train"].append(Utterance(path, label))
    for split in ("validation", "test"):
        splits[split] = [Utterance(p, l) for p, l, _ in all_utts[split]]

    for split, utts in splits.items():
        mpath = os.path.join(out_dir, f"{split}.tsv")
        save_manifest(mpath, utts)
        manifests[split] = mpath
    return manifests


def librispeech_manifests(root: str, out_dir: str, splits: Sequence[str]) -> Dict[str, str]:
    """Build manifests from LibriSpeech-layout directories
    (``root/<split>/<spk>/<chap>/<spk>-<chap>.trans.txt`` + audio files)."""
    os.makedirs(out_dir, exist_ok=True)
    manifests = {}
    for split in splits:
        utts = []
        sdir = os.path.join(root, split)
        for dirpath, _, files in os.walk(sdir):
            for fn in files:
                if fn.endswith(".trans.txt"):
                    with open(os.path.join(dirpath, fn)) as f:
                        for line in f:
                            line = line.strip()
                            if not line:
                                continue
                            utt_id, text = line.split(" ", 1)
                            for ext in (".wav", ".flac"):
                                ap = os.path.join(dirpath, utt_id + ext)
                                if os.path.exists(ap):
                                    utts.append(Utterance(ap, text.lower()))
                                    break
        mpath = os.path.join(out_dir, f"{split}.tsv")
        save_manifest(mpath, utts)
        manifests[split] = mpath
    return manifests


def spokendigits_manifests(out_dir: str, data_dir: Optional[str] = None) -> Dict[str, str]:
    """Build manifests from the TFDS ``spoken_digit`` dataset (8 kHz
    unlabeled clips, for pretraining).

    Requires ``tensorflow_datasets`` (an optional dependency, imported
    here); clips are exported to WAV so the manifest pipeline applies.
    """
    try:
        import tensorflow_datasets as tfds  # gated optional dependency
    except ImportError as e:
        raise ImportError(
            "spokendigits_manifests requires tensorflow_datasets; install it "
            "or use a synthetic/unlabeled manifest instead"
        ) from e
    import numpy as _np

    from nn_conformer_for_speech_recognition_tpu_torch.data.audio import write_wav

    os.makedirs(os.path.join(out_dir, "wavs"), exist_ok=True)
    ds = tfds.load("spoken_digit", split="train", data_dir=data_dir)
    utts = []
    for i, ex in enumerate(tfds.as_numpy(ds)):
        audio = ex["audio"].astype(_np.float32) / 32768.0
        path = os.path.join(out_dir, "wavs", f"sd_{i:06d}.wav")
        write_wav(path, audio, 8000)
        utts.append(Utterance(path, ""))  # unlabeled (pretraining split)
    mpath = os.path.join(out_dir, "unlabeled.tsv")
    save_manifest(mpath, utts)
    return {"unlabeled": mpath}
