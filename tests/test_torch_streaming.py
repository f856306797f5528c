"""The port's `StreamingDataset` against its `BucketedDataset` and against
the JAX package's `StreamingDataset`: the same batches in the same order at
one seed (arrays bit-equal), no audio kept in memory, worker errors raised
at the consumer, an abandoned epoch leaves no producer waiting."""

import threading

import numpy as np
import pytest

from nn_conformer_for_speech_recognition_tpu.data import datasets as JD
from nn_conformer_for_speech_recognition_tpu.data.audio import make_synthetic_corpus
from nn_conformer_for_speech_recognition_tpu.data.streaming import StreamingDataset as JaxStreaming
from nn_conformer_for_speech_recognition_tpu.data.vocab import build_vocab as jax_build_vocab
from nn_conformer_for_speech_recognition_tpu_torch.data import datasets as TD
from nn_conformer_for_speech_recognition_tpu_torch.data.streaming import StreamingDataset
from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab

KW = dict(batch_size=4, bucket_boundaries=[9000, 14000], max_target_len=4)


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    man = make_synthetic_corpus(str(tmp_path_factory.mktemp("stream")), ["yes", "no", "go", "stop"], n_train=22,
                                n_val=0, n_test=0, n_unlabeled=6, max_words_per_utt=2, seed=0)
    transcripts = [u.transcript for u in JD.load_manifest(man["train"])]
    return man, jax_build_vocab("word", transcripts), build_vocab("word", transcripts)


def _same(a, b):
    for field in ("audio", "audio_lengths", "targets", "target_lengths", "indices"):
        x, y = getattr(a, field), getattr(b, field)
        assert x.dtype == y.dtype and np.array_equal(x, y), field


@pytest.mark.parametrize("split", ["train", "unlabeled"])
@pytest.mark.parametrize("seed, shuffle", [(0, True), (7, True), (None, False)])
def test_epoch_equals_bucketed_and_jax_streaming(corpus, split, seed, shuffle):
    man, jvocab, tvocab = corpus
    got = list(StreamingDataset(TD.load_manifest(man[split]), tvocab, num_workers=3, queue_depth=2, **KW)
               .epoch(seed=seed, shuffle=shuffle))
    plain = list(TD.BucketedDataset(TD.load_manifest(man[split]), tvocab, **KW).epoch(seed=seed, shuffle=shuffle))
    ref = list(JaxStreaming(JD.load_manifest(man[split]), jvocab, num_workers=3, queue_depth=2, **KW)
               .epoch(seed=seed, shuffle=shuffle))
    assert len(got) == len(plain) == len(ref) > 1
    for a, b, c in zip(got, plain, ref):
        _same(a, b)
        _same(a, c)


def test_streaming_keeps_no_audio_and_counts_like_bucketed(corpus):
    man, _, tvocab = corpus
    ds = StreamingDataset(TD.load_manifest(man["train"]), tvocab, **KW)
    plain = TD.BucketedDataset(TD.load_manifest(man["train"]), tvocab, **KW)
    assert len(list(ds.epoch(seed=1))) == ds.num_batches() == plain.num_batches()
    assert ds.cache_audio is False and not ds._cache and len(ds) == len(plain)
    assert (ds.num_workers, ds.queue_depth) == (4, 4)
    assert list(StreamingDataset([], tvocab, **KW).epoch(seed=0)) == []


def test_worker_error_surfaces_and_abandoned_epoch_frees_its_threads(corpus):
    man, _, tvocab = corpus
    ds = StreamingDataset(TD.load_manifest(man["train"]), tvocab, num_workers=2, queue_depth=1, **KW)
    before = threading.active_count()
    stream = ds.epoch(seed=0)
    next(stream)
    stream.close()  # the consumer walks away after one batch
    for _ in range(200):
        if threading.active_count() <= before:
            break
        threading.Event().wait(0.01)
    assert threading.active_count() <= before

    def broken(idxs, pad_to):
        raise OSError("unreadable clip")

    ds.make_batch = broken
    with pytest.raises(OSError, match="unreadable clip"):
        list(ds.epoch(seed=0))
