"""The traffic generator draws everything from the seed: the same seed gives
the same corpus, and every seed the same set of lengths."""

import numpy as np
import torch

from benchmark import harness as H
from benchmark import traffic as T


def _corpus(name, seed):
    cell = H.load_cell(name)
    traffic = dict(cell["traffic"], clips=16, seconds=[1.0, 2.0])
    return T.make_corpus(traffic, cell["cfg"], seed, torch.device("cpu"))


def test_same_seed_same_corpus():
    a, b = _corpus("conformer_m.train", 2 ** 31 + 11), _corpus("conformer_m.train", 2 ** 31 + 11)
    assert np.array_equal(a.pcm, b.pcm) and np.array_equal(a.lengths, b.lengths) and a.ids == b.ids


def test_seeds_share_the_lengths_in_another_order():
    a, b = _corpus("conformer_m.train", 1), _corpus("conformer_m.train", 2)
    assert sorted(a.lengths) == sorted(b.lengths) and not np.array_equal(a.lengths, b.lengths)
    assert not np.array_equal(a.pcm, b.pcm)
    # the words a clip holds follow its length: the same count of targets on every seed
    assert sorted(map(len, a.ids)) == sorted(map(len, b.ids))


def test_audio_is_zero_past_each_length_and_words_fit():
    c = _corpus("conformer_m.train", 7)
    for row, n in zip(c.pcm, c.lengths):
        assert not row[n:].any() and row[:n].any()
    assert max(map(len, c.ids)) <= c.max_target_len
    assert all(3 <= i < len(c.words) for ids in c.ids for i in ids)


def test_unlabelled_mix_has_no_transcripts():
    c = _corpus("conformer_m.label", 7)
    assert c.ids is None and c.transcript(0) == ""
