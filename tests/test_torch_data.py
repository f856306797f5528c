"""The port's copies of the host-side data modules against the originals:
the synthetic corpus (same seed → the same WAV bytes and manifests), the
bucketed dataset's epoch stream batch for batch, the pseudo-label filter,
the WER functions, both vocabularies and the LM corpus (lexicon,
segmentation, book-text cleaning, phoneme vocabulary, ``LMCorpus.batches``
for a seed).  Everything here is exact: the copies are numpy and the
standard library on both sides.
"""

import filecmp
import os

import numpy as np
import pytest

from nn_conformer_for_speech_recognition_tpu.data import audio as JA
from nn_conformer_for_speech_recognition_tpu.data import datasets as JD
from nn_conformer_for_speech_recognition_tpu.data import lm_corpus as JLC
from nn_conformer_for_speech_recognition_tpu.data import vocab as JV
from nn_conformer_for_speech_recognition_tpu.train import metrics as JM
from nn_conformer_for_speech_recognition_tpu_torch.data import audio as TA
from nn_conformer_for_speech_recognition_tpu_torch.data import datasets as TD
from nn_conformer_for_speech_recognition_tpu_torch.data import lm_corpus as TLC
from nn_conformer_for_speech_recognition_tpu_torch.data import vocab as TV
from nn_conformer_for_speech_recognition_tpu_torch.data.native_loader import PrefetchIterator
from nn_conformer_for_speech_recognition_tpu_torch.train import metrics as TM

WORDS = ["yes", "no", "go", "stop", "left"]


@pytest.fixture(scope="module")
def corpora(tmp_path_factory):
    """The same corpus written by both packages: 21 train clips of 1-3
    words (a ragged last batch at batch size 4), 6 unlabelled."""
    roots = [str(tmp_path_factory.mktemp(name)) for name in ("jax", "port")]
    kw = dict(n_train=21, n_val=3, n_test=0, n_unlabeled=6, max_words_per_utt=3, seed=5)
    return roots, JA.make_synthetic_corpus(roots[0], WORDS, **kw), TA.make_synthetic_corpus(roots[1], WORDS, **kw)


def test_synthetic_corpus_copy_writes_the_same_bytes(corpora):
    (jroot, troot), jman, tman = corpora
    assert list(jman) == list(tman) == ["train", "validation", "unlabeled"]
    for split in jman:
        jlines = open(jman[split]).read().replace(jroot, "ROOT")
        assert jlines == open(tman[split]).read().replace(troot, "ROOT") and jlines
    wavs = sorted(os.listdir(os.path.join(jroot, "wavs")))
    assert wavs == sorted(os.listdir(os.path.join(troot, "wavs"))) and len(wavs) == 30
    match, mismatch, errors = filecmp.cmpfiles(os.path.join(jroot, "wavs"), os.path.join(troot, "wavs"), wavs, shallow=False)
    assert (len(match), mismatch, errors) == (30, [], [])
    x, sr = TA.read_wav(os.path.join(troot, "wavs", wavs[0]))
    ref, ref_sr = JA.read_wav(os.path.join(jroot, "wavs", wavs[0]))
    assert sr == ref_sr == 16000 and x.dtype == np.float32
    np.testing.assert_array_equal(x, ref)
    rng_a, rng_b = np.random.default_rng(3), np.random.default_rng(3)
    np.testing.assert_array_equal(TA.synth_utterance(["go", "no"], rng=rng_a), JA.synth_utterance(["go", "no"], rng=rng_b))


def test_write_and_read_wav_round_trip(tmp_path, rng):
    x = np.clip(rng.standard_normal(800) * 0.3, -1, 1).astype(np.float32)
    TA.write_wav(str(tmp_path / "a.wav"), x, 8000)
    JA.write_wav(str(tmp_path / "b.wav"), x, 8000)
    assert filecmp.cmp(tmp_path / "a.wav", tmp_path / "b.wav", shallow=False)
    y, sr = TA.read_wav(str(tmp_path / "a.wav"))
    assert sr == 8000 and np.abs(y - x).max() <= 2.0 / 32768  # written x·32767 truncated, read /32768


@pytest.mark.parametrize("seed, shuffle", [(0, True), (7, True), (None, False)])
def test_bucketed_dataset_epoch_matches_batch_for_batch(corpora, seed, shuffle):
    _, jman, tman = corpora
    jutts, tutts = JD.load_manifest(jman["train"]), TD.load_manifest(tman["train"])
    assert [u.transcript for u in jutts] == [u.transcript for u in tutts]
    vocab = JV.build_vocab("word", [u.transcript for u in jutts])
    kw = dict(batch_size=4, bucket_boundaries=[8000, 16000], max_target_len=3)
    jds, tds = JD.BucketedDataset(jutts, vocab, **kw), TD.BucketedDataset(tutts, TV.build_vocab("word", [u.transcript for u in tutts]), **kw)
    assert len(tds) == len(jds) == 21 and tds.num_batches() == jds.num_batches()
    assert tds.bucket_boundaries == jds.bucket_boundaries
    jbatches, tbatches = list(jds.epoch(seed=seed, shuffle=shuffle)), list(tds.epoch(seed=seed, shuffle=shuffle))
    assert len(jbatches) == len(tbatches) == jds.num_batches()
    for jb, tb in zip(jbatches, tbatches):
        for field in ("audio", "audio_lengths", "targets", "target_lengths", "indices"):
            got, ref = getattr(tb, field), getattr(jb, field)
            assert got.dtype == ref.dtype and got.shape == ref.shape, field
            np.testing.assert_array_equal(got, ref, err_msg=field)
        assert tb.size == jb.size
    assert any(b.size < 4 for b in tbatches)  # a ragged batch was compared


def test_manifest_round_trip_and_sharding(corpora, tmp_path):
    _, _, tman = corpora
    utts = TD.load_manifest(tman["unlabeled"])
    assert len(utts) == 6 and not any(u.labeled for u in utts)
    TD.save_manifest(str(tmp_path / "m.tsv"), utts)
    assert open(tmp_path / "m.tsv").read() == open(tman["unlabeled"]).read()
    jutts = [JD.Utterance(u.audio_path, u.transcript) for u in utts]
    assert [u.audio_path for u in TD.shard_utterances(utts, 1, 4)] == [u.audio_path for u in JD.shard_utterances(jutts, 1, 4)]
    (_, got_idx), (_, ref_idx) = TD.shard_utterances_with_indices(utts, 1, 4), JD.shard_utterances_with_indices(jutts, 1, 4)
    np.testing.assert_array_equal(got_idx, ref_idx)
    assert [u.audio_path for u in TD.mix_datasets(utts[:1], utts[4:])] == [utts[0].audio_path, utts[4].audio_path, utts[5].audio_path]


class _FakeVocab:
    pad_id, blank_id, unk_id = 1, 0, 2

    def parse(self, s):
        return [2 if w == "zzz" else 5 for w in s.split()]


@pytest.mark.parametrize("lib", [TD, JD], ids=["port", "jax"])
def test_pseudo_label_filtering(lib):
    """with_pseudo_labels drops empties, too-long and high-unk labels, in
    the port as in the JAX package."""
    ds = lib.BucketedDataset.__new__(lib.BucketedDataset)
    ds.utterances = [lib.Utterance(f"/x/{i}.wav", "") for i in range(6)]
    ds.vocab = _FakeVocab()
    ds.max_target_len = 3
    labels = {0: "go go", 1: "", 2: "a b c d e", 3: "zzz zzz go", 4: " stop ", 5: "zzz go go go"}
    kept = ds.with_pseudo_labels(labels, unk_tol=0.3)
    assert [(u.audio_path, u.transcript) for u in kept] == [("/x/0.wav", "go go"), ("/x/4.wav", "stop")]
    assert [u.transcript for u in ds.with_pseudo_labels(labels, unk_tol=0.3, max_target_len=4)] == ["go go", "stop", "zzz go go go"]


def test_drop_untolerable_uses_the_wordpiece_filter(corpora):
    _, _, tman = corpora
    utts = TD.load_manifest(tman["train"])[:4]
    utts[1] = TD.Utterance(utts[1].audio_path, "qqq www")
    vocab = TV.build_vocab("wordpiece", [u.transcript for u in utts if "q" not in u.transcript] * 3, 32)
    kept = TD.BucketedDataset(utts, vocab, batch_size=2, drop_untolerable=True)
    assert len(kept) == 3 and all("q" not in u.transcript for u in kept.utterances)


def test_metrics_copy_equal(rng):
    words = ["a", "b", "c", "d", ""]
    def sentence():
        return " ".join(w for w in rng.choice(words, size=rng.integers(0, 7)) if w)
    refs, hyps = [sentence() for _ in range(40)], [sentence() for _ in range(40)]
    for name in ("wer", "cer", "padded_wer"):
        assert getattr(TM, name)(refs, hyps) == getattr(JM, name)(refs, hyps), name
    assert TM.edit_distance("kitten", "sitting") == JM.edit_distance("kitten", "sitting") == 3
    assert TM.wer(["a b"], ["a b"]) == 0.0 and TM.wer([""], ["a"]) == 1.0
    ours, ref = TM.Mean(), JM.Mean()
    for v, n in ((1.5, 2), (0.25, 5)):
        ours.update(v, n), ref.update(v, n)
    assert ours.result() == ref.result() and TM.Mean().result() == 0.0
    assert TM.perplexity(2.0) == JM.perplexity(2.0)


def test_wordpiece_vocab_copy_equal(tmp_path, rng):
    lines = ["The cat sat on the mat.", "the dog ran far away", "a cat ran, a dog sat", "the end of the road"] * 2
    pieces, ref_pieces = TV.learn_wordpieces(lines, 40), JV.learn_wordpieces(lines, 40)
    assert pieces == ref_pieces
    ours, ref = TV.build_vocab("wordpiece", lines, 48), JV.build_vocab("wordpiece", lines, 48)
    assert ours.tokens == ref.tokens and (ours.pad_id, ours.blank_id, ours.unk_id) == (ref.pad_id, ref.blank_id, ref.unk_id)
    for text in ("the cat ran", "a zebra sat!", "", "THE DOG"):
        assert ours.parse(text) == ref.parse(text)
        assert ours.is_tolerable(text, 0.3) == ref.is_tolerable(text, 0.3)
        assert TV.normalize_text(text) == JV.normalize_text(text)
    ids = rng.integers(0, len(ref), size=(4, 15))
    assert ours.decode(ids) == ref.decode(ids)
    ours.save(str(tmp_path / "wp.txt"))
    assert type(TV.load_any_vocab(str(tmp_path / "wp.txt"))) is TV.WordPieceVocab
    assert TV.load_any_vocab(str(tmp_path / "wp.txt")).tokens == JV.load_any_vocab(str(tmp_path / "wp.txt")).tokens
    words = TV.build_vocab("word", lines, 5)
    words.save(str(tmp_path / "w.txt"))
    assert type(TV.load_any_vocab(str(tmp_path / "w.txt"))) is TV.WordVocab
    assert TV.WordVocab.load(str(tmp_path / "w.txt"), 2).tokens == JV.WordVocab.load(str(tmp_path / "w.txt"), 2).tokens
    with pytest.raises(ValueError):
        TV.build_vocab("bpe", lines)
    with pytest.raises(ValueError):
        TV.WordPieceVocab(["<blank>", "<pad>", "<unk>"])


def test_prefetch_iterator_keeps_order_and_surfaces_errors():
    assert list(PrefetchIterator(iter(range(20)), depth=2)) == list(range(20))

    def broken():
        yield 1
        raise KeyError("lost")

    it = PrefetchIterator(broken())
    assert next(it) == 1
    with pytest.raises(KeyError):
        next(it)


# the JAX tests' lexicon (tests/test_lm_corpus.py)
LEXICON = {"go": ["G", "OW"], "stop": ["S", "T", "AA", "P"], "up": ["AH", "P"], "down": ["D", "AW", "N"], "a": ["AH"]}


@pytest.mark.parametrize("word", ["go", "STOP", "goup", "xgo", "downup", "qqq", ""])
def test_lexicon_copy_equal(tmp_path, word):
    ours, ref = TLC.Lexicon(LEXICON), JLC.Lexicon(LEXICON)
    assert ours.segment_word(word) == ref.segment_word(word)
    assert ours.pronounce(word) == ref.pronounce(word)
    sentence = f"Go, {word} stop!  a"
    assert ours.pronounce_sentence(sentence) == ref.pronounce_sentence(sentence)
    ours.save(str(tmp_path / "ours.txt"))
    ref.save(str(tmp_path / "ref.txt"))
    assert filecmp.cmp(tmp_path / "ours.txt", tmp_path / "ref.txt", shallow=False)
    assert TLC.Lexicon.load(str(tmp_path / "ref.txt")).entries == JLC.Lexicon.load(str(tmp_path / "ours.txt")).entries


def test_clean_book_text_and_phoneme_vocab_copy_equal():
    lines = ["CHAPTER ONE", "XIV.", "", "Hello, World! This is a sentence.", " ".join(["word"] * 40),
             "THE END OF A VERY LONG HEADING THAT GOES ON AND ON", "  mixed Case line; with 'quotes'  "]
    for max_len in (20, 3):
        assert TLC.clean_book_text(lines, max_len) == JLC.clean_book_text(lines, max_len)
    ours, ref = TLC.build_phoneme_vocab(TLC.Lexicon(LEXICON)), JLC.build_phoneme_vocab(JLC.Lexicon(LEXICON))
    assert ours.tokens == ref.tokens and ours.index == ref.index


@pytest.mark.parametrize("seed, shuffle", [(0, True), (3, True), (None, False)])
def test_lm_corpus_batches_copy_equal(rng, seed, shuffle):
    """The same (src, src_len, tgt, tgt_len) batches, the last one padded
    with empty rows, for one seed (``np.random.default_rng(seed)`` on both
    sides)."""
    words = ["go", "stop", "up", "down", "a", "goup", "zz"]
    sentences = [" ".join(rng.choice(words, size=rng.integers(1, 8))) for _ in range(19)] + ["zz", ""]
    vocab_words = ["<blank>", "<pad>", "<unk>", "go", "stop", "up", "down", "a"]
    ours = TLC.LMCorpus(sentences, TLC.Lexicon(LEXICON), TV.WordVocab(vocab_words), max_src_len=9, max_tgt_len=5)
    ref = JLC.LMCorpus(sentences, JLC.Lexicon(LEXICON), JV.WordVocab(vocab_words), max_src_len=9, max_tgt_len=5)
    assert len(ours) == len(ref) == 19 and ours.examples == ref.examples
    got, want = list(ours.batches(4, seed=seed, shuffle=shuffle)), list(ref.batches(4, seed=seed, shuffle=shuffle))
    assert len(got) == len(want) == 5 and int(got[-1][1][-1]) == 0
    for a, b in zip(got, want):
        for x, y in zip(a, b):
            assert x.dtype == y.dtype
            np.testing.assert_array_equal(x, y)
