"""LM corpus: lexicon, pronunciation streams, text cleaning; a copy of
`nn_conformer_for_speech_recognition_tpu/data/lm_corpus.py` (framework-free,
copied rather than imported: the JAX package's ``__init__`` imports jax).

  * ``Lexicon`` — word → phoneme-sequence map in the librispeech-lexicon.txt
    format, with greedy longest-match segmentation of out-of-lexicon words
    into in-lexicon chunks;
  * ``clean_book_text`` — book-corpus cleaning: drop roman-numeral and
    all-uppercase heading lines, normalise, truncate to ``max_len`` words;
  * ``LMCorpus`` — (pronunciation ids, word ids) example pairs batched with
    static shapes, shuffled by ``np.random.default_rng(seed)`` as the JAX
    package shuffles, so both give the same batches for one seed.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, List, Optional, Sequence, Tuple

import numpy as np

from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import (
    WordVocab,
    normalize_text,
)

_ROMAN_RE = re.compile(r"^[IVXLCDM]+\.?$")


class Lexicon:
    """word → phoneme sequence (ARPAbet-style), librispeech-lexicon format:
    ``WORD  PH1 PH2 ...`` per line."""

    def __init__(self, entries: Dict[str, List[str]]):
        self.entries = {w.lower(): p for w, p in entries.items()}
        self._max_chunk = max((len(w) for w in self.entries), default=1)

    @classmethod
    def load(cls, path: str) -> "Lexicon":
        entries: Dict[str, List[str]] = {}
        with open(path, encoding="utf-8") as f:
            for line in f:
                parts = line.split()
                if len(parts) >= 2:
                    entries.setdefault(parts[0], parts[1:])
        return cls(entries)

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            for w, p in self.entries.items():
                f.write(f"{w.upper()}  {' '.join(p)}\n")

    def segment_word(self, word: str) -> List[str]:
        """Greedy longest in-lexicon chunk segmentation of an OOV word
        (`lmvocab.py:85-138`); unsegmentable characters are dropped."""
        word = word.lower()
        if word in self.entries:
            return [word]
        out, i = [], 0
        while i < len(word):
            for j in range(min(len(word), i + self._max_chunk), i, -1):
                if word[i:j] in self.entries:
                    out.append(word[i:j])
                    i = j
                    break
            else:
                i += 1  # skip the unmatchable character
        return out

    def pronounce(self, word: str) -> List[str]:
        """Phoneme stream for a word, via segmentation for OOVs."""
        phones: List[str] = []
        for chunk in self.segment_word(word):
            phones.extend(self.entries[chunk])
        return phones

    def pronounce_sentence(self, sentence: str) -> List[str]:
        phones: List[str] = []
        for w in normalize_text(sentence).split():
            phones.extend(self.pronounce(w))
        return phones


def clean_book_text(
    lines: Sequence[str], max_len: int = 20
) -> List[str]:
    """Book-corpus cleaning (`librispeechlm.py:125-144`): drop empty, roman-
    numeral and all-uppercase heading lines; normalise; truncate to
    ``max_len`` words."""
    out = []
    for line in lines:
        line = line.strip()
        if not line:
            continue
        if _ROMAN_RE.match(line):
            continue
        if line.isupper() and len(line.split()) <= 8:
            continue
        norm = normalize_text(line)
        if not norm:
            continue
        words = norm.split()[:max_len]
        out.append(" ".join(words))
    return out


def build_phoneme_vocab(lexicon: Lexicon) -> WordVocab:
    """Vocabulary over the lexicon's phoneme inventory (the reference's
    pronunciation vocab, `lmvocab.py:43-62`)."""
    phones = sorted({p for plist in lexicon.entries.values() for p in plist})
    return WordVocab(["<blank>", "<pad>", "<unk>"] + phones)


class LMCorpus:
    """Pronunciation→word paired examples with static-shape batching."""

    def __init__(
        self,
        sentences: Sequence[str],
        lexicon: Lexicon,
        word_vocab: WordVocab,
        phoneme_vocab: Optional[WordVocab] = None,
        max_src_len: int = 64,
        max_tgt_len: int = 20,
    ):
        self.lexicon = lexicon
        self.word_vocab = word_vocab
        self.phoneme_vocab = phoneme_vocab or build_phoneme_vocab(lexicon)
        self.max_src_len = max_src_len
        self.max_tgt_len = max_tgt_len
        self.examples: List[Tuple[List[int], List[int]]] = []
        for s in sentences:
            phones = lexicon.pronounce_sentence(s)
            src = [self.phoneme_vocab.index.get(p, self.phoneme_vocab.unk_id)
                   for p in phones][:max_src_len]
            tgt = word_vocab.parse(normalize_text(s))[:max_tgt_len]
            if src and tgt:
                self.examples.append((src, tgt))

    def __len__(self) -> int:
        return len(self.examples)

    def batches(
        self, batch_size: int, seed: Optional[int] = None, shuffle: bool = True
    ) -> Iterator[Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]]:
        """Yields (src_ids (B,S), src_len (B,), tgt_ids (B,T), tgt_len (B,))."""
        order = np.arange(len(self.examples))
        if shuffle:
            np.random.default_rng(seed).shuffle(order)
        pv, wv = self.phoneme_vocab, self.word_vocab
        for s0 in range(0, len(order), batch_size):
            idxs = order[s0 : s0 + batch_size]
            src = np.full((batch_size, self.max_src_len), pv.pad_id, np.int32)
            slen = np.zeros((batch_size,), np.int32)
            tgt = np.full((batch_size, self.max_tgt_len), wv.pad_id, np.int32)
            tlen = np.zeros((batch_size,), np.int32)
            for row, i in enumerate(idxs):
                s_ids, t_ids = self.examples[int(i)]
                src[row, : len(s_ids)] = s_ids
                slen[row] = len(s_ids)
                tgt[row, : len(t_ids)] = t_ids
                tlen[row] = len(t_ids)
            yield src, slen, tgt, tlen
