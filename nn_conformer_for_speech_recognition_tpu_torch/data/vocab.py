"""Tokenizers: word-level vocab and word-piece model, copied from the JAX
package's ``data/vocab.py`` (``tests/test_torch_slice.py`` and
``tests/test_torch_data.py`` hold both equal to the originals).

* ``WordVocab``: frequency-sorted word vocabulary truncated to ``ntokens``,
  specials ``<blank>, <pad>, <unk>`` at indices 0/1/2, whitespace ``parse``,
  and ``decode`` that drops pad/blank and joins with spaces, with **no** CTC
  repeat-collapse, because units are whole words.

* ``WordPieceVocab``: sub-word pieces with a sentencepiece-style ``▁``
  word-start marker, specials ``<pad>, <blank>, <unk>`` at the head, greedy
  longest-match segmentation, whole-word→``<unk>`` fallback, an unk-ratio
  sentence filter (``is_tolerable``), and CTC-style decode: collapse
  consecutive repeats when blank is present, strip blanks, re-space.

``learn_wordpieces`` builds the piece inventory with a BPE-style merge
learner over the training corpus; nothing is downloaded.
"""

from __future__ import annotations

import collections
import re
from typing import Dict, Iterable, List, Optional, Sequence

BLANK_TOKEN = "<blank>"
PAD_TOKEN = "<pad>"
UNK_TOKEN = "<unk>"
SPACE_MARKER = "▁"  # '▁' sentencepiece word-start marker

_NORM_RE = re.compile(r"[^a-z' ]+")


def normalize_text(s: str) -> str:
    """Text normalisation: lowercase, strip punctuation, squeeze spaces."""
    s = s.lower().strip()
    s = _NORM_RE.sub(" ", s)
    return " ".join(s.split())


class WordVocab:
    """Word-level vocabulary with ``<blank>/<pad>/<unk>`` at 0/1/2."""

    def __init__(self, tokens: Sequence[str]):
        self.tokens: List[str] = list(tokens)
        if self.tokens[:3] != [BLANK_TOKEN, PAD_TOKEN, UNK_TOKEN]:
            raise ValueError("WordVocab specials must be <blank>,<pad>,<unk> at 0/1/2")
        self.index: Dict[str, int] = {t: i for i, t in enumerate(self.tokens)}

    blank_id = 0
    pad_id = 1
    unk_id = 2

    @classmethod
    def build(
        cls, transcripts: Iterable[str], ntokens: Optional[int] = None
    ) -> "WordVocab":
        """Frequency-sorted build, truncated to ``ntokens`` real tokens."""
        counter = collections.Counter()
        for line in transcripts:
            counter.update(line.strip().split())
        ordered = [w for w, _ in counter.most_common(ntokens)]
        return cls([BLANK_TOKEN, PAD_TOKEN, UNK_TOKEN] + ordered)

    def __len__(self) -> int:
        return len(self.tokens)

    def parse(self, sentence: str) -> List[int]:
        return [self.index.get(w, self.unk_id) for w in sentence.strip().split()]

    def decode_ids(self, ids: Sequence[int]) -> str:
        """Drop pad/blank, join — no repeat collapse."""
        words = [
            self.tokens[i]
            for i in ids
            if 0 <= i < len(self.tokens) and i not in (self.pad_id, self.blank_id)
        ]
        return " ".join(words)

    def decode(self, batch) -> List[str]:
        return [self.decode_ids([int(x) for x in row]) for row in batch]

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(self.tokens))

    @classmethod
    def load(cls, path: str, ntokens: Optional[int] = None) -> "WordVocab":
        with open(path, encoding="utf-8") as f:
            toks = f.read().split("\n")
        while toks and toks[-1] == "":  # trailing newline(s) are not tokens
            toks.pop()
        if ntokens is not None:
            toks = toks[: ntokens + 3]
        return cls(toks)


def learn_wordpieces(
    transcripts: Iterable[str], vocab_size: int = 1024, min_freq: int = 2
) -> List[str]:
    """BPE-style word-piece learner.

    Starts from characters (word-initial characters carry the ``▁`` marker)
    and greedily merges the most frequent adjacent pair until ``vocab_size``
    pieces exist.
    """
    word_freq = collections.Counter()
    for line in transcripts:
        word_freq.update(normalize_text(line).split())

    # each word as a tuple of symbols, first char gets the marker
    words = {
        tuple([SPACE_MARKER + w[0]] + list(w[1:])): f for w, f in word_freq.items() if w
    }
    pieces = set()
    for sym_seq in words:
        pieces.update(sym_seq)

    while len(pieces) < vocab_size:
        pair_freq = collections.Counter()
        for sym_seq, f in words.items():
            for a, b in zip(sym_seq, sym_seq[1:]):
                pair_freq[(a, b)] += f
        if not pair_freq:
            break
        (a, b), f = pair_freq.most_common(1)[0]
        if f < min_freq:
            break
        merged = a + b
        pieces.add(merged)
        new_words = {}
        for sym_seq, fr in words.items():
            out, i = [], 0
            while i < len(sym_seq):
                if i + 1 < len(sym_seq) and sym_seq[i] == a and sym_seq[i + 1] == b:
                    out.append(merged)
                    i += 2
                else:
                    out.append(sym_seq[i])
                    i += 1
            new_words[tuple(out)] = fr
        words = new_words

    # frequency-ordered piece list
    piece_freq = collections.Counter()
    for sym_seq, f in words.items():
        for s in sym_seq:
            piece_freq[s] += f
    for p in pieces:
        piece_freq.setdefault(p, 0)
    return [p for p, _ in piece_freq.most_common(vocab_size)]


class WordPieceVocab:
    """Word-piece vocabulary with ``<pad>/<blank>/<unk>`` at 0/1/2."""

    def __init__(self, tokens: Sequence[str]):
        self.tokens = list(tokens)
        if self.tokens[:3] != [PAD_TOKEN, BLANK_TOKEN, UNK_TOKEN]:
            raise ValueError("WordPieceVocab specials must be <pad>,<blank>,<unk> at 0/1/2")
        self.index = {t: i for i, t in enumerate(self.tokens)}
        self._max_piece_len = max((len(t) for t in self.tokens[3:]), default=1)

    pad_id = 0
    blank_id = 1
    unk_id = 2

    @classmethod
    def build(
        cls,
        transcripts: Iterable[str],
        ntokens: int = 1024,
        min_freq: int = 2,
    ) -> "WordPieceVocab":
        pieces = learn_wordpieces(transcripts, ntokens - 3, min_freq)
        return cls([PAD_TOKEN, BLANK_TOKEN, UNK_TOKEN] + pieces)

    def __len__(self) -> int:
        return len(self.tokens)

    def _segment_word(self, word: str) -> List[str]:
        """Greedy longest-match segmentation of ``▁word``."""
        s = SPACE_MARKER + word
        out, i = [], 0
        while i < len(s):
            for j in range(min(len(s), i + self._max_piece_len), i, -1):
                if s[i:j] in self.index:
                    out.append(s[i:j])
                    i = j
                    break
            else:
                return [UNK_TOKEN]  # unsegmentable → whole word unk
        return out

    def parse(self, sentence: str) -> List[int]:
        """Segment each word; any word containing an unknown piece collapses
        to a single ``<unk>``."""
        ids: List[int] = []
        for word in normalize_text(sentence).split():
            seg = self._segment_word(word)
            if UNK_TOKEN in seg:
                ids.append(self.unk_id)
            else:
                ids.extend(self.index[p] for p in seg)
        return ids

    def is_tolerable(self, sentence: str, unk_tol: float = 0.3) -> bool:
        """Unk-ratio sentence filter."""
        ids = self.parse(sentence)
        if not ids:
            return False
        return ids.count(self.unk_id) / len(ids) <= unk_tol

    def decode_ids(self, ids: Sequence[int]) -> str:
        """CTC-style decode: keep blank/unk and
        non-special pieces; collapse consecutive repeats when blank present;
        strip blanks; re-space on the ▁ marker."""
        toks = [
            self.tokens[i]
            for i in ids
            if 0 <= i < len(self.tokens)
        ]
        toks = [x for x in toks if x in (BLANK_TOKEN, UNK_TOKEN) or "<" not in x]
        if BLANK_TOKEN in toks:
            toks = [
                toks[i] if i == 0 or toks[i] != toks[i - 1] else "" for i in range(len(toks))
            ]
            toks = [x for x in toks if x != BLANK_TOKEN]
        s = "".join(toks)
        s = s.replace(UNK_TOKEN, SPACE_MARKER + UNK_TOKEN)
        s = s.replace(SPACE_MARKER, " ")
        return " ".join(s.split())

    def decode(self, batch) -> List[str]:
        return [self.decode_ids([int(x) for x in row]) for row in batch]

    def save(self, path: str) -> None:
        with open(path, "w", encoding="utf-8") as f:
            f.write("\n".join(self.tokens))

    @classmethod
    def load(cls, path: str, ntokens: Optional[int] = None) -> "WordPieceVocab":
        with open(path, encoding="utf-8") as f:
            toks = f.read().split("\n")
        while toks and toks[-1] == "":  # trailing newline(s) are not tokens
            toks.pop()
        if ntokens is not None:
            toks = toks[:ntokens]
        return cls(toks)


def load_any_vocab(path: str, ntokens: Optional[int] = None):
    """Dispatch on the special-token head order used by the two formats."""
    with open(path, encoding="utf-8") as f:
        head = f.read(64).split("\n")[0].strip()
    if head == BLANK_TOKEN:
        return WordVocab.load(path, ntokens)
    return WordPieceVocab.load(path, ntokens)


def build_vocab(kind: str, transcripts: Iterable[str], ntokens: Optional[int] = None):
    if kind == "word":
        return WordVocab.build(transcripts, ntokens)
    if kind == "wordpiece":
        return WordPieceVocab.build(transcripts, ntokens or 1024)
    raise ValueError(f"unknown vocab kind {kind!r}")
