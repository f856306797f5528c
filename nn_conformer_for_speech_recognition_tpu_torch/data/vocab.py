"""Word-level vocabulary, copied from the JAX package's ``data/vocab.py``.

myVocab semantics: frequency-sorted words truncated to ``ntokens``, specials
``<blank>, <pad>, <unk>`` at 0/1/2, whitespace ``parse``, and ``decode`` that
drops pad/blank and joins with spaces (no CTC repeat-collapse: units are
whole words).  ``tests/test_torch_slice.py`` holds it equal to the original.
The word-piece vocabulary is not ported yet.
"""

from __future__ import annotations

import collections
from typing import Dict, Iterable, List, Optional, Sequence

BLANK_TOKEN = "<blank>"
PAD_TOKEN = "<pad>"
UNK_TOKEN = "<unk>"


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


def build_vocab(kind: str, transcripts: Iterable[str], ntokens: Optional[int] = None):
    if kind == "word":
        return WordVocab.build(transcripts, ntokens)
    if kind == "wordpiece":
        raise NotImplementedError("the word-piece vocabulary is not ported yet")
    raise ValueError(f"unknown vocab kind {kind!r}")
