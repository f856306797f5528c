"""The one generator of every traffic mix: a corpus of synthetic utterances
drawn from the seed, with the parameters of a ``traffic/<name>.json`` file.

* ``clips`` utterances whose lengths are the ``clips`` evenly spaced points
  of ``seconds`` = [lo, hi] (each the middle of its share of the range),
  in an order drawn from the seed: every seed has the same set of lengths,
  so the work of an epoch is the same on every seed;
* audio: a tone of 100-3100 Hz at amplitude 0.1 plus white noise of
  standard deviation 0.05, drawn on the device from the seed, as 16-bit
  PCM at the configuration's sample rate, zero past each clip's length;
* transcripts (``labeled``): round(``words_per_second`` × seconds) words a
  clip, drawn uniformly from the lexicon of the configuration's vocabulary
  (``vocab_size`` - 3 synthetic words after blank, pad and unk).
"""

from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

SPECIALS = ("<blank>", "<pad>", "<unk>")


def lexicon(vocab_size: int) -> List[str]:
    return [f"w{i:04d}" for i in range(vocab_size - len(SPECIALS))]


@dataclasses.dataclass
class Corpus:
    pcm: np.ndarray  # (clips, pad_to) int16, zero past each length
    lengths: np.ndarray  # (clips,) samples
    ids: Optional[List[List[int]]]  # each clip's transcript as vocabulary ids, or None (unlabelled)
    words: List[str]  # the vocabulary's tokens, specials first
    max_target_len: int

    def transcript(self, i: int) -> str:
        return "" if self.ids is None else " ".join(self.words[j] for j in self.ids[i])


def make_corpus(traffic: dict, cfg: dict, seed: int, device) -> Corpus:
    sr = cfg["features"]["sample_rate"]
    n = traffic["clips"]
    lo, hi = traffic["seconds"]
    pad_to = int(round(hi * sr))
    rng = np.random.default_rng(seed)
    seconds = lo + (hi - lo) * (np.arange(n) + 0.5) / n
    lengths = np.round(seconds * sr).astype(np.int64)[rng.permutation(n)]
    words = list(SPECIALS) + lexicon(cfg["vocab_size"])
    ids = None
    max_target_len = 1
    if traffic["labeled"]:
        counts = np.maximum(np.round(traffic["words_per_second"] * lengths / sr).astype(np.int64), 1)
        ids = [(len(SPECIALS) + rng.integers(0, len(words) - len(SPECIALS), c)).tolist() for c in counts]
        max_target_len = int(np.ceil(traffic["words_per_second"] * hi))
    gen = torch.Generator(device=device).manual_seed(seed)
    pcm = np.empty((n, pad_to), np.int16)
    t = torch.arange(pad_to, device=device, dtype=torch.float32) / sr
    for i in range(0, n, 64):  # in blocks, to bound the device memory it takes
        rows = min(64, n - i)
        freq = 100.0 + 3000.0 * torch.rand((rows, 1), generator=gen, device=device)
        x = 0.1 * torch.sin(2 * np.pi * freq * t) + 0.05 * torch.randn((rows, pad_to), generator=gen, device=device)
        valid = torch.from_numpy(lengths[i:i + rows]).to(device)[:, None]
        x = x * (torch.arange(pad_to, device=device)[None, :] < valid)
        pcm[i:i + rows] = torch.clamp(torch.round(x * 32767.0), -32768, 32767).to(torch.int16).cpu().numpy()
    return Corpus(pcm, lengths, ids, words, max_target_len)
