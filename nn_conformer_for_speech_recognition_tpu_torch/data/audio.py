"""Host-side audio IO and synthetic corpus generation, copied from the JAX
package's ``data/audio.py`` (numpy and the standard library only;
``tests/test_torch_data.py`` holds the same seed to the same samples and
manifests).

WAV decode is stdlib ``wave`` + numpy (PCM8/PCM16/PCM32).  The synthetic
corpus is what tests and `chip_smoke.py` train on: each "word" is a
deterministic tone-complex signature, so a model that learns the mapping is
verifiably correct and pseudo-labels can be checked.
"""

from __future__ import annotations

import hashlib
import os
import wave
from typing import Dict, Optional, Sequence, Tuple

import numpy as np


def read_wav(path: str) -> Tuple[np.ndarray, int]:
    """Decode a WAV file → (float32 mono samples in [-1, 1], sample_rate)."""
    with wave.open(path, "rb") as w:
        sr = w.getframerate()
        n = w.getnframes()
        ch = w.getnchannels()
        width = w.getsampwidth()
        raw = w.readframes(n)
    if width == 2:
        x = np.frombuffer(raw, dtype="<i2").astype(np.float32) / 32768.0
    elif width == 4:
        x = np.frombuffer(raw, dtype="<i4").astype(np.float32) / 2147483648.0
    elif width == 1:
        x = (np.frombuffer(raw, dtype=np.uint8).astype(np.float32) - 128.0) / 128.0
    else:
        raise ValueError(f"unsupported sample width {width} in {path}")
    if ch > 1:
        x = x.reshape(-1, ch).mean(axis=1)
    return x, sr


def write_wav(path: str, samples: np.ndarray, sample_rate: int) -> None:
    x = np.clip(samples, -1.0, 1.0)
    pcm = (x * 32767.0).astype("<i2")
    with wave.open(path, "wb") as w:
        w.setnchannels(1)
        w.setsampwidth(2)
        w.setframerate(sample_rate)
        w.writeframes(pcm.tobytes())


def _word_signature(word: str, n_tones: int = 3) -> np.ndarray:
    """Deterministic per-word tone frequencies derived from a hash."""
    h = hashlib.sha256(word.encode()).digest()
    freqs = []
    for i in range(n_tones):
        v = int.from_bytes(h[4 * i : 4 * i + 4], "little")
        freqs.append(200.0 + (v % 3000))
    return np.asarray(freqs)


def synth_word_audio(
    word: str,
    sample_rate: int = 16000,
    duration: float = 0.4,
    rng: Optional[np.random.Generator] = None,
    noise_std: float = 0.02,
) -> np.ndarray:
    """One spoken 'word' = its tone-complex signature + envelope + noise."""
    rng = rng or np.random.default_rng(abs(hash(word)) % (2**31))
    n = int(sample_rate * duration)
    t = np.arange(n) / sample_rate
    freqs = _word_signature(word)
    sig = sum(np.sin(2 * np.pi * f * t + rng.uniform(0, 2 * np.pi)) for f in freqs)
    env = np.hanning(n)
    x = (sig / len(freqs)) * env
    x = x + noise_std * rng.standard_normal(n)
    return (0.5 * x).astype(np.float32)


def synth_utterance(
    words: Sequence[str],
    sample_rate: int = 16000,
    word_duration: float = 0.4,
    gap: float = 0.05,
    rng: Optional[np.random.Generator] = None,
    noise_std: float = 0.02,
) -> np.ndarray:
    rng = rng or np.random.default_rng(0)
    parts = []
    gap_n = int(sample_rate * gap)
    for w in words:
        parts.append(synth_word_audio(w, sample_rate, word_duration, rng, noise_std))
        parts.append(np.zeros(gap_n, np.float32))
    return np.concatenate(parts[:-1]) if parts else np.zeros(0, np.float32)


def make_synthetic_corpus(
    root: str,
    words: Sequence[str],
    n_train: int,
    n_val: int,
    n_test: int,
    n_unlabeled: int = 0,
    sample_rate: int = 16000,
    max_words_per_utt: int = 1,
    seed: int = 0,
) -> Dict[str, str]:
    """Write a manifest-based synthetic corpus (wav files + transcript TSVs).

    Layout: ``root/{split}.tsv`` lines of ``wav_path\ttranscript`` (empty
    transcript for the unlabeled NST split), wavs under
    ``root/wavs/``.
    Returns {split: manifest_path}.
    """
    rng = np.random.default_rng(seed)
    os.makedirs(os.path.join(root, "wavs"), exist_ok=True)
    manifests = {}
    counts = {
        "train": (n_train, True),
        "validation": (n_val, True),
        "test": (n_test, True),
        "unlabeled": (n_unlabeled, False),
    }
    idx = 0
    for split, (n, labeled) in counts.items():
        if n == 0:
            continue
        lines = []
        for _ in range(n):
            k = int(rng.integers(1, max_words_per_utt + 1))
            utt_words = [words[int(rng.integers(len(words)))] for _ in range(k)]
            audio = synth_utterance(utt_words, sample_rate, rng=rng)
            path = os.path.join(root, "wavs", f"utt_{idx:06d}.wav")
            write_wav(path, audio, sample_rate)
            text = " ".join(utt_words) if labeled else ""
            lines.append(f"{path}\t{text}")
            idx += 1
        mpath = os.path.join(root, f"{split}.tsv")
        with open(mpath, "w", encoding="utf-8") as f:
            f.write("\n".join(lines))
        manifests[split] = mpath
    return manifests
