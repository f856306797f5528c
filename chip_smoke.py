#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port once on one NVIDIA GPU and checks its kernels.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the hand-written
   kernels from ``csrc/`` with nvcc (the compiler's ``-Xptxas -v`` report
   is printed).
2. Holds each kernel against its plain PyTorch twin on the card at the
   shapes of the main path (Conformer-M, B=16, 30 s clips), with mixed
   lengths, and times both with CUDA events after warm-up.
3. Runs the slice: the Noisy Student pseudo-label pass
   (``make_predict_step``: log-mel → Conformer-M forward → greedy decode →
   ``WordVocab.decode_ids``) with weights and audio made from a seed.  The
   kernel path and the plain path must agree in float32; the bfloat16
   kernel path (the one a user runs) is timed, and the launch counters must
   show that every kernel ran in it.
4. Prints one JSON line with each kernel's numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  There is no CPU path: without a
CUDA device the script exits non-zero before printing any result.
"""

import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH, SECONDS, VOCAB, SEED = 16, 30.0, 1024, 0
N_BATCHES = 3  # main-path batches timed and counted
TOL = {"stft_logmel": 1e-3, "attention_f32": 1e-4, "attention_bf16": 2e-2, "lstm": 1e-4}
SLICE_LOGPROB_TOL, SLICE_ID_AGREEMENT = 2e-3, 0.999


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call on the card, from CUDA events."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def mixed_lengths(gen: torch.Generator, n: int, full: int, low: int) -> torch.Tensor:
    lengths = torch.randint(low, full + 1, (n,), generator=gen)
    lengths[0] = full
    return lengths.to(torch.int32)


def check_kernels(card: str) -> dict:
    """Each kernel against its plain twin at main-path shapes."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import stft_logmel as S

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    results = {}

    # -- stft_logmel: (16, 480000) f32 → (16, 938, 40)
    cfg = FeatureConfig()
    audio = (torch.randn(BATCH, int(SECONDS * cfg.sample_rate), generator=gen) * 0.1).to(dev)
    got, ref = S.stft_logmel(audio, cfg), S.stft_logmel_plain(audio, cfg)
    torch.cuda.synchronize()
    check(got.shape == ref.shape == (BATCH, 938, cfg.n_mels), f"stft_logmel shape {tuple(got.shape)}")
    err = max_abs(got, ref)
    ms = cuda_ms(lambda: S.stft_logmel(audio, cfg))
    plain_ms = cuda_ms(lambda: S.stft_logmel_plain(audio, cfg))
    print(f"stft_logmel (16, 480000) f32: max|Δ| {err:.3e} (tol {TOL['stft_logmel']}), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    check(err <= TOL["stft_logmel"], "stft_logmel disagrees with its plain twin")
    results["stft_logmel"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)

    # -- rel-pos attention: (16, 235, 4, 64), p (469, 4, 64)
    b, t, h, dh = BATCH, 235, 4, 64
    qu, qv, k, v = (torch.randn(b, t, h, dh, generator=gen) * 0.5 for _ in range(4))
    p = torch.randn(2 * t - 1, h, dh, generator=gen) * 0.5
    lengths = mixed_lengths(gen, b, t, t // 3)
    args32 = [x.to(dev) for x in (qu, qv, k, v, p)] + [lengths.to(dev), dh ** -0.5]
    args16 = [x.to(torch.bfloat16) for x in args32[:5]] + args32[5:]
    err32 = max_abs(A.flash_relpos_attention(*args32), A.flash_relpos_attention_plain(*args32))
    err16 = max_abs(A.flash_relpos_attention(*args16), A.flash_relpos_attention_plain(*args16))
    torch.cuda.synchronize()
    ms32 = cuda_ms(lambda: A.flash_relpos_attention(*args32))
    plain_ms32 = cuda_ms(lambda: A.flash_relpos_attention_plain(*args32))
    ms = cuda_ms(lambda: A.flash_relpos_attention(*args16))
    plain_ms = cuda_ms(lambda: A.flash_relpos_attention_plain(*args16))
    print(f"attention_relpos (16, 235, 4, 64): f32 max|Δ| {err32:.3e} (tol {TOL['attention_f32']}), "
          f"kernel {ms32:.4f} ms, plain {plain_ms32:.4f} ms; bf16 max|Δ| {err16:.3e} "
          f"(tol {TOL['attention_bf16']}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    check(err32 <= TOL["attention_f32"], "attention (f32) disagrees with its plain twin")
    check(err16 <= TOL["attention_bf16"], "attention (bf16) disagrees with its plain twin")
    results["attention_relpos"] = dict(max_abs_err=err32, ms=ms, plain_ms=plain_ms)

    # -- LSTM, one direction: xw (16, 235, 1280) f32, w_hh (320, 1280)
    hidden = 320
    xw = torch.randn(b, t, 4 * hidden, generator=gen).to(dev)
    w_hh = (torch.randn(hidden, 4 * hidden, generator=gen) * hidden ** -0.5).to(dev)
    lengths = lengths.to(dev)
    errs = []
    for reverse in (False, True):
        errs.append(max_abs(L.lstm(xw, w_hh, lengths, reverse=reverse),
                            L.lstm_plain(xw, w_hh, lengths, reverse)))
    torch.cuda.synchronize()
    err = max(errs)
    ms = cuda_ms(lambda: L.lstm(xw, w_hh, lengths, reverse=True))
    plain_ms = cuda_ms(lambda: L.lstm_plain(xw, w_hh, lengths, True), iters=5)
    print(f"lstm (16, 235, 4x320) f32, per direction: max|Δ| fwd {errs[0]:.3e} bwd {errs[1]:.3e} "
          f"(tol {TOL['lstm']}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    check(err <= TOL["lstm"], "lstm disagrees with its plain twin")
    results["lstm"] = dict(max_abs_err=err, ms=ms, plain_ms=plain_ms)
    return results


def make_batches(n_samples: int):
    """N_BATCHES + 1 padded batches of synthetic audio (tones + noise) with
    mixed lengths; batch 0 doubles as the warm-up."""
    gen = torch.Generator().manual_seed(SEED + 1)
    times = torch.arange(n_samples) / 16000.0
    batches = []
    for _ in range(N_BATCHES + 1):
        freqs = 100.0 + 3000.0 * torch.rand(BATCH, 3, 1, generator=gen)
        audio = torch.sin(2 * np.pi * freqs * times).sum(dim=1) * 0.1
        audio += 0.05 * torch.randn(BATCH, n_samples, generator=gen)
        lengths = mixed_lengths(gen, BATCH, n_samples, n_samples // 3)
        audio *= torch.arange(n_samples)[None, :] < lengths[:, None]
        batches.append((audio.cuda(), lengths.cuda()))
    return batches


def check_slice(card: str) -> None:
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.attention import flash_relpos_attention
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.lstm import lstm
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.stft_logmel import stft_logmel
    from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import greedy_decode
    from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_predict_step

    vocab = build_vocab("word", [" ".join(f"w{i}" for i in range(VOCAB - 3))])
    check(len(vocab) == VOCAB, "vocabulary size")
    gen = torch.Generator().manual_seed(SEED)
    base = init_params(ConformerCTC(conformer_m(use_pallas=True), VOCAB), gen)
    for name, buf in base.named_buffers():  # non-trivial running statistics
        buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 + (0.75 if name.endswith("var") else -0.25))
    state = base.state_dict()

    def model(**cfg):
        m = ConformerCTC(conformer_m(**cfg), VOCAB)
        m.load_state_dict(state)
        return m.cuda().eval()

    kernel32 = model(use_pallas=True, compute_dtype="float32")
    plain32 = model(use_pallas=False, compute_dtype="float32")
    kernel16 = model(use_pallas=True)  # 'auto': bfloat16 on CUDA
    plain16 = model(use_pallas=False)
    feat_kernel = make_featurizer(FeatureConfig())
    feat_plain = make_featurizer(FeatureConfig(impl="xla"))
    n_samples = int(SECONDS * 16000)
    batches = make_batches(n_samples)

    # -- float32: kernel path vs plain path
    worst, agree, total = 0.0, 0, 0
    with torch.inference_mode():
        for audio, alen in batches[1:]:
            fk, fl = feat_kernel(audio, alen)
            fp, _ = feat_plain(audio, alen)
            lk, ol = kernel32(fk, fl)
            lp, _ = plain32(fp, fl)
            check(lk.shape == (BATCH, 235, VOCAB), f"log-probs shape {tuple(lk.shape)}")
            valid = torch.arange(lk.shape[1], device=ol.device)[None, :] < ol[:, None]
            worst = max(worst, max_abs(lk[valid], lp[valid]))
            agree += (lk.argmax(-1) == lp.argmax(-1))[valid].sum().item()
            total += valid.sum().item()
    print(f"slice f32, kernel vs plain path over {N_BATCHES} batches: log-prob max|Δ| {worst:.3e} "
          f"(tol {SLICE_LOGPROB_TOL}), greedy ids equal on {agree}/{total} valid frames")
    check(worst <= SLICE_LOGPROB_TOL, "f32 log-probs of the kernel path disagree")
    check(agree >= SLICE_ID_AGREEMENT * total, "f32 greedy ids of the kernel path disagree")

    # -- bfloat16: finite log-probs, id agreement with the plain bf16 path
    with torch.inference_mode():
        audio, alen = batches[1]
        fk, fl = feat_kernel(audio, alen)
        lk, ol = kernel16(fk, fl)
        lp, _ = plain16(feat_plain(audio, alen)[0], fl)
        check(bool(torch.isfinite(lk).all()), "bf16 kernel path gives non-finite log-probs")
        valid = torch.arange(lk.shape[1], device=ol.device)[None, :] < ol[:, None]
        ids_k, ids_p = greedy_decode(lk, ol), greedy_decode(lp, ol)
        share = (ids_k == ids_p)[valid].float().mean().item()
    print(f"slice bf16, kernel vs plain path: greedy ids equal on {share:.4%} of valid frames")

    # -- the main path, as a user runs it: bf16 predict step
    predict = make_predict_step(kernel16, FeatureConfig(), pad_id=vocab.pad_id)
    predict(*batches[0])  # warm-up
    torch.cuda.synchronize()
    for wrapper in (stft_logmel, flash_relpos_attention, lstm):
        wrapper.launches = 0
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outputs = [predict(audio, alen) for audio, alen in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = {
        "stft_logmel": stft_logmel.launches,
        "attention_relpos": flash_relpos_attention.launches,
        "lstm": lstm.launches,
    }
    peak = torch.cuda.max_memory_allocated()
    texts = []
    for (ids, out_lengths), (_, alen) in zip(outputs, batches[1:]):
        check(ids.shape == (BATCH, 235) and ids.dtype == torch.int32, "predict ids shape/dtype")
        frames = alen // 512 + 1
        check(bool((out_lengths == ((frames + 1) // 2 + 1) // 2).all()), "predict out_lengths")
        texts += [vocab.decode_ids(row.tolist()) for row in ids.cpu()]
    print(f"pseudo-labels: {len(texts)} strings, first: {texts[0][:80]!r}")
    print(f"launch counts over {N_BATCHES} main-path batches: {launches}")
    check(launches["stft_logmel"] >= N_BATCHES, "stft_logmel kernel did not run on the main path")
    check(launches["attention_relpos"] == 16 * N_BATCHES, "attention kernel count off the main path")
    check(launches["lstm"] == 2 * N_BATCHES, "lstm kernel count off the main path")
    per_batch = dt / N_BATCHES
    print(f"bf16 pseudo-label pass: {per_batch * 1e3:.2f} ms/batch (B={BATCH}, {SECONDS:.0f} s clips), "
          f"{BATCH * SECONDS / per_batch:.1f} audio-s/s, peak memory {peak / 2**20:.1f} MiB  [{card}]")
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    sys.path.insert(0, str(REPO))
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    card = card_line()
    print(card)
    build.build(verbose=True)
    results = check_kernels(card)
    launches = check_slice(card)
    sources = {
        "stft_logmel": ("csrc/stft_logmel.cu", "ops/pallas/stft_logmel.py:74"),
        "attention_relpos": ("csrc/attention_relpos.cu", "ops/pallas/attention.py:281"),
        "lstm": ("csrc/lstm.cu", "ops/pallas/lstm.py:69"),
    }
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"nn_conformer_for_speech_recognition_tpu_torch/{src}",
            "replaces": f"nn_conformer_for_speech_recognition_tpu/{tpu}",
            "launches": launches[name],
            **results[name],
        }
        for name, (src, tpu) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
