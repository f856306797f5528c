#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port once on one NVIDIA GPU and checks its kernels.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the hand-written
   kernels from ``csrc/`` with nvcc, one process per source (the
   compiler's ``-Xptxas -v`` report is printed).
2. Holds each kernel against its plain PyTorch twin on the card at the
   shapes of the main paths (Conformer-M, B=16, 30 s clips, targets of
   100 tokens), with mixed lengths, and times both with CUDA events after
   warm-up.
3. Serving path: the Noisy Student pseudo-label pass (``make_predict_step``:
   log-mel → Conformer-M forward → greedy decode → ``WordVocab.decode_ids``)
   with weights and audio made from a seed.  The kernel path and the plain
   path must agree in float32; the bfloat16 kernel path (the one a user
   runs) is timed, and the launch counters must show every kernel of it.
4. Training path: the supervised train step.  In float32, one step of the
   kernel path and of the plain path from the same weights and features
   must agree (loss, gradient norm, every gradient, the updated parameters
   and batch statistics).  In bfloat16, as a user runs it
   (``make_augment_step`` then ``make_feature_train_step``), it is timed
   over several steps (ms/step, audio-s/s, MFU, peak memory), every
   gradient must be finite and non-zero, the loss must fall over 10 steps
   on a repeated batch, and the launch counters must show each kernel of
   the step the expected number of times.
5. Prints one JSON line with each kernel's numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  There is no CPU path: without a
CUDA device the script exits non-zero before printing any result.
"""

import dataclasses
import json
import subprocess
import sys
import time
from pathlib import Path

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH, SECONDS, VOCAB, SEED, TARGET_LEN = 16, 30.0, 1024, 0, 100
N_BATCHES = 3  # pseudo-label batches timed and counted
N_TRAIN_STEPS = 5  # bf16 train steps timed and counted, after two warm-up steps
LOSS_STEPS, LOSS_LR = 10, 1e-3  # the loss must fall over 10 steps at this lr
TOL = {
    "stft_logmel": 1e-3, "attention_f32": 1e-4, "attention_bf16": 2e-2, "lstm": 1e-4,
    "lstm_backward": 1e-4,  # dxw, absolute
    "lstm_weight_grad": 1e-4,  # dW_hh, relative to its largest entry
    "ctc_alpha": 1e-5,  # ll, relative
    # demit, absolute; posteriors exp(α + β - ll) are formed from log-space
    # values of ~1.5e3 at T=235, where one float32 ulp is 1.2e-4
    "ctc_beta": 5e-4,
    "ctc_witness_loss": 1e-5, "ctc_witness_grad": 1e-3,  # against torch's own CTC
}
SLICE_LOGPROB_TOL, SLICE_ID_AGREEMENT = 2e-3, 0.999
# float32 train step, kernel path vs plain path
TRAIN_TOL = {
    # the gradients of the two CTC implementations differ by ~1e-4 relative
    # (float32 posteriors at T=235), so the norm is held as the gradients are
    "loss": 1e-5, "grad_norm": 1e-3, "grad": 1e-3, "batch_stats": 1e-4,
    "step": 1e-2,  # relative to the parameter's largest step; see check_train
}


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


def counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` it bumps per launch."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import ctc as K
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import stft_logmel as S

    return {
        "stft_logmel": S.stft_logmel, "attention_relpos": A.flash_relpos_attention, "lstm": L.lstm_forward,
        "lstm_backward": L.lstm_backward, "lstm_weight_grad": L.lstm_weight_grad,
        "ctc_alpha": K.ctc_alpha, "ctc_beta": K.ctc_beta,
    }


def reset_counters() -> None:
    for wrapper in counters().values():
        wrapper.launches = 0


def read_counters() -> dict:
    return {name: wrapper.launches for name, wrapper in counters().items()}


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


def check_train_kernels(card: str) -> dict:
    """The train path's kernels against their twins at main-path shapes."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops import ctc as TC
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import ctc as K
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    results = {}

    # -- LSTM backward + dW_hh: B=16, T=235, H=320, both directions
    b, t, hidden = BATCH, 235, 320
    xw = torch.randn(b, t, 4 * hidden, generator=gen).to(dev)
    w_hh = (torch.randn(hidden, 4 * hidden, generator=gen) * hidden ** -0.5).to(dev)
    lengths = mixed_lengths(gen, b, t, t // 3).to(dev)
    gout = torch.randn(b, t, hidden, generator=gen).to(dev)
    errs, werrs, saved = [], [], {}
    for reverse in (False, True):
        h, c, gates = L.lstm_forward(xw, w_hh, lengths, reverse=reverse, save=True)
        h_ref, c_ref, g_ref = L.lstm_forward_plain(xw, w_hh, lengths, reverse)
        errs.append(max(max_abs(h, h_ref), max_abs(c, c_ref), max_abs(gates, g_ref)))
        dxw = L.lstm_backward(gout, gates, c, w_hh, lengths, reverse=reverse)
        dxw_ref = L.lstm_backward_plain(gout, g_ref, c_ref, w_hh, lengths, reverse)
        dw = L.lstm_weight_grad(h, dxw, reverse=reverse)
        dw_ref = L.lstm_weight_grad_plain(h_ref, dxw_ref, reverse)
        errs.append(max_abs(dxw, dxw_ref))
        werrs.append(max_abs(dw, dw_ref) / dw_ref.abs().max().item())
        saved[reverse] = (h, c, gates, dxw)
    torch.cuda.synchronize()
    fwd_err, bwd_err = max(errs[0], errs[2]), max(errs[1], errs[3])
    h, c, gates, dxw = saved[True]
    ms = cuda_ms(lambda: L.lstm_backward(gout, gates, c, w_hh, lengths, reverse=True))
    plain_ms = cuda_ms(lambda: L.lstm_backward_plain(gout, gates, c, w_hh, lengths, True), iters=5)
    wms = cuda_ms(lambda: L.lstm_weight_grad(h, dxw, reverse=True))
    wplain_ms = cuda_ms(lambda: L.lstm_weight_grad_plain(h, dxw, True))
    fms = cuda_ms(lambda: L.lstm_forward(xw, w_hh, lengths, reverse=True, save=True))
    print(f"lstm training forward (h, c, gates) vs twin: max|Δ| {fwd_err:.3e} (tol {TOL['lstm']}), "
          f"kernel {fms:.4f} ms  [{card}]")
    print(f"lstm_backward (16, 235, 4x320) f32, per direction: dxw max|Δ| fwd {errs[1]:.3e} bwd {errs[3]:.3e} "
          f"(tol {TOL['lstm_backward']}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    print(f"lstm_weight_grad (320 x 3760)·(3760 x 1280) f32: dW_hh max|Δ|/max|dW| fwd {werrs[0]:.3e} "
          f"bwd {werrs[1]:.3e} (tol {TOL['lstm_weight_grad']}), kernel {wms:.4f} ms, plain {wplain_ms:.4f} ms  [{card}]")
    check(fwd_err <= TOL["lstm"], "lstm training forward disagrees with its plain twin")
    check(bwd_err <= TOL["lstm_backward"], "lstm_backward disagrees with its plain twin")
    check(max(werrs) <= TOL["lstm_weight_grad"], "lstm_weight_grad disagrees with its plain twin")
    results["lstm_backward"] = dict(max_abs_err=bwd_err, ms=ms, plain_ms=plain_ms)
    results["lstm_weight_grad"] = dict(max_abs_err=max(werrs), ms=wms, plain_ms=wplain_ms)

    # -- CTC alpha/beta: B=16, T'=235, L=100 (S=201), V=1024; one row of
    #    repeated pairs, one empty label, one impossible alignment
    labels = torch.randint(3, VOCAB, (b, TARGET_LEN), generator=gen)
    labels[1] = labels[1, : TARGET_LEN // 2].repeat_interleave(2)
    label_lengths = torch.full((b,), TARGET_LEN)
    label_lengths[2] = 0
    input_lengths = torch.randint(2 * TARGET_LEN + 20, t + 1, (b,), generator=gen)
    input_lengths[0], input_lengths[3] = t, 60
    logits = (torch.randn(b, t, VOCAB, generator=gen) * 2).to(dev)
    labels, label_lengths, input_lengths = labels.to(dev), label_lengths.to(dev), input_lengths.to(dev)
    ext, can_skip, _, ext_len = TC.extended_labels(labels, label_lengths, 0)
    emit = TC.emit_log_probs(torch.log_softmax(logits, -1), ext)
    alpha = K.ctc_alpha(emit, can_skip, ext_len, input_lengths)
    alpha_ref = K.ctc_alpha_plain(emit, can_skip, ext_len, input_lengths)
    ll, ll_ref = K.final_ll(alpha[:, -1], ext_len), K.final_ll(alpha_ref[:, -1], ext_len)
    g = torch.randn(b, generator=gen).to(dev)
    demit = K.ctc_beta(emit, alpha, can_skip, ext_len, input_lengths, ll, g)
    demit_ref = K.ctc_beta_plain(emit, alpha, can_skip, ext_len, input_lengths, ll, g)
    torch.cuda.synchronize()
    check(bool(ll_ref[3] == TC.LOG_EPS) and bool((ll_ref[[0, 1, 2]] > TC.LOG_EPS / 2).all()),
          "ctc test rows: row 3 must be impossible, rows 0-2 possible")
    ll_err = ((ll - ll_ref).abs() / ll_ref.abs()).max().item()
    demit_err = max_abs(demit, demit_ref)
    check(bool(torch.isfinite(demit).all()), "ctc_beta gives non-finite values")
    x, w = logits.clone().requires_grad_(True), logits.clone().requires_grad_(True)
    ours = K.ctc_loss_kernel(torch.log_softmax(x, -1), labels, input_lengths, label_lengths, reduction=None)
    ref = torch.nn.functional.ctc_loss(torch.log_softmax(w, -1).transpose(0, 1), labels, input_lengths,
                                       label_lengths, reduction="none", zero_infinity=True)
    ours.sum().backward()
    ref.sum().backward()
    witness_loss = ((ours - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
    witness_grad = max_abs(x.grad, w.grad)
    check(bool(ours[3] == 0) and bool((x.grad[3] == 0).all()), "zero_infinity row not zeroed")
    ams = cuda_ms(lambda: K.ctc_alpha(emit, can_skip, ext_len, input_lengths))
    aplain_ms = cuda_ms(lambda: K.ctc_alpha_plain(emit, can_skip, ext_len, input_lengths), iters=5)
    bms = cuda_ms(lambda: K.ctc_beta(emit, alpha, can_skip, ext_len, input_lengths, ll, g))
    bplain_ms = cuda_ms(lambda: K.ctc_beta_plain(emit, alpha, can_skip, ext_len, input_lengths, ll, g), iters=5)
    print(f"ctc_alpha (16, 235, 201) f32: ll max rel|Δ| {ll_err:.3e} (tol {TOL['ctc_alpha']}), "
          f"kernel {ams:.4f} ms, plain {aplain_ms:.4f} ms  [{card}]")
    print(f"ctc_beta (16, 235, 201) f32: demit max|Δ| {demit_err:.3e} (tol {TOL['ctc_beta']}), "
          f"kernel {bms:.4f} ms, plain {bplain_ms:.4f} ms  [{card}]")
    print(f"ctc_loss_kernel vs torch.nn.functional.ctc_loss: loss max rel|Δ| {witness_loss:.3e} "
          f"(tol {TOL['ctc_witness_loss']}), logit-grad max|Δ| {witness_grad:.3e} (tol {TOL['ctc_witness_grad']})")
    check(ll_err <= TOL["ctc_alpha"], "ctc_alpha disagrees with its plain twin")
    check(demit_err <= TOL["ctc_beta"], "ctc_beta disagrees with its plain twin")
    check(witness_loss <= TOL["ctc_witness_loss"], "ctc loss disagrees with torch's CTC")
    check(witness_grad <= TOL["ctc_witness_grad"], "ctc gradient disagrees with torch's CTC")
    results["ctc_alpha"] = dict(max_abs_err=(ll - ll_ref).abs().max().item(), ms=ams, plain_ms=aplain_ms)
    results["ctc_beta"] = dict(max_abs_err=demit_err, ms=bms, plain_ms=bplain_ms)
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


def check_slice(card: str) -> dict:
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
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
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    outputs = [predict(audio, alen) for audio, alen in batches[1:]]
    torch.cuda.synchronize()
    dt = time.perf_counter() - t0
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    texts = []
    for (ids, out_lengths), (_, alen) in zip(outputs, batches[1:]):
        check(ids.shape == (BATCH, 235) and ids.dtype == torch.int32, "predict ids shape/dtype")
        frames = alen // 512 + 1
        check(bool((out_lengths == ((frames + 1) // 2 + 1) // 2).all()), "predict out_lengths")
        texts += [vocab.decode_ids(row.tolist()) for row in ids.cpu()]
    print(f"pseudo-labels: {len(texts)} strings, first: {texts[0][:80]!r}")
    print(f"launch counts over {N_BATCHES} pseudo-label batches: {launches}")
    expected = {"stft_logmel": N_BATCHES, "attention_relpos": 16 * N_BATCHES, "lstm": 2 * N_BATCHES}
    check(launches == {**dict.fromkeys(launches, 0), **expected}, f"pseudo-label launch counts, want {expected}")
    per_batch = dt / N_BATCHES
    print(f"bf16 pseudo-label pass: {per_batch * 1e3:.2f} ms/batch (B={BATCH}, {SECONDS:.0f} s clips), "
          f"{BATCH * SECONDS / per_batch:.1f} audio-s/s, peak memory {peak / 2**20:.1f} MiB  [{card}]")
    return launches


def relative_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    return max_abs(got, ref) / max(ref.abs().max().item(), 1e-30)


def check_train(card: str) -> dict:
    """The supervised train step: float32 kernel path vs plain path, then
    the bf16 step as a user runs it."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import (
        FeatureConfig, OptimizerConfig, SpecAugmentConfig, conformer_m,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_augment_step, make_feature_train_step
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState
    from nn_conformer_for_speech_recognition_tpu_torch.utils.flops import peak_bf16_flops, train_step_flops

    gen = torch.Generator().manual_seed(SEED + 3)
    base = init_params(ConformerCTC(conformer_m(use_pallas=True), VOCAB), gen)
    for name, buf in base.named_buffers():  # non-trivial running statistics
        buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 + (0.75 if name.endswith("var") else -0.25))
    weights = base.state_dict()

    def trainer(cfg, lr: float, ctc_impl: str = "auto"):
        m = ConformerCTC(cfg, VOCAB)
        m.load_state_dict(weights)
        m.cuda()
        state = TrainState.create(m, make_optimizer(OptimizerConfig(learning_rate=lr), m.named_parameters()), SEED)
        return state, make_feature_train_step(m, blank_id=0, ctc_impl=ctc_impl)

    n_samples = int(SECONDS * 16000)
    augment = make_augment_step(FeatureConfig(), SpecAugmentConfig())
    targets = torch.randint(3, VOCAB, (BATCH, TARGET_LEN), generator=gen).cuda()

    # -- float32, kernel path vs plain path: one step from the same weights
    #    and the same (augmented) features, dropout 0
    def f32(use_pallas: bool):
        cfg = conformer_m(use_pallas=use_pallas, compute_dtype="float32")
        return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.0),
                                   decoder=dataclasses.replace(cfg.decoder, dropout=0.0))

    audio, alen = make_batches(n_samples)[0]
    alen = torch.clamp_min(alen, n_samples // 2)  # 15-30 s: room for 100 targets
    feats, flens = augment(torch.Generator(device="cuda").manual_seed(SEED), audio, alen)
    tlen = torch.full((BATCH,), TARGET_LEN, device="cuda")
    tlen[1], tlen[2] = 0, TARGET_LEN // 3
    lr32 = OptimizerConfig().learning_rate
    runs = []
    for use_pallas, ctc_impl in ((True, "auto"), (False, "xla")):
        state, step = trainer(f32(use_pallas), lr32, ctc_impl)
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        state, metrics = step(state, feats, flens, targets, tlen)
        runs.append((state, metrics, before))
    (sk, met_k, before), (sp, met_p, _) = runs
    loss_err = abs(met_k["loss"].item() - met_p["loss"].item()) / abs(met_p["loss"].item())
    norm_err = abs(met_k["grad_norm"].item() - met_p["grad_norm"].item()) / met_p["grad_norm"].item()
    params_p = dict(sp.model.named_parameters())
    # updates: Adafactor normalises each row and column of a gradient (and
    # moves an unfactored entry by ±0.1·lr on the first step), so an entry
    # whose gradient is at noise level takes a full-size step of
    # noise-determined direction on either path; the update is held on the
    # entries whose gradient is clear of 0 by 1e-3 of the tensor's largest
    grad_err = step_err = 0.0
    noisy = total = 0
    for name, pk in sk.model.named_parameters():
        pp = params_p[name]
        grad_err = max(grad_err, relative_error(pk.grad, pp.grad))
        dk, dp = pk.detach() - before[name], pp.detach() - before[name]
        clear = pp.grad.abs() > 1e-3 * pp.grad.abs().max()
        step_err = max(step_err, max_abs(dk[clear], dp[clear]) / dp.abs().max().item())
        noisy += (~clear).sum().item()
        total += clear.numel()
    stats_p = dict(sp.model.named_buffers())
    stats_err = max(max_abs(b, stats_p[n]) for n, b in sk.model.named_buffers())
    print(f"train step f32, kernel vs plain path: loss {met_k['loss'].item():.6f} vs {met_p['loss'].item():.6f} "
          f"(rel {loss_err:.3e}, tol {TRAIN_TOL['loss']}), grad norm rel {norm_err:.3e} (tol {TRAIN_TOL['grad_norm']}), "
          f"worst gradient max|Δ|/max|g| {grad_err:.3e} (tol {TRAIN_TOL['grad']}), batch stats max|Δ| {stats_err:.3e} "
          f"(tol {TRAIN_TOL['batch_stats']}); updates at lr {lr32}: max|Δ|/max|step| {step_err:.3e} "
          f"(tol {TRAIN_TOL['step']}) on the {total - noisy}/{total} entries whose gradient is clear of 0")
    check(loss_err <= TRAIN_TOL["loss"], "f32 train-step loss of the kernel path disagrees")
    check(norm_err <= TRAIN_TOL["grad_norm"], "f32 gradient norm of the kernel path disagrees")
    check(grad_err <= TRAIN_TOL["grad"], "f32 gradients of the kernel path disagree")
    check(stats_err <= TRAIN_TOL["batch_stats"], "f32 batch statistics of the kernel path disagree")
    check(step_err <= TRAIN_TOL["step"], "f32 updated parameters of the kernel path disagree")
    del runs, sk, sp, params_p, stats_p, before

    # -- bf16, as a user runs it: augment, then the train step; full-length
    #    30 s clips, 100 targets per row (bench.py's shape)
    cfg16 = conformer_m(use_pallas=True)  # compute 'auto': bfloat16 on CUDA
    state, step = trainer(cfg16, OptimizerConfig().learning_rate)
    audio = make_batches(n_samples)[1][0]
    alen = torch.full((BATCH,), n_samples, device="cuda")
    tlen = torch.full((BATCH,), TARGET_LEN, device="cuda")

    def train_step(state):
        f, fl = augment(state.generator, audio, alen)
        return step(state, f, fl, targets, tlen)

    for _ in range(2):  # warm-up
        state, _ = train_step(state)
    torch.cuda.synchronize()
    reset_counters()
    torch.cuda.reset_peak_memory_stats()
    t0 = time.perf_counter()
    for _ in range(N_TRAIN_STEPS):
        state, metrics = train_step(state)
    torch.cuda.synchronize()
    dt = (time.perf_counter() - t0) / N_TRAIN_STEPS
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    for name, p in state.model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()) and p.grad.abs().max().item() > 0,
              f"bf16 train step: gradient of {name} is missing, non-finite or zero")
    check(bool(torch.isfinite(metrics["loss"])), "bf16 train-step loss is not finite")
    flops = train_step_flops(cfg16, VOCAB, BATCH, FeatureConfig().num_frames(n_samples))
    mfu = flops / dt / peak_bf16_flops(torch.cuda.get_device_name(0))
    print(f"bf16 train step (B={BATCH}, {SECONDS:.0f} s clips, {TARGET_LEN} targets, Adafactor lr "
          f"{OptimizerConfig().learning_rate}): {dt * 1e3:.2f} ms/step over {N_TRAIN_STEPS} steps, "
          f"{BATCH * SECONDS / dt:.1f} audio-s/s, MFU {mfu:.4%} of the card's dense bf16 peak "
          f"({flops / 1e12:.3f} model TFLOP/step), peak memory {peak / 2**20:.1f} MiB  [{card}]")
    print(f"launch counts over {N_TRAIN_STEPS} bf16 train steps: {launches}")
    n = N_TRAIN_STEPS
    expected = {"stft_logmel": n, "attention_relpos": 0, "lstm": 2 * n, "lstm_backward": 2 * n,
                "lstm_weight_grad": 2 * n, "ctc_alpha": n, "ctc_beta": n}
    check(launches == expected, f"train-step launch counts, want {expected}")

    # -- the loss falls over 10 steps on one repeated batch
    state, step = trainer(cfg16, LOSS_LR)
    losses = []
    for _ in range(LOSS_STEPS + 1):
        state, metrics = train_step(state)
        losses.append(metrics["loss"].item())
    print(f"bf16 loss on a repeated batch at lr {LOSS_LR}: " + " ".join(f"{x:.3f}" for x in losses))
    check(losses[-1] < losses[0], f"the loss did not fall in {LOSS_STEPS} steps")
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
    t0 = time.perf_counter()
    build.build(verbose=True)
    print(f"kernels built in {time.perf_counter() - t0:.1f} s")
    results = check_kernels(card)
    results.update(check_train_kernels(card))
    serve = check_slice(card)
    train = check_train(card)
    sources = {
        "stft_logmel": ("csrc/stft_logmel.cu", "ops/pallas/stft_logmel.py:74"),
        "attention_relpos": ("csrc/attention_relpos.cu", "ops/pallas/attention.py:281"),
        "lstm": ("csrc/lstm.cu", "ops/pallas/lstm.py:69"),
        "lstm_backward": ("csrc/lstm.cu", "ops/pallas/lstm.py:107"),
        "lstm_weight_grad": ("csrc/lstm.cu", "ops/pallas/lstm.py:159"),
        "ctc_alpha": ("csrc/ctc.cu", "ops/pallas/ctc.py:57"),
        "ctc_beta": ("csrc/ctc.cu", "ops/pallas/ctc.py:95"),
    }
    print(f"launches, pseudo-label pass + train steps: { {k: (serve[k], train[k]) for k in sources} }")
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"nn_conformer_for_speech_recognition_tpu_torch/{src}",
            "replaces": f"nn_conformer_for_speech_recognition_tpu/{tpu}",
            "launches": serve[name] + train[name],
            **results[name],
        }
        for name, (src, tpu) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
