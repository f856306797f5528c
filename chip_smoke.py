#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port once on one NVIDIA GPU and checks its kernels.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the hand-written
   kernels from ``csrc/`` with nvcc, one process per source (the
   compiler's ``-Xptxas -v`` report is printed).
2. Holds each kernel against its plain PyTorch twin on the card at the
   shapes of the main paths (Conformer-M; B=16, 30 s clips, targets of
   100 tokens; and B=4, 120 s clips, targets of 400 tokens), with mixed
   lengths, and times both with CUDA events after warm-up.  The CTC
   kernels are also read against the same recursions in float64.  Beside each
   time it works out the least time the card could take for the same work
   (bytes over the memory rate against operations over the peak rate) and,
   where one PyTorch call computes the same function, times that call.
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
5. Long-form training path: the same train step on B=4 clips of 120 s
   (T'=938), where ``attention_impl='auto'`` sends the encoder's attention
   through the flash kernels forward and backward.  One float32 step,
   kernel path vs plain path; then bfloat16 steps timed and counted, every
   gradient finite and non-zero, the loss falling over 10 steps, one step
   under ``remat`` (the attention forward then runs twice per block), and
   the peak memory of the einsum route at the same shape beside the kernel
   route's.
6. Prints one JSON line with each kernel's numbers, then, as the last line,
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
LONG_BATCH, LONG_SECONDS, LONG_TARGET_LEN = 4, 120.0, 400  # the long-form step: T'=938, S=801
T_SUB, LONG_T_SUB = 235, 938  # frames after subsampling; check_train holds them to the model's own count
# Peaks of one H100 SXM (NVIDIA's data sheet, dense): device memory 3.35 TB/s,
# 989 TFLOP/s in bf16 on the tensor cores, 67 TFLOP/s in float32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, torch.float32: 67e12}
TOL = {
    "stft_logmel": 1e-3, "attention_f32": 1e-4, "attention_bf16": 2e-2, "lstm": 1e-4,
    # lse and the attention backward in float32, absolute, as the JAX package
    # holds its Pallas backward; the bf16 gradients by `bf16_bar`
    "attention_bwd_f32": 5e-4,
    "lstm_backward": 1e-4,  # dxw, absolute
    "lstm_weight_grad": 1e-4,  # dW_hh, relative to its largest entry
    "ctc_alpha": 1e-5,  # ll, relative
    # demit, absolute; posteriors exp(α + β - ll) are formed from log-space
    # values of ~1.5e3 at T=235, where one float32 ulp is 1.2e-4
    "ctc_beta": 5e-4,
    "ctc_witness_loss": 1e-5,  # against torch's own CTC, relative
    # demit against the float64 recursions and the logit gradient against torch's CTC in float64, absolute,
    # by T': a posterior is exp(α + β − ll) of float32 sums that grow with T' and round at every frame.
    # About three times the H100's readings: 9.5e-4 at 235 frames and 6.1e-3 at 938, where torch's own
    # float32 CTC reads 9.7e-4 and 6.3e-3 and autograd through the plain recursion 3.4e-4 and 3.8e-4
    "ctc_float64": {235: 3e-3, 938: 2e-2},
}
SLICE_LOGPROB_TOL, SLICE_ID_AGREEMENT = 2e-3, 0.999
# float32 train step, kernel path vs plain path
TRAIN_TOL = {
    # the gradients of the two CTC implementations differ by ~1e-4 relative
    # (float32 posteriors at T=235), so the norm is held as the gradients are
    "loss": 1e-5, "grad_norm": 1e-3, "grad": 1e-3, "batch_stats": 1e-4,
    # at T'=938 the CTC kernels' float32 posteriors lie 6.4 times further from float64 than at 235 (the
    # "ctc_float64" readings above) while the plain path's CTC does not move, and every gradient
    # inherits that: the worst gradient read 1.44e-3 there against 3.1e-4 at 235
    "grad_long": 4e-3,
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


def bf16_bar(ref: torch.Tensor) -> float:
    """The bar for a bf16 gradient whose sums are float32 and which is
    rounded once at the end: one bf16 ulp at the reference's largest entry
    (2^-7 of it), and never below the float32 bar."""
    return max(2.0 ** -7 * ref.abs().max().item(), TOL["attention_bwd_f32"])


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def numbers(err: float, ms: float, plain_ms: float, moved_bytes: float, flops: float, dtype: torch.dtype,
            library_ms=None) -> dict:
    """One kernel's measured numbers beside its bound: the larger of the
    bytes it must move (inputs read once, outputs written once) over the
    memory rate and its operations over the peak rate for ``dtype``."""
    by_bytes, by_ops = moved_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations", library_ms=library_ms)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


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
        "attention_relpos_lse": A.flash_relpos_attention_forward_lse,
        "attention_relpos_bwd_dq": A.flash_relpos_attention_bwd_dq,
        "attention_relpos_bwd_dkv": A.flash_relpos_attention_bwd_dkv,
        "attention_relpos_bwd_dband": A.flash_relpos_attention_bwd_dband,
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


def check_kernels(card: str, b: int, seconds: float, t: int, inference_attention: bool) -> dict:
    """The log-mel and LSTM-forward kernels against their plain twins at the
    shapes of one main path (``b`` clips of ``seconds``, ``t`` frames
    after subsampling), and the inference attention forward where that
    path runs it."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import stft_logmel as S

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    results = {}

    # -- stft_logmel: (16, 480000) f32 → (16, 938, 40); (4, 1920000) → (4, 3751, 40)
    cfg = FeatureConfig()
    n_samples = int(seconds * cfg.sample_rate)
    audio = (torch.randn(b, n_samples, generator=gen) * 0.1).to(dev)
    got, ref = S.stft_logmel(audio, cfg), S.stft_logmel_plain(audio, cfg)
    torch.cuda.synchronize()
    check(got.shape == ref.shape == (b, cfg.num_frames(n_samples), cfg.n_mels),
          f"stft_logmel shape {tuple(got.shape)}")
    err = max_abs(got, ref)
    ms = cuda_ms(lambda: S.stft_logmel(audio, cfg))
    plain_ms = cuda_ms(lambda: S.stft_logmel_plain(audio, cfg))
    print(f"stft_logmel ({b}, {n_samples}) f32: max|Δ| {err:.3e} (tol {TOL['stft_logmel']}), "
          f"kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    check(err <= TOL["stft_logmel"], "stft_logmel disagrees with its plain twin")
    n_bins, frames = cfg.n_fft // 2 + 1, got.shape[1]
    # read: audio, window, the two DFT matrices, the mel filterbank; written: the log-mel.  Per frame a
    # windowed real DFT (two n_fft x n_bins products) and the mel product.  The plain version is a framed
    # cuBLAS matmul with elementwise ops around it: it doubles as the library yardstick
    stft_bytes = nbytes(audio, got) + 4 * (cfg.n_fft + 2 * cfg.n_fft * n_bins + n_bins * cfg.n_mels)
    stft_flops = b * frames * (4 * cfg.n_fft * n_bins + 2 * n_bins * cfg.n_mels)
    results["stft_logmel"] = numbers(err, ms, plain_ms, stft_bytes, stft_flops, torch.float32, library_ms=plain_ms)

    lengths = mixed_lengths(gen, b, t, t // 3)
    if inference_attention:
        # -- rel-pos attention: (16, 235, 4, 64), p (469, 4, 64)
        h, dh = 4, 64
        qu, qv, k, v = (torch.randn(b, t, h, dh, generator=gen) * 0.5 for _ in range(4))
        p = torch.randn(2 * t - 1, h, dh, generator=gen) * 0.5
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
        # 6·H·dh operations for each (query, valid key) pair; no one PyTorch call computes rel-pos attention
        pairs = t * int(lengths.sum())
        results["attention_relpos"] = numbers(err32, ms, plain_ms, nbytes(*args16[:5], args16[0]), 6 * h * dh * pairs,
                                              torch.bfloat16)

    # -- LSTM, one direction: xw (16, 235, 1280) or (4, 938, 1280) f32, w_hh (320, 1280)
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
    print(f"lstm ({b}, {t}, 4x320) f32, per direction: max|Δ| fwd {errs[0]:.3e} bwd {errs[1]:.3e} "
          f"(tol {TOL['lstm']}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    check(err <= TOL["lstm"], "lstm disagrees with its plain twin")
    # per valid step h·W_hh: 2·H·4H operations; read xw and W_hh, write h
    steps = int(lengths.sum())
    results["lstm"] = numbers(err, ms, plain_ms, nbytes(xw, w_hh) + 4 * b * t * hidden, 8 * hidden * hidden * steps,
                              torch.float32)
    return results


def check_train_kernels(card: str, b: int, t: int, target_len: int) -> dict:
    """The train path's LSTM and CTC kernels against their twins at the
    shapes of one train step: ``b`` rows of ``t`` subsampled frames and
    ``target_len`` targets."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops import ctc as TC
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import ctc as K
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 2)
    results = {}

    # -- LSTM backward + dW_hh: H=320, both directions
    hidden = 320
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
    print(f"lstm training forward ({b}, {t}, 4x320) (h, c, gates) vs twin: max|Δ| {fwd_err:.3e} (tol {TOL['lstm']}), "
          f"kernel {fms:.4f} ms  [{card}]")
    print(f"lstm_backward ({b}, {t}, 4x320) f32, per direction: dxw max|Δ| fwd {errs[1]:.3e} bwd {errs[3]:.3e} "
          f"(tol {TOL['lstm_backward']}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    print(f"lstm_weight_grad (320 x {b * t})·({b * t} x 1280) f32: dW_hh max|Δ|/max|dW| fwd {werrs[0]:.3e} "
          f"bwd {werrs[1]:.3e} (tol {TOL['lstm_weight_grad']}), kernel {wms:.4f} ms, plain {wplain_ms:.4f} ms  [{card}]")
    check(fwd_err <= TOL["lstm"], "lstm training forward disagrees with its plain twin")
    check(bwd_err <= TOL["lstm_backward"], "lstm_backward disagrees with its plain twin")
    check(max(werrs) <= TOL["lstm_weight_grad"], "lstm_weight_grad disagrees with its plain twin")
    steps = int(lengths.sum())
    results["lstm_backward"] = numbers(bwd_err, ms, plain_ms, nbytes(gout, gates, c, w_hh, dxw),
                                       8 * hidden * hidden * steps, torch.float32)
    # the plain version is one einsum (a cuBLAS GEMM): it doubles as the library yardstick
    results["lstm_weight_grad"] = numbers(max(werrs), wms, wplain_ms, nbytes(h, dxw, w_hh),
                                          8 * hidden * hidden * b * t, torch.float32, library_ms=wplain_ms)

    # -- CTC alpha/beta: S = 2·target_len + 1 states, V=1024; one row of
    #    repeated pairs, one empty label, one impossible alignment
    s = 2 * target_len + 1
    labels = torch.randint(3, VOCAB, (b, target_len), generator=gen)
    labels[1] = labels[1, : target_len // 2].repeat_interleave(2)
    label_lengths = torch.full((b,), target_len)
    label_lengths[2] = 0
    input_lengths = torch.randint(2 * target_len + 20, t + 1, (b,), generator=gen)
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
    # which float32 CTC carries what error: the kernels' demit, and the plain path's (autograd through the
    # plain alpha recursion, as ctc_impl='xla' trains), against the same recursions in float64, on the
    # rows that have an alignment
    emit64 = emit.double()
    alpha64 = K.ctc_alpha_plain(emit64, can_skip, ext_len, input_lengths)
    ll64 = K.final_ll(alpha64[:, -1], ext_len)
    demit64 = K.ctc_beta_plain(emit64, alpha64, can_skip, ext_len, input_lengths, ll64, g.double())
    leaf = emit.clone().requires_grad_(True)
    ll_auto = K.final_ll(K.ctc_alpha_plain(leaf, can_skip, ext_len, input_lengths)[:, -1], ext_len)
    (demit_auto,) = torch.autograd.grad(ll_auto, leaf, g)
    possible = ll_ref > TC.LOG_EPS / 2
    kernel64 = (demit[possible].double() - demit64[possible]).abs().max().item()
    auto64 = (demit_auto[possible].double() - demit64[possible]).abs().max().item()
    ll_err64 = ((ll[possible].double() - ll64[possible]).abs() / ll64[possible].abs()).max().item()
    tol64 = TOL["ctc_float64"][t]
    x, w = logits.clone().requires_grad_(True), logits.clone().requires_grad_(True)
    ours = K.ctc_loss_kernel(torch.log_softmax(x, -1), labels, input_lengths, label_lengths, reduction=None)
    ref = torch.nn.functional.ctc_loss(torch.log_softmax(w, -1).transpose(0, 1), labels, input_lengths,
                                       label_lengths, reduction="none", zero_infinity=True)
    (ours * g).sum().backward()
    (ref * g).sum().backward()
    witness_loss = ((ours - ref).abs() / ref.abs().clamp_min(1.0)).max().item()
    witness_grad = max_abs(x.grad, w.grad)
    w64 = logits.double().requires_grad_(True)
    ref64 = torch.nn.functional.ctc_loss(torch.log_softmax(w64, -1).transpose(0, 1), labels, input_lengths,
                                         label_lengths, reduction="none", zero_infinity=True)
    (ref64 * g).sum().backward()
    ours64, torch64 = max_abs(x.grad, w64.grad), max_abs(w.grad, w64.grad)
    check(bool(ours[3] == 0) and bool((x.grad[3] == 0).all()), "zero_infinity row not zeroed")
    ams = cuda_ms(lambda: K.ctc_alpha(emit, can_skip, ext_len, input_lengths))
    aplain_ms = cuda_ms(lambda: K.ctc_alpha_plain(emit, can_skip, ext_len, input_lengths), iters=5)
    bms = cuda_ms(lambda: K.ctc_beta(emit, alpha, can_skip, ext_len, input_lengths, ll, g))
    bplain_ms = cuda_ms(lambda: K.ctc_beta_plain(emit, alpha, can_skip, ext_len, input_lengths, ll, g), iters=5)
    print(f"ctc_alpha ({b}, {t}, {s}) f32: ll max rel|Δ| {ll_err:.3e} (tol {TOL['ctc_alpha']}), "
          f"kernel {ams:.4f} ms, plain {aplain_ms:.4f} ms  [{card}]")
    print(f"ctc_beta ({b}, {t}, {s}) f32: demit max|Δ| {demit_err:.3e} (tol {TOL['ctc_beta']}), "
          f"kernel {bms:.4f} ms, plain {bplain_ms:.4f} ms  [{card}]")
    print(f"ctc against the float64 recursions ({b}, {t}, {s}): ll max rel|Δ| {ll_err64:.3e}; demit max|Δ| of the "
          f"kernels {kernel64:.3e} (tol {tol64}), of autograd through the plain recursion {auto64:.3e}")
    print(f"ctc_loss_kernel vs torch.nn.functional.ctc_loss: loss max rel|Δ| {witness_loss:.3e} "
          f"(tol {TOL['ctc_witness_loss']}); logit-grad max|Δ| against torch's CTC in float64: the kernels "
          f"{ours64:.3e} (tol {tol64}), torch's float32 CTC {torch64:.3e}; the kernels against torch's "
          f"float32 CTC {witness_grad:.3e}")
    check(ll_err <= TOL["ctc_alpha"], "ctc_alpha disagrees with its plain twin")
    check(demit_err <= TOL["ctc_beta"], "ctc_beta disagrees with its plain twin")
    check(kernel64 <= tol64, "ctc_beta disagrees with the float64 recursion")
    check(witness_loss <= TOL["ctc_witness_loss"], "ctc loss disagrees with torch's CTC")
    check(ours64 <= tol64, "ctc gradient disagrees with torch's CTC in float64")
    # torch's own CTC as the library yardstick: its forward beside alpha, its backward beside beta
    w = torch.log_softmax(logits, -1).transpose(0, 1).contiguous().requires_grad_(True)
    lib_loss = lambda: torch.nn.functional.ctc_loss(  # noqa: E731
        w, labels, input_lengths, label_lengths, reduction="sum", zero_infinity=True)
    lib_fwd_ms = cuda_ms(lib_loss)
    loss = lib_loss()
    lib_bwd_ms = cuda_ms(lambda: torch.autograd.grad(loss, w, retain_graph=True))
    print(f"torch.nn.functional.ctc_loss at the same shape: forward {lib_fwd_ms:.4f} ms, backward {lib_bwd_ms:.4f} ms")
    # about 10 operations per (frame, state): a three-term logsumexp; alpha reads emit and writes alpha,
    # beta reads emit and alpha and writes demit
    cells = int((input_lengths.to(torch.int64) * ext_len.to(torch.int64)).sum())
    results["ctc_alpha"] = numbers((ll - ll_ref).abs().max().item(), ams, aplain_ms, nbytes(emit, alpha), 10 * cells,
                                   torch.float32, library_ms=lib_fwd_ms)
    results["ctc_beta"] = numbers(demit_err, bms, bplain_ms, nbytes(emit, alpha, demit), 10 * cells, torch.float32,
                                  library_ms=lib_bwd_ms)
    return results


def check_attention_backward_kernels(card: str) -> dict:
    """The lse forward and the dq, dkv and dband kernels against their
    plain twins, float32 and bf16, at the long-form step's shape (ragged:
    one row full, one short, one shorter than a tile) and at the 30 s
    shape; the bf16 numbers at the long-form shape go into the result."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    results = {}
    h, dh = 4, 64
    shapes = [(LONG_BATCH, 938, torch.tensor([938, 500, 20, 811], dtype=torch.int32)),
              (BATCH, 235, mixed_lengths(gen, BATCH, 235, 235 // 3))]
    for b, t, lengths in shapes:
        qu, qv, k, v, g = (torch.randn(b, t, h, dh, generator=gen) * 0.5 for _ in range(5))
        p = torch.randn(2 * t - 1, h, dh, generator=gen) * 0.5
        pairs = t * int(lengths.sum())  # (query, valid key) pairs per head
        for dtype in (torch.float32, torch.bfloat16):
            args = [x.to(dev, dtype) for x in (qu, qv, k, v, p)] + [lengths.to(dev), dh ** -0.5]
            gd = g.to(dev, dtype)
            out_ref, lse_ref = A.flash_relpos_attention_plain(*args, return_lse=True)
            out, lse = A.flash_relpos_attention_forward_lse(*args)
            ref = A.flash_relpos_attention_backward_plain(*args, out_ref, lse_ref, gd)
            delta = A.attention_delta(out_ref, gd)
            call = (*args, lse_ref, delta, gd)
            got = (*A.flash_relpos_attention_bwd_dq(*call), *A.flash_relpos_attention_bwd_dkv(*call),
                   A.flash_relpos_attention_bwd_dband(*call))
            again = A.flash_relpos_attention_bwd_dband(*call)
            torch.cuda.synchronize()
            check(torch.equal(got[4], again), "dband is not bit-equal from run to run")
            grads = ("dqu", "dqv", "dk", "dv", "dp")
            errs = {"out": max_abs(out, out_ref), "lse": max_abs(lse, lse_ref)}
            errs.update({n: max_abs(x, r) for n, x, r in zip(grads, got, ref)})
            for x in (out, lse, *got):
                check(bool(torch.isfinite(x).all()), "an attention kernel gives non-finite values")
            bf16 = dtype == torch.bfloat16
            tols = {"out": TOL["attention_bf16" if bf16 else "attention_f32"], "lse": TOL["attention_bwd_f32"]}
            tols.update({n: bf16_bar(r) if bf16 else TOL["attention_bwd_f32"] for n, r in zip(grads, ref)})
            name = str(dtype).replace("torch.", "")
            print(f"attention backward ({b}, {t}, {h}, {dh}) {name}, lengths {lengths.tolist()[:4]}…: max|Δ| (tol) "
                  + ", ".join(f"{n} {e:.3e} ({tols[n]:.1e})" for n, e in errs.items()) + "; largest entries "
                  + ", ".join(f"{n} {r.abs().max().item():.3f}" for n, r in zip(grads, ref)))
            for n, e in errs.items():
                check(e <= tols[n], f"attention {'forward with lse' if n in ('out', 'lse') else 'backward'} "
                                    f"({name}): {n} disagrees with the plain twin")

            times = {
                "lse": cuda_ms(lambda: A.flash_relpos_attention_forward_lse(*args)),
                "dq": cuda_ms(lambda: A.flash_relpos_attention_bwd_dq(*call)),
                "dkv": cuda_ms(lambda: A.flash_relpos_attention_bwd_dkv(*call)),
                "dband": cuda_ms(lambda: A.flash_relpos_attention_bwd_dband(*call)),
                "plain_fwd": cuda_ms(lambda: A.flash_relpos_attention_plain(*args, return_lse=True), iters=5),
                "plain_bwd": cuda_ms(
                    lambda: A.flash_relpos_attention_backward_plain(*args, out_ref, lse_ref, gd), iters=5),
            }

            def autograd(fn):
                leaves = [x.detach().requires_grad_(True) for x in args[:5]]
                fn(*leaves, *args[5:]).backward(gd)

            times["einsum_autograd"] = cuda_ms(lambda: autograd(A.flash_relpos_attention_plain), iters=5)
            times["kernel_autograd"] = cuda_ms(lambda: autograd(A.flash_relpos_attention), iters=5)
            print(f"  times, ms: " + ", ".join(f"{n} {x:.4f}" for n, x in times.items())
                  + f"  (plain_bwd computes all five gradients; *_autograd: forward + backward)  [{card}]")
            if (b, dtype) != (LONG_BATCH, torch.bfloat16):
                continue
            # bytes: each (B,T,H,dh) input and output once, the table, lse and delta; operations per
            # (query, valid key) pair and head: 6·dh forward, 10·dh dq, 10·dh dkv, 8·dh dband
            x, stat = nbytes(args[0]), nbytes(lse)
            work = {"lse": (5 * x + nbytes(args[4]) + stat, 6), "dq": (7 * x + nbytes(args[4]) + 2 * stat, 10),
                    "dkv": (7 * x + nbytes(args[4]) + 2 * stat, 10), "dband": (5 * x + 2 * nbytes(args[4]) + 2 * stat, 8)}
            worst = {"lse": max(errs["out"], errs["lse"]), "dq": max(errs["dqu"], errs["dqv"]),
                     "dkv": max(errs["dk"], errs["dv"]), "dband": errs["dp"]}
            for key, (moved, units) in work.items():
                full = "attention_relpos_lse" if key == "lse" else f"attention_relpos_bwd_{key}"
                results[full] = numbers(worst[key], times[key], times["plain_fwd" if key == "lse" else "plain_bwd"],
                                        moved, units * h * dh * pairs, dtype)
    return results


def make_batches(n_samples: int, batch: int = BATCH, count: int = N_BATCHES + 1):
    """``count`` padded batches of synthetic audio (tones + noise) with
    mixed lengths; batch 0 doubles as the warm-up."""
    gen = torch.Generator().manual_seed(SEED + 1)
    times = torch.arange(n_samples) / 16000.0
    batches = []
    for _ in range(count):
        freqs = 100.0 + 3000.0 * torch.rand(batch, 3, 1, generator=gen)
        audio = torch.sin(2 * np.pi * freqs * times).sum(dim=1) * 0.1
        audio += 0.05 * torch.randn(batch, n_samples, generator=gen)
        lengths = mixed_lengths(gen, batch, n_samples, n_samples // 3)
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


def check_train(card: str, batch: int, seconds: float, target_len: int, long_form: bool) -> dict:
    """The supervised train step: float32 kernel path vs plain path, then
    the bf16 step as a user runs it.  ``long_form``: the subsampled length
    is at least 768, so 'auto' trains the attention through the flash
    kernels; the einsum route's peak memory and one step under remat are
    measured too."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import (
        ATTENTION_KERNEL_MIN_T_TRAINING, FeatureConfig, OptimizerConfig, SpecAugmentConfig, conformer_m,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_augment_step, make_feature_train_step
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState
    from nn_conformer_for_speech_recognition_tpu_torch.utils.flops import peak_bf16_flops, train_step_flops

    n_samples = int(seconds * 16000)
    frames = FeatureConfig().num_frames(n_samples)
    t_sub = conformer_m().subsampled_length(frames)
    check((t_sub >= ATTENTION_KERNEL_MIN_T_TRAINING) == long_form, f"T'={t_sub} is on the wrong side of the switch")
    check(t_sub == (LONG_T_SUB if long_form else T_SUB), f"T'={t_sub}: the kernel phase ran at another length")
    what = f"B={batch}, {seconds:.0f} s clips, T'={t_sub}, {target_len} targets"
    blocks = conformer_m().encoder.num_blocks

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

    augment = make_augment_step(FeatureConfig(), SpecAugmentConfig())
    targets = torch.randint(3, VOCAB, (batch, target_len), generator=gen).cuda()

    # -- float32, kernel path vs plain path: one step from the same weights
    #    and the same (augmented) features, dropout 0
    def f32(use_pallas: bool):
        cfg = conformer_m(use_pallas=use_pallas, compute_dtype="float32")
        return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.0),
                                   decoder=dataclasses.replace(cfg.decoder, dropout=0.0))

    audio, alen = make_batches(n_samples, batch, 2)[0]
    # ragged rows that still leave room for the targets (2·L + 1 frames and a few repeats)
    alen = torch.clamp_min(alen, n_samples * 7 // 8 if long_form else n_samples // 2)
    feats, flens = augment(torch.Generator(device="cuda").manual_seed(SEED), audio, alen)
    tlen = torch.full((batch,), target_len, device="cuda")
    tlen[1], tlen[2] = 0, target_len // 3
    lr32 = OptimizerConfig().learning_rate

    def one_step(use_pallas: bool, ctc_impl: str):
        state, step = trainer(f32(use_pallas), lr32, ctc_impl)
        before = {n: p.detach().clone() for n, p in state.model.named_parameters()}
        reset_counters()
        state, metrics = step(state, feats, flens, targets, tlen)
        return state.model, metrics, before, read_counters()

    def compare(kernel_run, plain_run) -> None:
        (mk, met_k, before, _), (mp, met_p, _, _) = kernel_run, plain_run
        grad_tol = TRAIN_TOL["grad_long" if long_form else "grad"]
        loss_err = abs(met_k["loss"].item() - met_p["loss"].item()) / abs(met_p["loss"].item())
        norm_err = abs(met_k["grad_norm"].item() - met_p["grad_norm"].item()) / met_p["grad_norm"].item()
        params_p = dict(mp.named_parameters())
        # updates: Adafactor normalises each row and column of a gradient (and
        # moves an unfactored entry by ±0.1·lr on the first step), so an entry
        # whose gradient is at noise level takes a full-size step of
        # noise-determined direction on either path; the update is held on the
        # entries whose gradient is clear of 0 by 1e-3 of the tensor's largest
        grad_err, worst, step_err = 0.0, "", 0.0
        noisy = total = 0
        for name, pk in mk.named_parameters():
            pp = params_p[name]
            err = relative_error(pk.grad, pp.grad)
            if err > grad_err:
                grad_err, worst = err, name
            dk, dp = pk.detach() - before[name], pp.detach() - before[name]
            clear = pp.grad.abs() > 1e-3 * pp.grad.abs().max()
            step_err = max(step_err, max_abs(dk[clear], dp[clear]) / dp.abs().max().item())
            noisy += (~clear).sum().item()
            total += clear.numel()
        stats_p = dict(mp.named_buffers())
        stats_err = max(max_abs(b, stats_p[n]) for n, b in mk.named_buffers())
        print(f"train step f32 ({what}), kernel vs plain path: loss {met_k['loss'].item():.6f} vs "
              f"{met_p['loss'].item():.6f} (rel {loss_err:.3e}, tol {TRAIN_TOL['loss']}), grad norm rel {norm_err:.3e} "
              f"(tol {TRAIN_TOL['grad_norm']}), worst gradient max|Δ|/max|g| {grad_err:.3e} in {worst} (tol {grad_tol:.1e}), "
              f"batch stats max|Δ| {stats_err:.3e} (tol {TRAIN_TOL['batch_stats']}); updates at lr {lr32}: "
              f"max|Δ|/max|step| {step_err:.3e} (tol {TRAIN_TOL['step']}) on the {total - noisy}/{total} entries "
              f"whose gradient is clear of 0")
        check(loss_err <= TRAIN_TOL["loss"], "f32 train-step loss disagrees")
        check(norm_err <= TRAIN_TOL["grad_norm"], "f32 gradient norm disagrees")
        check(grad_err <= grad_tol, "f32 gradients disagree")
        check(stats_err <= TRAIN_TOL["batch_stats"], "f32 batch statistics disagree")
        check(step_err <= TRAIN_TOL["step"], "f32 updated parameters disagree")

    kernel_run, plain_run = one_step(True, "auto"), one_step(False, "xla")
    check(not any(plain_run[3].values()), f"the plain path launched a kernel: {plain_run[3]}")
    check((kernel_run[3]["attention_relpos_bwd_dq"] == blocks) == long_form, f"f32 kernel path launches: {kernel_run[3]}")
    compare(kernel_run, plain_run)
    del kernel_run, plain_run

    # -- bf16, as a user runs it: augment, then the train step; full-length
    #    clips, the same count of targets in every row
    cfg16 = conformer_m(use_pallas=True)  # compute 'auto': bfloat16 on CUDA
    audio = make_batches(n_samples, batch, 2)[1][0]
    alen = torch.full((batch,), n_samples, device="cuda")
    tlen = torch.full((batch,), target_len, device="cuda")

    def run_steps(cfg, lr: float, warmup: int, n: int):
        """``n`` user steps after ``warmup``: (state, seconds per step, launches, peak bytes, losses)."""
        state, step = trainer(cfg, lr)
        losses = []
        for i in range(warmup + n):
            if i == warmup:
                torch.cuda.synchronize()
                reset_counters()
                torch.cuda.reset_peak_memory_stats()
                t0 = time.perf_counter()
            f, fl = augment(state.generator, audio, alen)
            state, metrics = step(state, f, fl, targets, tlen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / n
        return state, dt, read_counters(), torch.cuda.max_memory_allocated(), [x.item() for x in losses]

    state, dt, launches, peak, losses = run_steps(cfg16, OptimizerConfig().learning_rate, 2, N_TRAIN_STEPS)
    for name, p in state.model.named_parameters():
        check(p.grad is not None and bool(torch.isfinite(p.grad).all()) and p.grad.abs().max().item() > 0,
              f"bf16 train step: gradient of {name} is missing, non-finite or zero")
    check(bool(np.isfinite(losses).all()), "bf16 train-step loss is not finite")
    flops = train_step_flops(cfg16, VOCAB, batch, frames)
    mfu = flops / dt / peak_bf16_flops(torch.cuda.get_device_name(0))
    print(f"bf16 train step ({what}, Adafactor lr {OptimizerConfig().learning_rate}): {dt * 1e3:.2f} ms/step over "
          f"{N_TRAIN_STEPS} steps, {batch * seconds / dt:.1f} audio-s/s, MFU {mfu:.4%} of the card's dense bf16 peak "
          f"({flops / 1e12:.3f} model TFLOP/step), peak memory {peak / 2**20:.1f} MiB  [{card}]")
    print(f"launch counts over {N_TRAIN_STEPS} bf16 train steps: {launches}")
    n, attn = N_TRAIN_STEPS, blocks * N_TRAIN_STEPS if long_form else 0
    expected = {"stft_logmel": n, "attention_relpos": 0, "lstm": 2 * n, "lstm_backward": 2 * n,
                "lstm_weight_grad": 2 * n, "ctc_alpha": n, "ctc_beta": n, "attention_relpos_lse": attn,
                "attention_relpos_bwd_dq": attn, "attention_relpos_bwd_dkv": attn, "attention_relpos_bwd_dband": attn}
    check(launches == expected, f"train-step launch counts, want {expected}")
    del state

    # -- the loss falls over 10 steps on one repeated batch
    _, _, _, _, losses = run_steps(cfg16, LOSS_LR, 0, LOSS_STEPS + 1)
    print(f"bf16 loss on a repeated batch at lr {LOSS_LR}: " + " ".join(f"{x:.3f}" for x in losses))
    check(losses[-1] < losses[0], f"the loss did not fall in {LOSS_STEPS} steps")
    if not long_form:
        return launches

    # -- under remat each block's forward runs again in the backward: the
    #    attention forward is launched twice per block, each backward once
    _, dt_remat, count, peak_remat, _ = run_steps(dataclasses.replace(cfg16, remat=True), lr32, 1, 2)
    print(f"bf16 train step under remat ({what}): {dt_remat * 1e3:.2f} ms/step, peak memory "
          f"{peak_remat / 2**20:.1f} MiB, launches over 2 steps {count}  [{card}]")
    check(count == {k: (2 * v if k == "attention_relpos_lse" else v) * 2 // n for k, v in expected.items()},
          "launch counts under remat")
    # -- the einsum route at the same shape (attention_impl='xla'): its T² tensors in memory
    _, dt_einsum, count, peak_einsum, _ = run_steps(dataclasses.replace(cfg16, attention_impl="xla"), lr32, 1, 2)
    check(not any(v for k, v in count.items() if k.startswith("attention")), "the einsum route launched attention")
    print(f"bf16 train step on the einsum route ({what}, attention_impl='xla', probability dropout): "
          f"{dt_einsum * 1e3:.2f} ms/step, peak memory {peak_einsum / 2**20:.1f} MiB against "
          f"{peak / 2**20:.1f} MiB on the kernel route  [{card}]")
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
    # every kernel at the shapes of both train steps; the 30 s numbers go into the kernels line
    results = check_kernels(card, BATCH, SECONDS, T_SUB, inference_attention=True)
    results.update(check_train_kernels(card, BATCH, T_SUB, TARGET_LEN))
    check_kernels(card, LONG_BATCH, LONG_SECONDS, LONG_T_SUB, inference_attention=False)
    check_train_kernels(card, LONG_BATCH, LONG_T_SUB, LONG_TARGET_LEN)
    results.update(check_attention_backward_kernels(card))
    serve = check_slice(card)
    train = check_train(card, BATCH, SECONDS, TARGET_LEN, long_form=False)
    long_train = check_train(card, LONG_BATCH, LONG_SECONDS, LONG_TARGET_LEN, long_form=True)
    pallas = "ops/pallas"
    sources = {
        "stft_logmel": ("csrc/stft_logmel.cu", f"{pallas}/stft_logmel.py:74"),
        "attention_relpos": ("csrc/attention_relpos.cu", f"{pallas}/attention.py:281"),
        "lstm": ("csrc/lstm.cu", f"{pallas}/lstm.py:69"),
        "lstm_backward": ("csrc/lstm.cu", f"{pallas}/lstm.py:107"),
        "lstm_weight_grad": ("csrc/lstm.cu", f"{pallas}/lstm.py:159"),
        "ctc_alpha": ("csrc/ctc.cu", f"{pallas}/ctc.py:57"),
        "ctc_beta": ("csrc/ctc.cu", f"{pallas}/ctc.py:95"),
        "attention_relpos_lse": ("csrc/attention_relpos.cu", f"{pallas}/attention.py:281"),
        "attention_relpos_bwd_dq": ("csrc/attention_relpos_bwd.cu", f"{pallas}/attention.py:530"),
        "attention_relpos_bwd_dkv": ("csrc/attention_relpos_bwd.cu", f"{pallas}/attention.py:559"),
        "attention_relpos_bwd_dband": ("csrc/attention_relpos_bwd.cu", f"{pallas}/attention.py:590"),
    }
    paths = (serve, train, long_train)
    print("launches, pseudo-label pass + 30 s train steps + long-form train steps: "
          f"{ {k: tuple(path[k] for path in paths) for k in sources} }")
    for name in sources:
        check(sum(path[name] for path in paths) > 0, f"no main path launched {name}")
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"nn_conformer_for_speech_recognition_tpu_torch/{src}",
            "replaces": f"nn_conformer_for_speech_recognition_tpu/{tpu}",
            "launches": sum(path[name] for path in paths),
            **results[name],
        }
        for name, (src, tpu) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
