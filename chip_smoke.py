#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port once on one NVIDIA GPU and checks its kernels.

Run from the root of a checkout:  python3 chip_smoke.py

1. Prints the card's name and power limit, then builds the hand-written
   kernels from ``csrc/`` with nvcc, one process per source (the
   compiler's ``-Xptxas -v`` report is printed).
2. Holds each kernel against its plain PyTorch twin on the card at the
   shapes of the main paths (Conformer-M; B=16, 30 s clips, targets of
   100 tokens; B=4, 120 s clips, targets of 400 tokens; and the two
   buckets of the Noisy Student phase, B=16 clips of 1.8 s and 3.6 s,
   T'=14 and 28, targets of 8 tokens), with mixed lengths, and times both
   with CUDA events after warm-up.  The CTC
   kernels are also read against the same recursions in float64.  Beside each
   time it works out the least time the card could take for the same work
   (bytes over the memory rate against operations over the peak rate) and,
   where one PyTorch call computes the same function, times that call (for
   the LSTM recurrences, cuDNN's LSTM on a packed sequence).
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
6. The configuration whose depthwise conv is the hand-written kernel
   (``conformer_m(use_pallas=True, conv_impl='pallas')``): the kernel
   against its twin (forward and the gradient with respect to x, float32
   and bfloat16, K = 33 and an even K, at both train shapes and at the
   Noisy Student phase's) beside one ``conv1d(groups=C)`` call; then the
   pseudo-label pass and the 30 s train step of phases 3 and 4 again under
   that configuration, each against the plain path from the same weights,
   timed and counted beside the 'auto' ones, one step under ``remat``, and
   the float32 step against the plain path at the Noisy Student phase's
   longer bucket.
7. One Noisy Student generation through ``Trainer`` and ``run_nst`` under
   that configuration at Conformer-M's full width and depth in bfloat16: a
   synthetic corpus written to a temporary directory, manifests,
   vocabulary, four bucketed datasets, supervised training until the
   decodes are words, then ``run_nst``: a supervised epoch with SpecAugment
   and validation, pseudo-labels for the unlabelled split, the filter, the
   mix manifest (which must hold kept clips under the teacher's labels),
   the retrain on it, checkpoints with cursors.  Then the trained weights
   in float32 through ``Trainer.evaluate`` and ``generate_labels``, kernel
   path against plain path; the generation's checkpoint restored into a
   fresh trainer; and a mid-epoch kill resumed.  Stage times are taken
   from outside the trainer, each between two waits for the card.
8. The bias-input flash attention (``ops/cuda/attention.flash_attention``,
   the one kernel no model routes through, in the port as in the JAX
   package): the kernel against its twin at the encoder's shapes
   (16,235,4,64) and (4,938,4,64) and at the Noisy Student buckets' T'=14
   and 28, float32 and bfloat16 (bias bfloat16 and float32), beside one
   ``F.scaled_dot_product_attention`` call with the bias as its mask; then
   its own path, the public op on a Conformer-M block's tensors with
   ``bias = rel_shift(qv·pᵀ)``, forward in bfloat16 and forward + backward
   in float32, counted, held to the rel-pos kernel on the same tensors and
   to autograd through the twin, with both routes' times and bytes.
9. Beam-search evaluation at full width: ``make_eval_beam_step`` on
   Conformer-M (bfloat16, vocabulary 1024, B=16 × 30 s, beam 8, prune 16,
   64 labels) beside the greedy ``make_eval_step``; the card's hypotheses
   against the same search on the CPU from the same float32 log-probs, and
   each 1-best score against the greedy path's.
10. The command line, in process, on a synthetic corpus in a temporary
   directory: ``train`` at Conformer-M width, ``train --resume``, ``eval``
   greedy and beam from the saved checkpoint (held to `Trainer.evaluate`
   on the same weights), ``nst --generations 1``, and ``parity --tiny`` in
   both protocols.
11. Repeatability: the same ten bf16 train steps (the Noisy Student
   corpus through ``Trainer.train``, Conformer-M, ``conv_impl='pallas'``)
   from one seed in two fresh processes (``multiprocessing``'s spawn, each
   with its own CUDA context), losses and final parameters compared bit for bit
   and the first stage whose bits differ named; then each step group's op
   twice on the same inputs in this process (SpecAugment, the subsampling
   convs, the gather behind the CTC loss, ``lstm_dwhh``, Adafactor).
12. Prints one JSON line with each kernel's numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  There is no CPU path: without a
CUDA device the script exits non-zero before printing any result.
"""

import contextlib
import dataclasses
import io
import json
import multiprocessing
import os
import subprocess
import sys
import tempfile
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
# The Noisy Student phase: a synthetic corpus of ten words, up to 8 an utterance (0.4 s a word, gaps of 0.05 s),
# two length buckets; its batches are (16, 28400) and (16, 56800) samples, T' = 14 and 28, at most 8 targets
NST_WORDS = ["yes", "no", "go", "stop", "left", "right", "up", "down", "on", "off"]
NST_TRAIN, NST_VAL, NST_UNLABELED, NST_BATCH, NST_MAX_WORDS, NST_LR = 128, 32, 128, 16, 8, 1e-3
NST_LONGEST = int(16000 * (0.4 * NST_MAX_WORDS + 0.05 * (NST_MAX_WORDS - 1)))
NST_BUCKETS = ((NST_LONGEST // 2, 14), (NST_LONGEST, 28))  # (samples, frames after subsampling)
NST_PRETRAIN_EPOCHS = 20  # supervised epochs before the generation, so that the teacher's decodes are words
NST_EVAL_LOSS_TOL = 1e-4  # float32 validation loss, kernel path vs plain path, relative
KERNEL_SHAPES_CHECKED = set()  # (rows, frames after subsampling) at which the kernel phases ran
# Peaks of one H100 SXM (NVIDIA's data sheet, dense): device memory 3.35 TB/s,
# 989 TFLOP/s in bf16 on the tensor cores, 495 TFLOP/s in TF32 on them, 67 TFLOP/s in float32 outside them
HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {torch.bfloat16: 989e12, "tf32": 495e12, torch.float32: 67e12}
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
    # at the Noisy Student phase's 14 and 28 frames the bar of 235 frames holds a fortiori
    "ctc_float64": {14: 3e-3, 28: 3e-3, 235: 3e-3, 938: 2e-2},
    # unit-variance inputs, taps of variance 1/K: at most 33 float32 multiply-adds in the twin's order
    # (fused in the kernel); in bfloat16 both sum in float32 and round once, so `bf16_bar` with this floor
    "depthwise_conv_f32": 1e-5,
}
SLICE_LOGPROB_TOL, SLICE_ID_AGREEMENT = 2e-3, 0.999
# Beam-search evaluation: width, candidates a frame, label room.  The head of the seeded model is calibrated to speak
# as a trained CTC model does (log-probs spread by BEAM_LOGIT_STD over the vocabulary, the blank lifted by
# BEAM_BLANK_BIAS so that it wins most frames): on a flat distribution no hypothesis stands out and a row's greedy
# path alone would need more labels than there is room for
BEAM, PRUNE, MAX_LABEL_LEN, BEAM_LOGIT_STD, BEAM_BLANK_BIAS = 8, 16, 64, 4.0, 20.0
# card vs CPU from the same float32 log-probs: a score is a chain of 235 float32 logaddexp steps in two libraries'
# exp and log1p.  Held to 1e-3 absolute; where a score's magnitude passes 1e2 (one float32 ulp there is 8e-6 and
# grows with it) to 1e-5 of the score, as the CPU tests hold it to JAX's: the larger of the two
BEAM_SCORE_ATOL, BEAM_SCORE_RTOL, BEAM_ROWS_MAY_DIFFER = 1e-3, 1e-5, 0.01
# the command-line phase: epochs of the first `train`, and of the resumed one
CLI_EPOCHS, CLI_RESUME_EPOCHS = 2, 3
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


def device_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    """Mean milliseconds per call of the card's own work: CUDA events around
    ``iters`` calls queued behind a kernel that keeps the card busy (~20 ms)
    while the host queues them, so that the calls run back to back and the
    host's share, which `cuda_ms` reads when launches and not kernels set the
    pace, drops out.  ``fn`` must not wait for the card."""
    for _ in range(warmup):
        fn()
    start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
    torch.cuda.synchronize()
    torch.cuda._sleep(40_000_000)
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / iters


def max_abs(a: torch.Tensor, b: torch.Tensor) -> float:
    return (a.float() - b.float()).abs().max().item()


def bf16_bar(ref: torch.Tensor, floor: float = TOL["attention_bwd_f32"]) -> float:
    """The bar for a bf16 result whose sums are float32 and which is
    rounded once at the end: one bf16 ulp at the reference's largest entry
    (2^-7 of it), and never below the float32 bar ``floor``."""
    return max(2.0 ** -7 * ref.abs().max().item(), floor)


def check(cond: bool, what: str) -> None:
    if not cond:
        raise RuntimeError(f"chip_smoke: {what}")


def numbers(err: float, ms: float, plain_ms: float, moved_bytes: float, flops: float, dtype,
            library_ms=None) -> dict:
    """One kernel's measured numbers beside its bound: the larger of the
    bytes it must move (inputs read once, outputs written once) over the
    memory rate and its operations over the peak rate for ``dtype`` (a key
    of `PEAK_FLOPS`)."""
    by_bytes, by_ops = moved_bytes / HBM_BYTES_PER_S * 1e3, flops / PEAK_FLOPS[dtype] * 1e3
    return dict(max_abs_err=err, ms=ms, plain_ms=plain_ms, bound_ms=max(by_bytes, by_ops),
                bound_by="bytes" if by_bytes >= by_ops else "operations", library_ms=library_ms)


def nbytes(*tensors) -> int:
    return sum(t.numel() * t.element_size() for t in tensors)


def counters() -> dict:
    """Each kernel's wrapper, whose ``launches`` it bumps per launch."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import ctc as K
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import depthwise_conv as D
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
        "depthwise_conv": D.depthwise_conv1d_forward,
        "attention_bias": A.flash_attention_forward,
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
    n_samples = round(seconds * cfg.sample_rate)
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
        print(f"attention_relpos ({b}, {t}, {h}, {dh}): f32 max|Δ| {err32:.3e} (tol {TOL['attention_f32']}), "
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
    cudnn = cudnn_lstm_ms(b, t, hidden, lengths, gen)
    print(f"lstm ({b}, {t}, 4x320) f32, per direction: max|Δ| fwd {errs[0]:.3e} bwd {errs[1]:.3e} "
          f"(tol {TOL['lstm']}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms; cuDNN's LSTM, one direction on the packed "
          f"sequence (input projection included): forward {cudnn['forward']:.4f} ms, backward {cudnn['backward']:.4f} ms, "
          f"forward + backward {cudnn['both']:.4f} ms  [{card}]")
    check(err <= TOL["lstm"], "lstm disagrees with its plain twin")
    # per valid step h·W_hh: 2·H·4H operations; read xw and W_hh, write h
    steps = int(lengths.sum())
    results["lstm"] = numbers(err, ms, plain_ms, nbytes(xw, w_hh) + 4 * b * t * hidden, 8 * hidden * hidden * steps,
                              torch.float32, library_ms=cudnn["forward"])
    return results


def cudnn_lstm_ms(b: int, t: int, hidden: int, lengths: torch.Tensor, gen: torch.Generator) -> dict:
    """The yardstick of the LSTM recurrence kernels (the port never calls
    it): cuDNN's LSTM through ``nn.LSTM``, one direction, float32, on a
    packed sequence at the same lengths, with the BiLSTM's input width, so
    it also computes the input projection x·W_ih that the kernels are handed
    done.  Its forward alone, its backward alone (``autograd.grad`` on the
    forward's graph, kept), and a forward with its backward."""
    from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence

    from nn_conformer_for_speech_recognition_tpu_torch.config import conformer_m

    width = conformer_m().decoder.projection_dim
    layer = torch.nn.LSTM(width, hidden, batch_first=True).cuda()
    x = pack_padded_sequence(torch.randn(b, t, width, generator=gen).cuda(), lengths.cpu(), batch_first=True,
                             enforce_sorted=False)
    data = x.data.requires_grad_(True)  # the packed input as the leaf: each forward starts a graph of its own
    packed = PackedSequence(data, x.batch_sizes, x.sorted_indices, x.unsorted_indices)
    leaves = [data, *layer.parameters()]
    out = layer(packed)[0].data
    g = torch.randn(out.shape, generator=gen).cuda()

    def both():
        torch.autograd.grad(layer(packed)[0].data, leaves, g)

    return {"forward": cuda_ms(lambda: layer(packed)),
            "backward": cuda_ms(lambda: torch.autograd.grad(out, leaves, g, retain_graph=True)),
            "both": cuda_ms(both)}


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
    KERNEL_SHAPES_CHECKED.add((b, t))

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
    again = [L.lstm_weight_grad(h, dxw, reverse=True) for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(*again), "lstm_weight_grad is not bit-equal from launch to launch")
    wms = cuda_ms(lambda: L.lstm_weight_grad(h, dxw, reverse=True))
    wplain_ms = cuda_ms(lambda: L.lstm_weight_grad_plain(h, dxw, True))
    wdev = device_ms(lambda: L.lstm_weight_grad(h, dxw, reverse=True))
    wplain_dev = device_ms(lambda: L.lstm_weight_grad_plain(h, dxw, True))
    cudnn = cudnn_lstm_ms(b, t, hidden, lengths, gen)
    fms = cuda_ms(lambda: L.lstm_forward(xw, w_hh, lengths, reverse=True, save=True))
    print(f"lstm training forward ({b}, {t}, 4x320) (h, c, gates) vs twin: max|Δ| {fwd_err:.3e} (tol {TOL['lstm']}), "
          f"kernel {fms:.4f} ms  [{card}]")
    print(f"lstm_backward ({b}, {t}, 4x320) f32, per direction: dxw max|Δ| fwd {errs[1]:.3e} bwd {errs[3]:.3e} "
          f"(tol {TOL['lstm_backward']}), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    print(f"lstm_weight_grad (320 x {b * t})·({b * t} x 1280) f32: dW_hh max|Δ|/max|dW| fwd {werrs[0]:.3e} "
          f"bwd {werrs[1]:.3e} (tol {TOL['lstm_weight_grad']}), two launches bit-equal, kernel {wms:.4f} ms "
          f"({L.dwhh_plan(b * t, hidden, torch.cuda.get_device_properties(0).multi_processor_count)[0]} slices), "
          f"plain (the float32 einsum) {wplain_ms:.4f} ms; device time (calls queued back to back): kernel and reduce "
          f"{wdev:.4f} ms, einsum {wplain_dev:.4f} ms  [{card}]")
    print(f"cuDNN's LSTM at ({b}, {t}, 320), one direction (its backward also gives dx and dW_ih): forward "
          f"{cudnn['forward']:.4f} ms, backward {cudnn['backward']:.4f} ms, forward + backward {cudnn['both']:.4f} ms  [{card}]")
    check(fwd_err <= TOL["lstm"], "lstm training forward disagrees with its plain twin")
    check(bwd_err <= TOL["lstm_backward"], "lstm_backward disagrees with its plain twin")
    check(max(werrs) <= TOL["lstm_weight_grad"], "lstm_weight_grad disagrees with its plain twin")
    steps = int(lengths.sum())
    results["lstm_backward"] = numbers(bwd_err, ms, plain_ms, nbytes(gout, gates, c, w_hh, dxw),
                                       8 * hidden * hidden * steps, torch.float32, library_ms=cudnn["backward"])
    # the plain version is one einsum (a cuBLAS GEMM): it doubles as the library yardstick.  Bytes: h and dxw
    # read once, dW_hh written once; 2·H·4H operations a row, done three times (the 3×TF32 split that keeps
    # float32's accuracy on the tensor cores) at the TF32 rate
    results["lstm_weight_grad"] = numbers(max(werrs), wms, wplain_ms, nbytes(h, dxw, w_hh),
                                          3 * 8 * hidden * hidden * b * t, "tf32", library_ms=wplain_ms)

    # -- CTC alpha/beta: S = 2·target_len + 1 states, V=1024; one row of
    #    repeated pairs, one empty label, one impossible alignment
    s = 2 * target_len + 1
    labels = torch.randint(3, VOCAB, (b, target_len), generator=gen)
    labels[1] = labels[1, : target_len // 2].repeat_interleave(2)
    label_lengths = torch.full((b,), target_len)
    label_lengths[2] = 0
    # ragged rows that leave room for the targets and their repeats (row 1 needs a blank between each of its
    # target_len // 2 pairs); row 3 is shorter than its targets
    low, need = 2 * target_len + 20, target_len + target_len // 2
    input_lengths = torch.randint(low if low <= t else (need + t) // 2, t + 1, (b,), generator=gen)
    input_lengths[0], input_lengths[3] = t, 60 if target_len > 60 else target_len // 2
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


def check_depthwise_conv_kernel(card: str) -> dict:
    """The depthwise conv against its twin at the conv module's shapes in
    both train steps and in the Noisy Student phase's two buckets, where a
    row is shorter than the kernel's 64-row tile and than its 33 taps
    (C = 2 · d_model = 512): forward and dx (the same
    kernel on the gradient, taps reversed, pads swapped), float32 and bf16,
    K = 33 and an even K.  The bf16 numbers at (16, 235, 512), K = 33, go
    into the result, beside ``conv1d(groups=C)`` with its pad and two
    transposes, as the 'auto' route runs it."""
    import torch.nn.functional as F

    from nn_conformer_for_speech_recognition_tpu_torch.models.layers import same_padding
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import depthwise_conv as D

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 5)
    c, result = 512, None
    for b, t in ((BATCH, T_SUB), (LONG_BATCH, LONG_T_SUB), *((NST_BATCH, frames) for _, frames in NST_BUCKETS)):
        for k in (33, 32):
            x32, g32 = (torch.randn(b, t, c, generator=gen).to(dev) for _ in range(2))
            w32 = (torch.randn(k, c, generator=gen) * k ** -0.5).to(dev)
            pad_hi = k - 1 - (k - 1) // 2
            for dtype in (torch.float32, torch.bfloat16):
                x, g, w = x32.to(dtype), g32.to(dtype), w32.to(dtype)
                out, ref = D.depthwise_conv1d(x, w), D.depthwise_conv1d_plain(x, w)
                dx = D.depthwise_conv1d_forward(g, w, pad_lo=pad_hi, reverse_taps=True)
                leaf = x.clone().requires_grad_(True)
                (dx_ref,) = torch.autograd.grad(D.depthwise_conv1d_plain(leaf, w), leaf, g)
                torch.cuda.synchronize()
                check(out.shape == x.shape and out.dtype == dtype, "depthwise_conv output shape or type")
                floor = TOL["depthwise_conv_f32"]
                tols = (bf16_bar(ref, floor), bf16_bar(dx_ref, floor)) if dtype == torch.bfloat16 else (floor, floor)
                errs = (max_abs(out, ref), max_abs(dx, dx_ref))
                name = str(dtype).replace("torch.", "")
                ms = cuda_ms(lambda: D.depthwise_conv1d_forward(x, w))
                dx_ms = cuda_ms(lambda: D.depthwise_conv1d_forward(g, w, pad_lo=pad_hi, reverse_taps=True))
                plain_ms = cuda_ms(lambda: D.depthwise_conv1d_plain(x, w), iters=5)
                dw_ms = cuda_ms(lambda: D.depthwise_conv1d_weight_grad(x, g, k), iters=5)
                weight = w.t().unsqueeze(1).contiguous()  # (C, 1, K), the library route's parameter

                def library():
                    h = F.pad(x.transpose(1, 2), same_padding(t, k, 1))
                    return F.conv1d(h, weight, groups=c).transpose(1, 2)

                lib_err = max_abs(library(), ref)
                library_ms = cuda_ms(library)
                print(f"depthwise_conv ({b}, {t}, {c}) K={k} {name}: max|Δ| out {errs[0]:.3e} (tol {tols[0]:.1e}), "
                      f"dx {errs[1]:.3e} (tol {tols[1]:.1e}); kernel {ms:.4f} ms, dx by the same kernel {dx_ms:.4f} ms, "
                      f"plain {plain_ms:.4f} ms, conv1d(groups={c}) with pad and transposes {library_ms:.4f} ms "
                      f"(max|Δ| to the twin {lib_err:.3e}), dw by unfold + einsum {dw_ms:.4f} ms  [{card}]")
                check(errs[0] <= tols[0], f"depthwise_conv ({name}, K={k}) disagrees with its plain twin")
                check(errs[1] <= tols[1], f"depthwise_conv dx ({name}, K={k}) disagrees with autograd through the twin")
                if (b, t, k, dtype) == (BATCH, T_SUB, 33, torch.bfloat16):
                    # x read once, out written once, the taps; 2·K operations an element, done as float32
                    # multiply-adds outside the tensor cores whatever the storage type
                    result = numbers(max(errs), ms, plain_ms, nbytes(x, out, w), 2 * k * x.numel(), torch.float32,
                                     library_ms=library_ms)
    return {"depthwise_conv": result}


def key_padding(lengths: torch.Tensor, t: int, dtype: torch.dtype) -> torch.Tensor:
    """(B, 1, 1, T) additive key mask: 0 on valid keys, −1e30 beyond the length."""
    valid = torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]
    return torch.where(valid, 0.0, -1e30).to(dtype)[:, None, None, :]


def check_bias_attention_kernel(card: str) -> dict:
    """The bias-input flash attention against its twin on every query row, at
    the encoder's two shapes and the Noisy Student buckets', float32 and
    bfloat16 with a bias of either type, and beside one
    ``scaled_dot_product_attention`` call whose mask is ``bias·scale`` plus
    the key padding (a yardstick: the port never calls it).  The bias is
    drawn wide (its share of a score has spread 4·dh^-0.5 = 0.5, the qu·k
    share about 0.25) so that the softmax follows it, and bfloat16 is held
    to one bf16 ulp at the twin's largest entry: a kernel that read the bias
    wrongly, in one instantiation alone, would miss that bar, and the same
    kernel on a zeroed bias must miss it fourfold.  The bf16 numbers with a
    bf16 bias at (16, 235, 4, 64) go into the result."""
    import torch.nn.functional as F

    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 6)
    h, dh, result = 4, 64, None
    scale = dh ** -0.5
    shapes = [(BATCH, T_SUB, mixed_lengths(gen, BATCH, T_SUB, T_SUB // 3)),
              (LONG_BATCH, LONG_T_SUB, torch.tensor([938, 500, 20, 811], dtype=torch.int32)),
              *((NST_BATCH, frames, mixed_lengths(gen, NST_BATCH, frames, max(1, frames // 3))) for _, frames in NST_BUCKETS)]
    for b, t, lengths in shapes:
        qu, k, v = (torch.randn(b, t, h, dh, generator=gen) * 0.5 for _ in range(3))
        bias = torch.randn(b, h, t, t, generator=gen) * 4.0
        lengths = lengths.to(dev)
        valid = int(lengths.sum())
        for dtype, bias_dtype in ((torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                  (torch.bfloat16, torch.float32)):
            args = [x.to(dev, dtype) for x in (qu, k, v)] + [bias.to(dev, bias_dtype), lengths, scale]
            got, ref = A.flash_attention(*args), A.flash_attention_plain(*args)
            torch.cuda.synchronize()
            check(got.shape == ref.shape == (b, t, h, dh) and got.dtype == dtype, "attention_bias output shape or type")
            check(bool(torch.isfinite(got).all()), "attention_bias gives non-finite values")
            err = max_abs(got, ref)
            tol = TOL["attention_f32"] if dtype == torch.float32 else bf16_bar(ref, floor=TOL["attention_f32"])
            blind = max_abs(A.flash_attention(*args[:3], torch.zeros_like(args[3]), lengths, scale), ref)
            mask = (args[3].float() * scale + key_padding(lengths, t, torch.float32)).to(dtype)
            q_, k_, v_ = (x.transpose(1, 2) for x in args[:3])

            def library():
                return F.scaled_dot_product_attention(q_, k_, v_, attn_mask=mask, scale=scale).transpose(1, 2)

            lib_err = max_abs(library(), ref)
            ms = cuda_ms(lambda: A.flash_attention(*args))
            plain_ms = cuda_ms(lambda: A.flash_attention_plain(*args), iters=5)
            library_ms = cuda_ms(library)
            kernel_dev, library_dev = device_ms(lambda: A.flash_attention(*args)), device_ms(library)
            # bytes this run's lengths need: qu read and out written whole, k and v up to each row's length,
            # the bias columns up to it; 4·dh operations for each (query, valid key) pair and head
            size, bias_size = args[0].element_size(), args[3].element_size()
            moved = 2 * nbytes(args[0]) + 2 * valid * h * dh * size + h * t * valid * bias_size
            n = numbers(err, ms, plain_ms, moved, 4 * h * dh * t * valid, dtype, library_ms=library_ms)
            name = f"{str(dtype).replace('torch.', '')} with a {str(bias_dtype).replace('torch.', '')} bias"
            print(f"attention_bias ({b}, {t}, {h}, {dh}) {name}, lengths {lengths.tolist()[:4]}…: max|Δ| {err:.3e} "
                  f"(tol {tol:.3e}; {blind:.3e} with the bias zeroed), kernel {ms:.4f} ms, plain {plain_ms:.4f} ms, bound {n['bound_ms']:.4f} ms "
                  f"({n['bound_by']}, {moved / 1e6:.2f} MB), scaled_dot_product_attention with the bias and the key "
                  f"padding as its mask {library_ms:.4f} ms (max|Δ| to the twin {lib_err:.3e}); device time (calls "
                  f"queued back to back): kernel {kernel_dev:.4f} ms, scaled_dot_product_attention {library_dev:.4f} ms  [{card}]")
            check(err <= tol, f"attention_bias ({name}) disagrees with its plain twin")
            check(blind > 4 * tol, f"attention_bias ({name}): the bar does not see the bias")
            if (b, t, dtype, bias_dtype) == (BATCH, T_SUB, torch.bfloat16, torch.bfloat16):
                result = n
            if (b, t, dtype, bias_dtype) == (LONG_BATCH, LONG_T_SUB, torch.bfloat16, torch.bfloat16):
                # the ragged tail: the same call with every row at full length, and with every row at the mean
                # of this run's lengths; a block walks its row's 64-key tiles up to the length
                # (device times: `cuda_ms` reads the host's launch pace at these sizes)
                full, mean = torch.full_like(lengths, t), torch.full_like(lengths, valid // b)
                full_dev = device_ms(lambda: A.flash_attention(*args[:4], full, scale))
                mean_dev = device_ms(lambda: A.flash_attention(*args[:4], mean, scale))
                walked = [-(-int(x) // 64) for x in lengths]
                print(f"attention_bias ragged tail at ({b}, {t}, {h}, {dh}) bf16, device times: lengths {lengths.tolist()} "
                      f"(64-key tiles walked a block {walked}) {kernel_dev:.4f} ms; every row at {t} {full_dev:.4f} ms; "
                      f"every row at the mean length {valid // b} {mean_dev:.4f} ms: the ragged call takes "
                      f"{kernel_dev / full_dev:.2f} of the full one for {valid / (b * t):.2f} of its keys, "
                      f"{kernel_dev / mean_dev:.2f} of the call with the same keys spread evenly  [{card}]")
    return {"attention_bias": result}


def check_bias_attention_op(card: str) -> dict:
    """The bias-input op's own path, which is the only one it has: the public
    ``flash_attention`` on the tensors of a Conformer-M block's attention at
    (16, 235, 4, 64), with ``bias = rel_shift(qv·pᵀ)``.  Driven once in
    bfloat16 (forward) and once in float32 (forward and backward through
    `BiasFlashAttention`) with the counters at 0 before and read after; then
    held to the rel-pos kernel on the same tensors, and its gradients to
    autograd through the twin.  Returns the launch counts of the drive."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.models.conformer import sinusoidal_rel_positions
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A
    from nn_conformer_for_speech_recognition_tpu_torch.ops.relshift import rel_shift

    gen = torch.Generator().manual_seed(SEED + 7)
    cfg = conformer_m(use_pallas=True)
    mhsa = init_params(ConformerCTC(cfg, VOCAB), gen).encoder.blocks[0].mhsa.cuda()
    b, t, d, h = BATCH, T_SUB, cfg.encoder.d_model, cfg.encoder.num_heads
    dh = d // h
    scale = dh ** -0.5
    with torch.no_grad():
        mhsa.u_bias.copy_(torch.randn(h, dh, generator=gen) * 0.1)
        mhsa.v_bias.copy_(torch.randn(h, dh, generator=gen) * 0.1)
        x = torch.randn(b, t, d, generator=gen).cuda()
        q, k, v = mhsa.qkv(mhsa.norm(x)).reshape(b, t, 3, h, dh).unbind(dim=2)
        p = mhsa.pos_proj(torch.from_numpy(sinusoidal_rel_positions(t, d)).cuda()).reshape(2 * t - 1, h, dh)
        qu, qv = q + mhsa.u_bias, q + mhsa.v_bias
    lengths = mixed_lengths(gen, b, t, t // 3).cuda()
    g = (torch.randn(b, t, h, dh, generator=gen) * 0.5).cuda()

    def make_bias(qv_, p_):
        """The rel-pos term as the op's additive input: float32, as the einsum accumulates it."""
        return rel_shift(torch.einsum("bihd,lhd->bhil", qv_.float(), p_.float()))

    qu16, qv16, k16, v16, p16 = (x_.to(torch.bfloat16).contiguous() for x_ in (qu, qv, k, v, p))
    qu32, k32, v32 = (x_.contiguous() for x_ in (qu, k, v))
    bias16, bias32 = make_bias(qv16, p16), make_bias(qv, p)
    leaves = [x_.clone().requires_grad_(True) for x_ in (qu32, k32, v32, bias32)]

    # -- the drive: counted
    torch.cuda.synchronize()
    reset_counters()
    out16 = A.flash_attention(qu16, k16, v16, bias16, lengths, scale)
    out32 = A.flash_attention(*leaves, lengths, scale)
    out32.backward(g)
    torch.cuda.synchronize()
    launches = read_counters()
    check(launches == {**dict.fromkeys(launches, 0), "attention_bias": 2}, f"the op's launch counts: {launches}")
    check(out16.shape == (b, t, h, dh) and out16.dtype == torch.bfloat16 and bool(torch.isfinite(out16).all()),
          "the op's bf16 output")

    # -- against the rel-pos kernel on the same tensors, and the twin
    rel16 = A.flash_relpos_attention(qu16, qv16, k16, v16, p16, lengths, scale)
    rel32 = A.flash_relpos_attention(qu32, qv.contiguous(), k32, v32, p.contiguous(), lengths, scale)
    err32, err16 = max_abs(out32, rel32), max_abs(out16, rel16)
    twins = [x_.clone().requires_grad_(True) for x_ in (qu32, k32, v32, bias32)]
    A.flash_attention_plain(*twins, lengths, scale).backward(g)
    grad_errs = {n: max_abs(a.grad, r.grad) for n, a, r in zip(("dqu", "dk", "dv", "dbias"), leaves, twins)}
    check(not bool(leaves[3].grad[1, :, :, int(lengths[1]):].any()), "a masked key column of the bias got a gradient")
    ms11 = cuda_ms(lambda: A.flash_attention(qu16, k16, v16, bias16, lengths, scale))
    ms2 = cuda_ms(lambda: A.flash_relpos_attention(qu16, qv16, k16, v16, p16, lengths, scale))
    bias_ms = cuda_ms(lambda: make_bias(qv16, p16))
    bwd_ms = cuda_ms(lambda: A.flash_attention_backward_plain(qu32, k32, v32, bias32, lengths, scale, g), iters=5)
    read2 = nbytes(qu16, qv16, k16, v16, p16)
    read11 = nbytes(qu16, k16, v16, bias16)
    wide = b * h * t * (2 * t - 1) * 4  # the (B, H, T, 2T−1) float32 product, written, then read by the shift
    print(f"attention_bias as rel-pos attention ({b}, {t}, {h}, {dh}), bias = rel_shift(qv·pᵀ) in float32: against the "
          f"rel-pos kernel max|Δ| f32 {err32:.3e} (tol {TOL['attention_f32']}), bf16 {err16:.3e} (tol "
          f"{TOL['attention_bf16']}); bf16 times: rel-pos kernel {ms2:.4f} ms reading {read2 / 1e6:.2f} MB; bias-input "
          f"kernel {ms11:.4f} ms reading {read11 / 1e6:.2f} MB, after {bias_ms:.4f} ms to form the bias (einsum + "
          f"rel_shift: {nbytes(qv16, p16) / 1e6:.2f} MB read, {wide / 1e6:.2f} MB written and read again, "
          f"{nbytes(bias16) / 1e6:.2f} MB written): {ms11 + bias_ms:.4f} ms in all  [{card}]")
    print(f"BiasFlashAttention f32 gradients against autograd through the twin: "
          + ", ".join(f"{n} {e:.3e}" for n, e in grad_errs.items())
          + f" (tol {TOL['attention_bwd_f32']}); the plain backward {bwd_ms:.4f} ms  [{card}]")
    check(err32 <= TOL["attention_f32"], "the bias-input op (f32) disagrees with the rel-pos kernel")
    check(err16 <= TOL["attention_bf16"], "the bias-input op (bf16) disagrees with the rel-pos kernel")
    check(max(grad_errs.values()) <= TOL["attention_bwd_f32"], "BiasFlashAttention's gradients disagree with autograd")
    return launches


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


def weights_for(model, state: dict) -> dict:
    """``state`` under the names of ``model``'s depthwise-conv route: the
    kernel route's ``dw_kernel`` (K, C) and the library route's
    ``depthwise.weight`` (C, 1, K) hold the same taps."""
    want = model.state_dict().keys()
    return dict(
        (name, value) if name in want
        else (name.replace("dw_kernel", "depthwise.weight"), value.t().unsqueeze(1).contiguous())
        for name, value in state.items()
    )


def check_slice(card: str, conv_impl: str = "auto") -> dict:
    """The pseudo-label pass.  ``conv_impl='pallas'``: the configuration
    whose depthwise conv is the hand-written kernel; its plain path is the
    ``use_pallas=False`` model (grouped conv1d) with the same taps."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import greedy_decode
    from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_predict_step

    vocab = build_vocab("word", [" ".join(f"w{i}" for i in range(VOCAB - 3))])
    check(len(vocab) == VOCAB, "vocabulary size")
    gen = torch.Generator().manual_seed(SEED)
    base = init_params(ConformerCTC(conformer_m(use_pallas=True, conv_impl=conv_impl), VOCAB), gen)
    for name, buf in base.named_buffers():  # non-trivial running statistics
        buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 + (0.75 if name.endswith("var") else -0.25))
    state = base.state_dict()
    tag = f"conv_impl={conv_impl!r}"

    def model(**cfg):
        m = ConformerCTC(conformer_m(**cfg), VOCAB)
        m.load_state_dict(weights_for(m, state))
        return m.cuda().eval()

    kernel32 = model(use_pallas=True, conv_impl=conv_impl, compute_dtype="float32")
    plain32 = model(use_pallas=False, compute_dtype="float32")
    kernel16 = model(use_pallas=True, conv_impl=conv_impl)  # 'auto': bfloat16 on CUDA
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
    print(f"slice f32 ({tag}), kernel vs plain path over {N_BATCHES} batches: log-prob max|Δ| {worst:.3e} "
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
    print(f"slice bf16 ({tag}), kernel vs plain path: greedy ids equal on {share:.4%} of valid frames")

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
    expected = {"stft_logmel": N_BATCHES, "attention_relpos": 16 * N_BATCHES, "lstm": 2 * N_BATCHES,
                "depthwise_conv": 16 * N_BATCHES if conv_impl == "pallas" else 0}
    check(launches == {**dict.fromkeys(launches, 0), **expected}, f"pseudo-label launch counts, want {expected}")
    per_batch = dt / N_BATCHES
    print(f"bf16 pseudo-label pass ({tag}): {per_batch * 1e3:.2f} ms/batch (B={BATCH}, {SECONDS:.0f} s clips), "
          f"{BATCH * SECONDS / per_batch:.1f} audio-s/s, peak memory {peak / 2**20:.1f} MiB  [{card}]")
    return launches


def relative_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    return max_abs(got, ref) / max(ref.abs().max().item(), 1e-30)


def check_train(card: str, batch: int, seconds: float, target_len: int, long_form: bool,
                conv_impl: str = "auto") -> dict:
    """The supervised train step: float32 kernel path vs plain path, then
    the bf16 step as a user runs it.  ``long_form``: the subsampled length
    is at least 768, so 'auto' trains the attention through the flash
    kernels; the einsum route's peak memory and one step under remat are
    measured too.  ``conv_impl='pallas'``: the depthwise conv is the
    hand-written kernel (its plain path the grouped conv1d with the same
    taps), and one step under remat is counted at this shape too."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import (
        ATTENTION_KERNEL_MIN_T_TRAINING, FeatureConfig, OptimizerConfig, SpecAugmentConfig, conformer_m,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_augment_step, make_feature_train_step
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState
    from nn_conformer_for_speech_recognition_tpu_torch.utils.flops import peak_bf16_flops, train_step_flops

    n_samples = round(seconds * 16000)
    frames = FeatureConfig().num_frames(n_samples)
    t_sub = conformer_m().subsampled_length(frames)
    check((t_sub >= ATTENTION_KERNEL_MIN_T_TRAINING) == long_form, f"T'={t_sub} is on the wrong side of the switch")
    check((batch, t_sub) in KERNEL_SHAPES_CHECKED, f"B={batch}, T'={t_sub}: the kernel phase ran at no such shape")
    what = f"B={batch}, {seconds:g} s clips, T'={t_sub}, {target_len} targets, conv_impl={conv_impl!r}"
    blocks = conformer_m().encoder.num_blocks

    gen = torch.Generator().manual_seed(SEED + 3)
    base = init_params(ConformerCTC(conformer_m(use_pallas=True, conv_impl=conv_impl), VOCAB), gen)
    for name, buf in base.named_buffers():  # non-trivial running statistics
        buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 + (0.75 if name.endswith("var") else -0.25))
    weights = base.state_dict()

    def trainer(cfg, lr: float, ctc_impl: str = "auto"):
        m = ConformerCTC(cfg, VOCAB)
        m.load_state_dict(weights_for(m, weights))
        m.cuda()
        state = TrainState.create(m, make_optimizer(OptimizerConfig(learning_rate=lr), m.named_parameters()), SEED)
        return state, make_feature_train_step(m, blank_id=0, ctc_impl=ctc_impl)

    augment = make_augment_step(FeatureConfig(), SpecAugmentConfig())
    targets = torch.randint(3, VOCAB, (batch, target_len), generator=gen).cuda()

    # -- float32, kernel path vs plain path: one step from the same weights
    #    and the same (augmented) features, dropout 0
    def f32(use_pallas: bool):
        cfg = conformer_m(use_pallas=use_pallas, conv_impl=conv_impl if use_pallas else "auto", compute_dtype="float32")
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

        def plain(name):
            """The plain path's parameter and gradient under the kernel path's name and layout: the library
            route keeps the taps as ``depthwise.weight`` (C, 1, K), the kernel route as ``dw_kernel`` (K, C)."""
            if name in params_p:
                return params_p[name].detach(), params_p[name].grad
            p = params_p[name.replace("dw_kernel", "depthwise.weight")]
            return p.detach()[:, 0].t(), p.grad[:, 0].t()

        # updates: Adafactor normalises each row and column of a gradient (and
        # moves an unfactored entry by ±0.1·lr on the first step), so an entry
        # whose gradient is at noise level takes a full-size step of
        # noise-determined direction on either path; the update is held on the
        # entries whose gradient is clear of 0 by 1e-3 of the tensor's largest
        grad_err, worst, step_err = 0.0, "", 0.0
        noisy = total = 0
        for name, pk in mk.named_parameters():
            pp, pp_grad = plain(name)
            err = relative_error(pk.grad, pp_grad)
            if err > grad_err:
                grad_err, worst = err, name
            dk, dp = pk.detach() - before[name], pp - before[name]
            clear = pp_grad.abs() > 1e-3 * pp_grad.abs().max()
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
    check(kernel_run[3]["depthwise_conv"] == (2 * blocks if conv_impl == "pallas" else 0),
          f"f32 kernel path launches: {kernel_run[3]}")
    compare(kernel_run, plain_run)
    del kernel_run, plain_run

    # -- bf16, as a user runs it: augment, then the train step; full-length
    #    clips, the same count of targets in every row
    cfg16 = conformer_m(use_pallas=True, conv_impl=conv_impl)  # compute 'auto': bfloat16 on CUDA
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
    conv = 2 * blocks * N_TRAIN_STEPS if conv_impl == "pallas" else 0  # forward and dx in every block
    expected = {"stft_logmel": n, "attention_relpos": 0, "lstm": 2 * n, "lstm_backward": 2 * n,
                "lstm_weight_grad": 2 * n, "ctc_alpha": n, "ctc_beta": n, "attention_relpos_lse": attn,
                "attention_relpos_bwd_dq": attn, "attention_relpos_bwd_dkv": attn, "attention_relpos_bwd_dband": attn,
                "depthwise_conv": conv, "attention_bias": 0}
    check(launches == expected, f"train-step launch counts, want {expected}")
    del state

    # -- the loss falls over 10 steps on one repeated batch
    _, _, _, _, losses = run_steps(cfg16, LOSS_LR, 0, LOSS_STEPS + 1)
    print(f"bf16 loss on a repeated batch at lr {LOSS_LR}: " + " ".join(f"{x:.3f}" for x in losses))
    check(losses[-1] < losses[0], f"the loss did not fall in {LOSS_STEPS} steps")
    if not long_form and conv_impl != "pallas":
        return launches

    # -- under remat each block's forward runs again in the backward: the
    #    attention forward and the conv forward are launched twice per
    #    block, each backward once (conv: 2 forwards + dx = 48 a step)
    _, dt_remat, count, peak_remat, _ = run_steps(dataclasses.replace(cfg16, remat=True), lr32, 1, 2)
    print(f"bf16 train step under remat ({what}): {dt_remat * 1e3:.2f} ms/step, peak memory "
          f"{peak_remat / 2**20:.1f} MiB, launches over 2 steps {count}  [{card}]")
    again = {"attention_relpos_lse": 2.0, "depthwise_conv": 1.5}  # forwards repeated; the conv's dx is not
    check(count == {k: int(again.get(k, 1.0) * v) * 2 // n for k, v in expected.items()}, "launch counts under remat")
    if not long_form:
        return launches
    # -- the einsum route at the same shape (attention_impl='xla'): its T² tensors in memory
    _, dt_einsum, count, peak_einsum, _ = run_steps(dataclasses.replace(cfg16, attention_impl="xla"), lr32, 1, 2)
    check(not any(v for k, v in count.items() if k.startswith("attention")), "the einsum route launched attention")
    print(f"bf16 train step on the einsum route ({what}, attention_impl='xla', probability dropout): "
          f"{dt_einsum * 1e3:.2f} ms/step, peak memory {peak_einsum / 2**20:.1f} MiB against "
          f"{peak / 2**20:.1f} MiB on the kernel route  [{card}]")
    return launches


class KilledAfter:
    """Dataset proxy whose epoch raises after ``n`` batches: a kill mid-epoch."""

    def __init__(self, dataset, n: int):
        self._dataset, self._n = dataset, n

    def epoch(self, seed):
        for i, batch in enumerate(self._dataset.epoch(seed=seed)):
            if i >= self._n:
                raise KeyboardInterrupt("killed mid-epoch")
            yield batch

    def __getattr__(self, name):
        return getattr(self._dataset, name)


class StageClock:
    """Wall seconds by stage of a trainer, taken from outside it: `wrap`
    puts a timer around one method of one object, which waits for the card
    before it starts and before it stops, so that no stage is charged the
    work another left queued.  A stage inside another (the validation and
    the checkpoints inside ``train``) counts once, under its own name."""

    def __init__(self):
        self.seconds = {}
        self._inner = []

    def wrap(self, obj, method: str, stage: str) -> None:
        fn = getattr(obj, method)

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            self._inner.append(0.0)
            try:
                return fn(*args, **kwargs)
            finally:
                torch.cuda.synchronize()
                dt, inner = time.perf_counter() - t0, self._inner.pop()
                self.seconds[stage] = self.seconds.get(stage, 0.0) + dt - inner
                if self._inner:
                    self._inner[-1] += dt

        setattr(obj, method, timed)


def check_nst(card: str) -> dict:
    """One Noisy Student generation as a user drives it: synthetic corpus →
    manifests → vocabulary → bucketed datasets → `Trainer.init_state` →
    supervised training (`Trainer.train`, until the decodes are words) →
    `run_nst` (supervised epoch with SpecAugment and validation →
    pseudo-labels for the unlabelled split → filter → mix manifest →
    retrain → ``ckpt_gen0``), Conformer-M at full width and depth under
    ``use_pallas=True, conv_impl='pallas'`` in bfloat16.  Then the trained
    weights in float32 through `Trainer.evaluate` and `generate_labels` on
    the kernel path and on the plain path, which must agree.  Returns the
    launch counts of the `run_nst` call."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import (
        FeatureConfig, NSTConfig, OptimizerConfig, TrainConfig, conformer_m,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.data.audio import make_synthetic_corpus
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, load_manifest
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.nst.driver import run_nst
    from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    model_cfg = conformer_m(use_pallas=True, conv_impl="pallas")
    blocks = model_cfg.encoder.num_blocks
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        manifests = make_synthetic_corpus(os.path.join(root, "corpus"), NST_WORDS, NST_TRAIN, NST_VAL, 0, NST_UNLABELED,
                                          max_words_per_utt=NST_MAX_WORDS, seed=SEED)
        utts = {split: load_manifest(path) for split, path in manifests.items()}
        vocab = build_vocab("word", [u.transcript for u in utts["train"]])
        data = {split: BucketedDataset(u, vocab, NST_BATCH, bucket_boundaries=[n for n, _ in NST_BUCKETS],
                                       max_target_len=NST_MAX_WORDS) for split, u in utts.items()}
        corpus_s = time.perf_counter() - t0
        seconds = {split: float(ds._lengths.sum()) / 16000 for split, ds in data.items()}
        print(f"NST corpus: {len(vocab)} tokens, clips (audio-s) " + ", ".join(
            f"{split} {len(ds)} ({seconds[split]:.1f})" for split, ds in data.items())
            + f", buckets {data['train'].bucket_boundaries} samples, written and indexed in {corpus_s:.2f} s")
        for split, ds in data.items():  # the kernel phases ran at these batches' shapes
            check(int(ds._lengths.max()) <= NST_LONGEST, f"a clip of the {split} split is longer than the last bucket")
        for n, frames in NST_BUCKETS:
            check(model_cfg.subsampled_length(FeatureConfig().num_frames(n)) == frames
                  and (NST_BATCH, frames) in KERNEL_SHAPES_CHECKED, f"the kernel phases did not run at the bucket of {n} samples")

        def trainer(ckpt_dir, every: int = 0, cfg=model_cfg, feat_cfg=FeatureConfig(), ctc_impl: str = "auto"):
            train_cfg = TrainConfig(batch_size=NST_BATCH, optimizer=OptimizerConfig(learning_rate=NST_LR), log_every=0,
                                    checkpoint_dir=ckpt_dir, checkpoint_every_steps=every, ctc_impl=ctc_impl)
            return Trainer(ConformerCTC(cfg, len(vocab)), vocab, feat_cfg, train_cfg, log_fn=print)

        tr = trainer(None)
        tr.init_state(seed=SEED)
        check(next(tr.model.parameters()).device.type == "cuda", "the trainer did not put the model on the card")

        # -- supervised training until the model says words: a teacher that decodes nothing gives no pseudo-label
        #    to keep, and the generation would then retrain on the supervised lines alone
        per_epoch = data["train"].num_batches()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        tr.log = lambda msg: None
        tr.train(data["train"], epochs=NST_PRETRAIN_EPOCHS)
        tr.log = print
        torch.cuda.synchronize()
        pretrain_s = time.perf_counter() - t0
        pretrain = list(tr.history["train_loss"])
        print(f"supervised training before the generation: {NST_PRETRAIN_EPOCHS} epochs of {per_epoch} steps in "
              f"{pretrain_s:.2f} s ({pretrain_s / (NST_PRETRAIN_EPOCHS * per_epoch) * 1e3:.1f} ms/step), epoch loss "
              + " ".join(f"{x:.3f}" for x in pretrain[:: max(1, NST_PRETRAIN_EPOCHS // 10)]) + f" … {pretrain[-1]:.3f}  [{card}]")
        check(bool(np.isfinite(pretrain).all()) and pretrain[-1] < pretrain[0], "the supervised loss did not fall")
        check(tr.state.step == NST_PRETRAIN_EPOCHS * per_epoch, f"the state counts {tr.state.step} steps")

        forwards = {True: 0, False: 0}  # conv-module forwards of block 0, by training mode
        tr.model.encoder.blocks[0].conv.register_forward_hook(
            lambda m, *_: forwards.__setitem__(m.training, forwards[m.training] + 1))
        manager = CheckpointManager(os.path.join(root, "ckpt"), keep=3)
        teacher = {}  # what the teacher said of each unlabelled clip, as run_nst received it
        label = tr.generate_labels

        def teacher_labels(*args, **kwargs):
            teacher["labels"] = label(*args, **kwargs)
            return teacher["labels"]

        tr.generate_labels = teacher_labels
        clock = StageClock()
        for obj, method, stage in ((tr, "train", "train"), (tr, "evaluate", "evaluate"), (tr, "generate_labels", "label"),
                                   (tr, "save", "checkpoint"), (manager, "save", "checkpoint")):
            clock.wrap(obj, method, stage)
        work = os.path.join(root, "nst")
        torch.cuda.synchronize()
        reset_counters()
        torch.cuda.reset_peak_memory_stats()
        t0 = time.perf_counter()
        results = run_nst(tr, data["train"], data["unlabeled"], NSTConfig(generations=1, train_epochs_per_generation=1,
                                                                         max_target_len=NST_MAX_WORDS),
                          val_dataset=data["validation"], work_dir=work, checkpoint_manager=manager)
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
        launches = read_counters()
        peak = torch.cuda.max_memory_allocated()

        (res,) = results
        epoch_losses = tr.history["train_loss"][NST_PRETRAIN_EPOCHS:]
        check(len(epoch_losses) == 2 and bool(np.isfinite(epoch_losses).all()),
              "run_nst did not train twice, or a train loss of the generation is not finite")
        labels = teacher["labels"]
        check(res.num_pseudo_labels == len(labels) == len(data["unlabeled"]) == NST_UNLABELED,
              "a clip of the unlabelled split got no label")
        # the mix: the supervised lines, then every clip whose label passed the filter, under that label
        mix = load_manifest(os.path.join(work, "mix_gen0.tsv"))
        kept = mix[NST_TRAIN:]
        index_of = {u.audio_path: i for i, u in enumerate(data["unlabeled"].utterances)}
        check([(u.audio_path, u.transcript) for u in mix[:NST_TRAIN]] == [(u.audio_path, u.transcript) for u in utts["train"]],
              "mix_gen0.tsv does not start with the supervised lines")
        check(res.num_kept == len(kept) > 0, f"the filter kept {res.num_kept} pseudo-labels, the mix holds {len(kept)}")
        check(all(u.transcript and u.transcript == labels[index_of[u.audio_path]] for u in kept)
              and len({u.audio_path for u in kept}) == len(kept),
              "a kept line of mix_gen0.tsv is not an unlabelled clip under the teacher's label")
        mixed = BucketedDataset(mix, vocab, NST_BATCH, bucket_boundaries=data["train"].bucket_boundaries,
                                max_target_len=NST_MAX_WORDS)
        steps = per_epoch + mixed.num_batches()
        check(tr.state.step == NST_PRETRAIN_EPOCHS * per_epoch + steps,
              f"the state counts {tr.state.step} steps, the generation's epochs {steps}")
        check(res.is_best and res.val_loss is not None and np.isfinite(res.val_loss), "the generation has no validation score")
        evals, label_batches = 2 * data["validation"].num_batches(), data["unlabeled"].num_batches()
        check(forwards == {True: steps, False: evals + label_batches}, f"forwards counted {forwards}")
        # every forward runs the conv kernel once per block, every train step once more for dx
        expected = {"stft_logmel": steps + evals + label_batches, "attention_relpos": blocks * (evals + label_batches),
                    "lstm": 2 * (steps + evals + label_batches), "lstm_backward": 2 * steps, "lstm_weight_grad": 2 * steps,
                    "ctc_alpha": steps + evals, "ctc_beta": steps,
                    "depthwise_conv": blocks * (forwards[True] + forwards[False]) + blocks * steps}
        print(f"launch counts over the NST generation ({steps} train steps, {evals} validation and {label_batches} "
              f"labelling batches): {launches}")
        check(launches == {**dict.fromkeys(launches, 0), **expected}, f"NST launch counts, want {expected}")

        stage = clock.seconds
        train_audio = seconds["train"] + float(mixed._lengths.sum()) / 16000
        print(f"NST generation, Conformer-M bf16 conv_impl='pallas', B={NST_BATCH}, lr {NST_LR}: wall {wall:.2f} s; by stage "
              "(each between two waits for the card) " + ", ".join(f"{k} {v:.2f} s" for k, v in stage.items())
              + f"; train {train_audio / stage['train']:.1f} audio-s/s over {steps} steps "
              f"({stage['train'] / steps * 1e3:.1f} ms/step), labelling {seconds['unlabeled'] / stage['label']:.1f} audio-s/s "
              f"over {label_batches} batches ({stage['label'] / label_batches * 1e3:.1f} ms/batch), evaluate "
              f"{stage['evaluate'] / evals * 1e3:.1f} ms/batch; peak memory {peak / 2**20:.1f} MiB  [{card}]")
        print(f"NST losses: supervised epoch {epoch_losses[0]:.4f}, retrain on the mix {epoch_losses[1]:.4f}; validation loss "
              + " → ".join(f"{x:.4f}" for x in tr.history["val_loss"]) + ", WER "
              + " → ".join(f"{100 * x:.2f}" for x in tr.history["val_wer"])
              + f"; pseudo-labels {res.num_pseudo_labels}, of them not empty {sum(bool(x) for x in labels.values())}, "
              f"kept {res.num_kept} ({len({u.transcript for u in kept})} distinct strings, e.g. {kept[0].transcript!r}), "
              f"mix {len(mix)} lines")

        # -- the trained weights in float32 through the same entry points, kernel path against plain path
        #    (grouped conv1d, einsum attention, scanned LSTM and CTC, framed-matmul log-mel)
        trained = tr.model.state_dict()

        def float32_run(use_pallas: bool):
            cfg = conformer_m(use_pallas=use_pallas, conv_impl="pallas" if use_pallas else "auto", compute_dtype="float32")
            t = trainer(None, cfg=cfg, feat_cfg=FeatureConfig() if use_pallas else FeatureConfig(impl="xla"),
                        ctc_impl="auto" if use_pallas else "xla")
            t.init_state(seed=SEED)
            t.model.load_state_dict(weights_for(t.model, trained))
            reset_counters()
            loss, wer, _, hyps = t.evaluate(data["validation"], return_texts=True)
            return loss, wer, hyps, t.generate_labels(data["unlabeled"]), read_counters()

        loss_k, wer_k, hyps_k, labels_k, count_k = float32_run(True)
        loss_p, wer_p, hyps_p, labels_p, count_p = float32_run(False)
        check(not any(count_p.values()), f"the plain path launched a kernel: {count_p}")
        n_eval = data["validation"].num_batches() + label_batches
        check(count_k == {**dict.fromkeys(count_k, 0), "stft_logmel": n_eval, "attention_relpos": blocks * n_eval,
                          "lstm": 2 * n_eval, "ctc_alpha": data["validation"].num_batches(),
                          "depthwise_conv": blocks * n_eval}, f"float32 kernel path launches: {count_k}")
        loss_err = abs(loss_k - loss_p) / abs(loss_p)
        frames = sum(model_cfg.subsampled_length(FeatureConfig().num_frames(int(n)))
                     for split in ("validation", "unlabeled") for n in data[split]._lengths)
        differ = sum(a != b for a, b in zip(hyps_k, hyps_p)) + sum(labels_k[i] != labels_p[i] for i in labels_p)
        allowed = int((1 - SLICE_ID_AGREEMENT) * frames)  # one frame's id may differ in a thousand, as in check_slice
        same16 = sum(labels_k[i] == x for i, x in label(data["unlabeled"]).items())
        print(f"NST f32, kernel vs plain path from the trained weights: validation loss {loss_k:.6f} vs {loss_p:.6f} "
              f"(rel {loss_err:.3e}, tol {NST_EVAL_LOSS_TOL}), WER {100 * wer_k:.2f} vs {100 * wer_p:.2f}; decodes differ on "
              f"{differ} of {len(hyps_p) + len(labels_p)} clips ({frames} frames; at most {allowed} may); "
              f"{sum(bool(x) for x in labels_p.values())} of the plain path's labels are not empty; the bf16 kernel "
              f"path gives the float32 label on {same16}/{len(labels_k)} clips")
        check(loss_err <= NST_EVAL_LOSS_TOL, "f32 validation loss of the kernel path disagrees at the NST shapes")
        check(labels_k.keys() == labels_p.keys() and differ <= allowed, "f32 decodes of the kernel path disagree at the NST shapes")
        check(any(labels_p.values()), "the comparison ran on empty decodes only")

        # -- the generation's checkpoint restores into a fresh trainer bit for bit
        ref_loss, ref_wer = tr.evaluate(data["validation"])
        fresh = trainer(None)
        fresh.init_state(seed=SEED + 1)
        fresh.load(os.path.join(work, "ckpt_gen0"))
        mine, theirs = tr.state, fresh.state

        def tensors(st) -> dict:
            slots = {f"{name}.{k}": v for name, slot in st.optimizer.state.items() for k, v in slot.items()}
            return {**st.model.state_dict(), **slots, "generator": st.generator.get_state()}

        a, b = tensors(mine), tensors(theirs)
        check(a.keys() == b.keys() and all(torch.equal(a[k], b[k]) for k in a), "ckpt_gen0 does not restore bit-equal")
        check((mine.step, mine.seed, mine.optimizer.count) == (theirs.step, theirs.seed, theirs.optimizer.count),
              "ckpt_gen0 restores another step, seed or optimizer count")
        loss, wer = fresh.evaluate(data["validation"])
        print(f"ckpt_gen0 restored into a fresh trainer: {len(a)} tensors bit-equal, step {theirs.step}; validation loss "
              f"{loss:.6f} vs {ref_loss:.6f}, WER {100 * wer:.2f} vs {100 * ref_wer:.2f}")
        check(loss == ref_loss and wer == ref_wer, "the restored trainer evaluates differently")
        latest, cursor = manager.restore_latest_with_iterator(fresh.state)
        check(latest is fresh.state and cursor == {"epoch": 101, "step": 0} and fresh.state.step == mine.step,
              f"the newest checkpoint's cursor is {cursor}")
        del fresh

        # -- a kill in the middle of an epoch, resumed by a fresh trainer from the cursor
        ckpt_dir = os.path.join(root, "resume")
        killed = trainer(ckpt_dir, every=3)
        killed.init_state(seed=SEED)
        try:
            killed.train(KilledAfter(data["train"], 5), epochs=1)
            check(False, "the kill did not interrupt the epoch")
        except KeyboardInterrupt:
            pass
        del killed
        resumed = trainer(ckpt_dir, every=3)
        resumed.init_state(seed=SEED + 2)
        state, cursor = CheckpointManager(ckpt_dir).restore_latest_with_iterator(resumed.state)
        check(cursor == {"epoch": 0, "step": 3} and state.step == 3, f"mid-epoch cursor {cursor}")
        history = resumed.resume(data["train"], epochs=1)
        print(f"killed after 5 of {per_epoch} steps with a cursor every 3; resumed from {cursor} to step "
              f"{resumed.state.step}, the epoch's loss over the {resumed.state.step - 3} steps after the resume "
              f"{history['train_loss'][-1]:.4f}")
        check(resumed.state.step == per_epoch and len(history["train_loss"]) == 1,
              "the resumed run did not reach the epoch's end")
        check(bool(np.isfinite(history["train_loss"]).all()), "the loss after the resume is not finite")
    return launches


def check_beam(card: str) -> dict:
    """Beam-search evaluation at full width: `make_eval_beam_step` on
    Conformer-M (``use_pallas=True``, bfloat16, vocabulary 1024) over B=16
    clips of 30 s beside the greedy `make_eval_step`; the card's hypotheses
    against the same search on the CPU from the same float32 log-probs; each
    1-best score against the log-prob of the row's greedy path.  Returns the
    kernel launch counts of the timed beam batches."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import collapse_repeats, ctc_beam_search, greedy_decode
    from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_eval_beam_step, make_eval_step

    gen = torch.Generator().manual_seed(SEED + 8)
    cfg = conformer_m(use_pallas=True)
    blocks = cfg.encoder.num_blocks
    model = init_params(ConformerCTC(cfg, VOCAB), gen)
    for name, buf in model.named_buffers():  # non-trivial running statistics
        buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 + (0.75 if name.endswith("var") else -0.25))
    model.cuda().eval()
    batches = make_batches(int(SECONDS * 16000))
    featurize = make_featurizer(FeatureConfig())

    def log_probs(audio, alen):
        with torch.inference_mode():
            lp, out_lengths = model(*featurize(audio, alen))
        return lp.float(), out_lengths

    # the head calibrated to speak as a trained CTC model does (see BEAM_LOGIT_STD)
    spread = log_probs(*batches[0])[0].std(dim=-1).mean().item()
    with torch.no_grad():
        model.final_fc.weight.mul_(BEAM_LOGIT_STD / spread)
        model.final_fc.bias.zero_()
        model.final_fc.bias[0] = BEAM_BLANK_BIAS
    lp, out_lengths = log_probs(*batches[1])
    check(lp.shape == (BATCH, T_SUB, VOCAB), f"log-probs shape {tuple(lp.shape)}")
    valid = torch.arange(T_SUB, device="cuda")[None, :] < out_lengths[:, None]
    blank_share = ((lp.argmax(-1) == 0) & valid).sum().item() / valid.sum().item()

    # -- the card's hypotheses against the CPU's, from the same float32 log-probs
    kw = dict(blank_id=0, beam=BEAM, prune=PRUNE, max_label_len=MAX_LABEL_LEN)
    toks, lens, scores = (x.cpu() for x in ctc_beam_search(lp, out_lengths, **kw))
    t0 = time.perf_counter()
    rtoks, rlens, rscores = ctc_beam_search(lp.cpu(), out_lengths.cpu(), **kw)
    cpu_s = time.perf_counter() - t0
    check(toks.shape == (BATCH, BEAM, MAX_LABEL_LEN) and toks.dtype == torch.int32 and lens.shape == scores.shape == (BATCH, BEAM),
          "beam search output shapes")
    differ = [r for r in range(BATCH) if not (torch.equal(toks[r, 0], rtoks[r, 0]) and lens[r, 0] == rlens[r, 0])]
    all_beams = sum(torch.equal(toks[r], rtoks[r]) for r in range(BATCH))
    score_diff = (scores[:, 0] - rscores[:, 0]).abs()
    score_err = score_diff.max().item()
    score_ok = bool((score_diff <= (BEAM_SCORE_RTOL * rscores[:, 0].abs()).clamp(min=BEAM_SCORE_ATOL)).all())
    greedy = torch.where(valid, lp.max(dim=-1).values, 0.0).sum(dim=1).cpu()
    packed, n_greedy = collapse_repeats(greedy_decode(lp, out_lengths, pad_id=1), blank_id=0, pad_id=1)
    fits = n_greedy.cpu() <= MAX_LABEL_LEN  # a longer greedy path has no room in the beam's prefixes
    margin = (scores[:, 0] - greedy)[fits]
    same_as_greedy = sum(toks[r, 0, : lens[r, 0]].tolist() == packed[r, : n_greedy[r]].tolist() for r in range(BATCH))
    print(f"beam search (B={BATCH}, T'={T_SUB}, V={VOCAB}, beam {BEAM}, prune {PRUNE}, {MAX_LABEL_LEN} labels), card vs CPU "
          f"from the same float32 log-probs: 1-best equal on {BATCH - len(differ)}/{BATCH} rows (rows that differ: {differ}), "
          f"all {BEAM} beams equal on {all_beams}/{BATCH} rows, 1-best score max|Δ| {score_err:.3e} at scores of "
          f"{rscores[:, 0].min().item():.1f} to {rscores[:, 0].max().item():.1f} (tol max({BEAM_SCORE_ATOL}, {BEAM_SCORE_RTOL}·|score|)); "
          f"the head says blank on {blank_share:.1%} of the frames, 1-best lengths {lens[:, 0].tolist()}, greedy collapse "
          f"lengths {n_greedy.tolist()}, 1-best = greedy collapse on {same_as_greedy}/{BATCH} rows; 1-best score minus the "
          f"greedy path's log-prob on the {int(fits.sum())} rows whose greedy path fits: min {margin.min().item():.4f}; "
          f"the CPU search took {cpu_s:.2f} s")
    check(len(differ) <= BEAM_ROWS_MAY_DIFFER * BATCH, "the card's 1-best hypotheses differ from the CPU's")
    check(score_ok, "the card's 1-best scores differ from the CPU's")
    check(bool(fits.any()) and bool((margin >= -(BEAM_SCORE_RTOL * greedy[fits].abs()).clamp(min=BEAM_SCORE_ATOL)).all()),
          "a 1-best hypothesis scores below its row's greedy path")

    # -- ms/batch beside the greedy eval step, as Trainer.evaluate calls them
    targets = torch.randint(3, VOCAB, (BATCH, TARGET_LEN), generator=gen).cuda()
    tlen = torch.full((BATCH,), TARGET_LEN, device="cuda")
    greedy_step = make_eval_step(model, FeatureConfig(), blank_id=0, pad_id=1)
    beam_step = make_eval_beam_step(model, FeatureConfig(), blank_id=0, beam=BEAM, prune=PRUNE, max_label_len=MAX_LABEL_LEN)

    def run(step):
        step(*batches[0], targets, tlen)  # warm-up
        torch.cuda.synchronize()
        reset_counters()
        t0 = time.perf_counter()
        outs = [step(audio, alen, targets, tlen) for audio, alen in batches[1:]]
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / N_BATCHES * 1e3, read_counters(), outs

    greedy_ms, _, greedy_outs = run(greedy_step)
    beam_ms, launches, beam_outs = run(beam_step)
    for (gl, _, _), (bl, btoks, blens) in zip(greedy_outs, beam_outs):
        check(bool(torch.isfinite(bl)) and abs(gl.item() - bl.item()) <= 1e-6 * abs(gl.item()),
              "the beam step's loss differs from the greedy step's")
        check(btoks.shape == (BATCH, MAX_LABEL_LEN) and blens.shape == (BATCH,), "beam step output shapes")
    check(torch.equal(beam_outs[0][1].cpu(), toks[:, 0]), "the beam step's 1-best differs from the search on its log-probs")
    expected = {"stft_logmel": N_BATCHES, "attention_relpos": blocks * N_BATCHES, "lstm": 2 * N_BATCHES, "ctc_alpha": N_BATCHES}
    check(launches == {**dict.fromkeys(launches, 0), **expected}, f"beam-step launch counts {launches}, want {expected}")
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        beam_step(*batches[1], targets, tlen)
        torch.cuda.synchronize()
        profiled_ms = (time.perf_counter() - t0) * 1e3
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    device_ms, n_launches = sum(e.self_device_time_total for e in rows) / 1e3, sum(e.count for e in rows)
    check(device_ms > 0, "the profiler recorded no device time")
    print(f"bf16 eval step, Conformer-M, B={BATCH}, {SECONDS:.0f} s clips: beam search {beam_ms:.2f} ms/batch against greedy "
          f"{greedy_ms:.2f} ms/batch over {N_BATCHES} batches ({BATCH * SECONDS / beam_ms * 1e3:.1f} against "
          f"{BATCH * SECONDS / greedy_ms * 1e3:.1f} audio-s/s); one beam batch under the profiler: {profiled_ms:.2f} ms, "
          f"{n_launches} device launches, device time {device_ms:.2f} ms, busy share {device_ms / beam_ms:.3f} of the "
          f"unprofiled batch  [{card}]")
    print(f"launch counts over {N_BATCHES} beam-search eval batches: {launches}")
    return launches


def check_cli(card: str) -> dict:
    """The command line as a user types it, in process, on the Noisy Student
    phase's synthetic corpus in a temporary directory: ``train`` (Conformer-M,
    ``--use-pallas``, bfloat16, checkpoints), ``train --resume``, ``eval``
    greedy and beam from the saved checkpoint, ``nst --generations 1``, and
    ``parity --tiny`` in both protocols.  Returns the kernel launch counts
    of the whole phase."""
    from nn_conformer_for_speech_recognition_tpu_torch.cli import main as cli
    from nn_conformer_for_speech_recognition_tpu_torch.data.audio import make_synthetic_corpus
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import load_manifest
    from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import restore_state

    def run(argv):
        """(exit code, printed lines, seconds); what the command prints is passed on."""
        out = io.StringIO()
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        with contextlib.redirect_stdout(out):
            rc = cli.main(argv)
        torch.cuda.synchronize()
        dt = time.perf_counter() - t0
        lines = out.getvalue().strip().splitlines()
        print(f"$ cli.main {' '.join(argv[:1] + [a for a in argv[1:] if not a.startswith('/')][:14])} …  → exit {rc}, {dt:.2f} s")
        for line in lines:
            print("    " + line[:400])
        check(rc == 0, f"`{argv[0]}` exited with {rc}")
        return lines, dt

    with tempfile.TemporaryDirectory() as root:
        corpus = os.path.join(root, "corpus")
        make_synthetic_corpus(corpus, NST_WORDS, NST_TRAIN, NST_VAL, NST_VAL, NST_UNLABELED,
                              max_words_per_utt=NST_MAX_WORDS, seed=SEED)
        data = ["--manifest-dir", corpus, "--batch-size", str(NST_BATCH), "--max-target-len", str(NST_MAX_WORDS),
                "--bucket-boundaries", *(str(n) for n, _ in NST_BUCKETS)]
        model = ["--model", "conformer_m", "--use-pallas", "--compute-dtype", "bfloat16"]
        ckdir, saved, resumed = (os.path.join(root, x) for x in ("ck", "saved", "resumed"))
        torch.cuda.synchronize()
        reset_counters()

        lines, train_s = run(["train", *data, *model, "--epochs", str(CLI_EPOCHS), "--lr", str(NST_LR),
                              "--checkpoint-dir", ckdir, "--save", saved])
        epochs = [ln for ln in lines if ln.startswith("epoch ")]
        check([ln.split(":")[0] for ln in epochs] == [f"epoch {e}" for e in range(CLI_EPOCHS)], f"train logged {epochs}")
        lines, _ = run(["train", *data, *model, "--epochs", str(CLI_RESUME_EPOCHS), "--lr", str(NST_LR),
                        "--checkpoint-dir", ckdir, "--resume", "--save", resumed])
        epochs = [ln for ln in lines if ln.startswith("epoch ")]
        check([ln.split(":")[0] for ln in epochs] == [f"epoch {e}" for e in range(CLI_EPOCHS, CLI_RESUME_EPOCHS)],
              f"the resumed run did not continue from its cursor: it logged {epochs}")
        losses = [float(ln.split("loss=")[1].split()[0]) for ln in epochs]
        check(bool(np.isfinite(losses).all()), "a train loss of the resumed run is not finite")

        # eval from the checkpoint, greedy and beam, and the same weights through Trainer.evaluate
        evals = {}
        eval_args = ["eval", *data, *model, "--checkpoint", resumed, "--split", "test"]
        for decode in ("greedy", "beam"):
            lines, dt = run([*eval_args, "--decode", decode, "--beam", str(BEAM), "--prune", str(PRUNE),
                             "--max-label-len", str(MAX_LABEL_LEN)])
            evals[decode] = json.loads(lines[-1])
            evals[decode]["seconds"] = dt
            check(set(evals[decode]) == {"split", "loss", "wer", "decode", "seconds"} and evals[decode]["decode"] == decode
                  and evals[decode]["split"] == "test", f"eval printed {lines[-1]}")
        check(np.isfinite(evals["greedy"]["loss"]) and evals["greedy"]["loss"] == evals["beam"]["loss"],
              f"eval losses: {evals}")
        args = cli.build_parser().parse_args([*eval_args, "--beam", str(BEAM), "--prune", str(PRUNE),
                                              "--max-label-len", str(MAX_LABEL_LEN)])
        with contextlib.redirect_stdout(io.StringIO()):
            trainer, datasets, _ = cli._build(args)
        per_epoch = datasets["train"].num_batches()
        check(trainer.state.step == CLI_RESUME_EPOCHS * per_epoch == restore_state(resumed, trainer.state).step,
              f"the checkpoint counts {trainer.state.step} steps, {CLI_RESUME_EPOCHS} epochs have {CLI_RESUME_EPOCHS * per_epoch}")
        check(next(trainer.model.parameters()).device.type == "cuda", "the command line did not take the card")
        for decode in ("greedy", "beam"):
            loss, wer = trainer.evaluate(datasets["test"], decode=decode)
            check(loss == evals[decode]["loss"] and 100 * wer == evals[decode]["wer"],
                  f"eval --decode {decode} printed {evals[decode]}, Trainer.evaluate gives loss {loss}, WER {100 * wer}")
        del trainer

        lines, nst_s = run(["nst", *data, *model, "--checkpoint", resumed, "--generations", "1", "--ft-lr", str(NST_LR),
                            "--work-dir", os.path.join(root, "nst"), "--checkpoint-dir", os.path.join(root, "nst_ck")])
        (gen0,) = json.loads(lines[-1])
        check(gen0["generation"] == 0 and gen0["num_pseudo_labels"] == NST_UNLABELED and np.isfinite(gen0["val_loss"])
              and gen0["is_best"], f"nst printed {gen0}")
        mix = load_manifest(os.path.join(root, "nst", "mix_gen0.tsv"))
        check(len(mix) == NST_TRAIN + gen0["num_kept"], "mix_gen0.tsv does not hold the supervised lines and the kept clips")

        tiny = ["--manifest-dir", corpus, "--epochs", "1", "--generations", "1", "--batch-size", str(NST_BATCH), "--tiny"]
        lines, sc_s = run(["parity", *tiny, "--work-dir", os.path.join(root, "parity"), "--max-target-len", str(NST_MAX_WORDS)])
        sc = json.loads(lines[-1])
        check(sc["protocol"] == "reference-parity" and set(sc["wer"]) == {"base", "nst"}
              and all(np.isfinite(v) for tab in sc["wer"].values() for v in tab.values())
              and os.path.exists(os.path.join(root, "parity", "parity.md")), f"parity printed {lines[-1][:300]}")
        lines, ls_s = run(["parity", *tiny, "--protocol", "librispeech", "--work-dir", os.path.join(root, "parity_ls"),
                           "--max-target-len", "32", "--beam", "4", "--prune", "4"])
        ls = json.loads(lines[-1])
        check(ls["protocol"] == "librispeech" and ls["vocab"]["kind"] == "wordpiece"
              and [r["generation"] for r in ls["wer_per_generation"]] == ["base", 0]
              and all(np.isfinite(r["dev"]) and np.isfinite(r["test"]) for r in ls["wer_per_generation"])
              and os.path.exists(os.path.join(root, "parity_ls", "librispeech_parity.md")), f"parity printed {lines[-1][:300]}")
        torch.cuda.synchronize()
        launches = read_counters()

    steps = CLI_EPOCHS * per_epoch
    print(f"command line, Conformer-M bf16 --use-pallas, B={NST_BATCH}: train {CLI_EPOCHS} epochs of {per_epoch} steps with "
          f"validation and checkpoints {train_s:.2f} s ({train_s / steps * 1e3:.1f} ms a step, all included); eval of "
          f"{NST_VAL} clips greedy {evals['greedy']['seconds']:.2f} s, WER {evals['greedy']['wer']:.2f}%, beam "
          f"{evals['beam']['seconds']:.2f} s, WER {evals['beam']['wer']:.2f}%, loss {evals['greedy']['loss']:.4f} on both; "
          f"nst generation {nst_s:.2f} s, kept {gen0['num_kept']} of {gen0['num_pseudo_labels']}, validation WER "
          f"{100 * gen0['val_wer']:.2f}%; parity --tiny {sc_s:.2f} s (WER {sc['wer']}), librispeech protocol {ls_s:.2f} s "
          f"(WER per generation {ls['wer_per_generation']})  [{card}]")
    print(f"launch counts over the command-line phase: {launches}")
    check(launches["attention_bias"] == 0 and all(launches[k] > 0 for k in ("stft_logmel", "attention_relpos", "lstm",
          "lstm_backward", "lstm_weight_grad", "ctc_alpha", "ctc_beta")), "the command line missed a kernel of its path")
    return launches


F2_STEPS_PER_EPOCH, F2_EPOCHS = 5, 2  # the repeatability phase: ten steps, the first five batches of two epochs
F2_STAGES = ("batch", "features (log-mel, SpecAugment)", "subsampling convs out", "encoder out", "BiLSTM out",
             "log-probs", "loss", "log-prob gradient (the CTC gather's adjoint)")
F2_GROUPS = ("final_fc", "BiLSTM w_hh (lstm_dwhh)", "BiLSTM w_ih, bias", "projection, norm", "encoder",
             "subsampling convs")


def bits(x: torch.Tensor) -> int:
    """A digest of a tensor's bits, taken on the card: the bit patterns as
    integers weighted by position, summed in int64 (exact, so the same bits
    give the same digest whatever the order of the sum)."""
    v = x.detach().reshape(-1)
    v = v.view({2: torch.int16, 4: torch.int32, 8: torch.int64}[v.element_size()]).to(torch.int64)
    return int((v * torch.arange(1, v.numel() + 1, device=v.device)).sum())


def f2_group(name: str) -> str:
    """The step group a parameter's gradient and update belong to."""
    if name.startswith("decoder_lstm"):
        return F2_GROUPS[1] if name.endswith("_w_hh") else F2_GROUPS[2]
    for prefix, group in (("final_fc", 0), ("encoder", 4), ("subsampling", 5)):
        if name.startswith(prefix):
            return F2_GROUPS[group]
    return F2_GROUPS[3]


class FirstBatches:
    """Dataset proxy whose epoch stops after ``n`` batches."""

    def __init__(self, dataset, n: int):
        self._dataset, self._n = dataset, n

    def epoch(self, seed):
        for i, batch in zip(range(self._n), self._dataset.epoch(seed=seed)):
            yield batch

    def __getattr__(self, name):
        return getattr(self._dataset, name)


def repeat_worker(out_dir: str) -> None:
    """One of the repeatability phase's two fresh processes: ten bf16
    Conformer-M train steps (``conv_impl='pallas'``) through `Trainer.train`
    on the Noisy Student corpus, from SEED, recording for each step, in the
    order they are computed, a digest of every stage's bits and of each
    group's gradients and updated parameters; writes them, the losses and
    the final model and optimizer state into ``out_dir``."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, OptimizerConfig, TrainConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.data.audio import make_synthetic_corpus
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, load_manifest
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    with tempfile.TemporaryDirectory() as root:
        manifests = make_synthetic_corpus(os.path.join(root, "corpus"), NST_WORDS, NST_TRAIN, NST_VAL, 0, NST_UNLABELED,
                                          max_words_per_utt=NST_MAX_WORDS, seed=SEED)
        utts = load_manifest(manifests["train"])
        vocab = build_vocab("word", [u.transcript for u in utts])
        data = BucketedDataset(utts, vocab, NST_BATCH, bucket_boundaries=[n for n, _ in NST_BUCKETS],
                               max_target_len=NST_MAX_WORDS)
        train_cfg = TrainConfig(batch_size=NST_BATCH, optimizer=OptimizerConfig(learning_rate=NST_LR), log_every=0)
        tr = Trainer(ConformerCTC(conformer_m(use_pallas=True, conv_impl="pallas"), len(vocab)), vocab, FeatureConfig(),
                     train_cfg, log_fn=lambda msg: None)
        tr.init_state(seed=SEED)
        model, record, grads, steps, losses = tr.model, {}, {}, [], []
        names = {group: [n for n, _ in model.named_parameters() if f2_group(n) == group] for group in F2_GROUPS}

        def note(stage, x):
            record[stage] = bits(x)

        def on_output(module, inputs, out):
            note(F2_STAGES[5], out[0])
            if out[0].requires_grad:
                out[0].register_hook(lambda g: note(F2_STAGES[7], g))

        model.subsampling.register_forward_hook(lambda m, i, o: note(F2_STAGES[2], o[0]))
        model.encoder.register_forward_hook(lambda m, i, o: note(F2_STAGES[3], o))
        model.decoder_lstm.register_forward_hook(lambda m, i, o: note(F2_STAGES[4], o))
        model.register_forward_hook(on_output)
        for name, p in model.named_parameters():
            p.register_post_accumulate_grad_hook(lambda p, name=name: grads.__setitem__(name, bits(p.grad)))
        put, core = tr._put, tr._train_core

        def put_recorded(batch):
            record.clear()
            grads.clear()
            audio, alen, tgt, tlen = put(batch)
            record[F2_STAGES[0]] = hash((bits(audio), bits(alen), bits(tgt), bits(tlen)))
            return audio, alen, tgt, tlen

        def core_recorded(state, feats, frame_lengths, targets, target_lengths):
            note(F2_STAGES[1], feats)
            state, metrics = core(state, feats, frame_lengths, targets, target_lengths)
            note(F2_STAGES[6], metrics["loss"])
            losses.append(metrics["loss"].item())
            params = dict(model.named_parameters())
            for group in F2_GROUPS:
                record[f"gradients: {group}"] = hash(tuple(grads[n] for n in names[group]))
            for group in F2_GROUPS:
                record[f"parameters after Adafactor: {group}"] = hash(tuple(bits(params[n]) for n in names[group]))
            record["batch statistics"] = hash(tuple(bits(b) for _, b in model.named_buffers()))
            steps.append({**{stage: record[stage] for stage in F2_STAGES}, **record})  # in the order computed
            return state, metrics

        tr._put, tr._train_core = put_recorded, core_recorded
        tr.train(FirstBatches(data, F2_STEPS_PER_EPOCH), epochs=F2_EPOCHS)
        torch.cuda.synchronize()
        with open(os.path.join(out_dir, "record.json"), "w") as f:
            json.dump({"losses": [x.hex() for x in losses], "steps": steps}, f)
        slots = {f"{name}.{k}": v for name, slot in tr.state.optimizer.state.items() for k, v in slot.items()}
        torch.save({**model.state_dict(), **slots}, os.path.join(out_dir, "state.pt"))


def check_repeatability(card: str) -> dict:
    """F2: the same ten bf16 train steps from one seed (`repeat_worker`) in
    two fresh processes, losses and final parameters compared bit for bit,
    and the first stage of the first step whose bits differ named.  Then,
    inside this process, each step group's op twice on the same inputs:
    SpecAugment's draws and time warp, the subsampling convs forward and
    backward, the gather behind the CTC loss forward and backward (the
    port's, and torch's own ``gather`` beside it), two ``lstm_dwhh``
    launches, and one Adafactor update.  Returns the verdicts."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import (
        FeatureConfig, OptimizerConfig, SpecAugmentConfig, conformer_m,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.ops import ctc as TC
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_augment_step
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer

    runs = []
    with tempfile.TemporaryDirectory() as root:
        for i in range(2):
            out = os.path.join(root, f"run{i}")
            os.makedirs(out)
            t0 = time.perf_counter()
            # a fresh interpreter with a fresh CUDA context each time
            proc = multiprocessing.get_context("spawn").Process(target=repeat_worker, args=(out,))
            proc.start()
            proc.join(timeout=900)
            if proc.is_alive():
                proc.kill()
                proc.join()
            check(proc.exitcode == 0, f"repeat worker {i} exited with {proc.exitcode}")
            with open(os.path.join(out, "record.json")) as f:
                runs.append((json.load(f), torch.load(os.path.join(out, "state.pt")), time.perf_counter() - t0))
    (ra, sa, ta), (rb, sb, tb) = runs
    losses_equal = ra["losses"] == rb["losses"]
    state_equal = sa.keys() == sb.keys() and all(torch.equal(sa[k], sb[k]) for k in sa)
    first = next(((i, stage) for i, (a, b) in enumerate(zip(ra["steps"], rb["steps"])) for stage in a
                  if a[stage] != b.get(stage)), None)
    n_steps = len(ra["steps"])
    check(n_steps == len(rb["steps"]) == F2_STEPS_PER_EPOCH * F2_EPOCHS, f"the workers ran {n_steps} steps")
    print(f"F2, {n_steps} bf16 Conformer-M train steps (conv_impl='pallas', NST corpus, seed {SEED}) in two fresh "
          f"processes ({ta:.1f} s and {tb:.1f} s each): losses {'equal' if losses_equal else 'unequal'} ("
          + " ".join(f"{float.fromhex(x):.6f}" for x in ra["losses"]) + " / "
          + " ".join(f"{float.fromhex(x):.6f}" for x in rb["losses"]) + f"); final parameters and optimizer state "
          f"{'bit-equal' if state_equal else 'unequal'}; first stage whose bits differ: "
          + (f"step {first[0]}, {first[1]}" if first else "none") + f"  [{card}]")

    # -- each group's op twice on the same inputs, in this process (the NST phase's longer bucket and the 30 s
    #    step's shapes: B=16, T'=235, 100 targets, vocabulary 1024)
    gen = torch.Generator().manual_seed(SEED + 9)
    verdicts = {}
    augment = make_augment_step(FeatureConfig(), SpecAugmentConfig())
    audio = (torch.randn(NST_BATCH, NST_LONGEST, generator=gen) * 0.1).cuda()
    alen = mixed_lengths(gen, NST_BATCH, NST_LONGEST, NST_LONGEST // 3).cuda()
    feats = [augment(torch.Generator(device="cuda").manual_seed(SEED), audio, alen)[0] for _ in range(2)]
    verdicts["SpecAugment draws and time warp"] = torch.equal(*feats)
    model = init_params(ConformerCTC(conformer_m(use_pallas=True), VOCAB), gen).cuda()
    sub = model.subsampling
    x = feats[0]

    def subsampling_grads():
        sub.zero_grad(set_to_none=True)
        out, _ = sub(x, torch.full((NST_BATCH,), x.shape[1], device="cuda"), torch.bfloat16)
        out.float().square().sum().backward()
        return [p.grad.clone() for p in sub.parameters()]

    verdicts["subsampling convs forward and backward"] = all(map(torch.equal, subsampling_grads(), subsampling_grads()))
    b, t, target_len = BATCH, T_SUB, TARGET_LEN
    log_probs = torch.log_softmax(torch.randn(b, t, VOCAB, generator=gen) * 2, -1).cuda()
    labels = torch.randint(3, VOCAB, (b, target_len), generator=gen).cuda()
    ext = TC.extended_labels(labels, torch.full((b,), target_len, device="cuda"), 0)[0]
    g = torch.randn(b, t, ext.shape[1], generator=gen).cuda()

    def gather_grad(fn):
        leaf = log_probs.clone().requires_grad_(True)
        (grad,) = torch.autograd.grad(fn(leaf), leaf, g)
        return grad

    torch_gather = lambda lp: torch.gather(lp, 2, ext[:, None, :].expand(b, t, -1))  # noqa: E731
    verdicts["the CTC gather's adjoint (the port's emit_log_probs)"] = torch.equal(
        gather_grad(lambda lp: TC.emit_log_probs(lp, ext)), gather_grad(lambda lp: TC.emit_log_probs(lp, ext)))
    verdicts["torch.gather's own adjoint (scatter-add), same inputs"] = torch.equal(
        gather_grad(torch_gather), gather_grad(torch_gather))
    # what the port's deterministic adjoint costs against torch's scatter-add, at the 30 s step's shape here and
    # at the 120 s step's (B=4, T'=938, 400 targets)
    costs = {(b, t): (device_ms(lambda: gather_grad(lambda lp: TC.emit_log_probs(lp, ext)), iters=10),
                      device_ms(lambda: gather_grad(torch_gather), iters=10))}
    b2, t2, l2 = LONG_BATCH, LONG_T_SUB, LONG_TARGET_LEN
    log_probs = torch.log_softmax(torch.randn(b2, t2, VOCAB, generator=gen) * 2, -1).cuda()
    ext = TC.extended_labels(torch.randint(3, VOCAB, (b2, l2), generator=gen).cuda(),
                             torch.full((b2,), l2, device="cuda"), 0)[0]
    g = torch.randn(b2, t2, ext.shape[1], generator=gen).cuda()
    torch_gather = lambda lp: torch.gather(lp, 2, ext[:, None, :].expand(b2, t2, -1))  # noqa: E731
    costs[(b2, t2)] = (device_ms(lambda: gather_grad(lambda lp: TC.emit_log_probs(lp, ext)), iters=10),
                       device_ms(lambda: gather_grad(torch_gather), iters=10))
    print("F2, the CTC gather forward + backward, device time (calls queued back to back), the port's (one-hot contraction in "
          "float64) against torch.gather's (scatter-add with atomics): "
          + "; ".join(f"B={k[0]}, T'={k[1]}: {ours:.4f} ms against {lib:.4f} ms"
                                                      for k, (ours, lib) in costs.items()) + f"  [{card}]")
    h = torch.randn(b, t, 320, generator=gen).cuda()
    dxw = torch.randn(b, t, 1280, generator=gen).cuda()
    verdicts["lstm_dwhh, two launches"] = torch.equal(L.lstm_weight_grad(h, dxw), L.lstm_weight_grad(h, dxw))
    params = [torch.nn.Parameter(torch.randn(shape, generator=gen).cuda()) for shape in ((320, 1280), (1024,), (4, 64))]
    grads = [torch.randn(p.shape, generator=gen).cuda() for p in params]

    def adafactor_update():
        leaves = [torch.nn.Parameter(p.detach().clone()) for p in params]
        opt = make_optimizer(OptimizerConfig(), [(f"p{i}", leaf) for i, leaf in enumerate(leaves)])
        for leaf, grad in zip(leaves, grads):
            leaf.grad = grad.clone()
        opt.step()
        return leaves

    verdicts["one Adafactor update"] = all(map(torch.equal, adafactor_update(), adafactor_update()))
    torch.cuda.synchronize()
    print("F2, each step group's op twice on the same inputs in one process: "
          + "; ".join(f"{k} {'bit-equal' if v else 'UNEQUAL'}" for k, v in verdicts.items()) + f"  [{card}]")
    check(verdicts["lstm_dwhh, two launches"], "two lstm_dwhh launches on the same inputs are not bit-equal")
    check(verdicts["the CTC gather's adjoint (the port's emit_log_probs)"], "the CTC gather's adjoint is not bit-equal")
    check(losses_equal and state_equal, f"F2: two fresh processes differ, first at {first}")
    return {"losses_equal": losses_equal, "state_equal": state_equal, "first": first, **verdicts}


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
    long_results = check_kernels(card, LONG_BATCH, LONG_SECONDS, LONG_T_SUB, inference_attention=False)
    long_results.update(check_train_kernels(card, LONG_BATCH, LONG_T_SUB, LONG_TARGET_LEN))
    print("at the long-form shapes, kernel ms against bound ms (and the library call's): " + ", ".join(
        f"{name} {r['ms']:.4f} / {r['bound_ms']:.4f} ({r['bound_by']}" + (
            f"; library {r['library_ms']:.4f})" if r["library_ms"] is not None else ")") for name, r in long_results.items()))
    # and at the Noisy Student phase's two buckets, where a row is shorter than the conv kernel's 64-row tile and
    # the attention kernel's 32-row tile: every block is one partial tile with halo on both sides
    for n_samples, frames in NST_BUCKETS:
        check_kernels(card, NST_BATCH, n_samples / 16000, frames, inference_attention=True)
        check_train_kernels(card, NST_BATCH, frames, NST_MAX_WORDS)
    results.update(check_attention_backward_kernels(card))
    results.update(check_depthwise_conv_kernel(card))
    serve = check_slice(card)
    train = check_train(card, BATCH, SECONDS, TARGET_LEN, long_form=False)
    long_train = check_train(card, LONG_BATCH, LONG_SECONDS, LONG_TARGET_LEN, long_form=True)
    # the same pass and the same 30 s step where the depthwise conv is the hand-written kernel, then the NST generation
    serve_conv = check_slice(card, conv_impl="pallas")
    train_conv = check_train(card, BATCH, SECONDS, TARGET_LEN, long_form=False, conv_impl="pallas")
    # the float32 step, kernel path against plain path, once more at the NST phase's longer bucket
    check_train(card, NST_BATCH, NST_LONGEST / 16000, NST_MAX_WORDS, long_form=False, conv_impl="pallas")
    nst = check_nst(card)
    # the bias-input attention (the kernel, then its own op path), beam-search evaluation, the command line
    results.update(check_bias_attention_kernel(card))
    op = check_bias_attention_op(card)
    beam = check_beam(card)
    cli = check_cli(card)
    # F2: the same ten train steps in two fresh processes, bit for bit
    check_repeatability(card)
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
        "depthwise_conv": ("csrc/depthwise_conv.cu", f"{pallas}/depthwise_conv.py:50"),
        "attention_bias": ("csrc/attention_bias.cu", f"{pallas}/attention.py:64"),
    }
    model_paths = (serve, train, long_train, serve_conv, train_conv, nst, beam, cli)
    paths = (*model_paths, op)
    print("launches, pseudo-label pass + 30 s train steps + long-form train steps, then under conv_impl='pallas' the "
          "pass + the 30 s steps + the NST generation, then beam-search evaluation + the command line + the bias-input "
          f"op: { {k: tuple(path.get(k, 0) for path in paths) for k in sources} }")
    # no model routes through the bias-input attention, here as in the JAX package: its path is its own op
    check(not any(path.get("attention_bias", 0) for path in model_paths), "a model path launched the bias-input attention")
    check(op["attention_bias"] > 0, "the bias-input op's own path did not launch its kernel")
    for name in sources:
        if name != "attention_bias":
            check(sum(path.get(name, 0) for path in model_paths) > 0, f"no model path launched {name}")
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"nn_conformer_for_speech_recognition_tpu_torch/{src}",
            "replaces": f"nn_conformer_for_speech_recognition_tpu/{tpu}",
            "launches": sum(path.get(name, 0) for path in paths),
            **results[name],
        }
        for name, (src, tpu) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    main()
