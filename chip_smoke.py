#!/usr/bin/env python3
"""Drives the PyTorch/CUDA port once on one NVIDIA GPU and checks its kernels.

Run from the root of a checkout:  python3 chip_smoke.py
(``python3 chip_smoke.py --ctc-times [TREE]`` times only the CTC kernels of
the checkout at TREE, this one by default: see `ctc_times_main`;
``--conv-times [TREE]`` the depthwise conv's: see `conv_times_main`.)

1. Prints the card's name and power limit, then builds the hand-written
   kernels from ``csrc/`` with nvcc, one process per source (the
   compiler's ``-Xptxas -v`` report is printed).
2. Holds each kernel against its plain PyTorch twin on the card at the
   shapes of the main paths (Conformer-M; B=16, 30 s clips, targets of
   100 tokens; B=4, 120 s clips, targets of 400 tokens; and the two
   buckets of the Noisy Student phase, B=16 clips of 1.8 s and 3.6 s,
   T'=14 and 28, targets of 8 tokens), with mixed lengths, and times both
   with CUDA events after warm-up.  The CTC kernels are also read against
   the same recursions in float64 beside their twins, launched twice for
   bit-equal results, timed on the card alone (`device_ms`) beside their
   serial floor, and their plan's builds must not spill; the log-mel
   kernel is read against the same function in float64 (at most twice the
   twin's error), twice for bit-equal launches, beside the cuFFT route.  Beside each time it works
   out the least time the card could take for the same work
   (bytes over the memory rate against operations over the peak rate) and,
   where one PyTorch call computes the same function, times that call (for
   the LSTM recurrences, cuDNN's LSTM on a packed sequence, one direction
   and bidirectional).  The LSTM recurrences run both directions in one
   launch of the cluster kernels: that launch is held to the twin of each
   direction and to each direction alone, bit for bit, and timed beside one
   direction alone; then the grid route, which Conformer-L's H = 640 takes
   (both directions in one cooperative launch), at both train shapes
   against its twins, bit-equal across launches and to each direction
   alone, free of spills, timed beside cuDNN's LSTM at that width and its
   serial floor (a grid barrier timed alone), and a grid too large to be
   resident refused.
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
   Then Conformer-L (``conformer_l(use_pallas=True)``: 17 blocks, d_model
   512, 8 heads, BiLSTM H = 640) at full width and depth: the pass of
   phase 3 and the 30 s step of phase 4, the same checks, its BiLSTM
   through the grid kernels (one forward a pass; one forward and one
   backward a step; no cluster launch).
6. The configuration whose depthwise conv is the hand-written kernel
   (``conformer_m(use_pallas=True, conv_impl='pallas')``): the kernels
   against their twins (the forward, the gradient with respect to x and
   the weight gradient dw with its tile-order reduce, two dw launches
   bit-equal, float32 and bfloat16, K = 33 and an even K, at both train
   shapes, the Noisy Student phase's and Conformer-L's C = 1024), each
   timed on the card alone beside one ``conv1d(groups=C)`` call and
   cuDNN's grouped weight gradient, every build free of spills; then the
   pseudo-label pass and the 30 s train step of phases 3 and 4 again under
   that configuration, each against the plain path from the same weights,
   timed and counted beside the 'auto' ones, one step under ``remat``, the
   float32 step against the plain path at the Noisy Student phase's longer
   bucket, and Conformer-L's 30 s step under
   ``conformer_l(use_pallas=True, conv_impl='pallas')``.
   Before those passes and steps, Adafactor's and the gradient norm's
   multi-tensor kernels (``ops/cuda/adafactor.py``) on Conformer-M's 514
   parameters: five Adafactor steps against the per-tensor loop on the same
   tensors, bit-equal twice, the run without the clip missing the bar; the
   norm against float64; their kernels' device time beside the bound of the
   bytes their passes move.  Every train step counts their launches (4 and
   2 a step), and the float32 plain path runs the per-tensor loops.
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
   convs, the gather behind the CTC loss, ``lstm_dwhh``, the cluster LSTM
   recurrences, Adafactor).
12. Pretraining and the language model: the LSTM kernels at the
   pretraining decoder's H = 160 (cluster route) against their twins at
   the pretrain step's shape (B=16, T'=235, beside cuDNN's LSTM) and the
   pretrain command's (T'=14 and 28); contrastive pretraining at
   Conformer-M's width and depth (`PretrainModel`, float32 as the JAX
   module, B=16 × 30 s): one step of the kernel path against the plain
   path (loss, every gradient, batch statistics), `PretrainTrainer`'s step
   timed and counted (log-mel and LSTM kernels only), the loss falling over
   ten steps, and the hand-off to ``Trainer.load_encoder_only``, which must
   change nothing; `LMTrainer` at `LMConfig`'s defaults; the pronunciation
   LM as ``Trainer(lm_apply=...)`` over Conformer-M, greedy and beam, the
   float32 fused evaluation held between the kernel and the plain path and
   the bf16 one timed against the unfused; `fuse_lm_weights_into_asr` on
   the card; then ``pretrain`` and ``train --encoder-checkpoint`` on the
   command line.
13. Device-resident data (Conformer-M, bf16, B=16, a corpus of 64 seeded
   clips of 28-30 s with 100-word transcripts, vocabulary 1024, written to
   a temporary directory): the native WAV decode against the pure-Python
   one, sample for sample and through ``BucketedDataset.make_batch``;
   ``DeviceResidentDataset`` on the card; ``Trainer.train`` over it (its
   resident source) against ``Trainer.train`` over the host dataset's same
   batches (its host source) from one seed, every loss and state tensor
   bit-equal, with the launch counts of both; one epoch of
   ``make_epoch_scan_step`` under
   ``torch.cuda.set_sync_debug_mode('error')``.  Then the encoder variants at
   Conformer-M's size (``use_relative_attention=False``; ``conv_norm``
   'groupnorm' and 'layernorm' under ``conv_impl`` 'auto' and 'pallas'):
   the float32 pass, kernel path against plain path, and three bf16 train
   steps with the loss falling.
14. Data parallelism over processes (`parallel.mesh`; Conformer-M bf16,
   B=16 × 30 s on the resident corpus): at world size 1 over NCCL, three
   train steps through the data-parallel path bit-equal to the same steps
   without a process group, ``evaluate`` and ``generate_labels`` through
   their gathers, ms/step and device ms/step with and without the group
   and the launches it adds, a ``utils.profiling.trace`` of one step that
   must name every hand-written kernel the step launched, and a resident
   epoch of ``make_epoch_scan_step`` under ``set_sync_debug_mode('error')``
   with the group on; then two processes sharing the card over gloo
   (Conformer-M's widths at two blocks, float32) against one process at the
   CPU tests' bars; then ``utils.guards.check_step`` on a step fed a NaN, which must
   raise.
15. Tensor and sequence parallelism (`check_model_parallel`; Conformer-M
   bf16 at full width, two blocks, the long-form batch B=4 × ≤120 s):
   the rel-pos kernels (2 with and without lse, 5, 6, 7) on a head slice
   bit-equal to the same heads of the whole launch; ``seq_parallel`` at
   world size 1 over NCCL, its fallback counted and the step bit-equal to
   the plain one; then two processes sharing the card over gloo: the step
   split over a model axis of 2 and the sequence-parallel step over a data
   axis of 2 against one process, the sequence-parallel forward bit-equal
   to the data-parallel one, the vocabulary-sharded beam search against
   the dense one, the LM and pretraining trainers data-parallel, and the
   dry run's twin.
16. Prints one JSON line with each kernel's numbers, then, as the last line,
   ``{"ok": true, "device": {...}}``.

Any failure raises and exits non-zero.  There is no CPU path: without a
CUDA device the script exits non-zero before printing any result.
"""

import contextlib
import ctypes
import dataclasses
import functools
import io
import json
import math
import multiprocessing
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Optional

import numpy as np
import torch

REPO = Path(__file__).resolve().parent
BATCH, SECONDS, VOCAB, SEED, TARGET_LEN = 16, 30.0, 1024, 0, 100
N_BATCHES = 3  # pseudo-label batches timed and counted
N_TRAIN_STEPS = 5  # bf16 train steps timed and counted, after two warm-up steps
LOSS_STEPS, LOSS_LR = 10, 1e-3  # the loss must fall over 10 steps at this lr
LONG_BATCH, LONG_SECONDS, LONG_TARGET_LEN = 4, 120.0, 400  # the long-form step: T'=938, S=801
T_SUB, LONG_T_SUB = 235, 938  # frames after subsampling; check_train holds them to the model's own count
# the benchmark's conformer_m.train step: 64 rows of 30 s clips at 10 ms hops, T'=751, rows of 20-30 s
CELL_BATCH, CELL_T_SUB = 64, 751
DIRECTIONS = (False, True)  # a BiLSTM's two directions: reverse flags
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
    # dw against its twin, relative to its largest entry: float32 sums over B·T rows in the same tile order, the
    # products fused in the kernel; the twin's own sum inside a tile runs in another order
    "depthwise_conv_dw": 1e-5,
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
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import adafactor as AF
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import ctc as K
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import depthwise_conv as D
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import stft_logmel as S

    return {
        "stft_logmel": S.stft_logmel, "attention_relpos": A.flash_relpos_attention, "lstm": L.lstm_forward_cluster,
        "lstm_backward": L.lstm_backward_cluster, "lstm_weight_grad": L.lstm_weight_grad,
        "ctc_alpha": K.ctc_alpha, "ctc_beta": K.ctc_beta,
        "attention_relpos_lse": A.flash_relpos_attention_forward_lse,
        "attention_relpos_bwd_dq": A.flash_relpos_attention_bwd_dq,
        "attention_relpos_bwd_dkv": A.flash_relpos_attention_bwd_dkv,
        "attention_relpos_bwd_dband": A.flash_relpos_attention_bwd_dband,
        "depthwise_conv": D.depthwise_conv1d_forward, "depthwise_conv_weight_grad": D.depthwise_conv1d_weight_grad,
        "attention_bias": A.flash_attention_forward,
        "lstm_grid": L.lstm_forward_grid, "lstm_backward_grid": L.lstm_backward_grid,
        "adafactor_step": AF.adafactor_step, "global_norm": AF.global_norm,
    }


def reset_counters() -> None:
    for wrapper in counters().values():
        wrapper.launches = 0


def read_counters() -> dict:
    return {name: wrapper.launches for name, wrapper in counters().items()}


# a train step's launches of the multi-tensor kernels: Adafactor's four passes (with the clip) and the norm's two
UPDATE_LAUNCHES = {"adafactor_step": 4, "global_norm": 2}


def update_launches(steps: int) -> dict:
    return {k: v * steps for k, v in UPDATE_LAUNCHES.items()}


TRAIN_ATTENTION_KERNELS = ("attention_relpos_lse", "attention_relpos_bwd_dq", "attention_relpos_bwd_dkv",
                           "attention_relpos_bwd_dband")


def train_attention_launches(cfg, t_sub: int, block_steps: int) -> dict:
    """The rel-pos kernels' launches over ``block_steps`` (blocks × train
    steps) at ``t_sub`` subsampled frames: the forward with lse and the
    three backward kernels once each a block and step where training takes
    the kernels, none on the einsum route.  Written from the
    configuration's own fields and not from `config.attention_route`, so
    that a change to the route rule shows here as a wrong count: the
    kernels need ``use_pallas``, relative attention and ``attention_impl``
    'auto' or 'flash'; under 'auto' they train from 768 frames on, and
    below that only where no attention probability is dropped."""
    enc = cfg.encoder
    on = (cfg.use_pallas and enc.use_relative_attention and cfg.attention_impl in ("auto", "flash")
          and (cfg.attention_impl == "flash" or t_sub >= 768 or enc.attention_dropout == 0))
    return dict.fromkeys(TRAIN_ATTENTION_KERNELS, block_steps if on else 0)


@contextlib.contextmanager
def optimizer_loops():
    """Inside, Adafactor and the gradient norm run their per-tensor loops
    (the kernels' plain twins) on CUDA tensors too."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import adafactor as AF

    route = AF.on_kernel_route
    AF.on_kernel_route = lambda tensors: False
    try:
        yield
    finally:
        AF.on_kernel_route = route


def mixed_lengths(gen: torch.Generator, n: int, full: int, low: int) -> torch.Tensor:
    lengths = torch.randint(low, full + 1, (n,), generator=gen)
    lengths[0] = full
    return lengths.to(torch.int32)


def check_kernels(card: str, b: int, seconds: float, t: int, inference_attention: bool) -> dict:
    """The log-mel and LSTM-forward kernels against their plain twins at the
    shapes of one main path (``b`` clips of ``seconds``, ``t`` frames
    after subsampling), and the inference attention forward where that
    path runs it."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.ops import features as F
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import stft_logmel as S

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED)
    results = {}

    # -- stft_logmel: (16, 480000) f32 → (16, 938, 40); (4, 1920000) → (4, 3751, 40)
    cfg = FeatureConfig()
    n_samples = round(seconds * cfg.sample_rate)
    audio = (torch.randn(b, n_samples, generator=gen) * 0.1).to(dev)
    got, ref, again = S.stft_logmel(audio, cfg), S.stft_logmel_plain(audio, cfg), S.stft_logmel(audio, cfg)
    ref64 = S.stft_logmel_float64(audio, cfg)
    library = cufft_logmel(audio, cfg)
    torch.cuda.synchronize()
    check(got.shape == ref.shape == (b, cfg.num_frames(n_samples), cfg.n_mels),
          f"stft_logmel shape {tuple(got.shape)}")
    err = max_abs(got, ref)
    kernel64, twin64 = ((x.double() - ref64).abs().max().item() for x in (got, ref))
    ms = cuda_ms(lambda: S.stft_logmel(audio, cfg))
    plain_ms = cuda_ms(lambda: S.stft_logmel_plain(audio, cfg))
    library_ms = cuda_ms(lambda: cufft_logmel(audio, cfg))
    dev_ms, plain_dev, library_dev = (device_ms(lambda: fn(audio, cfg))
                                      for fn in (S.stft_logmel, S.stft_logmel_plain, cufft_logmel))
    plan = S.stft_logmel_tc_plan(cfg.n_fft, b * got.shape[1])
    print(f"stft_logmel ({b}, {n_samples}) f32: max|Δ| {err:.3e} (tol {TOL['stft_logmel']}); against float64 kernel "
          f"{kernel64:.3e}, twin {twin64:.3e} (kernel at most 2× the twin's), two launches bit-equal; kernel "
          f"{ms:.4f} ms, device {dev_ms:.4f}; plain {plain_ms:.4f}, device {plain_dev:.4f}; cuFFT route (torch.stft "
          f"+ |·|² + mel matmul + log) {library_ms:.4f}, device {library_dev:.4f}, max|Δ| against the twin "
          f"{max_abs(library, ref):.3e}; plan {plan}  [{card}]")
    check(err <= TOL["stft_logmel"], "stft_logmel disagrees with its plain twin")
    check(kernel64 <= 2 * twin64, "stft_logmel: the kernel lies more than twice as far from float64 as the twin")
    check(torch.equal(got, again), "stft_logmel is not bit-equal from launch to launch")
    check(plan["local_bytes"] == 0 and plan["blocks_per_sm"] >= 1, f"stft_logmel plan {plan}")
    # read once: audio and the kernel's tables (window, the folded basis, mel_fb, bands); written: the log-mel.
    # The operations the function needs, not the kernel's DFT (3 × 2·(n_fft−1)·(n_fft+1)/2 TF32 products a
    # frame, ~70× more): a frame's real FFT, 2.5·n·log2(n), and the mel product over the filterbank's
    # nonzeros, at float32.  The library yardstick is the cuFFT route (four calls: no one PyTorch call
    # computes the log-mel)
    window, _, _, mel_fb = F.feature_constants(cfg, dev)
    tables = (window, *F.kernel_constants(cfg, dev), mel_fb)
    stft_ops = b * got.shape[1] * (2.5 * cfg.n_fft * math.log2(cfg.n_fft) + 2 * int((mel_fb != 0).sum()))
    results["stft_logmel"] = numbers(err, ms, plain_ms, nbytes(audio, got, *tables), stft_ops, torch.float32,
                                     library_ms=library_ms)

    lengths = mixed_lengths(gen, b, t, t // 3)
    if inference_attention:
        results["attention_relpos"] = check_attention_kernel(card, b, t, conformer_m().encoder.num_heads, lengths, gen)

    # -- the LSTM forward recurrence, H=320: a direction's xw (16, 235, 1280) or (4, 938, 1280) f32 and w_hh
    #    (320, 1280); both directions in one cluster launch (the model's call) and each direction alone
    hidden = 320
    xws = [torch.randn(b, t, 4 * hidden, generator=gen).to(dev) for _ in DIRECTIONS]
    w_hhs = [(torch.randn(hidden, 4 * hidden, generator=gen) * hidden ** -0.5).to(dev) for _ in DIRECTIONS]
    lengths = lengths.to(dev)
    both = L.lstm_directions(xws, w_hhs, lengths, DIRECTIONS)
    errs = []
    for xw, w, reverse, h in zip(xws, w_hhs, DIRECTIONS, both):
        errs.append(max_abs(h, L.lstm_plain(xw, w, lengths, reverse)))
        check(torch.equal(h, L.lstm(xw, w, lengths, reverse=reverse)),
              "lstm: the two-direction launch and one direction alone differ")
    torch.cuda.synchronize()
    err = max(errs)
    times = {
        "both directions, one launch": lambda: L.lstm_directions(xws, w_hhs, lengths, DIRECTIONS),
        "one direction": lambda: L.lstm(xws[1], w_hhs[1], lengths, reverse=True),
    }
    events = {k: cuda_ms(fn) for k, fn in times.items()}
    device = {k: device_ms(fn) for k, fn in times.items()}
    plain_ms = cuda_ms(lambda: [L.lstm_plain(*a, lengths, r) for *a, r in zip(xws, w_hhs, DIRECTIONS)], iters=5)
    cudnn = {k: cudnn_lstm_ms(b, t, hidden, lengths, gen, bidirectional=k) for k in (False, True)}
    steps_live = int(lengths.max())
    floor = serial_floor_ms(b, hidden, steps_live)
    print(f"lstm ({b}, {t}, 4x320) f32: max|Δ| fwd {errs[0]:.3e} bwd {errs[1]:.3e} (tol {TOL['lstm']}), the two-direction "
          "launch bit-equal to each direction alone; kernel ms (events / device): " + ", ".join(
              f"{k} {events[k]:.4f} / {device[k]:.4f}" for k in times)
          + f"; cluster {device['one direction'] / steps_live * 1e3:.2f} us a step over {steps_live} steps, serial "
          f"floor {floor:.4f} ms (a cluster barrier {cluster_barrier_us():.3f} us); plain, both directions "
          f"{plain_ms:.4f} ms; cuDNN's LSTM on the packed sequence (input "
          f"projection included), forward: one direction {cudnn[False]['forward']:.4f} ms, bidirectional "
          f"{cudnn[True]['forward']:.4f} ms  [{card}]")
    check(err <= TOL["lstm"], "lstm disagrees with its plain twin")
    # both directions: per valid step h·W_hh, 2·H·4H operations; read xw and W_hh, write h
    steps = 2 * int(lengths.sum())
    results["lstm"] = numbers(err, events["both directions, one launch"], plain_ms,
                              nbytes(*xws, *w_hhs) + 2 * 4 * b * t * hidden, 8 * hidden * hidden * steps,
                              torch.float32, library_ms=cudnn[True]["forward"])
    return results


def check_attention_kernel(card: str, b: int, t: int, heads: int, lengths: torch.Tensor,
                           gen: torch.Generator) -> dict:
    """The inference rel-pos attention forward against its plain twin at
    ``b`` rows of ``t`` frames and ``heads`` heads of 64 (a model's pass:
    Conformer-M's 4, Conformer-L's 8), in float32 (the CUDA-core kernel)
    and bf16 (the tensor-core kernel, the main path's type); returns the
    bf16 kernel's numbers."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A

    dev = torch.device("cuda")
    dh = 64
    qu, qv, k, v = (torch.randn(b, t, heads, dh, generator=gen) * 0.5 for _ in range(4))
    p = torch.randn(2 * t - 1, heads, dh, generator=gen) * 0.5
    args32 = [x.to(dev) for x in (qu, qv, k, v, p)] + [lengths.to(dev), dh ** -0.5]
    args16 = [x.to(torch.bfloat16) for x in args32[:5]] + args32[5:]
    err32 = max_abs(A.flash_relpos_attention(*args32), A.flash_relpos_attention_plain(*args32))
    ref16 = A.flash_relpos_attention_plain(*args16)
    err16 = max_abs(A.flash_relpos_attention(*args16), ref16)
    bar16 = bf16_bar(ref16, floor=TOL["attention_f32"])  # the bf16 kernel: the tensor-core one
    torch.cuda.synchronize()
    ms32 = cuda_ms(lambda: A.flash_relpos_attention(*args32))
    plain_ms32 = cuda_ms(lambda: A.flash_relpos_attention_plain(*args32))
    ms = cuda_ms(lambda: A.flash_relpos_attention(*args16))
    plain_ms = cuda_ms(lambda: A.flash_relpos_attention_plain(*args16))
    dev_ms = device_ms(lambda: A.flash_relpos_attention(*args16))
    print(f"attention_relpos ({b}, {t}, {heads}, {dh}), lengths {lengths.tolist()[:4]}…: f32 max|Δ| {err32:.3e} "
          f"(tol {TOL['attention_f32']}), kernel {ms32:.4f} ms, plain {plain_ms32:.4f} ms; bf16 max|Δ| "
          f"{err16:.3e} (tol {bar16:.3e}, one bf16 ulp at the largest entry; and {TOL['attention_bf16']}), "
          f"kernel {ms:.4f} ms, device {dev_ms:.4f} ms, plain {plain_ms:.4f} ms  [{card}]")
    check(err32 <= TOL["attention_f32"], f"attention (f32, {heads} heads) disagrees with its plain twin")
    check(err16 <= min(bar16, TOL["attention_bf16"]), f"attention (bf16, {heads} heads) disagrees with its plain twin")
    # 6·H·dh operations for each (query, valid key) pair; no one PyTorch call computes rel-pos attention
    pairs = t * int(lengths.sum())
    return numbers(err16, ms, plain_ms, nbytes(*args16[:5], args16[0]), 6 * heads * dh * pairs, torch.bfloat16)


def cufft_logmel(audio: torch.Tensor, cfg) -> torch.Tensor:
    """The log-mel kernel's library yardstick (the port never calls it):
    ``torch.stft`` (cuFFT) on the centered, reflect-padded frames under the
    same window, |·|², the mel product and the log of the clamp."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops import features as F

    window, _, _, mel_fb = F.feature_constants(cfg, audio.device)
    spec = torch.stft(audio, cfg.n_fft, cfg.hop_length, window=window, center=True, pad_mode="reflect",
                      return_complex=True)
    return torch.log(torch.clamp_min(spec.abs().square().transpose(1, 2) @ mel_fb, cfg.log_floor))


def serial_floor_ms(b: int, hidden: int, steps: int) -> float:
    """The least time of the cluster recurrence's chain of ``steps``
    dependent steps: each one CTA's share of the step's product (min(b, 16)
    rows, rounded up to the kernel's groups of 4, by H by 4H/16 columns) at
    one SM's share of the float32 peak, plus one cluster barrier as the card
    times it (`cluster_barrier_us`)."""
    rows = 4 * ((min(b, 16) + 3) // 4)
    share = 2 * rows * hidden * 4 * -(-hidden // 16)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    return steps * (share / (PEAK_FLOPS[torch.float32] / sms) * 1e3 + cluster_barrier_us() * 1e-3)


# The CTC kernels' work a state and step: float32 operations (alpha: logaddexp3's four max/min, two differences,
# two adds and the max's add, then the emit's add; beta the same with eb's add, and the posterior's add, difference,
# min and product) and special-function operations (two exps and a log; beta's posterior one more exp)
CTC_STEP_OPS = {"alpha": (10, 3), "beta": (14, 4)}
SFU_PER_CLOCK = 16  # an SM's special-function results a clock (CUDA's throughput table, compute capability 9.0)


def ctc_serial_floor_ms(states: int, steps: int, kernel: str = "alpha") -> float:
    """The least time of a CTC kernel's chain of ``steps`` dependent steps
    over ``states`` states, which one SM walks (one block a row): each
    step's float32 arithmetic at one SM's share of the float32 peak, its
    exps and logs at the SM's 16 special-function results a clock (the clock
    the float32 peak implies: 128 FMAs a clock an SM), and one block barrier
    with one shared-memory round trip at the kernel's plan's threads, as the
    card times them (`ctc_step_us`)."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import ctc as K

    ops, sfu = CTC_STEP_OPS[kernel]
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    sm_flops = PEAK_FLOPS[torch.float32] / sms
    clock = sm_flops / 256
    step_s = states * ops / sm_flops + states * sfu / (SFU_PER_CLOCK * clock)
    return steps * (step_s * 1e3 + ctc_step_us(K.ctc_plan(states, kernel)["threads"]) * 1e-3)


@functools.lru_cache(maxsize=None)
def ctc_step_us(threads: int) -> float:
    """Microseconds of one block barrier with a shared-memory round trip in a
    block of ``threads``: events around 10,000 in one launch, less the same
    launch with 100."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    sink = torch.zeros(1, device="cuda")
    stream = build.stream_of(sink)

    def run(iters):
        build.check(build.library().ctc_step_probe(iters, threads, sink.data_ptr(), stream), "ctc_step_probe")

    long_ms, short_ms = cuda_ms(lambda: run(10_000), iters=5), cuda_ms(lambda: run(100), iters=5)
    return (long_ms - short_ms) / 9_900 * 1e3


def kernel_dtypes(can_skip: torch.Tensor, ext_len: torch.Tensor, input_lengths: torch.Tensor):
    """can_skip as uint8, the lengths as int32: the CTC kernels' own types, which their wrappers then pass on
    unconverted (in every tree of the port, for `ctc_times`)."""
    return can_skip.to(torch.uint8), ext_len.to(torch.int32), input_lengths.to(torch.int32)


@functools.lru_cache(maxsize=1)
def cluster_barrier_us() -> float:
    """Microseconds of one barrier of a 16-CTA cluster (two clusters, one CTA
    an SM, as the recurrences run): events around 10,000 barriers in one
    launch, less the same launch with 100."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    stream = build.stream_of(torch.zeros(1, device="cuda"))

    def run(iters):
        build.check(build.library().lstm_cluster_barrier_probe(iters, 320, stream), "lstm_cluster_barrier_probe")

    long_ms, short_ms = cuda_ms(lambda: run(10_000), iters=5), cuda_ms(lambda: run(100), iters=5)
    return (long_ms - short_ms) / 9_900 * 1e3


@functools.lru_cache(maxsize=1)
def grid_barrier_us() -> float:
    """Microseconds of one grid barrier of the grid recurrences (64 CTAs a
    direction, two directions, one CTA an SM with the forward's shared memory
    at Conformer-L's H = 640, as they run): events around 10,000 barriers in
    one cooperative launch, less the same launch with 100."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L

    plan = L.grid_plan(BATCH, 640, torch.cuda.get_device_properties(0).multi_processor_count, L.smem_optin(0))
    counters = torch.zeros(2, device="cuda", dtype=torch.int32)
    stream = build.stream_of(counters)

    def run(iters):
        counters.zero_()
        build.check(build.library().lstm_grid_barrier_probe(iters, plan["ctas"], 2, plan["smem_bytes"],
                                                            counters.data_ptr(), stream), "lstm_grid_barrier_probe")

    long_ms, short_ms = cuda_ms(lambda: run(10_000), iters=5), cuda_ms(lambda: run(100), iters=5)
    return (long_ms - short_ms) / 9_900 * 1e3


def grid_serial_floor_ms(b: int, hidden: int, steps: int) -> float:
    """The least time of the grid recurrence's chain of ``steps`` dependent
    steps: each one CTA's share of the step's product (the plan's rows by H
    by its 4·units columns) at one SM's share of the float32 peak, plus one
    grid barrier as the card times it (`grid_barrier_us`)."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L

    sms = torch.cuda.get_device_properties(0).multi_processor_count
    plan = L.grid_plan(b, hidden, sms, L.smem_optin(0))
    share = 2 * plan["rows"] * hidden * 4 * plan["units"]
    return steps * (share / (PEAK_FLOPS[torch.float32] / sms) * 1e3 + grid_barrier_us() * 1e-3)


def cudnn_lstm_ms(b: int, t: int, hidden: int, lengths: torch.Tensor, gen: torch.Generator,
                  bidirectional: bool = False, width: Optional[int] = None) -> dict:
    """The yardstick of the LSTM recurrence kernels (the port never calls
    it): cuDNN's LSTM through ``nn.LSTM``, one direction or both, float32,
    on a packed sequence at the same lengths, with the BiLSTM's input width
    (``width``, Conformer-M's by default), so it also computes the input
    projection x·W_ih that the kernels are handed done.  Its forward alone,
    its backward alone (``autograd.grad`` on the forward's graph, kept), and
    a forward with its backward."""
    from torch.nn.utils.rnn import PackedSequence, pack_padded_sequence

    from nn_conformer_for_speech_recognition_tpu_torch.config import conformer_m

    width = width or conformer_m().decoder.projection_dim
    layer = torch.nn.LSTM(width, hidden, batch_first=True, bidirectional=bidirectional).cuda()
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


def ctc_inputs(gen: torch.Generator, b: int, t: int, target_len: int):
    """The CTC kernels' inputs at a train step's shape, on the card: logits (b, t, V) and random labels of
    ``target_len`` tokens, row 1 of repeated pairs, row 2 an empty label, row 3 shorter than its targets
    (no alignment), the other rows ragged but long enough for their targets; then the emit gather.
    Returns logits, labels, label_lengths, input_lengths, emit, can_skip and ext_len."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops import ctc as TC

    dev = torch.device("cuda")
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
    return logits, labels, label_lengths, input_lengths, emit, can_skip, ext_len


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

    # -- LSTM training forward, backward and dW_hh: H=320, both directions, each recurrence one cluster launch
    hidden = 320
    xws = [torch.randn(b, t, 4 * hidden, generator=gen).to(dev) for _ in DIRECTIONS]
    w_hhs = [(torch.randn(hidden, 4 * hidden, generator=gen) * hidden ** -0.5).to(dev) for _ in DIRECTIONS]
    lengths = mixed_lengths(gen, b, t, t // 3).to(dev)
    gouts = [torch.randn(b, t, hidden, generator=gen).to(dev) for _ in DIRECTIONS]
    outs = L.lstm_forward_directions(xws, w_hhs, lengths, DIRECTIONS, save=True)
    refs = [L.lstm_forward_plain(xw, w, lengths, r) for xw, w, r in zip(xws, w_hhs, DIRECTIONS)]
    hs, cs, gates = (list(x) for x in zip(*outs))
    dxws = L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, DIRECTIONS)
    again = L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, DIRECTIONS)
    errs, werrs = [], []
    for i, reverse in enumerate(DIRECTIONS):
        h_ref, c_ref, g_ref = refs[i]
        errs.append(max(max_abs(hs[i], h_ref), max_abs(cs[i], c_ref), max_abs(gates[i], g_ref)))
        dxw_ref = L.lstm_backward_plain(gouts[i], g_ref, c_ref, w_hhs[i], lengths, reverse)
        errs.append(max_abs(dxws[i], dxw_ref))
        check(torch.equal(dxws[i], again[i]), "lstm_backward: two launches on the same inputs are not bit-equal")
        check(torch.equal(dxws[i], L.lstm_backward(gouts[i], gates[i], cs[i], w_hhs[i], lengths, reverse=reverse)),
              "lstm_backward: the two-direction launch and one direction alone differ")
        dw = L.lstm_weight_grad(hs[i], dxws[i], reverse=reverse)
        dw_ref = L.lstm_weight_grad_plain(h_ref, dxw_ref, reverse)
        werrs.append(max_abs(dw, dw_ref) / dw_ref.abs().max().item())
    torch.cuda.synchronize()
    fwd_err, bwd_err = max(errs[0], errs[2]), max(errs[1], errs[3])
    times = {
        "both directions, one launch": lambda: L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, DIRECTIONS),
        "one direction": lambda: L.lstm_backward(gouts[1], gates[1], cs[1], w_hhs[1], lengths, reverse=True),
    }
    events = {k: cuda_ms(fn) for k, fn in times.items()}
    device = {k: device_ms(fn) for k, fn in times.items()}
    plain_ms = cuda_ms(lambda: [L.lstm_backward_plain(*a, lengths, r)
                                for *a, r in zip(gouts, gates, cs, w_hhs, DIRECTIONS)], iters=5)
    fwd_times = {
        "both directions, one launch": lambda: L.lstm_forward_directions(xws, w_hhs, lengths, DIRECTIONS, save=True),
        "one direction": lambda: L.lstm_forward(xws[1], w_hhs[1], lengths, reverse=True, save=True),
    }
    fwd_device = {k: device_ms(fn) for k, fn in fwd_times.items()}
    h, dxw = hs[1], dxws[1]
    twice = [L.lstm_weight_grad(h, dxw, reverse=True) for _ in range(2)]
    torch.cuda.synchronize()
    check(torch.equal(*twice), "lstm_weight_grad is not bit-equal from launch to launch")
    wms = cuda_ms(lambda: L.lstm_weight_grad(h, dxw, reverse=True))
    wplain_ms = cuda_ms(lambda: L.lstm_weight_grad_plain(h, dxw, True))
    wdev = device_ms(lambda: L.lstm_weight_grad(h, dxw, reverse=True))
    wplain_dev = device_ms(lambda: L.lstm_weight_grad_plain(h, dxw, True))
    cudnn = {k: cudnn_lstm_ms(b, t, hidden, lengths, gen, bidirectional=k) for k in (False, True)}
    steps_live = int(lengths.max())
    print(f"lstm training forward ({b}, {t}, 4x320), both directions (h, c, gates) vs twin: max|Δ| {fwd_err:.3e} "
          f"(tol {TOL['lstm']}); device ms: " + ", ".join(f"{k} {v:.4f}" for k, v in fwd_device.items()) + f"  [{card}]")
    print(f"lstm_backward ({b}, {t}, 4x320) f32: dxw max|Δ| fwd {errs[1]:.3e} bwd {errs[3]:.3e} (tol "
          f"{TOL['lstm_backward']}), two launches bit-equal, the two-direction launch bit-equal to each direction alone; "
          "kernel ms (events / device): " + ", ".join(f"{k} {events[k]:.4f} / {device[k]:.4f}" for k in times)
          + f"; cluster {device['one direction'] / steps_live * 1e3:.2f} us a step over {steps_live} steps, serial floor "
          f"{serial_floor_ms(b, hidden, steps_live):.4f} ms; plain, both directions {plain_ms:.4f} ms  [{card}]")
    print(f"lstm_weight_grad (320 x {b * t})·({b * t} x 1280) f32: dW_hh max|Δ|/max|dW| fwd {werrs[0]:.3e} "
          f"bwd {werrs[1]:.3e} (tol {TOL['lstm_weight_grad']}), two launches bit-equal, kernel {wms:.4f} ms "
          f"({L.dwhh_plan(b * t, hidden, torch.cuda.get_device_properties(0).multi_processor_count)[0]} slices), "
          f"plain (the float32 einsum) {wplain_ms:.4f} ms; device time (calls queued back to back): kernel and reduce "
          f"{wdev:.4f} ms, einsum {wplain_dev:.4f} ms  [{card}]")
    print(f"cuDNN's LSTM at ({b}, {t}, 320) (its backward also gives dx, dW_ih and dW_hh), one direction: forward "
          f"{cudnn[False]['forward']:.4f} ms, backward {cudnn[False]['backward']:.4f} ms, forward + backward "
          f"{cudnn[False]['both']:.4f} ms; bidirectional: forward {cudnn[True]['forward']:.4f} ms, backward "
          f"{cudnn[True]['backward']:.4f} ms, forward + backward {cudnn[True]['both']:.4f} ms  [{card}]")
    check(fwd_err <= TOL["lstm"], "lstm training forward disagrees with its plain twin")
    check(bwd_err <= TOL["lstm_backward"], "lstm_backward disagrees with its plain twin")
    check(max(werrs) <= TOL["lstm_weight_grad"], "lstm_weight_grad disagrees with its plain twin")
    steps = 2 * int(lengths.sum())
    results["lstm_backward"] = numbers(bwd_err, events["both directions, one launch"], plain_ms,
                                       nbytes(*gouts, *gates, *cs, *w_hhs, *dxws), 8 * hidden * hidden * steps,
                                       torch.float32, library_ms=cudnn[True]["backward"])
    # the plain version is one einsum (a cuBLAS GEMM): it doubles as the library yardstick.  Bytes: h and dxw
    # read once, dW_hh written once; 2·H·4H operations a row, done three times (the 3×TF32 split that keeps
    # float32's accuracy on the tensor cores) at the TF32 rate
    results["lstm_weight_grad"] = numbers(max(werrs), wms, wplain_ms, nbytes(h, dxw, w_hhs[1]),
                                          3 * 8 * hidden * hidden * b * t, "tf32", library_ms=wplain_ms)

    # -- CTC alpha/beta: S = 2·target_len + 1 states, V=1024; one row of
    #    repeated pairs, one empty label, one impossible alignment
    s = 2 * target_len + 1
    logits, labels, label_lengths, input_lengths, emit, can_skip, ext_len = ctc_inputs(gen, b, t, target_len)
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
    twin64 = (demit_ref[possible].double() - demit64[possible]).abs().max().item()
    ll_err64, twin_ll64 = (((x[possible].double() - ll64[possible]).abs() / ll64[possible].abs()).max().item()
                           for x in (ll, ll_ref))
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
    # the kernels' own inputs (uint8, int32), converted once as CTCLogLikelihood does, so the times hold no conversion
    kin = (emit, *kernel_dtypes(can_skip, ext_len, input_lengths))
    check(torch.equal(alpha, K.ctc_alpha(*kin)), "ctc_alpha: two launches on the same inputs are not bit-equal")
    check(torch.equal(demit, K.ctc_beta(kin[0], alpha, *kin[1:], ll, g)),
          "ctc_beta: two launches on the same inputs are not bit-equal")
    plan = {kernel: K.ctc_plan(s, kernel) for kernel in ("alpha", "beta")}
    # every build, the plan's among them
    built = {f"{kernel} K={k}": K.ctc_kernel_attributes(kernel, k) for kernel, ks in K.STATES_PER_THREAD.items()
             for k in ks}
    ams, ams_events = device_ms(lambda: K.ctc_alpha(*kin)), cuda_ms(lambda: K.ctc_alpha(*kin))
    aplain_ms = cuda_ms(lambda: K.ctc_alpha_plain(emit, can_skip, ext_len, input_lengths), iters=5)
    bms, bms_events = (fn(lambda: K.ctc_beta(kin[0], alpha, *kin[1:], ll, g)) for fn in (device_ms, cuda_ms))
    bplain_ms = cuda_ms(lambda: K.ctc_beta_plain(emit, alpha, can_skip, ext_len, input_lengths, ll, g), iters=5)
    frames = int(input_lengths.max())  # the longest row's chain, which the launch waits for
    floors = {kernel: ctc_serial_floor_ms(s, frames - 1, kernel) for kernel in ("alpha", "beta")}
    print(f"ctc plan ({b}, {t}, {s}): {plan}; built: {built}  [{card}]")
    print(f"ctc_alpha ({b}, {t}, {s}) f32: ll max rel|Δ| {ll_err:.3e} (tol {TOL['ctc_alpha']}), two launches bit-equal, "
          f"kernel device {ams:.4f} ms ({ams / frames * 1e3:.3f} us a step over {frames} frames; events "
          f"{ams_events:.4f}), serial floor {floors['alpha']:.4f} ms, plain {aplain_ms:.4f} ms  [{card}]")
    print(f"ctc_beta ({b}, {t}, {s}) f32: demit max|Δ| {demit_err:.3e} (tol {TOL['ctc_beta']}), two launches bit-equal, "
          f"kernel device {bms:.4f} ms ({bms / frames * 1e3:.3f} us a step; events {bms_events:.4f}), serial floor "
          f"{floors['beta']:.4f} ms, plain {bplain_ms:.4f} ms  [{card}]")
    print(f"ctc against the float64 recursions ({b}, {t}, {s}): ll max rel|Δ| of the kernel {ll_err64:.3e}, of the twin "
          f"{twin_ll64:.3e}; demit max|Δ| of the kernels {kernel64:.3e} (tol {tol64}), of the twin {twin64:.3e}, of "
          f"autograd through the plain recursion {auto64:.3e}")
    print(f"ctc_loss_kernel vs torch.nn.functional.ctc_loss: loss max rel|Δ| {witness_loss:.3e} "
          f"(tol {TOL['ctc_witness_loss']}); logit-grad max|Δ| against torch's CTC in float64: the kernels "
          f"{ours64:.3e} (tol {tol64}), torch's float32 CTC {torch64:.3e}; the kernels against torch's "
          f"float32 CTC {witness_grad:.3e}")
    check(all(v["local_bytes"] == 0 for v in built.values()), f"the CTC kernels spill or keep a stack frame: {built}")
    check(ll_err <= TOL["ctc_alpha"], "ctc_alpha disagrees with its plain twin")
    check(demit_err <= TOL["ctc_beta"], "ctc_beta disagrees with its plain twin")
    check(kernel64 <= tol64, "ctc_beta disagrees with the float64 recursion")
    check(witness_loss <= TOL["ctc_witness_loss"], "ctc loss disagrees with torch's CTC")
    check(ours64 <= tol64, "ctc gradient disagrees with torch's CTC in float64")
    # torch's own CTC as the library yardstick: its forward beside alpha, its backward beside beta
    w = torch.log_softmax(logits, -1).transpose(0, 1).contiguous().requires_grad_(True)
    lib_loss = lambda: torch.nn.functional.ctc_loss(  # noqa: E731
        w, labels, input_lengths, label_lengths, reduction="sum", zero_infinity=True)
    loss = lib_loss()
    lib_bwd = lambda: torch.autograd.grad(loss, w, retain_graph=True)  # noqa: E731
    lib_fwd_ms, lib_bwd_ms = device_ms(lib_loss), device_ms(lib_bwd)
    print(f"torch.nn.functional.ctc_loss at the same shape: forward device {lib_fwd_ms:.4f} ms (events "
          f"{cuda_ms(lib_loss):.4f}), backward device {lib_bwd_ms:.4f} ms (events {cuda_ms(lib_bwd):.4f})  [{card}]")
    # about 10 operations per (frame, state): a three-term logsumexp; alpha reads emit and writes alpha,
    # beta reads emit and alpha and writes demit
    cells = int((input_lengths.to(torch.int64) * ext_len.to(torch.int64)).sum())
    results["ctc_alpha"] = numbers((ll - ll_ref).abs().max().item(), ams, aplain_ms, nbytes(emit, alpha), 10 * cells,
                                   torch.float32, library_ms=lib_fwd_ms)
    results["ctc_beta"] = numbers(demit_err, bms, bplain_ms, nbytes(emit, alpha, demit), 10 * cells, torch.float32,
                                  library_ms=lib_bwd_ms)
    return results


# (rows, frames, targets a row) of the CTC kernels' launches: the 30 s and the long-form train steps, the NST buckets
CTC_SHAPES = ((BATCH, T_SUB, TARGET_LEN), (LONG_BATCH, LONG_T_SUB, LONG_TARGET_LEN),
              *((NST_BATCH, frames, NST_MAX_WORDS) for _, frames in NST_BUCKETS))


def ctc_times(card: str) -> None:
    """Device time of the CTC kernels of whichever checkout's package is
    imported (`ctc_times_main`), on the same seeded inputs in every tree, at
    `CTC_SHAPES`."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import ctc as K

    print(f"ctc kernels of {Path(K.__file__).resolve().parents[3]}  [{card}]")
    for b, t, target_len in CTC_SHAPES:
        gen = torch.Generator().manual_seed(SEED + 12)
        _, _, _, input_lengths, emit, can_skip, ext_len = ctc_inputs(gen, b, t, target_len)
        kin = (emit, *kernel_dtypes(can_skip, ext_len, input_lengths))
        alpha = K.ctc_alpha(*kin)
        ll = K.final_ll(alpha[:, -1], ext_len)
        g = torch.randn(b, generator=gen).cuda()
        a_ms = device_ms(lambda: K.ctc_alpha(*kin))
        b_ms = device_ms(lambda: K.ctc_beta(kin[0], alpha, *kin[1:], ll, g))
        s = emit.shape[2]
        frames = int(input_lengths.max())
        print(f"ctc ({b}, {t}, {s}): device alpha {a_ms:.4f} ms, beta {b_ms:.4f} ms ({a_ms / frames * 1e3:.3f} / "
              f"{b_ms / frames * 1e3:.3f} us a step over {frames} frames)  [{card}]", flush=True)


def ctc_times_main(tree: Path) -> None:
    """``python3 chip_smoke.py --ctc-times [TREE]``: `ctc_times` for the port
    in the checkout at TREE (this one by default), built there: for timing a
    parent commit's kernels against this one's in turns, in one call."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    sys.path.insert(0, str(tree.resolve()))
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    card = card_line()
    print(card)
    build.build()
    ctc_times(card)


# the grid kernels' builds: (kernel index of `lstm_grid_kernel_attributes`, name)
GRID_BUILDS = ((0, "forward"), (1, "training forward"), (2, "backward"))


def check_grid_route(card: str, b: int, t: int) -> dict:
    """The route past the cluster's shared memory at Conformer-L's H = 640
    (input 512) and ``b`` rows of ``t`` frames (the 30 s and the long-form
    shapes): the grid kernels (inference and training forward, backward),
    both directions in one cooperative launch, against their twins for each
    direction, each direction alone and a second launch bit-equal, timed
    beside cuDNN's LSTM at that width (one direction and bidirectional) and
    their serial floor; every build free of spills; a grid the card cannot
    hold resident refused with a `RuntimeError`; and dW_hh at H = 640 (the
    `lstm_dwhh` GEMM kernel on the grid's h and dxw, as Conformer-L's step
    runs it) against its twin, two launches bit-equal.  Returns the
    kernels' numbers, dW_hh's as ``lstm_weight_grad_conformer_l``."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import conformer_l
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 11)
    dec = conformer_l().decoder
    hidden, sms = dec.lstm_hidden, torch.cuda.get_device_properties(0).multi_processor_count
    plan = L.grid_plan(b, hidden, sms, L.smem_optin(0))
    check(not L.cluster_plan(b, hidden, L.smem_optin(0))[0], f"H={hidden} fits the cluster's shared memory")
    check(L.route(b, hidden, dev) == ("grid", plan) and plan["directions"] == 2, f"grid plan {plan}")
    xws = [torch.randn(b, t, 4 * hidden, generator=gen).to(dev) for _ in DIRECTIONS]
    w_hhs = [(torch.randn(hidden, 4 * hidden, generator=gen) * hidden ** -0.5).to(dev) for _ in DIRECTIONS]
    gouts = [torch.randn(b, t, hidden, generator=gen).to(dev) for _ in DIRECTIONS]
    lengths = mixed_lengths(gen, b, t, t // 3).to(dev)
    before = read_counters()
    saved = L.lstm_forward_directions(xws, w_hhs, lengths, DIRECTIONS, save=True)
    hs = L.lstm_directions(xws, w_hhs, lengths, DIRECTIONS)
    refs = [L.lstm_forward_plain(xw, w, lengths, r) for xw, w, r in zip(xws, w_hhs, DIRECTIONS)]
    gates, cs = [s[2] for s in saved], [s[1] for s in saved]
    dxws = L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, DIRECTIONS)
    again = L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, DIRECTIONS)
    fwd_again = L.lstm_forward_directions(xws, w_hhs, lengths, DIRECTIONS, save=True)
    alone = [L.lstm_forward(xw, w, lengths, reverse=r, save=True) for xw, w, r in zip(xws, w_hhs, DIRECTIONS)]
    torch.cuda.synchronize()
    launches = {k: v - before[k] for k, v in read_counters().items()}
    check(launches == {**dict.fromkeys(launches, 0), "lstm_grid": 5, "lstm_backward_grid": 2},
          f"grid-route launch counts {launches}")
    fwd_errs, bwd_errs, werrs = [], [], []
    for i, reverse in enumerate(DIRECTIONS):
        fwd_errs += [max_abs(x, y) for x, y in zip(saved[i], refs[i])] + [max_abs(hs[i], refs[i][0])]
        dxw_ref = L.lstm_backward_plain(gouts[i], refs[i][2], refs[i][1], w_hhs[i], lengths, reverse)
        bwd_errs.append(max_abs(dxws[i], dxw_ref))
        dw = L.lstm_weight_grad(saved[i][0], dxws[i], reverse=reverse)
        dw_ref = L.lstm_weight_grad_plain(refs[i][0], dxw_ref, reverse)
        werrs.append(max_abs(dw, dw_ref) / dw_ref.abs().max().item())
        check(torch.equal(dw, L.lstm_weight_grad(saved[i][0], dxws[i], reverse=reverse)),
              "lstm_weight_grad at the grid route's H: two launches are not bit-equal")
        check(torch.equal(dxws[i], again[i]), "the grid backward: two launches are not bit-equal")
        check(all(map(torch.equal, saved[i], fwd_again[i])), "the grid forward: two launches are not bit-equal")
        check(all(map(torch.equal, saved[i], alone[i])), "the grid forward: both directions and one alone differ")
    check(torch.equal(dxws[1], L.lstm_backward(gouts[1], gates[1], cs[1], w_hhs[1], lengths, reverse=True)),
          "the grid backward: both directions and one alone differ")
    built = {}
    for kernel, name in GRID_BUILDS:
        for groups in range(1, 5):
            regs, local = ctypes.c_int(), ctypes.c_int()
            build.check(build.library().lstm_grid_kernel_attributes(kernel, groups, ctypes.byref(regs),
                                                                    ctypes.byref(local)), "lstm_grid_kernel_attributes")
            built[f"{name} rows {4 * groups}"] = (regs.value, local.value)
    # a grid no card holds resident: 1,000 CTAs a direction, passed through the C entry, is refused, not run
    forced = {**plan, "ctas": 1000, "units": 1}
    layout = L.grid_layout(hidden, 1000, plan["rows"])
    forced["smem_bytes"] = 4 * max(layout["fwd_floats"], layout["bwd_floats"])
    try:
        L.lstm_forward_grid(xws, w_hhs, lengths.to(torch.int32), DIRECTIONS, False, forced)
        refused = False
    except RuntimeError as err:
        refused = "cannot be resident" in str(err)
    check(refused, "a grid over the co-resident limit was not refused")
    steps_live = int(lengths.max())
    fwd = lambda: L.lstm_directions(xws, w_hhs, lengths, DIRECTIONS)  # noqa: E731
    fwd_save = lambda: L.lstm_forward_directions(xws, w_hhs, lengths, DIRECTIONS, save=True)  # noqa: E731
    bwd = lambda: L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, DIRECTIONS)  # noqa: E731
    fms, bms = cuda_ms(fwd), cuda_ms(bwd)
    fdev, fsave_dev, bdev = device_ms(fwd), device_ms(fwd_save), device_ms(bwd)
    fplain = cuda_ms(lambda: [L.lstm_plain(*a, lengths, r) for *a, r in zip(xws, w_hhs, DIRECTIONS)], iters=3)
    bplain = cuda_ms(lambda: [L.lstm_backward_plain(*a, lengths, r)
                              for *a, r in zip(gouts, gates, cs, w_hhs, DIRECTIONS)], iters=3)
    h, dxw = saved[1][0], dxws[1]
    wms = cuda_ms(lambda: L.lstm_weight_grad(h, dxw, reverse=True))
    wplain_ms = cuda_ms(lambda: L.lstm_weight_grad_plain(h, dxw, True))
    wdev = device_ms(lambda: L.lstm_weight_grad(h, dxw, reverse=True))
    wplain_dev = device_ms(lambda: L.lstm_weight_grad_plain(h, dxw, True))
    cudnn = {k: cudnn_lstm_ms(b, t, hidden, lengths, gen, bidirectional=k, width=dec.projection_dim)
             for k in (False, True)}
    floor = grid_serial_floor_ms(b, hidden, steps_live)
    print(f"lstm grid route ({b}, {t}, 4x{hidden}) f32, plan {plan}, builds (registers, local bytes) {built}  [{card}]")
    print(f"lstm grid route ({b}, {t}, 4x{hidden}), both directions in one launch: forward (h; h, c, gates) max|Δ| "
          f"{max(fwd_errs):.3e} (tol {TOL['lstm']}), kernel {fms:.4f} ms (device {fdev:.4f}; saving c and gates "
          f"{fsave_dev:.4f}), plain {fplain:.4f} ms; backward dxw max|Δ| {max(bwd_errs):.3e} (tol "
          f"{TOL['lstm_backward']}), kernel {bms:.4f} ms (device {bdev:.4f}), plain {bplain:.4f} ms; two launches "
          f"bit-equal, each direction alone bit-equal; {fdev / steps_live * 1e3:.2f} / {bdev / steps_live * 1e3:.2f} "
          f"us a step over {steps_live} steps, serial floor {floor:.4f} ms (a grid barrier {grid_barrier_us():.3f} us); "
          f"a grid of 1,000 CTAs a direction refused; cuDNN's LSTM (input {dec.projection_dim}), one direction: "
          f"forward {cudnn[False]['forward']:.4f} ms, backward {cudnn[False]['backward']:.4f} ms; bidirectional: "
          f"forward {cudnn[True]['forward']:.4f} ms, backward {cudnn[True]['backward']:.4f} ms  [{card}]")
    print(f"lstm_weight_grad ({hidden} x {b * t})·({b * t} x {4 * hidden}) f32 on the grid route's h and dxw: dW_hh "
          f"max|Δ|/max|dW| fwd {werrs[0]:.3e} bwd {werrs[1]:.3e} (tol {TOL['lstm_weight_grad']}), two launches "
          f"bit-equal, kernel {wms:.4f} ms ({L.dwhh_plan(b * t, hidden, sms)[0]} slices), plain (the float32 einsum) "
          f"{wplain_ms:.4f} ms; device time (calls queued back to back): kernel and reduce {wdev:.4f} ms, einsum "
          f"{wplain_dev:.4f} ms  [{card}]")
    check(all(local == 0 for _, local in built.values()), f"the grid kernels spill or keep a stack frame: {built}")
    check(max(fwd_errs) <= TOL["lstm"], "the grid forward disagrees with its plain twin")
    check(max(bwd_errs) <= TOL["lstm_backward"], "the grid backward disagrees with its plain twin")
    check(max(werrs) <= TOL["lstm_weight_grad"], "lstm_weight_grad at the grid route's H disagrees with its plain twin")
    # both directions: per valid step h·W_hh (or dgates·W_hhᵀ), 2·H·4H operations
    steps = 2 * int(lengths.sum())
    return {
        "lstm_grid": numbers(max(fwd_errs), fms, fplain, nbytes(*xws, *w_hhs) + 2 * 4 * b * t * hidden,
                             8 * hidden * hidden * steps, torch.float32, library_ms=cudnn[True]["forward"]),
        "lstm_backward_grid": numbers(max(bwd_errs), bms, bplain, nbytes(*gouts, *gates, *cs, *w_hhs, *dxws),
                                      8 * hidden * hidden * steps, torch.float32, library_ms=cudnn[True]["backward"]),
        # as check_train_kernels' lstm_weight_grad: the einsum is the library yardstick too
        "lstm_weight_grad_conformer_l": numbers(max(werrs), wms, wplain_ms, nbytes(h, dxw, w_hhs[1]),
                                                3 * 8 * hidden * hidden * b * t, "tf32", library_ms=wplain_ms),
    }


def check_attention_backward_kernels(card: str) -> dict:
    """The lse forward and the dq, dkv and dband kernels against their
    plain twins, float32 and bf16, at the long-form step's shape (ragged:
    one row full, one short, one shorter than a tile), at the 30 s shape
    and at the benchmark's training cell's shape (64 rows, T'=751, lengths
    from 500 to 751 with one row ending at a tile edge and one just past
    it); the bf16 numbers at the long-form shape go into the result, with
    those at the cell's shape under ``cell_shape``.
    In bf16 every one of them is a tensor-core kernel: their registers,
    spills and blocks an SM are read first (no spill at dh = 64, two
    blocks an SM), the forward's output is held to one bf16 ulp at the
    twin's largest entry as the gradients are, and the twin on a band
    shifted by one row (a skew or unskew off by one) must miss the bars
    that they meet, in the forward's output, dqv and dp."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 4)
    results = {}
    h, dh = 4, 64
    for kernel in A.TC_KERNELS:
        plans = {width: A.relpos_tc_plan(kernel, width) for width in A.HEAD_DIMS}
        print(f"bf16 {kernel} on the tensor cores, by head width: "
              + "; ".join(f"dh {w}: {pl['registers']} registers, {pl['local_bytes']} B local, "
                          f"{pl['smem_bytes']} B shared, {pl['blocks_per_sm']} blocks an SM" for w, pl in plans.items()))
        check(plans[dh]["local_bytes"] == 0, f"the bf16 {kernel} kernel spills at dh = {dh}")
        check(plans[dh]["blocks_per_sm"] >= 2, f"the bf16 {kernel} kernel holds fewer than two blocks an SM")
    cell_lengths = mixed_lengths(gen, CELL_BATCH, CELL_T_SUB, 500)
    cell_lengths[1:3] = torch.tensor([640, 641], dtype=torch.int32)  # the end of a 64-row (and 32-row) tile, one past
    shapes = [(LONG_BATCH, 938, torch.tensor([938, 500, 20, 811], dtype=torch.int32)),
              (BATCH, 235, mixed_lengths(gen, BATCH, 235, 235 // 3)), (CELL_BATCH, CELL_T_SUB, cell_lengths)]
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
            out_bar = min(bf16_bar(out_ref, floor=TOL["attention_f32"]), TOL["attention_bf16"])
            tols = {"out": out_bar if bf16 else TOL["attention_f32"], "lse": TOL["attention_bwd_f32"]}
            tols.update({n: bf16_bar(r) if bf16 else TOL["attention_bwd_f32"] for n, r in zip(grads, ref)})
            name = str(dtype).replace("torch.", "")
            print(f"attention backward ({b}, {t}, {h}, {dh}) {name}, lengths {lengths.tolist()[:4]}…: max|Δ| (tol) "
                  + ", ".join(f"{n} {e:.3e} ({tols[n]:.1e})" for n, e in errs.items()) + "; largest entries "
                  + ", ".join(f"{n} {r.abs().max().item():.3f}" for n, r in zip(grads, ref)))
            for n, e in errs.items():
                check(e <= tols[n], f"attention {'forward with lse' if n in ('out', 'lse') else 'backward'} "
                                    f"({name}): {n} disagrees with the plain twin")
            if bf16:  # the control: a band one row off misses the bar the kernels meet
                p_dev = args[4]
                shifted_p = torch.cat([p_dev[1:], torch.zeros_like(p_dev[:1])])
                shifted = A.flash_relpos_attention_backward_plain(*args[:4], shifted_p, *args[5:], out_ref, lse_ref, gd)
                misses = {n: max_abs(shifted[i], ref[i]) for i, n in ((1, "dqv"), (4, "dp"))}
                misses["out"] = max_abs(A.flash_relpos_attention_plain(*args[:4], shifted_p, *args[5:]), out_ref)
                print("  the twin on a band one row off: max|Δ| (tol) "
                      + ", ".join(f"{n} {e:.3e} ({tols[n]:.1e})" for n, e in misses.items()))
                for n, e in misses.items():
                    check(e > tols[n], f"the bf16 bar does not see a band one row off in {n}")

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
            device = {
                "fwd": device_ms(lambda: A.flash_relpos_attention(*args)),
                "lse": device_ms(lambda: A.flash_relpos_attention_forward_lse(*args)),
                "dq": device_ms(lambda: A.flash_relpos_attention_bwd_dq(*call)),
                "dkv": device_ms(lambda: A.flash_relpos_attention_bwd_dkv(*call)),
                "dband": device_ms(lambda: A.flash_relpos_attention_bwd_dband(*call)),
            }
            print(f"  times, ms: " + ", ".join(f"{n} {x:.4f}" for n, x in times.items())
                  + f"  (plain_bwd computes all five gradients; *_autograd: forward + backward); device ms: "
                  + ", ".join(f"{n} {x:.4f}" for n, x in device.items()) + f"  [{card}]")
            if dtype != torch.bfloat16 or b not in (LONG_BATCH, CELL_BATCH):
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
                entry = numbers(worst[key], times[key], times["plain_fwd" if key == "lse" else "plain_bwd"],
                                moved, units * h * dh * pairs, dtype)
                if b == LONG_BATCH:
                    results[full] = entry
                else:
                    results[full]["cell_shape"] = {"shape": [b, t, h, dh], "device_ms": device[key], **entry}
    return results


# (rows, frames, channels) of the depthwise conv's launches: the 30 s and long-form steps and the Noisy Student
# buckets at Conformer-M's C = 512, the 30 s step at Conformer-L's C = 1024
CONV_SHAPES = ((BATCH, T_SUB, 512), (LONG_BATCH, LONG_T_SUB, 512), *((NST_BATCH, f, 512) for _, f in NST_BUCKETS),
               (BATCH, T_SUB, 1024))


def conv_inputs(gen: torch.Generator, b: int, t: int, c: int, k: int):
    """x, the incoming gradient g (unit variance) and taps w (variance 1/K), float32 on the card."""
    x, g = (torch.randn(b, t, c, generator=gen).cuda() for _ in range(2))
    return x, g, (torch.randn(k, c, generator=gen) * k ** -0.5).cuda()


def conv_library(x: torch.Tensor, w: torch.Tensor, g: torch.Tensor):
    """The one-call PyTorch yardsticks of the conv module's route 'auto' for x (B, T, C), taps w (K, C) and the
    incoming gradient g: ``conv1d(groups=C)`` with its pad and two transposes, and cuDNN's grouped weight gradient
    (``torch.nn.grad.conv1d_weight``) on the same padded, transposed x and g, → (K, C).  The port calls
    neither."""
    import torch.nn.functional as F

    from nn_conformer_for_speech_recognition_tpu_torch.models.layers import same_padding

    (_, t, c), k = x.shape, w.shape[0]
    weight = w.t().unsqueeze(1).contiguous()  # (C, 1, K), the library route's parameter

    def forward():
        return F.conv1d(F.pad(x.transpose(1, 2), same_padding(t, k, 1)), weight, groups=c).transpose(1, 2)

    def weight_grad():
        h = F.pad(x.transpose(1, 2), same_padding(t, k, 1))
        return torch.nn.grad.conv1d_weight(h, weight.shape, g.transpose(1, 2), groups=c)[:, 0].t()

    return forward, weight_grad


def check_depthwise_conv_kernel(card: str) -> dict:
    """The depthwise conv's kernels against their twins at `CONV_SHAPES`,
    where the Noisy Student buckets' rows are shorter than a tile and than
    the 33 taps: the forward, dx (the same kernel on the gradient, taps
    reversed, pads swapped) and dw (the dw kernel and its tile-order
    reduce; two launches bit-equal), float32 and bf16, K = 33 (taps in
    registers) and an even K (the generic build); every build the plans
    launch free of spills.  Each is timed on the card alone (`device_ms`;
    the forward also by events) beside its twin and a library call:
    ``conv1d(groups=C)`` for the forward and dx, cuDNN's grouped weight
    gradient for dw.  The bf16 numbers at (16, 235, 512), K = 33, go into
    the result, and at (16, 235, 1024) under names of their own."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import depthwise_conv as D

    gen = torch.Generator().manual_seed(SEED + 5)
    result, builds = {}, set()
    one = torch.zeros(1, device="cuda")
    print(f"launch floor of device_ms (a one-element zero_): {device_ms(lambda: one.zero_()) * 1e3:.2f} us  [{card}]")
    for b, t, c in CONV_SHAPES:
        for k in (33, 32):
            x32, g32, w32 = conv_inputs(gen, b, t, c, k)
            pad_hi = k - 1 - (k - 1) // 2
            for dtype in (torch.float32, torch.bfloat16):
                x, g, w = x32.to(dtype), g32.to(dtype), w32.to(dtype)
                plan = D.depthwise_plan(b, t, c, k, dtype)
                builds.add((dtype, plan["vectorized"], plan["fixed_taps"]))
                out, ref = D.depthwise_conv1d(x, w), D.depthwise_conv1d_plain(x, w)
                dx = D.depthwise_conv1d_forward(g, w, pad_lo=pad_hi, reverse_taps=True)
                leaf = x.clone().requires_grad_(True)
                (dx_ref,) = torch.autograd.grad(D.depthwise_conv1d_plain(leaf, w), leaf, g)
                dw, dw_again = (D.depthwise_conv1d_weight_grad(x, g, k) for _ in range(2))
                dw_ref = D.depthwise_conv1d_weight_grad_plain(x, g, k)
                torch.cuda.synchronize()
                check(out.shape == x.shape and out.dtype == dtype, "depthwise_conv output shape or type")
                check(dw.shape == (k, c) and dw.dtype == torch.float32, "depthwise_conv dw shape or type")
                floor = TOL["depthwise_conv_f32"]
                tols = (bf16_bar(ref, floor), bf16_bar(dx_ref, floor)) if dtype == torch.bfloat16 else (floor, floor)
                errs = (max_abs(out, ref), max_abs(dx, dx_ref), max_abs(dw, dw_ref))
                dw_rel = errs[2] / dw_ref.abs().max().item()
                name = str(dtype).replace("torch.", "")
                ms, events_ms = device_ms(lambda: D.depthwise_conv1d_forward(x, w)), cuda_ms(lambda: D.depthwise_conv1d_forward(x, w))
                dx_ms = device_ms(lambda: D.depthwise_conv1d_forward(g, w, pad_lo=pad_hi, reverse_taps=True))
                dw_ms = device_ms(lambda: D.depthwise_conv1d_weight_grad(x, g, k))
                plain_ms = cuda_ms(lambda: D.depthwise_conv1d_plain(x, w), iters=5)
                dw_plain_ms = cuda_ms(lambda: D.depthwise_conv1d_weight_grad_plain(x, g, k), iters=5)
                lib_fwd, lib_dw = conv_library(x, w, g)
                lib_err, lib_dw_err = max_abs(lib_fwd(), ref), max_abs(lib_dw(), dw_ref)
                library_ms, library_dw_ms = device_ms(lib_fwd), device_ms(lib_dw)
                print(f"depthwise_conv ({b}, {t}, {c}) K={k} {name}, {'vector' if plan['vectorized'] else 'scalar'} "
                      f"layout, {'fixed' if plan['fixed_taps'] else 'generic'} taps, row groups {plan['row_groups']} in "
                      f"{plan['blocks']} blocks over {plan['tiles']} tiles a slab (dw {plan['dw_row_groups']} in "
                      f"{plan['dw_blocks']}, {plan['dw_partials']} partials a slab): max|Δ| out {errs[0]:.3e} (tol "
                      f"{tols[0]:.1e}), dx {errs[1]:.3e} (tol {tols[1]:.1e}), dw {errs[2]:.3e} = {dw_rel:.3e} of its "
                      f"largest (tol {TOL['depthwise_conv_dw']:.0e}), dw launches bit-equal {torch.equal(dw, dw_again)}; "
                      f"device forward {ms:.4f} ms (events {events_ms:.4f}), dx {dx_ms:.4f}, dw {dw_ms:.4f}; plain "
                      f"{plain_ms:.4f}, dw plain {dw_plain_ms:.4f}; conv1d(groups={c}) with pad and transposes device "
                      f"{library_ms:.4f} (max|Δ| to the twin {lib_err:.3e}), cuDNN's weight gradient device "
                      f"{library_dw_ms:.4f} (max|Δ| {lib_dw_err:.3e})  [{card}]", flush=True)
                check(errs[0] <= tols[0], f"depthwise_conv ({name}, K={k}) disagrees with its plain twin")
                check(errs[1] <= tols[1], f"depthwise_conv dx ({name}, K={k}) disagrees with autograd through the twin")
                check(dw_rel <= TOL["depthwise_conv_dw"], f"depthwise_conv dw ({name}, K={k}) disagrees with its twin")
                check(torch.equal(dw, dw_again), f"depthwise_conv dw ({name}, K={k}): two launches differ")
                if k == 33 and dtype == torch.bfloat16 and (b, t) == (BATCH, T_SUB):
                    # x read once, out written once, the taps; 2·K operations an element, done as float32
                    # multiply-adds outside the tensor cores whatever the storage type.  dw reads x and g and
                    # writes (K, C) float32
                    suffix = "" if c == 512 else "_conformer_l"
                    result[f"depthwise_conv{suffix}"] = dict(
                        numbers(max(errs[:2]), ms, plain_ms, nbytes(x, out, w), 2 * k * x.numel(), torch.float32,
                                library_ms=library_ms), dx_ms=dx_ms, events_ms=events_ms)
                    result[f"depthwise_conv_weight_grad{suffix}"] = numbers(
                        errs[2], dw_ms, dw_plain_ms, nbytes(x, g, dw), 2 * k * x.numel(), torch.float32,
                        library_ms=library_dw_ms)
    built = {}
    for dtype, vectorized, fixed in sorted(builds, key=str):
        for kernel in D.KERNELS:
            built[f"{kernel} {str(dtype)[6:]} {'vector' if vectorized else 'scalar'} K={fixed or 'any'}"] = (
                D.depthwise_kernel_attributes(kernel, dtype, vectorized, fixed))
    print(f"depthwise_conv builds the plans launch: {built}")
    check(all(v["local_bytes"] == 0 for v in built.values()), f"the depthwise conv kernels spill: {built}")
    return result


def conv_times(card: str) -> None:
    """Device time of the depthwise conv of whichever checkout's package is
    imported (`conv_times_main`) in bf16 at K = 33 and `CONV_SHAPES`, on the
    same seeded inputs in every tree: the forward, dx and dw as that tree's
    `DepthwiseConv1d` computes them."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import depthwise_conv as D

    print(f"depthwise conv of {Path(D.__file__).resolve().parents[3]}  [{card}]")
    for b, t, c in CONV_SHAPES:
        gen = torch.Generator().manual_seed(SEED + 14)
        x, g, w = (v.bfloat16() for v in conv_inputs(gen, b, t, c, 33))
        fwd = device_ms(lambda: D.depthwise_conv1d_forward(x, w))
        dx = device_ms(lambda: D.depthwise_conv1d_forward(g, w, pad_lo=16, reverse_taps=True))
        dw = device_ms(lambda: D.depthwise_conv1d_weight_grad(x, g, 33))
        print(f"depthwise_conv ({b}, {t}, {c}) K=33 bfloat16: device forward {fwd:.4f} ms, dx {dx:.4f}, dw {dw:.4f}  "
              f"[{card}]", flush=True)


def conv_times_main(tree: Path) -> None:
    """``python3 chip_smoke.py --conv-times [TREE]``: `conv_times` for the
    port in the checkout at TREE (this one by default), built there."""
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    sys.path.insert(0, str(tree.resolve()))
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    card = card_line()
    print(card)
    build.build()
    conv_times(card)


# Adafactor's multi-tensor kernels against the per-tensor loop on the same CUDA tensors, five steps of Conformer-M's
# 514 parameters: parameters atol 1e-6 (the loop's own bar against optax), slots 1e-5 of their largest magnitude (the
# means and the clip's sum of squares run in another order; the momentum crosses zero); the norm within 1e-6 of a
# float64 sum of squares (its partials are float32 sums of 4,096 squares, added in float64)
OPT_TOL = {"params": 1e-6, "slots": 1e-5, "norm": 1e-6}
OPT_STEPS, OPT_PROFILED = 5, 10
OPT_KERNELS = ("adafactor_moments_kernel", "adafactor_factors_kernel", "adafactor_clip_sums_kernel",
               "adafactor_apply_kernel", "sumsq_partials_kernel", "sumsq_finish_kernel")


def adafactor_bytes(opt) -> tuple:
    """(Adafactor's bytes a step, the norm's): what the passes read and
    write, each tensor counted once a pass.  Norm: every gradient.  Moments:
    an unfactored parameter's g and v (read and write), a factored one's g
    twice (row sums, column sums), v_row and v_col (read and write).
    Factors: v_row twice, v_col, the factors written.  Clip sums: a
    factored g again.  Apply: g, p (read and write), ema (read and write),
    an unfactored v, the factors.  A partial a chunk is written and read."""
    table = opt._table
    n = sum(p.numel() for _, p, *_ in opt.params)
    nf = sum(p.numel() for _, p, _, dims, _ in opt.params if dims is not None)
    nu, factors, ema = n - nf, table.rows + table.cols, opt.momentum is not None
    moments = 3 * nu + 2 * nf + 2 * factors + table.chunks
    factor_pass = 2 * table.rows + table.cols + factors
    clip = nf + factors + table.chunks
    apply = 3 * n + 2 * n * ema + nu + factors + table.chunks
    return 4 * (moments + factor_pass + clip + apply), 4 * (n + 2 * table.chunks)


def check_optimizer_kernels(card: str) -> dict:
    """Adafactor's and the gradient norm's multi-tensor kernels
    (`ops/cuda/adafactor.py`) on Conformer-M's 514 parameters: five
    Adafactor steps (lr 1e-2, momentum 0.9, clip 1.0; gradients that grow
    step by step, so that the clip binds) against the per-tensor loop from
    the same parameters and gradients at `OPT_TOL`, a second kernel run bit
    for bit, 4 launches and 514 parameters counted a step, and the kernels
    without the clip missing the bar; the norm against a float64 sum of
    squares and ``optax_global_norm``, bit-equal twice, 2 launches.  Then the
    kernels' own device time (the profiler's kernel rows, `OPT_PROFILED`
    calls), whole calls on CUDA events (the host's table and pointer reads
    included) and the loops' calls, beside the bound of the bytes the passes
    move (`adafactor_bytes`)."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nn_conformer_for_speech_recognition_tpu_torch.config import OptimizerConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import adafactor as AF
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import optax_global_norm
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer

    model = init_params(ConformerCTC(conformer_m(use_pallas=True), VOCAB), torch.Generator().manual_seed(SEED + 17))
    init = {k: p.detach().cuda() for k, p in model.named_parameters()}
    del model
    gen = torch.Generator(device="cuda").manual_seed(SEED + 17)
    grads = [{k: torch.randn(t.shape, generator=gen, device="cuda") * (1 + 2 * s) for k, t in init.items()}
             for s in range(OPT_STEPS)]

    def run(loop: bool = False, clip: bool = True):
        params = {k: torch.nn.Parameter(t.clone()) for k, t in init.items()}
        opt = make_optimizer(OptimizerConfig(learning_rate=1e-2), params.items())
        if not clip:
            opt.clipping_threshold = None
        with optimizer_loops() if loop else contextlib.nullcontext():
            for g in grads:
                for k, p in params.items():
                    p.grad = g[k]
                opt.step()
        torch.cuda.synchronize()
        return opt

    def gaps(opt, ref) -> tuple:
        p_gap = max(max_abs(p, q) for (_, p, *_), (_, q, *_) in zip(opt.params, ref.params))
        s_gap = max((opt.state[n][k] - v).abs().max().item() / v.abs().max().item()
                    for n, st in ref.state.items() for k, v in st.items())
        return p_gap, s_gap

    def passes(p_gap, s_gap) -> bool:
        return p_gap <= OPT_TOL["params"] and s_gap <= OPT_TOL["slots"]

    ref = run(loop=True)
    before = AF.adafactor_step.launches, AF.adafactor_step.params
    opt = run()
    counted = (AF.adafactor_step.launches - before[0], AF.adafactor_step.params - before[1])
    again = run()
    p_gap, s_gap = gaps(opt, ref)
    control = gaps(run(clip=False), ref)
    moved = min((p - init[n]).abs().max().item() for n, p, *_ in opt.params)
    equal = all(torch.equal(p, q) for (_, p, *_), (_, q, *_) in zip(opt.params, again.params)) and all(
        torch.equal(again.state[n][k], v) for n, st in opt.state.items() for k, v in st.items())
    n_params, n_elements = len(opt.params), sum(p.numel() for _, p, *_ in opt.params)

    gs = list(grads[-1].values())
    exact = torch.sqrt(sum(g.double().square().sum() for g in gs)).item()
    before_norm = AF.global_norm.launches
    norm, norm_again = AF.global_norm(gs), AF.global_norm(gs)
    norm_launches = (AF.global_norm.launches - before_norm) / 2
    norm_err = abs(norm.item() - exact) / exact
    loop_norm_err = abs(optax_global_norm(gs).item() - exact) / exact

    # times: the kernels' rows under the profiler; whole calls on events; the loops' calls
    profiler_warmup()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiler_warmup()
        for _ in range(OPT_PROFILED):
            opt.step()
            AF.global_norm(gs)
        torch.cuda.synchronize()
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA]
    kernel_ms = {name: sum(e.self_device_time_total for e in rows if name in e.key) / 1e3 / OPT_PROFILED
                 for name in OPT_KERNELS}
    ada_ms = sum(v for k, v in kernel_ms.items() if k.startswith("adafactor_"))
    norm_ms = sum(v for k, v in kernel_ms.items() if k.startswith("sumsq_"))
    ada_events = cuda_ms(opt.step)
    norm_events = cuda_ms(lambda: AF.global_norm(gs))
    with optimizer_loops():
        ada_loop = cuda_ms(ref.step, iters=3, warmup=1)
    norm_loop = cuda_ms(lambda: optax_global_norm(gs), iters=5)
    ada_bytes, norm_bytes = adafactor_bytes(opt)
    ada = numbers(p_gap, ada_ms, ada_loop, ada_bytes, 18 * n_elements, torch.float32)
    norm_numbers = numbers(norm_err, norm_ms, norm_loop, norm_bytes, 2 * n_elements, torch.float32)
    print(f"adafactor_step, Conformer-M ({n_params} parameters, {n_elements} elements), {OPT_STEPS} steps against the "
          f"per-tensor loop: parameters max|Δ| {p_gap:.3e} (tol {OPT_TOL['params']}), slots max|Δ|/max {s_gap:.3e} "
          f"(tol {OPT_TOL['slots']}); without the clip {control[0]:.3e} / {control[1]:.3e}; two runs bit-equal "
          f"{equal}; {counted[0] / OPT_STEPS:g} launches and {counted[1] / OPT_STEPS:g} parameters a step; kernels "
          f"{ada_ms:.4f} ms device ({', '.join(f'{k} {v:.4f}' for k, v in kernel_ms.items() if 'adafactor' in k)}), "
          f"a call "
          f"{ada_events:.4f} ms on events, the loop {ada_loop:.2f} ms; bound {ada['bound_ms']:.4f} ms "
          f"({ada_bytes / 1e9:.3f} GB), {ada['bound_ms'] / ada_ms:.1%} of it  [{card}]")
    print(f"global_norm, the same {n_params} gradients: rel err {norm_err:.3e} against float64 (tol {OPT_TOL['norm']}; "
          f"optax_global_norm {loop_norm_err:.3e}), two calls bit-equal {torch.equal(norm, norm_again)}, "
          f"{norm_launches:g} launches; kernels {norm_ms:.4f} ms device (partials "
          f"{kernel_ms['sumsq_partials_kernel']:.4f}, finish {kernel_ms['sumsq_finish_kernel']:.4f}), a call {norm_events:.4f} ms on events, the "
          f"loop {norm_loop:.2f} ms; bound {norm_numbers['bound_ms']:.4f} ms ({norm_bytes / 1e9:.3f} GB), "
          f"{norm_numbers['bound_ms'] / norm_ms:.1%} of it  [{card}]")
    check(passes(p_gap, s_gap), "the Adafactor kernels disagree with the per-tensor loop")
    check(not passes(*control), "the Adafactor kernels without the clip still meet the bar: it does not separate")
    check(equal, "two runs of the Adafactor kernels are not bit-equal")
    check(moved > 1e-3, "a parameter did not move")
    check(counted == (UPDATE_LAUNCHES["adafactor_step"] * OPT_STEPS, n_params * OPT_STEPS) and n_params == 514,
          f"Adafactor kernel launches and parameters counted {counted}")
    check(norm_err <= OPT_TOL["norm"] and torch.equal(norm, norm_again), "the norm kernels disagree or differ")
    check(norm_launches == UPDATE_LAUNCHES["global_norm"], f"norm launches {norm_launches}")
    check(all(v > 0 for v in kernel_ms.values()), f"a kernel without rows under the profiler: {kernel_ms}")
    return {"adafactor_step": {**ada, "events_ms": ada_events, "slots_err": s_gap},
            "global_norm": {**norm_numbers, "events_ms": norm_events}}


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


def lstm_route_counters(preset: str, batch: int) -> tuple:
    """The counters of the forward and backward recurrence that ``preset``'s
    BiLSTM takes at ``batch`` rows on this card: the cluster kernels' or the
    grid kernels'."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L

    kind, _ = L.route(batch, getattr(C, preset)().decoder.lstm_hidden, torch.device("cuda"))
    return ("lstm", "lstm_backward") if kind == "cluster" else ("lstm_grid", "lstm_backward_grid")


def check_slice(card: str, conv_impl: str = "auto", preset: str = "conformer_m") -> dict:
    """The pseudo-label pass of ``preset`` (a `config` preset at full width
    and depth).  ``conv_impl='pallas'``: the configuration whose depthwise
    conv is the hand-written kernel; its plain path is the
    ``use_pallas=False`` model (grouped conv1d) with the same taps."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import greedy_decode
    from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_predict_step

    vocab = build_vocab("word", [" ".join(f"w{i}" for i in range(VOCAB - 3))])
    check(len(vocab) == VOCAB, "vocabulary size")
    make_config = getattr(C, preset)
    gen = torch.Generator().manual_seed(SEED)
    base = init_params(ConformerCTC(make_config(use_pallas=True, conv_impl=conv_impl), VOCAB), gen)
    for name, buf in base.named_buffers():  # non-trivial running statistics
        buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 + (0.75 if name.endswith("var") else -0.25))
    state = base.state_dict()
    tag = f"{preset}, conv_impl={conv_impl!r}"

    def model(**cfg):
        m = ConformerCTC(make_config(**cfg), VOCAB)
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
    blocks = make_config().encoder.num_blocks
    expected = {"stft_logmel": N_BATCHES, "attention_relpos": blocks * N_BATCHES,
                lstm_route_counters(preset, BATCH)[0]: N_BATCHES,
                "depthwise_conv": blocks * N_BATCHES if conv_impl == "pallas" else 0}  # no dw: no backward
    check(launches == {**dict.fromkeys(launches, 0), **expected}, f"pseudo-label launch counts, want {expected}")
    per_batch = dt / N_BATCHES
    print(f"bf16 pseudo-label pass ({tag}): {per_batch * 1e3:.2f} ms/batch (B={BATCH}, {SECONDS:.0f} s clips), "
          f"{BATCH * SECONDS / per_batch:.1f} audio-s/s, peak memory {peak / 2**20:.1f} MiB  [{card}]")
    return launches


def relative_error(got: torch.Tensor, ref: torch.Tensor) -> float:
    return max_abs(got, ref) / max(ref.abs().max().item(), 1e-30)


def check_train(card: str, batch: int, seconds: float, target_len: int, long_form: bool,
                conv_impl: str = "auto", preset: str = "conformer_m") -> dict:
    """The supervised train step of ``preset`` (a `config` preset at full
    width and depth): float32 kernel path vs plain path, then the bf16 step
    as a user runs it.  ``long_form``: the subsampled length is at least
    768 (the presets drop no attention probability, so 'auto' trains the
    attention through the flash kernels at every length); the einsum
    route's peak memory and one step under remat are measured too.
    ``conv_impl='pallas'``: the depthwise conv is the hand-written kernel
    (its plain path the grouped conv1d with the same taps), and one step
    under remat is counted at this shape too."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.config import (
        ATTENTION_KERNEL_MIN_T_TRAINING, FeatureConfig, OptimizerConfig, SpecAugmentConfig,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_augment_step, make_feature_train_step
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState
    from nn_conformer_for_speech_recognition_tpu_torch.utils.flops import peak_bf16_flops, train_step_flops

    make_config = getattr(C, preset)
    n_samples = round(seconds * 16000)
    frames = FeatureConfig().num_frames(n_samples)
    t_sub = make_config().subsampled_length(frames)
    check((t_sub >= ATTENTION_KERNEL_MIN_T_TRAINING) == long_form, f"T'={t_sub} is on the wrong side of the switch")
    check((batch, t_sub) in KERNEL_SHAPES_CHECKED, f"B={batch}, T'={t_sub}: the kernel phase ran at no such shape")
    what = f"{preset}, B={batch}, {seconds:g} s clips, T'={t_sub}, {target_len} targets, conv_impl={conv_impl!r}"
    blocks = make_config().encoder.num_blocks

    gen = torch.Generator().manual_seed(SEED + 3)
    base = init_params(ConformerCTC(make_config(use_pallas=True, conv_impl=conv_impl), VOCAB), gen)
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
        cfg = make_config(use_pallas=use_pallas, conv_impl=conv_impl if use_pallas else "auto", compute_dtype="float32")
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

    kernel_run = one_step(True, "auto")
    with optimizer_loops():
        plain_run = one_step(False, "xla")
    check(not any(plain_run[3].values()), f"the plain path launched a kernel: {plain_run[3]}")
    check(all(kernel_run[3][k] == v for k, v in update_launches(1).items()),
          f"f32 kernel path launches: {kernel_run[3]}")
    check(all(kernel_run[3][k] == v for k, v in train_attention_launches(f32(True), t_sub, blocks).items()),
          f"f32 kernel path launches: {kernel_run[3]}")
    conv_blocks = blocks if conv_impl == "pallas" else 0  # forward and dx in every block, and dw
    check((kernel_run[3]["depthwise_conv"], kernel_run[3]["depthwise_conv_weight_grad"]) == (2 * conv_blocks, conv_blocks),
          f"f32 kernel path launches: {kernel_run[3]}")
    compare(kernel_run, plain_run)
    del kernel_run, plain_run

    # -- bf16, as a user runs it: augment, then the train step; full-length
    #    clips, the same count of targets in every row
    cfg16 = make_config(use_pallas=True, conv_impl=conv_impl)  # compute 'auto': bfloat16 on CUDA
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
    n = N_TRAIN_STEPS
    conv = 2 * blocks * N_TRAIN_STEPS if conv_impl == "pallas" else 0  # forward and dx in every block
    # one launch of each recurrence serves both directions (the cluster's, or past its H the grid's); dW_hh is one
    # launch a direction
    lstm_fwd, lstm_bwd = lstm_route_counters(preset, batch)
    expected = {**dict.fromkeys(launches, 0), "stft_logmel": n, lstm_fwd: n, lstm_bwd: n,
                "lstm_weight_grad": 2 * n, "ctc_alpha": n, "ctc_beta": n,
                **train_attention_launches(cfg16, t_sub, blocks * n),
                "depthwise_conv": conv, "depthwise_conv_weight_grad": conv // 2, **update_launches(n)}
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
    again = {"attention_relpos_lse": 2.0, "depthwise_conv": 1.5}  # forwards repeated; the conv's dx and dw are not
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
        # every forward runs the conv kernel once per block, every train step once more for dx and the dw kernel once
        # per block; one launch of each
        # LSTM recurrence serves both directions, dW_hh is one launch a direction
        expected = {"stft_logmel": steps + evals + label_batches, "attention_relpos": blocks * (evals + label_batches),
                    "lstm": steps + evals + label_batches, "lstm_backward": steps, "lstm_weight_grad": 2 * steps,
                    "ctc_alpha": steps + evals, "ctc_beta": steps,
                    "depthwise_conv": blocks * (forwards[True] + forwards[False]) + blocks * steps,
                    "depthwise_conv_weight_grad": blocks * steps, **update_launches(steps),
                    **train_attention_launches(model_cfg, 1, blocks * steps)}  # every bucket below 768 frames
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
                          "lstm": n_eval, "ctc_alpha": data["validation"].num_batches(),
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
    expected = {"stft_logmel": N_BATCHES, "attention_relpos": blocks * N_BATCHES, "lstm": N_BATCHES, "ctc_alpha": N_BATCHES}
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


def run_cli(argv):
    """Runs the command line in process: (printed lines, seconds); what the
    command prints is passed on, and a non-zero exit fails."""
    from nn_conformer_for_speech_recognition_tpu_torch.cli import main as cli

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

    run = run_cli
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


# Pretraining and the language model
PRETRAIN_MASK_P = 0.3  # the loss-falling steps' mask probability, as the JAX package's pretraining test
LM_BATCH, LM_STEPS, LM_WEIGHT = 32, 5, 0.3  # LMTrainer's batch and steps; Trainer's default fusion weight
# float32 fused evaluation, kernel path vs plain path: the loss relative, as the unfused pass's log-probs agree
# (SLICE_LOGPROB_TOL); a beam row's 1-best may flip where two hypotheses' scores lie closer than the two paths
FUSED_LOSS_RTOL, FUSED_BEAM_ROWS_MAY_DIFFER = 1e-3, 1


def check_pretrain_lstm(card: str, b: int, t: int) -> dict:
    """The LSTM kernels at the pretraining decoder's width (H = target_dim / 2 = 160 for `PretrainConfig`'s
    defaults, the cluster route): the training forward, the backward and dW_hh of both directions against
    their twins at ``b`` rows of ``t`` subsampled frames, bit-equal to each direction alone, timed beside
    cuDNN's bidirectional LSTM at the decoder's input width (Conformer-M's d_model 256)."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import PretrainConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L

    dev = torch.device("cuda")
    gen = torch.Generator().manual_seed(SEED + 15)
    hidden = PretrainConfig().target_dim // 2
    kind, _ = L.route(b, hidden, dev)
    check(kind == "cluster", f"H = {hidden} at B = {b} takes the {kind} route, not the cluster's")
    xws = [torch.randn(b, t, 4 * hidden, generator=gen).to(dev) for _ in DIRECTIONS]
    w_hhs = [(torch.randn(hidden, 4 * hidden, generator=gen) * hidden ** -0.5).to(dev) for _ in DIRECTIONS]
    lengths = mixed_lengths(gen, b, t, max(t // 3, 1)).to(dev)
    gouts = [torch.randn(b, t, hidden, generator=gen).to(dev) for _ in DIRECTIONS]
    outs = L.lstm_forward_directions(xws, w_hhs, lengths, DIRECTIONS, save=True)
    hs, cs, gates = (list(x) for x in zip(*outs))
    dxws = L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, DIRECTIONS)
    ferrs, berrs, werrs = [], [], []
    for i, reverse in enumerate(DIRECTIONS):
        h_ref, c_ref, g_ref = L.lstm_forward_plain(xws[i], w_hhs[i], lengths, reverse)
        ferrs.append(max(max_abs(hs[i], h_ref), max_abs(cs[i], c_ref), max_abs(gates[i], g_ref)))
        check(torch.equal(hs[i], L.lstm_forward(xws[i], w_hhs[i], lengths, reverse=reverse, save=True)[0]),
              "lstm (H = 160): the two-direction launch and one direction alone differ")
        dxw_ref = L.lstm_backward_plain(gouts[i], g_ref, c_ref, w_hhs[i], lengths, reverse)
        berrs.append(max_abs(dxws[i], dxw_ref))
        check(torch.equal(dxws[i], L.lstm_backward(gouts[i], gates[i], cs[i], w_hhs[i], lengths, reverse=reverse)),
              "lstm_backward (H = 160): the two-direction launch and one direction alone differ")
        dw = L.lstm_weight_grad(hs[i], dxws[i], reverse=reverse)
        dw_ref = L.lstm_weight_grad_plain(h_ref, dxw_ref, reverse)
        werrs.append(max_abs(dw, dw_ref) / dw_ref.abs().max().item())
    torch.cuda.synchronize()
    fwd = lambda: L.lstm_forward_directions(xws, w_hhs, lengths, DIRECTIONS, save=True)  # noqa: E731
    bwd = lambda: L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, DIRECTIONS)  # noqa: E731
    dwhh = lambda: L.lstm_weight_grad(hs[1], dxws[1], reverse=True)  # noqa: E731
    fwd_ms, bwd_ms, w_ms = cuda_ms(fwd), cuda_ms(bwd), cuda_ms(dwhh)
    fwd_dev, bwd_dev, w_dev = device_ms(fwd), device_ms(bwd), device_ms(dwhh)
    fwd_plain = cuda_ms(lambda: [L.lstm_forward_plain(xw, w, lengths, r) for xw, w, r in zip(xws, w_hhs, DIRECTIONS)],
                        iters=5)
    bwd_plain = cuda_ms(lambda: [L.lstm_backward_plain(*a, lengths, r)
                                 for *a, r in zip(gouts, gates, cs, w_hhs, DIRECTIONS)], iters=5)
    w_plain = cuda_ms(lambda: L.lstm_weight_grad_plain(hs[1], dxws[1], True))
    cudnn = cudnn_lstm_ms(b, t, hidden, lengths, gen, bidirectional=True, width=conformer_m().encoder.d_model)
    steps_live = int(lengths.max())
    print(f"lstm at the pretraining decoder's H = {hidden} ({b}, {t}), cluster route, both directions in one launch: "
          f"training forward (h, c, gates) max|Δ| {max(ferrs):.3e} (tol {TOL['lstm']}), backward dxw {max(berrs):.3e} (tol "
          f"{TOL['lstm_backward']}), dW_hh max|Δ|/max|dW| {max(werrs):.3e} (tol {TOL['lstm_weight_grad']}), each launch "
          f"bit-equal to one direction alone; ms (events / device): forward {fwd_ms:.4f} / {fwd_dev:.4f} (plain "
          f"{fwd_plain:.4f}), backward {bwd_ms:.4f} / {bwd_dev:.4f} (plain {bwd_plain:.4f}), dW_hh of one direction "
          f"{w_ms:.4f} / {w_dev:.4f} (the float32 einsum {w_plain:.4f}); serial floor of {steps_live} steps "
          f"{serial_floor_ms(b, hidden, steps_live):.4f} ms; cuDNN's bidirectional LSTM at input width "
          f"{conformer_m().encoder.d_model}: forward {cudnn['forward']:.4f}, backward {cudnn['backward']:.4f} ms  [{card}]")
    check(max(ferrs) <= TOL["lstm"], "lstm (H = 160) disagrees with its plain twin")
    check(max(berrs) <= TOL["lstm_backward"], "lstm_backward (H = 160) disagrees with its plain twin")
    check(max(werrs) <= TOL["lstm_weight_grad"], "lstm_weight_grad (H = 160) disagrees with its plain twin")
    steps = 2 * int(lengths.sum())
    return {
        "lstm_pretrain": numbers(max(ferrs), fwd_ms, fwd_plain, nbytes(*xws, *w_hhs, *hs, *cs, *gates),
                                 8 * hidden * hidden * steps, torch.float32, library_ms=cudnn["forward"]),
        "lstm_backward_pretrain": numbers(max(berrs), bwd_ms, bwd_plain, nbytes(*gouts, *gates, *cs, *w_hhs, *dxws),
                                          8 * hidden * hidden * steps, torch.float32, library_ms=cudnn["backward"]),
        # as at H = 320: the 3×TF32 split at the TF32 rate; the einsum (a cuBLAS GEMM) is the library yardstick
        "lstm_weight_grad_pretrain": numbers(max(werrs), w_ms, w_plain, nbytes(hs[1], dxws[1], w_hhs[1]),
                                             3 * 8 * hidden * hidden * b * t, "tf32", library_ms=w_plain),
    }


def check_pretrain(card: str) -> dict:
    """Contrastive pretraining at full width and depth: `PretrainModel` over Conformer-M with `PretrainConfig`'s
    defaults (target_dim 320, so the BiLSTM decoder's H = 160), float32 as the JAX module, B=16 × 30 s.  One step on
    the kernel path against the plain path (the LSTM twins) from one state, the same features and draws, dropout 0:
    loss, every gradient and the batch statistics; then `PretrainTrainer`'s step as a user runs it (log-mel kernel,
    draws from the state's generator, Adam), timed and counted, and ten steps at lr 1e-3 (mask probability 0.3) on a
    repeated batch and draws, whose loss must fall; then `save` and `Trainer.load_encoder_only` from the checkpoint,
    which must leave the ASR model as it was.  Returns the launch counts of the timed steps."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import (
        FeatureConfig, PretrainConfig, TrainConfig, conformer_m,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.models.pretrain import (
        PretrainModel, contrastive_loss, draw_pretrain,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer
    from nn_conformer_for_speech_recognition_tpu_torch.train.pretrain_loop import PretrainTrainer

    dev = torch.device("cuda")
    pcfg = PretrainConfig(learning_rate=LOSS_LR, mask_probability=PRETRAIN_MASK_P)
    mcfg = conformer_m()
    hidden = pcfg.target_dim // 2
    n_samples = int(SECONDS * 16000)
    t_sub = mcfg.subsampled_length(FeatureConfig().num_frames(n_samples))
    check((BATCH, t_sub) in KERNEL_SHAPES_CHECKED, f"B={BATCH}, T'={t_sub}: the kernel phase ran at no such shape")
    gen = torch.Generator().manual_seed(SEED + 16)
    base = init_params(PretrainModel(mcfg, pcfg), gen)
    for name, buf in base.named_buffers():  # non-trivial running statistics
        buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 + (0.75 if name.endswith("var") else -0.25))
    weights = base.state_dict()
    batches = make_batches(n_samples, count=2)
    audio, alen = batches[1]
    draws = draw_pretrain(torch.Generator(device=dev).manual_seed(SEED), BATCH, t_sub, pcfg, dev)

    # -- float32, kernel path vs plain path: one forward and backward from the same weights, features and draws
    no_dropout = dataclasses.replace(mcfg, encoder=dataclasses.replace(mcfg.encoder, dropout=0.0))
    with torch.no_grad():
        feats, flens = make_featurizer(FeatureConfig())(audio, alen)

    def one_step(kernel: bool):
        m = PretrainModel(no_dropout, pcfg)
        m.load_state_dict(weights)
        m.decoder.use_kernel = kernel
        m.cuda().train()
        reset_counters()
        ctx, tgt, mask_pos, lengths = m(feats, flens, draws)
        loss = contrastive_loss(ctx, tgt, mask_pos, lengths, draws.distractors, pcfg.temperature, pcfg.diversity_alpha)
        loss.backward()
        torch.cuda.synchronize()
        return m, loss.item(), read_counters(), int(mask_pos.sum())

    mk, loss_k, launches_k, masked = one_step(True)
    mp, loss_p, launches_p, _ = one_step(False)
    grads_p = dict(mp.named_parameters())
    grad_errs = {n: relative_error(p.grad, grads_p[n].grad) for n, p in mk.named_parameters()}
    worst = max(grad_errs, key=grad_errs.get)
    stats_p = dict(mp.named_buffers())
    stats_err = max(max_abs(b, stats_p[n]) for n, b in mk.named_buffers())
    loss_err = abs(loss_k - loss_p) / abs(loss_p)
    print(f"pretrain step f32 (Conformer-M, target_dim {pcfg.target_dim}, H = {hidden}, B={BATCH}, T'={t_sub}, "
          f"{masked} masked frames), kernel vs plain path: loss {loss_k:.6f} vs {loss_p:.6f} (rel {loss_err:.3e}, tol "
          f"{TRAIN_TOL['loss']}), worst gradient {worst} rel {grad_errs[worst]:.3e} (tol {TRAIN_TOL['grad']}), batch "
          f"statistics max|Δ| {stats_err:.3e} (tol {TRAIN_TOL['batch_stats']}); launches {launches_k}")
    check(np.isfinite(loss_k) and loss_err <= TRAIN_TOL["loss"], "the pretrain loss of the kernel path disagrees")
    check(grad_errs[worst] <= TRAIN_TOL["grad"], f"the pretrain gradient of {worst} disagrees")
    check(all(bool(torch.isfinite(p.grad).all()) and p.grad.abs().max().item() > 0 for p in mk.parameters()),
          "a pretrain gradient is not finite or is zero")
    check(stats_err <= TRAIN_TOL["batch_stats"], "the pretrain batch statistics disagree")
    want = {"lstm": 1, "lstm_backward": 1, "lstm_weight_grad": 2}
    check(launches_k == {**dict.fromkeys(launches_k, 0), **want} and not any(launches_p.values()),
          f"pretrain step launches: kernel path {launches_k}, want {want}; plain path {launches_p}")
    del mk, mp, grads_p, stats_p

    # -- the step as a user runs it: PretrainTrainer (log-mel kernel, the state's draws, dropout 0.1, Adam)
    tr = PretrainTrainer(mcfg, pcfg, FeatureConfig(), log_fn=lambda _: None)
    tr.init_state(seed=SEED)
    tr.model.load_state_dict(weights)
    check(next(tr.model.parameters()).device.type == "cuda", "PretrainTrainer did not take the card")
    for _ in range(2):  # warm-up
        tr.state, _ = tr._train_step(tr.state, audio, alen)
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()
    reset_counters()
    t0 = time.perf_counter()
    losses = [tr._train_step(tr.state, audio, alen)[1]["loss"] for _ in range(N_TRAIN_STEPS)]
    torch.cuda.synchronize()
    per_step = (time.perf_counter() - t0) / N_TRAIN_STEPS
    launches = read_counters()
    peak = torch.cuda.max_memory_allocated()
    check(all(bool(torch.isfinite(x)) for x in losses), "a pretrain loss is not finite")
    want = {"stft_logmel": N_TRAIN_STEPS, "lstm": N_TRAIN_STEPS, "lstm_backward": N_TRAIN_STEPS,
            "lstm_weight_grad": 2 * N_TRAIN_STEPS}
    check(launches == {**dict.fromkeys(launches, 0), **want}, f"pretrain launches {launches}, want {want}")
    print(f"f32 pretrain step (PretrainTrainer, Conformer-M, B={BATCH}, {SECONDS:.0f} s clips): {per_step * 1e3:.2f} ms/step, "
          f"{BATCH * SECONDS / per_step:.1f} audio-s/s, peak memory {peak / 2**20:.1f} MiB; launches over "
          f"{N_TRAIN_STEPS} steps {launches}  [{card}]")

    # -- the loss falls over ten steps at lr 1e-3 on a repeated batch and draws
    fall = PretrainTrainer(mcfg, pcfg, FeatureConfig(), log_fn=lambda _: None)
    fall.init_state(seed=SEED)
    fall.model.load_state_dict(weights)
    curve = [fall._train_step(fall.state, audio, alen, draws)[1]["loss"].item() for _ in range(LOSS_STEPS)]
    print(f"pretrain loss over {LOSS_STEPS} steps at lr {LOSS_LR} (mask probability {PRETRAIN_MASK_P}), repeated batch "
          f"and draws: {[round(x, 4) for x in curve]}")
    check(bool(np.isfinite(curve).all()) and curve[-1] < curve[0], "the pretrain loss did not fall")

    # -- the hand-off: save, then Trainer.load_encoder_only takes nothing (no encoder. or subsampling. parameter)
    vocab = build_vocab("word", [" ".join(f"w{i}" for i in range(VOCAB - 3))])
    with tempfile.TemporaryDirectory() as root:
        fall.save(os.path.join(root, "pretrained"))
        asr = Trainer(ConformerCTC(conformer_m(use_pallas=True), VOCAB), vocab, FeatureConfig(), TrainConfig(),
                      log_fn=lambda _: None)
        asr.init_state(seed=SEED)
        before = {k: v.clone() for k, v in asr.model.state_dict().items()}
        asr.load_encoder_only(os.path.join(root, "pretrained"))
    unchanged = all(torch.equal(v, before[k]) for k, v in asr.model.state_dict().items())
    same_shapes = sum(k.startswith("context_net.") and ("encoder." + k[len("context_net."):]) in before
                      for k in weights)
    print(f"pretrain → Trainer.load_encoder_only: the ASR model unchanged: {unchanged} ({same_shapes} context-network "
          "tensors have an encoder tensor of the same name after the prefix; the restore takes encoder. and "
          "subsampling. names only, as the JAX package's)")
    check(unchanged and same_shapes > 0, "load_encoder_only from a pretraining checkpoint changed the ASR model")
    return launches


class ArrayDataset:
    """An in-memory split for `Trainer.evaluate`: padded batches on the host
    and one transcript an utterance."""

    def __init__(self, batches, targets: np.ndarray, target_lengths: np.ndarray, vocab):
        from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import Batch, Utterance

        self.batches, rows = [], 0
        for audio, alen in batches:
            b = audio.shape[0]
            self.batches.append(Batch(audio.cpu().numpy(), alen.cpu().numpy().astype(np.int32), targets, target_lengths,
                                      np.arange(rows, rows + b)))
            rows += b
        self.utterances = [Utterance("", vocab.decode_ids(targets[r % len(targets)].tolist())) for r in range(rows)]

    def epoch(self, seed: int = 0, shuffle: bool = True):
        return iter(self.batches)


def check_lm(card: str) -> dict:
    """The language model and its fusions.  `LMTrainer` at `LMConfig`'s defaults (d 320, 8 heads, 4 + 4 layers,
    FFN 512, float32) on a synthetic lexicon and corpus over the ASR vocabulary: five steps on one batch, the loss
    finite and falling, then an epoch as a user runs it.  Then `make_pron_lm_apply` over that LM into
    ``Trainer(lm_apply=...)`` over Conformer-M ``use_pallas=True`` (vocabulary 1024, B=16 × 30 s), greedy and beam:
    the fused loss finite and apart from the unfused one; in float32 the fused steps of the kernel path against the
    plain path's (loss, greedy ids, beam 1-best); bf16 ms/batch fused against unfused through `Trainer.evaluate`.
    Then `fuse_lm_weights_into_asr` on the card: an all-zero LM at Conformer-M's width a no-op bit for bit, a
    seeded one changing the MHSA weights of blocks 0-3 and 15-12 only.  Returns the launch counts of the fused
    bf16 evaluation, greedy and beam."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, LMConfig, TrainConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.data.lm_corpus import Lexicon, LMCorpus
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.models.lm import (
        TransformerLM, fuse_lm_weights_into_asr, make_pron_lm_apply,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.lm_loop import LMTrainer
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer, make_eval_beam_step, make_eval_step

    dev = torch.device("cuda")
    rng = np.random.default_rng(SEED + 17)
    # words of letters only: the LM corpus normalises text to letters and apostrophes
    vocab = build_vocab("word", [" ".join("w" + "".join(chr(97 + i // 26 ** k % 26) for k in range(3))
                                          for i in range(VOCAB - 3))])
    check(len(vocab) == VOCAB, "vocabulary size")
    words = vocab.tokens[3:]
    phones = [f"P{i}" for i in range(40)]
    lexicon = Lexicon({w: list(rng.choice(phones, size=rng.integers(2, 6))) for w in words})
    sentences = [" ".join(rng.choice(words, size=rng.integers(5, 21))) for _ in range(LM_BATCH * LM_STEPS)]
    corpus = LMCorpus(sentences, lexicon, vocab)
    lm_cfg = LMConfig()

    # -- LMTrainer: five steps on one batch, then an epoch
    tr = LMTrainer(lm_cfg, len(corpus.phoneme_vocab), len(vocab), vocab.pad_id, log_fn=lambda _: None)
    tr.init_state(seed=SEED)
    check(next(tr.model.parameters()).device.type == "cuda", "LMTrainer did not take the card")
    batch = tr._put(*next(corpus.batches(LM_BATCH, seed=0)))
    reset_counters()
    curve = []
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    for _ in range(LM_STEPS):
        tr.state, loss = tr._train_step(tr.state, *batch)
        curve.append(loss.item())
    step_ms = (time.perf_counter() - t0) / LM_STEPS * 1e3
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    history = tr.train(corpus, epochs=1, batch_size=LM_BATCH)
    epoch_s = time.perf_counter() - t0
    score = tr.evaluate(corpus, batch_size=LM_BATCH)
    lm_launches = read_counters()
    print(f"LMTrainer (TransformerLM d {lm_cfg.embed_dim}, {lm_cfg.num_heads} heads, {lm_cfg.num_encoder_layers} + "
          f"{lm_cfg.num_decoder_layers} layers, FFN {lm_cfg.ffn_dim}, source vocabulary {len(corpus.phoneme_vocab)}, "
          f"target {len(vocab)}, B={LM_BATCH}, S={corpus.max_src_len}, T={corpus.max_tgt_len}, f32): loss over "
          f"{LM_STEPS} steps on one batch {[round(x, 4) for x in curve]} ({step_ms:.2f} ms/step incl. the first); an "
          f"epoch of {len(corpus) // LM_BATCH} steps {epoch_s:.2f} s, loss {history['lm_loss'][-1]:.4f}, perplexity "
          f"{history['lm_ppl'][-1]:.1f}; evaluate {score:.4f}; kernel launches {sum(lm_launches.values())}  [{card}]")
    check(bool(np.isfinite(curve).all()) and curve[-1] < curve[0], "the LM loss did not fall")
    check(np.isfinite(history["lm_ppl"][-1]) and np.isfinite(score), "the LM epoch or its evaluation is not finite")
    check(not any(lm_launches.values()), "the LM, which has no kernel, launched one")

    # -- the pronunciation LM as the shallow-fusion hook of the ASR model's evaluation
    pron_len = max(len(p) for p in lexicon.entries.values())
    table = np.zeros((len(vocab), pron_len), np.int32)
    for i, w in enumerate(vocab.tokens):
        ids = [corpus.phoneme_vocab.index[p] for p in lexicon.entries.get(w, [])]
        table[i, : len(ids)] = ids
    lm_apply = make_pron_lm_apply(tr.model, table)
    gen = torch.Generator().manual_seed(SEED + 18)
    asr = init_params(ConformerCTC(conformer_m(use_pallas=True), VOCAB), gen)
    for name, buf in asr.named_buffers():  # non-trivial running statistics
        buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 + (0.75 if name.endswith("var") else -0.25))
    batches = make_batches(int(SECONDS * 16000))
    asr.to(dev).eval()
    with torch.inference_mode():
        spread = asr(*make_featurizer(FeatureConfig())(*batches[0]))[0].float().std(dim=-1).mean().item()
    with torch.no_grad():  # a head that speaks as a trained CTC model does (see BEAM_LOGIT_STD)
        asr.final_fc.weight.mul_(BEAM_LOGIT_STD / spread)
        asr.final_fc.bias.zero_()
        asr.final_fc.bias[0] = BEAM_BLANK_BIAS
    weights = asr.state_dict()
    targets = rng.integers(3, VOCAB, (BATCH, TARGET_LEN // 10)).astype(np.int32)
    tlen = np.full((BATCH,), TARGET_LEN // 10, np.int32)
    beam_kw = dict(beam=BEAM, prune=PRUNE, max_label_len=MAX_LABEL_LEN)

    def model(**cfg):
        m = ConformerCTC(conformer_m(**cfg), VOCAB)
        m.load_state_dict(weights)
        return m.to(dev).eval()

    # float32: the fused steps of the kernel path against the plain path's, on the same batches
    kernel32, plain32 = model(use_pallas=True, compute_dtype="float32"), model(compute_dtype="float32")
    t_dev, tl_dev = torch.from_numpy(targets).to(dev), torch.from_numpy(tlen).to(dev)
    steps = {}
    for name, m, feat, ctc in (("kernel", kernel32, FeatureConfig(), "auto"), ("plain", plain32, FeatureConfig(impl="xla"), "xla")):
        steps[name] = (make_eval_step(m, feat, 0, vocab.pad_id, lm_apply=lm_apply, lm_weight=LM_WEIGHT, ctc_impl=ctc),
                       make_eval_beam_step(m, feat, 0, **beam_kw, lm_apply=lm_apply, lm_weight=LM_WEIGHT, ctc_impl=ctc))
    unfused = make_eval_step(kernel32, FeatureConfig(), 0, vocab.pad_id)
    loss_errs, agree, frames, beam_differ, apart = [], 0, 0, [], []
    for audio, alen in batches[1:]:
        (lk, ik, ol), (lp, ip, _) = (steps[n][0](audio, alen, t_dev, tl_dev) for n in ("kernel", "plain"))
        (bk, tk, nk), (bp, tp, np_) = (steps[n][1](audio, alen, t_dev, tl_dev) for n in ("kernel", "plain"))
        lu = unfused(audio, alen, t_dev, tl_dev)[0]
        check(bool(torch.isfinite(lk)) and bool(torch.isfinite(bk)), "a fused loss is not finite")
        loss_errs += [abs(lk.item() - lp.item()) / abs(lp.item()), abs(bk.item() - bp.item()) / abs(bp.item())]
        apart.append(abs(lk.item() - lu.item()) / abs(lu.item()))
        valid = torch.arange(ik.shape[1], device=dev)[None, :] < ol[:, None]
        agree += (ik == ip)[valid].sum().item()
        frames += valid.sum().item()
        beam_differ.append(sum(not (torch.equal(tk[r], tp[r]) and nk[r] == np_[r]) for r in range(BATCH)))
    print(f"fused eval f32 (Conformer-M + the pronunciation LM, weight {LM_WEIGHT}, pronunciations of up to {pron_len} "
          f"tokens: S = {pron_len} × T'), kernel vs plain path over {N_BATCHES} batches: loss max rel|Δ| "
          f"{max(loss_errs):.3e} (tol {FUSED_LOSS_RTOL}), greedy ids equal on {agree}/{frames} valid frames, beam 1-best "
          f"rows that differ a batch {beam_differ} (at most {FUSED_BEAM_ROWS_MAY_DIFFER}); fused against unfused loss, "
          f"relative: {[f'{x:.3e}' for x in apart]}")
    check(max(loss_errs) <= FUSED_LOSS_RTOL, "the fused loss of the kernel path disagrees with the plain path's")
    check(agree >= SLICE_ID_AGREEMENT * frames, "the fused greedy ids of the kernel path disagree")
    check(max(beam_differ) <= FUSED_BEAM_ROWS_MAY_DIFFER, "the fused beam hypotheses of the kernel path disagree")
    check(min(apart) > 1e-6, "the fusion did not move the loss")
    del kernel32, plain32, steps

    # bf16, as a user runs it: Trainer.evaluate fused and unfused, greedy and beam
    data = ArrayDataset(batches[1:], targets, tlen, vocab)
    warm = ArrayDataset(batches[:1], targets, tlen, vocab)
    results, launches = {}, {}
    for fused in (False, True):
        trainer = Trainer(ConformerCTC(conformer_m(use_pallas=True), VOCAB), vocab, FeatureConfig(),
                          TrainConfig(batch_size=BATCH, **beam_kw), log_fn=lambda _: None,
                          lm_apply=lm_apply if fused else None, lm_weight=LM_WEIGHT)
        trainer.init_state(seed=SEED)
        trainer.model.load_state_dict(weights)
        for decode in ("greedy", "beam"):
            trainer.evaluate(warm, decode=decode)
            torch.cuda.synchronize()
            if fused:
                reset_counters()
            t0 = time.perf_counter()
            loss, wer = trainer.evaluate(data, decode=decode)
            torch.cuda.synchronize()
            results[fused, decode] = (loss, wer, (time.perf_counter() - t0) / N_BATCHES * 1e3)
            if fused:
                launches[decode] = read_counters()
    for decode in ("greedy", "beam"):
        (lu, wu, mu), (lf, wf, mf) = results[False, decode], results[True, decode]
        print(f"bf16 Trainer.evaluate ({decode}), Conformer-M, B={BATCH}, {SECONDS:.0f} s clips: fused {mf:.2f} ms/batch "
              f"(loss {lf:.4f}, WER {100 * wf:.2f}%) against unfused {mu:.2f} ms/batch (loss {lu:.4f}, WER "
              f"{100 * wu:.2f}%)  [{card}]")
        check(np.isfinite(lf) and abs(lf - lu) > 1e-6 * abs(lu), f"the fused {decode} loss is not finite or not moved")
    blocks = conformer_m().encoder.num_blocks
    want = {"stft_logmel": N_BATCHES, "attention_relpos": blocks * N_BATCHES, "lstm": N_BATCHES, "ctc_alpha": N_BATCHES}
    for decode, got in launches.items():
        check(got == {**dict.fromkeys(got, 0), **want}, f"fused {decode} evaluation launches {got}, want {want}")
    print(f"launch counts of the fused bf16 evaluation over {N_BATCHES} batches, greedy then beam: {launches}")

    # -- weight fusion on the card: a zero LM is a no-op, a seeded one moves blocks 0-3 and 15-12 only
    d, heads = conformer_m().encoder.d_model, conformer_m().encoder.num_heads
    wide = init_params(TransformerLM(len(corpus.phoneme_vocab), len(vocab), d=d, heads=heads), gen).to(dev)
    asr_state = {k: v.to(dev) for k, v in weights.items()}
    zero = fuse_lm_weights_into_asr(asr_state, {k: torch.zeros_like(v) for k, v in wide.state_dict().items()})
    check(all(torch.equal(zero[k], v) for k, v in asr_state.items()), "fusing an all-zero LM changed the ASR model")
    fused_state = fuse_lm_weights_into_asr(asr_state, wide.state_dict())
    moved = sorted({int(k.split(".")[2]) for k, v in fused_state.items() if not torch.equal(v, asr_state[k])})
    check(moved == [0, 1, 2, 3, 12, 13, 14, 15], f"weight fusion moved blocks {moved}")
    skipped = fuse_lm_weights_into_asr(asr_state, tr.model.state_dict())  # d 320 against 256: every block skipped
    check(all(torch.equal(skipped[k], v) for k, v in asr_state.items()), "an LM of another width was fused")
    fused_model = model(use_pallas=True)
    fused_model.load_state_dict(fused_state)
    loss = make_eval_step(fused_model, FeatureConfig(), 0, vocab.pad_id)(*batches[1], t_dev, tl_dev)[0]
    print(f"weight fusion on the card: zero LM a no-op, a seeded LM at d {d} moved the MHSA of blocks {moved}, the LM at "
          f"d {lm_cfg.embed_dim} skipped; the fused model's loss {loss.item():.4f}")
    check(bool(torch.isfinite(loss)), "the weight-fused model's loss is not finite")
    return {k: launches["greedy"][k] + launches["beam"][k] for k in launches["greedy"]}


def check_cli_pretrain(card: str) -> tuple:
    """``pretrain`` on the command line (Conformer-M, the Noisy Student phase's synthetic corpus, its unlabelled
    split, one epoch), then ``train --encoder-checkpoint`` from its save, which must start the ASR model as from
    its seed alone.  Returns the launch counts of each command."""
    from nn_conformer_for_speech_recognition_tpu_torch.cli import main as cli
    from nn_conformer_for_speech_recognition_tpu_torch.data.audio import make_synthetic_corpus
    from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import STATE_FILE

    with tempfile.TemporaryDirectory() as root:
        corpus = os.path.join(root, "corpus")
        make_synthetic_corpus(corpus, NST_WORDS, NST_TRAIN, NST_VAL, 0, NST_UNLABELED, max_words_per_utt=NST_MAX_WORDS,
                              seed=SEED)
        buckets = ["--bucket-boundaries", *(str(n) for n, _ in NST_BUCKETS)]
        pretrained = os.path.join(root, "pretrained")
        reset_counters()
        _, pre_s = run_cli(["pretrain", "--manifest-dir", corpus, "--model", "conformer_m", "--batch-size", str(NST_BATCH),
                            *buckets, "--epochs", "1", "--lr", str(LOSS_LR), "--save", pretrained])
        pre_launches = read_counters()
        saved = torch.load(os.path.join(pretrained, STATE_FILE), map_location="cpu", weights_only=True)
        steps = saved["step"]
        # one epoch over the two length buckets: at least NST_UNLABELED / NST_BATCH steps, one more a ragged bucket
        check(saved["model"]["decoder.lstm_fwd_0_w_hh"].shape == (160, 640)
              and NST_UNLABELED // NST_BATCH <= steps <= NST_UNLABELED // NST_BATCH + len(NST_BUCKETS)
              and all(bool(torch.isfinite(v).all()) for v in saved["model"].values()),
              f"the pretrain checkpoint: {steps} steps")
        data = ["--manifest-dir", corpus, "--batch-size", str(NST_BATCH), "--max-target-len", str(NST_MAX_WORDS), *buckets]
        model = ["--model", "conformer_m", "--use-pallas"]
        reset_counters()
        _, train_s = run_cli(["train", *data, *model, "--epochs", "1", "--lr", str(NST_LR), "--encoder-checkpoint",
                              pretrained])
        train_launches = read_counters()
        with contextlib.redirect_stdout(io.StringIO()):
            fresh, _, _ = cli._build(cli.build_parser().parse_args(["eval", *data, *model]))
            handed, _, _ = cli._build(cli.build_parser().parse_args(["eval", *data, *model, "--encoder-checkpoint",
                                                                     pretrained]))
        same = all(torch.equal(a, b) for a, b in zip(fresh.model.state_dict().values(), handed.model.state_dict().values()))
    print(f"command line: pretrain, Conformer-M f32, {NST_UNLABELED} unlabelled clips in {steps} steps of {NST_BATCH}: "
          f"{pre_s:.2f} s; launches {pre_launches}; train --encoder-checkpoint from its save: {train_s:.2f} s, the "
          f"ASR model as from its seed alone: {same}; launches {train_launches}  [{card}]")
    check(same, "train --encoder-checkpoint from a pretraining checkpoint changed the ASR model")
    want = {"stft_logmel": steps, "lstm": steps, "lstm_backward": steps, "lstm_weight_grad": 2 * steps}
    check(pre_launches == {**dict.fromkeys(pre_launches, 0), **want}, f"pretrain launches {pre_launches}, want {want}")
    check(all(train_launches[k] > 0 for k in ("stft_logmel", "attention_relpos", "lstm", "lstm_backward",
                                              "lstm_weight_grad", "ctc_alpha", "ctc_beta")),
          "train --encoder-checkpoint missed a kernel of its path")
    return pre_launches, train_launches


F2_STEPS_PER_EPOCH, F2_EPOCHS = 5, 2  # the repeatability phase: ten steps, the first five batches of two epochs
F2_STAGES = ("batch", "features (log-mel, SpecAugment)", "subsampling convs out", "encoder out", "BiLSTM out",
             "log-probs", "loss", "log-prob gradient (the CTC gather's adjoint)")
F2_GROUPS = ("final_fc", "BiLSTM w_hh (lstm_dwhh)", "BiLSTM w_ih, bias", "projection, norm", "encoder",
             "subsampling convs")


# The resident phase: a corpus of 64 seeded clips of 28-30 s, each with a transcript of 100 words over a lexicon that
# makes vocabulary 1024 (the 30 s step's target shape), one bucket of 480,000 samples: 4 steps an epoch at B=16
RESIDENT_CLIPS, RESIDENT_WORDS, RESIDENT_EPOCHS = 64, 100, 2


def resident_corpus(root: str):
    """``RESIDENT_CLIPS`` 16-bit WAVs (three tones and noise, 28-30 s, the
    first 30 s) under ``root`` with their transcripts: every word of a
    lexicon of VOCAB - 3 words is said at least once."""
    from nn_conformer_for_speech_recognition_tpu_torch.data.audio import write_wav
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import Utterance

    rng = np.random.default_rng(SEED + 16)
    lexicon = [f"w{i}" for i in range(VOCAB - 3)]
    utts = []
    for i in range(RESIDENT_CLIPS):
        n = int(SECONDS * 16000) if i == 0 else int(rng.integers(int(SECONDS * 16000) * 14 // 15, int(SECONDS * 16000) + 1))
        t = np.arange(n) / 16000.0
        freqs = 100.0 + 3000.0 * rng.random(3)
        x = 0.1 * np.sin(2 * np.pi * freqs[:, None] * t).sum(axis=0) + 0.05 * rng.standard_normal(n)
        path = os.path.join(root, f"clip{i:03d}.wav")
        write_wav(path, x.astype(np.float32), 16000)
        words = [lexicon[(i * RESIDENT_WORDS + j) % len(lexicon)] for j in range(RESIDENT_WORDS)]
        rng.shuffle(words)
        utts.append(Utterance(path, " ".join(words)))
    return utts


@contextlib.contextmanager
def python_decoder():
    """The WAV decoder as on a machine without a compiler."""
    from nn_conformer_for_speech_recognition_tpu_torch.data import native_loader

    load = native_loader._load_native
    native_loader._load_native = lambda: None
    try:
        yield
    finally:
        native_loader._load_native = load


def check_resident(card: str) -> dict:
    """Device-resident data at full width: the native WAV decode against the
    pure-Python one (sample for sample, and `BucketedDataset.make_batch`
    over each), `DeviceResidentDataset` on the card, then Conformer-M (bf16,
    ``use_pallas=True``, ``conv_impl='auto'``, Adafactor as the 30 s step,
    SpecAugment and dropout on) trained from one seed by ``Trainer.train``
    over it (its resident source: each order row gathered on the card) and
    over the host `BucketedDataset`'s batches in the same order (its host
    source: each batch copied to the card): every loss, parameter, batch
    statistic and optimizer slot bit-equal, and the launch counts of both.
    One further epoch, `make_epoch_scan_step` over the trainer's model,
    runs with ``torch.cuda.set_sync_debug_mode('error')``: a call that
    waits for the card inside it raises.  Returns the resident source's
    launch counts over its two epochs."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, TrainConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.data import native_loader
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset
    from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.models.conformer import sinusoidal_rel_positions
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    n_samples = int(SECONDS * 16000)
    check((BATCH, T_SUB) in KERNEL_SHAPES_CHECKED, "the kernel phases did not run at the resident batches' shape")
    with tempfile.TemporaryDirectory() as root:
        t0 = time.perf_counter()
        utts = resident_corpus(root)
        vocab = build_vocab("word", [u.transcript for u in utts])
        check(len(vocab) == VOCAB, f"the resident corpus makes vocabulary {len(vocab)}")
        corpus_s = time.perf_counter() - t0

        # -- the native decode against the pure-Python one
        check(native_loader.native_available(), "the native WAV decoder did not build on this machine")
        paths = [u.audio_path for u in utts]
        decoded, seconds = {}, {}
        for branch in ("native", "python"):
            out, lens = np.zeros((len(paths), n_samples), np.float32), np.zeros((len(paths),), np.int32)
            with python_decoder() if branch == "python" else contextlib.nullcontext():
                t0 = time.perf_counter()
                native_loader.decode_batch(paths, out, lens)
                seconds[branch] = time.perf_counter() - t0
            decoded[branch] = out, lens
        check(np.array_equal(decoded["native"][0], decoded["python"][0])
              and np.array_equal(decoded["native"][1], decoded["python"][1]), "the two WAV decodes disagree")
        audio_s = float(decoded["native"][1].sum()) / 16000
        print(f"resident corpus: {len(paths)} clips, {audio_s:.1f} audio-s, vocabulary {len(vocab)}, written in "
              f"{corpus_s:.2f} s; decode_batch of all clips: native {seconds['native']:.3f} s, pure Python "
              f"{seconds['python']:.3f} s, equal sample for sample")

        def host_dataset(cache_audio: bool):
            return BucketedDataset(utts, vocab, BATCH, bucket_boundaries=[n_samples], max_target_len=RESIDENT_WORDS,
                                   cache_audio=cache_audio)

        idx = np.arange(BATCH) * 3 % len(utts)
        batches = {}
        for branch in ("native", "python"):
            with python_decoder() if branch == "python" else contextlib.nullcontext():
                ds = host_dataset(False)
                t0 = time.perf_counter()
                batches[branch] = ds.make_batch(idx, n_samples)
                seconds[branch] = time.perf_counter() - t0
        check(all(np.array_equal(getattr(batches["native"], k), getattr(batches["python"], k))
                  for k in ("audio", "audio_lengths", "targets", "target_lengths", "indices")),
              "make_batch differs between the two decodes")
        check(bool((batches["native"].target_lengths == RESIDENT_WORDS).all()), "a clip has not 100 targets")
        print(f"make_batch of {BATCH} clips (cache off): native {seconds['native'] * 1e3:.1f} ms, pure Python "
              f"{seconds['python'] * 1e3:.1f} ms, equal")

        # -- the resident dataset on the card
        host = host_dataset(True)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        dev = DeviceResidentDataset(host)
        torch.cuda.synchronize()
        build_s = time.perf_counter() - t0
        arrays = dev.device_arrays()
        check(all(x.device.type == "cuda" for x in arrays), "the resident tensors are not on the card")
        steps = dev.num_batches()
        print(f"DeviceResidentDataset: {nbytes(*arrays) / 1e6:.1f} MB resident ({len(dev)} clips × {n_samples} "
              f"samples, float32), built in {build_s:.2f} s; {steps} steps an epoch at B={BATCH}")

        def trainer():
            train_cfg = TrainConfig(batch_size=BATCH, log_every=0)
            tr = Trainer(ConformerCTC(conformer_m(use_pallas=True), len(vocab)), vocab, FeatureConfig(), train_cfg,
                         log_fn=lambda msg: None)
            tr.init_state(seed=SEED)
            return tr

        def state_tensors(tr):
            out = {f"model.{k}": v for k, v in tr.model.state_dict().items()}
            out.update({f"opt.{n}.{k}": v for n, slots in tr.state.optimizer.state.items() for k, v in slots.items()})
            return out

        # -- the two sources from one seed, bit for bit
        on_host, resident = trainer(), trainer()
        reset_counters()
        on_host.train(InResidentOrder(host, dev), epochs=RESIDENT_EPOCHS)
        host_launches = read_counters()
        reset_counters()
        resident.train(dev, epochs=RESIDENT_EPOCHS)
        torch.cuda.synchronize()
        launches = read_counters()
        n, cfg = RESIDENT_EPOCHS * steps, resident.model.config
        expected = {**dict.fromkeys(launches, 0), "stft_logmel": n, "lstm": n, "lstm_backward": n,
                    "lstm_weight_grad": 2 * n, "ctc_alpha": n, "ctc_beta": n, **update_launches(n),
                    **train_attention_launches(cfg, T_SUB, cfg.encoder.num_blocks * n)}
        print(f"launch counts over {RESIDENT_EPOCHS} resident epochs ({n} steps): {launches}")
        check(launches == expected and host_launches == expected, f"resident launch counts, want {expected}")
        a, b = state_tensors(on_host), state_tensors(resident)
        differ = [k for k in a if not torch.equal(a[k], b[k])]
        losses = resident.history["train_loss"]
        print(f"train's two sources, {RESIDENT_EPOCHS} epochs: losses resident {losses} / host "
              f"{on_host.history['train_loss']}; {len(a) - len(differ)}/{len(a)} state tensors bit-equal")
        check(losses == on_host.history["train_loss"] and bool(np.isfinite(losses).all()), "the sources' losses differ")
        check(not differ, f"the sources' state differs in {differ[:5]}")
        check((resident.state.step, resident.state.optimizer.count)
              == (on_host.state.step, on_host.state.optimizer.count) == (n, n), "the sources' step counts differ")
        check(torch.equal(resident.state.generator.get_state(), on_host.state.generator.get_state()),
              "the sources' SpecAugment generators differ")

        # -- (b): nothing waits for the card inside an epoch
        order = dev.order_matrix(seed=SEED + RESIDENT_EPOCHS)
        epoch = epoch_step(resident)
        torch.cuda.synchronize()
        torch.cuda.set_sync_debug_mode("error")
        try:
            order_dev = resident._upload_order(order)
            resident.state, out = epoch(resident.state, *arrays, order_dev)
        finally:
            torch.cuda.set_sync_debug_mode("default")
        sync_free = out[0].cpu().numpy()
        # the control: under the same mode the copy that each forward used to make of the rel-pos table (from
        # pageable host memory, before `rel_position_table` kept it on the card) raises
        torch.cuda.set_sync_debug_mode("error")
        try:
            torch.from_numpy(sinusoidal_rel_positions(T_SUB, conformer_m().encoder.d_model)).to("cuda")
            control = "did not raise"
        except RuntimeError as e:
            control = f"raised ({e})"
        finally:
            torch.cuda.set_sync_debug_mode("default")
        print(f"one epoch of make_epoch_scan_step under set_sync_debug_mode('error'): no wait for the card; losses "
              f"{sync_free.tolist()}; the control, a pageable copy of the rel-pos table under the same mode, {control}")
        check(sync_free.shape == (steps,) and bool(np.isfinite(sync_free).all()), "the sync-checked epoch's losses")
        check(control.startswith("raised"), "set_sync_debug_mode('error') did not catch a pageable host-to-device copy")
    return launches


class InResidentOrder:
    """A host `BucketedDataset` read in a `DeviceResidentDataset`'s order:
    each row of the resident ``order_matrix(seed)`` built by the host's
    ``make_batch`` at its largest bucket, so that `Trainer.train`'s host
    source takes the batches its resident source gathers."""

    def __init__(self, host, dev):
        self._host, self._dev = host, dev

    def epoch(self, seed=None, shuffle=True):
        for row in self._dev.order_matrix(seed, shuffle):
            yield self._host.make_batch(row[row >= 0], max(self._host.bucket_boundaries))

    def num_batches(self):
        return self._dev.num_batches()

    def __getattr__(self, name):
        return getattr(self._host, name)


def epoch_step(tr):
    """`make_epoch_scan_step` over a trainer's model, with its augmentation,
    CTC, ids and data-parallel layout."""
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_epoch_scan_step

    cfg = tr.train_cfg
    return make_epoch_scan_step(tr.model, tr.feat_cfg, cfg.specaugment, tr.vocab.blank_id,
                                use_specaugment=cfg.use_specaugment, ctc_impl=cfg.ctc_impl, batch_sharding=tr.shard,
                                emit_ids=cfg.train_wer, pad_id=tr.vocab.pad_id, mesh=tr.mesh)


DP_STEPS, DP_GLOO_BLOCKS = 3, 2  # train steps of the data-parallel phase; the gloo phase's encoder depth
DP_GLOO_LR = 1e-3  # the gloo phase's learning rate: the CPU tests' (their bars were set at it)
# the gloo phase's gradient bar, of each tensor's largest entry: float32 sums over B·T' = 3,760 frames in two
# orders (one unit roundoff, 6e-8, times the frames: 2.2e-4 of the summed terms), with a factor of two; the CPU
# test's 1e-5 holds at T' = 14
DP_GRAD_BAR = 5e-4
DP_TRACE_KERNELS = {  # counter → a substring of its kernel's name in a profiler trace
    "stft_logmel": "stft_logmel_tc_kernel", "lstm": "lstm_fwd_cluster", "lstm_backward": "lstm_bwd_cluster",
    "lstm_weight_grad": "lstm_dwhh", "ctc_alpha": "ctc_alpha_kernel", "ctc_beta": "ctc_beta_kernel",
    "attention_relpos": "attention_relpos_tc_kernel", "depthwise_conv": "depthwise_conv_kernel",
    "adafactor_step": "adafactor_apply_kernel", "global_norm": "sumsq_partials_kernel",
    # the forward with lse is the same template as the forward without, the backward one kernel each
    "attention_relpos_lse": "attention_relpos_tc_kernel", "attention_relpos_bwd_dq": "bwd_dq_tc_kernel",
    "attention_relpos_bwd_dkv": "bwd_dkv_tc_kernel", "attention_relpos_bwd_dband": "bwd_dband_tc_kernel",
}


def profiler_warmup() -> None:
    """Opens a profiling window with 64 short ``spin_kernel`` launches and
    a wait: in a process that has profiled before, the first kernels of a
    window can go unrecorded (17 of a train step's have been on the H100),
    so the window's own work starts after these, and their rows are left
    out of the sums."""
    for _ in range(64):
        torch.cuda._sleep(1000)
    torch.cuda.synchronize()
    time.sleep(0.01)


def dp_trainer(vocab, preset=None, lr: Optional[float] = None):
    """A `Trainer` of the data-parallel phase (Conformer-M bf16,
    ``use_pallas=True``, unless ``preset`` is given; Adafactor as the 30 s
    step, at ``lr`` where given; SpecAugment on), initialised from SEED."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, TrainConfig, conformer_m
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    cfg = preset if preset is not None else conformer_m(use_pallas=True)
    tr = Trainer(ConformerCTC(cfg, len(vocab)), vocab, FeatureConfig(), TrainConfig(batch_size=BATCH, log_every=0),
                 learning_rate=lr, log_fn=lambda msg: None)
    tr.init_state(seed=SEED)
    return tr


def dp_small_run(vocab, data) -> tuple:
    """The two-process phase's work, in whichever process group is set:
    one step's gradient from the start (a fresh trainer), then `DP_STEPS`
    steps of `Trainer.train`; (gradients, losses, parameters) on the host."""
    first = dp_trainer(vocab, preset=small_depth(), lr=DP_GLOO_LR)
    batch = next(data.epoch(seed=SEED))
    first._composed_step(True, 0.0)(first.state, *first._put(first._local(batch)), first._batch_lengths(batch))
    grads = {n: p.grad.detach().cpu() for n, p in first.model.named_parameters()}
    tr = dp_trainer(vocab, preset=small_depth(), lr=DP_GLOO_LR)
    tr.train(data, epochs=1)
    return grads, tr.history["train_loss"], {k: v.detach().cpu() for k, v in tr.model.state_dict().items()}


def small_depth(**kw):
    """Conformer-M's widths at `DP_GLOO_BLOCKS` blocks, float32, dropout 0:
    the two-process phase's model."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import conformer_m

    cfg = conformer_m(use_pallas=True, compute_dtype="float32", **kw)
    enc = dataclasses.replace(cfg.encoder, num_blocks=DP_GLOO_BLOCKS, dropout=0.0)
    return dataclasses.replace(cfg, encoder=enc, decoder=dataclasses.replace(cfg.decoder, dropout=0.0))


def dp_gloo_worker(rank: int, world: int, port: int, manifest: str, out_dir: str) -> None:
    """One of the two processes that share the card over gloo: joins the
    group, trains `DP_STEPS` float32 steps of the small-depth model on its
    rows of each global batch (the first `DP_STEPS` batches' clips of the
    corpus at ``manifest``, whose transcripts give the vocabulary), writes
    its losses and parameters."""
    import torch.distributed as dist

    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, load_manifest
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        utts = load_manifest(manifest)
        vocab = build_vocab("word", [u.transcript for u in utts])
        data = BucketedDataset(utts[:DP_STEPS * BATCH], vocab, BATCH, bucket_boundaries=[int(SECONDS * 16000)],
                               max_target_len=RESIDENT_WORDS)
        grads, losses, state = dp_small_run(vocab, data)
        torch.save({"grads": grads, "losses": losses, "state": state}, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def param_spread(got: dict, ref: dict, lr: float, steps: int, rtol: float = 1e-5) -> tuple:
    """(elements outside the CPU test's bars, elements farther apart than
    one Adafactor step of the other sign a step, elements) of ``got``
    against ``ref``.  The bars are ``tests/_torch_multiproc_helpers.
    assert_params_close``'s: rtol with an atol of rtol times the tensor's
    largest entry, here with rtol times the update scale (lr × steps) added
    for tensors that start at zero.  Adafactor's first update of an element
    is ±lr whatever its gradient's size, so an element whose gradient is
    float noise (or, on the card, cuDNN's weight gradients, which sum in no
    fixed order) moves by a step of either sign: such elements miss the bars
    by at most 2 × lr a step."""
    off = beyond = total = 0
    for k, r in ref.items():
        g, r = got[k].float().cpu(), r.float().cpu()
        diff = (g - r).abs()
        off += int((diff > rtol * r.abs() + rtol * (float(r.abs().max()) + lr * steps)).sum())
        beyond += int((diff > 2 * lr * steps + rtol * r.abs()).sum())
        total += r.numel()
    return off, beyond, total


def grad_spread(got: dict, ref: dict) -> float:
    """The largest difference of a gradient tensor from ``ref``'s, over that
    tensor's largest entry."""
    return max(float((got[k] - g).abs().max()) / max(float(g.abs().max()), 1e-30) for k, g in ref.items())


def check_data_parallel(card: str) -> dict:
    """Data parallelism over processes (`parallel.mesh`), Conformer-M bf16,
    ``use_pallas=True``, B=16 × 30 s on the resident phase's corpus:

    * world size 1 over NCCL (``cpu:gloo,cuda:nccl``, a tcp rendezvous on
      127.0.0.1): `DP_STEPS` train steps through the data-parallel path
      (global statistics in the masked BatchNorm, the global row count,
      the flat gradient all-reduce) bit-equal to the same steps without a
      process group; ms/step and device ms/step (`device_ms`) with and
      without it, and the launches the group adds (the NCCL kernels of one
      step under the profiler); `evaluate` and `generate_labels` through
      their gathers, equal to the plain trainer's; a `utils.profiling.trace`
      of one step whose Chrome trace names every hand-written kernel the
      step launched; a resident epoch of `make_epoch_scan_step` under
      ``set_sync_debug_mode('error')`` with the group on;
    * two processes on the one card over gloo (NCCL refuses two ranks on
      one GPU), Conformer-M's widths at `DP_GLOO_BLOCKS` blocks in float32,
      dropout 0, against one process run twice: ranks bit-equal, losses
      rtol 1e-5, the first step's gradients within `DP_GRAD_BAR` of each
      tensor's largest entry, the parameters after `DP_STEPS` steps
      counted against the CPU tests' bars beside the one process's own
      spread (`param_spread`: no element farther apart than one step of
      the other sign a step, at most 1% of them outside the bars);
    * `utils.guards.check_step` on a step fed a NaN: it must raise.

    Returns the launch counts of the data-parallel steps."""
    import torch.distributed as dist
    from torch.autograd import DeviceType

    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, save_manifest
    from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import BACKEND, data_shard
    from nn_conformer_for_speech_recognition_tpu_torch.utils.guards import check_step, tree_finite_report
    from nn_conformer_for_speech_recognition_tpu_torch.utils.profiling import trace

    check((BATCH, T_SUB) in KERNEL_SHAPES_CHECKED, "the kernel phases did not run at the data-parallel batches' shape")
    n_samples, train_clips = int(SECONDS * 16000), DP_STEPS * BATCH
    with tempfile.TemporaryDirectory() as root:
        utts = resident_corpus(root)
        vocab = build_vocab("word", [u.transcript for u in utts])
        kw = dict(bucket_boundaries=[n_samples], max_target_len=RESIDENT_WORDS)
        train = BucketedDataset(utts[:train_clips], vocab, BATCH, **kw)
        held_out = BucketedDataset(utts[train_clips:train_clips + BATCH], vocab, BATCH, **kw)

        def state_tensors(tr):
            out = {f"model.{k}": v for k, v in tr.model.state_dict().items()}
            out.update({f"opt.{n}.{k}": v for n, slots in tr.state.optimizer.state.items() for k, v in slots.items()})
            return out

        def timings(tr, label):
            """ms/step (host clock around a synchronise), device ms/step
            (`device_ms`), and one profiled step's kernel launches and NCCL
            launches, on one fixed batch."""
            batch = next(train.epoch(seed=SEED))
            step, args = tr._composed_step(True, 0.0), (*tr._put(tr._local(batch)), tr._batch_lengths(batch))

            def one():
                tr.state, _ = step(tr.state, *args)

            one()
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            for _ in range(N_TRAIN_STEPS):
                one()
            torch.cuda.synchronize()
            wall = (time.perf_counter() - t0) / N_TRAIN_STEPS * 1e3
            device = device_ms(one, iters=N_TRAIN_STEPS, warmup=1)
            from torch.profiler import ProfilerActivity, profile

            torch.cuda.synchronize()
            with profile(activities=[ProfilerActivity.CUDA]) as prof:
                profiler_warmup()
                one()
                torch.cuda.synchronize()
            rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
            launches = sum(e.count for e in rows)
            busy = sum(e.self_device_time_total for e in rows) / 1e3
            nccl = sum(e.count for e in rows if "nccl" in e.key.lower())
            print(f"data-parallel phase, {label}: {wall:.2f} ms/step, device {device:.2f} ms/step by device_ms (the "
                  f"host sets the pace, so this reads the wall), the card's own work {busy:.2f} ms/step under the "
                  f"profiler in {launches} device launches a step, {nccl} of them NCCL  [{card}]")
            return dict(wall=wall, device=device, busy=busy, launches=launches, nccl=nccl)

        # -- the same steps without a process group, then through the data-parallel path at world size 1
        plain = dp_trainer(vocab)
        plain.train(train, epochs=1)
        check(plain.shard is None and plain.state.step == DP_STEPS, "the plain trainer's steps")
        plain_eval = plain.evaluate(held_out, return_texts=True)
        plain_labels = plain.generate_labels(held_out)
        timer = dp_trainer(vocab)  # timed without the group, before it and after it: plain, group, plain
        without_group = [timings(timer, "without a process group (before it)")]
        port = free_port()
        dist.init_process_group(BACKEND, init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)
        try:
            dp = dp_trainer(vocab)
            check(dp.shard == data_shard() and dp.shard.world == 1, "the trainer did not take the process group")
            reset_counters()
            dp.train(train, epochs=1)
            torch.cuda.synchronize()
            launches = read_counters()
            a, b = state_tensors(plain), state_tensors(dp)
            differ = [k for k in a if not torch.equal(a[k], b[k])]
            print(f"data-parallel phase, world size 1 over NCCL: {DP_STEPS} steps, losses "
                  f"{dp.history['train_loss']} / without a process group {plain.history['train_loss']}; "
                  f"{len(a) - len(differ)}/{len(a)} state tensors bit-equal; launch counts {launches}")
            check(not differ and dp.history["train_loss"] == plain.history["train_loss"],
                  f"the data-parallel steps differ from the plain ones in {differ[:5]}")
            check(torch.equal(dp.state.generator.get_state(), plain.state.generator.get_state()),
                  "the SpecAugment generators differ")
            dp_eval = dp.evaluate(held_out, return_texts=True)
            dp_labels = dp.generate_labels(held_out)
            check(dp_eval == plain_eval and dp_labels == plain_labels and len(dp_labels) == BATCH,
                  "evaluate or generate_labels through the gathers differs from the plain trainer's")
            print(f"evaluate through gather_metric: loss {dp_eval[0]:.6f}, WER {dp_eval[1]:.4f} (equal to the plain "
                  f"trainer's); generate_labels through gather_pseudo_labels: {len(dp_labels)} labels, equal")

            # -- time, with and without the group (the plain trainer runs in the group's absence below)
            with_group = timings(dp, "world size 1 over NCCL")

            # -- one traced step: its events name every hand-written kernel it launched
            batch = next(train.epoch(seed=SEED))
            step = dp._composed_step(True, 0.0)
            args = (*dp._put(dp._local(batch)), dp._batch_lengths(batch))
            trace_dir = os.path.join(root, "trace")
            reset_counters()
            with trace(trace_dir):
                profiler_warmup()
                dp.state, _ = step(dp.state, *args)
                torch.cuda.synchronize()
            traced = {k for k, v in read_counters().items() if v}
            with open(next(Path(trace_dir).glob("trace_*.json"))) as f:
                names = {e.get("name", "") for e in json.load(f)["traceEvents"] if e.get("cat") == "kernel"}
            missing = [k for k in traced if not any(DP_TRACE_KERNELS[k] in n for n in names)]
            print(f"utils.profiling.trace of one step: {len(names)} kernel names; hand-written kernels launched "
                  f"{sorted(traced)}, each named in the trace: {not missing}")
            check(traced and not missing, f"the trace does not name {missing}")

            # -- a resident epoch with the group on: nothing waits for the card inside it
            dev = DeviceResidentDataset(train, sharding=data_shard())
            epoch = epoch_step(dp)
            arrays = dev.device_arrays()
            order = dev.order_matrix(seed=SEED + 1)
            epoch(dp.state, *arrays, dp._upload_order(order[:1]))  # one step first: NCCL's setup may wait
            torch.cuda.synchronize()
            torch.cuda.set_sync_debug_mode("error")
            try:
                dp.state, out = epoch(dp.state, *arrays, dp._upload_order(order))
            finally:
                torch.cuda.set_sync_debug_mode("default")
            sync_free = out[0].cpu().numpy()
            print(f"one resident epoch of make_epoch_scan_step under set_sync_debug_mode('error') with the process "
                  f"group on: no wait for the card; losses {sync_free.tolist()}")
            check(sync_free.shape == (order.shape[0],) and bool(np.isfinite(sync_free).all()),
                  "the sync-checked epoch")
        finally:
            dist.destroy_process_group()
        without_group.append(timings(timer, "without a process group (after it)"))
        without_group = {k: float(np.mean([t[k] for t in without_group])) for k in without_group[0]}
        per_forward = 2 * (conformer_m_blocks() + 1)
        print(f"the process group at world size 1 adds {with_group['launches'] - without_group['launches']:.0f} device "
              f"launches a step ({with_group['nccl']} NCCL); the data-parallel path issues {per_forward} all-reduces a "
              f"forward (two for each of the 16 blocks' masked BatchNorm and the projection norm's), as many in the "
              f"backward, one of the row count and one of the flat gradient: {2 * per_forward + 2} a step; "
              f"{with_group['wall'] - without_group['wall']:+.2f} ms/step of wall, "
              f"{with_group['device'] - without_group['device']:+.2f} ms/step by device_ms, "
              f"{with_group['busy'] - without_group['busy']:+.2f} ms/step of the card's own work (against the mean of "
              f"the two runs without the group)  [{card}]")

        # -- two processes on the one card over gloo, against one process
        manifest = os.path.join(root, "train.tsv")
        save_manifest(manifest, utts)
        ref_grads, ref_losses, ref = dp_small_run(vocab, train)
        rerun_grads, rerun_losses, rerun = dp_small_run(vocab, train)  # one process against itself: the card's floor
        out_dir, port = os.path.join(root, "gloo"), free_port()
        os.makedirs(out_dir)
        ctx = multiprocessing.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=dp_gloo_worker, args=(r, 2, port, manifest, out_dir)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.kill()
                p.join()
        check(all(p.exitcode == 0 for p in procs), f"the gloo workers exited with {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(2)]
        in_sync = all(torch.equal(ranks[0]["state"][k], ranks[1]["state"][k]) for k in ref)
        dp_grad, rerun_grad = grad_spread(ranks[0]["grads"], ref_grads), grad_spread(rerun_grads, ref_grads)
        off, beyond, total = param_spread(ranks[0]["state"], ref, DP_GLOO_LR, DP_STEPS)
        rerun_off, rerun_beyond, _ = param_spread(rerun, ref, DP_GLOO_LR, DP_STEPS)
        loss_ok = np.allclose(ranks[0]["losses"], ref_losses, rtol=1e-5)
        print(f"two processes on one card over gloo (Conformer-M widths, {DP_GLOO_BLOCKS} blocks, float32, lr "
              f"{DP_GLOO_LR}, {DP_STEPS} steps, {time.perf_counter() - t0:.1f} s): losses {ranks[0]['losses']} / one "
              f"process {ref_losses} (again: {rerun_losses}); ranks bit-equal {in_sync}; the first step's gradients "
              f"at most {dp_grad:.2e} of each tensor's largest entry from one process's (one process against itself "
              f"{rerun_grad:.2e}; bar {DP_GRAD_BAR}); parameters: {off} of {total} elements outside the CPU test's bars "
              f"(one process against itself {rerun_off}), {beyond} farther than one step of the other sign a step "
              f"(itself {rerun_beyond})  [{card}]")
        check(in_sync and loss_ok and dp_grad <= DP_GRAD_BAR and beyond == 0 and off <= 1e-2 * total,
              "the two-process run differs from one process")

        # -- check_step on a step fed a NaN
        checked = check_step(plain._composed_step(True, 0.0))
        batch = next(train.epoch(seed=SEED))
        args = (*plain._put(batch), None)
        error, _ = checked(plain.state, *args)
        check(error.get() is None, f"check_step flagged a finite step: {error.get()}")
        audio = args[0].clone()
        audio[0, 1000] = float("nan")
        error, (_, metrics) = checked(plain.state, audio, *args[1:])
        try:
            error.throw()
            raised = None
        except FloatingPointError as e:
            raised = str(e)
        bad = tree_finite_report(plain.model)
        print(f"utils.guards.check_step on a step fed a NaN: raised {raised is not None} ({(raised or '')[:120]}...); "
              f"tree_finite_report then finds {len(bad)} non-finite tensors in the model")
        check(raised is not None and "loss" in raised, "check_step did not raise on a NaN step")
    return launches


def conformer_m_blocks() -> int:
    from nn_conformer_for_speech_recognition_tpu_torch.config import conformer_m

    return conformer_m().encoder.num_blocks


def free_port() -> int:
    import socket

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def check_encoder_variants(card: str) -> dict:
    """The encoder variants at Conformer-M's width and depth:
    ``use_relative_attention=False`` (plain softmax attention, no kernel in
    either package), ``conv_norm='groupnorm'`` and ``'layernorm'`` under
    ``conv_impl='auto'`` (the library conv with its bias) and ``'pallas'``
    (kernel 10, no bias).  For each: the float32 pass, kernel path against
    the plain path from the same weights (``SLICE_*`` bars); then three bf16
    train steps at lr 1e-3 on one batch augmented once: every gradient
    finite and non-zero, the loss falling.  Returns the
    launch counts of the whole phase."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import (
        FeatureConfig, OptimizerConfig, SpecAugmentConfig, conformer_m,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_augment_step, make_feature_train_step
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState

    variants = [(dict(use_relative_attention=False), "auto")] + [
        (dict(conv_norm=norm), conv) for norm in ("groupnorm", "layernorm") for conv in ("auto", "pallas")]
    n_samples, steps = int(SECONDS * 16000), 3
    check((BATCH, T_SUB) in KERNEL_SHAPES_CHECKED, "the kernel phases did not run at the variants' shape")
    audio, alen = make_batches(n_samples, BATCH, 2)[1]
    gen = torch.Generator().manual_seed(SEED + 17)
    targets = torch.randint(3, VOCAB, (BATCH, TARGET_LEN), generator=gen).cuda()
    tlen = torch.full((BATCH,), TARGET_LEN).cuda()
    alen = torch.clamp_min(alen, n_samples // 2)
    feat_kernel, feat_plain = make_featurizer(FeatureConfig()), make_featurizer(FeatureConfig(impl="xla"))
    augment = make_augment_step(FeatureConfig(), SpecAugmentConfig())
    totals = {}
    reset_counters()
    for encoder, conv_impl in variants:
        tag = f"{', '.join(f'{k}={v!r}' for k, v in encoder.items())}, conv_impl={conv_impl!r}"

        def config(**kw):
            cfg = conformer_m(**kw)
            return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, **encoder))

        base = init_params(ConformerCTC(config(use_pallas=True, conv_impl=conv_impl), VOCAB), gen)
        for name, buf in base.named_buffers():  # non-trivial running statistics
            buf.copy_(torch.rand(buf.shape, generator=gen) * 0.5 + (0.75 if name.endswith("var") else -0.25))
        weights = base.state_dict()

        def model(**kw):
            """``weights`` in a model of this variant; the library route's depthwise bias, which the kernel route
            has not, at 0: the same function"""
            m = ConformerCTC(config(**kw), VOCAB)
            missing, unexpected = m.load_state_dict(weights_for(m, weights), strict=False)
            check(not unexpected and all(k.endswith("depthwise.bias") for k in missing), f"weights of {tag}: "
                  f"missing {missing[:3]}, unexpected {unexpected[:3]}")
            with torch.no_grad():
                for k in missing:
                    m.get_parameter(k).zero_()
            return m.cuda()

        # -- float32 pass, kernel path vs plain path
        kernel32 = model(use_pallas=True, conv_impl=conv_impl, compute_dtype="float32").eval()
        plain32 = model(use_pallas=False, compute_dtype="float32").eval()
        with torch.inference_mode():
            fk, fl = feat_kernel(audio, alen)
            lk, ol = kernel32(fk, fl)
            lp, _ = plain32(feat_plain(audio, alen)[0], fl)
        valid = torch.arange(lk.shape[1], device=ol.device)[None, :] < ol[:, None]
        worst = max_abs(lk[valid], lp[valid])
        agree = (lk.argmax(-1) == lp.argmax(-1))[valid].float().mean().item()
        del kernel32, plain32

        # -- bf16 train steps, as a user runs them
        m = model(use_pallas=True, conv_impl=conv_impl)
        state = TrainState.create(m, make_optimizer(OptimizerConfig(learning_rate=LOSS_LR), m.named_parameters()), SEED)
        step = make_feature_train_step(m, blank_id=0)
        losses = []
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        f, fl = augment(state.generator, audio, alen)  # one draw, so that three steps see the loss fall
        for _ in range(steps):
            state, metrics = step(state, f, fl, targets, tlen)
            losses.append(metrics["loss"])
        torch.cuda.synchronize()
        dt = (time.perf_counter() - t0) / steps
        losses = [x.item() for x in losses]
        bad = [n for n, p in m.named_parameters()
               if p.grad is None or not bool(torch.isfinite(p.grad).all()) or p.grad.abs().max().item() == 0]
        print(f"encoder variant ({tag}), Conformer-M: f32 pass kernel vs plain path log-prob max|Δ| {worst:.3e} "
              f"(tol {SLICE_LOGPROB_TOL}), greedy ids equal on {agree:.4%} of valid frames; bf16 train steps at lr "
              f"{LOSS_LR}: {dt * 1e3:.2f} ms/step, loss " + " ".join(f"{x:.3f}" for x in losses) + f"  [{card}]")
        check(worst <= SLICE_LOGPROB_TOL and agree >= SLICE_ID_AGREEMENT, f"{tag}: f32 pass of the kernel path disagrees")
        check(not bad, f"{tag}: gradients missing, non-finite or zero: {bad[:5]}")
        check(bool(np.isfinite(losses).all()) and losses[-1] < losses[0], f"{tag}: the loss did not fall")
        counts = read_counters()
        reset_counters()
        blocks = m.config.encoder.num_blocks
        conv = conv_impl == "pallas"
        # the kernel pass, then the steps: a log-mel for the pass and one for the augment draw; attention kernel 2
        # in the pass, the forward with lse and the backward kernels in the steps (no probability dropout), none
        # without relative positions; kernel 10 forward once a block in the pass, forward and dx a step, dw a step
        expected = {**dict.fromkeys(counts, 0), "stft_logmel": 2, "lstm": 1 + steps, "lstm_backward": steps,
                    "lstm_weight_grad": 2 * steps, "ctc_alpha": steps, "ctc_beta": steps,
                    "attention_relpos": blocks if encoder.get("use_relative_attention", True) else 0,
                    "depthwise_conv": blocks * (1 + 2 * steps) if conv else 0,
                    "depthwise_conv_weight_grad": blocks * steps if conv else 0, **update_launches(steps),
                    **train_attention_launches(m.config, T_SUB, blocks * steps)}
        check(counts == expected, f"{tag}: launch counts {counts}, want {expected}")
        for k, v in counts.items():
            totals[k] = totals.get(k, 0) + v
    print(f"launch counts over the encoder variants' passes and steps: {totals}")
    return totals


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
    from nn_conformer_for_speech_recognition_tpu_torch.train import loop
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
        put, make_core = tr._put, loop.make_feature_train_step

        def put_recorded(batch):
            record.clear()
            grads.clear()
            audio, alen, tgt, tlen = put(batch)
            record[F2_STAGES[0]] = hash((bits(audio), bits(alen), bits(tgt), bits(tlen)))
            return audio, alen, tgt, tlen

        def make_core_recorded(*args, **kwargs):  # the trainer builds its train step on this at its first step
            core = make_core(*args, **kwargs)

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

            return core_recorded

        tr._put, loop.make_feature_train_step = put_recorded, make_core_recorded
        try:
            tr.train(FirstBatches(data, F2_STEPS_PER_EPOCH), epochs=F2_EPOCHS)
        finally:
            loop.make_feature_train_step = make_core
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
    launches, two launches of each cluster LSTM recurrence, and one
    Adafactor update.  Returns the verdicts."""
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
    xws = [torch.randn(b, t, 1280, generator=gen).cuda() for _ in DIRECTIONS]
    w_hhs = [(torch.randn(320, 1280, generator=gen) * 320 ** -0.5).cuda() for _ in DIRECTIONS]
    lengths = mixed_lengths(gen, b, t, t // 3).cuda()
    _, cs, gates = zip(*L.lstm_forward_directions(xws, w_hhs, lengths, DIRECTIONS, save=True))

    def cluster_lstm():
        """Both directions' h from the forward and dxw from the backward, one launch each."""
        hs = [h for h, _, _ in L.lstm_forward_directions(xws, w_hhs, lengths, DIRECTIONS)]
        return hs + L.lstm_backward_directions(hs, gates, cs, w_hhs, lengths, DIRECTIONS)

    verdicts["the cluster LSTM forward and backward, two launches"] = all(map(torch.equal, cluster_lstm(),
                                                                              cluster_lstm()))
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
    check(verdicts["the cluster LSTM forward and backward, two launches"], "two cluster LSTM launches are not bit-equal")
    check(verdicts["the CTC gather's adjoint (the port's emit_log_probs)"], "the CTC gather's adjoint is not bit-equal")
    check(losses_equal and state_equal, f"F2: two fresh processes differ, first at {first}")
    return {"losses_equal": losses_equal, "state_equal": state_equal, "first": first, **verdicts}


# ---------------------------------------------------------------------------
# model and sequence parallelism over processes
# ---------------------------------------------------------------------------

# the long-form batch of the two-process phase: B=4 clips of these lengths (T'=938 padded), targets in proportion to
# LONG_TARGET_LEN; the depth is `DP_GLOO_BLOCKS`, the rule for an earlier path's depth
MP_SECONDS = (120.0, 100.0, 60.0, 110.0)
MP_LR, MP_STEPS = 1e-3, 2  # the LM's and the pretraining's steps over two processes, at this lr
# The steps over two processes against one.  In float32 the split step must compute one process's step to its float32
# roundoff: the loss to 1e-5 and each gradient within `DP_GRAD_BAR` of its largest entry, `check_data_parallel`'s bars;
# the sequence-parallel step its loss, and its gradients are held to the data-parallel step on the same two ranks (the
# data split alone moves every sum over the rows: LayerNorm weights' gradients read 8.1e-4 of their largest entry (H100)
# from one process's at this shape, where `check_data_parallel` holds the data split at its own).  In bf16, the main
# path's type, a split rounds each rank's partial product to bf16 before the sum and a data split rounds sums over its
# rows: with random weights the biases' gradients, sums of terms that nearly cancel, were read (H100) 13-39% of their
# norm apart from one process's while the loss agreed to 1e-4, so bf16 is held to one process by the loss
# (`MP_BF16_LOSS_RTOL`) and the gradient norm (`MP_BF16_NORM_RTOL`) only; and the sequence-parallel bf16 step is held to
# the data-parallel one on the same ranks, from which only the rel-pos table's and u, v's gradients may differ (summed
# over the rows in another order): each gradient within `MP_GRAD_REL` of its norm
MP_BF16_LOSS_RTOL, MP_BF16_NORM_RTOL, MP_GRAD_REL = 1e-3, 5e-2, 5e-2
# ... except, in float32, the gradients of the attention's position terms (u, v and the rel-pos table's projection):
# each is a sum over all B·T' query rows of terms whose row sums vanish (a softmax row's score gradients add up to
# zero), the small remainder of large terms, which another order of the same float32 sums moves further: read (H100)
# 6.9e-4 (split) and 1.48e-3 (sequence-parallel) of their largest entry, bar 5e-3
MP_RELPOS_GRAD_BAR, MP_RELPOS_LEAVES = 5e-3, ("mhsa.u_bias", "mhsa.v_bias", "mhsa.pos_proj.weight")


def mp_config(**kw):
    """Conformer-M at full width, ``use_pallas=True``, `DP_GLOO_BLOCKS` blocks, dropout 0: bf16 on the card."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import conformer_m

    cfg = conformer_m(use_pallas=True, **kw)
    enc = dataclasses.replace(cfg.encoder, num_blocks=DP_GLOO_BLOCKS, dropout=0.0)
    return dataclasses.replace(cfg, encoder=enc, decoder=dataclasses.replace(cfg.decoder, dropout=0.0))


def mp_vocab():
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import WordVocab

    # words of letters only: the LM corpus normalises text to letters and apostrophes
    return WordVocab(["<blank>", "<pad>", "<unk>"] + ["w" + "".join(chr(97 + i // 26 ** k % 26) for k in range(3))
                                                      for i in range(VOCAB - 3)])


def mp_batch() -> tuple:
    """(audio, lengths, targets, target lengths) of the long-form batch, host arrays from SEED."""
    rng = np.random.default_rng(SEED + 18)
    n = int(max(MP_SECONDS) * 16000)
    alen = np.asarray([int(s * 16000) for s in MP_SECONDS], np.int32)
    audio = (0.1 * rng.standard_normal((len(MP_SECONDS), n)) * (np.arange(n)[None] < alen[:, None])).astype(np.float32)
    tlen = np.asarray([round(LONG_TARGET_LEN * s / max(MP_SECONDS)) for s in MP_SECONDS], np.int32)
    targets = np.zeros((len(MP_SECONDS), LONG_TARGET_LEN), np.int32)
    for row, n_tok in enumerate(tlen):
        targets[row, :n_tok] = rng.integers(3, VOCAB, size=n_tok)
    return audio, alen, targets, tlen


def mp_trainer(mesh_cfg, dtype: str = "auto"):
    """The phase's trainer under ``mesh_cfg`` in ``dtype`` ('auto': bf16 on the card), from SEED."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, TrainConfig
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    vocab = mp_vocab()
    tr = Trainer(ConformerCTC(mp_config(compute_dtype=dtype), len(vocab)), vocab, FeatureConfig(),
                 TrainConfig(batch_size=len(MP_SECONDS), use_specaugment=False, log_every=0), mesh_cfg,
                 learning_rate=MP_LR, log_fn=lambda _: None)
    tr.init_state(seed=SEED)
    return tr


def mp_step(tr, batch) -> dict:
    """One train step of ``tr`` on its rows of ``batch``: the loss, the gradient norm, every gradient and the state
    after it (split parameters gathered whole), on the host, and the step's ms (host clock, synchronised)."""
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import full_state_dict, gather_shards

    rows = slice(None) if tr.shard is None else tr.shard.rows(len(MP_SECONDS))
    put = lambda x: torch.from_numpy(np.ascontiguousarray(x[rows])).to(tr.device)  # noqa: E731
    lengths = None if tr.shard is None else torch.from_numpy(batch[1]).to(tr.device)
    args = [put(x) for x in batch]
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    tr.state, metrics = tr._composed_step(False, 0.0)(tr.state, *args, lengths)
    torch.cuda.synchronize()
    ms = (time.perf_counter() - t0) * 1e3
    plan = getattr(tr.model, "tensor_parallel", None)
    grads = {n: (gather_shards(p.grad, plan.specs[n], plan.axis) if plan and n in plan.specs else p.grad).float().cpu()
             for n, p in tr.model.named_parameters()}
    state = {k: v.cpu() for k, v in full_state_dict(tr.model).items()}
    return {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]), "grads": grads, "state": state,
            "ms": ms}


def mp_forward(tr, batch) -> tuple:
    """Eval-mode log-probs (float32) and output lengths of ``tr``'s rows of ``batch``, on the card."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer

    rows = slice(None) if tr.shard is None else tr.shard.rows(len(MP_SECONDS))
    audio, alen = (torch.from_numpy(np.ascontiguousarray(x[rows])).to(tr.device) for x in batch[:2])
    with torch.inference_mode():
        tr.model.eval()
        feats, frames = make_featurizer(tr.feat_cfg)(audio, alen)
        log_probs, lengths = tr.model(feats, frames)
    return log_probs.float(), lengths


def mp_lm_and_pretrain() -> dict:
    """`MP_STEPS` `LMTrainer` steps (`LMConfig`'s widths, dropout 0, float32) on a batch of 8 from a synthetic
    lexicon, and `MP_STEPS` `PretrainTrainer` steps (the two-process phase's Conformer-M, float32) on B=4 × 30 s of
    noise, each data-parallel where a process group is set: losses and parameters on the host."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, LMConfig, PretrainConfig
    from nn_conformer_for_speech_recognition_tpu_torch.data.lm_corpus import Lexicon, LMCorpus
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import full_state_dict
    from nn_conformer_for_speech_recognition_tpu_torch.train.lm_loop import LMTrainer
    from nn_conformer_for_speech_recognition_tpu_torch.train.pretrain_loop import PretrainTrainer

    rng = np.random.default_rng(SEED + 19)
    vocab = mp_vocab()
    words = [w for w in vocab.tokens[3:]][:200]
    phones = [f"P{i}" for i in range(40)]
    lexicon = Lexicon({w: list(rng.choice(phones, size=rng.integers(2, 6))) for w in words})
    corpus = LMCorpus([" ".join(rng.choice(words, size=rng.integers(5, 21))) for _ in range(8)], lexicon, vocab)
    lm = LMTrainer(LMConfig(dropout=0.0), len(corpus.phoneme_vocab), len(vocab), vocab.pad_id, learning_rate=MP_LR,
                   log_fn=lambda _: None)
    lm.init_state(seed=SEED)
    batch = lm._put(*next(corpus.batches(8, seed=0)))
    lm_losses = []
    for _ in range(MP_STEPS):
        lm.state, loss = lm._train_step(lm.state, *batch)
        lm_losses.append(float(loss))
    cfg = mp_config(compute_dtype="float32")
    pt = PretrainTrainer(cfg, PretrainConfig(learning_rate=MP_LR, mask_probability=0.3), FeatureConfig(),
                         log_fn=lambda _: None)
    pt.init_state(seed=SEED)
    audio = torch.from_numpy((0.1 * rng.standard_normal((4, int(SECONDS * 16000)))).astype(np.float32))
    rows = slice(None) if pt.shard is None else pt.shard.rows(4)
    audio = audio[rows].to(pt.device)
    alen = torch.full((audio.shape[0],), audio.shape[1], dtype=torch.int32, device=pt.device)
    pt_losses = []
    for _ in range(MP_STEPS):
        pt.state, metrics = pt._train_step(pt.state, audio, alen)
        pt_losses.append(float(metrics["loss"]))
    return {"lm_losses": lm_losses, "lm": {k: v.cpu() for k, v in full_state_dict(lm.model).items()},
            "pt_losses": pt_losses, "pt": {k: v.cpu() for k, v in pt.model.state_dict().items()}}


def mp_gloo_worker(rank: int, world: int, port: int, out_dir: str) -> None:
    """One of the two processes of `check_model_parallel` sharing the card over gloo: the split step (model axis 2)
    with its kernel launches, the pass's log-probs decoded by the vocabulary-sharded beam search beside the dense one;
    the eval forward with and without Ulysses over the data axis (2 data ranks) and the sequence-parallel step; the
    LM and pretraining steps data-parallel; the dry run's twin.  Writes what the parent holds against one process."""
    import torch.distributed as dist

    from nn_conformer_for_speech_recognition_tpu_torch.config import MeshConfig
    from nn_conformer_for_speech_recognition_tpu_torch.dryrun import dryrun_multichip
    from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import ctc_beam_search, ctc_beam_search_sharded
    from nn_conformer_for_speech_recognition_tpu_torch.parallel import sequence as S

    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    torch.cuda.set_device(0)
    dist.init_process_group("gloo", init_method=f"tcp://127.0.0.1:{port}", rank=rank, world_size=world)
    try:
        out, batch = {}, mp_batch()
        t0 = time.perf_counter()
        tp = mp_trainer(MeshConfig(model_parallel_size=world))
        reset_counters()
        out["tp"] = mp_step(tp, batch)
        out["tp_launches"] = read_counters()
        out["tp32"] = mp_step(mp_trainer(MeshConfig(model_parallel_size=world), "float32"), batch)
        log_probs, lengths = mp_forward(tp, batch)
        part = log_probs.shape[2] // world
        kw = dict(blank_id=0, beam=BEAM, prune=PRUNE, max_label_len=MAX_LABEL_LEN)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        sharded = ctc_beam_search_sharded(log_probs[..., rank * part:(rank + 1) * part].contiguous(), lengths,
                                          axis=tp.mesh.model, **kw)
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        dense = ctc_beam_search(log_probs, lengths, **kw)
        torch.cuda.synchronize()
        out["beam"] = {"equal": all(torch.equal(a, b) for a, b in zip(sharded[:2], dense[:2])),
                       "score_diff": float((sharded[2] - dense[2]).abs().max()), "sharded_s": t2 - t1,
                       "dense_s": time.perf_counter() - t2, "frames": int(lengths.max()),
                       "lengths": sharded[1][:, 0].tolist()}
        out["tp_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        dp = mp_trainer(MeshConfig())
        plain_lp, _ = mp_forward(dp, batch)
        out["dp"] = mp_step(dp, batch)
        out["dp32"] = mp_step(mp_trainer(MeshConfig(), "float32"), batch)
        sp = mp_trainer(MeshConfig(seq_parallel=True))
        try:
            S.reset_fallback_stats()
            sp_lp, _ = mp_forward(sp, batch)
            out["sp_forward_equal"] = torch.equal(sp_lp, plain_lp)
            out["sp_forward_diff"] = float((sp_lp - plain_lp).abs().max())
            out["sp_stats"] = S.fallback_stats("seq_parallel")
            reset_counters()
            out["sp"] = mp_step(sp, batch)
            out["sp_launches"] = read_counters()
            out["sp32"] = mp_step(mp_trainer(MeshConfig(seq_parallel=True), "float32"), batch)
        finally:
            S.set_sequence_mesh(None)
        out["sp_s"] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out.update(mp_lm_and_pretrain())
        dry = dryrun_multichip(log=lambda _: None)
        out["dryrun"] = {"loss": dry["loss"], "labels": len(dry["labels"]), "mesh": dry["mesh"]}
        out["rest_s"] = time.perf_counter() - t0
        torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    finally:
        dist.destroy_process_group()


def head_slice_kernels(card: str) -> None:
    """Kernels 2 (with and without lse) and 5, 6 and 7 on heads 2-3 of the long-form step's (4, 938, 4, 64) bf16
    inputs and the table's (1875, 2, 64) head slice, as a model rank of two launches them, each held bit-equal to
    the same heads of the whole launch; the copies that make a strided head slice contiguous counted under the
    profiler beside the kernels."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A

    dev, gen = torch.device("cuda"), torch.Generator().manual_seed(SEED + 20)
    b, t, h, dh = LONG_BATCH, LONG_T_SUB, 4, 64
    lengths = torch.tensor([938, 500, 20, 811], dtype=torch.int32, device=dev)
    qu, qv, k, v, g = (torch.randn(b, t, h, dh, generator=gen).mul(0.5).to(dev, torch.bfloat16) for _ in range(5))
    p = torch.randn(2 * t - 1, h, dh, generator=gen).mul(0.5).to(dev, torch.bfloat16)
    heads, scale = slice(2, 4), dh ** -0.5

    def run(qu, qv, k, v, p, g, lengths):
        with torch.no_grad():
            plain = A.flash_relpos_attention(qu, qv, k, v, p, lengths, scale)  # the forward without lse
        out, lse = A.flash_relpos_attention_forward_lse(qu, qv, k, v, p, lengths, scale)
        call = (qu, qv, k, v, p, lengths, scale, lse, A.attention_delta(out, g), g)
        return (plain, out, lse, *A.flash_relpos_attention_bwd_dq(*call), *A.flash_relpos_attention_bwd_dkv(*call),
                A.flash_relpos_attention_bwd_dband(*call))

    whole = run(qu, qv, k, v, p, g, lengths)
    sliced = [x[:, :, heads] for x in (qu, qv, k, v)] + [p[:, heads], g[:, :, heads], lengths]
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        profiler_warmup()
        share = run(*sliced)
        torch.cuda.synchronize()
    names = ("forward", "forward (lse)", "lse", "dqu", "dqv", "dk", "dv", "dp")
    # the whole launch's outputs at those heads: lse is (B, H, T), the table's gradient (2T-1, H, dh)
    pick = lambda name, x: x[:, heads] if name == "lse" or name == "dp" else x[:, :, heads]  # noqa: E731
    equal = {name: torch.equal(s, pick(name, w)) for name, s, w in zip(names, share, whole)}
    rows = [e for e in prof.key_averages() if e.device_type == DeviceType.CUDA and "spin_kernel" not in e.key]
    kernels = sum(e.count for e in rows if "tc_kernel" in e.key or "reduce" in e.key)
    copies = sum(e.count for e in rows if "copy" in e.key.lower() or "elementwise" in e.key.lower())
    print(f"kernels 2 (with and without lse), 5, 6, 7 on heads 2-3 of (4,938,4,64) bf16 and the table's head slice: "
          f"bit-equal to the whole launch's heads: {equal}; under the profiler {sum(e.count for e in rows)} device "
          f"launches, {kernels} of them the attention kernels and their reduce, {copies} copies and elementwise "
          f"kernels (strided head slices made contiguous, the delta)  [{card}]")
    check(all(equal.values()), f"a kernel on a head slice differs from the whole launch: {equal}")


def check_model_parallel(card: str) -> dict:
    """Tensor and sequence parallelism, the vocabulary-sharded beam search and the LM and pretraining trainers over
    processes (`parallel.mesh`, `parallel.sequence`, `ops/decode.py`), Conformer-M at full width, bf16,
    ``use_pallas=True``, `DP_GLOO_BLOCKS` blocks, on the long-form batch (B=4, T'=938, so that the rel-pos
    kernels run in training):

    * (b) one process: `head_slice_kernels`;
    * (c) world size 1 over NCCL with ``seq_parallel=True``: every attention layer falls back with the reason "size
      1", and the step is bit-equal to the same step without a process group;
    * (a) two processes sharing the card over gloo (NCCL refuses two ranks on one GPU), `mp_gloo_worker`, against
      one process run here: the split step (model axis 2: two heads, 512 FFN units a rank) and the
      sequence-parallel step (data axis 2), in float32 to `check_data_parallel`'s bars (`MP_RELPOS_GRAD_BAR` for
      the attention's position terms; the sequence-parallel step's gradients against the data-parallel one's on
      the same ranks, since the data split alone moves every sum) and in bf16 by the loss and the gradient norm
      (see `MP_BF16_LOSS_RTOL`; the bf16 sequence-parallel step against the data-parallel one to `MP_GRAD_REL`);
      the sequence-parallel eval forward bit-equal to the data-parallel one (the same kernels on the same rows and
      heads); the sharded beam's hypotheses equal to the dense search's; the LM's and the pretraining's steps
      data-parallel to `check_data_parallel`'s bars (`param_spread`); the dry run's twin finite, a label a row.

    Returns the launch counts of (c)'s step, a main path of this phase."""
    import torch.distributed as dist

    from nn_conformer_for_speech_recognition_tpu_torch.config import MeshConfig
    from nn_conformer_for_speech_recognition_tpu_torch.parallel import sequence as S
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import BACKEND

    t_phase = time.perf_counter()
    head_slice_kernels(card)

    # -- (c) world size 1 over NCCL with seq_parallel: the fallback, and the same step as without a group
    batch = mp_batch()
    plain = mp_step(mp_trainer(MeshConfig()), batch)
    dist.init_process_group(BACKEND, init_method=f"tcp://127.0.0.1:{free_port()}", rank=0, world_size=1)
    try:
        S.reset_fallback_stats()
        sp1 = mp_trainer(MeshConfig(seq_parallel=True))
        reset_counters()
        one_rank = mp_step(sp1, batch)
        launches = read_counters()
        stats = S.fallback_stats("seq_parallel")
    finally:
        S.set_sequence_mesh(None)
        dist.destroy_process_group()
    same = [k for k in plain["state"] if torch.equal(plain["state"][k], one_rank["state"][k])]
    print(f"seq_parallel at world size 1 over NCCL: the counter {stats}; the step bit-equal to the plain one in "
          f"{len(same)}/{len(plain['state'])} state tensors, loss {one_rank['loss']} / {plain['loss']}; launch counts "
          f"{launches}  [{card}]")
    check(stats == {"engaged": 0, "fallback": DP_GLOO_BLOCKS,
                    "reasons": {"axis 'data' has size 1 (need > 1)": DP_GLOO_BLOCKS}}, f"the fallback counter {stats}")
    check(len(same) == len(plain["state"]) and one_rank["loss"] == plain["loss"],
          "the sequence-parallel step at world size 1 differs from the plain one")

    # -- (a) two processes on the one card over gloo, against one process
    plain32 = mp_step(mp_trainer(MeshConfig(), "float32"), batch)
    ref = mp_lm_and_pretrain()
    with tempfile.TemporaryDirectory() as out_dir:
        port, ctx = free_port(), multiprocessing.get_context("spawn")
        t0 = time.perf_counter()
        procs = [ctx.Process(target=mp_gloo_worker, args=(r, 2, port, out_dir)) for r in range(2)]
        for p in procs:
            p.start()
        for p in procs:
            p.join(timeout=600)
            if p.is_alive():
                p.kill()
                p.join()
        gloo_s = time.perf_counter() - t0
        check(all(p.exitcode == 0 for p in procs), f"the gloo workers exited with {[p.exitcode for p in procs]}")
        ranks = [torch.load(os.path.join(out_dir, f"rank{r}.pt")) for r in range(2)]

    def grad_rel(got: dict, ref: dict) -> list:
        """(L2 distance over the norm, largest difference over the largest entry, name) of each gradient against
        ``ref``'s, the farthest first."""
        return sorted(((float((got[k] - r).norm() / max(float(r.norm()), 1e-30)),
                        float((got[k] - r).abs().max() / max(float(r.abs().max()), 1e-30)), k)
                       for k, r in ref["grads"].items()), reverse=True)

    failed = []  # every comparison is printed before the phase fails on any of them

    def expect(cond: bool, what: str) -> None:
        if not cond:
            failed.append(what)

    what = {"tp": "split over the model axis (2 heads, 512 FFN units a rank)",
            "sp": "sequence-parallel over the data axis (2 rows a rank, 2 heads each in attention)"}
    for name in ("tp", "sp"):
        for dtype, got, base in (("bf16", ranks[0][name], plain), ("float32", ranks[0][name + "32"], plain32)):
            in_sync = all(torch.equal(got["state"][k], ranks[1][name + ("" if dtype == "bf16" else "32")]["state"][k])
                          for k in got["state"])
            loss_rel = abs(got["loss"] - base["loss"]) / abs(base["loss"])
            norm_rel = abs(got["grad_norm"] - base["grad_norm"]) / base["grad_norm"]
            spread = grad_rel(got["grads"], base)
            far = max(b for _, b, _ in spread)
            far_rest = max(b for _, b, k in spread if not k.endswith(MP_RELPOS_LEAVES))
            far_relpos = max(b for _, b, k in spread if k.endswith(MP_RELPOS_LEAVES))
            print(f"two processes over gloo, the {dtype} step {what[name]}: loss {got['loss']:.6f} / one process "
                  f"{base['loss']:.6f} (relative {loss_rel:.2e}), gradient norm {got['grad_norm']:.4f} / "
                  f"{base['grad_norm']:.4f} (relative {norm_rel:.2e}); gradients at most {far:.2e} of their largest "
                  f"entry from one process's ({far_rest:.2e} but the position terms'), the five farthest by L2 over "
                  f"the norm {[(k, round(a, 5), round(b, 5)) for a, b, k in spread[:5]]}; ranks' whole states "
                  f"bit-equal {in_sync}; {got['ms']:.1f} ms for the step (one process {base['ms']:.1f})  [{card}]")
            if dtype == "bf16":
                expect(in_sync and loss_rel <= MP_BF16_LOSS_RTOL and norm_rel <= MP_BF16_NORM_RTOL,
                       f"the bf16 {name} step over two processes differs from one process")
            elif name == "tp":
                expect(in_sync and loss_rel <= 1e-5 and far_rest <= DP_GRAD_BAR and far_relpos <= MP_RELPOS_GRAD_BAR,
                       f"the float32 {name} step over two processes differs from one process")
            else:  # the data split moves every gradient's sums (`check_data_parallel` holds it); Ulysses is held below
                expect(in_sync and loss_rel <= 1e-5, f"the float32 {name} step's loss differs from one process's")
        print(f"rank 0's kernel launches in the bf16 {name} step: {ranks[0][name + '_launches']}")
        for kernel in ("attention_relpos_lse", "attention_relpos_bwd_dq", "attention_relpos_bwd_dkv",
                       "attention_relpos_bwd_dband"):
            expect(ranks[0][name + "_launches"][kernel] == DP_GLOO_BLOCKS, f"{name}: {kernel} launches")
    for dtype, sp, dp in (("bf16", ranks[0]["sp"], ranks[0]["dp"]), ("float32", ranks[0]["sp32"], ranks[0]["dp32"])):
        spread = grad_rel(sp["grads"], dp)
        loss_rel = abs(sp["loss"] - dp["loss"]) / abs(dp["loss"])
        far_rest = max(b for _, b, k in spread if not k.endswith(MP_RELPOS_LEAVES))
        far_relpos = max(b for _, b, k in spread if k.endswith(MP_RELPOS_LEAVES))
        print(f"the {dtype} sequence-parallel step against the data-parallel one on the same two ranks: loss relative "
              f"{loss_rel:.2e}; gradients apart by at most {spread[0][0]:.2e} of their norm, {far_rest:.2e} of their "
              f"largest entry but the position terms' ({far_relpos:.2e}), the five farthest "
              f"{[(k, round(a, 5), round(b, 5)) for a, b, k in spread[:5]]}  [{card}]")
        if dtype == "bf16":
            expect(spread[0][0] <= MP_GRAD_REL and loss_rel <= 1e-5,
                   "the bf16 sequence-parallel step differs from the data-parallel one")
        else:
            expect(far_rest <= DP_GRAD_BAR and far_relpos <= MP_RELPOS_GRAD_BAR and loss_rel <= 1e-5,
                   "the float32 sequence-parallel step differs from the data-parallel one")
    for r in ranks:
        expect(r["sp_stats"] == {"engaged": DP_GLOO_BLOCKS, "fallback": 0, "reasons": {}},
              f"Ulysses did not engage in every layer: {r['sp_stats']}")
        expect(r["sp_forward_equal"], f"the sequence-parallel forward differs from the data-parallel one by "
                                     f"{r['sp_forward_diff']}")
        expect(r["beam"]["equal"] and r["beam"]["score_diff"] <= BEAM_SCORE_ATOL,
              f"the sharded beam differs from the dense one: {r['beam']}")
        expect(np.isfinite(r["dryrun"]["loss"]) and r["dryrun"]["labels"] == 4, f"the dry run: {r['dryrun']}")
    beam = ranks[0]["beam"]
    print(f"the sequence-parallel eval forward bit-equal to the data-parallel one on both ranks; Ulysses engaged in "
          f"{DP_GLOO_BLOCKS} of {DP_GLOO_BLOCKS} layers a forward.  ctc_beam_search_sharded over two ranks (V = 512 a "
          f"rank, {beam['frames']} frames, one all-reduce a frame): hypotheses equal to ctc_beam_search's, scores "
          f"within {beam['score_diff']:.1e}; {beam['sharded_s']:.2f} s against the dense search's "
          f"{beam['dense_s']:.2f} s; best lengths {beam['lengths']}  [{card}]")
    for name, steps_key, state_key in (("LMTrainer", "lm_losses", "lm"), ("PretrainTrainer", "pt_losses", "pt")):
        got = ranks[0]
        off, beyond, total = param_spread(got[state_key], ref[state_key], MP_LR, MP_STEPS)
        loss_ok = np.allclose(got[steps_key], ref[steps_key], rtol=1e-4)
        in_sync = all(torch.equal(got[state_key][k], ranks[1][state_key][k]) for k in got[state_key])
        print(f"{name} data-parallel over two processes, {MP_STEPS} steps: losses {got[steps_key]} / one process "
              f"{ref[steps_key]}; {off} of {total} parameter elements outside the CPU tests' bars, {beyond} farther "
              f"than one step of the other sign a step; ranks bit-equal {in_sync}  [{card}]")
        expect(loss_ok and in_sync and beyond == 0 and off <= 1e-2 * total, f"{name} over two processes")
    print(f"the dry run's twin on two processes: mesh {ranks[0]['dryrun']['mesh']}, loss {ranks[0]['dryrun']['loss']:.4f}, "
          f"{ranks[0]['dryrun']['labels']} labels.  The gloo sub-phase {gloo_s:.1f} s (split step and beams "
          f"{ranks[0]['tp_s']:.1f} s, sequence-parallel {ranks[0]['sp_s']:.1f} s, LM, pretraining and dry run "
          f"{ranks[0]['rest_s']:.1f} s); the phase {time.perf_counter() - t_phase:.1f} s  [{card}]")
    check(not failed, "; ".join(failed))
    return launches


def main() -> None:
    if not torch.cuda.is_available():
        raise SystemExit("chip_smoke: no CUDA device; this script runs only on the GPU")
    sys.path.insert(0, str(REPO))
    from nn_conformer_for_speech_recognition_tpu_torch.config import conformer_l
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
    # the LSTM route past the cluster's shared memory (Conformer-L's H = 640) at both train shapes
    results.update(check_grid_route(card, BATCH, T_SUB))
    long_results.update(check_grid_route(card, LONG_BATCH, LONG_T_SUB))
    # the bf16 rel-pos forward at the shape of Conformer-L's pass: 8 heads of 64
    gen = torch.Generator().manual_seed(SEED + 13)
    results["attention_relpos_conformer_l"] = check_attention_kernel(
        card, BATCH, T_SUB, conformer_l().encoder.num_heads, mixed_lengths(gen, BATCH, T_SUB, T_SUB // 3), gen)
    print("at the long-form shapes, kernel ms against bound ms (and the library call's): " + ", ".join(
        f"{name} {r['ms']:.4f} / {r['bound_ms']:.4f} ({r['bound_by']}" + (
            f"; library {r['library_ms']:.4f})" if r["library_ms"] is not None else ")") for name, r in long_results.items()))
    # and at the Noisy Student phase's two buckets, where a row is shorter than the conv kernel's 64-row tile and
    # the attention kernel's 32-row tile: every block is one partial tile with halo on both sides
    for n_samples, frames in NST_BUCKETS:
        check_kernels(card, NST_BATCH, n_samples / 16000, frames, inference_attention=True)
        check_train_kernels(card, NST_BATCH, frames, NST_MAX_WORDS)
        check_pretrain_lstm(card, NST_BATCH, frames)  # the pretrain command's shapes
    # the pretraining decoder's H = 160 at the pretrain phase's shape; these numbers go into the kernels line
    t_new = time.perf_counter()
    results.update(check_pretrain_lstm(card, BATCH, T_SUB))
    new_phases_s = time.perf_counter() - t_new
    results.update(check_attention_backward_kernels(card))
    results.update(check_depthwise_conv_kernel(card))
    results.update(check_optimizer_kernels(card))
    serve = check_slice(card)
    train = check_train(card, BATCH, SECONDS, TARGET_LEN, long_form=False)
    long_train = check_train(card, LONG_BATCH, LONG_SECONDS, LONG_TARGET_LEN, long_form=True)
    # Conformer-L at full width and depth: the pass and the 30 s step, whose BiLSTM (H = 640) takes the grid kernels
    serve_l = check_slice(card, preset="conformer_l")
    train_l = check_train(card, BATCH, SECONDS, TARGET_LEN, long_form=False, preset="conformer_l")
    # the same pass and the same 30 s step where the depthwise conv is the hand-written kernel, then the NST generation
    serve_conv = check_slice(card, conv_impl="pallas")
    train_conv = check_train(card, BATCH, SECONDS, TARGET_LEN, long_form=False, conv_impl="pallas")
    # the float32 step, kernel path against plain path, once more at the NST phase's longer bucket
    check_train(card, NST_BATCH, NST_LONGEST / 16000, NST_MAX_WORDS, long_form=False, conv_impl="pallas")
    # Conformer-L's 30 s step with its depthwise conv (C = 1024) on the kernels: forward, dx and dw in 17 blocks
    train_l_conv = check_train(card, BATCH, SECONDS, TARGET_LEN, long_form=False, conv_impl="pallas",
                               preset="conformer_l")
    nst = check_nst(card)
    # the bias-input attention (the kernel, then its own op path), beam-search evaluation, the command line
    results.update(check_bias_attention_kernel(card))
    op = check_bias_attention_op(card)
    beam = check_beam(card)
    cli = check_cli(card)
    # F2: the same ten train steps in two fresh processes, bit for bit
    check_repeatability(card)
    # contrastive pretraining, the LM and its fusions, and `pretrain` then `train --encoder-checkpoint` on the command line
    t_new = time.perf_counter()
    pretrain = check_pretrain(card)
    lm = check_lm(card)
    cli_pretrain, cli_handoff = check_cli_pretrain(card)
    new_phases_s += time.perf_counter() - t_new
    print(f"the pretraining and LM phases with the H = 160 kernel check at B=16 × 30 s took {new_phases_s:.1f} s; "
          f"the script so far {time.perf_counter() - t0:.1f} s")
    # device-resident data through train's two sources and the native WAV decode, then the encoder variants
    t_new = time.perf_counter()
    resident = check_resident(card)
    variants = check_encoder_variants(card)
    print(f"the resident and encoder-variant phases took {time.perf_counter() - t_new:.1f} s; the script so far "
          f"{time.perf_counter() - t0:.1f} s")
    # data parallelism over processes: world size 1 over NCCL, two processes on the card over gloo, the trace, the guards
    t_new = time.perf_counter()
    data_parallel = check_data_parallel(card)
    print(f"the data-parallel phase took {time.perf_counter() - t_new:.1f} s; the script so far "
          f"{time.perf_counter() - t0:.1f} s")
    # tensor and sequence parallelism: head-slice kernels, world size 1 over NCCL, two processes on the card over gloo
    t_new = time.perf_counter()
    model_parallel = check_model_parallel(card)
    print(f"the model-parallel phase took {time.perf_counter() - t_new:.1f} s; the script so far "
          f"{time.perf_counter() - t0:.1f} s")
    pallas = "ops/pallas"
    sources = {
        "stft_logmel": ("csrc/stft_logmel.cu", f"{pallas}/stft_logmel.py:74"),
        # bf16, the main path's type: the tensor-core kernels (float32 runs the CUDA-core kernels of
        # csrc/attention_relpos.cu and csrc/attention_relpos_bwd.cu)
        "attention_relpos": ("csrc/attention_relpos_tc.cu", f"{pallas}/attention.py:281"),
        "lstm": ("csrc/lstm.cu", f"{pallas}/lstm.py:69"),
        "lstm_backward": ("csrc/lstm.cu", f"{pallas}/lstm.py:107"),
        "lstm_weight_grad": ("csrc/lstm.cu", f"{pallas}/lstm.py:159"),
        "ctc_alpha": ("csrc/ctc.cu", f"{pallas}/ctc.py:57"),
        "ctc_beta": ("csrc/ctc.cu", f"{pallas}/ctc.py:95"),
        "attention_relpos_lse": ("csrc/attention_relpos_tc.cu", f"{pallas}/attention.py:281"),
        "attention_relpos_bwd_dq": ("csrc/attention_relpos_bwd_tc.cu", f"{pallas}/attention.py:530"),
        "attention_relpos_bwd_dkv": ("csrc/attention_relpos_bwd_tc.cu", f"{pallas}/attention.py:559"),
        "attention_relpos_bwd_dband": ("csrc/attention_relpos_bwd_tc.cu", f"{pallas}/attention.py:590"),
        "depthwise_conv": ("csrc/depthwise_conv.cu", f"{pallas}/depthwise_conv.py:50"),
        # the weight half of the kernel's jnp backward, _dw_bwd
        "depthwise_conv_weight_grad": ("csrc/depthwise_conv.cu", f"{pallas}/depthwise_conv.py:107"),
        "attention_bias": ("csrc/attention_bias.cu", f"{pallas}/attention.py:64"),
        "lstm_grid": ("csrc/lstm_grid.cu", f"{pallas}/lstm.py:69"),
        "lstm_backward_grid": ("csrc/lstm_grid.cu", f"{pallas}/lstm.py:107"),
        "attention_relpos_conformer_l": ("csrc/attention_relpos_tc.cu", f"{pallas}/attention.py:281"),
        "lstm_weight_grad_conformer_l": ("csrc/lstm.cu", f"{pallas}/lstm.py:159"),
        "depthwise_conv_conformer_l": ("csrc/depthwise_conv.cu", f"{pallas}/depthwise_conv.py:50"),
        "depthwise_conv_weight_grad_conformer_l": ("csrc/depthwise_conv.cu", f"{pallas}/depthwise_conv.py:107"),
        "lstm_pretrain": ("csrc/lstm.cu", f"{pallas}/lstm.py:69"),
        "lstm_backward_pretrain": ("csrc/lstm.cu", f"{pallas}/lstm.py:107"),
        "lstm_weight_grad_pretrain": ("csrc/lstm.cu", f"{pallas}/lstm.py:159"),
        # no Pallas kernel: the JAX package's optax calls, which XLA fuses
        "adafactor_step": ("csrc/adafactor.cu", "train/optim.py:31"),
        "global_norm": ("csrc/adafactor.cu", "train/loop.py:279"),
    }
    m_paths = (serve, train, long_train, serve_conv, train_conv, nst, beam, cli, lm, cli_handoff, resident, variants,
               data_parallel, model_parallel)
    l_paths = (serve_l, train_l, train_l_conv)
    p_paths = (pretrain, cli_pretrain)
    paths = (*m_paths, *l_paths, *p_paths, op)
    print("launches, pseudo-label pass + 30 s train steps + long-form train steps, then under conv_impl='pallas' the "
          "pass + the 30 s steps + the NST generation, then beam-search evaluation + the command line + the fused "
          "evaluation + train --encoder-checkpoint + the resident epochs + the encoder variants + the data-parallel "
          "steps + the sequence-parallel step at world size 1, then Conformer-L's pass + 30 s train steps + 30 s "
          "train steps under conv_impl='pallas', then the pretrain steps + the pretrain command, then the bias-input op: "
          f"{ {k: tuple(path.get(k, 0) for path in paths) for k in read_counters()} }")
    # (counter, paths counted) of each entry.  Conformer-L runs four kernels at other shapes than Conformer-M's,
    # the rel-pos forward at 8 heads, dW_hh at H = 640 and the depthwise conv's forward and dw at C = 1024; the
    # pretraining decoder runs the LSTM kernels at H = 160: their launches go under names of their own, beside the
    # numbers measured at those shapes
    counted = {name: (name, paths) for name in sources}
    for name in ("attention_relpos", "lstm_weight_grad", "depthwise_conv", "depthwise_conv_weight_grad"):
        counted[name] = (name, (*m_paths, op))
        counted[f"{name}_conformer_l"] = (name, l_paths)
    for name in ("lstm", "lstm_backward", "lstm_weight_grad"):
        counted[name] = (name, (*m_paths, *l_paths, op))
        counted[f"{name}_pretrain"] = (name, p_paths)

    def launches(name: str, models_only: bool = False) -> int:
        counter, counted_paths = counted[name]
        return sum(path.get(counter, 0) for path in counted_paths if not (models_only and path is op))

    # no model routes through the bias-input attention, here as in the JAX package: its path is its own op.  The
    # Conformer-M paths (H = 320) run the cluster LSTM kernels, Conformer-L's (H = 640) the grid kernels
    check(op["attention_bias"] > 0, "the bias-input attention's own path did not launch it")
    for name, other in (("attention_bias", (*m_paths, *l_paths, *p_paths)), ("lstm_grid", (*m_paths, *p_paths)),
                        ("lstm_backward_grid", (*m_paths, *p_paths)), ("lstm", l_paths), ("lstm_backward", l_paths)):
        check(not any(p.get(name, 0) for p in other), f"a path that should not have launched {name}")
    # pretraining runs the log-mel and the LSTM kernels (H = 160) only: attention and conv on their einsum and conv1d
    # routes as the JAX module builds them, and no CTC
    for p in p_paths:
        check({k for k, v in p.items() if v} == {"stft_logmel", "lstm", "lstm_backward", "lstm_weight_grad"},
              f"a pretraining path launched {p}")
    for name in sources:
        if name != "attention_bias":
            check(launches(name, models_only=True) > 0, f"no model path launched {name}")
    kernels = [
        {
            "name": name,
            "route": "cuda",
            "source": f"nn_conformer_for_speech_recognition_tpu_torch/{src}",
            "replaces": f"nn_conformer_for_speech_recognition_tpu/{tpu}",
            "launches": launches(name),
            **results[name],
        }
        for name, (src, tpu) in sources.items()
    ]
    print(json.dumps({"kernels": kernels}))
    device = {"platform": "gpu", "kind": torch.cuda.get_device_name(0), "count": torch.cuda.device_count()}
    print(json.dumps({"ok": True, "device": device}))


if __name__ == "__main__":
    if sys.argv[1:2] == ["--ctc-times"]:
        ctc_times_main(Path(sys.argv[2]) if len(sys.argv) > 2 else REPO)
    elif sys.argv[1:2] == ["--conv-times"]:
        conv_times_main(Path(sys.argv[2]) if len(sys.argv) > 2 else REPO)
    else:
        main()
