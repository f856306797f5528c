"""The benchmark's own yardstick, frozen here so that a change to the program
cannot move it: the card's peaks, the model-FLOPs count behind MFU, the
kernel groups of a profiler trace and the least time each group of
hand-written kernels could take.

* ``conformer_forward_flops`` / ``train_step_flops``: a copy of the port's
  ``utils/flops.py`` (matmul and conv FLOPs from the configuration alone; a
  train step is 3 forwards).
* ``GROUPS`` / ``group_of``: a copy of ``utils/profile_step.GROUPS``.
* ``bound_s``: the larger of the bytes over the memory rate and the
  operations over the peak of their type, as ``chip_smoke.numbers`` counts
  a kernel's bound; the per-group counts follow ``chip_smoke.py``'s and
  ``PERF.md``'s "Bound ms" definitions, with the rows' real lengths in
  place of the padded maximum (what these inputs need).
"""

from __future__ import annotations

import math
from typing import Dict, Sequence

import numpy as np

HBM_BYTES_PER_S = 3.35e12
PEAK_FLOPS = {"bf16": 989e12, "tf32": 495e12, "fp32": 67e12}
# dense bf16 tensor-core peaks by a substring of the device name, the most specific first
BF16_PEAK_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),
    ("H200", 989e12),
)


def peak_bf16_flops(device_name: str) -> float:
    for key, peak in BF16_PEAK_FLOPS:
        if key in device_name:
            return peak
    raise ValueError(f"no bf16 peak known for {device_name!r}")


def conformer_forward_flops(model: dict, vocab_size: int, batch: int, frames: int) -> float:
    """Matmul FLOPs of one Conformer-CTC forward at ``frames`` feature frames
    a row; ``model`` is a configuration file's ``model`` object."""
    sub, enc, dec = model["subsampling"], model["encoder"], model["decoder"]
    d = enc["d_model"]
    total = 0.0
    t, f, c_in = frames, model["n_mels"], 1
    for ch, k, st, sf in zip(sub["channels"], sub["kernel_sizes"], sub["time_strides"], sub["freq_strides"]):
        t = math.ceil(t / st)
        f = math.ceil(f / sf)
        total += batch * t * f * ch * 2 * k * k * c_in
        c_in = ch
    total += 2 * batch * t * (f * c_in) * d
    t_enc = t
    h, dh = enc["num_heads"], d // enc["num_heads"]
    ffn = 2 * (2 * batch * t_enc * d * enc["ffn_dim"]) * 2
    qkv = 2 * batch * t_enc * d * 3 * d
    scores = 2 * batch * h * t_enc * t_enc * dh
    att_v = 2 * batch * h * t_enc * t_enc * dh
    relpos = 2 * scores + 2 * (2 * t_enc - 1) * d * d
    out_proj = 2 * batch * t_enc * d * d
    conv_pw1 = 2 * batch * t_enc * d * (2 * enc["conv_expansion"] * d)
    conv_dw = 2 * batch * t_enc * (enc["conv_expansion"] * d) * enc["conv_kernel_size"]
    conv_pw2 = 2 * batch * t_enc * (enc["conv_expansion"] * d) * d
    total += enc["num_blocks"] * (ffn + qkv + scores + att_v + relpos + out_proj + conv_pw1 + conv_dw + conv_pw2)
    p, lh = dec["projection_dim"], dec["lstm_hidden"]
    total += 2 * batch * t_enc * d * p
    total += 2 * (2 * batch * t_enc * (p + lh) * 4 * lh)
    total += 2 * batch * t_enc * (2 * lh) * vocab_size
    return float(total)


def train_step_flops(model: dict, vocab_size: int, batch: int, frames: int) -> float:
    return 3.0 * conformer_forward_flops(model, vocab_size, batch, frames)


REST = "elementwise, reductions, copies"
GROUPS = (
    ("attention forward + lse", ("attention_relpos_kernel", "attention_relpos_tc_kernel")),
    ("attention bwd dq", ("bwd_dq_kernel", "bwd_dq_tc_kernel")),
    ("attention bwd dkv", ("bwd_dkv_kernel", "bwd_dkv_tc_kernel")),
    ("attention bwd dband (+ reduce)", ("bwd_dband_kernel", "bwd_dband_tc_kernel", "dband_reduce_kernel")),
    ("lstm_fwd", ("lstm_fwd_",)),
    ("lstm_bwd", ("lstm_bwd_",)),
    ("lstm_dwhh (+ reduce)", ("lstm_dwhh_kernel", "lstm_dwhh_reduce_kernel")),
    ("ctc alpha + beta", ("ctc_alpha_kernel", "ctc_beta_kernel")),
    ("stft_logmel", ("stft_logmel_tc_kernel",)),
    ("depthwise_conv", ("depthwise_conv_kernel",)),
    ("depthwise_conv dw (+ reduce)", ("depthwise_dw_kernel", "depthwise_dw_reduce_kernel")),
    ("convolutions (cuDNN)", ("conv", "cudnn", "wgrad", "dgrad")),
    ("GEMMs (cuBLAS)", ("gemm", "cutlass", "cublas", "xmma", "nvjet")),
)


def group_of(kernel_name: str) -> str:
    key = kernel_name.lower()
    return next((group for group, words in GROUPS if any(w in key for w in words)), REST)


# the roofline groups of the benchmark's metrics → the `GROUPS` they sum
ROOFLINE_GROUPS = {
    "stft_logmel": ("stft_logmel",),
    "lstm": ("lstm_fwd", "lstm_bwd"),
    "lstm_dwhh": ("lstm_dwhh (+ reduce)",),
    "ctc": ("ctc alpha + beta",),
    "attention": ("attention forward + lse", "attention bwd dq", "attention bwd dkv",
                  "attention bwd dband (+ reduce)"),
}


def bound_s(moved_bytes: float, flops: float, kind: str) -> float:
    """The least time: the larger of ``moved_bytes`` at the memory rate and
    ``flops`` at the peak of ``kind`` ('bf16', 'tf32', 'fp32')."""
    return max(moved_bytes / HBM_BYTES_PER_S, flops / PEAK_FLOPS[kind])


def _frames(samples: np.ndarray, feat: dict) -> np.ndarray:
    return samples // feat["hop_length"] + 1


def _subsampled(frames: np.ndarray, model: dict) -> np.ndarray:
    t = np.asarray(frames, np.int64)
    for s in model["subsampling"]["time_strides"]:
        t = -(-t // s)
    return t


def step_bounds(cfg: dict, samples: Sequence[int], targets: Sequence[int], training: bool) -> Dict[str, float]:
    """{roofline group: least seconds} of one step (``training``) or one
    pseudo-label batch over rows of ``samples`` audio samples and
    ``targets`` target tokens (training only).  Inputs read once, outputs
    written once; float32 is 4 bytes, bf16 2."""
    model, feat = cfg["model"], cfg["features"]
    samples = np.asarray(samples, np.int64)
    frames = _frames(samples, feat)
    t = _subsampled(frames, model)
    n_fft, n_mels = feat["n_fft"], feat["n_mels"]
    out = {}
    # log-mel: the audio read, the features written, the window and the filterbank; a frame's real FFT,
    # 2.5·n·log2(n), and the mel product over the filterbank's nonzeros (~2 a bin), at float32
    n_bins = n_fft // 2 + 1
    mel_nonzeros = 2 * n_bins
    stft_bytes = 4 * (samples.sum() + frames.sum() * n_mels + n_fft + n_bins * n_mels)
    stft_ops = frames.sum() * (2.5 * n_fft * math.log2(n_fft) + 2 * mel_nonzeros)
    out["stft_logmel"] = bound_s(stft_bytes, stft_ops, "fp32")
    # the recurrences, both directions: per valid step h·W_hh, 2·H·4H operations; forward reads xw and
    # W_hh and writes h (training: also c and the gates); backward reads dh, gates, c, W_hh, writes dxw
    h = model["decoder"]["lstm_hidden"]
    valid = int(t.sum())
    steps = 2 * valid
    fwd_bytes = 4 * (2 * valid * 4 * h + 2 * h * 4 * h + 2 * valid * h)
    if training:
        fwd_bytes += 4 * (2 * valid * 4 * h + 2 * valid * h)
        bwd_bytes = 4 * (2 * valid * h + 2 * valid * 4 * h + 2 * valid * h + 2 * h * 4 * h + 2 * valid * 4 * h)
        out["lstm"] = bound_s(fwd_bytes, 8 * h * h * steps, "fp32") + bound_s(bwd_bytes, 8 * h * h * steps, "fp32")
        # dW_hh a direction: h and dxw read, dW_hh written; 2·H·4H a valid row-step, three times (3×TF32)
        out["lstm_dwhh"] = 2 * bound_s(4 * (valid * h + valid * 4 * h + h * 4 * h), 3 * 8 * h * h * valid, "tf32")
        # CTC alpha and beta over each row's T' × (2L + 1) cells, ~10 operations a cell; alpha reads emit,
        # writes alpha; beta reads emit and alpha, writes the emit gradient
        cells = float((t * (2 * np.asarray(targets, np.int64) + 1)).sum())
        out["ctc"] = bound_s(4 * 2 * cells, 10 * cells, "fp32") + bound_s(4 * 3 * cells, 10 * cells, "fp32")
    else:
        out["lstm"] = bound_s(fwd_bytes, 8 * h * h * steps, "fp32")
    # rel-pos attention in bf16, per block: x = one (B, T', H, dh) tensor of valid rows, the (2T'-1, H, dh)
    # table, lse (B, H, T') float32; operations per (valid query, valid key) pair and head:
    # 6·dh forward, 10·dh dq, 10·dh dkv, 8·dh dband
    enc = model["encoder"]
    heads, dh = enc["num_heads"], enc["d_model"] // enc["num_heads"]
    x = 2 * valid * heads * dh
    table = 2 * (2 * int(t.max(initial=1)) - 1) * heads * dh
    stat = 4 * valid * heads
    pairs = float((t * t).sum())
    per = heads * dh * pairs
    if training:
        work = [(5 * x + table + stat, 6), (7 * x + table + 2 * stat, 10), (7 * x + table + 2 * stat, 10),
                (5 * x + 2 * table + 2 * stat, 8)]
    else:
        work = [(5 * x + table, 6)]
    out["attention"] = enc["num_blocks"] * sum(bound_s(b, u * per, "bf16") for b, u in work)
    return out
