"""Analytic model-FLOPs accounting for MFU, copied from
`nn_conformer_for_speech_recognition_tpu/utils/flops.py`
(``tests/test_torch_train.py`` holds the copy equal to the original), with
the port's E-Branchformer block added.

Counts the matmul/conv FLOPs of one ConformerCTC forward from the configs
alone (a matmul (m,k)x(k,n) = 2·m·k·n FLOPs) and models a train step as 3x
forward, the usual "model FLOPs" convention (rematerialisation is not
credited).  MFU = model FLOPs per step ÷ step time ÷ the card's dense
bf16 peak, looked up by the name ``torch.cuda.get_device_name()`` gives.
"""

from __future__ import annotations

import math

from nn_conformer_for_speech_recognition_tpu_torch.config import ModelConfig

# dense bf16 tensor-core peaks (NVIDIA data sheets, no sparsity), by a
# substring of the device name; the most specific name first
BF16_PEAK_FLOPS = (
    ("H100 PCIe", 756e12),
    ("H100 NVL", 835e12),
    ("H100", 989e12),  # SXM5, e.g. "NVIDIA H100 80GB HBM3"
    ("H200", 989e12),
)


def peak_bf16_flops(device_name: str) -> float:
    """Dense bf16 peak of the card called ``device_name``; raises for a
    card not in the table."""
    for key, peak in BF16_PEAK_FLOPS:
        if key in device_name:
            return peak
    raise ValueError(f"no bf16 peak known for {device_name!r}")


def conformer_forward_flops(
    mcfg: ModelConfig, vocab_size: int, batch: int, frames: int
) -> float:
    """Matmul FLOPs of one ConformerCTC forward: subsampling convs →
    per-frame projection → N conformer (or E-Branchformer) blocks → BiLSTM
    CTC head."""
    sub = mcfg.subsampling
    d = mcfg.encoder.d_model
    total = 0.0

    # subsampling convs: each output element costs 2·k·k·c_in; spatial
    # dims shrink by the strides
    t, f, c_in = frames, mcfg.n_mels, 1
    for ch, k, st, sf in zip(
        sub.channels, sub.kernel_sizes, sub.time_strides, sub.freq_strides
    ):
        t = math.ceil(t / st)
        f = math.ceil(f / sf)
        total += batch * t * f * ch * 2 * k * k * c_in
        c_in = ch
    # flatten (f·c) → d_model per frame
    total += 2 * batch * t * (f * c_in) * d
    t_enc = t

    # conformer blocks
    e = mcfg.encoder
    h, dh = e.num_heads, d // e.num_heads
    ffn = 2 * (2 * batch * t_enc * d * e.ffn_dim) * 2  # two FFNs, two mats each
    qkv = 2 * batch * t_enc * d * 3 * d
    scores = 2 * batch * h * t_enc * t_enc * dh
    att_v = 2 * batch * h * t_enc * t_enc * dh
    # Transformer-XL rel-pos: qp against the (2T-1) table (2x the score
    # matmul) + pos_proj
    relpos = 2 * scores + 2 * (2 * t_enc - 1) * d * d
    out_proj = 2 * batch * t_enc * d * d
    if e.block == "e_branchformer":
        # the cgMLP (d → cgmlp_dim, the gate's depthwise conv over half of it,
        # cgmlp_dim/2 → d) and the merge (depthwise conv over 2d, 2d → d) in
        # place of the conv module
        half = e.cgmlp_dim // 2
        cgmlp = 2 * batch * t_enc * (d * e.cgmlp_dim + half * e.conv_kernel_size + half * d)
        merge = 2 * batch * t_enc * (2 * d * e.merge_conv_kernel + 2 * d * d)
        mixer = cgmlp + merge
    else:
        conv_pw1 = 2 * batch * t_enc * d * (2 * e.conv_expansion * d)
        conv_dw = 2 * batch * t_enc * (e.conv_expansion * d) * e.conv_kernel_size
        conv_pw2 = 2 * batch * t_enc * (e.conv_expansion * d) * d
        mixer = conv_pw1 + conv_dw + conv_pw2
    total += e.num_blocks * (ffn + qkv + scores + att_v + relpos + out_proj + mixer)

    # decoder: projection → BiLSTM → vocab head
    dec = mcfg.decoder
    p, lh = dec.projection_dim, dec.lstm_hidden
    total += 2 * batch * t_enc * d * p
    total += 2 * (2 * batch * t_enc * (p + lh) * 4 * lh)  # 2 directions
    total += 2 * batch * t_enc * (2 * lh) * vocab_size
    return float(total)


def train_step_flops(
    mcfg: ModelConfig, vocab_size: int, batch: int, frames: int
) -> float:
    """Model FLOPs of one train step = 3x forward (fwd + param-grad +
    activation-grad matmuls)."""
    return 3.0 * conformer_forward_flops(mcfg, vocab_size, batch, frames)
