"""Conformer encoder blocks, port of
`nn_conformer_for_speech_recognition_tpu/models/conformer.py`.

Macaron block: ½FFN → MHSA(rel-pos) → ConvModule → ½FFN → LayerNorm, with
mask-based length handling.  Parameters are float32; each layer computes in
the dtype of its input (bfloat16 on CUDA, float32 on the CPU, see
`config.resolve_compute_dtype`).  With ``use_kernel`` the attention goes
through the rel-pos flash kernel wrapper (`ops/cuda/attention.py`), which
launches the kernel for CUDA tensors at every sequence length.
"""

from __future__ import annotations

import functools

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nn_conformer_for_speech_recognition_tpu_torch.config import ConformerConfig
from nn_conformer_for_speech_recognition_tpu_torch.models.layers import (
    LayerNorm,
    Linear,
    same_padding,
)
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.attention import (
    flash_relpos_attention,
    flash_relpos_attention_plain,
)


def length_mask(lengths: torch.Tensor, t: int) -> torch.Tensor:
    """(B,) lengths → (B, T) bool validity mask."""
    return torch.arange(t, device=lengths.device)[None, :] < lengths[:, None]


@functools.lru_cache(maxsize=8)
def sinusoidal_rel_positions(t: int, d_model: int) -> np.ndarray:
    """Sinusoidal embeddings for relative distances j-i ∈ [-(T-1), T-1];
    row l encodes distance l - (T-1).  Copy of the JAX package's."""
    dist = np.arange(-(t - 1), t, dtype=np.float32)  # (2T-1,)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, d_model, 2, dtype=np.float32) / d_model))
    ang = dist[:, None] * inv_freq[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (batch, time) with padded frames excluded from the
    statistics; eval mode normalises with the running statistics."""

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask[..., None].to(x.dtype)
            denom = torch.clamp_min(m.sum(), 1.0)
            mean = (x * m).sum(dim=(0, 1)) / denom
            var = (((x - mean) ** 2) * m).sum(dim=(0, 1)) / denom
            with torch.no_grad():
                mom = self.momentum
                self.running_mean.mul_(mom).add_((1 - mom) * mean.float())
                self.running_var.mul_(mom).add_((1 - mom) * var.float())
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + self.eps)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


class FeedForwardModule(nn.Module):
    """LN → Linear(ffn_dim) → SiLU → dropout → Linear(d_model) → dropout."""

    def __init__(self, d_model: int, ffn_dim: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.norm = LayerNorm(d_model)
        self.fc1 = Linear(d_model, ffn_dim)
        self.fc2 = Linear(ffn_dim, d_model)

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        h = F.dropout(F.silu(self.fc1(self.norm(x))), self.dropout, self.training)
        return F.dropout(self.fc2(h), self.dropout, self.training)


class RelPositionMHSA(nn.Module):
    """Multi-head self-attention with Transformer-XL relative position bias:
    score(i,j) = (q_i + u)·k_j + (q_i + v)·r_{j-i}, softmax over valid keys."""

    def __init__(self, d_model: int, num_heads: int, dropout: float, use_kernel: bool):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must divide into num_heads")
        self.d_model, self.num_heads, self.dropout = d_model, num_heads, dropout
        self.attention = flash_relpos_attention if use_kernel else flash_relpos_attention_plain
        dh = d_model // num_heads
        self.norm = LayerNorm(d_model)
        self.qkv = Linear(d_model, 3 * d_model, bias=False)
        self.pos_proj = Linear(d_model, d_model, bias=False)
        self.out_proj = Linear(d_model, d_model)
        self.u_bias = nn.Parameter(torch.zeros(num_heads, dh))
        self.v_bias = nn.Parameter(torch.zeros(num_heads, dh))

    def forward(
        self, x: torch.Tensor, lengths: torch.Tensor, rel: torch.Tensor
    ) -> torch.Tensor:
        """``rel``: (2T-1, d_model) sinusoidal table in x's dtype.  As on the
        JAX package's flash path, dropout applies to the output only."""
        b, t, _ = x.shape
        h, dh = self.num_heads, self.d_model // self.num_heads
        q, k, v = self.qkv(self.norm(x)).reshape(b, t, 3, h, dh).unbind(dim=2)
        p = self.pos_proj(rel).reshape(2 * t - 1, h, dh)
        out = self.attention(
            q + self.u_bias.to(x.dtype), q + self.v_bias.to(x.dtype), k, v, p,
            lengths, 1.0 / float(np.sqrt(dh)),
        )
        out = self.out_proj(out.reshape(b, t, self.d_model))
        return F.dropout(out, self.dropout, self.training)


class ConvModule(nn.Module):
    """LN → pointwise (2× expansion) → GLU → depthwise conv → masked BN →
    SiLU → pointwise → dropout.  The depthwise conv is a grouped conv1d
    without bias (BatchNorm follows), as the JAX package's XLA path."""

    def __init__(self, d_model: int, kernel_size: int, expansion: int, dropout: float):
        super().__init__()
        channels = expansion * d_model
        self.kernel_size, self.dropout = kernel_size, dropout
        self.norm = LayerNorm(d_model)
        self.pointwise_in = Linear(d_model, 2 * channels)
        self.depthwise = nn.Conv1d(channels, channels, kernel_size, groups=channels, bias=False)
        self.batch_norm = MaskedBatchNorm(channels)
        self.pointwise_out = Linear(channels, d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        a, g = self.pointwise_in(self.norm(x)).chunk(2, dim=-1)
        h = a * torch.sigmoid(g)  # GLU
        # zero padded frames so the depthwise window never reads garbage
        h = h * mask[..., None].to(h.dtype)
        h = F.pad(h.transpose(1, 2), same_padding(h.shape[1], self.kernel_size, 1))
        h = F.conv1d(h, self.depthwise.weight.to(h.dtype), groups=h.shape[1]).transpose(1, 2)
        h = F.silu(self.batch_norm(h, mask))
        return F.dropout(self.pointwise_out(h), self.dropout, self.training)


class ConformerBlock(nn.Module):
    def __init__(self, config: ConformerConfig, use_kernel: bool):
        super().__init__()
        if not config.use_relative_attention:
            raise NotImplementedError("only relative-position attention is ported")
        if config.conv_norm != "batchnorm":
            raise NotImplementedError(f"conv_norm={config.conv_norm!r} is not ported")
        self.ffn1 = FeedForwardModule(config.d_model, config.ffn_dim, config.dropout)
        self.mhsa = RelPositionMHSA(
            config.d_model, config.num_heads, config.attention_dropout, use_kernel
        )
        self.conv = ConvModule(
            config.d_model, config.conv_kernel_size, config.conv_expansion, config.dropout
        )
        self.ffn2 = FeedForwardModule(config.d_model, config.ffn_dim, config.dropout)
        self.norm = LayerNorm(config.d_model)

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor, lengths: torch.Tensor, rel: torch.Tensor
    ) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x)
        x = x + self.mhsa(x, lengths, rel)
        x = x + self.conv(x, mask)
        x = x + 0.5 * self.ffn2(x)
        return self.norm(x) * mask[..., None].to(x.dtype)


class ConformerEncoder(nn.Module):
    """Stack of Conformer blocks; (B, T, d_model) + lengths → (B, T, d_model)."""

    def __init__(self, config: ConformerConfig, use_kernel: bool):
        super().__init__()
        self.d_model = config.d_model
        self.blocks = nn.ModuleList(
            ConformerBlock(config, use_kernel) for _ in range(config.num_blocks)
        )

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        t = x.shape[1]
        mask = length_mask(lengths, t)
        rel = torch.from_numpy(sinusoidal_rel_positions(t, self.d_model)).to(x.device, x.dtype)
        for block in self.blocks:
            x = block(x, mask, lengths, rel)
        return x
