"""The Conformer-CTC model in plain float32 PyTorch (Gulati et al. 2020,
with the repository's CTC head), its parameters named as the port's
``state_dict`` names them, so that one set of weights loads into both:

features (B, T, n_mels) → two stride-2 SAME convs with ReLU → Linear →
dropout → N × [x + ½FFN, x + MHSA(rel-pos), x + Conv, x + ½FFN, LayerNorm,
× mask] → Linear → SiLU → masked BatchNorm → × mask → BiLSTM → dropout →
Linear → log_softmax.

FFN: LN → Linear → SiLU → dropout → Linear → dropout.  MHSA: LN → q, k, v
(no bias); score(i, j) = ((q_i + u)·k_j + (q_i + v)·r_{j-i}) / sqrt(dh)
with r the projected sinusoidal table, softmax over the valid keys,
output projection, dropout.  Conv: LN → pointwise to 2C → GLU → × mask →
depthwise conv (SAME, no bias) → masked BatchNorm → SiLU → pointwise →
dropout.  LayerNorm eps 1e-6, BatchNorm eps 1e-5 over the valid frames
(biased variance; running statistics in eval).

Dropout: each site draws its keep-mask with ``F.dropout`` on a tensor of
ones of the site's shape in ``mask_dtype`` (the configuration's compute
dtype), in the order of the forward, from the global generator, which the
caller seeds; every site with p = 0 draws nothing.  ``rounding`` rounds
the inputs of every product that the configuration computes in its
compute dtype (`ops.Rounding`; identity for the reference).
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.ops import Rounding, lstm_direction, rel_shift, same_padding, sinusoidal_table

LN_EPS, BN_EPS, NEG = 1e-6, 1e-5, -1e30


class Ctx:
    """What every layer of one forward needs."""

    def __init__(self, training: bool, mask_dtype: torch.dtype, rounding: Rounding):
        self.training, self.mask_dtype, self.r = training, mask_dtype, rounding

    def dropout(self, x: torch.Tensor, p: float) -> torch.Tensor:
        if not self.training or p == 0.0:
            return x
        keep = F.dropout(torch.ones(x.shape, dtype=self.mask_dtype, device=x.device), p, True) != 0
        return torch.where(keep, x / (1.0 - p), 0.0)

    def linear(self, lin: nn.Linear, x: torch.Tensor) -> torch.Tensor:
        return F.linear(self.r(x), self.r(lin.weight), lin.bias)


def layer_norm(norm: nn.LayerNorm, x: torch.Tensor) -> torch.Tensor:
    return F.layer_norm(x, norm.normalized_shape, norm.weight, norm.bias, LN_EPS)


class MaskedBatchNorm(nn.Module):
    def __init__(self, c: int):
        super().__init__()
        self.weight = nn.Parameter(torch.ones(c))
        self.bias = nn.Parameter(torch.zeros(c))
        self.register_buffer("running_mean", torch.zeros(c))
        self.register_buffer("running_var", torch.ones(c))

    def forward(self, x: torch.Tensor, mask: torch.Tensor, ctx: Ctx) -> torch.Tensor:
        if ctx.training:
            m = mask[..., None].to(x.dtype)
            count = torch.clamp_min(m.sum(), 1.0)
            mean = (x * m).sum(dim=(0, 1)) / count
            var = (((x - mean) ** 2) * m).sum(dim=(0, 1)) / count
        else:
            mean, var = self.running_mean, self.running_var
        return (x - mean) * torch.rsqrt(var + BN_EPS) * self.weight + self.bias


class FeedForward(nn.Module):
    def __init__(self, d: int, ffn: int, p: float):
        super().__init__()
        self.p = p
        self.norm = nn.LayerNorm(d)
        self.fc1 = nn.Linear(d, ffn)
        self.fc2 = nn.Linear(ffn, d)

    def forward(self, x, ctx: Ctx):
        h = ctx.dropout(F.silu(ctx.linear(self.fc1, layer_norm(self.norm, x))), self.p)
        return ctx.dropout(ctx.linear(self.fc2, h), self.p)


class RelPositionMHSA(nn.Module):
    def __init__(self, d: int, heads: int, p: float):
        super().__init__()
        self.d, self.heads, self.p = d, heads, p
        self.norm = nn.LayerNorm(d)
        self.qkv = nn.Linear(d, 3 * d, bias=False)
        self.pos_proj = nn.Linear(d, d, bias=False)
        self.out_proj = nn.Linear(d, d)
        self.u_bias = nn.Parameter(torch.zeros(heads, d // heads))
        self.v_bias = nn.Parameter(torch.zeros(heads, d // heads))

    def forward(self, x, lengths, rel, ctx: Ctx):
        b, t, _ = x.shape
        h, dh = self.heads, self.d // self.heads
        q, k, v = ctx.linear(self.qkv, layer_norm(self.norm, x)).reshape(b, t, 3, h, dh).unbind(dim=2)
        p = ctx.linear(self.pos_proj, rel).reshape(2 * t - 1, h, dh)
        r = ctx.r
        ac = torch.einsum("bihd,bjhd->bhij", r(q + self.u_bias), r(k))
        bd = rel_shift(torch.einsum("bihd,lhd->bhil", r(q + self.v_bias), r(p)))
        scores = (ac + bd) / float(np.sqrt(dh))
        valid = (torch.arange(t, device=x.device)[None, :] < lengths[:, None])[:, None, None, :]
        attn = ctx.dropout(torch.softmax(scores.masked_fill(~valid, NEG), dim=-1), self.p)
        out = torch.einsum("bhij,bjhd->bihd", r(attn), r(v)).reshape(b, t, h * dh)
        return ctx.dropout(ctx.linear(self.out_proj, out), self.p)


class ConvModule(nn.Module):
    def __init__(self, d: int, kernel: int, expansion: int, p: float):
        super().__init__()
        c = expansion * d
        self.kernel, self.p = kernel, p
        self.norm = nn.LayerNorm(d)
        self.pointwise_in = nn.Linear(d, 2 * c)
        self.depthwise = nn.Conv1d(c, c, kernel, groups=c, bias=False)
        self.batch_norm = MaskedBatchNorm(c)
        self.pointwise_out = nn.Linear(c, d)

    def forward(self, x, mask, ctx: Ctx):
        a, g = ctx.linear(self.pointwise_in, layer_norm(self.norm, x)).chunk(2, dim=-1)
        h = a * torch.sigmoid(g) * mask[..., None].to(x.dtype)
        h = F.pad(h.transpose(1, 2), same_padding(h.shape[1], self.kernel, 1))
        h = F.conv1d(ctx.r(h), ctx.r(self.depthwise.weight), groups=h.shape[1]).transpose(1, 2)
        h = F.silu(self.batch_norm(h, mask, ctx))
        return ctx.dropout(ctx.linear(self.pointwise_out, h), self.p)


class ConformerBlock(nn.Module):
    def __init__(self, enc: dict):
        super().__init__()
        d, p = enc["d_model"], enc["dropout"]
        self.ffn1 = FeedForward(d, enc["ffn_dim"], p)
        self.mhsa = RelPositionMHSA(d, enc["num_heads"], enc["attention_dropout"])
        self.conv = ConvModule(d, enc["conv_kernel_size"], enc["conv_expansion"], p)
        self.ffn2 = FeedForward(d, enc["ffn_dim"], p)
        self.norm = nn.LayerNorm(d)

    def forward(self, x, mask, lengths, rel, ctx: Ctx):
        x = x + 0.5 * self.ffn1(x, ctx)
        x = x + self.mhsa(x, lengths, rel, ctx)
        x = x + self.conv(x, mask, ctx)
        x = x + 0.5 * self.ffn2(x, ctx)
        return layer_norm(self.norm, x) * mask[..., None].to(x.dtype)


class Subsampling(nn.Module):
    def __init__(self, sub: dict, d: int, n_mels: int):
        super().__init__()
        self.sub = sub
        convs, c_in, f = [], 1, n_mels
        for ch, k, sf in zip(sub["channels"], sub["kernel_sizes"], sub["freq_strides"]):
            convs.append(nn.Conv2d(c_in, ch, k))
            c_in, f = ch, -(-f // sf)
        self.convs = nn.ModuleList(convs)
        self.out = nn.Linear(f * c_in, d)

    def forward(self, x, ctx: Ctx):
        h = x[:, None]
        for conv, k, st, sf in zip(self.convs, self.sub["kernel_sizes"], self.sub["time_strides"],
                                   self.sub["freq_strides"]):
            h = F.pad(h, (*same_padding(h.shape[3], k, sf), *same_padding(h.shape[2], k, st)))
            h = F.relu(F.conv2d(ctx.r(h), ctx.r(conv.weight), conv.bias, stride=(st, sf)))
        b, c, t, f = h.shape
        return ctx.linear(self.out, h.permute(0, 2, 3, 1).reshape(b, t, f * c))


class BiLSTM(nn.Module):
    def __init__(self, d_in: int, hidden: int):
        super().__init__()
        for name in ("fwd", "bwd"):
            self.register_parameter(f"lstm_{name}_0_w_ih", nn.Parameter(torch.empty(d_in, 4 * hidden)))
            self.register_parameter(f"lstm_{name}_0_w_hh", nn.Parameter(torch.empty(hidden, 4 * hidden)))
            self.register_parameter(f"lstm_{name}_0_bias", nn.Parameter(torch.zeros(4 * hidden)))

    def forward(self, x, lengths, ctx: Ctx):
        outs = []
        for name, reverse in (("fwd", False), ("bwd", True)):
            xw = ctx.r(x) @ ctx.r(getattr(self, f"lstm_{name}_0_w_ih")) + getattr(self, f"lstm_{name}_0_bias")
            outs.append(lstm_direction(xw, getattr(self, f"lstm_{name}_0_w_hh"), lengths, reverse))
        return torch.cat(outs, dim=-1)


class ConformerCTC(nn.Module):
    """``model`` is a configuration file's ``model`` object."""

    def __init__(self, model: dict, vocab_size: int):
        super().__init__()
        self.cfg = model
        enc, dec = model["encoder"], model["decoder"]
        if (dec["lstm_layers"], dec["bidirectional"], enc["conv_norm"], enc["use_relative_attention"],
                enc["ffn_expansion_in_block"], enc["attention_dropout"]) != (1, True, "batchnorm", True, True, 0.0):
            raise ValueError("the reference holds one bidirectional LSTM layer, the conv module's masked "
                             "BatchNorm, relative positions, ffn_dim as the FFN's hidden size and no "
                             "attention dropout")
        self.subsampling = Subsampling(model["subsampling"], enc["d_model"], model["n_mels"])
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(ConformerBlock(enc) for _ in range(enc["num_blocks"]))
        self.projection = nn.Linear(enc["d_model"], dec["projection_dim"])
        self.projection_norm = MaskedBatchNorm(dec["projection_dim"])
        self.decoder_lstm = BiLSTM(dec["projection_dim"], dec["lstm_hidden"])
        self.final_fc = nn.Linear(2 * dec["lstm_hidden"], vocab_size)

    def forward(self, feats: torch.Tensor, frame_lengths: torch.Tensor, ctx: Ctx,
                remat: Optional[bool] = None):
        """(B, T, n_mels) features → (B, T', V) float32 log-probs and (B,)
        lengths.  ``remat`` (default: while autograd records) recomputes the
        subsampling and each block in the backward pass, with the same
        dropout masks, to hold a large batch."""
        remat = torch.is_grad_enabled() if remat is None else remat

        def run(fn, *args):
            return checkpoint(fn, *args, use_reentrant=False) if remat else fn(*args)

        lengths = frame_lengths
        for s in self.cfg["subsampling"]["time_strides"]:
            lengths = -(-lengths // s)
        h = run(lambda f: self.subsampling(f, ctx), feats)
        h = ctx.dropout(h, self.cfg["encoder"]["dropout"])
        t = h.shape[1]
        mask = torch.arange(t, device=h.device)[None, :] < lengths[:, None]
        rel = torch.from_numpy(sinusoidal_table(t, self.cfg["encoder"]["d_model"])).to(h.device)
        for block in self.encoder.blocks:
            h = run(lambda x, blk=block: blk(x, mask, lengths, rel, ctx), h)
        h = self.projection_norm(F.silu(ctx.linear(self.projection, h)), mask, ctx) * mask[..., None].to(h.dtype)
        h = ctx.dropout(self.decoder_lstm(h, lengths, ctx), self.cfg["decoder"]["dropout"])
        return torch.log_softmax(F.linear(h, self.final_fc.weight, self.final_fc.bias), dim=-1), lengths
