"""The E-Branchformer-CTC model in plain float32 PyTorch (Kim et al. 2022,
"E-Branchformer: Branchformer with Enhanced Merging for Speech
Recognition", arXiv:2210.00077, with the repository's CTC head), its
parameters named as the port's ``state_dict`` names them under
``conv_impl`` 'auto', so that one set of weights loads into both:

features (B, T, n_mels) → two stride-2 SAME convs with ReLU → Linear →
dropout → N × block → LayerNorm → × mask → Linear → SiLU → masked
BatchNorm → × mask → BiLSTM → dropout → Linear → log_softmax.

A block, on x with ``mask`` its valid frames:

    x  = x + ½·FFN_a(x)
    x1 = MHSA(x)                                  (rel-pos, as `model.RelPositionMHSA`)
    u  = GELU(Linear_{d→c}(LN(x)));  r, g = the halves of u
    g  = depthwise_K(LN(g) · mask) + bias         (SAME)
    x2 = dropout(Linear_{c/2→d}(dropout(r · g)))
    m  = [x1, x2];  m = m + depthwise_Km(m · mask) + bias
    x  = x + dropout(Linear_{2d→d}(m))
    x  = x + ½·FFN_b(x)
    x  = LN(x) · mask

with c = ``cgmlp_dim``, K = ``conv_kernel_size``, Km = ``merge_conv_kernel``;
GELU exact (erf); LayerNorm eps 1e-6.

Departures from the paper and ESPnet's recipe
(``egs2/librispeech/asr1/conf/tuning/train_asr_e_branchformer.yaml``),
which the configuration file lists under ``assumed``: the CTC head above
in place of a CTC linear and a 6-layer attention decoder; SAME padding in
the front end, where ESPnet's Conv2dSubsampling pads nothing; padded frames
zeroed before both depthwise convs, where ESPnet's gate conv sees them;
no stochastic depth; the relative attention of `model.RelPositionMHSA`
(Transformer-XL's score ((q + u)·k + (q + v)·r) / sqrt(dh) over the
sinusoids of distances -(T-1) .. T-1), where ESPnet's ``rel_pos latest``
adds a learned bias to its rel-shifted position term the same way.

Dropout is drawn in the program's order from the global generator, which
the caller seeds, as `model` draws it: each site's keep-mask is
``F.dropout`` of ones in ``mask_dtype``; the attention probabilities' mask
is ``torch.rand(B, H, T, T) >= p`` (float32 uniforms), as the program's
einsum attention draws it.  The attention's output dropout takes
``attention_dropout``, the program's convention, as in `model`.
"""

from __future__ import annotations

from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from benchmark.reference.model import (
    NEG,
    BiLSTM,
    Ctx,
    FeedForward,
    MaskedBatchNorm,
    RelPositionMHSA,
    Subsampling,
    layer_norm,
)
from benchmark.reference.ops import rel_shift, same_padding, sinusoidal_table


def depthwise(conv: nn.Conv1d, x: torch.Tensor, ctx: Ctx) -> torch.Tensor:
    """SAME depthwise conv with its bias over (B, T, C) ``x``."""
    k = conv.kernel_size[0]
    h = F.pad(x.transpose(1, 2), same_padding(x.shape[1], k, 1))
    return F.conv1d(ctx.r(h), ctx.r(conv.weight), conv.bias, groups=h.shape[1]).transpose(1, 2)


class RelPositionMHSADropped(RelPositionMHSA):
    """`model.RelPositionMHSA` whose probabilities are dropped by the
    program's float32 uniform draw."""

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
        attn = torch.softmax(scores.masked_fill(~valid, NEG), dim=-1)
        if ctx.training and self.p > 0.0:
            keep = torch.rand(attn.shape, device=attn.device) >= self.p
            attn = torch.where(keep, attn / (1.0 - self.p), 0.0)
        out = torch.einsum("bhij,bjhd->bihd", r(attn), r(v)).reshape(b, t, h * dh)
        return ctx.dropout(ctx.linear(self.out_proj, out), self.p)


class ConvolutionalGatingMLP(nn.Module):
    def __init__(self, d: int, c: int, kernel: int, p: float):
        super().__init__()
        self.p = p
        self.norm = nn.LayerNorm(d)
        self.channel_proj1 = nn.Linear(d, c)
        self.gate_norm = nn.LayerNorm(c // 2)
        self.depthwise = nn.Conv1d(c // 2, c // 2, kernel, groups=c // 2)
        self.channel_proj2 = nn.Linear(c // 2, d)

    def forward(self, x, mask, ctx: Ctx):
        r, g = F.gelu(ctx.linear(self.channel_proj1, layer_norm(self.norm, x))).chunk(2, dim=-1)
        g = depthwise(self.depthwise, layer_norm(self.gate_norm, g) * mask[..., None].to(g.dtype), ctx)
        return ctx.dropout(ctx.linear(self.channel_proj2, ctx.dropout(r * g, self.p)), self.p)


class MergeModule(nn.Module):
    def __init__(self, d: int, kernel: int, p: float):
        super().__init__()
        self.p = p
        self.depthwise = nn.Conv1d(2 * d, 2 * d, kernel, groups=2 * d)
        self.proj = nn.Linear(2 * d, d)

    def forward(self, x1, x2, mask, ctx: Ctx):
        c = torch.cat([x1, x2], dim=-1)
        c = c + depthwise(self.depthwise, c * mask[..., None].to(c.dtype), ctx)
        return ctx.dropout(ctx.linear(self.proj, c), self.p)


class EBranchformerBlock(nn.Module):
    def __init__(self, enc: dict):
        super().__init__()
        d, p = enc["d_model"], enc["dropout"]
        self.ffn1 = FeedForward(d, enc["ffn_dim"], p)
        self.mhsa = RelPositionMHSADropped(d, enc["num_heads"], enc["attention_dropout"])
        self.cgmlp = ConvolutionalGatingMLP(d, enc["cgmlp_dim"], enc["conv_kernel_size"], p)
        self.merge = MergeModule(d, enc["merge_conv_kernel"], p)
        self.ffn2 = FeedForward(d, enc["ffn_dim"], p)
        self.norm = nn.LayerNorm(d)

    def forward(self, x, mask, lengths, rel, ctx: Ctx):
        x = x + 0.5 * self.ffn1(x, ctx)
        x1 = self.mhsa(x, lengths, rel, ctx)
        x2 = self.cgmlp(x, mask, ctx)
        x = x + self.merge(x1, x2, mask, ctx)
        x = x + 0.5 * self.ffn2(x, ctx)
        return layer_norm(self.norm, x) * mask[..., None].to(x.dtype)


class EBranchformerCTC(nn.Module):
    """``model`` is a configuration file's ``model`` object."""

    def __init__(self, model: dict, vocab_size: int):
        super().__init__()
        self.cfg = model
        enc, dec = model["encoder"], model["decoder"]
        if (enc.get("block"), dec["lstm_layers"], dec["bidirectional"], enc["use_relative_attention"],
                enc["ffn_expansion_in_block"]) != ("e_branchformer", 1, True, True, True):
            raise ValueError("the reference holds E-Branchformer blocks with relative positions and ffn_dim as "
                             "the FFN's hidden size, and one bidirectional LSTM layer")
        self.subsampling = Subsampling(model["subsampling"], enc["d_model"], model["n_mels"])
        self.encoder = nn.Module()
        self.encoder.blocks = nn.ModuleList(EBranchformerBlock(enc) for _ in range(enc["num_blocks"]))
        self.encoder.after_norm = nn.LayerNorm(enc["d_model"])
        self.projection = nn.Linear(enc["d_model"], dec["projection_dim"])
        self.projection_norm = MaskedBatchNorm(dec["projection_dim"])
        self.decoder_lstm = BiLSTM(dec["projection_dim"], dec["lstm_hidden"])
        self.final_fc = nn.Linear(2 * dec["lstm_hidden"], vocab_size)

    def forward(self, feats: torch.Tensor, frame_lengths: torch.Tensor, ctx: Ctx,
                remat: Optional[bool] = None):
        """(B, T, n_mels) features → (B, T', V) float32 log-probs and (B,)
        lengths; ``remat`` as `model.ConformerCTC.forward`."""
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
        h = layer_norm(self.encoder.after_norm, h) * mask[..., None].to(h.dtype)
        h = self.projection_norm(F.silu(ctx.linear(self.projection, h)), mask, ctx) * mask[..., None].to(h.dtype)
        h = ctx.dropout(self.decoder_lstm(h, lengths, ctx), self.cfg["decoder"]["dropout"])
        return torch.log_softmax(F.linear(h, self.final_fc.weight, self.final_fc.bias), dim=-1), lengths
