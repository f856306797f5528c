"""Conformer encoder blocks, port of
`nn_conformer_for_speech_recognition_tpu/models/conformer.py`.

Macaron block: ½FFN → MHSA(rel-pos) → ConvModule → ½FFN → LayerNorm, with
mask-based length handling.  Parameters are float32; each layer computes in
the dtype of its input (bfloat16 on CUDA, float32 on the CPU, see
`config.resolve_compute_dtype`).  The caller picks the attention route per
forward (`config.attention_route`): the rel-pos flash kernels
(`ops/cuda/attention.py`, forward and backward) or the plain einsum
attention, which also drops attention probabilities in training.  The
conv module's depthwise conv is the hand-written kernel
(`ops/cuda/depthwise_conv.py`) or a grouped conv1d, by `config.conv_route`.
With ``remat`` each block is recomputed in the backward pass (`torch.utils.checkpoint`).

Under tensor parallelism (`parallel.mesh.shard_module`) the FFNs and the
attention layers hold their model rank's share of the weights (``tp``, the
model axis): an FFN's hidden units, an attention layer's heads (q, k, v,
the rel-pos table and u, v of its own heads), each closed by one
all-reduce over the model group.  Dropout on a split activation is drawn
for the whole tensor and sliced, so that the ranks together draw what one
process draws.  Under sequence parallelism (`parallel.sequence`) an
attention layer exchanges its rows for its heads over the data group
where `parallel.sequence.seq_parallel_applicable` allows it.

``ConformerConfig.block`` 'e_branchformer' builds `EBranchformerBlock`s
(Kim et al. 2022) in place of `ConformerBlock`s: the attention branch and a
cgMLP branch side by side, merged by a depthwise conv over both, with one
more LayerNorm after the stack.  Its depthwise convs take the conv
module's route and carry a bias.  It runs under data and sequence
parallelism; `parallel.mesh.shard_module` refuses it under tensor
parallelism.

The encoder variants of ``ConformerConfig``: ``use_relative_attention=False``
is plain softmax attention over the keys (no position term, no u/v biases,
no ``pos_proj``; no kernel in either package), and ``conv_norm`` 'groupnorm'
or 'layernorm' replaces the conv module's masked BatchNorm (the library
depthwise conv then has a bias, as the JAX module's).
"""

from __future__ import annotations

import contextlib
import functools
from typing import Optional

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F
from torch.utils.checkpoint import checkpoint

from nn_conformer_for_speech_recognition_tpu_torch.config import ConformerConfig
from nn_conformer_for_speech_recognition_tpu_torch.models.layers import (
    GroupNorm,
    LayerNorm,
    Linear,
    same_padding,
)
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.attention import (
    flash_relpos_attention,
    flash_relpos_attention_plain,
)
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.depthwise_conv import depthwise_conv1d
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import (
    Axis,
    all_reduce_sum,
    copy_to_group,
    process_group_active,
    reduce_from_group,
)
from nn_conformer_for_speech_recognition_tpu_torch.parallel.sequence import (
    active_sequence_mesh,
    seq_parallel_applicable,
    ulysses_relpos_attention_rows,
)
from nn_conformer_for_speech_recognition_tpu_torch.utils.profiling import annotate

NEG_INF = -1e30  # the JAX module's key-mask value
CONV_NORMS = ("batchnorm", "groupnorm", "layernorm")
BLOCKS = ("conformer", "e_branchformer")


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


@functools.lru_cache(maxsize=16)
def rel_position_table(t: int, d_model: int, device: torch.device, dtype: torch.dtype) -> torch.Tensor:
    """`sinusoidal_rel_positions` on ``device`` in ``dtype``, copied there
    once per (T, d_model, device, dtype): a forward copies nothing from the
    host, so a train step on the card does not wait for a copy.  Made
    outside inference mode, so that a table first made by an eval step can
    be saved for a later training backward."""
    with torch.inference_mode(False):
        return torch.from_numpy(sinusoidal_rel_positions(t, d_model)).to(device, dtype)


class MaskedBatchNorm(nn.Module):
    """BatchNorm over (batch, time) with padded frames excluded from the
    statistics (biased variance over valid frames); eval mode normalises
    with the running statistics.  Training updates them as
    ``running = momentum * running + (1 - momentum) * batch`` unless
    ``update_stats`` is off (a rematerialised block's recompute).

    Under a process group (data parallelism, `parallel.mesh`) the
    statistics are the global batch's, as GSPMD gives the JAX module: the
    masked sum and count, then the masked sum of squared deviations, are
    summed over the ranks by a differentiable all-reduce, so the gradient
    goes through the global statistics and every rank updates the running
    ones alike.  A rematerialised block's recompute issues the same two
    all-reduces again, in the same order on every rank.  The sums run over
    ``data_axis`` where a trainer set it (`parallel.mesh.shard_module`):
    the ranks of a model group hold the same rows, so a sum over the world
    would count each row once a model rank."""

    data_axis: Optional[Axis] = None

    def __init__(self, channels: int, momentum: float = 0.9, eps: float = 1e-5):
        super().__init__()
        self.momentum, self.eps = momentum, eps
        self.update_stats = True
        self.weight = nn.Parameter(torch.ones(channels))
        self.bias = nn.Parameter(torch.zeros(channels))
        self.register_buffer("running_mean", torch.zeros(channels))
        self.register_buffer("running_var", torch.ones(channels))

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        if self.training:
            m = mask[..., None].to(x.dtype)
            total, count = (x * m).sum(dim=(0, 1)), m.sum()
            axis = self.data_axis
            spread = process_group_active() if axis is None else axis.spread
            if spread:
                both = all_reduce_sum(torch.cat([total, count.reshape(1)]), axis)
                total, count = both[:-1], both[-1]
            denom = torch.clamp_min(count, 1.0)
            mean = total / denom
            squares = (((x - mean) ** 2) * m).sum(dim=(0, 1))
            var = (all_reduce_sum(squares, axis) if spread else squares) / denom
            if self.update_stats:
                mom = self.momentum
                self.running_mean.mul_(mom).add_((1 - mom) * mean.detach().float())
                self.running_var.mul_(mom).add_((1 - mom) * var.detach().float())
        else:
            mean, var = self.running_mean, self.running_var
        y = (x - mean.to(x.dtype)) * torch.rsqrt(var.to(x.dtype) + self.eps)
        return y * self.weight.to(x.dtype) + self.bias.to(x.dtype)


def split_dropout(h: torch.Tensor, p: float, training: bool, axis: Axis, dim: int) -> torch.Tensor:
    """Dropout of this model rank's share (along ``dim``) of an activation
    split over ``axis``: the mask is drawn for the whole tensor, as
    ``F.dropout`` draws it in one process, and sliced, so that every rank
    advances the generator alike and together they drop what one process
    drops."""
    if not training or p == 0.0:
        return h
    dim %= h.dim()
    whole = list(h.shape)
    whole[dim] *= axis.size
    mask = F.dropout(torch.ones(whole, dtype=h.dtype, device=h.device), p, True)
    return h * mask.narrow(dim, axis.rank * h.shape[dim], h.shape[dim])


def _share(n: int, axis: Axis) -> slice:
    """Model rank ``axis.rank``'s share of ``n`` units."""
    part = n // axis.size
    return slice(axis.rank * part, (axis.rank + 1) * part)


class FeedForwardModule(nn.Module):
    """LN → Linear(ffn_dim) → SiLU → dropout → Linear(d_model) → dropout.
    Split over ``tp`` (`parallel.mesh.shard_module`): ``fc1`` holds the
    rank's hidden units (its output rows) and ``fc2`` the same units (its
    input columns), so the rank's partial output is summed over the model
    group once (Megatron-LM's pairing); ``fc1``'s bias is replicated and
    sliced, its gradient summed over the group."""

    tp: Optional[Axis] = None

    def __init__(self, d_model: int, ffn_dim: int, dropout: float):
        super().__init__()
        self.dropout = dropout
        self.norm = LayerNorm(d_model)
        self.fc1 = Linear(d_model, ffn_dim)
        self.fc2 = Linear(ffn_dim, d_model)

    @staticmethod
    def check_split(leaves, mp: int) -> None:
        if set(leaves) != {"fc1.weight", "fc2.weight"}:
            raise ValueError(f"an FFN splits both its Linears over the model axis, the rule splits {sorted(leaves)}")

    def forward(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp is None:
            h = F.dropout(F.silu(self.fc1(self.norm(x))), self.dropout, self.training)
            return F.dropout(self.fc2(h), self.dropout, self.training)
        bias = copy_to_group(self.fc1.bias, tp)[_share(self.fc1.bias.shape[0], tp)].to(x.dtype)
        h = F.linear(copy_to_group(self.norm(x), tp), self.fc1.weight.to(x.dtype), bias)
        h = split_dropout(F.silu(h), self.dropout, self.training, tp, dim=-1)
        out = reduce_from_group(F.linear(h, self.fc2.weight.to(h.dtype)), tp) + self.fc2.bias.to(h.dtype)
        return F.dropout(out, self.dropout, self.training)


class RelPositionMHSA(nn.Module):
    """Multi-head self-attention with Transformer-XL relative position bias:
    score(i,j) = (q_i + u)·k_j + (q_i + v)·r_{j-i}, softmax over valid keys.
    With ``use_relative=False``: score(i,j) = q_i·k_j, and no u, v or
    ``pos_proj``.

    Split over ``tp`` (`parallel.mesh.shard_module`) a rank runs H/mp
    heads: ``qkv`` holds q, k and v of its heads, ``pos_proj`` their
    columns of the table, ``out_proj`` their input columns, whose partial
    output is summed over the model group once; u and v are replicated and
    sliced to the rank's heads."""

    tp: Optional[Axis] = None

    def __init__(self, d_model: int, num_heads: int, dropout: float, use_relative: bool = True):
        super().__init__()
        if d_model % num_heads:
            raise ValueError("d_model must divide into num_heads")
        self.d_model, self.num_heads, self.dropout = d_model, num_heads, dropout
        self.use_relative = use_relative
        dh = d_model // num_heads
        self.norm = LayerNorm(d_model)
        self.qkv = Linear(d_model, 3 * d_model, bias=False)
        if use_relative:
            self.pos_proj = Linear(d_model, d_model, bias=False)
        self.out_proj = Linear(d_model, d_model)
        if use_relative:
            self.u_bias = nn.Parameter(torch.zeros(num_heads, dh))
            self.v_bias = nn.Parameter(torch.zeros(num_heads, dh))

    def check_split(self, leaves, mp: int) -> None:
        want = {"qkv.weight", "out_proj.weight"} | ({"pos_proj.weight"} if self.use_relative else set())
        if set(leaves) != want:
            raise ValueError(f"an attention layer splits {sorted(want)} over the model axis, the rule splits "
                             f"{sorted(leaves)}")
        if self.num_heads % mp:
            raise ValueError(f"{self.num_heads} heads do not divide over model_parallel_size={mp}")

    def forward(
        self, x: torch.Tensor, lengths: torch.Tensor, rel: torch.Tensor, use_kernel: bool = False
    ) -> torch.Tensor:
        """``rel``: (2T-1, d_model) sinusoidal table in x's dtype.
        ``use_kernel`` sends the attention through the flash kernels, forward
        and backward (dropout on the output only, as the JAX flash path);
        otherwise the einsum attention also drops probabilities in training.
        `config.attention_route` picks the einsum route in training only
        below 768 frames and only where ``attention_dropout > 0``: without a
        probability mask both routes compute the same function.  Without
        relative positions the attention is always the einsum route
        (`config.attention_route` never picks the kernels for it).  Under
        sequence parallelism, where applicable, the rel-pos attention is
        `parallel.sequence.ulysses_relpos_attention_rows` on the same route,
        without probability dropout, as the JAX Ulysses path.  The
        attention core, from the biased queries (or the Ulysses exchange) to
        the heads' output before ``out_proj``, is the span
        ``encoder.attention`` (`utils.profiling.annotate`)."""
        b, t, _ = x.shape
        tp = self.tp
        dh = self.d_model // self.num_heads
        h = self.num_heads if tp is None else self.num_heads // tp.size
        heads = slice(None) if tp is None else _share(self.num_heads, tp)
        xn = self.norm(x) if tp is None else copy_to_group(self.norm(x), tp)
        q, k, v = self.qkv(xn).reshape(b, t, 3, h, dh).unbind(dim=2)
        scale = 1.0 / float(np.sqrt(dh))
        drop = self.dropout if self.training else 0.0
        axis = None
        if self.use_relative:
            u, vb = self.u_bias, self.v_bias
            if tp is not None:
                u, vb = copy_to_group(u, tp)[heads], copy_to_group(vb, tp)[heads]
            seq = active_sequence_mesh()
            if seq is not None and seq_parallel_applicable(seq[0], seq[1], t, h):
                axis = seq[0].axis(seq[1])
                cols = _share(h * dh, axis)  # the table of this rank's heads only
                p = F.linear(rel, self.pos_proj.weight[cols].to(rel.dtype)).reshape(2 * t - 1, h // axis.size, dh)
            else:
                p = self.pos_proj(rel).reshape(2 * t - 1, h, dh)
        with annotate("encoder.attention"):
            if not self.use_relative:
                out = self._dot_attention(q, k, v, lengths, scale)
            elif axis is not None:
                out = ulysses_relpos_attention_rows(q, k, v, p, u, vb, lengths, scale, axis, use_kernel)
            else:
                args = (q + u.to(x.dtype), q + vb.to(x.dtype), k, v, p, lengths, scale)
                if use_kernel:
                    out = flash_relpos_attention(*args)
                else:
                    mask = {}
                    if drop > 0.0 and tp is not None:  # the whole mask, as one process draws it, sliced
                        mask["keep"] = (torch.rand((b, self.num_heads, t, t), device=x.device) >= drop)[:, heads]
                    out = flash_relpos_attention_plain(*args, dropout=drop, **mask)
        out = out.reshape(b, t, h * dh)
        if tp is None:
            out = self.out_proj(out)
        else:
            out = reduce_from_group(F.linear(out, self.out_proj.weight.to(out.dtype)), tp)
            out = out + self.out_proj.bias.to(out.dtype)
        return F.dropout(out, self.dropout, self.training)

    def _dot_attention(self, q, k, v, lengths, scale: float) -> torch.Tensor:
        """The JAX module's attention without relative positions: scores in
        float32 (float64 for float64 inputs), invalid keys at `NEG_INF`,
        softmax in that type, probabilities cast to v's type, then dropped
        in training."""
        acc = torch.promote_types(q.dtype, torch.float32)
        scores = torch.einsum("bihd,bjhd->bhij", q.to(acc), k.to(acc)) * scale
        scores = scores.masked_fill(~length_mask(lengths, k.shape[1])[:, None, None, :], NEG_INF)
        attn = torch.softmax(scores, dim=-1).to(v.dtype)
        if self.tp is None:
            attn = F.dropout(attn, self.dropout, self.training)
        else:
            attn = split_dropout(attn, self.dropout, self.training, self.tp, dim=1)
        return torch.einsum("bhij,bjhd->bihd", attn, v)


class ConvModule(nn.Module):
    """LN → pointwise (2× expansion) → GLU → depthwise conv → norm → SiLU →
    pointwise → dropout.  The norm is ``norm``: the masked BatchNorm
    (``batch_norm``), flax's GroupNorm of 32 groups (``group_norm``) or a
    LayerNorm over the channels (``layer_norm``).  The depthwise conv has
    one of two routes, fixed at construction because each owns its
    parameter, as in the JAX package: ``use_kernel`` registers
    ``dw_kernel`` (K, C) and runs `ops.cuda.depthwise_conv.depthwise_conv1d`
    (the hand-written kernel on CUDA, channels-last, no transposes; no
    bias, whatever the norm); otherwise ``depthwise`` is a grouped conv1d
    (the JAX package's XLA path), with a bias unless BatchNorm follows."""

    def __init__(self, d_model: int, kernel_size: int, expansion: int, dropout: float, use_kernel: bool = False,
                 norm: str = "batchnorm"):
        super().__init__()
        if norm not in CONV_NORMS:
            raise ValueError(f"conv_norm must be one of {CONV_NORMS}, got {norm!r}")
        channels = expansion * d_model
        self.kernel_size, self.dropout = kernel_size, dropout
        self.norm = LayerNorm(d_model)
        self.pointwise_in = Linear(d_model, 2 * channels)
        if use_kernel:
            self.dw_kernel = nn.Parameter(torch.empty(kernel_size, channels))
        else:
            self.depthwise = nn.Conv1d(channels, channels, kernel_size, groups=channels, bias=norm != "batchnorm")
        if norm == "batchnorm":
            self.batch_norm = MaskedBatchNorm(channels)
        elif norm == "groupnorm":
            self.group_norm = GroupNorm(channels)
        else:
            self.layer_norm = LayerNorm(channels)
        self.pointwise_out = Linear(channels, d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        a, g = self.pointwise_in(self.norm(x)).chunk(2, dim=-1)
        h = a * torch.sigmoid(g)  # GLU
        # zero padded frames so the depthwise window never reads garbage
        h = h * mask[..., None].to(h.dtype)
        if hasattr(self, "dw_kernel"):
            h = depthwise_conv1d(h, self.dw_kernel.to(h.dtype))
        else:
            h = F.pad(h.transpose(1, 2), same_padding(h.shape[1], self.kernel_size, 1))
            bias = self.depthwise.bias
            h = F.conv1d(h, self.depthwise.weight.to(h.dtype), None if bias is None else bias.to(h.dtype),
                         groups=h.shape[1]).transpose(1, 2)
        if hasattr(self, "batch_norm"):
            h = self.batch_norm(h, mask)
        else:  # no mask: flax's GroupNorm and LayerNorm take none
            h = (self.group_norm if hasattr(self, "group_norm") else self.layer_norm)(h)
        h = F.silu(h)
        return F.dropout(self.pointwise_out(h), self.dropout, self.training)


class ConformerBlock(nn.Module):
    def __init__(self, config: ConformerConfig, conv_kernel: bool = False):
        super().__init__()
        self.ffn1 = FeedForwardModule(config.d_model, config.ffn_dim, config.dropout)
        self.mhsa = RelPositionMHSA(config.d_model, config.num_heads, config.attention_dropout,
                                    use_relative=config.use_relative_attention)
        self.conv = ConvModule(
            config.d_model, config.conv_kernel_size, config.conv_expansion, config.dropout, use_kernel=conv_kernel,
            norm=config.conv_norm,
        )
        self.ffn2 = FeedForwardModule(config.d_model, config.ffn_dim, config.dropout)
        self.norm = LayerNorm(config.d_model)

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor, lengths: torch.Tensor, rel: torch.Tensor,
        attention_kernel: bool = False,
    ) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x)
        x = x + self.mhsa(x, lengths, rel, attention_kernel)
        x = x + self.conv(x, mask)
        x = x + 0.5 * self.ffn2(x)
        return self.norm(x) * mask[..., None].to(x.dtype)


def _add_depthwise(owner: nn.Module, channels: int, kernel_size: int, use_kernel: bool) -> None:
    """A SAME depthwise conv with a bias on ``owner``, on the conv module's
    routes: ``use_kernel`` registers ``dw_kernel`` (K, C) and ``dw_bias``
    (C,) for `ops.cuda.depthwise_conv.depthwise_conv1d`; otherwise
    ``depthwise`` is a grouped conv1d with its bias."""
    if use_kernel:
        owner.dw_kernel = nn.Parameter(torch.empty(kernel_size, channels))
        owner.dw_bias = nn.Parameter(torch.zeros(channels))
    else:
        owner.depthwise = nn.Conv1d(channels, channels, kernel_size, groups=channels)


def _depthwise(owner: nn.Module, h: torch.Tensor) -> torch.Tensor:
    """``owner``'s depthwise conv and bias over (B, T, C) ``h``, whose padded
    frames the caller has zeroed."""
    if hasattr(owner, "dw_kernel"):
        return depthwise_conv1d(h, owner.dw_kernel.to(h.dtype)) + owner.dw_bias.to(h.dtype)
    conv = owner.depthwise
    h = F.pad(h.transpose(1, 2), same_padding(h.shape[1], conv.kernel_size[0], 1))
    return F.conv1d(h, conv.weight.to(h.dtype), conv.bias.to(h.dtype), groups=h.shape[1]).transpose(1, 2)


class ConvolutionalGatingMLP(nn.Module):
    """The cgMLP branch: LN → Linear(cgmlp_dim) → GELU → split into halves
    r and g → g: LN → × mask → depthwise conv (SAME, bias) → r · g →
    dropout → Linear(d_model) → dropout.  Padded frames are zeroed before
    the conv, as in `ConvModule`, where ESPnet's gate lets them in."""

    def __init__(self, d_model: int, cgmlp_dim: int, kernel_size: int, dropout: float, use_kernel: bool = False):
        super().__init__()
        if cgmlp_dim % 2:
            raise ValueError(f"cgmlp_dim must be even, got {cgmlp_dim}")
        self.dropout = dropout
        self.norm = LayerNorm(d_model)
        self.channel_proj1 = Linear(d_model, cgmlp_dim)
        self.gate_norm = LayerNorm(cgmlp_dim // 2)
        _add_depthwise(self, cgmlp_dim // 2, kernel_size, use_kernel)
        self.channel_proj2 = Linear(cgmlp_dim // 2, d_model)

    def forward(self, x: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        r, g = F.gelu(self.channel_proj1(self.norm(x))).chunk(2, dim=-1)
        g = _depthwise(self, self.gate_norm(g) * mask[..., None].to(g.dtype))
        h = F.dropout(r * g, self.dropout, self.training)
        return F.dropout(self.channel_proj2(h), self.dropout, self.training)


class MergeModule(nn.Module):
    """E-Branchformer's merge: c = [x1, x2] over the channels, c + depthwise
    conv (SAME, bias) of c × mask, Linear(2·d_model → d_model), dropout."""

    def __init__(self, d_model: int, kernel_size: int, dropout: float, use_kernel: bool = False):
        super().__init__()
        self.dropout = dropout
        _add_depthwise(self, 2 * d_model, kernel_size, use_kernel)
        self.proj = Linear(2 * d_model, d_model)

    def forward(self, x1: torch.Tensor, x2: torch.Tensor, mask: torch.Tensor) -> torch.Tensor:
        c = torch.cat([x1, x2], dim=-1)
        c = c + _depthwise(self, c * mask[..., None].to(c.dtype))
        return F.dropout(self.proj(c), self.dropout, self.training)


class EBranchformerBlock(nn.Module):
    """E-Branchformer block: x + ½FFN; the attention branch (`RelPositionMHSA`,
    whose output dropout is ``attention_dropout``) and the cgMLP branch on
    the same x; x + merge of both; x + ½FFN; LayerNorm; × mask.  The cgMLP
    branch and the merge are the spans ``encoder.cgmlp`` and
    ``encoder.merge`` (`utils.profiling.annotate`)."""

    tensor_parallel_refused = "an E-Branchformer block has no tensor-parallel split"

    def __init__(self, config: ConformerConfig, conv_kernel: bool = False):
        super().__init__()
        d = config.d_model
        self.ffn1 = FeedForwardModule(d, config.ffn_dim, config.dropout)
        self.mhsa = RelPositionMHSA(d, config.num_heads, config.attention_dropout,
                                    use_relative=config.use_relative_attention)
        self.cgmlp = ConvolutionalGatingMLP(d, config.cgmlp_dim, config.conv_kernel_size, config.dropout,
                                            use_kernel=conv_kernel)
        self.merge = MergeModule(d, config.merge_conv_kernel, config.dropout, use_kernel=conv_kernel)
        self.ffn2 = FeedForwardModule(d, config.ffn_dim, config.dropout)
        self.norm = LayerNorm(d)

    def forward(
        self, x: torch.Tensor, mask: torch.Tensor, lengths: torch.Tensor, rel: torch.Tensor,
        attention_kernel: bool = False,
    ) -> torch.Tensor:
        x = x + 0.5 * self.ffn1(x)
        x1 = self.mhsa(x, lengths, rel, attention_kernel)
        with annotate("encoder.cgmlp"):
            x2 = self.cgmlp(x, mask)
        with annotate("encoder.merge"):
            x = x + self.merge(x1, x2, mask)
        x = x + 0.5 * self.ffn2(x)
        return self.norm(x) * mask[..., None].to(x.dtype)


@contextlib.contextmanager
def _frozen_batch_stats(module: nn.Module):
    """Running statistics untouched inside: a rematerialised block's
    recompute must not update them a second time."""
    norms = [m for m in module.modules() if isinstance(m, MaskedBatchNorm)]
    for m in norms:
        m.update_stats = False
    try:
        yield
    finally:
        for m in norms:
            m.update_stats = True


class ConformerEncoder(nn.Module):
    """Stack of Conformer blocks, or of E-Branchformer blocks followed by a
    LayerNorm (× mask); (B, T, d_model) + lengths → (B, T, d_model).

    With ``remat`` each block runs under non-reentrant
    ``torch.utils.checkpoint`` whenever autograd records: its activations
    are recomputed in the backward pass (the JAX package's ``nn.remat``).
    The checkpoint restores the RNG state for the recompute, so dropout
    replays the same masks, and the recompute leaves the batch statistics
    alone."""

    def __init__(self, config: ConformerConfig, remat: bool = False, conv_kernel: bool = False):
        super().__init__()
        if config.block not in BLOCKS:
            raise ValueError(f"block must be one of {BLOCKS}, got {config.block!r}")
        self.d_model, self.remat = config.d_model, remat
        block = EBranchformerBlock if config.block == "e_branchformer" else ConformerBlock
        self.blocks = nn.ModuleList(block(config, conv_kernel) for _ in range(config.num_blocks))
        if config.block == "e_branchformer":
            self.after_norm = LayerNorm(config.d_model)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor, attention_kernel: bool = False) -> torch.Tensor:
        t = x.shape[1]
        mask = length_mask(lengths, t)
        rel = rel_position_table(t, self.d_model, x.device, x.dtype)
        for block in self.blocks:
            if self.remat and torch.is_grad_enabled():
                x = checkpoint(
                    block, x, mask, lengths, rel, attention_kernel, use_reentrant=False,
                    context_fn=lambda block=block: (contextlib.nullcontext(), _frozen_batch_stats(block)),
                )
            else:
                x = block(x, mask, lengths, rel, attention_kernel)
        if hasattr(self, "after_norm"):
            x = self.after_norm(x) * mask[..., None].to(x.dtype)
        return x
