"""wav2vec-2.0-style contrastive pretraining, port of
`nn_conformer_for_speech_recognition_tpu/models/pretrain.py`.

* feature encoder: the conv subsampling over log-mels;
* target path: a linear quantization to target vectors, optionally through
  a Gumbel-softmax;
* context path: random time-step masking (masked frames set to
  ``mask_value``) → Linear → Conformer context network → BiLSTM;
* loss: InfoNCE over the masked frames with K distractors drawn from other
  frames of the same utterance, plus α times the entropy term on the mean
  target distribution (`contrastive_loss`).

The JAX module builds its submodules with their defaults, so the port
follows those: float32 throughout, the einsum attention and the grouped
``conv1d`` depthwise conv at every length.  The BiLSTM (H = target_dim / 2,
160 by default) runs through the LSTM recurrence kernels
(`ops/cuda/lstm.py`, the cluster route at that width): they compute flax's
RNN on every valid frame, and the loss reads valid frames only.

The random draws (mask, Gumbel noise, distractor offsets) are uniform
tensors that a caller may inject (`PretrainDraws`), so that a step can be
held to the JAX package's on the same draws.  Distractors are gathered as
(B, T', K, D) directly, not from a (B, T', T', D) repeat of the targets.

Submodule names: ``conv_subsampling``, ``quant_proj``, ``pre_context``,
``context_net``, ``decoder``.  None starts with ``encoder.`` or
``subsampling.``, so `train.checkpoint.restore_encoder_params` takes
nothing from a pretraining checkpoint, as the JAX package's takes nothing
from its tree (``ConvSubsampling_0``, ``context_net``, ...).
"""

from __future__ import annotations

import dataclasses
from typing import Optional, Tuple

import torch
import torch.distributed as dist
import torch.nn as nn

from nn_conformer_for_speech_recognition_tpu_torch.config import ModelConfig, PretrainConfig
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import BiLSTM
from nn_conformer_for_speech_recognition_tpu_torch.models.conformer import ConformerEncoder, length_mask
from nn_conformer_for_speech_recognition_tpu_torch.models.layers import Linear
from nn_conformer_for_speech_recognition_tpu_torch.models.subsampling import ConvSubsampling
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import Axis, all_reduce_sum


@dataclasses.dataclass
class PretrainDraws:
    """One train step's uniform draws in [0, 1): ``mask`` (B, T'),
    ``gumbel`` (B, T', target_dim) or None, ``distractors`` (B, T', K)."""

    mask: torch.Tensor
    gumbel: Optional[torch.Tensor]
    distractors: torch.Tensor

    def rows(self, rows: slice) -> "PretrainDraws":
        """The draws of a data rank's ``rows`` of the batch."""
        return PretrainDraws(self.mask[rows], None if self.gumbel is None else self.gumbel[rows],
                             self.distractors[rows])


def draw_pretrain(
    generator: torch.Generator, batch: int, t: int, cfg: PretrainConfig, device: torch.device
) -> PretrainDraws:
    """The draws of one step over ``t`` subsampled frames, from ``generator``
    (on ``device``)."""
    mask = torch.rand((batch, t), generator=generator, device=device)
    gumbel = None
    if cfg.use_gumbel_quantizer:
        gumbel = torch.rand((batch, t, cfg.target_dim), generator=generator, device=device)
    distractors = torch.rand((batch, t, cfg.distractors_k), generator=generator, device=device)
    return PretrainDraws(mask, gumbel, distractors)


class PretrainModel(nn.Module):
    """(B, T, n_mels) features + lengths → (context (B, T', target_dim),
    targets (B, T', target_dim), mask positions (B, T') bool, lengths').
    ``model.train()`` masks and (with the Gumbel quantizer) adds noise from
    the given draws; ``model.eval()`` masks nothing."""

    def __init__(self, config: ModelConfig, pretrain: PretrainConfig):
        super().__init__()
        self.config, self.pretrain = config, pretrain
        d = config.encoder.d_model
        self.conv_subsampling = ConvSubsampling(config.subsampling, d, config.n_mels)
        self.quant_proj = Linear(d, pretrain.target_dim)
        self.pre_context = Linear(d, d)
        self.context_net = ConformerEncoder(config.encoder)
        self.decoder = BiLSTM(d, pretrain.target_dim // 2, use_kernel=True)

    def forward(
        self, features: torch.Tensor, frame_lengths: torch.Tensor, draws: Optional[PretrainDraws] = None
    ) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor, torch.Tensor]:
        pt = self.pretrain
        h, lengths = self.conv_subsampling(features, frame_lengths, torch.float32)
        if self.training and draws is None:
            raise ValueError("PretrainModel in train mode needs its draws (see draw_pretrain)")
        targets = self.quant_proj(h)
        if pt.use_gumbel_quantizer and self.training:
            g = -torch.log(-torch.log(draws.gumbel + 1e-10) + 1e-10)
            targets = torch.softmax((targets + g) / pt.gumbel_tau, dim=-1)
        valid = length_mask(lengths, h.shape[1])
        mask_pos = (draws.mask < pt.mask_probability) & valid if self.training else torch.zeros_like(valid)
        ctx = torch.where(mask_pos[..., None], torch.full_like(h, pt.mask_value), h)
        ctx = self.pre_context(ctx)
        ctx = self.context_net(ctx, lengths, attention_kernel=False)
        ctx = self.decoder(ctx, lengths)
        return ctx, targets, mask_pos, lengths


def _unit(x: torch.Tensor) -> torch.Tensor:
    # rsqrt(sumsq + eps): a finite value and gradient at x == 0 (padded
    # frames), where norm-then-divide has an infinite derivative
    return x * torch.rsqrt(torch.sum(x * x, dim=-1, keepdim=True) + 1e-12)


def contrastive_loss(
    context: torch.Tensor,
    targets: torch.Tensor,
    mask_pos: torch.Tensor,
    lengths: torch.Tensor,
    distractor_u: torch.Tensor,
    temperature: float = 0.1,
    diversity_alpha: float = 0.1,
    global_rows: bool = False,
    axis: Optional[Axis] = None,
) -> torch.Tensor:
    """InfoNCE over the masked positions with K within-utterance
    distractors, plus α·diversity.  ``distractor_u`` (B, T, K) uniform
    draws pick each distractor's offset from its frame: 1 + ⌊u·max(len−1, 1)⌋,
    modulo the row's length, so never the frame itself where len > 1.

    With ``global_rows`` the rows are a data rank's share of a batch: the
    masked positions are counted, and the target distribution averaged,
    over the data group ``axis`` (the world where None), and the
    diversity term, which every rank then computes whole, enters each
    rank's loss divided by the group's size, so that the ranks' losses and
    gradients add up to the global batch's."""
    b, t, _ = context.shape
    unit_ctx, unit_tgt = _unit(context), _unit(targets)
    pos_sim = torch.sum(unit_ctx * unit_tgt, dim=-1) / temperature  # (B, T)

    lengths = lengths.to(torch.int64)
    max_others = torch.clamp_min(lengths[:, None, None] - 1, 1)
    offs = 1 + torch.floor(distractor_u * max_others.to(distractor_u.dtype)).to(torch.int64)
    idx = (torch.arange(t, device=context.device)[None, :, None] + offs) % torch.clamp_min(lengths[:, None, None], 1)
    # _unit is row-wise, so the gathered rows of the unit targets are the units of the gathered rows
    dis = unit_tgt[torch.arange(b, device=context.device)[:, None, None], idx]  # (B, T, K, D)
    neg_sim = torch.sum(unit_ctx[:, :, None, :] * dis, dim=-1) / temperature  # (B, T, K)

    logits = torch.cat([pos_sim[..., None], neg_sim], dim=-1)
    nce = -(pos_sim - torch.logsumexp(logits, dim=-1))
    w = mask_pos.to(nce.dtype)
    spread = global_rows and (axis is None or axis.spread)
    count = all_reduce_sum(torch.sum(w), axis) if spread else torch.sum(w)
    loss = torch.sum(nce * w) / torch.clamp_min(count, 1.0)

    if diversity_alpha > 0:
        # the entropy of the mean target distribution over valid frames
        valid = (torch.arange(t, device=context.device)[None, :] < lengths[:, None])[..., None].to(targets.dtype)
        probs = torch.softmax(targets, dim=-1)
        sums = torch.cat([torch.sum(probs * valid, dim=(0, 1)), torch.sum(valid).reshape(1)])
        if spread:
            sums = all_reduce_sum(sums, axis)
        mean_p = sums[:-1] / torch.clamp_min(sums[-1], 1.0)
        entropy = -torch.sum(mean_p * torch.log(mean_p + 1e-10))
        ranks = (dist.get_world_size() if axis is None else axis.size) if spread else 1
        loss = loss - diversity_alpha * entropy / ranks
    return loss
