"""Convolutional subsampling frontend, port of
`nn_conformer_for_speech_recognition_tpu/models/subsampling.py`.

Stride-2 convs over the (time, mel) "image", time-preserving with SAME
padding (subsampled_length = ceil(ceil(T/2)/2)), then a per-frame Linear
over the flattened frequency × channel axis.  Torch has no 'same' padding
at stride > 1, so each conv pads explicitly with flax's rule (odd element
high), and the flatten follows the reference's NHWC order (t, f, c).
"""

from __future__ import annotations

from typing import Optional, Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from nn_conformer_for_speech_recognition_tpu_torch.config import SubsamplingConfig
from nn_conformer_for_speech_recognition_tpu_torch.models.layers import Linear, same_padding


class ConvSubsampling(nn.Module):
    """(B, T, n_mels) → (B, ceil(T/4), d_model), with length bookkeeping."""

    def __init__(self, config: SubsamplingConfig, d_model: int, n_mels: int):
        super().__init__()
        self.config = config
        convs, in_ch, freq = [], 1, n_mels
        for ch, k, sf in zip(config.channels, config.kernel_sizes, config.freq_strides):
            convs.append(nn.Conv2d(in_ch, ch, k))
            in_ch, freq = ch, -(-freq // sf)
        self.convs = nn.ModuleList(convs)
        self.out = Linear(freq * in_ch, d_model)

    def forward(
        self, x: torch.Tensor, frame_lengths: Optional[torch.Tensor], dtype: torch.dtype
    ) -> Tuple[torch.Tensor, Optional[torch.Tensor]]:
        cfg = self.config
        h = x.to(dtype)[:, None]  # (B, 1, T, F): time as H, mel bins as W
        for conv, k, st, sf in zip(self.convs, cfg.kernel_sizes, cfg.time_strides, cfg.freq_strides):
            t_pad = same_padding(h.shape[2], k, st)
            f_pad = same_padding(h.shape[3], k, sf)
            h = F.pad(h, (*f_pad, *t_pad))
            h = F.conv2d(h, conv.weight.to(dtype), conv.bias.to(dtype), stride=(st, sf))
            h = F.relu(h)
        b, c, t, f = h.shape
        h = self.out(h.permute(0, 2, 3, 1).reshape(b, t, f * c))

        out_lengths = None
        if frame_lengths is not None:
            out_lengths = frame_lengths
            for st in cfg.time_strides:
                out_lengths = -(-out_lengths // st)
        return h, out_lengths
