"""The ASR model: Conformer encoder + BiLSTM CTC head, port of
`nn_conformer_for_speech_recognition_tpu/models/asr.py`.

features (B, T, n_mels) + lengths → ConvSubsampling → dropout → Conformer
blocks → Linear → SiLU → masked BatchNorm → BiLSTM → dropout → Linear
(float32) → log_softmax (float32).  ``model.train()`` / ``model.eval()``
play the JAX package's ``deterministic=False`` / ``True``: dropout and the
batch-statistics update in training, and the attention route chosen by
`config.attention_route`.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn as nn
import torch.nn.functional as F

from nn_conformer_for_speech_recognition_tpu_torch.config import (
    ModelConfig,
    attention_route,
    conv_route,
    resolve_compute_dtype,
    uses_lstm_kernel,
)
from nn_conformer_for_speech_recognition_tpu_torch.models.conformer import (
    ConformerEncoder,
    MaskedBatchNorm,
    length_mask,
)
from nn_conformer_for_speech_recognition_tpu_torch.models.layers import Linear
from nn_conformer_for_speech_recognition_tpu_torch.models.subsampling import ConvSubsampling
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.lstm import lstm_directions, lstm_plain


class BiLSTM(nn.Module):
    """Bidirectional LSTM over padded sequences, in the JAX package's packed
    (Pallas) parameter layout: per layer and direction ``w_ih`` (in, 4H),
    ``w_hh`` (H, 4H) and one ``bias`` (4H,), gates in i, f, g, o order.
    The input projection runs in the compute dtype and is cast to float32;
    the recurrence is float32; the output is cast back to the compute dtype.
    With ``use_kernel`` a layer's directions go to `ops.cuda.lstm.lstm_directions`
    together (on CUDA one launch of each kernel for both, through their
    autograd Function; on the CPU the same Function over the plain twins);
    otherwise each direction is `lstm_plain`, differentiated by autograd.
    """

    def __init__(
        self, input_dim: int, hidden: int, num_layers: int = 1,
        bidirectional: bool = True, use_kernel: bool = True,
    ):
        super().__init__()
        self.num_layers = num_layers
        self.directions = [("fwd", False)] + ([("bwd", True)] if bidirectional else [])
        self.use_kernel = use_kernel
        d = input_dim
        for i in range(num_layers):
            for name, _ in self.directions:
                self.register_parameter(f"lstm_{name}_{i}_w_ih", nn.Parameter(torch.empty(d, 4 * hidden)))
                self.register_parameter(f"lstm_{name}_{i}_w_hh", nn.Parameter(torch.empty(hidden, 4 * hidden)))
                self.register_parameter(f"lstm_{name}_{i}_bias", nn.Parameter(torch.zeros(4 * hidden)))
            d = hidden * len(self.directions)

    def forward(self, x: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
        dtype = x.dtype
        reverse = [r for _, r in self.directions]
        for i in range(self.num_layers):
            xws = [(x.to(dtype) @ getattr(self, f"lstm_{name}_{i}_w_ih").to(dtype)).float()
                   + getattr(self, f"lstm_{name}_{i}_bias") for name, _ in self.directions]
            w_hhs = [getattr(self, f"lstm_{name}_{i}_w_hh") for name, _ in self.directions]
            if self.use_kernel:
                outs = lstm_directions(xws, w_hhs, lengths, reverse)
            else:
                outs = [lstm_plain(xw, w, lengths, r) for xw, w, r in zip(xws, w_hhs, reverse)]
            x = torch.cat(outs, dim=-1)
        return x.to(dtype)


class ConformerCTC(nn.Module):
    """features (B, T, n_mels) + lengths → log-probs (B, T', V) + lengths'."""

    def __init__(self, config: ModelConfig, vocab_size: int):
        super().__init__()
        self.config = config
        enc, dec = config.encoder, config.decoder
        self.subsampling = ConvSubsampling(config.subsampling, enc.d_model, config.n_mels)
        self.encoder = ConformerEncoder(enc, remat=config.remat, conv_kernel=conv_route(config) == "kernel")
        self.projection = Linear(enc.d_model, dec.projection_dim)
        self.projection_norm = MaskedBatchNorm(dec.projection_dim)
        self.decoder_lstm = BiLSTM(
            dec.projection_dim, dec.lstm_hidden, dec.lstm_layers, dec.bidirectional,
            use_kernel=uses_lstm_kernel(config),
        )
        lstm_out = dec.lstm_hidden * (2 if dec.bidirectional else 1)
        self.final_fc = nn.Linear(lstm_out, vocab_size)

    def encode(
        self, features: torch.Tensor, frame_lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        dtype = resolve_compute_dtype(self.config, features.device)
        h, lengths = self.subsampling(features, frame_lengths, dtype)
        h = F.dropout(h, self.config.encoder.dropout, self.training)
        h = self.encoder(h, lengths, attention_route(self.config, self.training, h.shape[1]) == "kernel")
        mask = length_mask(lengths, h.shape[1])
        h = self.projection_norm(F.silu(self.projection(h)), mask)
        return h * mask[..., None].to(h.dtype), lengths

    def forward(
        self, features: torch.Tensor, frame_lengths: torch.Tensor
    ) -> Tuple[torch.Tensor, torch.Tensor]:
        h, lengths = self.encode(features, frame_lengths)
        h = self.decoder_lstm(h, lengths)
        h = F.dropout(h, self.config.decoder.dropout, self.training)
        logits = self.final_fc(h.float())
        return torch.log_softmax(logits, dim=-1), lengths


def orthogonal_(p: torch.Tensor, generator: torch.Generator) -> torch.Tensor:
    """flax's ``orthogonal()`` on a (rows, cols) matrix with rows ≤ cols: QR
    of a (cols, rows) normal draw, Q's columns multiplied by the signs of
    R's diagonal, transposed, so that the rows are orthonormal.  Draws as
    many numbers as a normal fill of ``p``."""
    q, r = torch.linalg.qr(torch.randn(p.shape[::-1], generator=generator).double())
    return p.copy_((q * torch.sign(torch.diagonal(r))).t())


def init_params(model: nn.Module, generator: torch.Generator) -> nn.Module:
    """Seeded initialisation, as the JAX package's model initialises:
    LeCun-normal matrices (std 1/sqrt(fan_in)), each LSTM direction's
    recurrent ``_w_hh`` (H, 4H) orthogonal, norm scales at 1, every bias
    (and the attention's u/v) at 0."""
    with torch.no_grad():
        for name, p in model.named_parameters():
            if p.ndim == 1:
                p.fill_(1.0 if name.endswith("weight") else 0.0)
            elif name.endswith(("u_bias", "v_bias")):
                p.zero_()
            elif name.endswith("_w_hh"):
                orthogonal_(p, generator)
            else:
                # LSTM input matrices are (in, 4H) and the depthwise taps
                # (K, C); Linear/conv weights are (out, in, ...)
                fan_in = p.shape[0] if name.endswith(("_w_ih", "dw_kernel")) else p[0].numel()
                p.copy_(torch.randn(p.shape, generator=generator) * fan_in ** -0.5)
    return model
