"""Predict step, port of ``make_predict_step``
(`nn_conformer_for_speech_recognition_tpu/train/loop.py:323-334`).

The Noisy Student pseudo-label pass calls it once per batch: featurise,
ConformerCTC forward in eval mode, greedy decode.  The JAX step takes the
train state as its first argument; here the model module holds its own
parameters and buffers, so the step takes the audio only.  The training
steps are not ported yet.
"""

from __future__ import annotations

from typing import Callable, Tuple

import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import greedy_decode
from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer


def make_predict_step(
    model: ConformerCTC, feat_cfg: FeatureConfig, pad_id: int
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``predict_step(audio, audio_lengths) → (ids, out_lengths)``:
    (B, S) float32 audio and (B,) sample counts → (B, T') int32 greedy ids
    (``pad_id`` beyond each row's length) and (B,) output lengths.  Puts
    ``model`` in eval mode (running BatchNorm statistics, no dropout)."""
    featurize = make_featurizer(feat_cfg)
    model.eval()

    @torch.inference_mode()
    def predict_step(audio: torch.Tensor, audio_lengths: torch.Tensor):
        feats, frame_lengths = featurize(audio, audio_lengths)
        log_probs, out_lengths = model(feats, frame_lengths)
        return greedy_decode(log_probs, out_lengths, pad_id=pad_id), out_lengths

    return predict_step
