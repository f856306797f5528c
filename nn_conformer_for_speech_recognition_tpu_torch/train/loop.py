"""Train, eval and predict steps, port of
`nn_conformer_for_speech_recognition_tpu/train/loop.py` (``make_augment_step``,
``make_feature_train_step``, ``make_train_step``, ``make_eval_step``,
``make_predict_step``, ``optax_global_norm``).

The JAX steps are pure functions of a state pytree.  Here the model module
holds its parameters and batch statistics and the optimizer its state, so
a train step updates them in place and returns the same `TrainState`; the
predict step takes the audio only.  Each step puts the model in the mode
it needs: train mode (dropout, batch-statistics update, the differentiable
attention route) for the train step, eval mode for the others.

Not ported, as TPU scheduler workarounds: the ``optimization_barrier``
fence between the augment and train halves, the hardware-RNG dropout key
and the scan-over-steps protocols.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterable, Tuple

import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, SpecAugmentConfig
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu_torch.ops.ctc import ctc_loss
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.ctc import ctc_loss_kernel
from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import greedy_decode
from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
from nn_conformer_for_speech_recognition_tpu_torch.ops.specaugment import add_gaussian_noise, specaugment
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState


def _select_ctc(ctc_impl: str) -> Callable[..., torch.Tensor]:
    """'auto' and 'pallas' → the alpha/beta kernels (their plain twins on
    the CPU); 'xla' → the plain recursion differentiated by autograd."""
    if ctc_impl in ("auto", "pallas"):
        return ctc_loss_kernel
    if ctc_impl != "xla":
        raise ValueError(f"unknown ctc_impl {ctc_impl!r}")
    return ctc_loss


def _batch_loss(ctc, log_probs, targets, out_lengths, target_lengths, blank_id) -> torch.Tensor:
    """Per-sequence CTC over the target length, averaged over the rows
    that have a target (``target_lengths > 0``)."""
    per_seq = ctc(log_probs, targets, out_lengths, target_lengths, blank_id=blank_id, reduction=None)
    w = (target_lengths > 0).to(per_seq.dtype)
    denom = torch.clamp_min(target_lengths, 1).to(per_seq.dtype)
    return (per_seq / denom * w).sum() / torch.clamp_min(w.sum(), 1.0)


def optax_global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tensors))


def make_augment_step(
    feat_cfg: FeatureConfig,
    sa_cfg: SpecAugmentConfig,
    use_specaugment: bool = True,
    noise_std: float = 0.0,
) -> Callable[[torch.Generator, torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``augment(generator, audio, audio_lengths) → (features,
    frame_lengths)``: optional waveform noise, log-mel features (the STFT
    kernel on CUDA), SpecAugment, all drawn from ``generator``."""
    featurize = make_featurizer(feat_cfg)

    @torch.no_grad()
    def augment(generator, audio, audio_lengths):
        if noise_std > 0.0:
            audio = add_gaussian_noise(audio, generator, noise_std)
        feats, frame_lengths = featurize(audio, audio_lengths)
        if use_specaugment:
            feats = specaugment(feats, frame_lengths, sa_cfg, generator)
        return feats, frame_lengths

    return augment


def make_feature_train_step(
    model: ConformerCTC,
    blank_id: int,
    ctc_impl: str = "auto",
    emit_ids: bool = False,
    pad_id: int = 0,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, feats, frame_lengths, targets,
    target_lengths) → (state, metrics)``: forward in train mode, CTC loss,
    backward, one optimizer update.  ``metrics`` holds ``loss`` and
    ``grad_norm`` (of the gradients before the update), and with
    ``emit_ids`` the greedy ids of the training forward and their lengths.
    Dropout draws from the device generator seeded by
    ``state.dropout_seed()``; the global RNG state is restored after."""
    ctc = _select_ctc(ctc_impl)

    def train_step(state: TrainState, feats, frame_lengths, targets, target_lengths):
        if state.model is not model:
            raise ValueError("train_step: state.model is not the model the step was made for")
        model.train()
        model.zero_grad(set_to_none=True)
        devices = [feats.device] if feats.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(state.dropout_seed())
            log_probs, out_lengths = model(feats, frame_lengths)
            loss = _batch_loss(ctc, log_probs, targets, out_lengths, target_lengths, blank_id)
            loss.backward()
        grad_norm = optax_global_norm(p.grad for p in model.parameters())
        state.apply_gradients()
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        if emit_ids:
            metrics["ids"] = greedy_decode(log_probs.detach(), out_lengths, pad_id=pad_id)
            metrics["out_lengths"] = out_lengths
        return state, metrics

    return train_step


def make_train_step(
    model: ConformerCTC,
    feat_cfg: FeatureConfig,
    sa_cfg: SpecAugmentConfig,
    blank_id: int,
    use_specaugment: bool = True,
    noise_std: float = 0.0,
    ctc_impl: str = "auto",
    emit_ids: bool = False,
    pad_id: int = 0,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, audio, audio_lengths, targets, target_lengths)
    → (state, metrics)``: `make_augment_step` (drawing from
    ``state.generator``) then `make_feature_train_step`."""
    augment = make_augment_step(feat_cfg, sa_cfg, use_specaugment, noise_std)
    core = make_feature_train_step(model, blank_id, ctc_impl, emit_ids=emit_ids, pad_id=pad_id)

    def train_step(state: TrainState, audio, audio_lengths, targets, target_lengths):
        feats, frame_lengths = augment(state.generator, audio, audio_lengths)
        return core(state, feats, frame_lengths, targets, target_lengths)

    return train_step


def make_eval_step(
    model: ConformerCTC, feat_cfg: FeatureConfig, blank_id: int, pad_id: int, ctc_impl: str = "auto"
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns ``eval_step(audio, audio_lengths, targets, target_lengths)
    → (loss, ids, out_lengths)``: eval-mode forward, the train step's loss,
    greedy ids (``pad_id`` beyond each row's length).  Shallow LM fusion
    is not ported yet."""
    featurize = make_featurizer(feat_cfg)
    ctc = _select_ctc(ctc_impl)

    @torch.inference_mode()
    def eval_step(audio, audio_lengths, targets, target_lengths):
        model.eval()
        feats, frame_lengths = featurize(audio, audio_lengths)
        log_probs, out_lengths = model(feats, frame_lengths)
        loss = _batch_loss(ctc, log_probs, targets, out_lengths, target_lengths, blank_id)
        return loss, greedy_decode(log_probs, out_lengths, pad_id=pad_id), out_lengths

    return eval_step


def make_predict_step(
    model: ConformerCTC, feat_cfg: FeatureConfig, pad_id: int
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``predict_step(audio, audio_lengths) → (ids, out_lengths)``:
    (B, S) float32 audio and (B,) sample counts → (B, T') int32 greedy ids
    (``pad_id`` beyond each row's length) and (B,) output lengths, in eval
    mode (running BatchNorm statistics, no dropout).  The Noisy Student
    pseudo-label pass calls it once per batch."""
    featurize = make_featurizer(feat_cfg)

    @torch.inference_mode()
    def predict_step(audio: torch.Tensor, audio_lengths: torch.Tensor):
        model.eval()
        feats, frame_lengths = featurize(audio, audio_lengths)
        log_probs, out_lengths = model(feats, frame_lengths)
        return greedy_decode(log_probs, out_lengths, pad_id=pad_id), out_lengths

    return predict_step
