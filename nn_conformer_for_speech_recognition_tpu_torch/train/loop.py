"""Train, eval and predict steps and the `Trainer` that drives them, port of
`nn_conformer_for_speech_recognition_tpu/train/loop.py` (``make_augment_step``,
``make_feature_train_step``, ``make_train_step``, ``make_epoch_scan_step``,
``make_eval_step``, ``make_predict_step``, ``make_beam_step``,
``make_eval_beam_step``, ``optax_global_norm``, ``Trainer``).

The JAX steps are pure functions of a state pytree.  Here the model module
holds its parameters and batch statistics and the optimizer its state, so
a train step updates them in place and returns the same `TrainState`; the
predict step takes the audio only.  Each step puts the model in the mode
it needs: train mode (dropout, batch-statistics update, the differentiable
attention route) for the train step, eval mode for the others.

`Trainer` is the host-side epoch loop around them: shuffled bucketed
batches, per-epoch validation, WER on decoded strings, checkpoints with
resume cursors, and the Noisy Student pseudo-label pass.  Over a
device-resident dataset (`data/device_cache.py`) an epoch gathers its
batches on the device and, through `Trainer.train_device_epochs`, runs as
one call of `make_epoch_scan_step` (in chunks where mid-epoch checkpoints
are asked for) that pulls nothing to the host before it ends.  It runs on
the first CUDA device unless the caller asks for ``device="cpu"``.

Parallelism (`parallel.mesh`): under a process group, one card a process,
the trainer lays its processes out as ``('data', 'model')``
(`parallel.mesh.make_mesh`, from ``MeshConfig``).  Each data rank reads
every global batch and computes on its contiguous share of the rows
(`parallel.mesh.DataShard`).  The loss divides by the global count of rows
with a target, the masked BatchNorm takes the global batch's statistics,
one all-reduce of the flat gradient over the data group follows the
backward, and the optimizer then runs alike on every rank; SpecAugment,
the waveform noise and dropout are drawn for the global batch and sliced,
so the ranks together compute one process's step on the whole batch.
With ``model_parallel_size`` > 1 each model rank holds its share of the
FFN and attention weights (`parallel.mesh.shard_module`), the gradient
norm sums the split leaves' squares over the model group, and Adafactor
computes the whole parameters' update (`train.optim`).  With
``seq_parallel`` the attention layers run Ulysses over the data group
(`parallel.sequence`).  ``shard_map_kernels`` is how the JAX package keeps
its kernels to a device's rows; here every rank's kernels see only its
rows anyway, and the field's engagement is counted
(`parallel.sequence.fallback_stats`).  `Trainer.evaluate` and
`Trainer.generate_labels` gather their results (`parallel.multihost`);
checkpoints are written whole by rank 0.

Not ported, as TPU scheduler workarounds: the ``optimization_barrier``
fence between the augment and train halves and the hardware-RNG dropout
key.

Shallow LM fusion: ``lm_apply`` (context ids → LM logits, e.g.
`models.lm.make_pron_lm_apply`) given to `make_eval_step`,
`make_eval_beam_step` or `Trainer` adds ``lm_weight`` times the LM's
log-probs to the model's (`models.lm.shallow_fusion`) before the CTC loss
and the decode; the CTC takes the fused scores as they are, unnormalised.

Phase spans: `Trainer.train`, `Trainer.generate_labels` and the train and
predict steps mark their phases with `utils.profiling.annotate`, which
records only while a ``torch.profiler`` records (the span names are listed
there).
"""

from __future__ import annotations

import dataclasses
import itertools
import os
import time
from typing import Callable, Dict, Iterable, List, Optional, Tuple

import numpy as np
import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import (
    FeatureConfig,
    MeshConfig,
    SpecAugmentConfig,
    TrainConfig,
)
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import Batch, BucketedDataset
from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import gather_rows
from nn_conformer_for_speech_recognition_tpu_torch.data.native_loader import PrefetchIterator
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
from nn_conformer_for_speech_recognition_tpu_torch.models.conformer import MaskedBatchNorm
from nn_conformer_for_speech_recognition_tpu_torch.models.lm import shallow_fusion
from nn_conformer_for_speech_recognition_tpu_torch.ops.ctc import ctc_loss
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.ctc import ctc_loss_kernel
from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import ctc_beam_search, greedy_decode
from nn_conformer_for_speech_recognition_tpu_torch.ops.features import frame_lengths_of, make_featurizer
from nn_conformer_for_speech_recognition_tpu_torch.ops.specaugment import (
    add_gaussian_noise,
    apply_specaugment,
    draw_specaugment,
    specaugment,
)
from nn_conformer_for_speech_recognition_tpu_torch.parallel import multihost as MH
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import (
    Axis,
    DataShard,
    Mesh,
    all_reduce_,
    all_reduce_sum,
    batch_rows,
    broadcast_module,
    check_mesh,
    is_main_process,
    process_group_active,
    shard_module,
    tensor_parallel_plan,
    unshard_module,
)
from nn_conformer_for_speech_recognition_tpu_torch.parallel.sequence import (
    kernel_sharding_applicable,
    sequence_mesh_engaged,
    set_sequence_mesh,
)
from nn_conformer_for_speech_recognition_tpu_torch.train import metrics as M
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import (
    CheckpointManager,
    restore_encoder_params,
    restore_state,
    save_state,
)
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState
from nn_conformer_for_speech_recognition_tpu_torch.utils.profiling import annotate


def _select_ctc(ctc_impl: str) -> Callable[..., torch.Tensor]:
    """'auto' and 'pallas' → the alpha/beta kernels (their plain twins on
    the CPU); 'xla' → the plain recursion differentiated by autograd."""
    if ctc_impl in ("auto", "pallas"):
        return ctc_loss_kernel
    if ctc_impl != "xla":
        raise ValueError(f"unknown ctc_impl {ctc_impl!r}")
    return ctc_loss


def _batch_loss(
    ctc, log_probs, targets, out_lengths, target_lengths, blank_id, global_rows: bool = False,
    axis: Optional[Axis] = None,
) -> torch.Tensor:
    """Per-sequence CTC over the target length, averaged over the rows
    that have a target (``target_lengths > 0``).  With ``global_rows`` (a
    data-parallel rank's share of a batch) the count of such rows is
    summed over the data group ``axis`` (the world where None): each
    rank's loss is then its share of the global batch's mean, and a rank
    that holds only batch padding adds zero."""
    per_seq = ctc(log_probs, targets, out_lengths, target_lengths, blank_id=blank_id, reduction=None)
    w = (target_lengths > 0).to(per_seq.dtype)
    denom = torch.clamp_min(target_lengths, 1).to(per_seq.dtype)
    count = w.sum()
    if global_rows and (axis is None or axis.spread):
        count = all_reduce_sum(count, axis)
    return (per_seq / denom * w).sum() / torch.clamp_min(count, 1.0)


def all_reduce_gradients(model: torch.nn.Module, loss: torch.Tensor, axis: Optional[Axis] = None) -> torch.Tensor:
    """Sums every parameter's gradient, and the loss, over the data group
    ``axis`` (the world where None) in one all-reduce of a flat buffer;
    returns the global loss.

    Under tensor parallelism the split parameters' shares are summed over
    the data group, and the replicated parameters' gradients over every
    rank and divided by the model axis's size: each model rank computes its
    own copy of them, which library kernels that sum in no fixed order
    (cuDNN's float32 weight gradients) can leave a few ulps apart, and the
    mean makes them one, so that the model ranks' copies never drift."""
    named = list(model.named_parameters())
    missing = [name for name, p in named if p.grad is None]
    if missing:
        raise RuntimeError(f"no gradient for {missing[:4]}: every rank must reduce the same buffer")
    plan = tensor_parallel_plan(model)
    split = plan is not None and plan.axis.spread
    buckets = [([p.grad for n, p in named if not split or n not in plan.specs], None if split else axis,
                plan.axis.size if split else 1)]
    if split:
        buckets.append(([p.grad for n, p in named if n in plan.specs], axis, 1))
    total = loss
    for i, (grads, over, ranks) in enumerate(buckets):
        if over is not None and not over.spread:
            continue
        with_loss = [loss.detach().reshape(1).to(grads[0].dtype)] if i == 0 else []
        flat = all_reduce_(torch.cat([g.reshape(-1) for g in grads] + with_loss), over)
        if ranks > 1:
            flat /= ranks
        with torch.no_grad():  # one multi-tensor copy back, not one launch a parameter
            parts = torch.split(flat[:flat.numel() - len(with_loss)], [g.numel() for g in grads])
            torch._foreach_copy_(grads, [part.view_as(g) for g, part in zip(grads, parts)])
        if with_loss:
            total = flat[-1].to(loss.dtype)
    return total


def optax_global_norm(tensors: Iterable[torch.Tensor]) -> torch.Tensor:
    return torch.sqrt(sum(torch.sum(torch.square(x)) for x in tensors))


def gradient_norm(model: torch.nn.Module) -> torch.Tensor:
    """The global norm of the model's gradients.  Under tensor parallelism
    the squares of the split parameters' shares are summed over the model
    group and each replicated parameter counts once."""
    plan = tensor_parallel_plan(model)
    if plan is None:
        return optax_global_norm(p.grad for p in model.parameters())
    named = list(model.named_parameters())
    split = sum(torch.sum(torch.square(p.grad)) for n, p in named if n in plan.specs)
    whole = sum(torch.sum(torch.square(p.grad)) for n, p in named if n not in plan.specs)
    return torch.sqrt(all_reduce_(split, plan.axis) + whole)


def make_augment_step(
    feat_cfg: FeatureConfig,
    sa_cfg: SpecAugmentConfig,
    use_specaugment: bool = True,
    noise_std: float = 0.0,
    shard: Optional[DataShard] = None,
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor]]:
    """Returns ``augment(generator, audio, audio_lengths, batch_lengths=None)
    → (features, frame_lengths)``: optional waveform noise, log-mel features
    (the STFT kernel on CUDA), SpecAugment, all drawn from ``generator``.
    With ``shard`` the audio is that rank's rows of a global batch whose
    (B,) sample counts are ``batch_lengths``: the noise and the SpecAugment
    draws are made for the global batch from the generator, which every
    rank advances alike, and the rank's rows of them are applied."""
    featurize = make_featurizer(feat_cfg)

    @torch.no_grad()
    def augment(generator, audio, audio_lengths, batch_lengths=None):
        with annotate("train.augment"):
            batch = None if shard is None else batch_lengths.shape[0]
            rows = slice(None) if shard is None else shard.rows(batch)
            if noise_std > 0.0:
                audio = add_gaussian_noise(audio, generator, noise_std, batch=batch, rows=rows)
            feats, frame_lengths = featurize(audio, audio_lengths)
            if use_specaugment and shard is None:
                feats = specaugment(feats, frame_lengths, sa_cfg, generator)
            elif use_specaugment:
                draws = draw_specaugment(frame_lengths_of(batch_lengths, feat_cfg), feats.shape[2], sa_cfg,
                                         generator)
                feats = apply_specaugment(feats, frame_lengths, draws.rows(rows), sa_cfg)
            return feats, frame_lengths

    return augment


def make_feature_train_step(
    model: ConformerCTC,
    blank_id: int,
    ctc_impl: str = "auto",
    emit_ids: bool = False,
    pad_id: int = 0,
    shard: Optional[DataShard] = None,
    mesh: Optional[Mesh] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """Returns ``train_step(state, feats, frame_lengths, targets,
    target_lengths) → (state, metrics)``: forward in train mode, CTC loss,
    backward, one optimizer update.  ``metrics`` holds ``loss`` and
    ``grad_norm`` (of the gradients before the update), and with
    ``emit_ids`` the greedy ids of the training forward and their lengths.
    Dropout draws from the device generator seeded by
    ``state.dropout_seed()``; the global RNG state is restored after.

    With ``shard`` (data parallelism) the inputs are that rank's rows of a
    global batch: the loss divides by the global count of rows with a
    target, the gradients and the loss are summed over the process group
    after the backward (one all-reduce), so the update, the norm and the
    reported loss are the global batch's on every rank; the dropout seed
    folds in the rank.  ``mesh`` names the data group those sums run over
    (the world without one); the ranks of a model group share a data rank,
    so they draw the same dropout masks."""
    ctc = _select_ctc(ctc_impl)
    rank = 0 if shard is None else shard.rank
    axis = None if mesh is None else mesh.data

    def train_step(state: TrainState, feats, frame_lengths, targets, target_lengths):
        if state.model is not model:
            raise ValueError("train_step: state.model is not the model the step was made for")
        devices = [feats.device] if feats.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            with annotate("train.forward"):
                model.train()
                model.zero_grad(set_to_none=True)
                torch.manual_seed(state.dropout_seed(rank))
                log_probs, out_lengths = model(feats, frame_lengths)
                loss = _batch_loss(ctc, log_probs, targets, out_lengths, target_lengths, blank_id,
                                   global_rows=shard is not None, axis=axis)
            with annotate("train.backward"):
                loss.backward()
                if shard is not None:
                    loss = all_reduce_gradients(model, loss, axis)
        with annotate("train.grad_norm"):
            grad_norm = gradient_norm(model)
        with annotate("train.optimizer"):
            state.apply_gradients()
        metrics = {"loss": loss.detach(), "grad_norm": grad_norm}
        if emit_ids:
            with annotate("train.greedy"):
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
    shard: Optional[DataShard] = None,
    mesh: Optional[Mesh] = None,
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``train_step(state, audio, audio_lengths, targets, target_lengths,
    batch_lengths=None) → (state, metrics)``: `make_augment_step` (drawing
    from ``state.generator``) then `make_feature_train_step`; with
    ``shard``, on that rank's rows of a global batch whose sample counts
    are ``batch_lengths``."""
    augment = make_augment_step(feat_cfg, sa_cfg, use_specaugment, noise_std, shard=shard)
    core = make_feature_train_step(model, blank_id, ctc_impl, emit_ids=emit_ids, pad_id=pad_id, shard=shard,
                                   mesh=mesh)

    def train_step(state: TrainState, audio, audio_lengths, targets, target_lengths, batch_lengths=None):
        feats, frame_lengths = augment(state.generator, audio, audio_lengths, batch_lengths)
        return core(state, feats, frame_lengths, targets, target_lengths)

    return train_step


def make_epoch_scan_step(
    model: ConformerCTC,
    feat_cfg: FeatureConfig,
    sa_cfg: SpecAugmentConfig,
    blank_id: int,
    use_specaugment: bool = True,
    noise_std: float = 0.0,
    ctc_impl: str = "auto",
    batch_sharding: Optional[DataShard] = None,
    emit_ids: bool = False,
    pad_id: int = 0,
    mesh: Optional[Mesh] = None,
) -> Callable[..., Tuple[TrainState, Tuple[torch.Tensor, ...]]]:
    """Returns ``epoch(state, audio, alen, targets, tlen, order) → (state,
    (losses, sizes[, ids]))``: the train steps of an epoch over
    device-resident tensors (`data/device_cache.DeviceResidentDataset`).
    ``order`` is the (steps, B) int32 index tensor on the device (-1: a
    batch-padding row, `DeviceResidentDataset.order_matrix`); each row is
    gathered on the device (`gather_rows`) and taken by one `make_train_step`
    step.  The outputs stay on the device: (steps,) losses, (steps,)
    valid-row counts (the weights of the epoch's mean loss) and, with
    ``emit_ids``, the (steps, B, T') greedy ids of the training forwards.
    Nothing is pulled to the host, so an epoch on the card is queued
    without a wait; a call over one row at a time runs the same operations
    in the same order as one call over all of them.

    ``batch_sharding`` (a `parallel.mesh.DataShard`, data parallelism):
    every rank holds the whole resident corpus and the same order, and
    gathers its rows of each order row; the sample counts of the whole row
    go to the augment step (the global batch's draws), the losses are the
    global batch's and ``ids`` the rank's rows'."""
    if batch_sharding is not None and not isinstance(batch_sharding, DataShard):
        raise TypeError(f"batch_sharding must be a parallel.mesh.DataShard, got {type(batch_sharding).__name__}")
    step = make_train_step(model, feat_cfg, sa_cfg, blank_id, use_specaugment=use_specaugment, noise_std=noise_std,
                           ctc_impl=ctc_impl, emit_ids=emit_ids, pad_id=pad_id, shard=batch_sharding, mesh=mesh)

    def epoch(state: TrainState, audio, alen, targets, tlen, order):
        losses, sizes, ids = [], [], []
        for idx in order:
            with annotate("train.gather"):
                sizes.append((idx >= 0).sum())
                if batch_sharding is None:
                    batch = gather_rows(audio, alen, targets, tlen, idx)
                else:
                    batch_lengths = alen.index_select(0, torch.clamp_min(idx, 0)) * (idx >= 0)
                    local = gather_rows(audio, alen, targets, tlen, idx[batch_sharding.rows(idx.shape[0])])
                    batch = (*local, batch_lengths)
            state, metrics = step(state, *batch)
            losses.append(metrics["loss"])
            if emit_ids:
                ids.append(metrics["ids"])
        return state, (torch.stack(losses), torch.stack(sizes), *((torch.stack(ids),) if emit_ids else ()))

    return epoch


def make_eval_step(
    model: ConformerCTC,
    feat_cfg: FeatureConfig,
    blank_id: int,
    pad_id: int,
    lm_apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    lm_weight: float = 0.3,
    ctc_impl: str = "auto",
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns ``eval_step(audio, audio_lengths, targets, target_lengths)
    → (loss, ids, out_lengths)``: eval-mode forward, with ``lm_apply``
    shallow LM fusion, the train step's loss, greedy ids (``pad_id`` beyond
    each row's length)."""
    featurize = make_featurizer(feat_cfg)
    ctc = _select_ctc(ctc_impl)

    @torch.inference_mode()
    def eval_step(audio, audio_lengths, targets, target_lengths):
        model.eval()
        feats, frame_lengths = featurize(audio, audio_lengths)
        log_probs, out_lengths = model(feats, frame_lengths)
        if lm_apply is not None:
            log_probs = shallow_fusion(log_probs, lm_apply, lm_weight)
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
        with annotate("label.forward"):
            model.eval()
            feats, frame_lengths = featurize(audio, audio_lengths)
            log_probs, out_lengths = model(feats, frame_lengths)
            return greedy_decode(log_probs, out_lengths, pad_id=pad_id), out_lengths

    return predict_step


def make_beam_step(
    model: ConformerCTC,
    feat_cfg: FeatureConfig,
    blank_id: int,
    beam: int = 8,
    prune: int = 16,
    max_label_len: int = 64,
) -> Callable[[torch.Tensor, torch.Tensor], Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns ``beam_step(audio, audio_lengths) → (tokens (B,
    max_label_len) padded with -1, lengths (B,), scores (B,))``: the 1-best
    of `ops/decode.ctc_beam_search` over an eval-mode forward."""
    featurize = make_featurizer(feat_cfg)

    @torch.inference_mode()
    def beam_step(audio, audio_lengths):
        model.eval()
        feats, frame_lengths = featurize(audio, audio_lengths)
        log_probs, out_lengths = model(feats, frame_lengths)
        toks, lens, scores = ctc_beam_search(
            log_probs, out_lengths, blank_id=blank_id, beam=beam, prune=prune, max_label_len=max_label_len)
        return toks[:, 0], lens[:, 0], scores[:, 0]

    return beam_step


def make_eval_beam_step(
    model: ConformerCTC,
    feat_cfg: FeatureConfig,
    blank_id: int,
    beam: int = 8,
    prune: int = 16,
    max_label_len: int = 64,
    lm_apply: Optional[Callable[[torch.Tensor], torch.Tensor]] = None,
    lm_weight: float = 0.3,
    ctc_impl: str = "auto",
) -> Callable[..., Tuple[torch.Tensor, torch.Tensor, torch.Tensor]]:
    """Returns ``step(audio, audio_lengths, targets, target_lengths) →
    (loss, tokens (B, max_label_len), lengths (B,))``: the eval step's loss
    and the beam search's 1-best from the log-probs of one forward (fused
    with the LM's where ``lm_apply`` is given)."""
    featurize = make_featurizer(feat_cfg)
    ctc = _select_ctc(ctc_impl)

    @torch.inference_mode()
    def step(audio, audio_lengths, targets, target_lengths):
        model.eval()
        feats, frame_lengths = featurize(audio, audio_lengths)
        log_probs, out_lengths = model(feats, frame_lengths)
        if lm_apply is not None:
            log_probs = shallow_fusion(log_probs, lm_apply, lm_weight)
        loss = _batch_loss(ctc, log_probs, targets, out_lengths, target_lengths, blank_id)
        toks, lens, _ = ctc_beam_search(
            log_probs, out_lengths, blank_id=blank_id, beam=beam, prune=prune, max_label_len=max_label_len)
        return loss, toks[:, 0], lens[:, 0]

    return step


def _wer_words(refs: List[str], hyps: List[str], protocol: str) -> int:
    """The word count a WER protocol divides by (`train.metrics`): the
    references' words, or under 'padded' the longer of each pair's."""
    if protocol == "padded":
        return sum(max(len(r.split()), len(h.split())) for r, h in zip(refs, hyps))
    return sum(len(r.split()) for r in refs)


def _in_order(texts: Dict[int, str]) -> List[str]:
    return [texts[k] for k in sorted(texts)]


def mean_of_steps(losses: List[torch.Tensor]) -> float:
    """The mean of per-step losses, pulled from the device at once and
    summed on the host (the JAX trainers' ``total += float(loss)``)."""
    pulled = torch.stack(losses).cpu().numpy() if losses else np.zeros((0,), np.float32)
    return sum(float(x) for x in pulled) / max(len(pulled), 1)


def setup_layout(mesh, mesh_cfg: MeshConfig) -> Tuple[Mesh, Optional[DataShard]]:
    """A trainer's layout: ``mesh`` (a `parallel.mesh.Mesh`) or the one
    ``mesh_cfg`` lays over the process group (`parallel.mesh.check_mesh`
    raises for anything else), and the data rank's `DataShard` (None
    without a process group).  ``seq_parallel`` activates Ulysses over the
    data axis from now on, as the JAX trainers do at construction."""
    mesh = check_mesh(mesh, mesh_cfg)
    shard = DataShard(mesh.data.rank, mesh.data.size) if process_group_active() else None
    if mesh_cfg.seq_parallel:
        set_sequence_mesh(mesh, mesh_cfg.data_axis)
    return mesh, shard


def init_split(model: torch.nn.Module, mesh: Mesh, shard: Optional[DataShard], init: Callable[[], None]):
    """Initialises ``model`` whole by ``init()`` (a split model is gathered
    whole first), gives every rank rank 0's parameters and buffers, then
    splits it over the model axis (`parallel.mesh.shard_module`); returns
    the plan, None without tensor parallelism.  The ranks of a model group
    start from the weights one process starts from."""
    if tensor_parallel_plan(model) is not None:
        unshard_module(model)
    init()
    if shard is not None:
        broadcast_module(model)
    return shard_module(model, mesh)


def resolve_device(device=None) -> torch.device:
    """The first CUDA device, unless the caller names another; where a CUDA
    device is wanted (by default, or by name) and there is none this raises
    rather than run on the CPU.  Under ``torchrun`` the current device is
    the rank's card (`parallel.mesh.initialize_multihost` set it)."""
    if device is not None and torch.device(device).type != "cuda":
        return torch.device(device)
    if not torch.cuda.is_available():
        raise RuntimeError("no CUDA device found; pass device='cpu' to run on the CPU")
    wanted = torch.device("cuda" if device is None else device)
    return torch.device("cuda", torch.cuda.current_device() if wanted.index is None else wanted.index)


class Trainer:
    """Host-side orchestration: epochs, metrics, checkpoints, NST labelling.

    ``model`` is moved to ``device`` (the first CUDA device by default;
    ``device="cpu"`` for the CPU).  ``lm_apply`` and ``lm_weight`` fuse an
    LM into `evaluate` (both decodes), as in `make_eval_step`.  The train state lives in the model (its
    parameters and batch statistics), the optimizer and `TrainState`;
    assigning a state that holds another model (a deep copy kept by
    `run_nst`) makes that model the trainer's.

    Under a process group (``torchrun``, `parallel.mesh.initialize_multihost`)
    the trainer trains over its ranks, one card each, as the JAX trainer
    trains over every device it sees: each rank reads the same global
    batches and computes on its data rank's share of the rows, with
    ``mesh_cfg``'s tensor and sequence parallelism, and only rank 0 logs.
    ``mesh`` is a `parallel.mesh.Mesh` (`parallel.mesh.make_mesh`), by
    default the one ``mesh_cfg`` lays over the process group.
    """

    def __init__(
        self,
        model: ConformerCTC,
        vocab,
        feat_cfg: FeatureConfig,
        train_cfg: TrainConfig,
        mesh_cfg: MeshConfig = MeshConfig(),
        learning_rate: Optional[float] = None,
        mesh=None,
        log_fn: Callable[[str], None] = print,
        lm_apply=None,
        lm_weight: float = 0.3,
        device=None,
    ):
        self.device = resolve_device(device)
        # the layout, and the data rank's share of every batch (None without a process group)
        self.mesh, self.shard = setup_layout(mesh, mesh_cfg)
        self.vocab = vocab
        self.feat_cfg = feat_cfg
        self.train_cfg = train_cfg
        self.mesh_cfg = mesh_cfg
        self.log = log_fn if is_main_process() else (lambda _: None)
        self.lm_apply, self.lm_weight = lm_apply, lm_weight
        self.opt_cfg = train_cfg.optimizer
        if learning_rate is not None:
            self.opt_cfg = dataclasses.replace(self.opt_cfg, learning_rate=learning_rate)
        self._state: Optional[TrainState] = None
        self._auto_ckpt: Optional[CheckpointManager] = None
        self.history: Dict[str, List[float]] = {"train_loss": [], "train_wer": [], "val_loss": [], "val_wer": []}
        self._bind(model.to(self.device))

    def _bind(self, model: ConformerCTC) -> None:
        """Makes ``model`` the trainer's and builds the steps over it."""
        self.model = model
        blank, pad = self.vocab.blank_id, self.vocab.pad_id
        cfg = self.train_cfg
        self._train_core = make_feature_train_step(
            model, blank, ctc_impl=cfg.ctc_impl, emit_ids=cfg.train_wer, pad_id=pad, shard=self.shard,
            mesh=self.mesh)
        # composed (augment ∘ core) steps, keyed by (use_specaugment,
        # noise_std), so that a caller (the NST retrain) can override the
        # augmentation per train() call
        self._step_cache: Dict[Tuple[bool, float], Callable] = {}
        lm = dict(lm_apply=self.lm_apply, lm_weight=self.lm_weight)
        self._eval_step = make_eval_step(model, self.feat_cfg, blank, pad, ctc_impl=cfg.ctc_impl, **lm)
        self._eval_beam_step = make_eval_beam_step(
            model, self.feat_cfg, blank, beam=cfg.beam, prune=cfg.prune, max_label_len=cfg.max_label_len,
            ctc_impl=cfg.ctc_impl, **lm)
        self._predict_step = make_predict_step(model, self.feat_cfg, pad)
        self._epoch_scans: Dict[Tuple[bool, float], Callable] = {}  # `_epoch_scan_fn`'s, over this model

    @property
    def state(self) -> Optional[TrainState]:
        return self._state

    @state.setter
    def state(self, state: Optional[TrainState]) -> None:
        if state is not None and state.model is not self.model:
            self._bind(state.model)
        self._state = state

    def _require_state(self) -> TrainState:
        if self._state is None:
            raise RuntimeError("call init_state() first")
        return self._state

    # ------------------------------------------------------------------ init

    def init_state(self, seed: int = 0, example: Optional[Batch] = None, variables=None) -> TrainState:
        """A fresh train state: parameters drawn from ``seed`` (or taken from
        ``variables``, the ``{"params", "batch_stats"}`` of the JAX package's
        model, converted), batch statistics at their start values, a new
        optimizer.  ``example`` is accepted for the JAX package's signature;
        no shape needs tracing here.  Under a process group every rank then
        takes rank 0's parameters and batch statistics, and under tensor
        parallelism keeps its model rank's share of them."""
        del example

        def init():
            if variables is not None:
                self.model.load_state_dict(flax_to_state_dict(variables, self.model.config), strict=True)
                return
            init_params(self.model, torch.Generator().manual_seed(seed))
            with torch.no_grad():
                for m in self.model.modules():
                    if isinstance(m, MaskedBatchNorm):
                        m.running_mean.zero_()
                        m.running_var.fill_(1.0)

        plan = init_split(self.model, self.mesh, self.shard, init)
        optimizer = make_optimizer(self.opt_cfg, self.model.named_parameters(), plan)
        self._state = TrainState.create(self.model, optimizer, seed)
        return self._state

    def _local(self, batch: Batch) -> Batch:
        """The rank's rows of a global batch (the batch itself without a
        process group).  Under ``shard_map_kernels`` the split is counted
        as the JAX package's kernel sharding counts it."""
        if self.mesh_cfg.shard_map_kernels:
            kernel_sharding_applicable(self.mesh, self.mesh_cfg.data_axis, len(batch.indices))
        return batch if self.shard is None else batch_rows(batch, self.shard.rank, self.shard.world)

    def _batch_lengths(self, batch: Batch) -> Optional[torch.Tensor]:
        """The (B,) sample counts of the whole global batch on the device,
        for the data-parallel augment step's draws; None without a process
        group."""
        if self.shard is None:
            return None
        x = batch.audio_lengths
        return x if isinstance(x, torch.Tensor) else torch.from_numpy(np.ascontiguousarray(x, np.int32)).to(self.device)

    def _put(self, batch: Batch):
        """The batch's arrays on the trainer's device: host arrays copied
        there, tensors of a resident batch (already there) as they are."""

        def put(x, dtype):
            if isinstance(x, torch.Tensor):
                if x.device != self.device:
                    raise ValueError(f"a batch on {x.device} given to a trainer on {self.device}")
                return x
            return torch.from_numpy(np.ascontiguousarray(x, dtype=dtype)).to(self.device)

        return (put(batch.audio, None), put(batch.audio_lengths, np.int32), put(batch.targets, None),
                put(batch.target_lengths, np.int32))

    def _composed_step(self, sa: bool, noise_std: float):
        """(augment ∘ core) step for the given augmentation settings, cached
        per (sa, noise_std)."""
        key = (bool(sa), float(noise_std))
        if key not in self._step_cache:
            augment = make_augment_step(self.feat_cfg, self.train_cfg.specaugment,
                                        use_specaugment=key[0], noise_std=key[1], shard=self.shard)
            core = self._train_core

            def step(state, audio, audio_lengths, targets, target_lengths, batch_lengths=None):
                feats, frame_lengths = augment(state.generator, audio, audio_lengths, batch_lengths)
                return core(state, feats, frame_lengths, targets, target_lengths)

            self._step_cache[key] = step
        return self._step_cache[key]

    def _resolve_noise(self, add_noise: Optional[bool], noise_std: Optional[float]) -> float:
        on = self.train_cfg.add_noise if add_noise is None else add_noise
        if not on:
            return 0.0
        return self.train_cfg.noise_std if noise_std is None else noise_std

    # ----------------------------------------------------------------- train

    def train(
        self,
        dataset: BucketedDataset,
        epochs: int,
        val_dataset: Optional[BucketedDataset] = None,
        use_specaugment: Optional[bool] = None,
        epoch_offset: int = 0,
        checkpoint_manager=None,
        add_noise: Optional[bool] = None,
        noise_std: Optional[float] = None,
        start_step: int = 0,
    ) -> Dict[str, List[float]]:
        """Epoch loop; with ``checkpoint_manager`` a rotated checkpoint is
        written per epoch, keyed best-by-val-loss.  If
        ``TrainConfig.checkpoint_dir`` is set and no manager is passed, one
        is created there (rotation = ``keep_checkpoints``).
        ``add_noise``/``noise_std`` override the config's waveform-noise
        augmentation per call (`run_nst`'s noisy-student knob).

        Epoch ``e`` draws its batches from ``dataset.epoch(seed =
        train_cfg.seed + epoch_offset + e)``.  ``start_step`` skips that
        many batches of the FIRST epoch: the resume cursor written by
        ``TrainConfig.checkpoint_every_steps`` checkpoints (the stream is a
        function of the seed, so skip-and-continue reproduces an
        uninterrupted run exactly; see `resume`).

        Per-step losses stay on the device and are pulled once per epoch: a
        ``.item()`` per step would serialise the host against the device.

        A device-resident dataset (`data/device_cache.DeviceResidentDataset`)
        goes through the epoch step of `train_device_epochs`, one order row
        a call: the same operations in the same order, so the two give
        bit-equal losses and state."""
        self._require_state()
        sa = self.train_cfg.use_specaugment if use_specaugment is None else use_specaugment
        noise = self._resolve_noise(add_noise, noise_std)
        checkpoint_manager = self._auto_ckpt_manager(checkpoint_manager)
        if hasattr(dataset, "device_arrays"):
            return self._train_resident(
                dataset, epochs, val_dataset=val_dataset, use_specaugment=sa, epoch_offset=epoch_offset,
                checkpoint_manager=checkpoint_manager, fused=False, noise_std=noise, start_step=start_step)
        step_fn = self._composed_step(sa, noise)
        want_wer = self.train_cfg.train_wer
        log_every = self.train_cfg.log_every
        num_batches = dataset.num_batches() if hasattr(dataset, "num_batches") else None
        ckpt_every = self.train_cfg.checkpoint_every_steps

        for epoch in range(epochs):
            t0 = time.time()
            losses = M.Mean()
            nan_steps = 0
            audio_seconds = 0.0
            stream = dataset.epoch(seed=self.train_cfg.seed + epoch_offset + epoch)
            skip = start_step if epoch == 0 else 0
            if skip:
                stream = itertools.islice(stream, skip, None)
            step_losses, step_sizes = [], []
            step_ids = []  # (ids on the device, indices) when train_wer is on
            step_i = skip
            batches = PrefetchIterator(stream)
            while True:
                with annotate("train.data_wait"):
                    batch = next(batches, None)
                if batch is None:  # the epoch's end
                    break
                with annotate("train.put"):
                    local = self._local(batch)
                    audio, alen, tgt, tlen = self._put(local)
                    batch_lengths = self._batch_lengths(batch)
                self.state, metrics = step_fn(self.state, audio, alen, tgt, tlen, batch_lengths)
                step_losses.append(metrics["loss"])
                step_sizes.append(batch.size)
                if want_wer:
                    step_ids.append((metrics["ids"], local.indices.copy()))
                audio_seconds += float(batch.audio_lengths.sum()) / self.feat_cfg.sample_rate
                step_i += 1
                if ckpt_every and checkpoint_manager is not None and step_i % ckpt_every == 0:
                    checkpoint_manager.save(
                        self.state, iterator={"epoch": epoch_offset + epoch, "step": step_i})
                if log_every and step_i % log_every == 0:
                    # progress note without a device sync (no loss pull)
                    total = f"/{num_batches}" if num_batches else ""
                    self.log(f"  epoch {epoch_offset + epoch} step {step_i}{total} "
                             f"({audio_seconds / max(time.time() - t0, 1e-9):.1f} audio-s/s)")
            with annotate("train.pull"):
                pulled = torch.stack(step_losses).cpu().numpy() if step_losses else np.zeros((0,), np.float32)
            with annotate("train.epilogue"):
                for loss, size in zip(pulled, step_sizes):
                    if np.isnan(loss):
                        nan_steps += 1
                    else:
                        losses.update(float(loss), size)
                dt = time.time() - t0
                self.history["train_loss"].append(losses.result())
                msg = (f"epoch {epoch_offset + epoch}: loss={losses.result():.4f} "
                       f"({audio_seconds / max(dt, 1e-9):.1f} audio-s/s)")
                if want_wer:
                    twer = self._train_wer_from_steps(dataset, step_ids)
                    self.history["train_wer"].append(twer)
                    msg += f" train_wer={100 * twer:.2f}"
                if nan_steps:
                    msg += f" [{nan_steps} NaN steps]"
                if val_dataset is not None:
                    vloss, vwer = self.evaluate(val_dataset)
                    self.history["val_loss"].append(vloss)
                    self.history["val_wer"].append(vwer)
                    msg += f" val_loss={vloss:.4f} val_wer={100 * vwer:.2f}"
                self.log(msg)
                if checkpoint_manager is not None:
                    metric = self.history["val_loss"][-1] if val_dataset is not None else None
                    checkpoint_manager.save(
                        self.state, metric=metric, iterator={"epoch": epoch_offset + epoch + 1, "step": 0})
        return self.history

    def resume(
        self,
        dataset: BucketedDataset,
        epochs: int,
        val_dataset: Optional[BucketedDataset] = None,
        checkpoint_manager=None,
        **train_kwargs,
    ) -> Dict[str, List[float]]:
        """Resume an interrupted `train(dataset, epochs, ...)` run from the
        newest checkpoint, including a MID-EPOCH cursor written by
        ``TrainConfig.checkpoint_every_steps``: restores the full train
        state and skips the already-consumed batches of the interrupted
        epoch, so the completed run's parameters equal an uninterrupted
        run's.  After a mid-epoch resume ``history["train_loss"][0]``
        averages only the steps after the cursor."""
        manager = self._auto_ckpt_manager(checkpoint_manager)
        if manager is None:
            raise ValueError("resume needs a checkpoint manager or TrainConfig.checkpoint_dir")
        state, it = manager.restore_latest_with_iterator(self._require_state())
        if state is None:
            return self.train(dataset, epochs, val_dataset=val_dataset, checkpoint_manager=manager, **train_kwargs)
        self.state = state
        start_epoch = it["epoch"] if it else 0
        start_step = it["step"] if it else 0
        if start_epoch >= epochs and start_step == 0:
            return self.history
        return self.train(
            dataset, epochs - start_epoch, val_dataset=val_dataset, epoch_offset=start_epoch,
            checkpoint_manager=manager, start_step=start_step, **train_kwargs,
        )

    def _auto_ckpt_manager(self, checkpoint_manager):
        if checkpoint_manager is None and self.train_cfg.checkpoint_dir:
            if self._auto_ckpt is None:
                self._auto_ckpt = CheckpointManager(
                    self.train_cfg.checkpoint_dir, keep=self.train_cfg.keep_checkpoints)
            return self._auto_ckpt
        return checkpoint_manager

    def _train_wer_from_steps(self, dataset, step_ids) -> float:
        """Corpus WER of the training forward's greedy decodes, pulled at
        epoch end; under a process group each rank scores its rows and the
        WERs are reduced weighted by their reference words."""
        refs: List[str] = []
        hyps: List[str] = []
        for ids_dev, indices in step_ids:
            ids = ids_dev.cpu().numpy()
            for row, idx in enumerate(indices):
                if idx < 0:
                    continue
                refs.append(dataset.utterances[int(idx)].transcript)
                hyps.append(self.vocab.decode_ids(ids[row]))
        if self.shard is not None:
            words = _wer_words(refs, hyps, "standard")
            twer, total = MH.gather_metric(M.wer(refs, hyps), words)
            return twer if total else float("nan")
        return M.wer(refs, hyps) if refs else float("nan")

    def _epoch_scan_fn(self, use_specaugment: Optional[bool] = None, noise_std: float = 0.0):
        """`make_epoch_scan_step` over the trainer's model, cached per
        (use_specaugment, noise_std)."""
        sa = self.train_cfg.use_specaugment if use_specaugment is None else use_specaugment
        key = (bool(sa), float(noise_std))
        if key not in self._epoch_scans:
            cfg = self.train_cfg
            self._epoch_scans[key] = make_epoch_scan_step(
                self.model, self.feat_cfg, cfg.specaugment, self.vocab.blank_id, use_specaugment=key[0],
                noise_std=key[1], ctc_impl=cfg.ctc_impl, batch_sharding=self.shard, emit_ids=cfg.train_wer,
                pad_id=self.vocab.pad_id, mesh=self.mesh)
        return self._epoch_scans[key]

    def _upload_order(self, order: np.ndarray) -> torch.Tensor:
        """An epoch's order matrix on the device: on the card one copy from
        pinned memory, queued without a wait."""
        host = torch.from_numpy(np.ascontiguousarray(order))
        if self.device.type != "cuda":
            return host.to(self.device)
        return host.pin_memory().to(self.device, non_blocking=True)

    def train_device_epochs(
        self,
        dataset,
        epochs: int,
        val_dataset: Optional[BucketedDataset] = None,
        use_specaugment: Optional[bool] = None,
        epoch_offset: int = 0,
        checkpoint_manager=None,
        add_noise: Optional[bool] = None,
        noise_std: Optional[float] = None,
        start_step: int = 0,
    ) -> Dict[str, List[float]]:
        """Epoch loop over a `DeviceResidentDataset`, one call of
        `make_epoch_scan_step` an epoch: the host uploads the epoch's order
        matrix and pulls the per-step losses once the epoch is queued;
        nothing else crosses.  Bit-equal to `train` over the same dataset,
        with the same per-epoch validation and checkpoints.  With
        ``TrainConfig.checkpoint_every_steps`` and a checkpoint manager the
        epoch runs in chunks of that many steps, so that the mid-epoch
        cursors can be written."""
        return self._train_resident(
            dataset, epochs, val_dataset=val_dataset, use_specaugment=use_specaugment, epoch_offset=epoch_offset,
            checkpoint_manager=self._auto_ckpt_manager(checkpoint_manager), fused=True,
            noise_std=self._resolve_noise(add_noise, noise_std), start_step=start_step)

    def _train_resident(
        self,
        dataset,
        epochs: int,
        val_dataset: Optional[BucketedDataset] = None,
        use_specaugment: Optional[bool] = None,
        epoch_offset: int = 0,
        checkpoint_manager=None,
        fused: bool = True,
        noise_std: float = 0.0,
        start_step: int = 0,
    ) -> Dict[str, List[float]]:
        """The epoch loop over device-resident tensors.  ``fused=True``
        calls the epoch step once an epoch (or once a chunk of
        ``checkpoint_every_steps`` where mid-epoch cursors are written);
        ``fused=False`` once an order row.  ``start_step`` drops the first
        epoch's consumed rows (the resume cursor; the order is a function
        of the seed), and ``TrainConfig.train_wer`` scores the ids the
        epoch step emits."""
        self._require_state()
        epoch_fn = self._epoch_scan_fn(use_specaugment, noise_std)
        arrays = dataset.device_arrays()
        want_wer = self.train_cfg.train_wer
        ckpt_every = self.train_cfg.checkpoint_every_steps
        alen_host = None  # one host copy, for the audio-seconds of every epoch
        sample_rate = self.feat_cfg.sample_rate
        for epoch in range(epochs):
            with annotate("train.order"):
                t0 = time.time()
                if alen_host is None:
                    alen_host = arrays[1].cpu().numpy()
                order = dataset.order_matrix(seed=self.train_cfg.seed + epoch_offset + epoch)
                skip = start_step if epoch == 0 else 0
                order = order[skip:]
                audio_seconds = float(alen_host[order[order >= 0]].sum()) / sample_rate
                if not fused:
                    chunk = 1
                elif ckpt_every and checkpoint_manager is not None:
                    chunk = ckpt_every
                else:
                    chunk = max(order.shape[0], 1)
                order_dev = self._upload_order(order)
            step_out = []
            step_i = skip
            for s0 in range(0, order.shape[0], chunk):
                self.state, out = epoch_fn(self.state, *arrays, order_dev[s0 : s0 + chunk])
                step_out.append(out)
                step_i += min(chunk, order.shape[0] - s0)
                if ckpt_every and checkpoint_manager is not None and step_i % ckpt_every == 0:
                    checkpoint_manager.save(self.state, iterator={"epoch": epoch_offset + epoch, "step": step_i})
            with annotate("train.pull"):
                outs = [torch.cat([o[i] for o in step_out]).cpu() for i in range(len(step_out[0]))] if step_out else []
            with annotate("train.epilogue"):
                losses, sizes = (outs[0].numpy(), outs[1].numpy()) if outs else (np.zeros((0,), np.float32),) * 2
                dt = time.time() - t0
                # the mean over the steps whose loss is not NaN, weighted by their valid rows (`train`'s M.Mean)
                ok = ~np.isnan(losses)
                wsum = float((sizes * ok).sum())
                mean_loss = float((losses[ok] * sizes[ok]).sum() / wsum) if wsum else float("nan")
                nan_steps = int((~ok).sum())
                self.history["train_loss"].append(mean_loss)
                msg = (f"epoch {epoch_offset + epoch}: loss={mean_loss:.4f} "
                       f"({audio_seconds / max(dt, 1e-9):.1f} audio-s/s{', fused epoch' if fused else ''})")
                if want_wer:
                    rows = order if self.shard is None else order[:, self.shard.rows(order.shape[1])]
                    twer = self._train_wer_from_steps(dataset, list(zip(outs[2], rows)) if outs else [])
                    self.history["train_wer"].append(twer)
                    msg += f" train_wer={100 * twer:.2f}"
                if nan_steps:
                    msg += f" [{nan_steps} NaN steps]"
                if val_dataset is not None:
                    vloss, vwer = self.evaluate(val_dataset)
                    self.history["val_loss"].append(vloss)
                    self.history["val_wer"].append(vwer)
                    msg += f" val_loss={vloss:.4f} val_wer={100 * vwer:.2f}"
                self.log(msg)
                if checkpoint_manager is not None:
                    metric = self.history["val_loss"][-1] if val_dataset is not None else None
                    checkpoint_manager.save(
                        self.state, metric=metric, iterator={"epoch": epoch_offset + epoch + 1, "step": 0})
        return self.history

    # ------------------------------------------------------------------ eval

    def evaluate(
        self,
        dataset: BucketedDataset,
        dump_path: Optional[str] = None,
        decode: str = "greedy",
        wer_protocol: str = "standard",
        return_texts: bool = False,
    ):
        """Mean loss and corpus WER over a split.  ``decode='greedy'`` is the
        per-frame argmax, ``decode='beam'`` the CTC prefix beam search
        (width, prune and label room from ``TrainConfig.beam / prune /
        max_label_len``), both from one forward per batch.
        ``wer_protocol='padded'`` scores with the '_'-padded alignment
        (`train/metrics.padded_wer`).  ``return_texts=True`` returns (loss,
        wer, refs, hyps).  ``dump_path`` receives the first prediction and
        its target.

        Under a process group each rank decodes its rows of every batch;
        the loss and the WER are reduced by `parallel.multihost.gather_metric`
        (weighted by rows, and by the words the protocol counts), and the
        texts, with ``return_texts``, gathered in the dataset's order."""
        self._require_state()
        if decode not in ("greedy", "beam"):
            raise ValueError(f"decode must be 'greedy' or 'beam', got {decode!r}")
        losses = M.Mean()
        refs: List[str] = []
        hyps: List[str] = []
        places: List[int] = []  # each text's row in the epoch, for the gather
        for number, batch in enumerate(dataset.epoch(shuffle=False)):
            local = self._local(batch)
            first = number * len(batch.indices) + (0 if self.shard is None else self.shard.rows(len(batch.indices)).start)
            if decode == "beam":
                loss, toks, lens = self._eval_beam_step(*self._put(local))
                toks, lens = toks.cpu().numpy(), lens.cpu().numpy()
                # the -1 padding beyond each hypothesis becomes the pad token
                ids = np.where(np.arange(toks.shape[1])[None, :] < lens[:, None], toks, self.vocab.pad_id)
            else:
                loss, ids, _ = self._eval_step(*self._put(local))
                ids = ids.cpu().numpy()
            losses.update(float(loss), local.size)
            for row, idx in enumerate(local.indices):
                if idx < 0:
                    continue
                refs.append(dataset.utterances[int(idx)].transcript)
                hyps.append(self.vocab.decode_ids(ids[row]))
                places.append(first + row)
        if dump_path and refs and is_main_process():
            os.makedirs(os.path.dirname(dump_path) or ".", exist_ok=True)
            with open(dump_path, "w", encoding="utf-8") as f:
                f.write(f"pred: {hyps[0]}\ntgt:  {refs[0]}\n")
        wer_fn = M.padded_wer if wer_protocol == "padded" else M.wer
        loss, wer = losses.result(), wer_fn(refs, hyps)
        if self.shard is not None:
            loss, _ = MH.gather_metric(loss, losses.count)
            wer, _ = MH.gather_metric(wer, _wer_words(refs, hyps, wer_protocol))
            if return_texts:
                refs, hyps = (_in_order(MH.gather_pseudo_labels(dict(zip(places, texts)))) for texts in (refs, hyps))
        if return_texts:
            return loss, wer, refs, hyps
        return loss, wer

    # ------------------------------------------------------------- NST labels

    def generate_labels(self, dataset: BucketedDataset, index_map=None) -> Dict[int, str]:
        """Greedy-decode pseudo-labels for every utterance (the NST U-split
        pass).  ``index_map`` (local→global index array) keys the returned
        dict by GLOBAL utterance index, for a ``dataset`` that is one
        host's shard of a larger corpus
        (`data/datasets.shard_utterances_with_indices`).

        Under a process group the ranks' labels are unioned
        (`parallel.multihost.gather_pseudo_labels`): without ``index_map``
        every rank reads the whole ``dataset`` and decodes its rows of each
        batch; with it ``dataset`` is the rank's own shard, decoded whole.
        A rank's own shard would give the ranks of a model group, or of a
        sequence-parallel data group, different batches: under either,
        ``index_map`` raises."""
        self._require_state()
        if index_map is not None and (self.mesh.model.size > 1 or sequence_mesh_engaged()):
            raise ValueError("generate_labels(index_map=...) decodes a rank's own shard; under tensor or sequence "
                             "parallelism the ranks must decode the same batches: pass the whole dataset")
        labels: Dict[int, str] = {}
        batches = iter(dataset.epoch(shuffle=False))
        while True:
            with annotate("label.input"):
                batch = next(batches, None)
                if batch is not None:
                    if index_map is None:
                        batch = self._local(batch)
                    audio, alen, _, _ = self._put(batch)
            if batch is None:  # the pass's end
                break
            ids, _ = self._predict_step(audio, alen)  # label.forward
            with annotate("label.pull"):
                ids = ids.cpu().numpy()
            with annotate("label.decode"):
                for row, idx in enumerate(batch.indices):
                    if idx < 0:
                        continue
                    key = int(idx) if index_map is None else int(index_map[int(idx)])
                    labels[key] = self.vocab.decode_ids(ids[row])
        return labels if self.shard is None else MH.gather_pseudo_labels(labels)

    # ------------------------------------------------------------ checkpoints

    def save(self, path: str) -> None:
        save_state(path, self._require_state())

    def load(self, path: str) -> None:
        self.state = restore_state(path, self._require_state())

    def load_encoder_only(self, path: str) -> None:
        """Selective restore of the encoder's and the subsampling's
        parameters only."""
        restore_encoder_params(path, self._require_state().model)
