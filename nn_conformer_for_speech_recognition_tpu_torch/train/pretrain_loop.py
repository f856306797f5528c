"""Contrastive pretraining loop, port of
`nn_conformer_for_speech_recognition_tpu/train/pretrain_loop.py`: Adam at
``PretrainConfig.learning_rate`` over the unlabelled split, the loss per
epoch in ``history["pretrain_loss"]``, and a checkpoint by
`train.checkpoint.save_state`.

A step: log-mel features (the STFT/log-mel kernel on CUDA), the draws of
`models.pretrain.draw_pretrain` from ``state.generator`` (or the caller's),
`PretrainModel` in train mode (masked BatchNorm statistics over valid
frames, dropout from the device generator seeded by
``state.dropout_seed()``), `contrastive_loss`, backward through the LSTM
kernels, one Adam update.  Runs on the first CUDA device unless the caller
asks for ``device="cpu"``.

Under a process group the trainer trains as `train.loop.Trainer` does
(`train.loop.setup_layout`): each data rank takes its rows of every
global batch, the draws are made for the global batch and sliced, the
loss is the global batch's (`models.pretrain.contrastive_loss` over the
data group), one all-reduce of the flat gradient follows the backward,
rank 0 writes the checkpoint; with ``model_parallel_size`` > 1 the rule
table splits the context network's FFN and attention weights.

The pretrained weights do not transfer into the ASR model:
``Trainer.load_encoder_only`` takes parameters named ``encoder.`` and
``subsampling.``, and this model has neither (see `models/pretrain.py`),
as in the JAX package.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import (
    FeatureConfig,
    MeshConfig,
    ModelConfig,
    PretrainConfig,
)
from nn_conformer_for_speech_recognition_tpu_torch.convert import pretrain_flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import init_params
from nn_conformer_for_speech_recognition_tpu_torch.models.pretrain import (
    PretrainDraws,
    PretrainModel,
    contrastive_loss,
    draw_pretrain,
)
from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import save_state
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import DataShard, Mesh, is_main_process
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import (
    all_reduce_gradients,
    init_split,
    mean_of_steps,
    resolve_device,
    setup_layout,
)
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import Adam
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState


def make_pretrain_step(
    model: PretrainModel, feat_cfg: FeatureConfig, shard: Optional[DataShard] = None, mesh: Optional[Mesh] = None
) -> Callable[..., Tuple[TrainState, Dict[str, torch.Tensor]]]:
    """``step(state, audio, audio_lengths, draws=None) → (state, {"loss"})``;
    without ``draws`` they come from ``state.generator``.  With ``shard``
    the audio is that data rank's rows of a global batch: the draws (given
    or made) are the global batch's, and the rank takes its rows of them;
    the loss and the gradients are the global batch's."""
    featurize = make_featurizer(feat_cfg)
    cfg = model.pretrain
    rank = 0 if shard is None else shard.rank
    axis = None if mesh is None else mesh.data

    def step(state: TrainState, audio, audio_lengths, draws: Optional[PretrainDraws] = None):
        if state.model is not model:
            raise ValueError("pretrain step: state.model is not the model the step was made for")
        with torch.no_grad():
            feats, frame_lengths = featurize(audio, audio_lengths)
        if draws is None:
            batch = feats.shape[0] * (1 if shard is None else shard.world)
            draws = draw_pretrain(state.generator, batch, model.config.subsampled_length(feats.shape[1]), cfg,
                                  feats.device)
        if shard is not None:
            draws = draws.rows(shard.rows(draws.mask.shape[0]))
        model.train()
        model.zero_grad(set_to_none=True)
        devices = [feats.device] if feats.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(state.dropout_seed(rank))
            ctx, targets, mask_pos, lengths = model(feats, frame_lengths, draws)
            loss = contrastive_loss(ctx, targets, mask_pos, lengths, draws.distractors,
                                    temperature=cfg.temperature, diversity_alpha=cfg.diversity_alpha,
                                    global_rows=shard is not None, axis=axis)
            loss.backward()
        if shard is not None:
            loss = all_reduce_gradients(model, loss, axis)
        state.apply_gradients()
        return state, {"loss": loss.detach()}

    return step


class PretrainTrainer:
    def __init__(
        self,
        model_cfg: ModelConfig,
        pretrain_cfg: PretrainConfig,
        feat_cfg: FeatureConfig,
        mesh_cfg: MeshConfig = MeshConfig(),
        mesh=None,
        log_fn: Callable[[str], None] = print,
        device=None,
    ):
        self.device = resolve_device(device)
        self.mesh, self.shard = setup_layout(mesh, mesh_cfg)
        self.model = PretrainModel(model_cfg, pretrain_cfg).to(self.device)
        self.cfg = pretrain_cfg
        self.feat_cfg = feat_cfg
        self.log = log_fn if is_main_process() else (lambda _: None)
        self.state: Optional[TrainState] = None
        self.history: Dict[str, List[float]] = {"pretrain_loss": []}
        self._train_step = make_pretrain_step(self.model, feat_cfg, self.shard, self.mesh)

    def init_state(self, seed: int = 0, variables=None) -> TrainState:
        """Parameters drawn from ``seed`` (or taken from ``variables``, the
        JAX package's ``{"params", "batch_stats"}``, converted), batch
        statistics at their start values, a fresh Adam.  Under a process
        group every rank takes rank 0's, and its model rank's share."""

        def init():
            if variables is not None:
                self.model.load_state_dict(pretrain_flax_to_state_dict(variables), strict=True)
                return
            init_params(self.model, torch.Generator().manual_seed(seed))
            for name, buf in self.model.named_buffers():
                buf.fill_(1.0 if name.endswith("running_var") else 0.0)

        plan = init_split(self.model, self.mesh, self.shard, init)
        optimizer = Adam(self.model.named_parameters(), self.cfg.learning_rate, plan=plan)
        self.state = TrainState.create(self.model, optimizer, seed)
        return self.state

    def train(self, dataset: BucketedDataset, epochs: int) -> Dict[str, List[float]]:
        """Epoch ``e`` draws its batches from ``dataset.epoch(seed=e)``; the
        losses are pulled from the device once an epoch."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        for epoch in range(epochs):
            t0 = time.time()
            losses = []
            for batch in dataset.epoch(seed=epoch):
                rows = slice(None) if self.shard is None else self.shard.rows(len(batch.indices))
                audio = torch.from_numpy(np.ascontiguousarray(batch.audio[rows])).to(self.device)
                alen = torch.from_numpy(batch.audio_lengths[rows].astype(np.int32)).to(self.device)
                self.state, metrics = self._train_step(self.state, audio, alen)
                losses.append(metrics["loss"])
            mean = mean_of_steps(losses)
            self.history["pretrain_loss"].append(mean)
            self.log(f"pretrain epoch {epoch}: loss={mean:.4f} ({time.time() - t0:.1f}s)")
        return self.history

    def save(self, path: str) -> None:
        save_state(path, self.state)
