"""LM training loop, port of
`nn_conformer_for_speech_recognition_tpu/train/lm_loop.py`: teacher-forced
cross-entropy over `models.lm.TransformerLM` examples from
`data.lm_corpus.LMCorpus`, AdamW (``optax.adamw``'s default decay 1e-4),
perplexity per epoch.

The decoder's input is the target shifted right by one with ``<pad>``
first; the loss is the cross-entropy averaged over the valid target
positions.  Dropout draws from the device generator seeded by
``state.dropout_seed()``, as the ASR train step's.  Runs on the first CUDA
device unless the caller asks for ``device="cpu"``.

Under a process group the trainer trains as `train.loop.Trainer` does
(`train.loop.setup_layout`): each data rank takes its rows of every
global batch, the loss divides by the global count of target positions,
one all-reduce of the flat gradient follows the backward, rank 0 writes
the checkpoint; with ``model_parallel_size`` > 1 the rule table splits the
final projection (`models.lm`), and Adam keeps its share of that state.
"""

from __future__ import annotations

import time
from typing import Callable, Dict, List, Optional, Tuple

import numpy as np
import torch
import torch.nn.functional as F

from nn_conformer_for_speech_recognition_tpu_torch.config import LMConfig, MeshConfig
from nn_conformer_for_speech_recognition_tpu_torch.convert import lm_flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import init_params
from nn_conformer_for_speech_recognition_tpu_torch.models.lm import TransformerLM
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import save_state
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import (
    Axis,
    DataShard,
    Mesh,
    all_reduce_sum,
    is_main_process,
)
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import (
    all_reduce_gradients,
    init_split,
    mean_of_steps,
    resolve_device,
    setup_layout,
)
from nn_conformer_for_speech_recognition_tpu_torch.train.metrics import perplexity
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import ADAMW_WEIGHT_DECAY, Adam
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState


def _lm_loss(model: TransformerLM, src, slen, tgt, tlen, pad: int, global_rows: bool = False,
             axis: Optional[Axis] = None) -> torch.Tensor:
    """Masked teacher-forced cross-entropy of one batch; with ``global_rows``
    (a data rank's share of a batch) the count of target positions is
    summed over the data group ``axis``, so that the ranks' losses add up
    to the global batch's."""
    src_mask = torch.arange(src.shape[1], device=src.device)[None, :] < slen[:, None]
    tgt_mask = torch.arange(tgt.shape[1], device=tgt.device)[None, :] < tlen[:, None]
    dec_in = F.pad(tgt[:, :-1], (1, 0), value=pad)
    logits = model(src, dec_in, src_mask=src_mask, tgt_mask=tgt_mask)
    ce = F.cross_entropy(logits.transpose(1, 2), tgt, reduction="none")
    w = tgt_mask.to(ce.dtype)
    count = torch.sum(w)
    if global_rows and (axis is None or axis.spread):
        count = all_reduce_sum(count, axis)
    return torch.sum(ce * w) / torch.clamp_min(count, 1.0)


def make_lm_train_step(
    model: TransformerLM, pad_id: int, shard: Optional[DataShard] = None, mesh: Optional[Mesh] = None
) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """``train_step(state, src, slen, tgt, tlen) → (state, loss)``: train
    mode, the masked loss, backward, one optimizer update.  With ``shard``
    the inputs are that data rank's rows of a global batch: the loss and
    the gradients are the global batch's (`train.loop.make_feature_train_step`)."""
    rank = 0 if shard is None else shard.rank
    axis = None if mesh is None else mesh.data

    def train_step(state: TrainState, src, slen, tgt, tlen):
        model.train()
        model.zero_grad(set_to_none=True)
        devices = [src.device] if src.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(state.dropout_seed(rank))
            loss = _lm_loss(model, src, slen, tgt, tlen, pad_id, global_rows=shard is not None, axis=axis)
            loss.backward()
        if shard is not None:
            loss = all_reduce_gradients(model, loss, axis)
        state.apply_gradients()
        return state, loss.detach()

    return train_step


def make_lm_score_step(
    model: TransformerLM, pad_id: int, shard: Optional[DataShard] = None, mesh: Optional[Mesh] = None
) -> Callable[..., torch.Tensor]:
    """``score_step(src, slen, tgt, tlen) → loss`` in eval mode; with
    ``shard``, the global batch's loss from the data rank's rows."""
    axis = None if mesh is None else mesh.data

    @torch.inference_mode()
    def score_step(src, slen, tgt, tlen):
        model.eval()
        loss = _lm_loss(model, src, slen, tgt, tlen, pad_id, global_rows=shard is not None, axis=axis)
        return loss if shard is None or (axis is not None and not axis.spread) else all_reduce_sum(loss, axis)

    return score_step


class LMTrainer:
    """Epochs of `make_lm_train_step` over an `LMCorpus`; ``history`` holds
    each epoch's mean loss (``lm_loss``) and its perplexity (``lm_ppl``).
    ``mesh_cfg`` and ``mesh`` lay out a process group as `train.loop.Trainer`'s."""

    def __init__(
        self,
        cfg: LMConfig,
        src_vocab_size: int,
        tgt_vocab_size: int,
        tgt_pad_id: int,
        learning_rate: float = 2e-4,
        mesh_cfg: MeshConfig = MeshConfig(),
        mesh=None,
        log_fn: Callable[[str], None] = print,
        device=None,
    ):
        self.cfg = cfg
        self.device = resolve_device(device)
        self.mesh, self.shard = setup_layout(mesh, mesh_cfg)
        self.model = TransformerLM(
            src_vocab=src_vocab_size, tgt_vocab=tgt_vocab_size, d=cfg.embed_dim, heads=cfg.num_heads,
            ffn=cfg.ffn_dim, enc_layers=cfg.num_encoder_layers, dec_layers=cfg.num_decoder_layers,
            dropout=cfg.dropout,
        ).to(self.device)
        self.pad_id = tgt_pad_id
        self.learning_rate = learning_rate
        self.log = log_fn if is_main_process() else (lambda _: None)
        self.state: Optional[TrainState] = None
        self.history: Dict[str, List[float]] = {"lm_loss": [], "lm_ppl": []}
        self._train_step = make_lm_train_step(self.model, tgt_pad_id, self.shard, self.mesh)
        self._score_step = make_lm_score_step(self.model, tgt_pad_id, self.shard, self.mesh)

    def init_state(self, seed: int = 0, params=None) -> TrainState:
        """Parameters drawn from ``seed``, or taken from ``params`` (the JAX
        package's LM params, converted); a fresh AdamW.  Under a process
        group every rank takes rank 0's, and its model rank's share."""

        def init():
            if params is not None:
                self.model.load_state_dict(lm_flax_to_state_dict(params), strict=True)
            else:
                init_params(self.model, torch.Generator().manual_seed(seed))

        plan = init_split(self.model, self.mesh, self.shard, init)
        optimizer = Adam(self.model.named_parameters(), self.learning_rate, weight_decay=ADAMW_WEIGHT_DECAY, plan=plan)
        self.state = TrainState.create(self.model, optimizer, seed)
        return self.state

    def _put(self, *arrays: np.ndarray):
        """The data rank's rows of a global batch's arrays, on the device."""
        rows = slice(None) if self.shard is None else self.shard.rows(arrays[0].shape[0])
        return tuple(torch.from_numpy(np.ascontiguousarray(a[rows])).to(self.device, torch.int64) for a in arrays)

    def train(self, corpus, epochs: int, batch_size: int = 32) -> Dict[str, List[float]]:
        """Epoch ``e`` draws its batches from ``corpus.batches(batch_size,
        seed=e)``; the losses are pulled from the device once an epoch."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        for epoch in range(epochs):
            t0 = time.time()
            losses = []
            for batch in corpus.batches(batch_size, seed=epoch):
                self.state, loss = self._train_step(self.state, *self._put(*batch))
                losses.append(loss)
            mean = mean_of_steps(losses)
            self.history["lm_loss"].append(mean)
            self.history["lm_ppl"].append(perplexity(mean))
            self.log(f"lm epoch {epoch}: loss={mean:.4f} ppl={perplexity(mean):.2f} ({time.time() - t0:.1f}s)")
        return self.history

    def evaluate(self, corpus, batch_size: int = 32) -> float:
        """Mean of the per-batch losses over the corpus in order."""
        if self.state is None:
            raise RuntimeError("call init_state() first")
        return mean_of_steps([self._score_step(*self._put(*batch)) for batch in corpus.batches(batch_size, shuffle=False)])

    def save(self, path: str) -> None:
        save_state(path, self.state)
