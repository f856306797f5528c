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
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import mean_of_steps, refuse_mesh, resolve_device
from nn_conformer_for_speech_recognition_tpu_torch.train.metrics import perplexity
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import ADAMW_WEIGHT_DECAY, Adam
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState


def _lm_loss(model: TransformerLM, src, slen, tgt, tlen, pad: int) -> torch.Tensor:
    """Masked teacher-forced cross-entropy of one batch."""
    src_mask = torch.arange(src.shape[1], device=src.device)[None, :] < slen[:, None]
    tgt_mask = torch.arange(tgt.shape[1], device=tgt.device)[None, :] < tlen[:, None]
    dec_in = F.pad(tgt[:, :-1], (1, 0), value=pad)
    logits = model(src, dec_in, src_mask=src_mask, tgt_mask=tgt_mask)
    ce = F.cross_entropy(logits.transpose(1, 2), tgt, reduction="none")
    w = tgt_mask.to(ce.dtype)
    return torch.sum(ce * w) / torch.clamp_min(torch.sum(w), 1.0)


def make_lm_train_step(model: TransformerLM, pad_id: int) -> Callable[..., Tuple[TrainState, torch.Tensor]]:
    """``train_step(state, src, slen, tgt, tlen) → (state, loss)``: train
    mode, the masked loss, backward, one optimizer update."""

    def train_step(state: TrainState, src, slen, tgt, tlen):
        model.train()
        model.zero_grad(set_to_none=True)
        devices = [src.device] if src.device.type == "cuda" else []
        with torch.random.fork_rng(devices=devices):
            torch.manual_seed(state.dropout_seed())
            loss = _lm_loss(model, src, slen, tgt, tlen, pad_id)
            loss.backward()
        state.apply_gradients()
        return state, loss.detach()

    return train_step


def make_lm_score_step(model: TransformerLM, pad_id: int) -> Callable[..., torch.Tensor]:
    """``score_step(src, slen, tgt, tlen) → loss`` in eval mode."""

    @torch.inference_mode()
    def score_step(src, slen, tgt, tlen):
        model.eval()
        return _lm_loss(model, src, slen, tgt, tlen, pad_id)

    return score_step


class LMTrainer:
    """Epochs of `make_lm_train_step` over an `LMCorpus`; ``history`` holds
    each epoch's mean loss (``lm_loss``) and its perplexity (``lm_ppl``)."""

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
        refuse_mesh(mesh, mesh_cfg)
        self.cfg = cfg
        self.device = resolve_device(device)
        self.model = TransformerLM(
            src_vocab=src_vocab_size, tgt_vocab=tgt_vocab_size, d=cfg.embed_dim, heads=cfg.num_heads,
            ffn=cfg.ffn_dim, enc_layers=cfg.num_encoder_layers, dec_layers=cfg.num_decoder_layers,
            dropout=cfg.dropout,
        ).to(self.device)
        self.pad_id = tgt_pad_id
        self.learning_rate = learning_rate
        self.log = log_fn
        self.state: Optional[TrainState] = None
        self.history: Dict[str, List[float]] = {"lm_loss": [], "lm_ppl": []}
        self._train_step = make_lm_train_step(self.model, tgt_pad_id)
        self._score_step = make_lm_score_step(self.model, tgt_pad_id)

    def init_state(self, seed: int = 0, params=None) -> TrainState:
        """Parameters drawn from ``seed``, or taken from ``params`` (the JAX
        package's LM params, converted); a fresh AdamW."""
        if params is not None:
            self.model.load_state_dict(lm_flax_to_state_dict(params), strict=True)
        else:
            init_params(self.model, torch.Generator().manual_seed(seed))
        optimizer = Adam(self.model.named_parameters(), self.learning_rate, weight_decay=ADAMW_WEIGHT_DECAY)
        self.state = TrainState.create(self.model, optimizer, seed)
        return self.state

    def _put(self, *arrays: np.ndarray):
        return tuple(torch.from_numpy(np.ascontiguousarray(a)).to(self.device, torch.int64) for a in arrays)

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
