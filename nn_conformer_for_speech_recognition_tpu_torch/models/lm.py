"""Transformer language models and their two fusions with the ASR model,
port of `nn_conformer_for_speech_recognition_tpu/models/lm.py`.

* `TransformerLM`: the pronunciation→word encoder-decoder LM (embeddings
  plus sinusoidal positions, encoder layers of self-attention and FFN,
  decoder layers of causal self-attention, cross-attention and FFN, a
  final projection); `CausalWordLM`: a decoder-only word LM.
* `shallow_fusion`: ASR log-probs plus ``lm_weight`` times the LM's
  next-token log-probs for the greedy prefix, on the eval path
  (``Trainer(lm_apply=...)``); `make_pron_lm_apply` wires a trained
  `TransformerLM` into that hook.
* `fuse_lm_weights_into_asr`: the additive merge of the LM's attention
  projections into the Conformer blocks' MHSA weights.

Plain PyTorch in float32, as flax computes by default: the JAX LM has no
Pallas path, so there is no kernel here.  `MultiHeadAttention` is flax's
``MultiHeadDotProductAttention`` (query scaled by 1/√dh, biases on q, k, v
and out, masked logits set to ``finfo(float32).min`` so that a row whose
keys are all masked attends uniformly, dropout on the weights drawn once
and shared by every batch row and head); LayerNorm keeps flax's epsilon
1e-6.  Parameters: flax's (d, H, dh) q/k/v kernels are ``Linear(d, H·dh)``
weights (H·dh, d), its (H, dh, d) out kernel ``Linear(H·dh, d)``
(`convert.lm_flax_to_state_dict`).

Under tensor parallelism (`parallel.mesh.shard_module`) the rule table
splits the final projection ``out_proj`` only, by its input rows, as the
JAX rule does: a model rank projects its share of the hidden units and the
partial logits are summed over the model group.
"""

from __future__ import annotations

import math
import re
from typing import Callable, Dict, Mapping, Optional, Tuple

import numpy as np
import torch
import torch.nn as nn
import torch.nn.functional as F

from nn_conformer_for_speech_recognition_tpu_torch.models.layers import LayerNorm, Linear
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import Axis, copy_to_group, reduce_from_group


def sinusoidal_positions(t: int, d: int) -> np.ndarray:
    pos = np.arange(t, dtype=np.float32)
    inv_freq = 1.0 / (10000.0 ** (np.arange(0, d, 2, dtype=np.float32) / d))
    ang = pos[:, None] * inv_freq[None, :]
    return np.concatenate([np.sin(ang), np.cos(ang)], axis=-1).astype(np.float32)


def _positions(t: int, d: int, like: torch.Tensor) -> torch.Tensor:
    return torch.from_numpy(sinusoidal_positions(t, d)).to(like.device, like.dtype)


class MultiHeadAttention(nn.Module):
    """flax ``MultiHeadDotProductAttention`` over (B, Tq, d) queries and
    (B, Tk, d) keys/values; ``mask`` is boolean and broadcasts to
    (B, H, Tq, Tk), True where a key may be attended."""

    def __init__(self, d: int, heads: int, dropout: float):
        super().__init__()
        if d % heads:
            raise ValueError("d must divide into heads")
        self.heads, self.dropout = heads, dropout
        self.query, self.key, self.value = Linear(d, d), Linear(d, d), Linear(d, d)
        self.out = Linear(d, d)

    def forward(self, x: torch.Tensor, kv: torch.Tensor, mask: Optional[torch.Tensor] = None) -> torch.Tensor:
        b, tq, d = x.shape
        h, dh = self.heads, d // self.heads
        q = self.query(x).reshape(b, tq, h, dh) / math.sqrt(dh)
        k = self.key(kv).reshape(b, kv.shape[1], h, dh)
        v = self.value(kv).reshape(b, kv.shape[1], h, dh)
        w = torch.einsum("bqhd,bkhd->bhqk", q, k)
        if mask is not None:
            w = w.masked_fill(~mask, torch.finfo(w.dtype).min)
        w = torch.softmax(w, dim=-1)
        if self.training and self.dropout > 0.0:
            keep = 1.0 - self.dropout
            w = w * ((torch.rand(w.shape[-2:], device=w.device) < keep).to(w.dtype) / keep)
        return self.out(torch.einsum("bhqk,bkhd->bqhd", w, v).reshape(b, tq, d))


class TransformerLayer(nn.Module):
    """Self-attention (causal with ``causal_self``) → add & LN → with
    ``cross`` cross-attention → add & LN → ReLU FFN with dropout → add & LN.
    ``norms`` are flax's ``LayerNorm_0..2`` in that order."""

    def __init__(self, d: int, heads: int, ffn: int, dropout: float, causal_self: bool = False, cross: bool = False):
        super().__init__()
        self.causal_self, self.dropout = causal_self, dropout
        self.self_attn = MultiHeadAttention(d, heads, dropout)
        if cross:
            self.cross_attn = MultiHeadAttention(d, heads, dropout)
        self.norms = nn.ModuleList(LayerNorm(d) for _ in range(3 if cross else 2))
        self.fc1, self.fc2 = Linear(d, ffn), Linear(ffn, d)

    def forward(
        self, x: torch.Tensor, enc_out: Optional[torch.Tensor] = None, mask: Optional[torch.Tensor] = None,
        enc_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        t = x.shape[1]
        attn_mask = None if mask is None else mask[:, None, None, :]
        if self.causal_self:
            causal = torch.tril(torch.ones((t, t), dtype=torch.bool, device=x.device))[None, None]
            attn_mask = causal if attn_mask is None else attn_mask & causal
        x = self.norms[0](x + self.self_attn(x, x, attn_mask))
        if hasattr(self, "cross_attn"):
            cmask = None if enc_mask is None else enc_mask[:, None, None, :]
            x = self.norms[1](x + self.cross_attn(x, enc_out, cmask))
        h = F.dropout(F.relu(self.fc1(x)), self.dropout, self.training)
        return self.norms[-1](x + self.fc2(h))


class _SplitOutProj(nn.Module):
    """An LM whose ``out_proj`` tensor parallelism may split by its input
    rows over ``tp``."""

    tp: Optional[Axis] = None

    @staticmethod
    def check_split(leaves, mp: int) -> None:
        if set(leaves) != {"out_proj.weight"}:
            raise ValueError(f"an LM splits only out_proj over the model axis, the rule splits {sorted(leaves)}")

    def project(self, x: torch.Tensor) -> torch.Tensor:
        tp = self.tp
        if tp is None:
            return self.out_proj(x)
        part = x.shape[-1] // tp.size
        x = copy_to_group(x, tp)[..., tp.rank * part:(tp.rank + 1) * part]
        logits = reduce_from_group(F.linear(x, self.out_proj.weight.to(x.dtype)), tp)
        return logits + self.out_proj.bias.to(x.dtype)


class TransformerLM(_SplitOutProj):
    """Pronunciation→word encoder-decoder LM: (B, S) source ids and (B, T)
    teacher-forced target ids → (B, T, tgt_vocab) next-word logits."""

    def __init__(
        self, src_vocab: int, tgt_vocab: int, d: int = 320, heads: int = 8, ffn: int = 512,
        enc_layers: int = 4, dec_layers: int = 4, dropout: float = 0.1,
    ):
        super().__init__()
        self.d = d
        self.src_embed = nn.Embedding(src_vocab, d)
        self.tgt_embed = nn.Embedding(tgt_vocab, d)
        self.enc = nn.ModuleList(TransformerLayer(d, heads, ffn, dropout) for _ in range(enc_layers))
        self.dec = nn.ModuleList(
            TransformerLayer(d, heads, ffn, dropout, causal_self=True, cross=True) for _ in range(dec_layers))
        self.out_proj = Linear(d, tgt_vocab)

    def forward(
        self, src_ids: torch.Tensor, tgt_ids: torch.Tensor, src_mask: Optional[torch.Tensor] = None,
        tgt_mask: Optional[torch.Tensor] = None,
    ) -> torch.Tensor:
        enc = self.src_embed(src_ids)
        enc = enc + _positions(src_ids.shape[1], self.d, enc)
        for layer in self.enc:
            enc = layer(enc, mask=src_mask)
        dec = self.tgt_embed(tgt_ids)
        dec = dec + _positions(tgt_ids.shape[1], self.d, dec)
        for layer in self.dec:
            dec = layer(dec, enc_out=enc, mask=tgt_mask, enc_mask=src_mask)
        return self.project(dec)


class CausalWordLM(_SplitOutProj):
    """Decoder-only word LM: (B, T) ids → (B, T, vocab) next-token logits."""

    def __init__(self, vocab: int, d: int = 256, heads: int = 4, ffn: int = 512, layers: int = 2,
                 dropout: float = 0.1):
        super().__init__()
        self.d = d
        self.embed = nn.Embedding(vocab, d)
        self.layers = nn.ModuleList(
            TransformerLayer(d, heads, ffn, dropout, causal_self=True) for _ in range(layers))
        self.out_proj = Linear(d, vocab)

    def forward(self, ids: torch.Tensor) -> torch.Tensor:
        x = self.embed(ids)
        x = x + _positions(ids.shape[1], self.d, x)
        for layer in self.layers:
            x = layer(x)
        return self.project(x)


def shallow_fusion(
    asr_log_probs: torch.Tensor,
    lm_apply: Callable[[torch.Tensor], torch.Tensor],
    lm_weight: float = 0.3,
    ngram: int = 2,
) -> torch.Tensor:
    """ASR frame log-probs (B, T, V) plus ``lm_weight`` times the LM's
    log-softmax for the greedy prefix: the context of frame t is the
    argmax ids shifted right by one (0 first).  ``ngram`` is unused, as in
    the JAX function.  The sum is not renormalised."""
    ids = torch.argmax(asr_log_probs, dim=-1)
    ctx = F.pad(ids[:, :-1], (1, 0))
    lm_logits = lm_apply(ctx)
    return asr_log_probs + lm_weight * torch.log_softmax(lm_logits, dim=-1)


_BLOCK = re.compile(r"(encoder\.)?blocks\.(\d+)\.")


def _lm_attn_as_qkv_out(lm_state: Mapping[str, torch.Tensor], prefix: str) -> Optional[Tuple[torch.Tensor, torch.Tensor]]:
    """An LM attention module's weights → (qkv (3·H·dh, d) as row blocks
    [q; k; v], out (d, H·dh)) in the layout of the Conformer MHSA's
    ``qkv`` and ``out_proj`` Linear weights, or None where one is missing."""
    try:
        q, k, v = (lm_state[f"{prefix}.{n}.weight"] for n in ("query", "key", "value"))
        out = lm_state[f"{prefix}.out.weight"]
    except KeyError:
        return None
    return torch.cat([q, k, v], dim=0), out


def fuse_lm_weights_into_asr(
    asr_state: Mapping[str, torch.Tensor], lm_state: Mapping[str, torch.Tensor], scale: float = 1.0
) -> Dict[str, torch.Tensor]:
    """LM→ASR weight fusion over state dicts; returns a new ASR state dict
    (load it with ``load_state_dict``), the inputs untouched.

    * LM encoder layer i's self-attention projections are added into
      Conformer block i's MHSA (q/k/v into ``qkv``, out into ``out_proj``);
    * LM decoder layer i's cross-attention (not its causal self-attention)
      into the mirrored block ``n_blocks - 1 - i``.

    ``asr_state`` holds ``encoder.blocks.{i}.…`` (a `ConformerCTC`'s) or
    ``blocks.{i}.…`` (an encoder's own); ``lm_state`` a `TransformerLM`'s.
    A weight merges only where the shapes agree and is skipped silently
    otherwise, as in the JAX function; the MHSA's qkv has no bias, so the
    LM's q/k/v biases have no target.  Fusing an all-zero LM is a no-op."""
    out = dict(asr_state)
    blocks = {}
    for name in asr_state:
        m = _BLOCK.match(name)
        if m:
            blocks.setdefault(m[1] or "", set()).add(int(m[2]))
    prefix = "encoder." if "encoder." in blocks else ""
    n_blocks = len(blocks.get(prefix, ()))

    def add_into(block: int, qkv_add: torch.Tensor, out_add: torch.Tensor) -> None:
        for leaf, add in (("qkv", qkv_add), ("out_proj", out_add)):
            key = f"{prefix}blocks.{block}.mhsa.{leaf}.weight"
            w = out.get(key)
            if w is not None and w.shape == add.shape:
                out[key] = w + scale * add.to(w.dtype)

    for stack, attn, target in (("enc", "self_attn", lambda i: i), ("dec", "cross_attn", lambda i: n_blocks - 1 - i)):
        for i in range(n_blocks):
            if not any(k.startswith(f"{stack}.{i}.") for k in lm_state):
                break
            pair = _lm_attn_as_qkv_out(lm_state, f"{stack}.{i}.{attn}")
            if pair is not None:
                add_into(target(i), *pair)
    return out


def make_pron_lm_apply(lm: TransformerLM, pron_table: np.ndarray) -> Callable[[torch.Tensor], torch.Tensor]:
    """The shallow-fusion hook (``Trainer(lm_apply=...)``) over a trained
    `TransformerLM`: greedy context word ids (B, T) → (B, T, V) logits, the
    source stream each context word's pronunciation (``pron_table`` (V, P)
    int, padded right with 0) flattened per row, the target stream the
    context itself.  The table is indexed; the JAX package's one-hot matmul
    was a TPU gather workaround.  The LM runs in eval mode."""
    table = torch.as_tensor(np.asarray(pron_table), dtype=torch.long, device=next(lm.parameters()).device)

    def apply(ctx_ids: torch.Tensor) -> torch.Tensor:
        lm.eval()
        src = table[ctx_ids].reshape(ctx_ids.shape[0], -1)
        with torch.no_grad():
            return lm(src, ctx_ids)

    return apply
