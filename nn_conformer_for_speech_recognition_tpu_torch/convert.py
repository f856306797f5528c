"""flax variables → a ``state_dict`` for the port's ``ConformerCTC``
(`flax_to_state_dict`), ``PretrainModel`` (`pretrain_flax_to_state_dict`)
and ``TransformerLM`` / ``CausalWordLM`` (`lm_flax_to_state_dict`).

Takes ``{"params": ..., "batch_stats": ...}`` as nested dicts of arrays
(numpy, or anything ``np.asarray`` accepts) and returns float32 tensors
keyed by the port's parameter and buffer names.  Layout rules:

* Dense kernel (in, out) → Linear weight (out, in);
* NHWC Conv kernel (kh, kw, in, out) → (out, in, kh, kw);
* depthwise Conv kernel (K, 1, C) → (C, 1, K); the kernel route's
  ``dw_kernel`` (K, C) (``conv_impl='pallas'``) keeps its name and layout;
* LayerNorm / MaskedBatchNorm / GroupNorm ``scale`` → ``weight``;
  batch_stats ``mean``/``var`` → ``running_mean``/``running_var``; the conv
  module's ``GroupNorm_0`` or ``LayerNorm_1`` (``conv_norm`` 'groupnorm' or
  'layernorm') is its ``group_norm`` or ``layer_norm``, and the library
  depthwise conv's ``bias`` there keeps its name;
* the packed (Pallas) LSTM leaves ``lstm_{fwd,bwd}_{i}_{w_ih,w_hh,bias}``
  keep their names and layout (gates already in i, f, g, o order);
* the flax ``OptimizedLSTMCell`` tree (the default ``use_pallas=False``
  checkpoint, and the pretraining model's ``decoder``) is packed into the
  same three tensors per direction;
* the pretraining model's ``ConvSubsampling_0`` is ``conv_subsampling``;
* in the LMs, ``nn.Embed``'s ``embedding`` (V, d) is an ``nn.Embedding``
  weight as it stands, a ``MultiHeadDotProductAttention``'s q/k/v kernel
  (d, H, dh) a Linear weight (H·dh, d) with the bias (H, dh) flattened,
  its out kernel (H, dh, d) a Linear weight (d, H·dh), a layer's
  ``LayerNorm_k`` ``norms.k`` and its ``Dense_0/1`` ``fc1/fc2``.

Every leaf maps onto exactly one name (a second mapping, or an incomplete
LSTM cell, raises); loading with ``strict=True`` rejects unknown leaves and
shows that every parameter and buffer was filled.
"""

from __future__ import annotations

import re
from typing import Callable, Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import ModelConfig

# flax submodule name → port attribute name, by parent module
_MODULE_RENAMES = {
    None: {"ConvSubsampling_0": "conv_subsampling"},
    "subsampling": {"Dense_0": "out"},
    "ConvSubsampling_0": {"Dense_0": "out"},
    "ffn1": {"Dense_0": "fc1", "Dense_1": "fc2"},
    "ffn2": {"Dense_0": "fc1", "Dense_1": "fc2"},
    # the conv module's second norm: BatchNorm, or under conv_norm 'groupnorm' / 'layernorm' the others
    "conv": {"Dense_0": "pointwise_in", "Dense_1": "pointwise_out", "MaskedBatchNorm_0": "batch_norm",
             "GroupNorm_0": "group_norm", "LayerNorm_1": "layer_norm"},
}
_LEAF_RENAMES = {"kernel": "weight", "scale": "weight", "mean": "running_mean", "var": "running_var"}
_INDEXED = re.compile(r"(Conv|block)_(\d+)")
_GATES = ("i", "f", "g", "o")
# parameter rank → permutation from the port's layout back to flax's
_FLAX_AXES = {2: (1, 0), 3: (2, 1, 0), 4: (2, 3, 1, 0)}


def _flatten(tree: Mapping, prefix: Tuple[str, ...] = ()) -> Iterator[Tuple[Tuple[str, ...], np.ndarray]]:
    for key, value in tree.items():
        if isinstance(value, Mapping):
            yield from _flatten(value, prefix + (key,))
        else:
            yield prefix + (key,), np.asarray(value, dtype=np.float32)


def _torch_name(path: Tuple[str, ...]) -> str:
    parts, parent = [], None
    for seg in path[:-1]:
        m = _INDEXED.fullmatch(seg)
        if m:
            name = {"Conv": "convs", "block": "blocks"}[m[1]] + "." + m[2]
        elif seg == "LayerNorm_0":
            name = "norm"
        else:
            name = _MODULE_RENAMES.get(parent, {}).get(seg, seg)
        parts.append(name)
        parent = seg
    parts.append(_LEAF_RENAMES.get(path[-1], path[-1]))
    return ".".join(parts)


def _to_torch_layout(path: Tuple[str, ...], x: np.ndarray) -> np.ndarray:
    if path[-1] != "kernel":
        return x
    if x.ndim == 2:  # Dense (in, out) → (out, in)
        return x.T
    if x.ndim == 3:  # depthwise (K, 1, C) → (C, 1, K)
        return x.transpose(2, 1, 0)
    if x.ndim == 4:  # NHWC (kh, kw, in, out) → (out, in, kh, kw)
        return x.transpose(3, 2, 0, 1)
    raise ValueError(f"unexpected kernel rank {x.ndim} at {'/'.join(path)}")


def flax_axes(name: str, ndim: int) -> Tuple[int, ...]:
    """Permutation that takes the port's parameter ``name`` back to the JAX
    package's layout (``param.permute(axes)``), the inverse of
    `_to_torch_layout`: Linear (out, in) → (in, out), depthwise (C, 1, K) →
    (K, 1, C), Conv2d (out, in, kh, kw) → (kh, kw, in, out).  The packed
    LSTM weights, ``dw_kernel``, the rel-pos biases and every vector keep
    their layout."""
    if name.endswith("weight") and ndim in _FLAX_AXES:
        return _FLAX_AXES[ndim]
    return tuple(range(ndim))


def _pack_lstm_cells(
    cells: Dict[int, Dict[str, np.ndarray]], layers: int, bidirectional: bool, scope: str
) -> Dict[str, np.ndarray]:
    """``OptimizedLSTMCell_{n}`` trees → packed w_ih, w_hh and bias of the
    BiLSTM at ``scope``.  Cells are numbered in creation order: layer by
    layer, forward then backward."""
    dirs = ("fwd", "bwd") if bidirectional else ("fwd",)
    if sorted(cells) != list(range(layers * len(dirs))):
        raise ValueError(f"expected {layers * len(dirs)} LSTM cells, got {sorted(cells)}")
    out = {}
    for n, leaves in cells.items():
        expected = {f"i{g}/kernel" for g in _GATES} | {f"h{g}/{k}" for g in _GATES for k in ("kernel", "bias")}
        if set(leaves) != expected:
            raise ValueError(f"OptimizedLSTMCell_{n} has leaves {sorted(leaves)}")
        layer, name = divmod(n, len(dirs))
        prefix = f"{scope}.lstm_{dirs[name]}_{layer}"
        out[f"{prefix}_w_ih"] = np.concatenate([leaves[f"i{g}/kernel"] for g in _GATES], axis=1)
        out[f"{prefix}_w_hh"] = np.concatenate([leaves[f"h{g}/kernel"] for g in _GATES], axis=1)
        out[f"{prefix}_bias"] = np.concatenate([leaves[f"h{g}/bias"] for g in _GATES])
    return out


def flax_to_state_dict(variables: Mapping, config: ModelConfig) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of the JAX ``ConformerCTC`` → the
    port's ``state_dict`` (load with ``strict=True``)."""
    return _model_state_dict(variables, "decoder_lstm", lambda: (config.decoder.lstm_layers, config.decoder.bidirectional))


def pretrain_flax_to_state_dict(variables: Mapping) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of the JAX ``PretrainModel`` → the
    port's ``state_dict`` (its ``decoder`` is one bidirectional layer)."""
    return _model_state_dict(variables, "decoder", lambda: (1, True))


def _model_state_dict(
    variables: Mapping, lstm_scope: str, lstm_layout: Callable[[], Tuple[int, bool]]
) -> Dict[str, torch.Tensor]:
    """``lstm_layout()`` gives the (layers, bidirectional) of the BiLSTM at
    ``lstm_scope``; it is asked only where the tree holds flax LSTM cells."""
    unknown = set(variables) - {"params", "batch_stats"}
    if unknown:
        raise ValueError(f"unexpected variable collections {sorted(unknown)}")
    arrays: Dict[str, np.ndarray] = {}
    cells: Dict[int, Dict[str, np.ndarray]] = {}

    def put(name: str, value: np.ndarray, path) -> None:
        if name in arrays:
            raise ValueError(f"{'/'.join(path)} maps onto {name} a second time")
        arrays[name] = value

    for collection in ("params", "batch_stats"):
        for path, x in _flatten(variables.get(collection, {})):
            cell = re.fullmatch(r"OptimizedLSTMCell_(\d+)", path[1]) if len(path) > 2 else None
            if path[0] == lstm_scope and cell:
                cells.setdefault(int(cell[1]), {})["/".join(path[2:])] = x
                continue
            put(_torch_name(path), _to_torch_layout(path, x), path)
    if cells:
        for name, value in _pack_lstm_cells(cells, *lstm_layout(), lstm_scope).items():
            put(name, value, (lstm_scope, name))
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in arrays.items()}


_LM_STACKS = re.compile(r"(enc|dec|layer)_(\d+)")
_LM_STACK_NAMES = {"enc": "enc", "dec": "dec", "layer": "layers"}
_LM_EMBEDS = {"src_embed": "src_embed", "tgt_embed": "tgt_embed", "Embed_0": "embed"}


def _lm_leaf(path: Tuple[str, ...], x: np.ndarray) -> Tuple[str, np.ndarray]:
    """One flax LM leaf → (port name, array in the port's layout)."""
    if path[0] in _LM_EMBEDS and path[1:] == ("embedding",):
        return f"{_LM_EMBEDS[path[0]]}.weight", x
    if path[0] == "out_proj":
        return f"out_proj.{_LEAF_RENAMES.get(path[1], path[1])}", x.T if path[1] == "kernel" else x
    m = _LM_STACKS.fullmatch(path[0])
    if m is None or len(path) < 3:
        raise ValueError(f"unexpected LM leaf {'/'.join(path)}")
    layer = f"{_LM_STACK_NAMES[m[1]]}.{m[2]}"
    sub, leaf = path[1], path[-1]
    if sub in ("self_attn", "cross_attn") and len(path) == 4:
        proj = path[2]
        if leaf == "kernel":
            x = (x.reshape(-1, x.shape[-1]) if proj == "out" else x.reshape(x.shape[0], -1)).T
        elif proj != "out":
            x = x.reshape(-1)
        return f"{layer}.{sub}.{proj}.{leaf if leaf == 'bias' else 'weight'}", x
    ln = re.fullmatch(r"LayerNorm_(\d)", sub)
    if ln and len(path) == 3:
        return f"{layer}.norms.{ln[1]}.{_LEAF_RENAMES.get(leaf, leaf)}", x
    if sub in ("Dense_0", "Dense_1") and len(path) == 3:
        return f"{layer}.fc{int(sub[-1]) + 1}.{_LEAF_RENAMES.get(leaf, leaf)}", x.T if leaf == "kernel" else x
    raise ValueError(f"unexpected LM leaf {'/'.join(path)}")


def lm_flax_to_state_dict(params: Mapping) -> Dict[str, torch.Tensor]:
    """The params of the JAX ``TransformerLM`` or ``CausalWordLM`` (the tree,
    or ``{"params": tree}``) → the port's ``state_dict`` (load with
    ``strict=True``)."""
    if set(params) == {"params"}:
        params = params["params"]
    arrays: Dict[str, np.ndarray] = {}
    for path, x in _flatten(params):
        name, value = _lm_leaf(path, x)
        if name in arrays:
            raise ValueError(f"{'/'.join(path)} maps onto {name} a second time")
        arrays[name] = value
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in arrays.items()}
