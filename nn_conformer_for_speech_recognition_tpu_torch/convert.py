"""flax variables → a ``state_dict`` for the port's ``ConformerCTC``.

Takes ``{"params": ..., "batch_stats": ...}`` as nested dicts of arrays
(numpy, or anything ``np.asarray`` accepts) and returns float32 tensors
keyed by the port's parameter and buffer names.  Layout rules:

* Dense kernel (in, out) → Linear weight (out, in);
* NHWC Conv kernel (kh, kw, in, out) → (out, in, kh, kw);
* depthwise Conv kernel (K, 1, C) → (C, 1, K); the kernel route's
  ``dw_kernel`` (K, C) (``conv_impl='pallas'``) keeps its name and layout;
* LayerNorm / MaskedBatchNorm ``scale`` → ``weight``; batch_stats
  ``mean``/``var`` → ``running_mean``/``running_var``;
* the packed (Pallas) LSTM leaves ``lstm_{fwd,bwd}_{i}_{w_ih,w_hh,bias}``
  keep their names and layout (gates already in i, f, g, o order);
* the flax ``OptimizedLSTMCell`` tree (the default ``use_pallas=False``
  checkpoint) is packed into the same three tensors per direction.

Every leaf maps onto exactly one name (a second mapping, or an incomplete
LSTM cell, raises); loading with ``strict=True`` rejects unknown leaves and
shows that every parameter and buffer was filled.
"""

from __future__ import annotations

import re
from typing import Dict, Iterator, Mapping, Tuple

import numpy as np
import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import ModelConfig

# flax submodule name → port attribute name, by parent module
_MODULE_RENAMES = {
    "subsampling": {"Dense_0": "out"},
    "ffn1": {"Dense_0": "fc1", "Dense_1": "fc2"},
    "ffn2": {"Dense_0": "fc1", "Dense_1": "fc2"},
    "conv": {"Dense_0": "pointwise_in", "Dense_1": "pointwise_out", "MaskedBatchNorm_0": "batch_norm"},
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


def _pack_lstm_cells(cells: Dict[int, Dict[str, np.ndarray]], config: ModelConfig) -> Dict[str, np.ndarray]:
    """``OptimizedLSTMCell_{n}`` trees → packed w_ih, w_hh and bias.  Cells
    are numbered in creation order: layer by layer, forward then backward."""
    dec = config.decoder
    dirs = ("fwd", "bwd") if dec.bidirectional else ("fwd",)
    if sorted(cells) != list(range(dec.lstm_layers * len(dirs))):
        raise ValueError(f"expected {dec.lstm_layers * len(dirs)} LSTM cells, got {sorted(cells)}")
    out = {}
    for n, leaves in cells.items():
        expected = {f"i{g}/kernel" for g in _GATES} | {f"h{g}/{k}" for g in _GATES for k in ("kernel", "bias")}
        if set(leaves) != expected:
            raise ValueError(f"OptimizedLSTMCell_{n} has leaves {sorted(leaves)}")
        layer, name = divmod(n, len(dirs))
        prefix = f"decoder_lstm.lstm_{dirs[name]}_{layer}"
        out[f"{prefix}_w_ih"] = np.concatenate([leaves[f"i{g}/kernel"] for g in _GATES], axis=1)
        out[f"{prefix}_w_hh"] = np.concatenate([leaves[f"h{g}/kernel"] for g in _GATES], axis=1)
        out[f"{prefix}_bias"] = np.concatenate([leaves[f"h{g}/bias"] for g in _GATES])
    return out


def flax_to_state_dict(variables: Mapping, config: ModelConfig) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of the JAX ``ConformerCTC`` → the
    port's ``state_dict`` (load with ``strict=True``)."""
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
            if path[0] == "decoder_lstm" and cell:
                cells.setdefault(int(cell[1]), {})["/".join(path[2:])] = x
                continue
            put(_torch_name(path), _to_torch_layout(path, x), path)
    if cells:
        for name, value in _pack_lstm_cells(cells, config).items():
            put(name, value, ("decoder_lstm", name))
    return {k: torch.from_numpy(np.array(v, order="C")) for k, v in arrays.items()}
