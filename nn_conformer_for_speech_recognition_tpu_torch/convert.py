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
from typing import Callable, Dict, Iterator, Mapping, Optional, Tuple

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


def check_bridgeable(config: ModelConfig) -> None:
    """Raises for a configuration the JAX package cannot hold: its encoder
    has Conformer blocks only, so no JAX checkpoint holds the port's
    E-Branchformer block."""
    block = getattr(getattr(config, "encoder", None), "block", "conformer")  # None: a caller with no model config
    if block != "conformer":
        raise ValueError(f"the JAX package has no {block!r} encoder block: no JAX checkpoint converts to this "
                         "configuration")


def flax_to_state_dict(variables: Mapping, config: ModelConfig) -> Dict[str, torch.Tensor]:
    """``{"params", "batch_stats"}`` of the JAX ``ConformerCTC`` → the
    port's ``state_dict`` (load with ``strict=True``)."""
    check_bridgeable(config)
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


# ---------------------------------------------------------------------------
# optimizer state and whole train states (the checkpoint bridge's framework-free half)
# ---------------------------------------------------------------------------


def _optax_parts(tree, found=None) -> Dict[str, Mapping]:
    """The optax states inside a restored ``opt_state`` (nested lists,
    dicts or named tuples), by kind: ``'factored'`` (``v``, ``v_row``,
    ``v_col``), ``'ema'`` (momentum), ``'adam'`` (``mu``, ``nu``)."""
    found = {} if found is None else found
    if hasattr(tree, "_asdict"):
        tree = tree._asdict()
    if isinstance(tree, Mapping):
        keys = set(tree)
        kind = ("factored" if {"v_row", "v_col", "v"} <= keys else "ema" if "ema" in keys
                else "adam" if {"mu", "nu"} <= keys else None)
        if kind is not None:
            if kind in found:
                raise ValueError(f"two optax {kind} states in one opt_state")
            found[kind] = tree
            return found
        items = tree.values()
    elif isinstance(tree, (list, tuple)):
        items = tree
    else:
        return found
    for item in items:
        _optax_parts(item, found)
    return found


def factored_dims(shape: Tuple[int, ...], min_dim: int = 128) -> Optional[Tuple[int, int]]:
    """(second largest, largest) axis, as optax picks them for Adafactor's
    factored second moments (``min_dim_size_to_factor`` 128), or None."""
    if len(shape) < 2:
        return None
    order = np.argsort(shape)
    return None if shape[order[-2]] < min_dim else (int(order[-2]), int(order[-1]))


def _axis_mean(slots: Dict[str, np.ndarray], shape: Tuple[int, ...], axis: int) -> np.ndarray:
    """The mean over ``axis`` of a parameter's second moments, from its
    full ``v`` or its factored ``v_row`` / ``v_col`` (each the mean over one
    of the two factored axes: exact, as the moments are averages of g²)."""
    dims = factored_dims(shape)
    if dims is None:
        return slots["v"].mean(axis=axis)
    return {dims[1]: slots["v_row"], dims[0]: slots["v_col"]}[axis]


def _pack_adafactor_cells(cells: Dict[int, Dict[str, Dict[str, np.ndarray]]], layers: int, bidirectional: bool,
                          scope: str) -> Dict[str, Dict[str, np.ndarray]]:
    """Adafactor slots of ``OptimizedLSTMCell`` gate leaves → the slots of
    the packed w_ih, w_hh and bias (gates concatenated along the last
    axis).  The second moments of a packed block are rebuilt exactly from
    the gates' (the mean over the gate axis is the mean of the gates'
    means); the momentum is concatenated."""
    dirs = ("fwd", "bwd") if bidirectional else ("fwd",)
    out = {}
    for n, leaves in cells.items():
        layer, d = divmod(n, len(dirs))
        prefix = f"{scope}.lstm_{dirs[d]}_{layer}"
        for packed, leaf in (("w_ih", "i{}/kernel"), ("w_hh", "h{}/kernel"), ("bias", "h{}/bias")):
            gates = [leaves[leaf.format(g)] for g in _GATES]
            gate_shape = tuple(gates[0]["_shape"])
            shape = gate_shape[:-1] + (gate_shape[-1] * len(gates),)
            last = len(shape) - 1
            slots: Dict[str, np.ndarray] = {}
            dims = factored_dims(shape)
            if dims is None:  # then no gate, whose axes are no longer, is factored either
                slots["v"] = np.concatenate([g["v"] for g in gates], axis=last)
            else:
                def mean(axis):
                    parts = [_axis_mean(g, gate_shape, axis) for g in gates]
                    return np.mean(parts, axis=0) if axis == last else np.concatenate(parts, axis=-1)

                slots["v_row"], slots["v_col"] = mean(dims[1]), mean(dims[0])
            if "ema" in gates[0]:
                slots["ema"] = np.concatenate([g["ema"] for g in gates], axis=last)
            out[f"{prefix}_{packed}"] = slots
    return out


def optimizer_state_from_optax(
    opt_state, params: Mapping, lstm_scope: str = "decoder_lstm",
    lstm_layout: Callable[[], Tuple[int, bool]] = lambda: (1, True),
) -> Tuple[int, Dict[str, Dict[str, torch.Tensor]]]:
    """A restored optax ``opt_state`` (``optax.adafactor`` with or without
    momentum, ``optax.adam`` or ``adamw``) over the flax ``params`` → the
    update count and the state of the port's `train.optim.Adafactor` or
    `Adam`, keyed by the port's parameter names.  Adafactor's slots keep the
    JAX layout (as the port keeps them), Adam's take the port's layout;
    flax ``OptimizedLSTMCell`` gates are packed as `flax_to_state_dict`
    packs their parameters."""
    parts = _optax_parts(opt_state)
    adam = "adam" in parts
    if not adam and "factored" not in parts:
        raise ValueError(f"no optax adafactor or adam state found (found {sorted(parts)})")
    per_leaf: Dict[str, Dict[str, np.ndarray]] = {}
    cells: Dict[int, Dict[str, Dict[str, np.ndarray]]] = {}
    for path, p in _flatten(params):
        slots: Dict[str, np.ndarray] = {"_shape": np.asarray(p.shape)}
        if adam:
            slots.update({k: _leaf(parts["adam"][k], path) for k in ("mu", "nu")})
        else:
            factored = factored_dims(p.shape) is not None
            for k in (("v_row", "v_col") if factored else ("v",)):
                slots[k] = _leaf(parts["factored"][k], path)
            if "ema" in parts:
                slots["ema"] = _leaf(parts["ema"]["ema"], path)
        cell = re.fullmatch(r"OptimizedLSTMCell_(\d+)", path[1]) if len(path) > 2 else None
        if path[0] == lstm_scope and cell:
            cells.setdefault(int(cell[1]), {})["/".join(path[2:])] = slots
            continue
        if adam:
            slots = {k: _to_torch_layout(path, v) for k, v in slots.items() if k != "_shape"}
        per_leaf[_torch_name(path)] = {k: v for k, v in slots.items() if k != "_shape"}
    if cells:
        layers, bidirectional = lstm_layout()
        if adam:  # elementwise: concatenated as the parameters are
            for k in ("mu", "nu"):
                packed = _pack_lstm_cells({n: {leaf: s[k] for leaf, s in leaves.items()} for n, leaves in cells.items()},
                                          layers, bidirectional, lstm_scope)
                for name, value in packed.items():
                    per_leaf.setdefault(name, {})[k] = value
        else:
            per_leaf.update(_pack_adafactor_cells(cells, layers, bidirectional, lstm_scope))
    count_from = parts["adam"] if adam else parts["factored"]
    state = {name: {k: torch.from_numpy(np.array(v, dtype=np.float32, order="C")) for k, v in slots.items()}
             for name, slots in per_leaf.items()}
    return int(np.asarray(count_from["count"])), state


def _leaf(tree: Mapping, path: Tuple[str, ...]) -> np.ndarray:
    for key in path:
        tree = tree[key]
    return np.asarray(tree, dtype=np.float32)


def train_state_from_flax(restored: Mapping, config: ModelConfig, seed: int = 0) -> dict:
    """A JAX ``TrainState`` checkpoint as restored without a template
    (``{"step", "params", "batch_stats", "opt_state", "rng", "iterator"}``
    as nested dicts and lists of arrays) → the payload of the port's
    ``train/checkpoint.py``: model state dict, optimizer count and state,
    step, the data-iterator cursor.  The PRNG key cannot cross frameworks:
    the port's generator is seeded from ``seed`` at restore, and its dropout
    from ``seed`` and the step (`train.state.TrainState`)."""
    check_bridgeable(config)
    variables = {"params": restored["params"], "batch_stats": restored.get("batch_stats", {})}
    layout = (lambda: (config.decoder.lstm_layers, config.decoder.bidirectional))
    count, opt = optimizer_state_from_optax(restored["opt_state"], restored["params"], lstm_layout=layout)
    it = restored.get("iterator") or {"epoch": -1, "step": 0}
    return {
        "step": int(np.asarray(restored["step"])),
        "seed": int(seed),
        "model": flax_to_state_dict(variables, config),
        "optimizer": {"count": count, "state": opt},
        "generator": None,
        "iterator": {"epoch": int(np.asarray(it["epoch"])), "step": int(np.asarray(it["step"]))},
    }
