"""Multi-process coordination, port of
`nn_conformer_for_speech_recognition_tpu/parallel/multihost.py`.

Every process runs the same program over its share of the data
(`parallel.mesh.initialize_multihost`, `data.datasets.shard_utterances`);
these helpers gather its host-side results: metrics as weighted means,
decoded token ids, pseudo-label strings as UTF-8 bytes.  They travel as
CPU tensors, which the process group carries over gloo.  Everything is the
identity in a single process, as in the JAX module.
"""

from __future__ import annotations

import hashlib
from typing import Dict, Tuple

import numpy as np
import torch
import torch.distributed as dist

from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import process_group_active


def is_multihost() -> bool:
    return process_group_active() and dist.get_world_size() > 1


def process_allgather(x: np.ndarray) -> np.ndarray:
    """(P, *x.shape): every process's ``x``, stacked in rank order; the
    shapes must agree."""
    t = torch.from_numpy(np.ascontiguousarray(x))
    out = [torch.empty_like(t) for _ in range(dist.get_world_size())]
    dist.all_gather(out, t)
    return torch.stack(out).numpy()


def gather_metric(value: float, weight: float = 1.0) -> Tuple[float, float]:
    """Weighted-mean reduction of a host-local metric across processes:
    (global mean, global weight)."""
    if not is_multihost():
        return value, weight
    total = process_allgather(np.asarray([value * weight, weight], np.float64))
    tw = float(total[:, 1].sum())
    return float(total[:, 0].sum() / max(tw, 1e-12)), tw


def gather_token_batches(ids: np.ndarray, lengths: np.ndarray) -> Tuple[np.ndarray, np.ndarray]:
    """All-gather (N, L) token ids and their (N,) lengths.  Processes may
    hold different N and L: both are padded to the global maximum for the
    gather, and the padding rows are dropped after it."""
    if not is_multihost():
        return ids, lengths
    n, l = ids.shape
    dims = process_allgather(np.asarray([n, l], np.int64))
    n_max, l_max = int(dims[:, 0].max()), int(dims[:, 1].max())
    ids_p = np.zeros((n_max, l_max), ids.dtype)
    ids_p[:n, :l] = ids
    len_p = np.full((n_max,), -1, np.int64)  # -1 marks a padding row
    len_p[:n] = lengths
    ids_g = process_allgather(ids_p).reshape(-1, l_max)
    len_g = process_allgather(len_p).reshape(-1)
    keep = len_g >= 0
    return ids_g[keep], len_g[keep]


def gather_pseudo_labels(labels: Dict[int, str]) -> Dict[int, str]:
    """Union of the processes' ``{global utterance index: text}`` maps.
    Texts travel as UTF-8 bytes padded to the global width (nothing is
    truncated), counts padded to the global maximum."""
    if not is_multihost():
        return labels
    items = sorted(labels.items())
    encoded = [text.encode("utf-8") for _, text in items]
    dims = process_allgather(np.asarray([len(items), max((len(b) for b in encoded), default=0)], np.int64))
    n_max = int(dims[:, 0].max())
    max_len = max(int(dims[:, 1].max()), 1)
    idx = np.full((n_max,), -1, np.int64)
    blen = np.zeros((n_max,), np.int64)
    txt = np.zeros((n_max, max_len), np.uint8)
    for row, ((i, _), b) in enumerate(zip(items, encoded)):
        idx[row], blen[row] = i, len(b)
        txt[row, : len(b)] = np.frombuffer(b, np.uint8)
    idx_g = process_allgather(idx).reshape(-1)
    blen_g = process_allgather(blen).reshape(-1)
    txt_g = process_allgather(txt).reshape(-1, max_len)
    return {int(i): bytes(row[: int(nb)]).decode("utf-8") for i, nb, row in zip(idx_g, blen_g, txt_g) if i >= 0}


def local_mesh(config=None) -> torch.device:
    """The devices this process evaluates on by itself.  One card a
    process: that is the rank's card (the current CUDA device), or the CPU
    where there is none."""
    del config
    return torch.device("cuda", torch.cuda.current_device()) if torch.cuda.is_available() else torch.device("cpu")


def host_local_state(state):
    """The state a process evaluates with by itself.  Every process holds
    the whole replicated state, so this is the state itself."""
    return state


def _named_tensors(params):
    """(name, tensor) pairs, sorted by name, of a module's parameters, a
    state dict, or a nested dict of tensors."""
    if isinstance(params, torch.nn.Module):
        return sorted(params.named_parameters())
    out = []

    def walk(tree, prefix):
        for k, v in tree.items():
            name = f"{prefix}.{k}" if prefix else str(k)
            if isinstance(v, dict):
                walk(v, name)
            else:
                out.append((name, v))

    walk(params, "")
    return sorted(out, key=lambda kv: kv[0])


def params_fingerprint(params) -> np.ndarray:
    """Order-stable 32-byte SHA-256 of every tensor's name and exact bytes."""
    h = hashlib.sha256()
    for name, t in _named_tensors(params):
        h.update(name.encode())
        h.update(torch.as_tensor(t).detach().cpu().contiguous().reshape(-1).view(torch.uint8).numpy().tobytes())
    return np.frombuffer(h.digest(), np.uint8)


def assert_params_in_sync(params) -> None:
    """Raises `AssertionError` unless every process holds bit-identical
    ``params`` (the data-parallel invariant); a no-op in a single process."""
    if not is_multihost():
        return
    digests = process_allgather(params_fingerprint(params))
    if not (digests == digests[0]).all():
        raise AssertionError(f"params diverged across processes: digests={digests.tolist()}")
