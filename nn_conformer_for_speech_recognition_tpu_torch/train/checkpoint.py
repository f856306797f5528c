"""Checkpointing, port of
`nn_conformer_for_speech_recognition_tpu/train/checkpoint.py` on
``torch.save`` / ``torch.load`` (the JAX package uses orbax).

A checkpoint is a directory holding ``state.pt``: the model's
``state_dict`` (parameters and batch statistics), the Adafactor state and
its count, the step, the seed, the state of the ``torch.Generator`` that
SpecAugment and the waveform noise draw from (None in a checkpoint
converted from the JAX package: the generator is then seeded from the
seed, as `TrainState.create` seeds it), and the data-iterator cursor
``{"epoch", "step"}``.  The epoch stream is a function of (seed, epoch), so
the cursor is complete: a resumed run skips ``step`` batches of epoch
``epoch`` and continues bit for bit.  The layout of a checkpoint directory
tree (``step_%08d``, ``best``) is the JAX package's.

Restoring copies into the template state's own tensors, so the step
functions bound to its model keep working, and returns that state.

Under a process group (data parallelism) rank 0 writes and rotates while
the others wait at a barrier; every rank restores.  Under tensor
parallelism every rank first gathers its model group's shares of the
split parameters and of their optimizer slots, so that rank 0 writes the
whole state, the state a one-process run holds: a checkpoint does not
depend on ``model_parallel_size``, and a rank restoring it cuts its own
shares from it.
"""

from __future__ import annotations

import os
import shutil
from typing import Dict, Optional

import torch

from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import (
    barrier,
    full_state_dict,
    gather_shards,
    is_main_process,
    local_state_dict,
    tensor_parallel_plan,
)
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState

STATE_FILE = "state.pt"


def whole_optimizer_slots(state: TrainState) -> Dict[str, Dict[str, torch.Tensor]]:
    """The optimizer's slots, those of split parameters gathered whole over
    the model group (a collective)."""
    plan = tensor_parallel_plan(state.model)
    slots = state.optimizer.state
    if plan is None:
        return slots
    specs = state.optimizer.slot_specs
    return {name: {k: v if specs[name][k] is None else gather_shards(v, specs[name][k], plan.axis)
                   for k, v in st.items()} for name, st in slots.items()}


def _payload(state: TrainState, iterator: Optional[dict] = None) -> dict:
    return {
        "step": state.step,
        "seed": state.seed,
        "model": full_state_dict(state.model),
        "optimizer": {"count": state.optimizer.count, "state": whole_optimizer_slots(state)},
        "generator": state.generator.get_state(),
        # (epoch, step) of the next batch; epoch -1: no cursor was given
        "iterator": {
            "epoch": (iterator or {}).get("epoch", -1),
            "step": (iterator or {}).get("step", 0),
        },
    }


def _gathered(state: TrainState, iterator: Optional[dict]) -> Optional[dict]:
    """The payload where this rank writes it (rank 0), None elsewhere; every
    rank of a split model takes part in the gathers."""
    if tensor_parallel_plan(state.model) is None and not is_main_process():
        return None
    payload = _payload(state, iterator)
    return payload if is_main_process() else None


def save_state(path: str, state: TrainState, iterator: Optional[dict] = None) -> None:
    """Writes ``path/state.pt``; the file appears under its name only once
    it is complete.  Under a process group rank 0 writes and every rank
    returns once it has."""
    payload = _gathered(state, iterator)
    if payload is not None:
        _write_state(path, payload)
    barrier()


def _write_state(path: str, payload: dict) -> None:
    path = os.path.abspath(path)
    os.makedirs(path, exist_ok=True)
    tmp = os.path.join(path, f"{STATE_FILE}.{os.getpid()}.tmp")
    torch.save(payload, tmp)
    os.replace(tmp, os.path.join(path, STATE_FILE))


def _load(path: str, device) -> dict:
    return torch.load(os.path.join(os.path.abspath(path), STATE_FILE), map_location=device, weights_only=True)


def restore_state(path: str, template: TrainState, with_iterator: bool = False):
    """Fills ``template`` (model, optimizer, generator, step, seed) from the
    checkpoint and returns it; with ``with_iterator`` also the cursor, or
    None where the checkpoint was saved without one."""
    device = next(template.model.parameters()).device
    saved = _load(path, device)
    template.model.load_state_dict(local_state_dict(template.model, saved["model"]), strict=True)
    plan = tensor_parallel_plan(template.model)
    opt = template.optimizer
    if set(saved["optimizer"]["state"]) != set(opt.state):
        raise ValueError("checkpoint and optimizer hold different parameters")
    for name, slots in saved["optimizer"]["state"].items():
        if set(slots) != set(opt.state[name]):
            raise ValueError(f"checkpoint and optimizer disagree on the state of {name}")
        specs = opt.slot_specs[name]
        opt.state[name] = {k: (v if plan is None or specs[k] is None else specs[k].local(v, plan.axis.rank)).to(device)
                           for k, v in slots.items()}
    opt.count = int(saved["optimizer"]["count"])
    template.step, template.seed = int(saved["step"]), int(saved["seed"])
    if saved["generator"] is None:  # converted from the JAX package (`convert.train_state_from_flax`)
        template.generator.manual_seed(template.seed)
    else:
        template.generator.set_state(saved["generator"].cpu())
    if with_iterator:
        it = {"epoch": int(saved["iterator"]["epoch"]), "step": int(saved["iterator"]["step"])}
        return template, (it if it["epoch"] >= 0 else None)
    return template


def restore_encoder_params(path: str, model: torch.nn.Module) -> None:
    """Copies only the encoder's and the subsampling's parameters from the
    checkpoint into ``model`` (the 'load a pretrained conformer' path): the
    head, every batch statistic and whatever the checkpoint lacks stay."""
    saved: Dict[str, torch.Tensor] = local_state_dict(model, _load(path, "cpu")["model"])
    with torch.no_grad():
        for name, p in model.named_parameters():
            if name.startswith(("encoder.", "subsampling.")) and name in saved:
                p.copy_(saved[name])


class CheckpointManager:
    """Rotating checkpoint manager: keeps the newest ``keep`` checkpoints
    (``step_%08d``), plus ``best`` by the lowest metric given; under a
    process group rank 0 writes and rotates, the others wait."""

    def __init__(self, directory: str, keep: int = 3):
        self.directory = os.path.abspath(directory)
        self.keep = keep
        os.makedirs(self.directory, exist_ok=True)
        self.best_metric: Optional[float] = None

    def _step_dirs(self):
        out = []
        for name in os.listdir(self.directory):
            if name.startswith("step_"):
                try:
                    out.append((int(name.split("_")[1]), name))
                except ValueError:
                    pass
        return sorted(out)

    def save(self, state: TrainState, metric: Optional[float] = None, iterator: Optional[dict] = None) -> str:
        path = os.path.join(self.directory, f"step_{int(state.step):08d}")
        best = metric is not None and (self.best_metric is None or metric < self.best_metric)
        if best:
            self.best_metric = metric
        payload = _gathered(state, iterator)
        if payload is not None:
            _write_state(path, payload)
            if best:
                shutil.rmtree(os.path.join(self.directory, "best"), ignore_errors=True)
                shutil.copytree(path, os.path.join(self.directory, "best"))
            dirs = self._step_dirs()
            while len(dirs) > self.keep:
                _, name = dirs.pop(0)
                shutil.rmtree(os.path.join(self.directory, name), ignore_errors=True)
        barrier()
        return path

    def latest(self) -> Optional[str]:
        dirs = self._step_dirs()
        return os.path.join(self.directory, dirs[-1][1]) if dirs else None

    def restore_latest(self, template: TrainState) -> Optional[TrainState]:
        path = self.latest()
        return restore_state(path, template) if path else None

    def restore_latest_with_iterator(self, template: TrainState):
        """(state, iterator|None) of the newest checkpoint, or (None, None).
        ``iterator`` = {"epoch", "step"}: where the next batch comes from."""
        path = self.latest()
        if not path:
            return None, None
        return restore_state(path, template, with_iterator=True)
