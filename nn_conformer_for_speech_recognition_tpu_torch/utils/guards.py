"""Numerics guards, port of `nn_conformer_for_speech_recognition_tpu/utils/guards.py`.

* `tree_finite_report` and `assert_all_finite`: a host-side audit of a
  module, a state dict or a nested dict of tensors;
* `nan_guard`: passes a value through and reports a NaN or an Inf in it.
  On the CPU it prints at once, as the JAX function's ``jax.debug.print``;
  on the card it only records a flag on the device (`FiniteFlags`), read at
  the caller's next synchronisation, so the guard adds no wait.
  ``torch._assert_async`` is not used: a failed device-side assert leaves
  the CUDA context unusable.
* `check_step`, the counterpart of ``checkify_step``: wraps a train step so
  that it returns ``(error, outputs)``, with the loss and every gradient
  checked on the device; ``error.throw()`` raises `FloatingPointError`.
"""

from __future__ import annotations

from typing import Callable, Dict, Iterator, List, Optional, Tuple

import torch


def _leaves(tree, prefix: str = "") -> Iterator[Tuple[str, torch.Tensor]]:
    """(path, tensor) of a module's state dict, a state dict, or a nested
    dict, with nested keys joined by '/' as the JAX function joins a
    pytree's."""
    if isinstance(tree, torch.nn.Module):
        tree = tree.state_dict()
    for key, value in tree.items():
        path = f"{prefix}/{key}" if prefix else str(key)
        if isinstance(value, dict):
            yield from _leaves(value, path)
        else:
            yield path, torch.as_tensor(value)


def tree_finite_report(tree) -> Dict[str, Tuple[int, int]]:
    """{path: (nan_count, inf_count)} of the floating leaves that hold
    either; one pull from the device for the whole tree."""
    named = [(p, t) for p, t in _leaves(tree) if t.is_floating_point()]
    if not named:
        return {}
    home = named[0][1].device
    counts = torch.stack([torch.stack([torch.isnan(t).sum(), torch.isinf(t).sum()]).to(home) for _, t in named]).cpu()
    return {p: (int(n), int(i)) for (p, _), (n, i) in zip(named, counts.tolist()) if n or i}


def assert_all_finite(tree, what: str = "tree") -> None:
    bad = tree_finite_report(tree)
    if bad:
        raise FloatingPointError(f"non-finite values in {what}: {bad}")


class FiniteFlags:
    """Device flags of the guarded values that held a NaN or an Inf, by
    name; `nan_guard` sets them without a wait, `bad` reads them."""

    def __init__(self):
        self._flags: Dict[str, torch.Tensor] = {}

    def record(self, x: torch.Tensor, name: str) -> None:
        bad = ~torch.isfinite(x).all()
        seen = self._flags.get(name)
        self._flags[name] = bad if seen is None else seen | bad

    def bad(self) -> List[str]:
        """The names whose values held a NaN or an Inf (one pull)."""
        if not self._flags:
            return []
        home = next(iter(self._flags.values())).device
        pulled = torch.stack([f.to(home) for f in self._flags.values()]).tolist()
        return [name for name, b in zip(self._flags, pulled) if b]


def nan_guard(x: torch.Tensor, name: str = "value", flags: Optional[FiniteFlags] = None) -> torch.Tensor:
    """Returns ``x``.  With ``flags`` records whether ``x`` is finite on its
    device; without, on the CPU, prints when it is not.  A CUDA tensor
    needs ``flags``: a print would wait for the card."""
    if flags is not None:
        flags.record(x, name)
    elif x.device.type == "cpu":
        if not bool(torch.isfinite(x).all()):
            print(f"NaN/Inf detected in {name}: True")
    else:
        raise ValueError("nan_guard on a device tensor records into a FiniteFlags: pass flags=")
    return x


class StepError:
    """The checks of one step: device flags until `get` or `throw` reads
    them."""

    def __init__(self, names: List[str], flags: torch.Tensor):
        self.names, self._flags = names, flags

    def get(self) -> Optional[str]:
        bad = [n for n, b in zip(self.names, self._flags.cpu().tolist()) if b]
        return f"non-finite values in {', '.join(bad)}" if bad else None

    def throw(self) -> None:
        msg = self.get()
        if msg:
            raise FloatingPointError(msg)


def check_step(step_fn: Callable) -> Callable:
    """Wraps ``step_fn(state, ...) → (state, metrics)`` (a train step of
    `train.loop`) into ``(state, ...) → (error, (state, metrics))``:
    ``error`` holds, on the device, whether ``metrics["loss"]`` and each
    parameter's gradient of the step held a NaN or an Inf; the step itself
    runs unchanged."""

    def checked(state, *args, **kwargs):
        state, metrics = step_fn(state, *args, **kwargs)
        named = [("loss", metrics["loss"])] + [
            (f"grad/{n}", p.grad) for n, p in state.model.named_parameters() if p.grad is not None]
        flags = torch.stack([~torch.isfinite(t).all() for _, t in named])
        return StepError([n for n, _ in named], flags), (state, metrics)

    return checked
