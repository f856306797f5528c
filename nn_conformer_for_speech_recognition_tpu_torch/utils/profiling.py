"""The port's tracing: ``torch.profiler`` windows, the program's phase spans
and the device time by kernel group.

* `trace(log_dir)`: ``torch.profiler`` over the host and, where there is
  one, the card; empties the phase table, then writes a Chrome trace
  (``chrome://tracing``, Perfetto) into ``log_dir`` and yields the
  profiler, whose `kernel_groups` sums the device time by kernel group;
* `annotate(name)`: a span of one of the program's phases.  It records only
  while a ``torch.profiler`` records (``torch.autograd._profiler_enabled()``,
  checked once a span): under `trace`, `utils.profile_step`, the
  benchmark's traced calls and ``torch.autograd.profiler.emit_nvtx()``, which
  turns the spans' ranges into NVTX ranges for Nsight Systems.  Otherwise it
  returns `OFF`, one shared no-op context: no allocation, no range, no event;
* `phase_table()`: per span name, its count, host seconds and device
  seconds; `reset_phases()` empties it.

A span opens a ``record_function`` range, so it sits in the profiler's
trace on the kernels' clock, and on a CUDA device records an event on the
current stream at its entry and at its exit.  Under the stream's ordering
the pair measures the device time the phase took, busy or idle: from the
end of the work queued before it to the end of its own.  The phase spans
listed below do not nest: a reader of the trace labels each idle gap of the
device with the outermost host range, so a span around others would take
their labels.  Four spans sit inside them and are read for their device
time alone: ``encoder.attention`` around each block's attention core
(`models.conformer.RelPositionMHSA`, both routes, both block kinds),
``encoder.cgmlp`` and ``encoder.merge`` around each E-Branchformer block's
cgMLP branch and merge module (`models.conformer.EBranchformerBlock`);
these three inside ``train.forward`` or ``label.forward``, twice under
``remat``, whose backward recomputes them; and ``train.all_reduce`` around each all-reduce of the flat gradient
(`train.loop.all_reduce_gradients`, inside ``train.backward``, only under a
process group).  A span that
an exception leaves counts nothing.  Spans are opened on one thread, the
one that drives the steps.

The spans, each path's contiguous over the host's work of a call: training
(`train.loop.Trainer.train`, the one epoch loop, also reached as
`Trainer.train_device_epochs`) ``train.order`` an epoch and a step's
``train.gather`` over resident data (``train.data_wait`` and ``train.put``
over a host dataset), then ``train.augment``, ``train.forward``, ``train.backward``,
``train.grad_norm``, ``train.optimizer`` (and ``train.greedy`` where the
step emits its ids), then ``train.pull``, ``train.epilogue``; labelling
(`Trainer.generate_labels`) a batch's ``label.input``, ``label.forward``,
``label.pull``, ``label.decode``.  The step functions
(`train.loop.make_augment_step`, `make_feature_train_step`,
`make_predict_step`) hold their own spans.

``start_server`` (the JAX package's live-capture endpoint) has no
counterpart: ``torch.profiler`` has no trace server.  Nor has its
``StepTimer``: `phase_table` gives the data wait (``train.data_wait``) and
each phase's host and device time.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, List, Optional, Tuple

import torch

OFF = contextlib.nullcontext()

_rows: Dict[str, list] = {}  # name → [count, host ns, device s or None]
_pending: List[Tuple[list, torch.cuda.Event, torch.cuda.Event]] = []  # event pairs not read yet, in stream order


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``with trace(dir) as prof: run_steps()`` writes
    ``dir/trace_<pid>_<ns>.json`` when the block ends; `phase_table` then
    holds the block's spans."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    reset_phases()
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


def annotate(name: str):
    """A span named ``name`` while a profiler records, else `OFF`."""
    return _Span(name) if torch.autograd._profiler_enabled() else OFF


class _Span:
    __slots__ = ("name", "range", "start", "t0")

    def __init__(self, name: str):
        self.name = name

    def __enter__(self):
        self.range = torch.profiler.record_function(self.name)
        self.range.__enter__()
        self.start = None
        if torch.cuda.is_initialized():
            self.start = torch.cuda.Event(enable_timing=True)
            self.start.record()
        self.t0 = time.perf_counter_ns()
        return self

    def __exit__(self, kind, value, tb):
        host = time.perf_counter_ns() - self.t0
        end = None
        if self.start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record()
        self.range.__exit__(kind, value, tb)
        if kind is None:
            row = _rows.setdefault(self.name, [0, 0, None])
            row[0] += 1
            row[1] += host
            if end is not None:
                _pending.append((row, self.start, end))
        _read_events(wait=False)  # keeps the pending pairs to those the card has not passed
        return False


def _read_events(wait: bool) -> None:
    """Adds each pending event pair's device time to its row: every pair,
    after one synchronise, with ``wait``; else those up to the first pair
    the card has not passed."""
    if wait and _pending:
        torch.cuda.synchronize()
    done = 0
    for row, start, end in _pending:
        if not (wait or end.query()):
            break
        row[2] = (row[2] or 0.0) + start.elapsed_time(end) / 1e3
        done += 1
    del _pending[:done]


def phase_table() -> Dict[str, Tuple[int, float, Optional[float]]]:
    """{span name: (count, host s, device s)} over every span recorded
    since the last `reset_phases` (device s None without a CUDA device).
    Waits for the card once."""
    _read_events(wait=True)
    return {name: (n, host * 1e-9, dev) for name, (n, host, dev) in _rows.items()}


def reset_phases() -> None:
    _rows.clear()
    _pending.clear()


def kernel_groups(prof: torch.profiler.profile, calls: int = 1) -> Dict[str, Tuple[float, float]]:
    """{kernel group: (device ms, launches)} a call of a profiled window of
    ``calls`` calls, each kernel in the first group of
    `utils.profile_step.GROUPS` its name matches; kernel rows only (the op
    rows repeat their kernels' time, and a span's range on the device's
    timeline, a user annotation, spans its kernels)."""
    from torch.autograd import DeviceType

    from nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step import GROUPS, REST, group_of

    groups = {name: [0.0, 0.0] for name in (*(g for g, _ in GROUPS), REST)}
    for event in prof.key_averages():
        if event.device_type == DeviceType.CUDA and not event.is_user_annotation:
            entry = groups[group_of(event.key)]
            entry[0] += event.self_device_time_total / 1e3 / calls
            entry[1] += event.count / calls
    return {name: (ms, n) for name, (ms, n) in groups.items()}
