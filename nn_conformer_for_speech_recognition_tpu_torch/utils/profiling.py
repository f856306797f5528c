"""Tracing and step timing, port of
`nn_conformer_for_speech_recognition_tpu/utils/profiling.py` over
``torch.profiler`` and CUDA events.

* `trace(log_dir)`: ``torch.profiler`` over the host and, where there is
  one, the card; writes a Chrome trace (``chrome://tracing``, Perfetto)
  into ``log_dir`` and yields the profiler, whose `kernel_groups` sums the
  device time by kernel group;
* `annotate(name)`: a named region on the trace timeline
  (``record_function``), and an NVTX range on the card;
* `StepTimer`: host data wait against step time, audio-seconds per second,
  with the JAX class's summary keys; on the card also the device time of
  each step, from CUDA events.

``start_server`` (the JAX package's live-capture endpoint) has no
counterpart: ``torch.profiler`` has no trace server.
"""

from __future__ import annotations

import contextlib
import os
import time
from typing import Dict, Iterator, Optional, Tuple

import torch


@contextlib.contextmanager
def trace(log_dir: str) -> Iterator[torch.profiler.profile]:
    """``with trace(dir) as prof: run_steps()`` writes
    ``dir/trace_<pid>_<ns>.json`` when the block ends."""
    activities = [torch.profiler.ProfilerActivity.CPU]
    if torch.cuda.is_available():
        activities.append(torch.profiler.ProfilerActivity.CUDA)
    os.makedirs(log_dir, exist_ok=True)
    with torch.profiler.profile(activities=activities) as prof:
        yield prof
    prof.export_chrome_trace(os.path.join(log_dir, f"trace_{os.getpid()}_{time.time_ns()}.json"))


@contextlib.contextmanager
def annotate(name: str) -> Iterator[None]:
    """Named region visible on the trace timeline (and to NVTX tools)."""
    nvtx = torch.cuda.is_available()
    if nvtx:
        torch.cuda.nvtx.range_push(name)
    try:
        with torch.profiler.record_function(name):
            yield
    finally:
        if nvtx:
            torch.cuda.nvtx.range_pop()


def kernel_groups(prof: torch.profiler.profile, calls: int = 1) -> Dict[str, Tuple[float, float]]:
    """{kernel group: (device ms, launches)} a call of a profiled window of
    ``calls`` calls, each kernel in the first group of
    `utils.profile_step.GROUPS` its name matches; kernel rows only (the op
    rows repeat their kernels' time)."""
    from torch.autograd import DeviceType

    from nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step import GROUPS, REST, group_of

    groups = {name: [0.0, 0.0] for name in (*(g for g, _ in GROUPS), REST)}
    for event in prof.key_averages():
        if event.device_type == DeviceType.CUDA:
            entry = groups[group_of(event.key)]
            entry[0] += event.self_device_time_total / 1e3 / calls
            entry[1] += event.count / calls
    return {name: (ms, n) for name, (ms, n) in groups.items()}


class StepTimer:
    """Per-step accounting of the host's data wait against the step.

    Usage::

        timer = StepTimer(sample_rate=16000)
        for batch in ds.epoch():
            timer.data_ready()
            state, metrics = step(state, *args)
            timer.step_done(batch_audio_samples)
        print(timer.summary())

    A step's host time is the time to queue it: a train loop on the card
    waits only where it pulls a value.  With ``device`` a CUDA device, each
    step is also bracketed by CUDA events on that device's stream, and
    `summary` (which then waits for the card) adds ``device_s``, the time
    the card spent between them.
    """

    def __init__(self, sample_rate: int = 16000, device: Optional[torch.device] = None):
        self.sample_rate = sample_rate
        self.device = torch.device(device) if device is not None else None
        self.reset()

    def _on_card(self) -> bool:
        return self.device is not None and self.device.type == "cuda"

    def reset(self) -> None:
        self._last = time.perf_counter()
        self.data_s = 0.0
        self.compute_s = 0.0
        self.audio_samples = 0
        self.steps = 0
        self._events = []  # (start, end) of each step on the card
        self._start = None

    def data_ready(self) -> None:
        now = time.perf_counter()
        self.data_s += now - self._last
        self._last = now
        if self._on_card():
            self._start = torch.cuda.Event(enable_timing=True)
            self._start.record(torch.cuda.current_stream(self.device))

    def step_done(self, audio_samples: int) -> None:
        now = time.perf_counter()
        self.compute_s += now - self._last
        self._last = now
        self.audio_samples += int(audio_samples)
        self.steps += 1
        if self._on_card() and self._start is not None:
            end = torch.cuda.Event(enable_timing=True)
            end.record(torch.cuda.current_stream(self.device))
            self._events.append((self._start, end))
            self._start = None

    @property
    def audio_seconds_per_second(self) -> float:
        total = self.data_s + self.compute_s
        return (self.audio_samples / self.sample_rate) / max(total, 1e-9)

    def device_seconds(self) -> float:
        """The card's time over the steps' event pairs (waits for it)."""
        if not self._events:
            return 0.0
        self._events[-1][1].synchronize()
        return sum(start.elapsed_time(end) for start, end in self._events) / 1e3

    def summary(self) -> Dict[str, float]:
        total = self.data_s + self.compute_s
        out = {
            "steps": self.steps,
            "data_wait_s": round(self.data_s, 3),
            "compute_s": round(self.compute_s, 3),
            "data_wait_frac": round(self.data_s / max(total, 1e-9), 3),
            "audio_seconds_per_second": round(self.audio_seconds_per_second, 1),
        }
        if self._on_card():
            out["device_s"] = round(self.device_seconds(), 6)
        return out
