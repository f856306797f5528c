"""Reading a ``torch.profiler`` trace of the profiled calls: the device's
operations (kernels, copies, sets), the kernels by group, the union of the
device's busy intervals over the profiled span, and the idle gaps labelled
with what the host was doing in each."""

from __future__ import annotations

import dataclasses
from collections import defaultdict
from typing import Dict, List, Tuple

import numpy as np
import torch
from torch.autograd import DeviceType

from benchmark.yardstick import group_of

SPAN = "bench.call"  # the benchmark's own span around each profiled call


@dataclasses.dataclass
class Trace:
    span_s: float  # from the first profiled call's start to the last one's end
    busy_s: float  # union of the device's operation intervals inside the span
    launches: int  # kernels (not copies or sets)
    groups: Dict[str, Tuple[float, int]]  # group → (device seconds, kernels)
    idle: List[Tuple[str, float]]  # (what the host did, idle seconds), the largest first


def _top_level(starts: np.ndarray, ends: np.ndarray) -> np.ndarray:
    """Indices of the intervals no other one (sorted by start) encloses."""
    keep, reach = [], -np.inf
    for i in np.argsort(starts, kind="stable"):
        if starts[i] >= reach or ends[i] > reach:  # after the last one, or overlapping it without nesting
            keep.append(i)
            reach = ends[i]
    return np.asarray(keep, np.int64)


def read(prof: torch.profiler.profile) -> Trace:
    dev, cpu, spans = [], [], []
    for e in prof.profiler.kineto_results.events():
        if e.device_type() == DeviceType.CUDA:
            if not e.is_user_annotation():
                dev.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name()))
        elif e.name() == SPAN:
            spans.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.start_thread_id()))
        elif not e.name().startswith(("cuda", "ProfilerStep")):
            cpu.append((e.start_ns(), e.start_ns() + e.duration_ns(), e.name(), e.start_thread_id()))
    return summarise(dev, cpu, spans)


def summarise(dev, cpu, spans) -> Trace:
    """``dev``: the device's operations (start ns, end ns, name); ``cpu``:
    the host's ops (start, end, name, thread); ``spans``: the benchmark's
    spans around the profiled calls (start, end, thread)."""
    if not spans or not dev:
        raise RuntimeError("the profiler recorded no span or no device operation")
    lo, hi = min(s for s, _, _ in spans), max(e for _, e, _ in spans)
    main = spans[0][2]

    groups: Dict[str, List[float]] = defaultdict(lambda: [0.0, 0])
    named: Dict[str, str] = {}
    launches = 0
    for s, e, name in dev:
        if name.startswith(("Memcpy", "Memset")):
            continue
        g = named.setdefault(name, group_of(name))
        groups[g][0] += (e - s) * 1e-9
        groups[g][1] += 1
        launches += 1

    iv = np.array([(max(s, lo), min(e, hi)) for s, e, _ in dev if e > lo and s < hi], np.float64)
    iv = iv[np.argsort(iv[:, 0])]
    reach = np.maximum.accumulate(iv[:, 1])
    starts_new = np.concatenate([[True], iv[1:, 0] > reach[:-1]])
    seg_start = iv[starts_new, 0]
    seg_end = np.append(reach[np.flatnonzero(starts_new)[1:] - 1], reach[-1])
    busy = float((seg_end - seg_start).sum()) * 1e-9
    gap_start = np.concatenate([[lo], seg_end])
    gap_end = np.concatenate([seg_start, [hi]])
    gap = gap_end - gap_start
    keep = gap > 0
    gap_start, gap, mid = gap_start[keep], gap[keep], (gap_start[keep] + gap_end[keep]) / 2

    labels = np.full(len(mid), "host: no op recorded (Python)", dtype=object)
    by_thread: Dict[int, list] = defaultdict(list)
    for s, e, name, tid in cpu:
        by_thread[tid].append((s, e, name))
    for tid in sorted(by_thread, key=lambda t: t != main):  # the main thread first, then the others
        rows = by_thread[tid]
        st = np.array([r[0] for r in rows], np.float64)
        en = np.array([r[1] for r in rows], np.float64)
        top = _top_level(st, en)
        ts, te = st[top], en[top]
        at = np.searchsorted(ts, mid, side="right") - 1
        hit = (at >= 0) & (mid < te[np.clip(at, 0, None)]) & (labels == "host: no op recorded (Python)")
        prefix = "" if tid == main else "other thread: "
        for j in np.flatnonzero(hit):
            labels[j] = prefix + rows[top[at[j]]][2]
    idle: Dict[str, float] = defaultdict(float)
    for label, g in zip(labels, gap):
        idle[label] += float(g) * 1e-9
    return Trace(span_s=(hi - lo) * 1e-9, busy_s=busy, launches=launches,
                 groups={k: (v[0], int(v[1])) for k, v in groups.items()},
                 idle=sorted(idle.items(), key=lambda kv: -kv[1]))
