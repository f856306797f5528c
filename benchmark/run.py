"""The benchmark's command: one run of one cell on the card.

    python3 -m benchmark.run --workload <cell> --seed <n> --seconds <s> --trace <0|1>

Set-up (timed as ``setup_s``: imports, the kernels' build or load, the
corpus, the resident dataset, the trainer, the weights, the warm-up calls),
then the window: the cell's call again and again until ``--seconds`` have
passed.  ``--trace 0`` prints the cell's end-to-end metrics; ``--trace 1``
runs the same window, then profiles a few more calls, and prints the
per-layer metrics.  After the window the program is freed and the
reference decides ``correct``.  The last line of standard output is the
result; standard error ends with each compared number beside its limit.
Exits non-zero, with no result, without a CUDA card, and if JAX or the JAX
package was loaded.
"""

import time

STARTED = time.perf_counter()

import argparse  # noqa: E402
import json  # noqa: E402
import math  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(prog="benchmark.run")
    ap.add_argument("--workload", required=True)
    ap.add_argument("--seed", type=int, required=True)
    ap.add_argument("--seconds", type=float, required=True)
    ap.add_argument("--trace", type=int, choices=(0, 1), default=0)
    args = ap.parse_args(argv)

    import torch

    from benchmark import harness as H

    cell = H.load_cell(args.workload)
    chips = cell["entry"]["chips"]
    if not torch.cuda.is_available() or torch.cuda.device_count() < chips:
        H.log(f"benchmark.run: needs {chips} CUDA device(s), found "
              f"{torch.cuda.device_count() if torch.cuda.is_available() else 0}; no result")
        return 2
    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True).stdout.strip().splitlines()[:1]
    H.log(f"card: {card[0] if card else 'nvidia-smi gave nothing'}")
    kind = H.load_module("kinds", cell["traffic"]["kind"])
    # a kind whose run spans processes or cards brings its own execute
    run_cell = getattr(kind, "execute", execute)
    out = run_cell(cell, args.seed, args.seconds, bool(args.trace), torch.device("cuda", 0), STARTED)
    if out is None:
        return 3
    print(json.dumps(out))
    return 0


def execute(cell: dict, seed: int, seconds: float, trace: bool, device, started: float):
    """Set-up, window, traced calls and judgement of one run; the result
    object, or None where JAX was loaded.  A test drives it on the CPU."""
    import torch

    from benchmark import harness as H

    run = H.Run(cell, seed, device)
    run.setup()
    setup_s = time.perf_counter() - started
    H.log(f"setup_s {setup_s:.3f}")
    cuda = device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(device)
    win = run.window(seconds)
    steps = win["calls"] * run.steps_per_call
    rate = win["calls"] * run.audio_per_call / win["seconds"]
    H.log(f"window: {win['calls']} calls, {steps} steps, {win['seconds']:.3f} s, {rate:.3f} audio-s/s")
    metrics, extra = {}, {}
    if not trace:
        metrics[cell["moves"]] = {"value": rate, "unit": cell["units"][cell["moves"]]}
        metrics["setup_s"] = {"value": setup_s, "unit": cell["units"]["setup_s"]}
    else:
        from benchmark import trace as TR

        profiled = cell["traffic"]["profiled_calls"]
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            for _ in range(profiled):
                with torch.profiler.record_function(TR.SPAN):
                    run.call()
        t0 = time.perf_counter()
        tr = TR.read(prof)
        del prof
        H.log(f"trace read in {time.perf_counter() - t0:.2f} s")
        reading = Reading(cell, run, win, tr, profiled, device)
        for m in cell["per_layer"]:
            value = H.load_reader(m["name"])(reading)
            if value is not None:
                metrics[m["name"]] = {"value": value, "unit": m["unit"]}
        extra["breakdown"] = {
            "device_ops": sorted(([g, s] for g, (s, _) in tr.groups.items()), key=lambda x: -x[1])[:10],
            "idle_gaps": [[label, s] for label, s in tr.idle[:10]]}
    peak = torch.cuda.max_memory_allocated(device) if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(device) if cuda else "cpu", "count": 1,
                   "memory_peak_bytes": peak}
    if trace:
        device_info.update(busy_s=tr.busy_s, window_s=tr.span_s)
    H.log(f"memory peak: {peak} bytes")
    banned = H.banned_modules()
    if banned:
        H.log(f"benchmark.run: these modules were loaded, which the port must not load: {banned}; no result")
        return None
    run.free_program()
    t0 = time.perf_counter()
    readings = run.judge()
    table = H.compared(readings, cell["limits"])
    correct = H.passes(table) and win["failed"] == 0
    H.log(f"reference and comparison: {time.perf_counter() - t0:.2f} s; read, not compared: "
          + ", ".join(f"{k}={v}" for k, v in readings.items() if k not in table))
    for name, e in table.items():
        H.log(f"compared {name}: {e['value']!r} (limit {e['limit']!r})")
    attempted = run.kind.attempted(run, win["calls"])
    result = {"correct": correct, "attempted": attempted, "failed": win["failed"], "metrics": metrics,
              "device": device_info, **extra, "compared": table}
    return finite(result)


def finite(x):
    """``x`` with every float that JSON cannot carry (inf, nan) as a large
    number or null, numpy scalars as Python numbers."""
    if isinstance(x, dict):
        return {k: finite(v) for k, v in x.items()}
    if isinstance(x, (list, tuple)):
        return [finite(v) for v in x]
    if hasattr(x, "item") and not isinstance(x, (str, bytes)):
        x = x.item()
    if isinstance(x, float) and not math.isfinite(x):
        return None if math.isnan(x) else math.copysign(1e308, x)
    return x


class Reading:
    """What a per-layer metric's reader may read: the cell, the window's
    calls and time, the trace of the profiled calls, the card's peak, the
    least time of each roofline group in one step of this cell."""

    def __init__(self, cell, run, win, tr, profiled_calls, device):
        import torch

        from benchmark import yardstick as Y

        self.window_calls, self.window_s = win["calls"], win["seconds"]
        self.steps_per_call = run.steps_per_call
        self.trace = tr
        self.profiled_steps = profiled_calls * run.steps_per_call
        cfg, corpus, b = cell["cfg"], run.corpus, cell["traffic"]["batch"]
        pad = corpus.pcm.shape[1]
        frames = pad // cfg["features"]["hop_length"] + 1
        self.flops_per_step = run.kind.flops_per_step(cfg["model"], cfg["vocab_size"], b, frames)
        cuda = device.type == "cuda"
        self.peak_flops = Y.peak_bf16_flops(torch.cuda.get_device_name(device)) if cuda else math.nan
        self.peak_mem_bytes = torch.cuda.max_memory_allocated(device) if cuda else 0
        targets = [len(x) for x in corpus.ids] if corpus.ids is not None else [0] * len(corpus.lengths)
        # an epoch's least time by group, over its batches: every row once
        self.bounds_per_call = Y.step_bounds(cfg, corpus.lengths, targets, run.kind.TRAINING)
        self.profiled_calls = profiled_calls

    def roofline(self, group: str):
        """100 × Σ least time ÷ Σ device time of ``group``'s kernels over the
        profiled calls; None where the group ran nothing."""
        from benchmark.yardstick import ROOFLINE_GROUPS

        dev = sum(self.trace.groups.get(g, (0.0, 0))[0] for g in ROOFLINE_GROUPS[group])
        if dev <= 0.0:
            return None
        return 100.0 * self.bounds_per_call[group] * self.profiled_calls / dev


if __name__ == "__main__":
    sys.exit(main())
