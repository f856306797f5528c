"""A ``train_dp`` mix: `kinds/train.py`'s window (``Trainer.train(dataset,
epochs=1)`` over a ``DeviceResidentDataset``, an epoch of global batches a
call) run data-parallel by the port's ``Trainer`` over a process group of
one process a card, as ``torchrun`` starts it: every rank holds the whole
corpus and computes on its share of each global batch, one all-reduce of
the flat gradient a step.  The rate counts every card's audio.

``execute`` (in place of ``run.execute``) starts one worker process a card
(this module under ``python -m``, with ``torchrun``'s environment and a
free ``localhost`` port) and watches them: where one exits with an error,
or the run outlasts ``--seconds`` plus `LIMIT_S`, it kills every one and
raises, so that a failed rank never hangs the run.  The process group has
a bounded timeout (`TIMEOUT_S`) as well.  Rank 0 decides when the window
ends and tells the others after each call; it alone traces and reports.

The set-up, the judge and the control run on every rank of a process
group: they join the one ``torchrun`` describes where none exists, so the
cell's limits are set as every cell's are, by ``benchmark.control`` under
``torchrun --nproc-per-node <cards>``.  The judge is
`reference.steps.follow_steps` on the rank's share of the global batch,
the batch statistics and the gradients summed over the ranks.
"""

from __future__ import annotations

import argparse
import datetime
import json
import os
import signal
import socket
import subprocess
import sys
import tempfile
import time
from pathlib import Path
from typing import Dict

import torch

from benchmark import harness as H
from benchmark import train_setup as TS
from benchmark.reference import judge as J
from benchmark.reference import steps as S
from benchmark.reference.model import ConformerCTC

TRAIN = H.load_module("kinds", "train")
MOVES = TRAIN.MOVES
TRAINING = True
call, failed, attempted, flops_per_step = TRAIN.call, TRAIN.failed, TRAIN.attempted, TRAIN.flops_per_step
TIMEOUT_S = 600  # a collective that waits this long on a lost rank fails
LIMIT_S = 1800  # set-up, traced calls and the reference, beyond the window


def join(device) -> torch.device:
    """Joins the process group ``torchrun``'s environment describes, unless
    one exists; returns this rank's device (its card, ``LOCAL_RANK``)."""
    import torch.distributed as dist

    device = torch.device(device)
    local = int(os.environ.get("LOCAL_RANK", "0"))
    if device.type == "cuda":
        device = torch.device("cuda", local)
        torch.cuda.set_device(device)
    if not dist.is_initialized():
        dist.init_process_group("cpu:gloo,cuda:nccl" if device.type == "cuda" else "gloo", init_method="env://",
                                timeout=datetime.timedelta(seconds=TIMEOUT_S))
    return device


def _rank_world():
    import torch.distributed as dist

    return dist.get_rank(), dist.get_world_size()


def setup(run) -> None:
    """On every rank: the resident corpus and the data-parallel trainer,
    then `train_setup.first_calls`."""
    run.device = join(run.device)
    TS.resident_trainer(run, H.make_weights)
    TS.first_calls(run)


def judge(run) -> Dict[str, float]:
    w = H.make_weights(run.cfg, run.seed, run.device)
    rank, world = _rank_world()
    ref = S.follow_steps(ConformerCTC, run.cfg, run.traffic, run.corpus, w, run.seed, run.device, rank=rank,
                         world=world)
    return TS.readings(run, ref, w)


def control(cell: dict, seed: int, device):
    """On every rank: the reference in fp8 and the fault of half of each
    global batch left out, judged against the reference."""
    from benchmark import traffic as T
    from benchmark.reference.ops import Rounding, fp8_round

    device = join(device)
    rank, world = _rank_world()
    cfg, traffic = cell["cfg"], cell["traffic"]
    corpus = T.make_corpus(traffic, cfg, seed, device)
    w = H.make_weights(cfg, seed, device)

    def ref(**kw):
        return S.follow_steps(ConformerCTC, cfg, traffic, corpus, w, seed, device, rank=rank, world=world, **kw)

    base = ref()
    for side, kw in (("control", {"rounding": Rounding(fp8_round)}), ("fault: half the batch", {"drop_half": True})):
        yield side, J.train_readings(ref(**kw), base)


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def execute(cell: dict, seed: int, seconds: float, trace: bool, device, started: float):
    """The run over ``cell['entry']['chips']`` cards (processes on the CPU
    where ``device`` is the CPU, for the tests); returns rank 0's result."""
    world = cell["entry"]["chips"]
    if device.type == "cuda":
        from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

        build.build()  # once, before the workers load it
    folder = tempfile.mkdtemp(prefix="bench-dp-")
    cell_file, out_file = Path(folder) / "cell.json", Path(folder) / "result.json"
    cell_file.write_text(json.dumps(cell))
    started_wall = time.time() - (time.perf_counter() - started)
    env = dict(os.environ, WORLD_SIZE=str(world), MASTER_ADDR="localhost", MASTER_PORT=str(_free_port()))
    if device.type == "cpu":
        env.update(OMP_NUM_THREADS="1")
    procs = []
    try:
        for rank in range(world):
            argv = [sys.executable, "-m", "benchmark.kinds.train_dp", "--cell", str(cell_file), "--seed", str(seed),
                    "--seconds", str(seconds), "--trace", str(int(trace)), "--device", device.type,
                    "--started-wall", repr(started_wall), "--out", str(out_file)]
            procs.append(subprocess.Popen(argv, cwd=H.REPO, start_new_session=True, stdout=sys.stderr,
                                          env=dict(env, RANK=str(rank), LOCAL_RANK=str(rank))))
        deadline = time.monotonic() + seconds + LIMIT_S
        while True:
            codes = [p.poll() for p in procs]
            bad = [r for r, c in enumerate(codes) if c not in (None, 0)]
            if bad or time.monotonic() > deadline:
                what = f"rank {bad[0]} exited with {codes[bad[0]]}" if bad else "the run outlasted its limit"
                raise SystemExit(f"benchmark.run: {what}; every rank stopped, no result")
            if all(c == 0 for c in codes):
                break
            time.sleep(0.2)
        return json.loads(out_file.read_text())
    finally:
        for p in procs:
            if p.poll() is None:
                try:
                    os.killpg(p.pid, signal.SIGKILL)
                except ProcessLookupError:
                    pass
                p.wait()
        for f in (cell_file, out_file):
            f.unlink(missing_ok=True)
        os.rmdir(folder)


def _window(run, seconds: float) -> dict:
    """`harness.Run.window` over the ranks: rank 0 decides after each call
    whether another starts, and every rank follows."""
    import torch.distributed as dist

    rank, _ = _rank_world()
    failed_steps, calls, times = 0, 0, []
    t0 = last = time.perf_counter()
    deadline = t0 + seconds
    while True:
        out = run.call()
        calls += 1
        now = time.perf_counter()
        times.append(now - last)
        last = now
        failed_steps += run.kind.failed(run, out)
        end = time.perf_counter()
        go = torch.tensor([int(rank == 0 and end < deadline)])
        dist.broadcast(go, src=0)
        if not go.item():
            if rank == 0:
                H.log("call seconds: " + " ".join(f"{x:.4f}" for x in times))
            return {"calls": calls, "seconds": end - t0, "failed": failed_steps}


def worker(args) -> int:
    """One rank of `execute`'s run."""
    import torch.distributed as dist

    from benchmark import run as R

    cell = json.loads(Path(args.cell).read_text())
    run = H.Run(cell, args.seed, torch.device(args.device))
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import barrier

    run.setup()  # joins the process group
    barrier()
    rank, world = _rank_world()
    setup_s = time.time() - args.started_wall
    main = rank == 0
    if main:
        H.log(f"setup_s {setup_s:.3f}")
    cuda = run.device.type == "cuda"
    if cuda:
        torch.cuda.reset_peak_memory_stats(run.device)
    win = _window(run, args.seconds)
    rate = win["calls"] * run.audio_per_call / win["seconds"]
    metrics, extra = {}, {}
    if main:
        H.log(f"window: {win['calls']} calls, {win['calls'] * run.steps_per_call} steps, {win['seconds']:.3f} s, "
              f"{rate:.3f} audio-s/s over {world} ranks")
    if not args.trace:
        metrics[cell["moves"]] = {"value": rate, "unit": cell["units"][cell["moves"]]}
        metrics["setup_s"] = {"value": setup_s, "unit": cell["units"]["setup_s"]}
    else:
        from benchmark import trace as TR

        profiled = cell["traffic"]["profiled_calls"]
        if main:
            with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                    torch.profiler.ProfilerActivity.CUDA]) as prof:
                for _ in range(profiled):
                    with torch.profiler.record_function(TR.SPAN):
                        run.call()
            tr = TR.read(prof)
            del prof
            reading = R.Reading(cell, run, win, tr, profiled, run.device)
            for m in cell["per_layer"]:
                value = H.load_reader(m["name"])(reading)
                if value is not None:
                    metrics[m["name"]] = {"value": value, "unit": m["unit"]}
            extra["breakdown"] = {
                "device_ops": sorted(([g, s] for g, (s, _) in tr.groups.items()), key=lambda x: -x[1])[:10],
                "idle_gaps": [[label, s] for label, s in tr.idle[:10]]}
        else:
            for _ in range(profiled):
                run.call()
    peak = torch.cuda.max_memory_allocated(run.device) if cuda else 0
    device_info = {"platform": "gpu" if cuda else "cpu",
                   "kind": torch.cuda.get_device_name(run.device) if cuda else "cpu", "count": world,
                   "memory_peak_bytes": peak}
    if args.trace and main:
        device_info.update(busy_s=tr.busy_s, window_s=tr.span_s)
    banned = H.banned_modules()
    if banned:
        H.log(f"benchmark.run: these modules were loaded, which the port must not load: {banned}; no result")
        return 3
    run.free_program()
    readings = run.judge()
    if main:
        table = H.compared(readings, cell["limits"])
        correct = H.passes(table) and win["failed"] == 0
        H.log("read, not compared: " + ", ".join(f"{k}={v}" for k, v in readings.items() if k not in table))
        for name, e in table.items():
            H.log(f"compared {name}: {e['value']!r} (limit {e['limit']!r})")
        result = {"correct": correct, "attempted": run.kind.attempted(run, win["calls"]), "failed": win["failed"],
                  "metrics": metrics, "device": device_info, **extra, "compared": table}
        Path(args.out).write_text(json.dumps(R.finite(result)))
    barrier()
    dist.destroy_process_group()
    return 0


if __name__ == "__main__":
    ap = argparse.ArgumentParser(prog="benchmark.kinds.train_dp")
    for flag, kind in (("--cell", str), ("--seed", int), ("--seconds", float), ("--trace", int), ("--device", str),
                       ("--started-wall", float), ("--out", str)):
        ap.add_argument(flag, type=kind, required=True)
    sys.exit(worker(ap.parse_args()))
