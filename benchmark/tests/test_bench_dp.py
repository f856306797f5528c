"""The data-parallel cell at a tiny size on the CPU, four gloo processes: a
sound run is correct; the reference's four shards, their statistics and
gradients summed over the ranks, are the reference on the whole global
batch; one rank's failure ends the run, every other rank killed, where it
would wait on a collective for good."""

import json
import os
import subprocess
import sys
import threading
import time

import pytest
import torch

from benchmark import harness as H
from benchmark import traffic as T
from benchmark.reference import judge as J
from benchmark.reference import steps as S
from benchmark.reference.model import ConformerCTC

CELL = "conformer_m.train.dp4"
WORLD = 4


@pytest.fixture
def tiny_dp(tiny_cell):
    cell = tiny_cell(CELL)
    cell["traffic"].update(batch=8, clips=16)  # 2 global batches of 8, 2 rows a rank
    return cell


def _execute(cell, seed=2 ** 31 + 7):
    kind = H.load_module("kinds", "train_dp")
    return kind.execute(cell, seed, 0.3, False, torch.device("cpu"), time.perf_counter())


def test_sound_run_is_correct(tiny_dp):
    out = _execute(tiny_dp)
    assert out["correct"], out["compared"]
    assert out["device"]["count"] == WORLD and out["attempted"] > 0 and out["failed"] == 0
    assert set(out["metrics"]) == {"train_audio_per_s", "setup_s"}


SHARD = """
import json, sys, torch
from benchmark import traffic as T, harness as H
from benchmark.reference import steps as S
from benchmark.reference.model import ConformerCTC
torch.distributed.init_process_group("gloo", init_method="env://")
cell = json.loads(sys.argv[1])
cpu = torch.device("cpu")
corpus = T.make_corpus(cell["traffic"], cell["cfg"], 5, cpu)
w = H.make_weights(cell["cfg"], 5, cpu)
out = S.follow_steps(ConformerCTC, cell["cfg"], cell["traffic"], corpus, w, 5, cpu,
                     rank=torch.distributed.get_rank(), world=torch.distributed.get_world_size())
print(json.dumps(out))
"""


def test_four_shards_are_the_whole_batch(tiny_dp):
    """Without dropout (a rank draws its own masks), the reference on four
    ranks, each on its quarter of a global batch, reads what one process
    reads on the whole batch: float32 round-off apart."""
    cell = tiny_dp
    for part in ("encoder", "decoder"):
        cell["cfg"]["model"][part]["dropout"] = 0.0
    env = dict(os.environ, WORLD_SIZE=str(WORLD), MASTER_ADDR="localhost", MASTER_PORT=str(29400 + os.getpid() % 500),
               OMP_NUM_THREADS="1")
    procs = [subprocess.Popen([sys.executable, "-c", SHARD, json.dumps(cell)], cwd=H.REPO, stdout=subprocess.PIPE,
                              text=True, env=dict(env, RANK=str(r), LOCAL_RANK=str(r))) for r in range(WORLD)]
    outs = [json.loads(p.communicate(timeout=300)[0].strip().splitlines()[-1]) for p in procs]
    assert all(p.returncode == 0 for p in procs)
    cpu = torch.device("cpu")
    corpus = T.make_corpus(cell["traffic"], cell["cfg"], 5, cpu)
    whole = S.follow_steps(ConformerCTC, cell["cfg"], cell["traffic"], corpus, H.make_weights(cell["cfg"], 5, cpu), 5,
                           cpu)
    assert all(o == outs[0] for o in outs)  # every rank holds the same state
    readings = J.train_readings(outs[0], whole)
    assert readings["loss"] < 1e-5 and readings["grad"] < 1e-4 and readings["change_median"] < 1e-4, readings


def test_a_failed_rank_ends_the_run(tiny_dp, monkeypatch):
    kind = H.load_module("kinds", "train_dp")
    started, real = [], kind.subprocess.Popen

    def popen(*args, **kwargs):
        p = real(*args, **kwargs)
        started.append(p)
        return p

    monkeypatch.setattr(kind.subprocess, "Popen", popen)

    def kill_rank_two():  # once every rank is up, rank 2 dies; the others then wait on it in a collective
        while len(started) < WORLD:
            time.sleep(0.05)
        time.sleep(3.0)
        started[2].kill()

    threading.Thread(target=kill_rank_two, daemon=True).start()
    t0 = time.monotonic()
    with pytest.raises(SystemExit, match="rank 2 exited"):
        kind.execute(tiny_dp, 3, 600.0, False, torch.device("cpu"), time.perf_counter())
    assert time.monotonic() - t0 < 60.0
    assert all(p.poll() is not None for p in started)
