"""Whole runs on the CPU at a tiny size, the look for a card skipped: a sound
run is correct, and each fault the timed path can have makes it not
correct: a step that returns its state unchanged, half of the batch left
out with the mean over the rest, a word altered where it is produced.
The control, the reference one precision down put in the program's place,
fails the cell's limits too.  And the command itself refuses to run
without a card, and the run loads neither JAX nor the JAX package."""

import json
import subprocess
import sys
import time

import pytest
import torch

from benchmark import harness as H
from benchmark import run as R

REPO = H.REPO


def _run(cell, seed=2 ** 31 + 5):
    return R.execute(cell, seed, 0.3, False, torch.device("cpu"), time.perf_counter())


@pytest.mark.parametrize("name", ["conformer_m.train", "conformer_m.label"])
def test_sound_run_is_correct(tiny_cell, name):
    out = _run(tiny_cell(name))
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0
    assert list(out)[-1] == "compared"


def test_state_left_unchanged_is_caught(tiny_cell, monkeypatch):
    from nn_conformer_for_speech_recognition_tpu_torch.train import optim

    def unchanged(self):
        self.count += 1

    monkeypatch.setattr(optim.Adafactor, "step", unchanged)
    out = _run(tiny_cell("conformer_m.train"))
    assert not out["correct"] and out["compared"]["change"]["value"] > out["compared"]["change"]["limit"]


def test_half_the_batch_left_out_is_caught(tiny_cell, monkeypatch):
    from nn_conformer_for_speech_recognition_tpu_torch.train import loop

    real = loop._batch_loss

    def half(ctc, log_probs, targets, out_lengths, target_lengths, blank_id, *a, **k):
        n = log_probs.shape[0] // 2
        return real(ctc, log_probs[:n], targets[:n], out_lengths[:n], target_lengths[:n], blank_id, *a, **k)

    monkeypatch.setattr(loop, "_batch_loss", half)
    out = _run(tiny_cell("conformer_m.train"))
    assert not out["correct"]


def test_a_word_altered_is_caught(tiny_cell, monkeypatch):
    from nn_conformer_for_speech_recognition_tpu_torch.train import loop

    real = loop.greedy_decode

    def altered(log_probs, frame_lengths=None, pad_id=1):
        ids = real(log_probs, frame_lengths, pad_id).clone()
        ids[0, 0] = 3 + (int(ids[0, 0]) - 3 + 1) % (log_probs.shape[-1] - 3)
        return ids

    monkeypatch.setattr(loop, "greedy_decode", altered)
    cell = tiny_cell("conformer_m.label")
    out = _run(cell)
    assert not out["correct"] and out["compared"]["label_gap"]["value"] > out["compared"]["label_gap"]["limit"]


@pytest.mark.parametrize("name", ["conformer_m.train", "conformer_m.label"])
def test_the_control_and_the_faults_fail_the_limits(tiny_cell, name):
    """Each reading of ``benchmark.control``, the reference one precision
    down in the program's place and the planted faults, is not correct by
    the cell's limits, judged as a run judges."""
    cell = tiny_cell(name)
    # four blocks of 64: two of 32 round too little for fp8 to show over 8 short clips
    cell["cfg"]["model"]["encoder"].update(num_blocks=4, d_model=64, ffn_dim=128)
    cell["cfg"]["model"]["decoder"].update(projection_dim=64)
    kind = H.load_module("kinds", cell["traffic"]["kind"])
    sides = dict(kind.control(cell, 11, torch.device("cpu")))
    assert "control" in sides and len(sides) >= 2
    for side, readings in sides.items():
        assert not H.passes(H.compared(readings, cell["limits"])), (side, readings)


def _command(*args):
    return subprocess.run([sys.executable, *args], cwd=REPO, capture_output=True, text=True, timeout=600)


def test_without_a_card_the_command_fails_with_no_result():
    if torch.cuda.is_available():
        pytest.skip("a card is present: the command would run")
    p = _command("-m", "benchmark.run", "--workload", "conformer_m.train", "--seed", "1", "--seconds", "1",
                 "--trace", "0")
    assert p.returncode != 0 and p.stdout.strip() == ""
    assert "CUDA" in p.stderr


def test_a_run_loads_neither_jax_nor_the_jax_package():
    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import tiny\n"
        "from benchmark import harness as H, run as R\n"
        "for name in ('conformer_m.train', 'conformer_m.label'):\n"
        "    R.execute(tiny(H.load_cell(name)), 3, 0.2, False, torch.device('cpu'), time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = _command("-c", code)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "nn_conformer_for_speech_recognition_tpu_torch" in tops  # the port ran
    assert not tops & set(H.BANNED)


@pytest.mark.cuda
def test_cell_runs_on_the_card_and_is_correct():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA card")
    p = _command("-m", "benchmark.run", "--workload", "conformer_m.train", "--seed", "7", "--seconds", "3",
                 "--trace", "0")
    assert p.returncode == 0, p.stderr[-4000:]
    out = json.loads(p.stdout.strip().splitlines()[-1])
    assert out["correct"], out["compared"]
    assert out["device"]["platform"] == "gpu" and out["metrics"]["train_audio_per_s"]["value"] > 0
