"""The E-Branchformer cell at a tiny size on the CPU: a sound run is correct,
the planted faults (the cgMLP's gate dropped, half of each batch left out
of the loss) and the control are not; the reference's shared step-follower
is `judge.reference_train` for the Conformer; the configuration file is
the port's preset and the kind's frozen FLOP count the port's."""

import time

import pytest
import torch

from benchmark import harness as H
from benchmark import run as R
from benchmark import traffic as T
from benchmark.reference import judge as J
from benchmark.reference import steps as S
from benchmark.reference.model import ConformerCTC

CELL = "ebranchformer_l.train"


@pytest.fixture
def tiny_ebf(tiny_cell):
    def make(**encoder):
        cell = tiny_cell(CELL)
        cell["cfg"]["model"]["encoder"].update(cgmlp_dim=64, conv_kernel_size=5, merge_conv_kernel=5, **encoder)
        return cell

    return make


def _run(cell, seed=2 ** 31 + 9):
    return R.execute(cell, seed, 0.3, False, torch.device("cpu"), time.perf_counter())


def test_sound_run_is_correct(tiny_ebf):
    out = _run(tiny_ebf())
    assert out["correct"], out["compared"]
    assert out["attempted"] > 0 and out["failed"] == 0 and out["metrics"]["train_audio_per_s"]["value"] > 0


def test_the_gate_dropped_is_caught(tiny_ebf, monkeypatch):
    import torch.nn.functional as F

    from nn_conformer_for_speech_recognition_tpu_torch.models import conformer

    def ungated(self, x, mask):  # the gate computed and not applied: its parameters still get (zero) gradients
        r, g = F.gelu(self.channel_proj1(self.norm(x))).chunk(2, dim=-1)
        g = conformer._depthwise(self, self.gate_norm(g) * mask[..., None].to(g.dtype))
        h = F.dropout(r * (0.0 * g + 1.0), self.dropout, self.training)
        return F.dropout(self.channel_proj2(h), self.dropout, self.training)

    monkeypatch.setattr(conformer.ConvolutionalGatingMLP, "forward", ungated)
    out = _run(tiny_ebf())
    assert not out["correct"], out["compared"]


def test_half_the_batch_left_out_is_caught(tiny_ebf, monkeypatch):
    from nn_conformer_for_speech_recognition_tpu_torch.train import loop

    real = loop._batch_loss

    def half(ctc, log_probs, targets, out_lengths, target_lengths, blank_id, *a, **k):
        n = log_probs.shape[0] // 2
        return real(ctc, log_probs[:n], targets[:n], out_lengths[:n], target_lengths[:n], blank_id, *a, **k)

    monkeypatch.setattr(loop, "_batch_loss", half)
    assert not _run(tiny_ebf())["correct"]


def test_the_control_and_the_fault_fail_the_limits(tiny_ebf):
    cell = tiny_ebf(num_blocks=4, d_model=64, ffn_dim=128)
    cell["cfg"]["model"]["decoder"].update(projection_dim=64)
    kind = H.load_module("kinds", cell["traffic"]["kind"])
    sides = dict(kind.control(cell, 11, torch.device("cpu")))
    assert set(sides) == {"control", "fault: half the batch"}
    for side, readings in sides.items():
        assert not H.passes(H.compared(readings, cell["limits"])), (side, readings)


def test_follow_steps_is_the_judges_reference_train(tiny_cell):
    """For the Conformer reference on one process, the shared step-follower
    gives `judge.reference_train`'s readings bit for bit, and its weights
    are `harness.make_weights`'."""
    cell = tiny_cell("conformer_m.train")
    cfg, traffic, cpu = cell["cfg"], cell["traffic"], torch.device("cpu")
    corpus = T.make_corpus(traffic, cfg, 4, cpu)
    w = H.make_weights(cfg, 4, cpu)
    assert all(torch.equal(a, b) for a, b in zip(w.values(), S.draw_weights(ConformerCTC, cfg, 4, cpu).values()))
    assert S.follow_steps(ConformerCTC, cfg, traffic, corpus, w, 4, cpu) == J.reference_train(cfg, traffic, corpus,
                                                                                               w, 4, cpu)


def test_config_file_is_the_ports_preset_and_flops_its_count():
    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.utils import flops

    cfg = H.read_json(H.ROOT / "configs" / "ebranchformer_l.json")
    model, _, _ = H.port_configs(cfg, {"batch": 8, "specaugment": True}, 0)
    assert model == C.e_branchformer_l(use_pallas=True, n_mels=80)
    assert cfg["vocab_size"] == 5000 and cfg["reduced"] == []
    kind = H.load_module("kinds", "train_ebf")
    for batch, frames in ((32, 3001), (3, 17)):
        assert kind.flops_per_step(cfg["model"], 5000, batch, frames) == flops.train_step_flops(model, 5000, batch,
                                                                                                  frames)


def test_a_run_loads_neither_jax_nor_the_jax_package():
    import json
    import subprocess
    import sys

    code = (
        "import sys, time, torch\n"
        "sys.path.insert(0, 'benchmark/tests')\n"
        "from conftest import tiny\n"
        "from benchmark import harness as H, run as R\n"
        f"cell = tiny(H.load_cell({CELL!r}))\n"
        "cell['cfg']['model']['encoder'].update(cgmlp_dim=64, conv_kernel_size=5, merge_conv_kernel=5)\n"
        "R.execute(cell, 3, 0.2, False, torch.device('cpu'), time.perf_counter())\n"
        "print(sorted({m.split('.')[0] for m in sys.modules}))\n")
    p = subprocess.run([sys.executable, "-c", code], cwd=H.REPO, capture_output=True, text=True, timeout=600)
    assert p.returncode == 0, p.stderr[-3000:]
    tops = set(json.loads(p.stdout.strip().splitlines()[-1].replace("'", '"')))
    assert "nn_conformer_for_speech_recognition_tpu_torch" in tops and not tops & set(H.BANNED)
