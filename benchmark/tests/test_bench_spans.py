"""The readers of the port's phase spans (`benchmark.spans` and the twelve
metrics over it): each gives its number on a planted span table and trace,
and None where the port has no table, where the gate span counts other
steps than the profiled ones, and, for a device time, where the table has
no device column."""

import pytest

from benchmark import harness as H
from nn_conformer_for_speech_recognition_tpu_torch.utils import profiling as P

STEPS = 2
PLANTED = {  # two train steps and two label batches: (count, host s, device s)
    "train.order": (1, 0.01, 0.01), "train.gather": (STEPS, 0.002, 0.002), "train.augment": (STEPS, 0.1, 0.04),
    "train.forward": (STEPS, 0.3, 0.5), "train.backward": (STEPS, 0.2, 0.8),
    "train.grad_norm": (STEPS, 0.06, 0.1), "train.optimizer": (STEPS, 0.5, 0.6),
    "label.input": (STEPS + 1, 0.01, 0.02), "label.forward": (STEPS, 0.05, 1.4),
    "label.pull": (STEPS, 1.44, 0.002), "label.decode": (STEPS, 0.5, 0.5),
}
IDLE = [("train.optimizer", 0.3), ("label.decode", 0.45), ("host: no op recorded (Python)", 0.04),
        ("train.grad_norm", 0.05), ("aten::mul", 0.01)]
READS = {  # per step or batch, ms; shares of the 4 s span, %
    "augment_device_ms.train": 20.0, "forward_device_ms.train": 250.0, "backward_device_ms.train": 400.0,
    "update_device_ms.train": 350.0, "update_host_ms.train": 280.0, "update_idle_share.train": 8.75,
    "untraced_idle_share.train": 1.0, "forward_device_ms.label": 700.0, "pull_wait_ms.label": 720.0,
    "decode_host_ms.label": 250.0, "decode_idle_share.label": 11.25, "untraced_idle_share.label": 1.0,
}


class _Trace:
    span_s, busy_s, idle = 4.0, 3.0, IDLE


class _Reading:
    trace, profiled_steps = _Trace(), STEPS


def test_every_new_reader_is_in_the_benchmark():
    spec = H.read_json(H.REPO / "BENCHMARK.json")
    entries = {m["name"]: m for m in spec["per_layer"]}
    for name in READS:
        cell = "conformer_m.train" if name.endswith(".train") else "conformer_m.label"
        assert entries[name]["workloads"] == [cell], name


@pytest.mark.parametrize("name", sorted(READS))
def test_reader_on_a_planted_table(monkeypatch, name):
    monkeypatch.setattr(P, "phase_table", lambda: dict(PLANTED))
    assert H.load_reader(name)(_Reading()) == pytest.approx(READS[name], rel=1e-12)


@pytest.mark.parametrize("table", ["empty", "other steps", "no device"])
def test_readers_with_nothing_to_read_give_none(monkeypatch, table):
    planted = {"empty": {}, "other steps": {k: (v[0] + 1, *v[1:]) for k, v in PLANTED.items()},
               "no device": {k: (*v[:2], None) for k, v in PLANTED.items()}}[table]
    monkeypatch.setattr(P, "phase_table", lambda: planted)
    for name in READS:
        value = H.load_reader(name)(_Reading())
        if table == "no device" and "_device_" not in name:
            assert value == pytest.approx(READS[name], rel=1e-12), name  # host clocks and the trace's idle
        else:
            assert value is None, name


def test_a_port_without_spans_gives_none(monkeypatch):
    monkeypatch.setitem(__import__("sys").modules, P.__name__, None)  # the import fails as in a port before them
    assert all(H.load_reader(name)(_Reading()) is None for name in READS)
