"""``BENCHMARK.json`` is complete: every configuration, traffic mix, cell
limit and per-layer reader it names is a file of the benchmark, and every
cell reports setup_s, another end-to-end metric and a per-layer one."""

import json

from benchmark import harness as H


def test_every_name_has_its_file():
    spec = H.read_json(H.REPO / "BENCHMARK.json")
    for c in spec["configs"]:
        cfg = H.read_json(H.REPO / c["file"])
        assert cfg["name"] == c["name"] and cfg["reduced"] == c["reduced"]
    for w in spec["workloads"]:
        cell = H.load_cell(w["name"], spec)
        assert cell["limits"], f"{w['name']} has no limits"
        assert "setup_s" in cell["end_to_end"] and len(cell["end_to_end"]) >= 2 and cell["per_layer"]
        assert cell["moves"] in cell["end_to_end"]
    for m in spec["per_layer"]:
        assert callable(H.load_reader(m["name"]))
    assert len(json.dumps(spec)) < 64 * 1024


def test_every_kind_names_the_metric_it_moves():
    spec = H.read_json(H.REPO / "BENCHMARK.json")
    names = {m["name"] for m in spec["end_to_end"]}
    for w in spec["workloads"]:
        kind = H.load_module("kinds", H.load_cell(w["name"], spec)["traffic"]["kind"])
        assert kind.MOVES in names
        for hook in ("setup", "call", "failed", "attempted", "judge", "control", "flops_per_step"):
            assert callable(getattr(kind, hook)), (w["name"], hook)


def test_a_reader_with_nothing_to_read_returns_none():
    class Trace:
        groups, launches, busy_s, span_s = {}, 10, 1.0, 2.0

    class Reading:
        trace, profiled_steps = Trace(), 2

        def roofline(self, group):
            return None  # the group ran nothing

    assert H.load_reader("lstm_roofline.train")(Reading()) is None
    assert H.load_reader("launches_per_batch.label")(Reading()) == 5.0
    assert H.load_reader("idle_share.train")(Reading()) == 50.0
