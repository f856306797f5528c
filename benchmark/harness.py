"""One run of one cell: set-up, the measured window, the traced calls and the
comparison that decides ``correct``.

Everything a cell is made of is found by name: ``BENCHMARK.json``'s entry
names the configuration (``configs/<config>.json``, also read by the
reference) and the traffic mix (``traffic/<traffic>.json``, read by the
one generator in `benchmark.traffic`); the mix's ``kind`` names the module
``kinds/<kind>.py`` that sets the program up, makes the call the window
repeats, names the end-to-end metric it moves and judges the run;
``limits/<cell>.json`` holds the limits of the cell's compared numbers;
each per-layer metric is read by ``metrics/<metric>.py``.

The program is driven only through its own entry points.  `resident_trainer`
is the set-up the kinds share: a WAV corpus and a manifest written to a
fresh directory under ``TMPDIR``, read by the port's ``BucketedDataset`` and
made resident by its ``DeviceResidentDataset``, and a ``Trainer`` over the
configuration.  The weights are the benchmark's, drawn on the device from
the seed and loaded into the program's model after ``Trainer.init_state``;
the reference gets the same.
"""

from __future__ import annotations

import importlib.util
import json
import math
import os
import shutil
import sys
import tempfile
import time
import wave
from pathlib import Path
from typing import Callable, Dict, List, Optional

import torch

from benchmark import traffic as T
from benchmark.reference.model import ConformerCTC as ReferenceModel

ROOT = Path(__file__).resolve().parent
REPO = ROOT.parent
BANNED = ("jax", "jaxlib", "flax", "nn_conformer_for_speech_recognition_tpu")


def log(msg: str) -> None:
    print(msg, file=sys.stderr, flush=True)


def read_json(path: Path) -> dict:
    with open(path, encoding="utf-8") as f:
        return json.load(f)


def load_cell(name: str, spec: Optional[dict] = None) -> dict:
    """The cell ``name`` of ``BENCHMARK.json``: its entry, configuration,
    traffic mix, limits and the names of its metrics."""
    spec = spec or read_json(REPO / "BENCHMARK.json")
    entry = next((w for w in spec["workloads"] if w["name"] == name), None)
    if entry is None:
        raise SystemExit(f"no workload {name!r} in BENCHMARK.json")
    config = next(c for c in spec["configs"] if c["name"] == entry["config"])
    cfg = read_json(REPO / config["file"])
    traffic = read_json(ROOT / "traffic" / f"{entry['traffic']}.json")
    limits_path = ROOT / "limits" / f"{name}.json"
    limits = read_json(limits_path) if limits_path.exists() else {}
    moved = load_module("kinds", traffic["kind"]).MOVES

    def applies(metric):
        return name in metric["workloads"] if "workloads" in metric else True

    end_to_end = [m["name"] for m in spec["end_to_end"] if applies(m)]
    per_layer = [m for m in spec["per_layer"] if applies(m) and m["moves"] in end_to_end]
    return dict(name=name, entry=entry, cfg=cfg, traffic=traffic, limits=limits, moves=moved,
                end_to_end=end_to_end, per_layer=per_layer, units={m["name"]: m["unit"] for m in
                                                                  spec["end_to_end"] + spec["per_layer"]})


def port_configs(cfg: dict, traffic: dict, seed: int):
    """The port's configuration objects for a configuration file."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as C

    m = cfg["model"]
    tup = lambda d: {k: tuple(v) if isinstance(v, list) else v for k, v in d.items()}  # noqa: E731
    model = C.ModelConfig(
        subsampling=C.SubsamplingConfig(**tup(m["subsampling"])), encoder=C.ConformerConfig(**m["encoder"]),
        decoder=C.DecoderConfig(**m["decoder"]),
        **{k: v for k, v in m.items() if k not in ("subsampling", "encoder", "decoder")})
    feat = C.FeatureConfig(**cfg["features"])
    train = C.TrainConfig(batch_size=traffic["batch"], optimizer=C.OptimizerConfig(**cfg["optimizer"]),
                          specaugment=C.SpecAugmentConfig(**cfg["specaugment"]),
                          use_specaugment=traffic["specaugment"], seed=seed, log_every=0)
    return model, feat, train


def make_weights(cfg: dict, seed: int, device) -> Dict[str, torch.Tensor]:
    """The model's weights from ``seed``, drawn on ``device`` in one call:
    matrices LeCun-normal (std fan_in^-1/2; an LSTM matrix (in, 4H) and a
    depthwise conv's taps fan in over their first axis and their taps),
    norm scales 1, biases, u, v and running means 0, running variances 1."""
    with torch.device("meta"):
        shapes = {n: (tuple(t.shape), t.dtype) for n, t in ReferenceModel(cfg["model"], cfg["vocab_size"])
                  .state_dict().items()}
    normal = [n for n, (s, _) in shapes.items() if len(s) > 1 and not n.endswith(("u_bias", "v_bias"))]
    gen = torch.Generator(device=device).manual_seed(seed)
    draw = torch.randn(sum(math.prod(shapes[n][0]) for n in normal), generator=gen, device=device)
    out, at = {}, 0
    for n, (s, dtype) in shapes.items():
        if n in normal:
            size = math.prod(s)
            fan_in = s[0] if n.endswith(("_w_ih", "_w_hh")) else math.prod(s[1:])
            out[n] = (draw[at:at + size].view(s) * fan_in ** -0.5).contiguous()
            at += size
        elif n.endswith(("running_var",)) or (len(s) == 1 and n.endswith("weight")):
            out[n] = torch.ones(s, dtype=dtype, device=device)
        else:
            out[n] = torch.zeros(s, dtype=dtype, device=device)
    return out


def write_corpus(corpus: T.Corpus, sample_rate: int, folder: str) -> str:
    """The corpus as 16-bit mono WAV files and a manifest (``path\\ttranscript``
    a line); returns the manifest's path."""
    lines = []
    for i, n in enumerate(corpus.lengths):
        path = os.path.join(folder, f"{i:05d}.wav")
        with wave.open(path, "wb") as w:
            w.setnchannels(1)
            w.setsampwidth(2)
            w.setframerate(sample_rate)
            w.writeframes(corpus.pcm[i, :n].tobytes())
        lines.append(f"{path}\t{corpus.transcript(i)}")
    manifest = os.path.join(folder, "manifest.tsv")
    with open(manifest, "w", encoding="utf-8") as f:
        f.write("\n".join(lines))
    return manifest


def resident_trainer(run) -> None:
    """``run.corpus`` drawn from the seed, written as WAV files and a
    manifest, read by the port's ``BucketedDataset`` and made resident
    (``run.dataset``); ``run.trainer`` over the configuration with the
    benchmark's weights loaded."""
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, load_manifest
    from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import WordVocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    cfg, traffic = run.cfg, run.traffic
    marks = [("start", time.perf_counter())]
    run.corpus = T.make_corpus(traffic, cfg, run.seed, run.device)
    marks.append(("corpus drawn", time.perf_counter()))
    sr = cfg["features"]["sample_rate"]
    folder = tempfile.mkdtemp(prefix="bench-corpus-")
    try:
        utts = load_manifest(write_corpus(run.corpus, sr, folder))
        marks.append(("WAV written", time.perf_counter()))
        vocab = WordVocab(run.corpus.words)
        pad_to = run.corpus.pcm.shape[1]
        source = BucketedDataset(utts, vocab, traffic["batch"], sample_rate=sr, bucket_boundaries=(pad_to,),
                                 max_target_len=run.corpus.max_target_len)
        run.dataset = DeviceResidentDataset(source, pad_to=pad_to, device=run.device)
        marks.append(("resident", time.perf_counter()))
    finally:
        shutil.rmtree(folder, ignore_errors=True)
    model_cfg, feat_cfg, train_cfg = port_configs(cfg, traffic, run.seed)
    run.trainer = Trainer(ConformerCTC(model_cfg, len(vocab)), vocab, feat_cfg, train_cfg, log_fn=log,
                          device=run.device)
    run.trainer.init_state(seed=run.seed)
    run.trainer.model.load_state_dict(make_weights(cfg, run.seed, run.device), strict=True)
    marks.append(("trainer and weights", time.perf_counter()))
    log("set-up seconds: " + ", ".join(f"{name} {t - marks[i][1]:.3f}" for i, (name, t) in enumerate(marks[1:])))
    run.audio_per_call = float(run.corpus.lengths.sum()) / sr  # an epoch or a pass holds every clip once
    run.steps_per_call = run.dataset.num_batches()


class Run:
    """The program under one cell and seed; ``device`` is a CUDA device
    (the CPU only where a test drives a run without the card).  What is
    particular to the cell's kind of work, its ``kinds/<kind>.py`` does."""

    def __init__(self, cell: dict, seed: int, device):
        self.seed, self.device = seed, torch.device(device)
        self.cfg, self.traffic = cell["cfg"], cell["traffic"]
        self.kind = load_module("kinds", self.traffic["kind"])
        self.calls = 0  # calls made so far
        self.observed: dict = {}

    def setup(self) -> None:
        if self.device.type == "cuda":
            from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

            build.library()  # builds into the package's _build/ on a checkout's first run, else loads
        self.kind.setup(self)
        if self.device.type == "cuda":
            torch.cuda.synchronize(self.device)

    def call(self):
        """One call of the program, ending in its own pull to the host."""
        self.calls += 1
        return self.kind.call(self)

    def window(self, seconds: float) -> dict:
        """Calls until ``seconds`` have passed; the last one started runs to
        its end.  Returns the calls, the time from the window's start to the
        end of the last call, and what failed, as the kind counts it."""
        failed, calls, times = 0, 0, []
        t0 = last = time.perf_counter()
        deadline = t0 + seconds
        while True:
            out = self.call()
            calls += 1
            now = time.perf_counter()
            times.append(now - last)
            last = now
            failed += self.kind.failed(self, out)
            end = time.perf_counter()
            if end >= deadline:
                log("call seconds: " + " ".join(f"{x:.4f}" for x in times))
                return {"calls": calls, "seconds": end - t0, "failed": failed}

    def free_program(self) -> None:
        del self.trainer, self.dataset
        if self.device.type == "cuda":
            torch.cuda.empty_cache()

    def judge(self) -> Dict[str, float]:
        """The compared numbers: the reference worked out after the window,
        on the same weights and inputs."""
        return self.kind.judge(self)


def compared(readings: Dict[str, float], limits: Dict[str, float]) -> Dict[str, dict]:
    """Each number the cell's limits name, beside its limit (a number passes
    at or under it; one the run could not read, infinite).  Readings the
    limits do not name are read and logged, not compared."""
    return {k: {"value": readings.get(k, math.inf), "limit": v} for k, v in limits.items()}


def passes(table: Dict[str, dict]) -> bool:
    return bool(table) and all(math.isfinite(e["value"]) and e["value"] <= e["limit"] for e in table.values())


def banned_modules() -> List[str]:
    return sorted({m.split(".")[0] for m in list(sys.modules)} & set(BANNED))


def load_module(folder: str, name: str):
    """``<folder>/<name>.py`` of the benchmark, found by name."""
    path = ROOT / folder / f"{name}.py"
    if not path.exists():
        raise SystemExit(f"no {folder}/{name}.py in the benchmark")
    key = f"benchmark_{folder}_{name.replace('.', '_').replace('-', '_')}"
    if key not in sys.modules:
        spec = importlib.util.spec_from_file_location(key, path)
        module = importlib.util.module_from_spec(spec)
        sys.modules[key] = module
        spec.loader.exec_module(module)
    return sys.modules[key]


def load_reader(metric: str) -> Callable:
    return load_module("metrics", metric).read
