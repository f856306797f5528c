"""The spans inside the phase spans (`utils.profiling.annotate`): each
block's ``encoder.attention`` (both block kinds, both training routes) and
each E-Branchformer block's ``encoder.cgmlp`` and ``encoder.merge``, inside
``train.forward`` and ``label.forward``, and the data-parallel step's
``train.all_reduce``, inside ``train.backward``, under a process group only
(here one gloo process).  Without a profiler each costs one check of the
profiler's state and records nothing.  The phase spans around them keep
their order.  This file imports no jax.
"""

import socket

import pytest
import torch
import torch.distributed as dist

from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.data.audio import make_synthetic_corpus
from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, load_manifest
from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu_torch.train import loop as L
from nn_conformer_for_speech_recognition_tpu_torch.utils import profiling as P

BATCH, BLOCKS = 4, 2
INNER = ("encoder.attention", "encoder.cgmlp", "encoder.merge", "train.all_reduce")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    manifests = make_synthetic_corpus(str(tmp_path_factory.mktemp("branch")), ["yes", "no", "go", "stop"], n_train=8,
                                      n_val=0, n_test=0, n_unlabeled=4, max_words_per_utt=2, seed=0)
    vocab = build_vocab("word", [u.transcript for u in load_manifest(manifests["train"])])
    kw = dict(batch_size=BATCH, bucket_boundaries=[14000], max_target_len=4)
    return vocab, {k: BucketedDataset(load_manifest(v), vocab, **kw) for k, v in manifests.items() if v}


def _trainer(vocab, block="e_branchformer", attention_dropout=0.0):
    enc = TC.ConformerConfig(num_blocks=BLOCKS, d_model=32, num_heads=2, ffn_dim=64, conv_kernel_size=5, dropout=0.1,
                             attention_dropout=attention_dropout, block=block, cgmlp_dim=64, merge_conv_kernel=5)
    model = TC.ModelConfig(encoder=enc, decoder=TC.DecoderConfig(projection_dim=16, lstm_hidden=16, dropout=0.1),
                           n_mels=13, use_pallas=True, compute_dtype="float32")
    train = TC.TrainConfig(batch_size=BATCH, optimizer=TC.OptimizerConfig(learning_rate=1e-3), log_every=0)
    trainer = L.Trainer(ConformerCTC(model, len(vocab)), vocab, TC.FeatureConfig(n_fft=256, hop_length=256, n_mels=13),
                        train, device="cpu", log_fn=lambda _: None)
    trainer.init_state(seed=0)
    return trainer


def _profiled(fn):
    """(the program's ranges in the profiler's events as (start, end,
    name), the phase table) of ``fn()`` under a CPU profiler."""
    P.reset_phases()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        fn()
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events()
                    if e.name().startswith(("train.", "label.", "encoder.")))
    return ranges, P.phase_table()


def _inside(ranges, inner: str, outer: str) -> int:
    """The ``inner`` ranges, each asserted inside an ``outer`` one."""
    outers = [(s, e) for s, e, n in ranges if n == outer]
    found = [(s, e) for s, e, n in ranges if n == inner]
    for s, e in found:
        assert any(os <= s and e <= oe for os, oe in outers), (inner, outer)
    return len(found)


def _phases_contiguous(ranges):
    phases = [r for r in ranges if r[2] not in INNER]
    for (_, e0, a), (s1, _, b) in zip(phases, phases[1:]):
        assert e0 <= s1, (a, b)


@pytest.fixture
def one_process_group():
    with socket.socket() as s:
        s.bind(("localhost", 0))
        port = s.getsockname()[1]
    dist.init_process_group("gloo", init_method=f"tcp://localhost:{port}", rank=0, world_size=1)
    try:
        yield
    finally:
        dist.destroy_process_group()


def test_branch_spans_in_training_and_labelling(corpus):
    vocab, data = corpus
    trainer = _trainer(vocab)
    ranges, table = _profiled(lambda: trainer.train(DeviceResidentDataset(data["train"], device="cpu"), epochs=1))
    steps = table["train.optimizer"][0]
    assert steps == 2
    for name in ("encoder.cgmlp", "encoder.merge"):
        assert _inside(ranges, name, "train.forward") == table[name][0] == BLOCKS * steps
    assert "train.all_reduce" not in table  # no process group
    _phases_contiguous(ranges)
    ranges, table = _profiled(lambda: trainer.generate_labels(DeviceResidentDataset(data["unlabeled"], device="cpu")))
    for name in ("encoder.cgmlp", "encoder.merge"):
        assert _inside(ranges, name, "label.forward") == table[name][0] == BLOCKS
    _phases_contiguous(ranges)


@pytest.mark.parametrize("attention_dropout", [0.0, 0.1])
@pytest.mark.parametrize("block", ["conformer", "e_branchformer"])
def test_attention_span_in_training_and_labelling(corpus, monkeypatch, block, attention_dropout):
    """``encoder.attention`` opens once a block inside ``train.forward`` (on
    the kernel route without probability dropout, on the einsum route with
    it) and inside ``label.forward`` (the kernel route), for both block
    kinds."""
    from nn_conformer_for_speech_recognition_tpu_torch.models import conformer as TCM

    vocab, data = corpus
    trainer = _trainer(vocab, block=block, attention_dropout=attention_dropout)
    routes = []
    for name in ("flash_relpos_attention", "flash_relpos_attention_plain"):
        real = getattr(TCM, name)
        monkeypatch.setattr(TCM, name, lambda *a, real=real, name=name, **kw: routes.append(name) or real(*a, **kw))
    ranges, table = _profiled(lambda: trainer.train(DeviceResidentDataset(data["train"], device="cpu"), epochs=1))
    steps = table["train.optimizer"][0]
    assert _inside(ranges, "encoder.attention", "train.forward") == table["encoder.attention"][0] == BLOCKS * steps
    want = "flash_relpos_attention_plain" if attention_dropout > 0 else "flash_relpos_attention"
    assert routes == [want] * (BLOCKS * steps)
    _phases_contiguous(ranges)
    routes.clear()
    ranges, table = _profiled(lambda: trainer.generate_labels(DeviceResidentDataset(data["unlabeled"], device="cpu")))
    assert _inside(ranges, "encoder.attention", "label.forward") == table["encoder.attention"][0] == BLOCKS
    assert routes == ["flash_relpos_attention"] * BLOCKS
    _phases_contiguous(ranges)


def test_all_reduce_span_under_a_process_group(corpus, one_process_group):
    vocab, data = corpus
    trainer = _trainer(vocab, block="conformer")
    assert trainer.shard is not None
    ranges, table = _profiled(lambda: trainer.train(DeviceResidentDataset(data["train"], device="cpu"), epochs=1))
    assert _inside(ranges, "train.all_reduce", "train.backward") == table["train.all_reduce"][0] == 2
    assert {name for name in table if name.startswith("encoder.")} == {"encoder.attention"}  # Conformer blocks
    _phases_contiguous(ranges)


def test_off_each_span_costs_one_state_check(corpus, monkeypatch, one_process_group):
    """Without a profiler: one ``_profiler_enabled`` check a span, the shared
    no-op context, nothing recorded, the same log-probs."""
    vocab, _ = corpus
    trainer = _trainer(vocab)
    model = trainer.model.eval()
    feats, lengths = torch.rand((2, 40, 13)), torch.tensor([40, 30])
    with torch.no_grad():
        want = model(feats, lengths)[0]
    checks = []
    real = torch.autograd._profiler_enabled
    monkeypatch.setattr(torch.autograd, "_profiler_enabled", lambda: checks.append(1) or real())
    monkeypatch.setattr(P, "_Span", None)  # a span object would raise
    P.reset_phases()
    with torch.no_grad():
        got = model(feats, lengths)[0]
    assert len(checks) == 3 * BLOCKS and torch.equal(got, want)  # attention, cgMLP, merge
    model.train()
    loss = model(feats, lengths)[0].sum()
    loss.backward()
    checks.clear()
    L.all_reduce_gradients(model, loss.detach())
    assert len(checks) == 1 and P.phase_table() == {}
