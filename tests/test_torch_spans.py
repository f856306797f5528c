"""The port's phase spans (`utils.profiling.annotate`) in `Trainer.train`,
over resident data and over a stream, and in `Trainer.generate_labels`.

Under a CPU ``torch.profiler`` the profiler's own events hold each span
once a step or a batch, in the path's order, and none inside another;
`phase_table` counts them.  Without a profiler `annotate` is the shared
no-op and nothing is recorded, and the losses, the state and the labels are
bit-equal with and without one.  A ``StopIteration`` raised inside a step
or a batch leaves the call, with or without a profiler: only the data's
end ends an epoch or a pass.  Two tests, marked ``cuda``, hold a step's
spans to the step's own device span and the profiler's kernel count to
that of the same calls without spans on the card; they skip here.  This
file imports no jax: on the card run it with
python -m pytest --noconftest -m cuda tests/test_torch_spans.py
"""

from collections import Counter

import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.data.audio import make_synthetic_corpus
from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, load_manifest
from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu_torch.train import loop as L
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer
from nn_conformer_for_speech_recognition_tpu_torch.utils import profiling as P

BATCH = 4
STEP_SPANS = ("train.augment", "train.forward", "train.backward", "train.grad_norm", "train.optimizer")
LABEL_SPANS = ("label.input", "label.forward", "label.pull", "label.decode")


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    """8 labelled clips (2 batches), 8 unlabelled, a word vocabulary."""
    manifests = make_synthetic_corpus(str(tmp_path_factory.mktemp("spans")), ["yes", "no", "go", "stop"], n_train=8,
                                      n_val=0, n_test=0, n_unlabeled=8, max_words_per_utt=2, seed=0)
    vocab = build_vocab("word", [u.transcript for u in load_manifest(manifests["train"])])
    kw = dict(batch_size=BATCH, bucket_boundaries=[14000], max_target_len=4)
    return vocab, {k: BucketedDataset(load_manifest(v), vocab, **kw) for k, v in manifests.items() if v}


def _trainer(vocab, train_wer=False):
    """A tiny Conformer with dropout and SpecAugment on: the draws must not
    move under the profiler."""
    enc = TC.ConformerConfig(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64, conv_kernel_size=7, dropout=0.1)
    dec = TC.DecoderConfig(projection_dim=16, lstm_hidden=16, dropout=0.1)
    model = TC.ModelConfig(encoder=enc, decoder=dec, n_mels=13, use_pallas=True, conv_impl="pallas",
                           compute_dtype="float32")
    train = TC.TrainConfig(batch_size=BATCH, optimizer=TC.OptimizerConfig(learning_rate=1e-3), use_specaugment=True,
                           log_every=0, train_wer=train_wer)
    trainer = Trainer(ConformerCTC(model, len(vocab)), vocab, TC.FeatureConfig(n_fft=256, hop_length=256, n_mels=13),
                      train, device="cpu", log_fn=lambda _: None)
    trainer.init_state(seed=0)
    return trainer


def _run(corpus, route, trainer=None):
    """One call of ``route``: 'resident' (`train` over a resident dataset),
    'resident+wer' (the same with the train step's ids scored), 'stream'
    (`train` over the bucketed dataset) or 'labels'."""
    vocab, data = corpus
    trainer = trainer or _trainer(vocab, train_wer=route == "resident+wer")
    if route.startswith("resident"):
        return trainer, trainer.train(DeviceResidentDataset(data["train"], device="cpu"), epochs=1)
    if route == "stream":
        return trainer, trainer.train(data["train"], epochs=1)
    return trainer, trainer.generate_labels(DeviceResidentDataset(data["unlabeled"], device="cpu"))


def _profiled(fn):
    """``fn()`` under a CPU profiler, the table emptied first: (its result,
    the program's ranges in the profiler's events as (start, end, name) in
    order, the table)."""
    P.reset_phases()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
        out = fn()
    ranges = sorted((e.start_ns(), e.start_ns() + e.duration_ns(), e.name())
                    for e in prof.profiler.kineto_results.events() if e.name().startswith(("train.", "label.")))
    return out, ranges, P.phase_table()


ORDER = {  # the spans in the profiler's events over 2 steps or batches; the wait that finds the data's end counts
    "resident": ["train.order"] + ["train.gather", *STEP_SPANS] * 2 + ["train.pull", "train.epilogue"],
    "resident+wer": ["train.order"] + ["train.gather", *STEP_SPANS, "train.greedy"] * 2 + ["train.pull",
                                                                                           "train.epilogue"],
    "stream": ["train.data_wait", "train.put", *STEP_SPANS] * 2 + ["train.data_wait", "train.pull",
                                                                  "train.epilogue"],
    "labels": [*LABEL_SPANS] * 2 + ["label.input"],
}
ROUTES = sorted(ORDER)


@pytest.mark.parametrize("route", ROUTES)
def test_spans_under_a_profiler(corpus, route):
    _, ranges, table = _profiled(lambda: _run(corpus, route))
    assert [name for _, _, name in ranges] == ORDER[route]
    for (s0, e0, a), (s1, e1, b) in zip(ranges, ranges[1:]):
        assert e0 <= s1, (a, b)  # contiguous, none inside another
    assert {name: row[0] for name, row in table.items()} == Counter(ORDER[route])
    for name, (count, host, device) in table.items():
        assert device is None and host > 0, name
    assert sum(row[1] for row in table.values()) <= (ranges[-1][1] - ranges[0][0]) * 1e-9


def test_no_profiler_no_spans(corpus):
    P.reset_phases()
    assert P.annotate("train.optimizer") is P.OFF and P.annotate("label.decode") is P.OFF
    _run(corpus, "resident")
    _run(corpus, "labels")
    assert P.phase_table() == {}


@pytest.mark.parametrize("route", ROUTES)
def test_results_bit_equal_with_and_without_the_profiler(corpus, route):
    plain, out = _run(corpus, route)
    (traced, traced_out), _, _ = _profiled(lambda: _run(corpus, route))
    if route == "labels":
        assert out == traced_out and out
        return
    assert plain.history == traced.history
    assert np.isfinite(plain.history["train_loss"][-1])
    assert bool(plain.history["train_wer"]) == (route == "resident+wer")
    for (k, a), b in zip(plain.model.state_dict().items(), traced.model.state_dict().values()):
        assert torch.equal(a, b), k
    for name, slots in plain.state.optimizer.state.items():
        for k, v in slots.items():
            assert torch.equal(v, traced.state.optimizer.state[name][k]), (name, k)
    assert torch.equal(plain.state.generator.get_state(), traced.state.generator.get_state())


def _raise_stop(*args, **kwargs):
    raise StopIteration("from inside a step")


@pytest.mark.parametrize("profiled", [False, True], ids=["plain", "profiled"])
@pytest.mark.parametrize("route", ["resident", "stream", "labels"])
def test_a_stop_iteration_inside_a_step_is_raised(corpus, monkeypatch, route, profiled):
    """Only the data's end ends an epoch or a pass: a ``StopIteration`` from
    a step or the predict step is the caller's to see."""
    trainer = _trainer(corpus[0])
    if route == "labels":
        monkeypatch.setattr(trainer, "_predict_step", _raise_stop)
    else:  # the stream's step is built on the trainer's core, the resident route's epoch step anew
        monkeypatch.setattr(trainer, "_train_core", _raise_stop)
        monkeypatch.setattr(L, "make_feature_train_step", lambda *a, **k: _raise_stop)
    P.reset_phases()
    with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU]) if profiled else P.OFF:
        with pytest.raises(StopIteration, match="from inside a step"):
            _run(corpus, route, trainer)
    table = P.phase_table()
    assert ("train.optimizer" not in table and "label.decode" not in table) and bool(table) == profiled


def test_trace_empties_the_table(tmp_path):
    with P.trace(str(tmp_path)):
        with P.annotate("train.optimizer"):
            pass
    with P.trace(str(tmp_path)):
        with P.annotate("label.decode"):
            pass
    assert set(P.phase_table()) == {"label.decode"}


def _card_trainer(vocab):
    enc = TC.ConformerConfig(num_blocks=2, d_model=64, num_heads=2, ffn_dim=128, conv_kernel_size=7, dropout=0.1)
    dec = TC.DecoderConfig(projection_dim=32, lstm_hidden=32, dropout=0.1)
    trainer = Trainer(ConformerCTC(TC.ModelConfig(encoder=enc, decoder=dec, n_mels=40, use_pallas=True), len(vocab)),
                      vocab, TC.FeatureConfig(), TC.TrainConfig(batch_size=BATCH, log_every=0), log_fn=lambda _: None)
    trainer.init_state(seed=0)
    return trainer


@pytest.mark.cuda
def test_step_leaves_cover_the_step_on_the_card(corpus, monkeypatch):
    """On the card the device times of a step's spans add up to at least
    95% of the step's own event span, around the resident route's epoch
    step of one order row."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vocab, data = corpus
    trainer = _card_trainer(vocab)
    resident = DeviceResidentDataset(data["train"], device="cuda")
    trainer.train(resident, epochs=1)  # builds and warms the kernels
    real, pairs = trainer._epoch_scan_fn, []

    def timed_scan_fn(*args, **kwargs):
        epoch_step = real(*args, **kwargs)

        def timed(*step_args):
            start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
            start.record()
            out = epoch_step(*step_args)
            end.record()
            pairs.append((start, end))
            return out

        return timed

    monkeypatch.setattr(trainer, "_epoch_scan_fn", timed_scan_fn)
    _, _, table = _profiled(lambda: trainer.train(resident, epochs=1))
    steps = sum(start.elapsed_time(end) for start, end in pairs) / 1e3
    spans = sum(table[k][2] for k in ("train.gather", *STEP_SPANS))
    assert len(pairs) == table["train.optimizer"][0] == 2 and spans >= 0.95 * steps, (steps, table)
    assert np.isfinite(trainer.history["train_loss"][-1])


@pytest.mark.cuda
def test_kernel_groups_count_the_kernels_of_a_step_without_spans(corpus, monkeypatch):
    """`kernel_groups` over profiled calls with spans gives the launches it
    gives over the same calls with every span off, and a device time within
    a fifth of it: a span's range on the device's timeline is no kernel."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    vocab, data = corpus
    trainer = _card_trainer(vocab)
    resident = DeviceResidentDataset(data["train"], device="cuda")
    trainer.train(resident, epochs=2)  # builds and warms the kernels

    def groups():
        with torch.profiler.profile(activities=[torch.profiler.ProfilerActivity.CPU,
                                                torch.profiler.ProfilerActivity.CUDA]) as prof:
            trainer.train(resident, epochs=1)
            torch.cuda.synchronize()
        g = P.kernel_groups(prof)
        return sum(ms for ms, _ in g.values()), sum(n for _, n in g.values())

    spans_ms, spans_n = groups()
    monkeypatch.setattr(L, "annotate", lambda name: P.OFF)
    plain_ms, plain_n = groups()
    assert spans_n == plain_n and spans_ms == pytest.approx(plain_ms, rel=0.2), (spans_ms, plain_ms)
