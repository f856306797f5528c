"""The port's WER-parity harness (`parity.py`, ``cli parity --tiny``) against
the JAX package's, both protocols, on one synthetic corpus on the CPU.

Both harnesses start from one initialisation (the JAX package's, moved off
its symmetric start and converted) and train with SpecAugment and the input
noise off (``--tiny`` has no dropout), so the two runs draw no random number
that differs and every number can be held: each `Trainer.evaluate` call the
harness makes (base rows, the validation passes inside Noisy Student, the
row of each generation) gives the JAX package's loss to rtol 1e-4 (float32,
sums in another order, a few optimizer updates apart) and its WER and
decoded strings exactly, and the WER tables and kept pseudo-label counts of
the printed result are equal.  Also held equal: the result's keys and fixed
entries, the learned word-piece inventory, the files written, and the two
table formatters on the same input.
"""

import json
import os

import numpy as np
import pytest
from _torch_trainer_helpers import perturbed_variables

from nn_conformer_for_speech_recognition_tpu import parity as JP
from nn_conformer_for_speech_recognition_tpu.cli.main import main as jax_main
from nn_conformer_for_speech_recognition_tpu.data.audio import make_synthetic_corpus
from nn_conformer_for_speech_recognition_tpu_torch import parity as TP
from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer as JaxTrainer
from nn_conformer_for_speech_recognition_tpu_torch.cli.main import main
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

LOSS_RTOL = 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("paritycorpus"))
    make_synthetic_corpus(root, ["go", "stop", "yes", "no"], n_train=8, n_val=8, n_test=8, n_unlabeled=8, seed=0)
    return root


@pytest.fixture
def evals(monkeypatch):
    """Makes both packages' harnesses comparable number for number, and
    returns what each `Trainer.evaluate` call gave, per package, in order:
    `init_state` hands the port the JAX trainer's (perturbed) variables,
    `train` runs without SpecAugment and input noise, `evaluate` records
    (decode, loss, WER, hypotheses)."""
    start, seen = {}, {"jax": [], "port": []}
    jax_init, port_init = JaxTrainer.init_state, Trainer.init_state

    def init_jax(self, seed=0, example=None):
        jax_init(self, seed, example)
        start["variables"] = vs = perturbed_variables(self, np.random.default_rng(0))
        self.state = self.state.replace(params=vs["params"], batch_stats=vs["batch_stats"])
        return self.state

    def init_port(self, seed=0, example=None, variables=None):
        return port_init(self, seed, example, variables=start["variables"])

    def quiet(train):
        return lambda self, dataset, epochs, **kw: train(
            self, dataset, epochs, **{**kw, "use_specaugment": False, "add_noise": False})

    def recording(evaluate, sink):
        def wrapped(self, dataset, *args, **kw):
            loss, wer, _, hyps = evaluate(self, dataset, *args, **{**kw, "return_texts": True})
            sink.append((kw.get("decode", "greedy"), loss, wer, hyps))
            return loss, wer
        return wrapped

    monkeypatch.setattr(JaxTrainer, "init_state", init_jax)
    monkeypatch.setattr(Trainer, "init_state", init_port)
    for cls, name in ((JaxTrainer, "jax"), (Trainer, "port")):
        monkeypatch.setattr(cls, "train", quiet(cls.train))
        monkeypatch.setattr(cls, "evaluate", recording(cls.evaluate, seen[name]))
    return seen


def _assert_same_evaluations(evals, n_port_runs=1):
    """Every evaluation of the port's run(s) against the JAX run's."""
    ref = evals["jax"]
    assert len(ref) > 0 and len(evals["port"]) == n_port_runs * len(ref)
    for i, (decode, loss, wer, hyps) in enumerate(evals["port"]):
        ref_decode, ref_loss, ref_wer, ref_hyps = ref[i % len(ref)]
        assert decode == ref_decode, i
        np.testing.assert_allclose(loss, ref_loss, rtol=LOSS_RTOL, err_msg=f"evaluation {i}")
        assert wer == ref_wer and hyps == ref_hyps, i
    assert any(any(hyps) for _, _, _, hyps in ref), "every decode is empty: the comparison is vacuous"


def _run(run, argv, capsys):
    assert run(argv) == 0
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


def test_parity_tiny_speechcommands_protocol(corpus, tmp_path, capsys, evals):
    argv = ["parity", "--manifest-dir", corpus, "--epochs", "1", "--generations", "1", "--batch-size", "8", "--tiny",
            "--n-mels", "40"]
    ref = _run(jax_main, [*argv, "--work-dir", str(tmp_path / "jax")], capsys)
    got = _run(main, [*argv, "--work-dir", str(tmp_path / "port"), "--device", "cpu"], capsys)
    assert got.keys() == ref.keys()
    for key in ("protocol", "epochs", "generations", "streaming", "reference"):
        assert got[key] == ref[key], key
    assert got["stages"].keys() == ref["stages"].keys()
    assert all(s.keys() == {"wall_s", "max_rss_mb"} for s in got["stages"].values())
    assert got["wer"].keys() == ref["wer"].keys() == {"base", "nst"}
    for tab in got["wer"].values():
        assert tab.keys() == {"val", "test"} and all(np.isfinite(v) and v >= 0.0 for v in tab.values())
    assert got["wer"] == ref["wer"]
    for name in ("parity.json", "parity.md", "base_ckpt", "nst_ckpt", "mix_gen0.tsv"):
        assert os.path.exists(tmp_path / "port" / name) and os.path.exists(tmp_path / "jax" / name), name
    assert (tmp_path / "port" / "parity.md").read_text() == TP.format_table(got) + "\n"
    assert json.loads((tmp_path / "port" / "parity.json").read_text()) == got
    assert TP.format_table(ref) == JP.format_table(ref) and TP.REFERENCE_TABLE == JP.REFERENCE_TABLE
    # the streaming variant runs the same protocol
    streamed = _run(main, [*argv, "--work-dir", str(tmp_path / "streamed"), "--device", "cpu", "--streaming"], capsys)
    assert streamed["streaming"] is True and streamed["wer"] == ref["wer"]
    _assert_same_evaluations(evals, n_port_runs=2)


def test_parity_tiny_librispeech_protocol(corpus, tmp_path, capsys, evals):
    argv = ["parity", "--protocol", "librispeech", "--manifest-dir", corpus, "--epochs", "1", "--generations", "2",
            "--batch-size", "8", "--tiny", "--max-target-len", "16", "--beam", "4", "--prune", "4"]
    ref = _run(jax_main, [*argv, "--work-dir", str(tmp_path / "jax")], capsys)
    got = _run(main, [*argv, "--work-dir", str(tmp_path / "port"), "--device", "cpu"], capsys)
    assert got.keys() == ref.keys()
    for key in ("protocol", "vocab", "epochs", "generations", "beam", "prune", "unk_tolerance",
                "train_dropped_by_filter", "reference"):
        assert got[key] == ref[key], key
    rows, ref_rows = got["wer_per_generation"], ref["wer_per_generation"]
    assert [r["generation"] for r in rows] == [r["generation"] for r in ref_rows] == ["base", 0, 1]
    for row, ref_row in zip(rows, ref_rows):
        assert row.keys() == ref_row.keys()
        assert np.isfinite(row["dev"]) and np.isfinite(row["test"]) and row["dev"] >= 0.0
        assert row == ref_row
    _assert_same_evaluations(evals)
    assert {decode for decode, *_ in evals["port"]} == {"greedy", "beam"}  # NST validates greedy, the rows are beam
    # the word-piece inventory learned from the transcripts is the same file in both packages
    assert (tmp_path / "port" / "wmp_vocab.txt").read_text() == (tmp_path / "jax" / "wmp_vocab.txt").read_text()
    assert (tmp_path / "port" / "librispeech_parity.md").read_text() == TP.format_librispeech_table(rows) + "\n"
    assert TP.format_librispeech_table(ref_rows) == JP.format_librispeech_table(ref_rows)
    for name in ("librispeech_parity.json", "ls_base_ckpt", "ls_nst_ckpt", "ls_gen0", "ls_gen1"):
        assert os.path.exists(tmp_path / "port" / name) and os.path.exists(tmp_path / "jax" / name), name


def test_reference_vocab_roundtrip_runs_only_where_the_file_is(tmp_path):
    """An absent artifact is skipped with a note, as in the JAX package; a
    present one is loaded and every token round-trips."""
    notes = []
    assert TP.assert_reference_vocab_roundtrip(str(tmp_path / "missing.txt"), log=notes.append) is None
    assert "absent" in notes[0]
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab

    path = str(tmp_path / "words.txt")
    build_vocab("word", ["yes no go stop"]).save(path)
    vocab = TP.assert_reference_vocab_roundtrip(path, log=notes.append)
    assert len(vocab) == 7 and "4 tokens round-trip OK" in notes[-1]
    # the default artifacts are looked for inside the repository, never around it
    root = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    assert TP.REFERENCE_WORD_VOCAB == os.path.join(root, "reference", "vocabs", "myvocab.txt")
    assert TP.REFERENCE_WPM_VOCAB == os.path.join(root, "reference", "vocabs", "wmp_vocab.txt")
