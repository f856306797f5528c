"""The port's command line against the JAX package's, on the CPU.

One starting checkpoint is made once per file (the JAX initialisation of
the ``reference`` preset with noise added and the blank's bias lowered, so
that decodes are words), saved by the JAX `Trainer` and, converted, by the
port's; both command lines then run ``eval`` (greedy and beam) and ``nst``
from it on one synthetic corpus.  Tolerances: the evaluation loss rtol 1e-4
(float32, sums in another order), WER and the dumped strings equal.  The
``nst`` runs train with dropout 0.5 and SpecAugment, which the two packages
draw from different generators, at lr 3e-6 for two steps: the labels, the
kept count and the mix manifest are held equal, the validation loss to
rtol 5e-2 (the batch statistics move with each package's own dropout
masks; 1.9% was read).
"""

import argparse
import json
import os

import jax
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.cli.main import build_parser as jax_parser
from nn_conformer_for_speech_recognition_tpu.cli.main import main as jax_main
from nn_conformer_for_speech_recognition_tpu.data.audio import make_synthetic_corpus
from nn_conformer_for_speech_recognition_tpu.data.datasets import load_manifest
from nn_conformer_for_speech_recognition_tpu.data.vocab import build_vocab as jax_build_vocab
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC as JaxCTC
from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer as JaxTrainer
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.cli.main import build_parser, main
from nn_conformer_for_speech_recognition_tpu_torch.data import datasets as TD
from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import restore_state
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

LOSS_RTOL = 1e-4
MODEL = ["--model", "reference", "--compute-dtype", "float32", "--use-pallas", "--n-mels", "40"]
DATA = ["--batch-size", "8", "--max-target-len", "4"]  # the JAX trainer shards a batch over 8 virtual devices


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    """The corpus, and one checkpoint of the same weights for each package."""
    root = tmp_path_factory.mktemp("cli")
    corpus = str(root / "corpus")
    make_synthetic_corpus(corpus, ["go", "stop", "yes", "no"], n_train=8, n_val=8, n_test=8, n_unlabeled=8,
                          max_words_per_utt=2, seed=0)
    transcripts = [u.transcript for u in load_manifest(os.path.join(corpus, "train.tsv"))]
    jvocab, tvocab = jax_build_vocab("word", transcripts, 1024), build_vocab("word", transcripts, 1024)
    kw = dict(compute_dtype="float32", use_pallas=True, n_mels=40)
    jt = JaxTrainer(JaxCTC(C.MODEL_PRESETS["reference"](**kw), vocab_size=len(jvocab)), jvocab,
                    C.FeatureConfig(), C.TrainConfig(batch_size=8), log_fn=lambda _: None)
    jt.init_state(seed=0)
    rng = np.random.default_rng(0)
    vs = {"params": jax.tree.map(np.asarray, jt.state.params), "batch_stats": jax.tree.map(np.asarray, jt.state.batch_stats)}
    vs = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), vs)
    vs["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, vs["batch_stats"])
    vs["params"]["final_fc"]["bias"][0] -= 3.0
    jt.state = jt.state.replace(params=vs["params"], batch_stats=vs["batch_stats"])
    jt.save(str(root / "jax_ckpt"))
    tt = Trainer(ConformerCTC(TC.MODEL_PRESETS["reference"](**kw), len(tvocab)), tvocab, TC.FeatureConfig(),
                 TC.TrainConfig(batch_size=8), device="cpu", log_fn=lambda _: None)
    tt.init_state(seed=0, variables=vs)
    tt.save(str(root / "port_ckpt"))
    return dict(root=root, corpus=corpus, trainer=tt, vocab=tvocab,
                jax=["--manifest-dir", corpus, *MODEL, *DATA, "--checkpoint", str(root / "jax_ckpt")],
                port=["--manifest-dir", corpus, *MODEL, *DATA, "--checkpoint", str(root / "port_ckpt"), "--device", "cpu"])


def _last_json(capsys):
    return json.loads(capsys.readouterr().out.strip().splitlines()[-1])


@pytest.mark.parametrize("decode", [[], ["--decode", "beam", "--beam", "4", "--prune", "4", "--max-label-len", "8"]],
                         ids=["greedy", "beam"])
def test_eval_matches_jax_cli(setup, capsys, decode):
    out = {}
    for name, run in (("jax", jax_main), ("port", main)):
        results = str(setup["root"] / f"res_{name}_{len(decode)}")
        assert run(["eval", *setup[name], "--split", "test", "--results-dir", results, *decode]) == 0
        out[name] = (_last_json(capsys), open(os.path.join(results, "pred_tgt.txt")).read())
    (got, got_dump), (ref, ref_dump) = out["port"], out["jax"]
    assert got.keys() == ref.keys() and got["split"] == ref["split"] == "test" and got["decode"] == ref["decode"]
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=LOSS_RTOL)
    assert got["wer"] == ref["wer"] and got_dump == ref_dump
    assert got_dump.splitlines()[0] != "pred: ", "the first decode is empty: the comparison is vacuous"


def test_eval_from_checkpoint_equals_trainer_evaluate(setup, capsys):
    """The command line restores what `Trainer.save` wrote: same loss, same
    WER as the trainer that holds the weights, greedy and beam."""
    data = TD.BucketedDataset(TD.load_manifest(os.path.join(setup["corpus"], "validation.tsv")), setup["vocab"], 8,
                              max_target_len=4)
    for decode in ("greedy", "beam"):
        loss, wer = setup["trainer"].evaluate(data, decode=decode)
        assert main(["eval", *setup["port"], "--split", "validation", "--decode", decode]) == 0
        got = _last_json(capsys)
        assert got == {"split": "validation", "loss": loss, "wer": 100 * wer, "decode": decode}


def test_nst_matches_jax_cli(setup, capsys):
    out = {}
    for name, run in (("jax", jax_main), ("port", main)):
        work = str(setup["root"] / f"nst_{name}")
        assert run(["nst", *setup[name], "--generations", "1", "--work-dir", work]) == 0
        out[name] = (_last_json(capsys), open(os.path.join(work, "mix_gen0.tsv")).read())
    (got, got_mix), (ref, ref_mix) = out["port"], out["jax"]
    assert len(got) == len(ref) == 1 and got[0].keys() == ref[0].keys()
    for key in ("generation", "num_pseudo_labels", "num_kept", "is_best"):
        assert got[0][key] == ref[0][key], key
    assert got[0]["num_pseudo_labels"] == 8 and got[0]["num_kept"] > 0
    assert got_mix == ref_mix
    np.testing.assert_allclose(got[0]["val_loss"], ref[0]["val_loss"], rtol=5e-2)


def test_train_save_resume_and_streaming(setup, tmp_path, capsys):
    """`train --checkpoint-dir`, then `--resume` to a second epoch: the saved
    state counts two steps (8 clips in batches of 8); a finished run resumes
    to nothing; `--resume` without a directory is refused with code 2; and an
    uninterrupted run, with or without `--streaming`, ends in the resumed
    run's weights bit for bit."""
    common = ["--manifest-dir", setup["corpus"], *MODEL, *DATA, "--lr", "1e-4", "--device", "cpu"]
    ckdir, save = str(tmp_path / "ck"), str(tmp_path / "saved")
    assert main(["train", *common, "--epochs", "1", "--checkpoint-dir", ckdir]) == 0
    assert main(["train", *common, "--epochs", "2", "--checkpoint-dir", ckdir, "--resume", "--save", save,
                 "--train-wer"]) == 0
    template = setup["trainer"].state
    assert restore_state(save, template).step == 2
    assert main(["train", *common, "--epochs", "2", "--checkpoint-dir", ckdir, "--resume"]) == 0
    assert main(["train", *common, "--epochs", "1", "--resume"]) == 2
    plain, streamed = str(tmp_path / "plain"), str(tmp_path / "streamed")
    assert main(["train", *common, "--epochs", "2", "--save", plain]) == 0
    assert main(["train", *common, "--epochs", "2", "--save", streamed, "--streaming"]) == 0
    a = {k: v.clone() for k, v in restore_state(plain, template).model.state_dict().items()}
    b = restore_state(streamed, template).model.state_dict()
    assert all(torch.equal(a[k], b[k]) for k in a)
    # and the run resumed after its first epoch ends where the uninterrupted one does
    c = restore_state(save, template).model.state_dict()
    assert all(torch.equal(a[k], c[k]) for k in a)
    setup["trainer"].load(str(setup["root"] / "port_ckpt"))  # the shared trainer holds the fixture's weights again
    capsys.readouterr()


def _flags(parser):
    """{subcommand: {option: (default, choices, type, nargs, required, action class)}}"""
    (sub,) = [a for a in parser._actions if isinstance(a, argparse._SubParsersAction)]
    return {
        name: {
            a.option_strings[0]: (a.default, a.choices and tuple(a.choices), a.type, a.nargs, a.required, type(a).__name__)
            for a in sp._actions if a.option_strings and a.option_strings[0] != "-h"
        }
        for name, sp in sub.choices.items()
    }


def test_parser_has_the_jax_flags_plus_device():
    got, ref = _flags(build_parser()), _flags(jax_parser())
    assert list(got) == list(ref) == ["prepare-data", "train", "eval", "nst", "pretrain", "parity", "benchmark"]
    for name in ref:
        extra = {"--device"} if name in ("train", "eval", "nst", "pretrain", "parity") else set()
        assert set(got[name]) == set(ref[name]) | extra, name
        for flag, spec in ref[name].items():
            assert got[name][flag] == spec, (name, flag)
        if extra:
            assert got[name]["--device"][:2] == ("cuda", ("cuda", "cpu"))


@pytest.mark.parametrize(
    "argv, match",
    [
        (["benchmark"], "item 9"),
    ],
)
def test_what_is_not_ported_raises(setup, argv, match):
    rest = [] if argv[0] == "benchmark" else ["--manifest-dir", setup["corpus"], "--device", "cpu"]
    with pytest.raises(NotImplementedError, match=match):
        main([*argv, *rest])


@pytest.mark.parametrize("cmd", ["train", "eval", "nst", "pretrain"])
def test_mesh_flags_reach_the_layout(setup, cmd):
    """``--model-parallel``, ``--seq-parallel`` and ``--shard-map-kernels``
    make the ``MeshConfig`` the JAX command line makes; in one process a
    model axis of 2 asks for a process group (a ``torchrun`` launch)."""
    from nn_conformer_for_speech_recognition_tpu_torch.cli.main import _mesh_config

    argv = [cmd, "--manifest-dir", setup["corpus"], "--device", "cpu"]
    args = build_parser().parse_args(argv + ["--model-parallel", "2", "--seq-parallel", "--shard-map-kernels"])
    assert _mesh_config(args) == TC.MeshConfig(model_parallel_size=2, seq_parallel=True, shard_map_kernels=True)
    assert _mesh_config(build_parser().parse_args(argv)) == TC.MeshConfig()
    with pytest.raises(ValueError, match="1 processes not divisible by model_parallel_size=2"):
        main(argv + ["--model-parallel", "2", "--model", "reference", "--n-mels", "8"])


def test_default_device_is_the_card(setup):
    """Without ``--device`` the command line takes the first CUDA device and
    raises where there is none: never a quiet CPU run."""
    args = build_parser().parse_args(["eval", "--manifest-dir", setup["corpus"]])
    assert args.device == "cuda"
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["eval", "--manifest-dir", setup["corpus"], *MODEL, *DATA])
        with pytest.raises(RuntimeError, match="no CUDA device"):
            main(["parity", "--manifest-dir", setup["corpus"], "--work-dir", str(setup["root"] / "p"), "--tiny"])
