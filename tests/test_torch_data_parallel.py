"""Data parallelism over processes: the port on two gloo processes against
the port on one, and against the JAX `Trainer` on its 8-device virtual CPU
mesh.

One launch of two workers and one in-process run of the same scenario
(`_torch_multiproc_helpers.scenario_data_parallel`), from the weights of
``test_torch_trainer.py`` (the JAX initialisation with noise, converted):
the masked BatchNorm on a ragged batch split over the ranks, `_batch_loss`
with one rank holding only batch padding, two epochs of `Trainer.train`
with validation, `evaluate` with its texts, `generate_labels`, one
`run_nst` generation (SpecAugment on), a resident epoch with
SpecAugment and waveform noise, and one step's gradient.  One ``torchrun``
launch of ``cli train``.

Tolerances.  Two processes against one: BatchNorm outputs, gradients and
running statistics atol 1e-6; a step's gradient 1e-5 of each tensor's
largest entry; losses rtol 1e-5; WER, strings, pseudo-labels and the mix
manifest equal; parameters after two epochs rtol 1e-5, with an atol of
1e-5 of each tensor's largest entry, except the rel-pos projections
``mhsa.pos_proj.weight``.  Their gradient is
exactly zero along the sinusoid's near-constant columns (a shift of every
score of a query row leaves its softmax unchanged), so there it is float
noise of ~1e-7, which Adafactor's normalised update turns into steps of
±lr whose sign differs between any two summation orders: up to 2e-3 apart
after 8 steps at lr 1e-3, in one process as in two.  They are held through
the projected table with its mean over positions removed, the part the
attention sees, at atol 5e-4 (1.1e-4 was read; the table's entries reach
1.75).  Against the JAX trainer: losses rtol 1e-4, as
``test_torch_trainer.py``; WER, strings and labels equal.
"""

import json
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp
from _torch_multiproc_helpers import (
    NST,
    REPO,
    assert_params_close,
    free_port,
    launch,
    model_config,
    scenario_data_parallel,
)
from _torch_trainer_helpers import jax_trainer, make_corpus, perturbed_variables
from _torch_trainer_helpers import model_config as helpers_model_config

from nn_conformer_for_speech_recognition_tpu.models import conformer as JCM
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import DataShard
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_epoch_scan_step

B, T, C = 4, 6, 5  # the BatchNorm batch: two rows a rank


def _norm_inputs(rng):
    return {"x": (rng.standard_normal((B, T, C)) * 2 + 1).astype(np.float32),
            "lengths": np.asarray([6, 3, 5, 1]), "scale": np.full(C, 1.5, np.float32),
            "bias": np.full(C, 0.2, np.float32), "probe": rng.standard_normal((B, T, C)).astype(np.float32)}


def _loss_inputs(rng):
    """Four rows; rows 2 and 3, the second rank's, are batch padding."""
    logits = rng.standard_normal((4, 9, 7)).astype(np.float32)
    log_probs = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    return {"log_probs": log_probs, "targets": np.asarray([[3, 4, 0], [5, 0, 0], [0, 0, 0], [0, 0, 0]]),
            "out_lengths": np.asarray([9, 7, 0, 0]), "target_lengths": np.asarray([2, 1, 0, 0])}


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("dp")
    manifests, jvocab, tvocab, jdata, tdata = make_corpus(root / "corpus")
    variables = perturbed_variables(jax_trainer(jvocab), np.random.default_rng(0))
    assert model_config() == helpers_model_config(TC)  # the workers' copy of the tiny configuration
    sd_path = str(root / "start.pt")
    torch.save(flax_to_state_dict(variables, model_config()), sd_path)
    rng = np.random.default_rng(0)
    norm, loss = _norm_inputs(rng), _loss_inputs(rng)
    args = {"manifests": manifests, "state_dict": sd_path, "norm": {k: v.tolist() for k, v in norm.items()},
            "loss": {k: v.tolist() for k, v in loss.items()}}
    return dict(root=root, jvocab=jvocab, jdata=jdata, tdata=tdata, variables=variables, norm=norm, loss=loss,
                args=args)


@pytest.fixture(scope="module")
def one(setup):
    result, tensors = scenario_data_parallel({**setup["args"], "work_dir": str(setup["root"] / "one")})
    return {**result, "tensors": tensors}


@pytest.fixture(scope="module")
def two(setup):
    return launch("data_parallel", 2, {**setup["args"], "work_dir": str(setup["root"] / "two")},
                  str(setup["root"] / "two_out"))


@pytest.fixture(scope="module")
def jax_run(setup):
    jt = jax_trainer(setup["jvocab"], setup["variables"])
    data = setup["jdata"]
    history = {k: list(v) for k, v in jt.train(data["train"], epochs=2, val_dataset=data["validation"]).items()}
    return dict(history=history, eval=jt.evaluate(data["validation"], return_texts=True),
                labels=jt.generate_labels(data["unlabeled"]))


def test_ranks_hold_the_same_state(two):
    t0, t1 = two[0]["tensors"], two[1]["tensors"]
    for k in t0:
        if k.split(".")[0] in ("trained", "nst", "fused", "grad", "running_mean", "running_var"):
            assert torch.equal(t0[k], t1[k]), k
    assert two[0]["history"] == two[1]["history"] and two[0]["step"] == two[1]["step"]


def test_masked_batchnorm_takes_the_global_statistics(setup, one, two):
    rank = [r["tensors"] for r in two]
    ref = one["tensors"]
    for k in ("y", "dx"):
        torch.testing.assert_close(torch.cat([r[k] for r in rank]), ref[k], rtol=0, atol=1e-6, msg=k)
    for k in ("dscale", "dbias"):  # each rank's part of the parameter gradient; their sum is the global one
        torch.testing.assert_close(rank[0][k] + rank[1][k], ref[k], rtol=0, atol=1e-6, msg=k)
    for r in rank:
        for k in ("running_mean", "running_var"):
            torch.testing.assert_close(r[k], ref[k], rtol=0, atol=1e-6, msg=k)
    # the JAX module on the whole batch: the statistics GSPMD gives a sharded batch
    n = setup["norm"]
    mask = np.arange(T)[None, :] < n["lengths"][:, None]
    vs = {"params": {"scale": n["scale"], "bias": n["bias"]},
          "batch_stats": {"mean": np.zeros(C, np.float32), "var": np.ones(C, np.float32)}}
    y, upd = JCM.MaskedBatchNorm().apply(vs, jnp.asarray(n["x"]), jnp.asarray(mask), mutable=["batch_stats"])
    got_y = torch.cat([r["y"] for r in rank]).numpy()
    np.testing.assert_allclose(got_y[mask], np.asarray(y)[mask], atol=1e-5)
    np.testing.assert_allclose(rank[1]["running_mean"].numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(rank[1]["running_var"].numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-6)


def test_batch_loss_with_a_rank_of_padding_only(one, two):
    assert two[1]["loss"] == 0.0, "the rank with only batch padding must add zero"
    assert np.isfinite(two[0]["loss"]) and two[0]["loss"] > 0
    np.testing.assert_allclose(two[0]["loss"] + two[1]["loss"], one["loss"], rtol=1e-6)
    got = torch.cat([r["tensors"]["dlog_probs"] for r in two])
    torch.testing.assert_close(got, one["tensors"]["dlog_probs"], rtol=0, atol=1e-6)
    assert not got[2:].any()


def test_a_step_gradient_is_the_global_batchs(one, two):
    ref = one["tensors"]
    for k in (k for k in ref if k.startswith("grad.")):
        scale = float(ref[k].abs().max())
        torch.testing.assert_close(two[0]["tensors"][k], ref[k], rtol=0, atol=1e-5 * scale + 1e-12, msg=k)


def test_two_processes_train_as_one(one, two):
    got, ref = two[0]["history"], one["history"]
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-5)
    np.testing.assert_allclose(got["val_loss"], ref["val_loss"], rtol=1e-5)
    assert got["val_wer"] == ref["val_wer"] and len(got["train_loss"]) == 2
    assert_params_close(two[0]["tensors"], one["tensors"], "trained.")


def test_evaluate_and_labels_are_gathered(setup, one, two):
    for r in two:
        loss, wer, refs, hyps = r["eval"]
        np.testing.assert_allclose(loss, one["eval"][0], rtol=1e-5)
        assert wer == pytest.approx(one["eval"][1], rel=1e-12) and refs == one["eval"][2] and hyps == one["eval"][3]
        np.testing.assert_allclose(r["padded"][0], one["padded"][0], rtol=1e-5)
        assert r["padded"][1] == pytest.approx(one["padded"][1], rel=1e-12)
        assert r["labels"] == one["labels"]
    assert len(one["eval"][2]) == len(setup["tdata"]["validation"].utterances) and any(one["eval"][3])
    assert sorted(int(k) for k in two[0]["labels"]) == list(range(len(setup["tdata"]["unlabeled"].utterances)))


def test_nst_generation_on_two_processes(one, two):
    assert two[0]["nst"] == two[1]["nst"] == one["nst"] and one["nst"][0] > 0
    assert two[0]["mix"] == one["mix"] and two[1]["mix"] == one["mix"]
    assert NST["generations"] == 1 and one["mix"].count("\n") > len(one["labels"])


def test_resident_fused_epoch_on_two_processes(one, two):
    got, ref = two[0]["fused_history"], one["fused_history"]
    np.testing.assert_allclose(got["train_loss"], ref["train_loss"], rtol=1e-5)
    assert got["train_wer"] == pytest.approx(ref["train_wer"], rel=1e-12)
    assert_params_close(two[0]["tensors"], one["tensors"], "fused.")


def test_port_on_two_processes_matches_the_jax_trainer(jax_run, two):
    got, ref = two[0], jax_run
    np.testing.assert_allclose(got["history"]["train_loss"], ref["history"]["train_loss"], rtol=1e-4)
    np.testing.assert_allclose(got["history"]["val_loss"], ref["history"]["val_loss"], rtol=1e-4)
    assert got["history"]["val_wer"] == ref["history"]["val_wer"]
    loss, wer, refs, hyps = got["eval"]
    np.testing.assert_allclose(loss, ref["eval"][0], rtol=1e-4)
    assert (wer, refs, hyps) == (ref["eval"][1], ref["eval"][2], ref["eval"][3])
    assert {int(k): v for k, v in got["labels"].items()} == ref["labels"]


def test_indivisible_batch_raises(setup):
    with pytest.raises(ValueError, match=r"8 rows does not divide over 3 processes"):
        DataShard(1, 3).rows(8)
    with pytest.raises(ValueError, match=r"8 rows does not divide over 3"):
        DeviceResidentDataset(setup["tdata"]["train"], device="cpu", sharding=DataShard(0, 3))
    with pytest.raises(TypeError, match="DataShard"):
        make_epoch_scan_step(None, None, None, 0, batch_sharding=object())
    assert [DataShard(r, 4).rows(8) for r in range(4)] == [slice(0, 2), slice(2, 4), slice(4, 6), slice(6, 8)]


def _torchrun(flags, timeout=300):
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""), "OMP_NUM_THREADS": "1"}
    run = subprocess.run(
        [sys.executable, "-m", "torch.distributed.run", "--standalone", "--nproc-per-node", "2",
         "--master-port", str(free_port()), "-m", "nn_conformer_for_speech_recognition_tpu_torch.cli.main", *flags],
        env=env, capture_output=True, text=True, timeout=timeout)
    assert run.returncode == 0, run.stdout[-3000:] + run.stderr[-3000:]
    return run.stdout


def test_cli_train_and_eval_under_torchrun(tmp_path, capsys):
    """``torchrun --standalone --nproc-per-node 2 -m …cli.main train`` then
    ``eval`` on the CPU: both ranks finish, rank 0 alone logs, saves and
    prints the result line, and the two-process evaluation of the saved
    checkpoint equals one process's (loss rtol 1e-5, WER equal).  The
    preset trains with dropout 0.5, drawn per rank, so the trained weights
    are not held to a one-process run's."""
    from nn_conformer_for_speech_recognition_tpu_torch.cli.main import main
    from nn_conformer_for_speech_recognition_tpu_torch.data.audio import make_synthetic_corpus

    corpus = str(tmp_path / "corpus")
    make_synthetic_corpus(corpus, ["go", "stop", "yes", "no"], n_train=16, n_val=8, n_test=0, n_unlabeled=0,
                          max_words_per_utt=2, seed=0)
    common = ["--manifest-dir", corpus, "--model", "reference", "--compute-dtype", "float32", "--use-pallas",
              "--batch-size", "8", "--max-target-len", "4", "--device", "cpu"]
    out = _torchrun(["train", *common, "--epochs", "1", "--lr", "1e-3", "--save", str(tmp_path / "saved")])
    assert out.count("epoch 0:") == 1, out  # rank 0 logs
    assert torch.load(tmp_path / "saved" / "state.pt", weights_only=True)["step"] == 2  # 16 clips, global batch 8
    evaluate = ["eval", *common, "--split", "validation", "--checkpoint", str(tmp_path / "saved")]
    lines = [line for line in _torchrun(evaluate).splitlines() if line.startswith("{")]
    assert len(lines) == 1, lines  # rank 0 prints the result
    capsys.readouterr()
    assert main(evaluate) == 0
    got, ref = json.loads(lines[0]), json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    np.testing.assert_allclose(got["loss"], ref["loss"], rtol=1e-5)
    assert got["wer"] == pytest.approx(ref["wer"], rel=1e-12) and got["split"] == "validation"


def test_cli_pretrain_under_torchrun(tmp_path):
    """``torchrun --standalone --nproc-per-node 2 -m …cli.main pretrain`` on
    the CPU: both ranks take their rows of the batch, rank 0 alone logs and
    writes the checkpoint, which holds the whole pretraining model."""
    from nn_conformer_for_speech_recognition_tpu_torch.data.audio import make_synthetic_corpus

    corpus = str(tmp_path / "corpus")
    make_synthetic_corpus(corpus, ["go", "stop"], n_train=0, n_val=0, n_test=0, n_unlabeled=8, max_words_per_utt=2,
                          seed=0)
    save = tmp_path / "pretrained"
    out = _torchrun(["pretrain", "--manifest-dir", corpus, "--model", "reference", "--n-mels", "8", "--epochs", "1",
                     "--batch-size", "8", "--lr", "1e-3", "--save", str(save), "--device", "cpu"])
    assert out.count("pretrain epoch 0:") == 1, out
    saved = torch.load(save / "state.pt", weights_only=True)
    assert saved["step"] == 1 and saved["model"]["decoder.lstm_fwd_0_w_hh"].shape == (160, 640)
