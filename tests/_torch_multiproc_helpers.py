"""Runs the port over several processes on the CPU, for the data-parallel
tests: `launch` starts N workers, each a fresh interpreter running one
function of this module under a gloo process group (the environment that
``torchrun`` gives a worker: ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``,
``MASTER_ADDR``, ``MASTER_PORT``), and returns what each wrote.  The twin of
``examples/multihost_cpu_dryrun.py``'s ``launch`` for the JAX package.

The scenarios are plain functions of a JSON-able argument dict; a test runs
the same function in its own process, without a process group, for the
one-process answer.  This module imports torch and the port only, so the
workers never import jax.

    python tests/_torch_multiproc_helpers.py SCENARIO ARGS.json OUT_DIR   # one worker
"""

from __future__ import annotations

import json
import os
import socket
import subprocess
import sys
import time

import numpy as np
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
WORDS = ["yes", "no", "go", "stop"]
BATCH, LR = 8, 1e-3
NST = dict(generations=1, train_epochs_per_generation=1, initial_supervised_finetune=False, max_target_len=12,
           unk_tolerance=1.0)


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def launch(scenario: str, nproc: int, args: dict, out_dir: str, timeout: float = 300.0) -> list:
    """Runs ``scenario`` in ``nproc`` processes joined by gloo; returns the
    result of each rank in rank order (its JSON, with the tensors it saved
    under ``"tensors"``).  Raises with every worker's output where one
    fails or the run outlasts ``timeout`` seconds."""
    os.makedirs(out_dir, exist_ok=True)
    args_path = os.path.join(out_dir, "args.json")
    with open(args_path, "w") as f:
        json.dump(args, f)
    env = {**os.environ, "PYTHONPATH": REPO + os.pathsep + os.environ.get("PYTHONPATH", ""),
           "WORLD_SIZE": str(nproc), "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(free_port()),
           "OMP_NUM_THREADS": "1"}
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), scenario, args_path, out_dir],
                              env={**env, "RANK": str(r), "LOCAL_RANK": str(r)}, stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True)
             for r in range(nproc)]
    deadline, outputs = time.time() + timeout, []
    for p in procs:
        try:
            outputs.append(p.communicate(timeout=max(1.0, deadline - time.time()))[0])
        except subprocess.TimeoutExpired:
            for q in procs:
                q.kill()
            outputs.append(p.communicate()[0])
    if any(p.returncode != 0 for p in procs):
        report = "\n".join(f"----- rank {r} rc={p.returncode} -----\n{out}" for r, (p, out) in
                           enumerate(zip(procs, outputs)))
        raise RuntimeError(f"{scenario} on {nproc} processes failed:\n{report}")
    return [read_result(out_dir, r) for r in range(nproc)]


def read_result(out_dir: str, rank: int) -> dict:
    with open(os.path.join(out_dir, f"rank{rank}.json")) as f:
        result = json.load(f)
    result["tensors"] = torch.load(os.path.join(out_dir, f"rank{rank}.pt"), weights_only=True)
    return result


def write_result(out_dir: str, rank: int, result: dict, tensors: dict) -> None:
    torch.save(tensors, os.path.join(out_dir, f"rank{rank}.pt"))
    with open(os.path.join(out_dir, f"rank{rank}.json"), "w") as f:
        json.dump(result, f)


# ---------------------------------------------------------------------------
# the tiny configuration of `_torch_trainer_helpers.py`, port side only
# ---------------------------------------------------------------------------


def model_config(dropout=0.0):
    from nn_conformer_for_speech_recognition_tpu_torch import config as TC

    enc = TC.ConformerConfig(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64, conv_kernel_size=7, dropout=dropout)
    dec = TC.DecoderConfig(projection_dim=16, lstm_hidden=16, dropout=dropout)
    return TC.ModelConfig(encoder=enc, decoder=dec, n_mels=13, use_pallas=True, conv_impl="pallas",
                          compute_dtype="float32")


def port_datasets(manifests: dict):
    """The port's vocabulary and datasets over the corpus' manifests, as
    `_torch_trainer_helpers.make_corpus` builds them."""
    from nn_conformer_for_speech_recognition_tpu_torch.data import datasets as TD
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab

    vocab = build_vocab("word", [u.transcript for u in TD.load_manifest(manifests["train"])])
    kw = dict(batch_size=BATCH, bucket_boundaries=[14000], max_target_len=4)
    return vocab, {k: TD.BucketedDataset(TD.load_manifest(v), vocab, **kw) for k, v in manifests.items()}


def port_trainer(vocab, state_dict_path, **train_kw):
    """A CPU `Trainer` of the tiny model whose weights are the converted
    state dict at ``state_dict_path``."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as TC
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    tcfg = TC.TrainConfig(batch_size=BATCH, optimizer=TC.OptimizerConfig(learning_rate=LR),
                          **{"use_specaugment": False, "log_every": 0, **train_kw})
    trainer = Trainer(ConformerCTC(model_config(), len(vocab)), vocab,
                      TC.FeatureConfig(n_fft=256, hop_length=256, n_mels=13), tcfg, device="cpu",
                      log_fn=lambda _: None)
    trainer.init_state(seed=0)
    trainer.model.load_state_dict(torch.load(state_dict_path, weights_only=True), strict=True)
    return trainer


def assert_params_close(got: dict, ref: dict, prefix: str, rtol: float = 1e-5) -> None:
    """Every tensor of ``ref`` under ``prefix`` against ``got``'s: rtol,
    with an atol of rtol times the tensor's largest entry.  A rel-pos
    projection (``mhsa.pos_proj.weight``) is held through the projected
    table with its mean over positions removed, at atol 5e-4: along the
    sinusoid's near-constant columns its gradient is float noise, which
    Adafactor's normalised update turns into a step of either sign."""
    from nn_conformer_for_speech_recognition_tpu_torch.models.conformer import sinusoidal_rel_positions

    names = [k for k in ref if k.startswith(prefix)]
    assert names and {k for k in got if k.startswith(prefix)} == set(names)
    for k in names:
        if k.endswith("mhsa.pos_proj.weight"):
            rel = torch.from_numpy(sinusoidal_rel_positions(64, got[k].shape[1]))
            a, b = rel @ got[k].T, rel @ ref[k].T
            torch.testing.assert_close(a - a.mean(0), b - b.mean(0), rtol=0, atol=5e-4,
                                       msg=lambda m, k=k: f"{k}: {m}")
        else:
            atol = rtol * float(ref[k].abs().max())
            torch.testing.assert_close(got[k], ref[k], rtol=rtol, atol=atol, msg=lambda m, k=k: f"{k}: {m}")


def params(trainer) -> dict:
    return {k: v.detach().clone() for k, v in trainer.model.state_dict().items()}


# ---------------------------------------------------------------------------
# scenarios: each returns (JSON-able result, {name: tensor})
# ---------------------------------------------------------------------------


def scenario_gathers(args):
    """The multihost gathers with uneven shapes and a long non-ASCII text,
    and the parameter sync check on one perturbed rank."""
    from nn_conformer_for_speech_recognition_tpu_torch.parallel import multihost as MH
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import data_shard

    shard = data_shard()
    rank = shard.rank
    value, weight = args["metrics"][rank]
    mean, total = MH.gather_metric(value, weight)
    ids = np.asarray(args["ids"][rank], np.int32)
    ids_g, lens_g = MH.gather_token_batches(ids, np.asarray(args["lengths"][rank], np.int64))
    labels = MH.gather_pseudo_labels({int(k): v for k, v in args["labels"][rank].items()})
    torch.manual_seed(0)
    model = torch.nn.Linear(3, 2)
    MH.assert_params_in_sync(model)
    with torch.no_grad():
        model.bias.add_(1e-7 * rank)
    try:
        MH.assert_params_in_sync(model)
        diverged = False
    except AssertionError:
        diverged = True
    return ({"world": shard.world, "mean": mean, "total": total, "lengths": lens_g.tolist(),
             "labels": {str(k): v for k, v in labels.items()}, "multihost": MH.is_multihost(),
             "diverged_detected": diverged, "fingerprint": MH.params_fingerprint(model).tolist()},
            {"ids": torch.from_numpy(ids_g)})


def scenario_norm_and_loss(args):
    """MaskedBatchNorm in train mode on the rank's rows of a ragged batch,
    and `_batch_loss` on the rank's rows where the last rank holds only
    batch padding."""
    from nn_conformer_for_speech_recognition_tpu_torch.models.conformer import MaskedBatchNorm, length_mask
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.ctc import ctc_loss_kernel
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import data_shard
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import _batch_loss

    shard = data_shard()
    data = {k: torch.tensor(v) for k, v in args["norm"].items()}
    rows = shard.rows(data["x"].shape[0])
    x = data["x"][rows].clone().requires_grad_(True)
    bn = MaskedBatchNorm(x.shape[-1]).train()
    with torch.no_grad():
        bn.weight.copy_(data["scale"])
        bn.bias.copy_(data["bias"])
    y = bn(x, length_mask(data["lengths"][rows], x.shape[1]))
    (y * data["probe"][rows]).sum().backward()

    loss_in = {k: torch.tensor(v) for k, v in args["loss"].items()}
    lrows = shard.rows(loss_in["log_probs"].shape[0])
    log_probs = loss_in["log_probs"][lrows].clone().requires_grad_(True)
    loss = _batch_loss(ctc_loss_kernel, log_probs, loss_in["targets"][lrows], loss_in["out_lengths"][lrows],
                       loss_in["target_lengths"][lrows], 0, global_rows=shard.world > 1)
    loss.backward()
    return ({"loss": float(loss.detach())},
            {"y": y.detach(), "dx": x.grad, "dscale": bn.weight.grad, "dbias": bn.bias.grad,
             "running_mean": bn.running_mean, "running_var": bn.running_var, "dlog_probs": log_probs.grad})


def scenario_trainer(args):
    """Two epochs of `Trainer.train` with validation, `evaluate` (with the
    texts), `generate_labels`, one `run_nst` generation, and a fused
    resident epoch with SpecAugment and waveform noise from the same start."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as TC
    from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
    from nn_conformer_for_speech_recognition_tpu_torch.nst.driver import run_nst
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import data_shard

    vocab, data = port_datasets(args["manifests"])
    trainer = port_trainer(vocab, args["state_dict"])
    history = {k: list(v) for k, v in trainer.train(data["train"], epochs=2, val_dataset=data["validation"]).items()}
    trained = params(trainer)
    loss, wer, refs, hyps = trainer.evaluate(data["validation"], return_texts=True)
    padded = trainer.evaluate(data["validation"], wer_protocol="padded")
    labels = trainer.generate_labels(data["unlabeled"])
    nst = run_nst(trainer, data["train"], data["unlabeled"], TC.NSTConfig(**NST), val_dataset=data["validation"],
                  work_dir=args["work_dir"])
    after_nst = params(trainer)
    with open(os.path.join(args["work_dir"], "mix_gen0.tsv")) as f:
        mix = f.read()

    first = port_trainer(vocab, args["state_dict"])  # one step from the start: its gradient
    batch = next(data["train"].epoch(seed=0))
    first._composed_step(False, 0.0)(first.state, *first._put(first._local(batch)), first._batch_lengths(batch))
    grads = {n: p.grad for n, p in first.model.named_parameters()}

    fused = port_trainer(vocab, args["state_dict"], use_specaugment=True, add_noise=True, train_wer=True)
    resident = DeviceResidentDataset(data["train"], device="cpu", sharding=data_shard())
    fused_history = fused.train_device_epochs(resident, 1)
    result = {"history": history, "eval": [loss, wer, refs, hyps], "padded": list(padded),
              "labels": {str(k): v for k, v in labels.items()}, "nst": [r.num_kept for r in nst], "mix": mix,
              "fused_history": fused_history, "step": trainer.state.step}
    tensors = {**{f"trained.{k}": v for k, v in trained.items()}, **{f"nst.{k}": v for k, v in after_nst.items()},
               **{f"fused.{k}": v for k, v in params(fused).items()}, **{f"grad.{k}": v for k, v in grads.items()}}
    return result, tensors


def scenario_data_parallel(args):
    """`scenario_norm_and_loss` and `scenario_trainer` in one launch."""
    small, small_t = scenario_norm_and_loss(args)
    result, tensors = scenario_trainer(args)
    return {**result, **small}, {**tensors, **small_t}


SCENARIOS = {"gathers": scenario_gathers, "data_parallel": scenario_data_parallel}


def worker(scenario: str, args_path: str, out_dir: str) -> None:
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import initialize_multihost

    torch.set_num_threads(1)
    initialize_multihost("cpu")
    import torch.distributed as dist

    with open(args_path) as f:
        args = json.load(f)
    rank = dist.get_rank()
    if "work_dir" in args:  # one work directory for the whole group, as a shared file system gives
        os.makedirs(args["work_dir"], exist_ok=True)
    result, tensors = SCENARIOS[scenario](args)
    write_result(out_dir, rank, result, tensors)
    dist.destroy_process_group()


if __name__ == "__main__":
    worker(*sys.argv[1:4])
