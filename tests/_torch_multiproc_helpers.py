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


# ---------------------------------------------------------------------------
# tensor parallelism, the sharded beam, the LM and pretraining trainers
# ---------------------------------------------------------------------------


def world_size() -> int:
    import torch.distributed as dist

    return dist.get_world_size() if dist.is_initialized() else 1


def tp_model_config(attention_impl="flash", dropout=0.0):
    """The tiny model of the tensor-parallel tests: 4 heads, so that two
    model ranks hold two heads each."""
    import dataclasses

    cfg = model_config(dropout)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, num_heads=4, attention_dropout=dropout),
                               attention_impl=attention_impl)


def tp_trainer(vocab, state_dict_path, attention_impl, mesh_cfg, dropout=0.0):
    from nn_conformer_for_speech_recognition_tpu_torch import config as TC
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import local_state_dict
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    tcfg = TC.TrainConfig(batch_size=BATCH, optimizer=TC.OptimizerConfig(learning_rate=LR), use_specaugment=False,
                          log_every=0)
    trainer = Trainer(ConformerCTC(tp_model_config(attention_impl, dropout), len(vocab)), vocab,
                      TC.FeatureConfig(n_fft=256, hop_length=256, n_mels=13), tcfg, mesh_cfg, device="cpu",
                      log_fn=lambda _: None)
    trainer.init_state(seed=0)
    whole = torch.load(state_dict_path, weights_only=True)
    trainer.model.load_state_dict(local_state_dict(trainer.model, whole), strict=True)
    return trainer


def whole_grads(model) -> dict:
    """Every parameter's gradient, split ones gathered over the model group."""
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import gather_shards, tensor_parallel_plan

    plan = tensor_parallel_plan(model)
    return {n: gather_shards(p.grad, plan.specs[n], plan.axis) if plan and n in plan.specs else p.grad.clone()
            for n, p in model.named_parameters()}


def whole_state(trainer) -> dict:
    """The model's and the optimizer's state as a checkpoint holds it."""
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import full_state_dict
    from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import whole_optimizer_slots

    out = {f"model.{k}": v for k, v in full_state_dict(trainer.model).items()}
    for name, slots in whole_optimizer_slots(trainer.state).items():
        out.update({f"opt.{name}.{k}": v for k, v in slots.items()})
    return out


# the Adafactor leaves under tensor parallelism: port name → (the port's shape, split axis there, runs); both
# dims of every split leaf ≥ 128, so that optax factors it
ADAFACTOR_LEAVES = {
    "col.weight": ((256, 256), 0, 1),  # JAX (256, 256) split on its columns
    "row.weight": ((256, 256), 1, 1),  # ... on its rows
    "ffn.fc1.weight": ((1024, 256), 0, 1),  # JAX (256, 1024), columns
    "ffn.fc2.weight": ((256, 1024), 1, 1),  # JAX (1024, 256), rows: Megatron's pairing
    "ffn.fc2t.weight": ((256, 1024), 0, 1),  # JAX (1024, 256), columns: the JAX rule's split
    "mhsa.qkv.weight": ((768, 256), 0, 3),  # heads-aligned columns
    "norm.weight": ((256,), None, 1),  # replicated
    "small.weight": ((64, 64), None, 1),  # replicated, not factored
}
ADAFACTOR_STEPS = 5


def adafactor_inputs(seed: int = 0):
    """The leaves' start values and each step's gradients, in the port's layout."""
    rng = np.random.default_rng(seed)
    init = {k: rng.standard_normal(shape).astype(np.float32) for k, (shape, _, _) in ADAFACTOR_LEAVES.items()}
    grads = [{k: (rng.standard_normal(shape) * (1 + 3 * rng.random())).astype(np.float32)
              for k, (shape, _, _) in ADAFACTOR_LEAVES.items()} for _ in range(ADAFACTOR_STEPS)]
    return init, grads


def run_adafactor(mesh=None):
    """`ADAFACTOR_STEPS` Adafactor steps (lr 1e-2, momentum 0.9, clipping 1)
    on the leaves, split over ``mesh.model`` where given; (whole
    parameters, whole slots)."""
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import (
        ShardSpec,
        TensorParallelPlan,
        gather_shards,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import Adafactor

    init, grads = adafactor_inputs()
    mp = 1 if mesh is None else mesh.model.size
    specs = {k: ShardSpec(axis, shape[axis], mp, runs) for k, (shape, axis, runs) in ADAFACTOR_LEAVES.items()
             if axis is not None and mp > 1}
    rank = 0 if mesh is None else mesh.model.rank
    cut = lambda k, x: specs[k].local(torch.from_numpy(x), rank) if k in specs else torch.from_numpy(x.copy())  # noqa: E731
    params = {k: torch.nn.Parameter(cut(k, v)) for k, v in init.items()}
    plan = TensorParallelPlan(mesh.model, specs) if specs else None
    opt = Adafactor(params.items(), 1e-2, momentum=0.9, clipping_threshold=1.0, plan=plan)
    for g in grads:
        for k, p in params.items():
            p.grad = cut(k, g[k])
        opt.step()
    whole = lambda x, spec: x if spec is None else gather_shards(x, spec, plan.axis)  # noqa: E731
    out = {f"param.{k}": whole(p.detach(), specs.get(k)) for k, p in params.items()}
    for k, slots in opt.state.items():
        out.update({f"slot.{k}.{s}": whole(v, opt.slot_specs[k][s]) for s, v in slots.items()})
    return out


def lm_corpus(args):
    from nn_conformer_for_speech_recognition_tpu_torch.data import lm_corpus as TLC
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import WordVocab

    lm = args["lm"]
    return TLC.LMCorpus(lm["sentences"], TLC.Lexicon(lm["lexicon"]), WordVocab(["<blank>", "<pad>", "<unk>"] + lm["words"]),
                        max_src_len=12, max_tgt_len=6)


def lm_trainer(args, mesh_cfg):
    from nn_conformer_for_speech_recognition_tpu_torch import config as TC
    from nn_conformer_for_speech_recognition_tpu_torch.train.lm_loop import LMTrainer

    corpus = lm_corpus(args)
    tr = LMTrainer(TC.LMConfig(**args["lm"]["config"]), len(corpus.phoneme_vocab), len(corpus.word_vocab),
                   corpus.word_vocab.pad_id, learning_rate=1e-3, mesh_cfg=mesh_cfg, device="cpu",
                   log_fn=lambda _: None)
    tr.init_state(seed=0)
    return tr, corpus


def run_lm(args, mesh_cfg, save=None):
    """Two `LMTrainer` steps on the first batch of 8 (dropout 0) from seeded
    weights, written to ``save`` where given; (losses, the evaluation, the
    whole parameters and AdamW slots)."""
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import full_state_dict
    from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import whole_optimizer_slots

    tr, corpus = lm_trainer(args, mesh_cfg)
    batch = next(corpus.batches(8, seed=0))
    losses = []
    for _ in range(2):
        tr.state, loss = tr._train_step(tr.state, *tr._put(*batch))
        losses.append(float(loss))
    if save:
        tr.save(save)
    slots = {f"opt.{n}.{k}": v for n, st in whole_optimizer_slots(tr.state).items() for k, v in st.items()}
    return losses, tr.evaluate(corpus, batch_size=8), {**full_state_dict(tr.model), **slots}


def run_pretrain(args):
    """Two `PretrainTrainer` steps (data-parallel under a process group) on
    the unlabelled split's first batch of 8; (losses, parameters)."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as TC
    from nn_conformer_for_speech_recognition_tpu_torch.data import datasets as TD
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import WordVocab
    from nn_conformer_for_speech_recognition_tpu_torch.train.pretrain_loop import PretrainTrainer

    enc = TC.ConformerConfig(num_blocks=1, d_model=16, num_heads=2, ffn_dim=32, conv_kernel_size=5, dropout=0.0)
    mcfg = TC.ModelConfig(encoder=enc, decoder=TC.DecoderConfig(projection_dim=8, lstm_hidden=8), n_mels=8,
                          subsampling=TC.SubsamplingConfig(channels=(4, 4)))
    pcfg = TC.PretrainConfig(target_dim=16, distractors_k=3, learning_rate=1e-3, mask_probability=0.3)
    data = TD.BucketedDataset(TD.load_manifest(args["manifests"]["unlabeled"]), WordVocab(["<blank>", "<pad>", "<unk>"]),
                              batch_size=8, bucket_boundaries=[14000], max_target_len=4)
    tr = PretrainTrainer(mcfg, pcfg, TC.FeatureConfig(n_fft=256, hop_length=256, n_mels=8), device="cpu",
                         log_fn=lambda _: None)
    tr.init_state(seed=0)
    batch = next(data.epoch(seed=0))
    rows = slice(None) if tr.shard is None else tr.shard.rows(len(batch.indices))
    audio, alen = torch.from_numpy(batch.audio[rows]), torch.from_numpy(batch.audio_lengths[rows].astype(np.int32))
    losses = []
    for _ in range(2):
        tr.state, metrics = tr._train_step(tr.state, audio, alen)
        losses.append(float(metrics["loss"]))
    return losses, {k: v.clone() for k, v in tr.model.state_dict().items()}


def scenario_tensor_parallel(args):
    """Under a layout whose model axis is the world (two model ranks; one
    process without a group): one train step of the 4-head model from
    converted weights on each attention route, its checkpoint written and
    the other layout's checkpoint restored; Adafactor on split leaves; the
    vocabulary-sharded beam search; two LM steps with the rule table's
    split.  Then, data-parallel (the model axis of size 1): two LM and two
    pretraining steps."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as TC
    from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
    from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import ctc_beam_search_sharded
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import make_mesh
    from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import restore_state

    world = world_size()
    mesh_cfg = TC.MeshConfig(model_parallel_size=world)
    vocab, data = port_datasets(args["manifests"])
    batch = next(data["train"].epoch(seed=0))
    result, tensors = {}, {}
    for impl in ("flash", "xla", "dropout"):  # 'dropout': the einsum route at dropout 0.1 everywhere
        tr = tp_trainer(vocab, args["tp_state_dict"], "xla" if impl == "dropout" else impl, mesh_cfg,
                        0.1 if impl == "dropout" else 0.0)
        before = whole_state(tr)
        tr.state, metrics = tr._composed_step(False, 0.0)(tr.state, *tr._put(tr._local(batch)), tr._batch_lengths(batch))
        result[impl] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"])}
        tensors.update({f"{impl}.grad.{k}": v for k, v in whole_grads(tr.model).items()})
        tensors.update({f"{impl}.after.{k}": v for k, v in whole_state(tr).items()})
        if impl == "flash":
            loss, wer, refs, hyps = tr.evaluate(data["validation"], return_texts=True)
            result["eval"] = [loss, wer, refs, hyps]
            result["labels"] = {str(k): v for k, v in tr.generate_labels(data["unlabeled"]).items()}
            tensors.update({f"before.{k}": v for k, v in before.items()})
            tr.save(os.path.join(args["ckpt_dir"], f"mp{world}"))
            other = os.path.join(args["ckpt_dir"], "mp1")
            if world > 1 and os.path.exists(other):  # the one-process checkpoint, cut to this rank's shares
                restored = tp_trainer(vocab, args["tp_state_dict"], impl, mesh_cfg)
                restore_state(other, restored.state)
                tensors.update({f"restored.{k}": v for k, v in whole_state(restored).items()})
    resident = tp_trainer(vocab, args["tp_state_dict"], "xla", mesh_cfg)  # a fused resident epoch, split
    history = resident.train_device_epochs(DeviceResidentDataset(data["train"], device="cpu", sharding=resident.shard), 1)
    result["resident"] = {k: list(v) for k, v in history.items()}
    tensors.update({f"resident.{k}": v for k, v in whole_state(resident).items() if k.startswith("model.")})
    mesh = make_mesh(mesh_cfg)
    tensors.update({f"adafactor.{k}": v for k, v in run_adafactor(mesh if world > 1 else None).items()})
    lp = torch.tensor(args["beam"]["lp"])
    part = lp.shape[2] // world
    toks, lens, scores = ctc_beam_search_sharded(
        lp[:, :, mesh.model.rank * part:(mesh.model.rank + 1) * part], torch.tensor(args["beam"]["lengths"]),
        axis=mesh.model, blank_id=0, beam=4, prune=4, max_label_len=12)
    tensors.update({"beam.tokens": toks, "beam.lengths": lens, "beam.scores": scores})
    for layout, cfg in (("tp", mesh_cfg), ("dp", TC.MeshConfig())):
        save = os.path.join(args["ckpt_dir"], f"lm_mp{world}") if layout == "tp" else None
        losses, evaluated, state = run_lm(args, cfg, save)
        result[f"lm_{layout}"] = {"losses": losses, "eval": evaluated}
        tensors.update({f"lm_{layout}.{k}": v for k, v in state.items()})
    losses, state = run_pretrain(args)
    result["pretrain"] = {"losses": losses}
    tensors.update({f"pretrain.{k}": v for k, v in state.items()})
    return result, tensors


def scenario_tensor_parallel_4(args):
    """Four processes: Adafactor over a model axis of 4, then the dry run's
    train step and pseudo-label pass on its 2 × 2 layout."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as TC
    from nn_conformer_for_speech_recognition_tpu_torch.dryrun import dryrun_multichip
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import make_mesh

    tensors = run_adafactor(make_mesh(TC.MeshConfig(model_parallel_size=world_size())))
    dry = dryrun_multichip("cpu", log=lambda _: None)
    labels = {str(k): v for k, v in dry["labels"].items()}
    return {"dryrun": {"mesh": dry["mesh"], "loss": dry["loss"], "labels": labels}}, tensors


def ulysses_inputs(seed: int = 0):
    """(B=2, T=32, H=4, dh=8) q, k, v, the (63, 4, 8) table, the biases and
    the lengths of the Ulysses function's test: JAX ``test_sharding.py``'s
    case, with four heads for two ranks."""
    rng = np.random.default_rng(seed)
    b, t, h, dh = 2, 32, 4, 8
    mk = lambda *shape: rng.standard_normal(shape).astype(np.float32)  # noqa: E731
    return dict(q=mk(b, t, h, dh), k=mk(b, t, h, dh), v=mk(b, t, h, dh), p=mk(2 * t - 1, h, dh),
                u=(0.1 * mk(h, dh)).astype(np.float32), vb=(0.1 * mk(h, dh)).astype(np.float32),
                lengths=np.asarray([32, 23], np.int32), scale=0.25)


def run_ulysses(mesh, use_kernel: bool):
    """This rank's time shard of `ulysses_relpos_attention` on
    `ulysses_inputs`, and the gradients of the sum of its squared valid
    rows with respect to its shares of q, k, v and the table."""
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.sequence import ulysses_relpos_attention

    x = ulysses_inputs()
    n, rank = mesh.data.size, mesh.data.rank
    t, h = x["q"].shape[1], x["q"].shape[2]
    times, heads = slice(rank * t // n, (rank + 1) * t // n), slice(rank * h // n, (rank + 1) * h // n)
    q, k, v = (torch.from_numpy(x[name][:, times].copy()).requires_grad_(True) for name in "qkv")
    p = torch.from_numpy(x["p"][:, heads].copy()).requires_grad_(True)
    out = ulysses_relpos_attention(q, k, v, p, torch.from_numpy(x["u"][heads]), torch.from_numpy(x["vb"][heads]),
                                   torch.from_numpy(x["lengths"]), x["scale"], mesh, "data", use_kernel=use_kernel)
    valid = torch.arange(t)[times][None, :] < torch.from_numpy(x["lengths"])[:, None]
    (torch.where(valid[..., None, None], out, 0.0) ** 2).sum().backward()
    return {"out": out.detach(), "dq": q.grad, "dk": k.grad, "dv": v.grad, "dp": p.grad}


def scenario_sequence_parallel(args):
    """Sequence parallelism over the data axis (two data ranks; one process
    without a group, where it falls back): the Ulysses function on both
    routes; one step of ``seq_parallel=True`` training from converted
    weights on each attention route, with a spy on the model's Ulysses
    route, then `evaluate` and `generate_labels`; a forward at an odd T'
    (the fallback and its reason)."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as TC
    from nn_conformer_for_speech_recognition_tpu_torch.models import conformer as CM
    from nn_conformer_for_speech_recognition_tpu_torch.parallel import sequence as S
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import make_mesh

    world = world_size()
    result, tensors = {}, {}
    if world > 1:
        mesh = make_mesh(TC.MeshConfig())
        for use_kernel in (False, True):
            tensors.update({f"ulysses.{use_kernel}.{k}": v for k, v in run_ulysses(mesh, use_kernel).items()})
    vocab, data = port_datasets(args["manifests"])
    batch = next(data["train"].epoch(seed=0))
    calls = {"n": 0}
    route = CM.ulysses_relpos_attention_rows

    def spy(*a, **kw):
        calls["n"] += 1
        return route(*a, **kw)

    CM.ulysses_relpos_attention_rows = spy
    try:
        for impl in ("flash", "xla"):
            S.reset_fallback_stats()
            tr = tp_trainer(vocab, args["tp_state_dict"], impl, TC.MeshConfig(seq_parallel=True))
            calls["n"] = 0
            tr.state, metrics = tr._composed_step(False, 0.0)(tr.state, *tr._put(tr._local(batch)),
                                                             tr._batch_lengths(batch))
            result[impl] = {"loss": float(metrics["loss"]), "grad_norm": float(metrics["grad_norm"]),
                            "calls": calls["n"], "stats": S.fallback_stats("seq_parallel")}
            tensors.update({f"{impl}.{k}": v.clone() for k, v in tr.model.state_dict().items()})
            if impl == "flash":
                loss, wer, refs, hyps = tr.evaluate(data["validation"], return_texts=True)
                result["eval"] = [loss, wer, refs, hyps]
                result["labels"] = {str(k): v for k, v in tr.generate_labels(data["unlabeled"]).items()}
        # an odd T' (5 frames after subsampling): every attention layer falls back, with its reason
        S.reset_fallback_stats()
        calls["n"] = 0
        audio = torch.from_numpy(np.random.default_rng(1).standard_normal((BATCH, 5000)).astype(np.float32))
        rows = slice(None) if tr.shard is None else tr.shard.rows(BATCH)
        tr._predict_step(audio[rows], torch.full((BATCH,), 5000, dtype=torch.int32)[rows])
        result["odd"] = {"stats": S.fallback_stats("seq_parallel"), "calls": calls["n"]}
    finally:
        CM.ulysses_relpos_attention_rows = route
        S.set_sequence_mesh(None)
    return result, tensors


SCENARIOS = {"gathers": scenario_gathers, "data_parallel": scenario_data_parallel,
             "tensor_parallel": scenario_tensor_parallel, "tensor_parallel_4": scenario_tensor_parallel_4,
             "sequence_parallel": scenario_sequence_parallel}


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
