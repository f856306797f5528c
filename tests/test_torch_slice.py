"""The whole pseudo-label pass, JAX vs port, plus the copied pieces.

The JAX side is built as the product's kernel path runs it off-TPU
(``use_pallas=True``, flash attention and the Pallas LSTM in interpret
mode), float32, eval mode, with non-trivial running statistics; the port
loads the converted weights and runs its plain twins on the CPU.
Log-prob tolerance atol 1e-4 on valid frames (float32 both sides).
"""

import dataclasses
import os
import subprocess
import sys
import types
from pathlib import Path

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.data.vocab import WordVocab as JaxWordVocab
from nn_conformer_for_speech_recognition_tpu.data.vocab import build_vocab as jax_build_vocab
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu.ops import decode as JD
from nn_conformer_for_speech_recognition_tpu.ops.features import log_mel_spectrogram
from nn_conformer_for_speech_recognition_tpu.train.loop import make_predict_step as jax_predict_step
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC as TorchCTC
from nn_conformer_for_speech_recognition_tpu_torch.ops import decode as TD
from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_predict_step

REPO = Path(__file__).resolve().parents[1]


def test_config_copies_equal():
    for name in ("FeatureConfig", "SpecAugmentConfig", "SubsamplingConfig", "ConformerConfig", "DecoderConfig",
                 "ModelConfig", "OptimizerConfig", "MeshConfig", "TrainConfig", "NSTConfig"):
        assert repr(getattr(TC, name)()) == repr(getattr(C, name)()), name
    for preset in ("conformer_s", "conformer_m", "conformer_l", "reference_parity"):
        assert repr(getattr(TC, preset)()) == repr(getattr(C, preset)()), preset
    assert list(TC.MODEL_PRESETS) == list(C.MODEL_PRESETS)
    assert all(repr(TC.MODEL_PRESETS[k](n_mels=13)) == repr(C.MODEL_PRESETS[k](n_mels=13)) for k in C.MODEL_PRESETS)
    assert TC.SubsamplingConfig().subsampled_length(938) == C.SubsamplingConfig().subsampled_length(938) == 235
    assert TC.FeatureConfig().num_frames(480000) == C.FeatureConfig().num_frames(480000) == 938


@pytest.mark.parametrize("use_pallas", [True, False])
@pytest.mark.parametrize("conv_impl", ["auto", "pallas", "xla"])
def test_conv_route_follows_the_jax_rule(use_pallas, conv_impl):
    """The kernel route only for ``use_pallas=True, conv_impl='pallas'``, as
    ``ModelConfig.resolved_conv_impl`` of the JAX package; the model owns
    the route's parameter and not the other's."""
    ref = C.conformer_m(use_pallas=use_pallas, conv_impl=conv_impl).resolved_conv_impl()
    cfg = TC.conformer_s(use_pallas=use_pallas, conv_impl=conv_impl)
    assert TC.conv_route(cfg) == {"pallas": "kernel", "xla": "library"}[ref]
    names = [n for n, _ in TorchCTC(dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, num_blocks=1)),
                                    8).named_parameters() if ".conv." in n]
    assert ("encoder.blocks.0.conv.dw_kernel" in names) == (ref == "pallas")
    assert ("encoder.blocks.0.conv.depthwise.weight" in names) == (ref == "xla")


def test_conv_route_rejects_unknown_values():
    with pytest.raises(ValueError, match="conv_impl"):
        TC.conv_route(TC.conformer_m(use_pallas=True, conv_impl="cudnn"))


def test_resolution_by_device():
    cfg = TC.conformer_m(use_pallas=True)
    assert TC.resolve_compute_dtype(cfg, torch.device("cpu")) == torch.float32
    assert TC.resolve_compute_dtype(cfg, torch.device("cuda")) == torch.bfloat16
    assert TC.resolve_compute_dtype(dataclasses.replace(cfg, compute_dtype="float32"), "cuda") == torch.float32
    assert TC.uses_attention_kernel(cfg) and TC.uses_lstm_kernel(cfg)
    assert not TC.uses_attention_kernel(dataclasses.replace(cfg, attention_impl="xla"))
    assert not TC.uses_lstm_kernel(TC.conformer_m())
    with pytest.raises(ValueError):
        TC.resolve_compute_dtype(dataclasses.replace(cfg, compute_dtype="fp16"), "cpu")


def test_word_vocab_copy_equal(rng):
    lines = ["the cat sat", "the dog ran far", "a cat ran", "the end"]
    for ntokens in (None, 4):
        ours, ref = build_vocab("word", lines, ntokens), jax_build_vocab("word", lines, ntokens)
        assert ours.tokens == ref.tokens
        assert ours.parse("the cat flew") == ref.parse("the cat flew")
        ids = rng.integers(-1, len(ref) + 2, size=(3, 12))
        assert ours.decode(ids) == ref.decode(ids)
    assert (type(ours).blank_id, type(ours).pad_id, type(ours).unk_id) == (
        JaxWordVocab.blank_id, JaxWordVocab.pad_id, JaxWordVocab.unk_id)


def test_decode_matches_jax(rng):
    lp = rng.standard_normal((3, 11, 6)).astype(np.float32)
    lens = np.asarray([11, 4, 0], np.int32)
    ids = TD.greedy_decode(torch.from_numpy(lp), torch.from_numpy(lens), pad_id=1)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(JD.greedy_decode(jnp.asarray(lp), jnp.asarray(lens), 1)))
    raw = rng.integers(0, 4, size=(4, 9)).astype(np.int32)
    packed, n = TD.collapse_repeats(torch.from_numpy(raw), blank_id=0, pad_id=1)
    ref_packed, ref_n = JD.collapse_repeats(jnp.asarray(raw), 0, 1)
    np.testing.assert_array_equal(packed.numpy(), np.asarray(ref_packed))
    np.testing.assert_array_equal(n.numpy(), np.asarray(ref_n))


def _tiny(lib, **kw):
    enc = lib.ConformerConfig(num_blocks=2, d_model=16, num_heads=2, ffn_dim=32, conv_kernel_size=5, dropout=0.0)
    dec = lib.DecoderConfig(projection_dim=8, lstm_hidden=8)
    return lib.ModelConfig(encoder=enc, decoder=dec, use_pallas=True, attention_impl="flash", compute_dtype="float32",
                           **kw)


def _tiny_pallas_conv(lib):
    return _tiny(lib, conv_impl="pallas")


def _m_two_blocks(lib):
    cfg = lib.conformer_m(use_pallas=True, attention_impl="flash", compute_dtype="float32")
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, num_blocks=2))


@pytest.mark.parametrize(
    "make_cfg, vocab_size, seconds, lengths",
    [(_tiny, 12, 0.5, [8000, 5000, 1200]), (_m_two_blocks, 1024, 2.0, [32000, 21000]),
     (_tiny_pallas_conv, 12, 0.5, [8000, 5000, 1200])],
    ids=["tiny", "conformer_m_widths_2_blocks", "tiny_conv_impl_pallas"],
)
def test_predict_step_matches_jax(rng, make_cfg, vocab_size, seconds, lengths):
    jcfg, tcfg = make_cfg(C), make_cfg(TC)
    feat_cfg = C.FeatureConfig()
    samples = int(seconds * feat_cfg.sample_rate)
    audio = rng.standard_normal((len(lengths), samples)).astype(np.float32) * 0.1
    alen = np.asarray(lengths, np.int32)
    audio *= np.arange(samples)[None, :] < alen[:, None]
    vocab = JaxWordVocab(["<blank>", "<pad>", "<unk>"] + [f"w{i}" for i in range(vocab_size - 3)])

    model = ConformerCTC(jcfg, vocab_size=vocab_size)
    feats, flens = log_mel_spectrogram(jnp.asarray(audio), feat_cfg, jnp.asarray(alen))
    vs = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, feats, flens)
    vs = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), vs)
    vs["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, vs["batch_stats"])
    ref_lp, ref_len = jax.jit(lambda f, l: model.apply(vs, f, l, deterministic=True))(feats, flens)
    state = types.SimpleNamespace(params=vs["params"], batch_stats=vs["batch_stats"])
    jax_step = jax_predict_step(model, feat_cfg, vocab.pad_id)
    ref_ids, ref_out_len = jax.jit(lambda a, l: jax_step(state, a, l))(jnp.asarray(audio), jnp.asarray(alen))

    tm = TorchCTC(tcfg, vocab_size)
    tm.load_state_dict(flax_to_state_dict(vs, tcfg), strict=True)
    predict = make_predict_step(tm, TC.FeatureConfig(), vocab.pad_id)
    ids, out_len = predict(torch.from_numpy(audio), torch.from_numpy(alen))
    with torch.inference_mode():
        lp, _ = tm(*make_featurizer(TC.FeatureConfig())(torch.from_numpy(audio), torch.from_numpy(alen)))

    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_out_len))
    np.testing.assert_array_equal(out_len.numpy(), np.asarray(ref_len))
    ref_lp = np.asarray(ref_lp)
    for row, n in enumerate(out_len.tolist()):
        np.testing.assert_allclose(lp[row, :n].numpy(), ref_lp[row, :n], atol=1e-4)
    np.testing.assert_array_equal(ids.numpy(), np.asarray(ref_ids))
    assert vocab.decode(ids.numpy()) == vocab.decode(np.asarray(ref_ids))


def test_port_never_imports_jax():
    """With jax, flax and optax unimportable, every module of the port
    imports (``train.loop``, ``train.checkpoint``, ``nst.driver`` and
    ``data.*`` among them), and on the CPU a predict step, one train step, a
    two-step `Trainer.train` with a checkpoint, one `run_nst` generation, a
    beam-search `evaluate`, a fused epoch over a device-resident dataset
    (the native decoder loaded), the bias-input attention op and the
    command line (``train`` then ``eval --decode beam``) run."""
    code = """
import importlib, pkgutil, sys
sys.modules["jax"] = None
sys.modules["flax"] = None
sys.modules["optax"] = None
import torch
import nn_conformer_for_speech_recognition_tpu_torch as port
for info in pkgutil.walk_packages(port.__path__, port.__name__ + "."):
    importlib.import_module(info.name)
from nn_conformer_for_speech_recognition_tpu_torch import config as C
from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_predict_step, make_train_step
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState
enc = C.ConformerConfig(num_blocks=1, d_model=16, num_heads=2, ffn_dim=32, conv_kernel_size=5)
cfg = C.ModelConfig(encoder=enc, decoder=C.DecoderConfig(projection_dim=8, lstm_hidden=8), use_pallas=True)
vocab = build_vocab("word", ["a b c"])
model = init_params(ConformerCTC(cfg, len(vocab)), torch.Generator().manual_seed(0))
audio, alen = torch.randn(2, 4000), torch.tensor([4000, 2000])
ids, lens = make_predict_step(model, C.FeatureConfig(), vocab.pad_id)(audio, alen)
assert ids.shape == (2, 2) and lens.tolist() == [2, 1], (ids.shape, lens)
print([vocab.decode_ids(r) for r in ids.tolist()])
state = TrainState.create(model, make_optimizer(C.OptimizerConfig(), model.named_parameters()), seed=0)
step = make_train_step(model, C.FeatureConfig(), C.SpecAugmentConfig(), vocab.blank_id)
state, metrics = step(state, audio, alen, torch.tensor([[3, 4], [5, 0]]), torch.tensor([2, 1]))
assert state.step == 1 and torch.isfinite(metrics["loss"]) and torch.isfinite(metrics["grad_norm"]), metrics
import tempfile
from nn_conformer_for_speech_recognition_tpu_torch.data.audio import make_synthetic_corpus
from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, load_manifest
from nn_conformer_for_speech_recognition_tpu_torch.nst.driver import run_nst
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import CheckpointManager
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer
with tempfile.TemporaryDirectory() as root:
    man = make_synthetic_corpus(root, ["yes", "no"], 4, 2, 0, 2)
    vocab = build_vocab("word", ["yes no"])
    data = {k: BucketedDataset(load_manifest(v), vocab, batch_size=2, max_target_len=2) for k, v in man.items()}
    cfg = C.ModelConfig(encoder=enc, decoder=C.DecoderConfig(projection_dim=8, lstm_hidden=8), use_pallas=True,
                        conv_impl="pallas")
    trainer = Trainer(ConformerCTC(cfg, len(vocab)), vocab, C.FeatureConfig(), C.TrainConfig(batch_size=2),
                      device="cpu", log_fn=lambda _: None)
    trainer.init_state(seed=0)
    trainer.train(data["train"], epochs=1, checkpoint_manager=CheckpointManager(root + "/ck"))
    assert trainer.state.step == 2 and len(trainer.history["train_loss"]) == 1
    nst = C.NSTConfig(generations=1, initial_supervised_finetune=False)
    results = run_nst(trainer, data["train"], data["unlabeled"], nst, val_dataset=data["validation"], work_dir=root + "/nst")
    assert len(results) == 1 and results[0].num_pseudo_labels == 2
    loss, wer = trainer.evaluate(data["validation"], decode="beam")
    assert loss == trainer.evaluate(data["validation"])[0] and wer >= 0.0
    from nn_conformer_for_speech_recognition_tpu_torch.data.device_cache import DeviceResidentDataset
    from nn_conformer_for_speech_recognition_tpu_torch.data.native_loader import native_available
    step = trainer.state.step
    trainer.train_device_epochs(DeviceResidentDataset(data["train"], device="cpu"), epochs=1)
    assert trainer.state.step == step + 2 and native_available()
    from nn_conformer_for_speech_recognition_tpu_torch.cli.main import main
    flags = ["--manifest-dir", root, "--batch-size", "2", "--max-target-len", "2", "--use-pallas", "--device", "cpu"]
    assert main(["train", *flags, "--epochs", "1", "--save", root + "/saved"]) == 0
    assert main(["eval", *flags, "--split", "validation", "--checkpoint", root + "/saved", "--decode", "beam"]) == 0
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.attention import flash_attention
q = torch.randn(1, 5, 2, 16, requires_grad=True)
flash_attention(q, q.detach(), q.detach(), torch.zeros(1, 2, 5, 5), torch.tensor([4]), 0.25).sum().backward()
assert torch.isfinite(q.grad).all()
"""
    env = {**os.environ, "PYTHONPATH": os.pathsep.join(filter(None, [str(REPO), os.environ.get("PYTHONPATH")]))}
    proc = subprocess.run([sys.executable, "-c", code], capture_output=True, text=True, env=env, timeout=240)
    assert proc.returncode == 0, proc.stderr
