"""The encoder variants of ``ConformerConfig``, port against the JAX package:
``use_relative_attention=False`` (plain softmax attention, no u/v biases
or ``pos_proj``), and ``conv_norm`` 'groupnorm' and 'layernorm' (in place of
the masked BatchNorm; the library depthwise conv then has a bias, the
kernel route's ``dw_kernel`` none), each norm under both conv routes.

Both sides load the same weights (the JAX model's initial tree, moved off
its symmetric start, converted), ``use_pallas=True`` (the JAX side's Pallas
BiLSTM and depthwise conv in interpret mode, the port's plain twins),
float32, dropout 0, from the JAX package's log-mel features.  Tolerances:
log-probs rtol/atol 1e-4 on valid frames (padded frames differ by design:
flax's RNN runs past a row's length), output lengths equal; the CTC loss
of one train step rtol 1e-5 and each gradient atol 1e-4 of its tensor's
largest entry, as ``tests/test_torch_train.py`` holds the train step.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu.ops.features import log_mel_spectrogram
from nn_conformer_for_speech_recognition_tpu.ops.pallas.ctc import ctc_loss_pallas
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC as TorchCTC
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import init_params
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as TA
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.ctc import ctc_loss_kernel
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import restore_state, save_state
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import _batch_loss
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState

VOCAB = 12
# (encoder field, conv_impl): the attention variant once, each norm under the library and the kernel conv route
VARIANTS = {
    "no_relative": (dict(use_relative_attention=False), "auto"),
    "groupnorm_auto": (dict(conv_norm="groupnorm"), "auto"),
    "groupnorm_pallas": (dict(conv_norm="groupnorm"), "pallas"),
    "layernorm_auto": (dict(conv_norm="layernorm"), "auto"),
    "layernorm_pallas": (dict(conv_norm="layernorm"), "pallas"),
}


def _config(lib, variant):
    encoder, conv_impl = VARIANTS[variant]
    enc = lib.ConformerConfig(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64, conv_kernel_size=5, dropout=0.0,
                              **encoder)
    dec = lib.DecoderConfig(projection_dim=8, lstm_hidden=8, dropout=0.0)
    return lib.ModelConfig(encoder=enc, decoder=dec, use_pallas=True, conv_impl=conv_impl, attention_impl="flash",
                           compute_dtype="float32")


def _batch():
    rng = np.random.default_rng(7)
    lengths = np.asarray([8000, 5600, 3000], np.int32)
    audio = rng.standard_normal((3, 8000)).astype(np.float32) * 0.1
    audio *= np.arange(8000)[None, :] < lengths[:, None]
    targets = rng.integers(3, VOCAB, size=(3, 4)).astype(np.int32)
    tlen = np.asarray([4, 2, 0], np.int32)  # the last row has no target
    return audio, lengths, targets, tlen


class JaxRun:
    """One JAX run of a variant: weights, features, eval-mode log-probs,
    and one train step's train-mode log-probs, loss and gradients."""

    def __init__(self, variant):
        rng = np.random.default_rng(0)
        audio, lengths, targets, tlen = _batch()
        self.model = ConformerCTC(_config(C, variant), vocab_size=VOCAB)
        feats, flens = log_mel_spectrogram(jnp.asarray(audio), C.FeatureConfig(), jnp.asarray(lengths))
        vs = self.model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, feats, flens)
        vs = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), vs)
        vs["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, vs["batch_stats"])
        self.variables, self.feats, self.flens = vs, np.array(feats), np.array(flens)
        self.targets, self.tlen = targets, tlen
        lp, ol = jax.jit(lambda f, fl: self.model.apply(vs, f, fl, deterministic=True))(feats, flens)
        self.eval_out = np.asarray(lp), np.asarray(ol)

        def loss_fn(params):
            (lp, ol), _ = self.model.apply({"params": params, "batch_stats": vs["batch_stats"]}, feats, flens,
                                           deterministic=False, rngs={"dropout": jax.random.key(2)},
                                           mutable=["batch_stats"])
            t, tl = jnp.asarray(targets), jnp.asarray(tlen)
            per_seq = ctc_loss_pallas(lp, t, ol, tl, blank_id=0, reduction=None, interpret=True)
            w = (tl > 0).astype(jnp.float32)
            return jnp.sum(per_seq / jnp.maximum(tl, 1) * w) / jnp.maximum(jnp.sum(w), 1.0), (lp, ol)

        (loss, (lp, ol)), grads = jax.jit(jax.value_and_grad(loss_fn, has_aux=True))(vs["params"])
        self.train_out, self.loss = (np.asarray(lp), np.asarray(ol)), float(loss)
        self.grads = flax_to_state_dict({"params": grads}, _config(TC, variant))

    def port(self, variant):
        tm = TorchCTC(_config(TC, variant), VOCAB)
        tm.load_state_dict(flax_to_state_dict(self.variables, _config(TC, variant)), strict=True)
        return tm


@pytest.fixture(scope="module")
def jax_runs():
    runs = {}

    def get(variant):
        if variant not in runs:
            runs[variant] = JaxRun(variant)
        return runs[variant]

    return get


def _assert_log_probs(got, ref):
    (lp, ol), (ref_lp, ref_ol) = got, ref
    np.testing.assert_array_equal(ol.numpy(), ref_ol)
    valid = np.arange(ref_lp.shape[1])[None, :] < ref_ol[:, None]
    np.testing.assert_allclose(lp.detach().numpy()[valid], ref_lp[valid], rtol=1e-4, atol=1e-4)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_eval_log_probs_match_jax(jax_runs, variant):
    run = jax_runs(variant)
    tm = run.port(variant).eval()
    with torch.no_grad():
        _assert_log_probs(tm(torch.from_numpy(run.feats), torch.from_numpy(run.flens)), run.eval_out)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_train_step_matches_jax(jax_runs, variant):
    """Train mode (dropout 0): log-probs, the CTC loss and every gradient."""
    run = jax_runs(variant)
    tm = run.port(variant).train()
    lp, ol = tm(torch.from_numpy(run.feats), torch.from_numpy(run.flens))
    _assert_log_probs((lp, ol), run.train_out)
    loss = _batch_loss(ctc_loss_kernel, lp, torch.from_numpy(run.targets), ol, torch.from_numpy(run.tlen), 0)
    loss.backward()
    np.testing.assert_allclose(loss.item(), run.loss, rtol=1e-5)
    params = dict(tm.named_parameters())
    assert params.keys() == run.grads.keys()
    for name, p in params.items():
        g_ref = run.grads[name].numpy()
        scale = np.abs(g_ref).max()
        assert scale > 0 and p.grad is not None, name
        np.testing.assert_allclose(p.grad.numpy(), g_ref, atol=1e-4 * scale, err_msg=name)


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_converter_maps_every_leaf_once(jax_runs, variant):
    """Every flax leaf of the variant maps onto one port name and every port
    parameter and buffer is filled; the variant's own leaves are where they
    belong."""
    run = jax_runs(variant)
    cfg = _config(TC, variant)
    sd = flax_to_state_dict(run.variables, cfg)
    assert len(sd) == len(jax.tree.leaves(run.variables))
    model = TorchCTC(cfg, VOCAB)
    model.load_state_dict(sd, strict=True)
    assert set(sd) == set(model.state_dict())
    conv = run.variables["params"]["encoder"]["block_1"]["conv"]
    encoder, conv_impl = VARIANTS[variant]
    if encoder.get("use_relative_attention", True):
        assert "encoder.blocks.1.mhsa.u_bias" in sd
    else:
        assert not any(k in name for name in sd for k in ("u_bias", "v_bias", "pos_proj"))
    norm = encoder.get("conv_norm", "batchnorm")
    if norm != "batchnorm":
        flax_norm = {"groupnorm": "GroupNorm_0", "layernorm": "LayerNorm_1"}[norm]
        port_norm = {"groupnorm": "group_norm", "layernorm": "layer_norm"}[norm]
        np.testing.assert_array_equal(sd[f"encoder.blocks.1.conv.{port_norm}.weight"].numpy(), conv[flax_norm]["scale"])
        np.testing.assert_array_equal(sd[f"encoder.blocks.1.conv.{port_norm}.bias"].numpy(), conv[flax_norm]["bias"])
        assert not any("batch_norm" in name and ".conv." in name for name in sd)
    # the library conv has a bias iff the norm is not BatchNorm; the kernel route's never
    has_bias = "encoder.blocks.1.conv.depthwise.bias" in sd
    assert has_bias == (conv_impl == "auto" and norm != "batchnorm")
    if has_bias:
        np.testing.assert_array_equal(sd["encoder.blocks.1.conv.depthwise.bias"].numpy(), conv["depthwise"]["bias"])


@pytest.mark.parametrize("variant", list(VARIANTS))
def test_checkpoint_round_trip(tmp_path, variant):
    """A seeded model of the variant, saved and restored with strict
    loading into a fresh one, is bit-equal."""
    cfg = _config(TC, variant)
    model = init_params(TorchCTC(cfg, VOCAB), torch.Generator().manual_seed(0))
    state = TrainState.create(model, make_optimizer(TC.OptimizerConfig(), model.named_parameters()), seed=0)
    save_state(str(tmp_path / "state.pt"), state)
    fresh = TorchCTC(cfg, VOCAB)
    template = TrainState.create(fresh, make_optimizer(TC.OptimizerConfig(), fresh.named_parameters()), seed=1)
    restored = restore_state(str(tmp_path / "state.pt"), template)
    got, want = restored.model.state_dict(), model.state_dict()
    assert got.keys() == want.keys() and all(torch.equal(got[k], want[k]) for k in want)


def test_no_relative_attention_never_takes_the_kernels(jax_runs, monkeypatch):
    """Without relative positions `attention_route` says 'einsum' in both
    modes at every length, and a forward in either mode calls no rel-pos
    kernel wrapper, though ``use_pallas`` and ``attention_impl='flash'``
    would send the relative encoder there."""
    cfg = _config(TC, "no_relative")
    for t in (14, 235, 768, 938):
        assert TC.attention_route(cfg, True, t) == TC.attention_route(cfg, False, t) == "einsum"
    relative = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, use_relative_attention=True))
    assert TC.attention_route(relative, True, 14) == "kernel"

    def refuse(*args, **kwargs):
        raise AssertionError("a rel-pos kernel wrapper was called")

    from nn_conformer_for_speech_recognition_tpu_torch.models import conformer as TCM

    monkeypatch.setattr(TCM, "flash_relpos_attention", refuse)
    monkeypatch.setattr(TA, "flash_relpos_attention", refuse)
    run = jax_runs("no_relative")
    tm = run.port("no_relative")
    for training in (False, True):
        tm.train(training)
        tm(torch.from_numpy(run.feats), torch.from_numpy(run.flens))
