"""flax → torch weight conversion: every leaf maps exactly once, every
port parameter and buffer is filled, and the default-checkpoint LSTM layout
(flax OptimizedLSTMCell) packs into the port's layout with equal outputs.

Log-prob tolerance atol 1e-4 on valid frames (float32 both sides; padded
frames differ by design: flax's RNN runs past a row's length).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu_torch import config as TCfg
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC as TorchCTC

ENC = dict(num_blocks=2, d_model=16, num_heads=2, ffn_dim=32, conv_kernel_size=5, dropout=0.0)
DEC = dict(projection_dim=8, lstm_hidden=8)
VOCAB = 7


def _configs(use_pallas, **extra):
    kw = dict(n_mels=8, use_pallas=use_pallas, attention_impl="flash", compute_dtype="float32", **extra)
    jcfg = C.ModelConfig(encoder=C.ConformerConfig(**ENC), decoder=C.DecoderConfig(**DEC), **kw)
    # the port's BiLSTM always has the packed layout
    tcfg = TCfg.ModelConfig(
        encoder=TCfg.ConformerConfig(**ENC), decoder=TCfg.DecoderConfig(**DEC),
        **{**kw, "use_pallas": True},
    )
    return jcfg, tcfg


def _variables(model, rng, feats, lens):
    vs = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, feats, lens)
    # non-zero biases, u/v and running statistics
    vs = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), vs)
    vs["batch_stats"] = jax.tree.map(np.abs, vs["batch_stats"])
    return vs


@pytest.mark.parametrize("use_pallas", [True, False])
def test_every_leaf_maps_once(rng, use_pallas):
    jcfg, tcfg = _configs(use_pallas)
    vs = _variables(ConformerCTC(jcfg, VOCAB), rng, jnp.zeros((1, 8, 8)), jnp.array([8]))
    sd = flax_to_state_dict(vs, tcfg)
    n_leaves = len(jax.tree.leaves(vs))
    # the OptimizedLSTMCell tree packs 12 leaves per direction into 3 tensors
    assert len(sd) == (n_leaves if use_pallas else n_leaves - 2 * (12 - 3))
    model = TorchCTC(tcfg, VOCAB)
    model.load_state_dict(sd, strict=True)  # every parameter and buffer filled
    assert set(sd) == set(model.state_dict())
    p = vs["params"]
    blk = p["encoder"]["block_1"]
    np.testing.assert_array_equal(sd["encoder.blocks.1.mhsa.qkv.weight"].numpy(), blk["mhsa"]["qkv"]["kernel"].T)
    np.testing.assert_array_equal(
        sd["encoder.blocks.1.conv.depthwise.weight"].numpy()[:, 0, :],
        blk["conv"]["depthwise"]["kernel"][:, 0, :].T,
    )
    np.testing.assert_array_equal(
        sd["subsampling.convs.1.weight"].numpy(), p["subsampling"]["Conv_1"]["kernel"].transpose(3, 2, 0, 1)
    )
    np.testing.assert_array_equal(
        sd["projection_norm.running_var"].numpy(), vs["batch_stats"]["projection_norm"]["var"]
    )


def test_unknown_leaf_raises(rng):
    jcfg, tcfg = _configs(True)
    vs = _variables(ConformerCTC(jcfg, VOCAB), rng, jnp.zeros((1, 8, 8)), jnp.array([8]))
    vs["params"]["encoder"]["block_0"]["extra"] = {"kernel": np.zeros((2, 2), np.float32)}
    sd = flax_to_state_dict(vs, tcfg)
    with pytest.raises(RuntimeError, match="extra"):
        TorchCTC(tcfg, VOCAB).load_state_dict(sd, strict=True)
    del vs["params"]["encoder"]["block_0"]["extra"]
    vs["params"]["decoder_lstm"]["OptimizedLSTMCell_0"] = {"ii": {"kernel": np.zeros((8, 8), np.float32)}}
    with pytest.raises(ValueError):
        flax_to_state_dict(vs, tcfg)


def test_optimized_lstm_checkpoint_matches_jax(rng):
    """A default (use_pallas=False) checkpoint, converted, gives the JAX
    model's log-probs on valid frames."""
    jcfg, tcfg = _configs(False)
    feats = rng.standard_normal((3, 24, 8)).astype(np.float32)
    lens = np.asarray([24, 17, 9], np.int32)
    model = ConformerCTC(jcfg, VOCAB)
    vs = _variables(model, rng, jnp.asarray(feats), jnp.asarray(lens))
    ref, ref_len = model.apply(vs, jnp.asarray(feats), jnp.asarray(lens), deterministic=True)
    tm = TorchCTC(tcfg, VOCAB)
    tm.load_state_dict(flax_to_state_dict(vs, tcfg), strict=True)
    tm.eval()
    with torch.no_grad():
        got, got_len = tm(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    ref = np.asarray(ref)
    for row, n in enumerate(np.asarray(ref_len)):
        np.testing.assert_allclose(got[row, :n].numpy(), ref[row, :n], atol=1e-4)


def test_dw_kernel_checkpoint_maps_once_loads_strict_and_matches_jax(rng):
    """A ``use_pallas=True, conv_impl='pallas'`` checkpoint: its ``dw_kernel``
    (K, C) leaves keep their name and layout, every leaf maps once, the
    port's model for that configuration owns ``dw_kernel`` and no
    ``depthwise``, loads with ``strict=True`` and gives the JAX model's
    log-probs (atol 1e-4) and greedy ids."""
    jcfg, tcfg = _configs(True, conv_impl="pallas")
    feats = rng.standard_normal((3, 24, 8)).astype(np.float32)
    lens = np.asarray([24, 17, 9], np.int32)
    model = ConformerCTC(jcfg, VOCAB)
    vs = _variables(model, rng, jnp.asarray(feats), jnp.asarray(lens))
    sd = flax_to_state_dict(vs, tcfg)
    assert len(sd) == len(jax.tree.leaves(vs))
    tm = TorchCTC(tcfg, VOCAB)
    tm.load_state_dict(sd, strict=True)
    assert set(sd) == set(tm.state_dict())
    assert not any("depthwise" in k for k in sd)
    taps = vs["params"]["encoder"]["block_1"]["conv"]["dw_kernel"]
    assert taps.shape == (ENC["conv_kernel_size"], 2 * ENC["d_model"])
    np.testing.assert_array_equal(sd["encoder.blocks.1.conv.dw_kernel"].numpy(), taps)
    # the other route's model refuses this checkpoint, and this model the other's
    with pytest.raises(RuntimeError, match="dw_kernel"):
        TorchCTC(_configs(True)[1], VOCAB).load_state_dict(sd, strict=True)
    ref, ref_len = model.apply(vs, jnp.asarray(feats), jnp.asarray(lens), deterministic=True)
    with torch.no_grad():
        got, got_len = tm.eval()(torch.from_numpy(feats), torch.from_numpy(lens))
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    ref = np.asarray(ref)
    for row, n in enumerate(np.asarray(ref_len)):
        np.testing.assert_allclose(got[row, :n].numpy(), ref[row, :n], atol=1e-4)
        np.testing.assert_array_equal(got[row, :n].argmax(-1).numpy(), ref[row, :n].argmax(-1))


def test_adafactor_sees_dw_kernel_in_the_flax_layout():
    """``dw_kernel`` is (K, C) on both sides: no permutation, and with K <
    128 optax does not factor it, nor does the port."""
    from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_axes
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer

    assert flax_axes("encoder.blocks.0.conv.dw_kernel", 2) == (0, 1)
    assert flax_axes("encoder.blocks.0.conv.depthwise.weight", 3) == (2, 1, 0)
    tm = TorchCTC(TCfg.conformer_s(use_pallas=True, conv_impl="pallas"), VOCAB)
    opt = make_optimizer(TCfg.OptimizerConfig(), tm.named_parameters())
    slots = opt.state["encoder.blocks.0.conv.dw_kernel"]
    assert set(slots) == {"v", "ema"} and slots["v"].shape == (33, 512)
