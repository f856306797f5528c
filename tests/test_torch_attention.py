"""Port's rel-pos attention twin vs the JAX flash kernel (interpret mode)
and the JAX einsum path, and RelPositionMHSA with converted weights.

Tolerance atol 2e-4, as test_pallas.py's flash-vs-einsum MHSA check: the
online softmax and the one-shot softmax round differently.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu.models import conformer as JC
from nn_conformer_for_speech_recognition_tpu.ops.pallas import attention as JA
from nn_conformer_for_speech_recognition_tpu.ops.relshift import rel_shift as jax_rel_shift
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.models import conformer as TC
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.attention import flash_relpos_attention
from nn_conformer_for_speech_recognition_tpu_torch.ops.relshift import rel_shift

ATOL = 2e-4


def test_rel_shift_matches_jax(rng):
    x = rng.standard_normal((2, 3, 5, 9)).astype(np.float32)
    np.testing.assert_array_equal(rel_shift(torch.from_numpy(x)).numpy(), np.asarray(jax_rel_shift(jnp.asarray(x))))


@pytest.mark.parametrize("t, d", [(1, 8), (12, 32), (235, 256)])
def test_sinusoidal_rel_positions_is_exact_copy(t, d):
    np.testing.assert_array_equal(TC.sinusoidal_rel_positions(t, d), JC.sinusoidal_rel_positions(t, d))


def _jax_einsum_attention(qu, qv, k, v, p, lengths, scale):
    """The einsum path of models/conformer.RelPositionMHSA, f32."""
    t = qu.shape[1]
    ac = jnp.einsum("bihd,bjhd->bhij", qu, k)
    bd = jax_rel_shift(jnp.einsum("bihd,lhd->bhil", qv, p))
    scores = (ac + bd) * scale
    mask = JC.length_mask(lengths, t)
    scores = jnp.where(mask[:, None, None, :], scores, JC.NEG_INF)
    return jnp.einsum("bhij,bjhd->bihd", jax.nn.softmax(scores, axis=-1), v)


@pytest.mark.parametrize(
    "lengths, h, dh",
    [([12, 7], 2, 8), ([20, 1, 13], 2, 16), ([37, 37, 5, 30], 4, 8)],
)
def test_attention_twin_matches_jax(rng, lengths, h, dh):
    b, t = len(lengths), max(lengths)
    qu, qv, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(4))
    p = rng.standard_normal((2 * t - 1, h, dh)).astype(np.float32)
    lens = np.asarray(lengths, np.int32)
    scale = dh ** -0.5
    jargs = [jnp.asarray(a) for a in (qu, qv, k, v, p, lens)]
    flash = JA._flash_relpos_forward(*jargs, scale, interpret=True)
    einsum = _jax_einsum_attention(*jargs, scale)
    got = flash_relpos_attention(*[torch.from_numpy(a) for a in (qu, qv, k, v, p, lens)], scale)
    assert got.shape == (b, t, h, dh)
    np.testing.assert_allclose(got.numpy(), np.asarray(flash), atol=ATOL)
    np.testing.assert_allclose(got.numpy(), np.asarray(einsum), atol=ATOL)


def test_length_zero_row_weighs_every_key_alike(rng):
    """A row with no valid key (a batch-padding row: `audio_lengths` 0)
    masks every key alike, so every key weighs the same: the port's twin
    gives the mean of v over the T keys there, as the JAX einsum route does.
    The JAX Pallas forward weighs its t_pad padded keys alike, the zero
    padding included, and so reads T / t_pad of that mean (20 / 24 at
    T = 20).  The block's output on such a row is masked downstream
    (`models/conformer.py`), so nothing sees the difference; the port holds
    its kernels to the twin.  A row with valid keys agrees on all three."""
    t, h, dh = 20, 2, 8
    qu, qv, k, v = (rng.standard_normal((2, t, h, dh)).astype(np.float32) for _ in range(4))
    p = rng.standard_normal((2 * t - 1, h, dh)).astype(np.float32)
    lens = np.asarray([t, 0], np.int32)
    scale = dh ** -0.5
    jargs = [jnp.asarray(a) for a in (qu, qv, k, v, p, lens)]
    flash = np.asarray(JA._flash_relpos_forward(*jargs, scale, interpret=True))
    einsum = np.asarray(_jax_einsum_attention(*jargs, scale))
    got = flash_relpos_attention(*[torch.from_numpy(a) for a in (qu, qv, k, v, p, lens)], scale).numpy()
    mean_v = np.broadcast_to(v[1].mean(axis=0), (t, h, dh))
    np.testing.assert_allclose(got[1], mean_v, atol=1e-6)
    np.testing.assert_allclose(got[1], einsum[1], atol=ATOL)
    t_pad = 24  # the Pallas forward's block: T rounded up to a multiple of 8
    np.testing.assert_allclose(flash[1], got[1] * t / t_pad, atol=ATOL)
    np.testing.assert_allclose(got[0], flash[0], atol=ATOL)
    np.testing.assert_allclose(got[0], einsum[0], atol=ATOL)


@pytest.mark.parametrize("use_kernel", [True, False])
def test_mhsa_with_converted_weights(rng, monkeypatch, use_kernel):
    orig = JA._flash_relpos_forward
    monkeypatch.setattr(
        JA, "_flash_relpos_forward", lambda *a, **kw: orig(*a, **{**kw, "interpret": True})
    )
    d, heads, t = 32, 2, 12
    x = rng.standard_normal((2, t, d)).astype(np.float32)
    lens = np.asarray([12, 7], np.int32)
    mask = JC.length_mask(jnp.asarray(lens), t)
    jm = JC.RelPositionMHSA(d, heads, 0.0, use_relative=True, use_pallas=True)
    params = jm.init(jax.random.key(0), jnp.asarray(x), mask, True)
    params = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), params)
    ref = np.asarray(jm.apply(params, jnp.asarray(x), mask, True))

    tm = TC.RelPositionMHSA(d, heads, 0.0)
    tm.load_state_dict(flax_to_state_dict(params, None), strict=True)
    rel = torch.from_numpy(TC.sinusoidal_rel_positions(t, d))
    with torch.no_grad():
        got = tm(torch.from_numpy(x), torch.from_numpy(lens), rel, use_kernel=use_kernel).numpy()
    np.testing.assert_allclose(got[0], ref[0], atol=ATOL)
    np.testing.assert_allclose(got[1, :7], ref[1, :7], atol=ATOL)
