"""Port's LSTM twins vs the JAX Pallas LSTM kernels in interpret mode:
the forward (h, and the c and gates the training forward saves) and the
gradients in xw and w_hh.

Tolerance atol 1e-5, as test_pallas.py's kernel-vs-scan check: both sides
run the same float32 recurrence, summed in different orders; dW_hh, a sum
over B·T, gets 1e-5 relative to its largest entry.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu.ops.pallas import lstm as JL
from nn_conformer_for_speech_recognition_tpu.ops.pallas.lstm import lstm_pallas
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.lstm import lstm, lstm_forward, lstm_plain

ATOL = 1e-5


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize(
    "hidden, lengths",
    [(8, [7, 3, 7, 1]), (160, [6, 4, 6])],  # 160 > 128: spans lane tiles on the TPU side
)
def test_lstm_matches_pallas_interpret(rng, reverse, hidden, lengths):
    b, t = len(lengths), max(lengths)
    xw = rng.standard_normal((b, t, 4 * hidden)).astype(np.float32) * 0.5
    wh = rng.standard_normal((hidden, 4 * hidden)).astype(np.float32) * hidden ** -0.5
    lens = np.asarray(lengths, np.int32)
    ref = lstm_pallas(jnp.asarray(xw), jnp.asarray(wh), jnp.asarray(lens), reverse=reverse, interpret=True)
    got = lstm(torch.from_numpy(xw), torch.from_numpy(wh), torch.from_numpy(lens), reverse=reverse)
    assert got.shape == (b, t, hidden)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_lstm_padded_steps_carry_h(rng):
    """Padded steps emit the carried h; the reverse direction starts at each
    row's own len-1, so a row's valid outputs ignore its padding."""
    xw = torch.from_numpy(rng.standard_normal((2, 6, 16)).astype(np.float32))
    wh = torch.from_numpy(rng.standard_normal((4, 16)).astype(np.float32) * 0.5)
    lens = torch.tensor([6, 3])
    fwd = lstm_plain(xw, wh, lens)
    torch.testing.assert_close(fwd[1, 3:], fwd[1, 2:3].expand(3, 4))
    bwd = lstm_plain(xw, wh, lens, reverse=True)
    torch.testing.assert_close(bwd[1, 3:], torch.zeros(3, 4))
    alone = lstm_plain(xw[1:, :3], wh, torch.tensor([3]), reverse=True)
    torch.testing.assert_close(bwd[1:, :3], alone)


GRAD_ATOL = 1e-5  # float32 BPTT on both sides, summed in another order


def _jax_grads(xw, wh, lens, r, reverse):
    def loss(x, w):
        return jnp.sum(lstm_pallas(x, w, jnp.asarray(lens), reverse=reverse, interpret=True) * r)

    return [np.asarray(g) for g in jax.grad(loss, argnums=(0, 1))(jnp.asarray(xw), jnp.asarray(wh))]


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden, lengths", [(8, [7, 3, 7, 1]), (160, [6, 4, 6]), (37, [5, 2, 5]), (100, [4, 4, 1, 3])])
def test_lstm_gradients_match_pallas_interpret(rng, reverse, hidden, lengths):
    """d(sum(h · r)) / d(xw, w_hh): the autograd Function over the plain
    twins (explicit BPTT + the weight-gradient product), and autograd
    through the plain loop, both against jax.grad through the Pallas
    kernel's custom_vjp; H = 37 and 100 end the dW_hh kernel's output tile
    part-way."""
    b, t = len(lengths), max(lengths)
    xw = rng.standard_normal((b, t, 4 * hidden)).astype(np.float32) * 0.5
    wh = rng.standard_normal((hidden, 4 * hidden)).astype(np.float32) * hidden ** -0.5
    lens = np.asarray(lengths, np.int32)
    r = rng.standard_normal((b, t, hidden)).astype(np.float32)
    ref_dxw, ref_dwh = _jax_grads(xw, wh, lens, r, reverse)
    for fn in (lstm, lambda *a, reverse: lstm_plain(*a, reverse)):
        x = torch.from_numpy(xw).requires_grad_(True)
        w = torch.from_numpy(wh).requires_grad_(True)
        (fn(x, w, torch.from_numpy(lens), reverse=reverse) * torch.from_numpy(r)).sum().backward()
        np.testing.assert_allclose(x.grad.numpy(), ref_dxw, atol=GRAD_ATOL)
        np.testing.assert_allclose(w.grad.numpy(), ref_dwh, atol=GRAD_ATOL * max(1.0, np.abs(ref_dwh).max()))


@pytest.mark.parametrize("reverse", [False, True])
def test_training_forward_twin_matches_pallas_saves(rng, reverse):
    """The forward twin's saved c (every step) and gates (active steps;
    the twin stores 0 on padded ones, which the backward never reads)
    against what the Pallas forward kernel saves."""
    hidden, lengths = 8, [7, 3, 7, 1]
    b, t = len(lengths), max(lengths)
    xw = rng.standard_normal((b, t, 4 * hidden)).astype(np.float32) * 0.5
    wh = rng.standard_normal((hidden, 4 * hidden)).astype(np.float32) * hidden ** -0.5
    lens = np.asarray(lengths, np.int32)
    hp = JL._round_up(hidden, JL.LANES)
    b_pad = JL._round_up(b, JL._pick_bb(b, hp))
    xw_p = jnp.pad(jnp.moveaxis(JL._pad_gates_lanes(jnp.asarray(xw), hidden, hp), 1, 0), ((0, 0), (0, b_pad - b), (0, 0)))
    wh_p = JL._pad_gates_lanes(jnp.pad(jnp.asarray(wh), ((0, hp - hidden), (0, 0))), hidden, hp)
    len_map = jnp.pad(jnp.broadcast_to(jnp.asarray(lens, jnp.float32)[:, None], (b, hp)), ((0, b_pad - b), (0, 0)))
    h_ref, c_ref, g_ref = JL._lstm_forward(xw_p, wh_p, len_map, reverse, True)
    c_ref = np.moveaxis(np.asarray(c_ref)[:, :b, :hidden], 0, 1)
    g_ref = np.moveaxis(np.asarray(JL._unpad_gates_lanes(g_ref, hidden, hp))[:, :b], 0, 1)
    h, c, gates = lstm_forward(torch.from_numpy(xw), torch.from_numpy(wh), torch.from_numpy(lens), reverse=reverse, save=True)
    np.testing.assert_allclose(h.numpy(), np.moveaxis(np.asarray(h_ref)[:, :b, :hidden], 0, 1), atol=ATOL)
    np.testing.assert_allclose(c.numpy(), c_ref, atol=ATOL)
    active = np.arange(t)[None, :] < lens[:, None]
    np.testing.assert_allclose(gates.numpy()[active], g_ref[active], atol=ATOL)
    assert np.all(gates.numpy()[~active] == 0.0)
    assert lstm_forward(torch.from_numpy(xw), torch.from_numpy(wh), torch.from_numpy(lens))[1:] == (None, None)


def test_init_params_draws_w_hh_orthogonal_and_keeps_the_other_leaves():
    """Each direction's recurrent matrix starts orthogonal, as flax's
    ``orthogonal()`` draws it in the JAX package (rows orthonormal:
    w_hh·w_hhᵀ = I within 1e-5); the draw takes as many numbers from the
    generator as a normal fill, so every other leaf keeps the value, and
    the LeCun-normal standard deviation, it had before."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params

    enc = C.ConformerConfig(num_blocks=1, d_model=16, num_heads=2, ffn_dim=32, conv_kernel_size=5)
    dec = C.DecoderConfig(projection_dim=8, lstm_hidden=24, lstm_layers=2)
    cfg = C.ModelConfig(encoder=enc, decoder=dec, use_pallas=True)
    model = init_params(ConformerCTC(cfg, 12), torch.Generator().manual_seed(0))
    params = dict(model.named_parameters())
    w_hh = {n: p for n, p in params.items() if n.endswith("_w_hh")}
    assert len(w_hh) == 4  # two layers, two directions
    for name, w in w_hh.items():
        assert w.shape == (24, 96)
        torch.testing.assert_close(w @ w.t(), torch.eye(24), rtol=0, atol=1e-5, msg=name)
        assert abs(w.std().item() - 96 ** -0.5) < 0.1 * 96 ** -0.5, name  # entries of variance 1/(4H)

    # the LeCun-normal rule for every other leaf, as it drew before
    gen = torch.Generator().manual_seed(0)
    for name, p in params.items():
        if p.ndim == 1 or name.endswith(("u_bias", "v_bias")):
            continue
        fan_in = p.shape[0] if name.endswith(("_w_ih", "_w_hh", "dw_kernel")) else p[0].numel()
        draw = torch.randn(p.shape, generator=gen) * fan_in ** -0.5
        if name not in w_hh:
            assert torch.equal(p.detach(), draw), name
            if p.numel() >= 1000:
                assert abs(p.std().item() - fan_in ** -0.5) < 0.1 * fan_in ** -0.5, name
