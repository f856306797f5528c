"""Both LSTM directions in one call: the port's two-direction entry
(`lstm_directions`, `lstm_forward_directions`, `lstm_backward_directions`)
and its autograd Function, on the CPU through the plain twins, against the
JAX package's per-direction ``lstm_pallas`` in interpret mode, from the
same numpy inputs; and `BiLSTM.forward`, which now hands both directions
to that entry, against the JAX ``BiLSTM`` under converted weights.

H = 16, B = 3, T = 11, lengths (11, 6, 1): ragged, one of a single step.
Tolerance 1e-5, as test_torch_lstm.py's: the same float32 recurrence on
both sides, summed in other orders; dW_hh, a sum over B·T, 1e-5 of its
largest entry.  The two-direction entry and two one-direction calls run the
same arithmetic and are held bit for bit.  One JAX run serves the file
(module-scoped fixtures).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as JC
from nn_conformer_for_speech_recognition_tpu.models.asr import BiLSTM as JaxBiLSTM
from nn_conformer_for_speech_recognition_tpu.ops.pallas.lstm import lstm_pallas
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import BiLSTM
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L

HIDDEN, LENGTHS, IN_DIM = 16, (11, 6, 1), 8
B, T = len(LENGTHS), max(LENGTHS)
REVERSE = (False, True)
ATOL = 1e-5


@pytest.fixture(scope="module")
def case():
    """Numpy inputs of both directions and the JAX package's h and
    gradients of sum(h · r) for each, through the Pallas kernel's
    custom_vjp in interpret mode."""
    rng = np.random.default_rng(7)
    xws = [rng.standard_normal((B, T, 4 * HIDDEN)).astype(np.float32) * 0.5 for _ in REVERSE]
    whs = [rng.standard_normal((HIDDEN, 4 * HIDDEN)).astype(np.float32) * HIDDEN ** -0.5 for _ in REVERSE]
    rs = [rng.standard_normal((B, T, HIDDEN)).astype(np.float32) for _ in REVERSE]
    lens = np.asarray(LENGTHS, np.int32)
    ref_h, ref_grads = [], []
    for xw, wh, r, reverse in zip(xws, whs, rs, REVERSE):
        def loss(x, w, r=r, reverse=reverse):
            h = lstm_pallas(x, w, jnp.asarray(lens), reverse=reverse, interpret=True)
            return jnp.sum(h * r), h

        (_, h), grads = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(jnp.asarray(xw), jnp.asarray(wh))
        ref_h.append(np.asarray(h))
        ref_grads.append([np.asarray(g) for g in grads])
    return dict(xws=xws, whs=whs, rs=rs, lens=lens, h=ref_h, grads=ref_grads)


def _torch(case, grad=False):
    xws = [torch.from_numpy(x).requires_grad_(grad) for x in case["xws"]]
    whs = [torch.from_numpy(w).requires_grad_(grad) for w in case["whs"]]
    return xws, whs, torch.from_numpy(case["lens"])


@pytest.mark.parametrize("save", [False, True])
def test_two_directions_match_pallas_interpret(case, save):
    """h of both directions from one call, with and without the saved c
    and gates, against the JAX package's per-direction kernel."""
    xws, whs, lens = _torch(case)
    outs = L.lstm_forward_directions(xws, whs, lens, REVERSE, save=save)
    for (h, c, gates), ref in zip(outs, case["h"]):
        assert h.shape == (B, T, HIDDEN) and (c is None) == (gates is None) == (not save)
        np.testing.assert_allclose(h.numpy(), ref, atol=ATOL)
    hs = L.lstm_directions(xws, whs, lens, REVERSE)
    for h, ref in zip(hs, case["h"]):
        np.testing.assert_allclose(h.numpy(), ref, atol=ATOL)


def test_two_direction_gradients_match_pallas_interpret(case):
    """d(Σ_directions sum(h · r)) / d(xw, w_hh) of both directions through
    the one autograd Function, against jax.grad of each direction."""
    xws, whs, lens = _torch(case, grad=True)
    hs = L.lstm_directions(xws, whs, lens, REVERSE)
    sum((h * torch.from_numpy(r)).sum() for h, r in zip(hs, case["rs"])).backward()
    for x, w, h, ref_h, (ref_dx, ref_dw) in zip(xws, whs, hs, case["h"], case["grads"]):
        np.testing.assert_allclose(h.detach().numpy(), ref_h, atol=ATOL)
        np.testing.assert_allclose(x.grad.numpy(), ref_dx, atol=ATOL)
        np.testing.assert_allclose(w.grad.numpy(), ref_dw, atol=ATOL * max(1.0, np.abs(ref_dw).max()))


def test_two_directions_equal_two_one_direction_calls(case):
    """The two-direction entry and two one-direction calls, bit for bit:
    forward (h, c, gates), BPTT (dxw) and the gradients through autograd."""
    xws, whs, lens = _torch(case)
    both = L.lstm_forward_directions(xws, whs, lens, REVERSE, save=True)
    alone = [L.lstm_forward(x, w, lens, reverse=r, save=True) for x, w, r in zip(xws, whs, REVERSE)]
    for got, one in zip(both, alone):
        assert all(torch.equal(a, b) for a, b in zip(got, one))
    gouts = [torch.from_numpy(r) for r in case["rs"]]
    dxws = L.lstm_backward_directions(gouts, [o[2] for o in both], [o[1] for o in both], whs, lens, REVERSE)
    for dxw, gout, (_, c, gates), w, r in zip(dxws, gouts, alone, whs, REVERSE):
        assert torch.equal(dxw, L.lstm_backward(gout, gates, c, w, lens, reverse=r))

    grads = []
    for run in (lambda x, w: L.lstm_directions(x, w, lens, REVERSE),
                lambda x, w: [L.lstm(*a, lens, reverse=r) for *a, r in zip(x, w, REVERSE)]):
        xg, wg, _ = _torch(case, grad=True)
        sum((h * g).sum() for h, g in zip(run(xg, wg), gouts)).backward()
        grads.append([t.grad for t in (*xg, *wg)])
    assert all(torch.equal(a, b) for a, b in zip(*grads))


def test_bilstm_forward_matches_jax_under_converted_weights(case):
    """`BiLSTM.forward` (both directions to `lstm_directions`, and the plain
    path) against the JAX ``BiLSTM`` with ``use_pallas`` (interpret mode) on
    the same weights, converted by `flax_to_state_dict`; the kernel path and
    the plain path are the same float32 arithmetic on the CPU, bit for bit."""
    rng = np.random.default_rng(11)
    x = rng.standard_normal((B, T, IN_DIM)).astype(np.float32)
    jmod = JaxBiLSTM(hidden=HIDDEN, use_pallas=True)
    variables = jmod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(case["lens"]))
    ref = np.asarray(jmod.apply(variables, jnp.asarray(x), jnp.asarray(case["lens"])))
    cfg = JC.ModelConfig(decoder=JC.DecoderConfig(projection_dim=IN_DIM, lstm_hidden=HIDDEN))
    state = flax_to_state_dict({"params": {"decoder_lstm": variables["params"]}}, cfg)
    outs = []
    for use_kernel in (True, False):
        module = BiLSTM(IN_DIM, HIDDEN, use_kernel=use_kernel)
        module.load_state_dict({k.removeprefix("decoder_lstm."): v for k, v in state.items()}, strict=True)
        with torch.no_grad():
            outs.append(module(torch.from_numpy(x), torch.from_numpy(case["lens"])))
    assert outs[0].shape == (B, T, 2 * HIDDEN)
    np.testing.assert_allclose(outs[0].numpy(), ref, atol=ATOL)
    assert torch.equal(outs[0], outs[1])
