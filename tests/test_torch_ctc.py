"""The port's CTC loss (plain recursion, and the alpha/beta kernels' twins
behind their autograd Function) against the JAX package.

The JAX side: the ``lax.scan`` loss `ops.ctc.ctc_loss` and the Pallas loss
`ops.pallas.ctc.ctc_loss_pallas` in interpret mode, and for the twins the
Pallas ``_alpha_forward`` / ``_beta_backward`` kernels themselves on the
same padded inputs.  Tolerances (float32 on both sides, sums and exps in
another order): losses rtol 1e-5 / atol 1e-5, gradients and the beta
kernel's demit atol 1e-5, alpha atol 1e-4 on finite values (log-space
values of magnitude up to ~100 at these lengths), LOG_EPS entries equal.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu.ops import ctc as JC
from nn_conformer_for_speech_recognition_tpu.ops.pallas import ctc as JP
from nn_conformer_for_speech_recognition_tpu_torch.ops import ctc as TC
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import ctc as K

RTOL, ATOL = 1e-5, 1e-5

# (input lengths, label lengths, labels): mixed lengths, repeated labels,
# an empty label and an impossible alignment (3 labels in 2 frames)
CASES = {
    "mixed": ([9, 6, 9], [3, 2, 1], [[1, 2, 3], [4, 4, 0], [2, 0, 0]]),
    "repeats_empty_impossible": ([8, 8, 2, 5], [4, 0, 3, 2], [[2, 2, 3, 3], [0, 0, 0, 0], [1, 2, 3, 0], [5, 5, 0, 0]]),
}


def _inputs(rng, case, vocab=6):
    in_len, lab_len, labels = CASES[case]
    b, t = len(in_len), max(in_len)
    logits = rng.standard_normal((b, t, vocab)).astype(np.float32)
    log_probs = np.array(jax.nn.log_softmax(jnp.asarray(logits), axis=-1))
    return log_probs, np.asarray(labels, np.int32), np.asarray(in_len, np.int32), np.asarray(lab_len, np.int32)


def _jax_loss_and_grad(fn, args, reduction):
    def loss(lp):
        out = fn(lp, *args[1:], blank_id=0, zero_infinity=True, reduction=reduction)
        return jnp.sum(out), out

    (_, out), grad = jax.value_and_grad(loss, has_aux=True)(jnp.asarray(args[0]))
    return np.asarray(out), np.asarray(grad)


def _torch_loss_and_grad(fn, args, reduction):
    lp = torch.from_numpy(args[0]).requires_grad_(True)
    out = fn(lp, *[torch.from_numpy(a) for a in args[1:]], blank_id=0, zero_infinity=True, reduction=reduction)
    out.sum().backward()
    return out.detach().numpy(), lp.grad.numpy()


@pytest.mark.parametrize("reduction", [None, "sum", "mean"])
@pytest.mark.parametrize("case", sorted(CASES))
def test_ctc_loss_and_grad_match_jax(rng, case, reduction):
    args = _inputs(rng, case)
    ref, ref_grad = _jax_loss_and_grad(JC.ctc_loss, args, reduction)
    pallas, pallas_grad = _jax_loss_and_grad(
        lambda *a, **kw: JP.ctc_loss_pallas(*a, **kw, interpret=True), args, reduction)
    np.testing.assert_allclose(pallas, ref, rtol=RTOL, atol=ATOL)
    for fn in (TC.ctc_loss, K.ctc_loss_kernel):
        got, grad = _torch_loss_and_grad(fn, args, reduction)
        assert np.all(np.isfinite(grad)), fn.__name__
        np.testing.assert_allclose(got, ref, rtol=RTOL, atol=ATOL, err_msg=fn.__name__)
        np.testing.assert_allclose(grad, pallas_grad, atol=ATOL, err_msg=fn.__name__)
        np.testing.assert_allclose(grad, ref_grad, atol=ATOL, err_msg=fn.__name__)


def test_zero_infinity_zeroes_the_impossible_row(rng):
    args = _inputs(rng, "repeats_empty_impossible")
    for fn in (TC.ctc_loss, K.ctc_loss_kernel):
        nll, grad = _torch_loss_and_grad(fn, args, None)
        assert nll[2] == 0.0 and np.all(grad[2] == 0.0), fn.__name__
        assert np.all(nll[[0, 1, 3]] > 0.0)
        raw = fn(*[torch.from_numpy(a) for a in args], zero_infinity=False, reduction=None)
        assert raw[2] >= -TC.LOG_EPS / 2  # log(0) without zero_infinity


def test_matches_torch_ctc_loss(rng):
    """torch's own CTC as a second witness, on the gradient w.r.t. the
    logits (torch's CTC backward assumes a log_softmax before it)."""
    log_probs, labels, in_len, lab_len = _inputs(rng, "repeats_empty_impossible")
    logits = torch.from_numpy(log_probs).requires_grad_(True)
    witness = torch.from_numpy(log_probs).requires_grad_(True)
    ours = K.ctc_loss_kernel(torch.log_softmax(logits, -1), torch.from_numpy(labels), torch.from_numpy(in_len),
                             torch.from_numpy(lab_len), reduction=None)
    ref = torch.nn.functional.ctc_loss(
        torch.log_softmax(witness, -1).transpose(0, 1), torch.from_numpy(labels).long(),
        torch.from_numpy(in_len).long(), torch.from_numpy(lab_len).long(), blank=0,
        reduction="none", zero_infinity=True)
    ours.sum().backward()
    ref.sum().backward()
    torch.testing.assert_close(ours, ref, rtol=RTOL, atol=ATOL)
    torch.testing.assert_close(logits.grad, witness.grad, rtol=0, atol=ATOL)


def test_golden_value():
    rng = np.random.default_rng(1234)
    logits = torch.from_numpy(rng.standard_normal((2, 10, 6)).astype(np.float32))
    loss = TC.ctc_loss_from_logits(logits, torch.tensor([[1, 2, 3], [4, 5, 1]]), torch.tensor([10, 8]),
                                   torch.tensor([3, 3]), reduction="mean")
    assert abs(float(loss) - 3.1593) < 2e-2, float(loss)


def _padded(x, t_pad, b_pad, s_pad, fill):
    """(B, T, S) → the Pallas kernels' (T_pad, B_pad, S_pad) layout."""
    b, t, s = x.shape
    out = np.full((t_pad, b_pad, s_pad), fill, np.float32)
    out[:t, :b, :s] = np.moveaxis(x, 1, 0)
    return out


@pytest.mark.parametrize("case", sorted(CASES))
def test_alpha_beta_twins_match_pallas_kernels(rng, case):
    log_probs, labels, in_len, lab_len = _inputs(rng, case)
    b, t, _ = log_probs.shape
    ext, can_skip, valid, ext_len = (np.array(a) for a in JC.extended_labels(
        jnp.asarray(labels), jnp.asarray(lab_len), 0))
    emit = np.take_along_axis(log_probs, np.broadcast_to(ext[:, None, :], (b, t, ext.shape[1])), axis=2)
    s = ext.shape[1]
    time_block, s_pad, b_pad = 8, 128, 8
    t_pad = -(-t // time_block) * time_block
    fin = (np.arange(s)[None] == (ext_len - 1)[:, None]) | (
        (np.arange(s)[None] == (ext_len - 2)[:, None]) & (ext_len >= 2)[:, None])

    def bs(x):
        out = np.zeros((b_pad, s_pad), np.float32)
        out[:b, :s] = x
        return jnp.asarray(out)

    len_map = jnp.asarray(np.pad(np.broadcast_to(in_len[:, None], (b, s_pad)).astype(np.float32), ((0, b_pad - b), (0, 0))))
    emit_tbs = jnp.asarray(_padded(emit, t_pad, b_pad, s_pad, TC.LOG_EPS))
    alpha_ref = np.asarray(JP._alpha_forward(emit_tbs, bs(can_skip), bs(valid), len_map, time_block, True))
    alpha_ref = np.moveaxis(alpha_ref[:t, :b, :s], 0, 1)

    targs = [torch.from_numpy(a) for a in (emit, can_skip, ext_len, in_len)]
    alpha = K.ctc_alpha(*targs)
    finite = alpha_ref > TC.LOG_EPS / 2
    np.testing.assert_array_equal(alpha.numpy() > TC.LOG_EPS / 2, finite)
    np.testing.assert_allclose(alpha.numpy()[finite], alpha_ref[finite], atol=1e-4)

    ll = K.final_ll(alpha[:, -1], targs[2])
    ll_ref = np.asarray(JP._final_ll(jnp.asarray(np.moveaxis(alpha_ref, 1, 0)[-1]), jnp.asarray(fin, jnp.float32)))
    np.testing.assert_allclose(ll.numpy(), ll_ref, rtol=RTOL, atol=ATOL)

    g = rng.standard_normal(b).astype(np.float32)
    demit_ref = JP._beta_backward(
        emit_tbs, jnp.asarray(_padded(alpha.numpy(), t_pad, b_pad, s_pad, TC.LOG_EPS)), bs(can_skip), bs(valid),
        bs(fin), len_map, jnp.asarray(np.pad(g, (0, b_pad - b))), jnp.asarray(np.pad(ll.numpy(), (0, b_pad - b))),
        time_block, True)
    demit_ref = np.moveaxis(np.asarray(demit_ref)[:t, :b, :s], 0, 1)
    demit = K.ctc_beta(*targs[:1], alpha, *targs[1:], ll, torch.from_numpy(g))
    np.testing.assert_allclose(demit.numpy(), demit_ref, atol=ATOL)


@pytest.mark.parametrize("case", sorted(CASES))
def test_emit_adjoint_is_the_one_hot_contraction(rng, case):
    """The gather behind the loss puts each state's gradient back on its
    vocabulary column through the transposed one-hot contraction, as the
    JAX package differentiates its one-hot selection: equal to JAX's
    adjoint of that contraction and to torch's own adjoint of the gather
    (a scatter-add) within 1e-6, rows of repeated labels and the blank
    column included, and bit-equal from call to call."""
    log_probs, labels, _, lab_len = _inputs(rng, case)
    ext = TC.extended_labels(torch.from_numpy(labels), torch.from_numpy(lab_len), 0)[0]
    g = rng.standard_normal((*log_probs.shape[:2], ext.shape[1])).astype(np.float32)

    def adjoint(fn):
        leaf = torch.from_numpy(log_probs).requires_grad_(True)
        (grad,) = torch.autograd.grad(fn(leaf), leaf, torch.from_numpy(g))
        return grad

    got = adjoint(lambda lp: TC.emit_log_probs(lp, ext))
    assert torch.equal(got, adjoint(lambda lp: TC.emit_log_probs(lp, ext)))
    index = ext[:, None, :].expand(*log_probs.shape[:2], -1)
    torch.testing.assert_close(got, adjoint(lambda lp: torch.gather(lp, 2, index)), rtol=0, atol=1e-6)
    onehot = jax.nn.one_hot(jnp.asarray(ext.numpy()), log_probs.shape[2], dtype=jnp.float32)
    _, vjp = jax.vjp(lambda lp: jnp.einsum("btv,bsv->bts", lp, onehot, precision="highest"), jnp.asarray(log_probs))
    np.testing.assert_allclose(got.numpy(), np.asarray(vjp(jnp.asarray(g))[0]), rtol=0, atol=1e-6)
