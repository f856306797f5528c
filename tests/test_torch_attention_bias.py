"""The port's bias-input attention (`flash_attention`) against the JAX
package's: the plain twin against the Pallas kernel in interpret mode and
against ``flash_attention_reference``, and `BiasFlashAttention`'s backward
against ``_fa_bwd`` and ``jax.grad`` of the reference.

Tolerances, as ``test_pallas.py`` holds the Pallas kernel to its own
reference: atol 1e-4 forward (the online softmax and the one-shot softmax
round differently), atol 2e-4 backward.  The Pallas kernel pads T to its
tile and leaves the rows of masked queries to whatever the pad gives, so a
row is compared only where the query is valid; the twin and the reference
are compared on every row.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu.ops.pallas import attention as JA
from nn_conformer_for_speech_recognition_tpu.ops.relshift import rel_shift as jax_rel_shift
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A
from nn_conformer_for_speech_recognition_tpu_torch.ops.relshift import rel_shift

FWD_ATOL, BWD_ATOL = 1e-4, 2e-4


def _case(rng, b, t, h, dh, lengths):
    qu, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(3))
    bias = rng.standard_normal((b, h, t, t)).astype(np.float32) * 0.2
    return qu, k, v, bias, np.asarray(lengths, np.int32)


def _torch(arrays):
    return [torch.from_numpy(a) for a in arrays]


@pytest.mark.parametrize(
    "b, t, h, dh, lengths, scale, block",
    [(2, 24, 2, 16, [24, 12], 0.25, 8), (1, 16, 2, 16, [16], 1.0, 16), (3, 37, 4, 8, [37, 1, 20], 8 ** -0.5, 8)],
)
def test_twin_matches_pallas_kernel_and_reference(rng, b, t, h, dh, lengths, scale, block):
    case = _case(rng, b, t, h, dh, lengths)
    jargs = [jnp.asarray(a) for a in case]
    kernel = np.asarray(JA._flash_forward(*jargs, scale, block_q=block, block_k=block, interpret=True))
    ref = np.asarray(JA.flash_attention_reference(*jargs, scale))
    got = A.flash_attention(*_torch(case), scale)
    assert got.shape == (b, t, h, dh) and got.dtype == torch.float32
    np.testing.assert_allclose(got.numpy(), ref, atol=FWD_ATOL)
    for row, n in enumerate(lengths):
        np.testing.assert_allclose(got.numpy()[row, :n], kernel[row, :n], atol=FWD_ATOL)


def test_scale_multiplies_the_bias(rng):
    """(s + bias) · scale, not s · scale + bias."""
    qu, k, v, bias, lengths = _torch(_case(rng, 1, 9, 1, 8, [9]))
    a = A.flash_attention(qu, k, v, bias, lengths, 0.5)
    b = A.flash_attention(qu, k, v, bias * 2.0, lengths, 0.5)
    scores = (torch.einsum("bihd,bjhd->bhij", qu, k) + 2.0 * bias) * 0.5
    ref = torch.einsum("bhij,bjhd->bihd", torch.softmax(scores, -1), v)
    assert not torch.allclose(a, b, atol=1e-3)
    np.testing.assert_allclose(b.numpy(), ref.numpy(), atol=1e-5)


def test_bf16_inputs_accumulate_in_float32(rng):
    """bfloat16 inputs with a float32 or a bfloat16 bias: the result has the
    inputs' type and lies within one bf16 rounding of the JAX reference on
    the same bf16 inputs."""
    case = _case(rng, 2, 24, 2, 16, [24, 7])
    for bias_dtype in (torch.float32, torch.bfloat16):
        qu, k, v, bias, lengths = _torch(case)
        qu, k, v, bias = qu.bfloat16(), k.bfloat16(), v.bfloat16(), bias.to(bias_dtype)
        got = A.flash_attention(qu, k, v, bias, lengths, 0.25)
        assert got.dtype == torch.bfloat16
        jargs = [jnp.asarray(x.float().numpy(), jnp.bfloat16) for x in (qu, k, v)]
        jbias = jnp.asarray(bias.float().numpy(), jnp.bfloat16 if bias_dtype == torch.bfloat16 else jnp.float32)
        ref = JA.flash_attention_reference(*jargs, jbias, jnp.asarray(case[4]), 0.25)
        ref = np.asarray(ref.astype(jnp.float32))
        # one bf16 ulp at the largest entry
        np.testing.assert_allclose(got.float().numpy(), ref, atol=2.0 ** -7 * np.abs(ref).max())


@pytest.mark.parametrize("b, t, h, dh, lengths", [(1, 12, 1, 8, [12]), (2, 24, 2, 16, [24, 12])])
def test_backward_matches_fa_bwd_and_jax_grad(rng, b, t, h, dh, lengths):
    case = _case(rng, b, t, h, dh, lengths)
    jqu, jk, jv, jbias, jlen = (jnp.asarray(a) for a in case)

    def loss_ref(qu, k, v, bias):
        return jnp.sum(JA.flash_attention_reference(qu, k, v, bias, jlen, 0.5) ** 2)

    grads_ref = jax.grad(loss_ref, argnums=(0, 1, 2, 3))(jqu, jk, jv, jbias)
    out_ref = JA.flash_attention_reference(jqu, jk, jv, jbias, jlen, 0.5)
    grads_bwd = JA._fa_bwd(0.5, (jqu, jk, jv, jbias, jlen), 2 * out_ref)

    qu, k, v, bias, lens = _torch(case)
    leaves = [x.requires_grad_(True) for x in (qu, k, v, bias)]
    out = A.flash_attention(*leaves, lens, 0.5)
    assert out.grad_fn is not None and type(out.grad_fn).__name__ == "BiasFlashAttentionBackward"
    (out ** 2).sum().backward()
    for name, leaf, ref, bwd in zip(("dqu", "dk", "dv", "dbias"), leaves, grads_ref, grads_bwd):
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(ref), atol=BWD_ATOL, err_msg=name)
        np.testing.assert_allclose(leaf.grad.numpy(), np.asarray(bwd), atol=BWD_ATOL, err_msg=name)
    # masked key columns of the bias get no gradient
    assert not bias.grad[-1, :, :, lengths[-1]:].any()


def test_function_gradcheck_float64(rng):
    qu, k, v, bias, lens = _torch(_case(rng, 2, 7, 2, 4, [7, 3]))
    leaves = [x.double().requires_grad_(True) for x in (qu, k, v, bias)]
    assert torch.autograd.gradcheck(lambda *a: A.BiasFlashAttention.apply(*a, lens, 0.5), leaves, atol=1e-6)


def test_backward_plain_matches_autograd_through_twin(rng):
    qu, k, v, bias, lens = _torch(_case(rng, 2, 19, 2, 8, [19, 6]))
    g = torch.from_numpy(rng.standard_normal(qu.shape).astype(np.float32))
    leaves = [x.clone().requires_grad_(True) for x in (qu, k, v, bias)]
    want = torch.autograd.grad(A.flash_attention_plain(*leaves, lens, 0.35), leaves, g)
    got = A.flash_attention_backward_plain(qu, k, v, bias, lens, 0.35, g)
    for a, b in zip(got, want):
        np.testing.assert_allclose(a.numpy(), b.numpy(), atol=1e-5)


def test_rel_shift_bias_gives_relpos_attention(rng):
    """With bias = rel_shift(qv·pᵀ) the bias-input op is rel-pos attention:
    the formulation the two kernels share, in both packages."""
    b, t, h, dh = 2, 13, 2, 8
    qu, qv, k, v = (rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(4))
    p = rng.standard_normal((2 * t - 1, h, dh)).astype(np.float32)
    lens = np.asarray([13, 5], np.int32)
    tq, tqv, tk, tv, tp, tl = _torch((qu, qv, k, v, p, lens))
    bias = rel_shift(torch.einsum("bihd,lhd->bhil", tqv, tp))
    jbias = jax_rel_shift(jnp.einsum("bihd,lhd->bhil", jnp.asarray(qv), jnp.asarray(p)))
    np.testing.assert_allclose(bias.numpy(), np.asarray(jbias), atol=1e-5)
    got = A.flash_attention(tq, tk, tv, bias, tl, dh ** -0.5)
    want = A.flash_relpos_attention(tq, tqv, tk, tv, tp, tl, dh ** -0.5)
    np.testing.assert_allclose(got.numpy(), want.numpy(), atol=1e-5)
    ref = JA._flash_relpos_forward(*(jnp.asarray(a) for a in (qu, qv, k, v, p, lens)), dh ** -0.5, interpret=True)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=2e-4)


def test_wrapper_refuses_what_the_kernel_does_not_take(rng):
    """On a CPU tensor the forward takes the twin and counts no launch; the
    launch path's input check refuses a tensor that is not on the card."""
    qu, k, v, bias, lens = _torch(_case(rng, 1, 8, 1, 16, [8]))
    before = A.flash_attention_forward.launches
    A.flash_attention_forward(qu, k, v, bias, lens, 1.0)
    assert A.flash_attention_forward.launches == before
    with pytest.raises(ValueError, match="unsupported device"):
        A._check_bias_inputs(qu, k, v, bias, lens)
