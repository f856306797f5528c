"""The port's rel-pos attention backward (plain twins and the autograd
Function on the CPU path) vs the JAX package's flash backward.

The JAX side runs as its own tests run it on the CPU: the flash forward
and the dq, dkv and dband Pallas kernels in interpret mode, through the
real ``custom_vjp`` of ``flash_attention_relpos``.  Inputs come from a numpy
seed; float32 on both sides.

Tolerances: lse atol 1e-5 on rows with a valid key; the plain backward
against the Pallas backward atol 5e-4, the bar ``tests/test_pallas.py``
holds that backward to (tiles of another size sum in another order);
against ``torch.autograd`` through the plain forward atol 1e-5 (the same
arithmetic, softmax against exp(s − lse)).  The bf16 tensor-core kernels'
rounding (a model of it here, the kernels themselves on the card): one
bf16 ulp at the float32 twin's largest entry, never below 5e-4 for the
gradients and 1e-4 for the forward's output, the bars ``chip_smoke.py``
holds the kernels to.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from torch.utils.checkpoint import checkpoint

from nn_conformer_for_speech_recognition_tpu.ops import relshift as JR
from nn_conformer_for_speech_recognition_tpu.ops.pallas import attention as JA
from nn_conformer_for_speech_recognition_tpu_torch.ops import relshift as TR
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as TA

NAMES = ("dqu", "dqv", "dk", "dv", "dp")
# (lengths, H, dh): T = 12 (one tile), 40 and 70 (several 32-row tiles of the
# CUDA kernels, several 8- to 128-row tiles of the Pallas ones), one row
# shorter than the rest, one row shorter than a tile
CASES = [([12, 7], 2, 16), ([40, 40, 9], 2, 32), ([70, 33, 5], 2, 16)]


def _case(rng, lengths, h, dh):
    b, t = len(lengths), max(lengths)
    arrays = [rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(4)]
    arrays.append(rng.standard_normal((2 * t - 1, h, dh)).astype(np.float32) * 0.3)
    g = rng.standard_normal((b, t, h, dh)).astype(np.float32)
    return arrays, np.asarray(lengths, np.int32), g, dh ** -0.5


def _leaves(arrays, dtype=torch.float32):
    return [torch.from_numpy(a).to(dtype).requires_grad_(True) for a in arrays]


@pytest.mark.parametrize("shape", [(5, 5), (2, 3, 12, 12), (1, 2, 40, 40)])
def test_rel_shift_adjoint_matches_jax(rng, shape):
    ds = rng.standard_normal(shape).astype(np.float32)
    got = TR.rel_shift_adjoint(torch.from_numpy(ds))
    np.testing.assert_array_equal(got.numpy(), np.asarray(JR.rel_shift_adjoint(jnp.asarray(ds))))
    # and it is the adjoint: <rel_shift(x), ds> == <x, rel_shift_adjoint(ds)>
    x = torch.from_numpy(rng.standard_normal((*shape[:-1], 2 * shape[-1] - 1)).astype(np.float32))
    torch.testing.assert_close((TR.rel_shift(x) * torch.from_numpy(ds)).sum(), (x * got).sum(), rtol=1e-5, atol=1e-5)
    with pytest.raises(ValueError):
        TR.rel_shift_adjoint(torch.zeros(3, 4))


@pytest.mark.parametrize("lengths, h, dh", CASES)
def test_plain_forward_lse_matches_jax(rng, lengths, h, dh):
    arrays, lens, _, scale = _case(rng, lengths, h, dh)
    out_ref, lse_ref = JA._flash_relpos_forward(
        *[jnp.asarray(a) for a in arrays], jnp.asarray(lens), scale, return_lse=True, interpret=True)
    out, lse = TA.flash_relpos_attention_plain(*[torch.from_numpy(a) for a in arrays], torch.from_numpy(lens), scale,
                                               return_lse=True)
    t = max(lengths)
    assert lse.shape == (len(lengths), h, t) and lse.dtype == torch.float32
    np.testing.assert_allclose(lse.numpy(), np.asarray(lse_ref)[:, :, :t, 0], atol=1e-5)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), atol=2e-4)
    out_cpu, lse_cpu = TA.flash_relpos_attention_forward_lse(
        *[torch.from_numpy(a) for a in arrays], torch.from_numpy(lens), scale)  # the wrapper's CPU path is the twin
    assert torch.equal(out_cpu, out) and torch.equal(lse_cpu, lse)


@pytest.mark.parametrize("lengths, h, dh", CASES)
def test_plain_backward_matches_jax_pallas_backward(rng, lengths, h, dh):
    arrays, lens, g, scale = _case(rng, lengths, h, dh)
    jarrays, jlens = [jnp.asarray(a) for a in arrays], jnp.asarray(lens)
    out_ref, vjp = jax.vjp(lambda *a: JA.flash_attention_relpos(*a, jlens, scale), *jarrays)
    ref = vjp(jnp.asarray(g))
    tensors = [torch.from_numpy(a) for a in arrays]
    out, lse = TA.flash_relpos_attention_plain(*tensors, torch.from_numpy(lens), scale, return_lse=True)
    np.testing.assert_allclose(out.numpy(), np.asarray(out_ref), atol=2e-4)
    got = TA.flash_relpos_attention_backward_plain(*tensors, torch.from_numpy(lens), scale, out, lse, torch.from_numpy(g))
    for name, x, r in zip(NAMES, got, ref):
        assert x.shape == r.shape and np.abs(np.asarray(r)).max() > 0, name
        np.testing.assert_allclose(x.numpy(), np.asarray(r), atol=5e-4, err_msg=name)


@pytest.mark.parametrize("lengths, h, dh", CASES + [([6, 0], 1, 16)])
def test_plain_backward_matches_autograd(rng, lengths, h, dh):
    """Also with a row that has no valid key: the forward attends
    uniformly there, the backward gives probability exactly 0, so that
    row's gradients are 0 where autograd's are not; the other rows agree."""
    arrays, lens, g, scale = _case(rng, lengths, h, dh)
    leaves = _leaves(arrays)
    out, lse = TA.flash_relpos_attention_plain(*leaves, torch.from_numpy(lens), scale, return_lse=True)
    ref = torch.autograd.grad(out, leaves, torch.from_numpy(g))
    got = TA.flash_relpos_attention_backward_plain(
        *[x.detach() for x in leaves], torch.from_numpy(lens), scale, out.detach(), lse.detach(), torch.from_numpy(g))
    full = lens > 0
    if full.all():
        for name, x, r in zip(NAMES, got, ref):
            torch.testing.assert_close(x, r, rtol=0, atol=1e-5, msg=name)
    else:
        for name, x, r in zip(NAMES[:4], got, ref):
            torch.testing.assert_close(x[full], r[full], rtol=0, atol=1e-5, msg=name)
            assert torch.all(x[~full] == 0), name
    # each backward wrapper's CPU path is the same twin
    delta = TA.attention_delta(out.detach(), torch.from_numpy(g))
    call = (*[x.detach() for x in leaves], torch.from_numpy(lens), scale, lse.detach(), delta, torch.from_numpy(g))
    parts = (*TA.flash_relpos_attention_bwd_dq(*call), *TA.flash_relpos_attention_bwd_dkv(*call),
             TA.flash_relpos_attention_bwd_dband(*call))
    for name, x, r in zip(NAMES, parts, got):
        assert torch.equal(x, r), name


def test_function_gradcheck_float64(rng):
    arrays, lens, _, scale = _case(rng, [6, 4], 2, 4)
    leaves = _leaves(arrays, torch.float64)
    lens = torch.from_numpy(lens)
    assert torch.autograd.gradcheck(lambda *a: TA.RelPosFlashAttention.apply(*a, lens, scale), leaves,
                                    eps=1e-6, atol=1e-6, rtol=1e-5)


def test_function_under_checkpoint_gives_the_same_gradients(rng):
    """A rematerialised block runs the Function's forward twice (the
    recompute) and its backward once; the gradients do not change."""
    arrays, lens, g, scale = _case(rng, [40, 40, 9], 2, 16)
    lens, g = torch.from_numpy(lens), torch.from_numpy(g)
    forwards, runs = [], []
    forward = TA.flash_relpos_attention_forward_lse

    def counted(*a):
        forwards.append(1)
        return forward(*a)

    for remat in (False, True):
        leaves = _leaves(arrays)
        forwards.clear()
        TA.flash_relpos_attention_forward_lse = counted
        try:
            fn = lambda *a: TA.flash_relpos_attention(*a, lens, scale)  # noqa: E731
            out = checkpoint(fn, *leaves, use_reentrant=False) if remat else fn(*leaves)
            (out * g).sum().backward()
        finally:
            TA.flash_relpos_attention_forward_lse = forward
        runs.append((len(forwards), [x.grad for x in leaves]))
    (n_plain, grads_plain), (n_remat, grads_remat) = runs
    assert (n_plain, n_remat) == (1, 2)
    for name, a, b in zip(NAMES, grads_remat, grads_plain):
        torch.testing.assert_close(a, b, rtol=0, atol=0, msg=name)


def _bf16_bar(ref):
    """``chip_smoke.bf16_bar``: one bf16 ulp at the reference's largest
    entry (2^-7 of it), never below the float32 bar 5e-4."""
    return max(2.0 ** -7 * ref.abs().max().item(), 5e-4)


def _backward_rounded_as_the_tensor_core_kernels(qu, qv, k, v, p, lengths, scale, lse, delta, g, band_shift=0):
    """The twin's recipe, rounded where the bf16 kernels round: P (dv's
    operand) and ds (the operand of dqu, dqv, dk and dp) formed in float32
    and rounded to bf16 before their products, the sums float32, each
    result rounded to bf16 once.  ``band_shift`` = 1 reads the band one
    row off in dqv's product and dp one table row off: the unskew off by
    one."""
    prob = torch.exp(TA._plain_scores(qu, qv, k, p, scale) - lse[..., None])
    prob = torch.where(TA._key_mask(lengths, qu.shape[1], qu.device), prob, 0.0)
    ds = prob * (torch.einsum("bihd,bjhd->bhij", g, v) - delta[..., None]) * scale
    prob, ds = prob.bfloat16().float(), ds.bfloat16().float()
    dbd = TR.rel_shift_adjoint(ds)

    def shifted(x):
        return torch.cat([x[band_shift:], torch.zeros_like(x[:band_shift])])

    grads = (
        torch.einsum("bhij,bjhd->bihd", ds, k),
        torch.einsum("bhil,lhd->bihd", dbd, shifted(p)),
        torch.einsum("bhij,bihd->bjhd", ds, qu),
        torch.einsum("bhij,bihd->bjhd", prob, g),
        shifted(torch.einsum("bhil,bihd->lhd", dbd, qv)),
    )
    return tuple(x.bfloat16() for x in grads)


# the gradients each bf16 tensor-core backward kernel writes
KERNEL_GRADS = {"dq": ("dqu", "dqv"), "dkv": ("dk", "dv"), "dband": ("dp",)}


def _bf16_case(rng, b=2, t=300, h=2, dh=64):
    """bf16-representable float32 inputs (qu, qv, k, v, g, p) at (b, t, h, dh),
    lengths ``t`` and 137, and the scale."""
    shapes = [(b, t, h, dh)] * 5 + [(2 * t - 1, h, dh)]
    arrays = [torch.from_numpy(rng.standard_normal(s).astype(np.float32) * 0.5).bfloat16().float() for s in shapes]
    return arrays, torch.tensor([t, 137]), dh ** -0.5


def _band_one_row_off(p):
    return torch.cat([p[1:], torch.zeros_like(p[:1])])


def test_bf16_rounding_of_the_tensor_core_kernels_fits_the_bar(rng):
    """The bf16 dq, dkv and dband kernels round P (dv's operand) and ds (the
    operand of dqu, dqv, dk and dp) to bf16 before every product that takes
    them.  Modelled on bf16 inputs at (2, 300, 2, 64) with ragged lengths,
    that rounding keeps each kernel's gradients (dq: dqu and dqv; dkv: dk
    and dv; dband: dp) within the bar of the float32 twin, so a miss on the
    card points at a kernel; the same model with the band one row off misses
    the bar: in dqv and dp where the unskew reads it, in dk and dv where the
    scores' skew does."""
    (qu, qv, k, v, g, p), lengths, scale = _bf16_case(rng)
    out, lse = TA.flash_relpos_attention_plain(qu, qv, k, v, p, lengths, scale, return_lse=True)
    ref = dict(zip(NAMES, TA.flash_relpos_attention_backward_plain(qu, qv, k, v, p, lengths, scale, out, lse, g)))
    delta = TA.attention_delta(out, g)
    got = dict(zip(NAMES, _backward_rounded_as_the_tensor_core_kernels(qu, qv, k, v, p, lengths, scale, lse, delta, g)))
    unskew_off = _backward_rounded_as_the_tensor_core_kernels(qu, qv, k, v, p, lengths, scale, lse, delta, g,
                                                              band_shift=1)
    # the scores recomputed on a band one row off
    skew_off = _backward_rounded_as_the_tensor_core_kernels(qu, qv, k, v, _band_one_row_off(p), lengths, scale, lse,
                                                            delta, g)
    for kernel, names in KERNEL_GRADS.items():
        off = dict(zip(NAMES, skew_off if kernel == "dkv" else unskew_off))
        for name in names:
            r = ref[name]
            assert r.dtype == torch.float32 and r.abs().max() > 0, (kernel, name)
            err = (got[name].float() - r).abs().max().item()
            assert err <= _bf16_bar(r), (kernel, name, err, _bf16_bar(r))
            if name != "dqu":  # dqu = ds . k reads no band row
                assert (off[name].float() - r).abs().max().item() > _bf16_bar(r), (kernel, name)


def _forward_rounded_as_the_tensor_core_kernel(qu, qv, k, v, p, lengths, scale):
    """The twin's forward, rounded where the bf16 kernel rounds: the
    unnormalised probabilities exp(s - m) rounded to bf16 before the value
    product (the TPU kernel's cast to v's type), their sum l unrounded, the
    division at the end and the output rounded to bf16 once."""
    scores = TA._plain_scores(qu, qv, k, p, scale)
    scores = scores.masked_fill(~TA._key_mask(lengths, qu.shape[1], qu.device), TA.MASK_VALUE)
    e = torch.exp(scores - scores.amax(dim=-1, keepdim=True))
    l = e.sum(dim=-1).transpose(1, 2)[..., None]  # (B, T, H, 1)
    return (torch.einsum("bhij,bjhd->bihd", e.bfloat16().float(), v) / l).bfloat16()


def test_bf16_rounding_of_the_tensor_core_forward_fits_the_bar(rng):
    """The bf16 forward kernel rounds the probabilities to bf16 before the
    value product, as the TPU kernel does.  On bf16 inputs at (2, 300, 2, 64)
    with ragged lengths, a model of that rounding and the JAX package's
    Pallas forward (interpret mode) on the same bf16 inputs both lie within
    the bar the card holds the kernel to (one bf16 ulp at the float32 twin's
    largest entry, never below 1e-4); the model with the band one row off
    misses it."""
    (qu, qv, k, v, _, p), lengths, scale = _bf16_case(rng)
    ref = TA.flash_relpos_attention_plain(qu, qv, k, v, p, lengths, scale)
    bar = max(2.0 ** -7 * ref.abs().max().item(), 1e-4)
    got = _forward_rounded_as_the_tensor_core_kernel(qu, qv, k, v, p, lengths, scale)
    jax_out = JA._flash_relpos_forward(*(jnp.asarray(x.numpy(), jnp.bfloat16) for x in (qu, qv, k, v, p)),
                                       jnp.asarray(lengths.numpy(), jnp.int32), scale, interpret=True)
    assert jax_out.dtype == jnp.bfloat16
    for name, x in (("model", got.float()), ("jax", torch.from_numpy(np.asarray(jax_out, np.float32)))):
        err = (x - ref).abs().max().item()
        assert err <= bar, (name, err, bar)
    off = _forward_rounded_as_the_tensor_core_kernel(qu, qv, k, v, _band_one_row_off(p), lengths, scale)
    assert (off.float() - ref).abs().max().item() > bar
