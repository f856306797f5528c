"""The depthwise conv's plain twin and autograd Function against the JAX
package's Pallas kernel (interpret mode on the CPU) and its jnp reference.

Tolerances: float32 outputs and dx atol 1e-5 (sums of at most 33 products of
unit-variance inputs, in the same order on both sides); dw atol 1e-5 of its
largest entry (a float32 sum over B·T rows, in another order than jnp's);
bfloat16 within 2e-2 plus one bf16 ulp (2^-7) of the float32 result's
value (one bf16 rounding of the inputs and one of the output; the port sums
products in float32, the Pallas body multiplies in bfloat16 first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu.ops.pallas.depthwise_conv import (
    depthwise_conv1d_pallas,
    depthwise_conv1d_reference,
)
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import depthwise_conv as D


def _case(rng, k, t, c, b=2):
    x = rng.standard_normal((b, t, c)).astype(np.float32)
    w = (rng.standard_normal((k, c)) * k ** -0.5).astype(np.float32)
    return x, w


@pytest.mark.parametrize("c", [32, 130])
@pytest.mark.parametrize("t", [8, 37, 235])
@pytest.mark.parametrize("k", [33, 7, 4])
def test_twin_matches_pallas_and_reference(rng, k, t, c):
    x, w = _case(rng, k, t, c)
    got = D.depthwise_conv1d(torch.from_numpy(x), torch.from_numpy(w))
    assert got.dtype == torch.float32 and got.shape == x.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(depthwise_conv1d_pallas(jnp.asarray(x), jnp.asarray(w))), atol=1e-5)
    np.testing.assert_allclose(got.numpy(), np.asarray(depthwise_conv1d_reference(jnp.asarray(x), jnp.asarray(w))), atol=1e-5)
    assert D.depthwise_conv1d_forward.launches == 0  # a CPU tensor never counts as a kernel launch


@pytest.mark.parametrize("k, t, c", [(33, 37, 130), (4, 235, 32)])
def test_twin_bfloat16_close_to_float32(rng, k, t, c):
    x, w = _case(rng, k, t, c)
    ref = D.depthwise_conv1d_plain(torch.from_numpy(x), torch.from_numpy(w))
    got = D.depthwise_conv1d(torch.from_numpy(x).bfloat16(), torch.from_numpy(w).bfloat16())
    assert got.dtype == torch.bfloat16
    torch.testing.assert_close(got.float(), ref, rtol=2.0 ** -7, atol=2e-2)


@pytest.mark.parametrize("k, t, c", [(33, 37, 130), (7, 8, 32), (4, 37, 32), (4, 235, 130)])
def test_gradients_match_jax(rng, k, t, c):
    """dx and dw of `DepthwiseConv1d` (twin path) against ``jax.grad``
    through ``depthwise_conv1d_pallas``, odd and even K."""
    x, w = _case(rng, k, t, c)
    r = rng.standard_normal(x.shape).astype(np.float32)
    gx, gw = jax.grad(lambda a, b: (depthwise_conv1d_pallas(a, b) * r).sum(), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w).requires_grad_(True)
    (D.depthwise_conv1d(tx, tw) * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(tx.grad.numpy(), np.asarray(gx), atol=1e-5)
    np.testing.assert_allclose(tw.grad.numpy(), np.asarray(gw), atol=1e-5 * np.abs(np.asarray(gw)).max())


@pytest.mark.parametrize("k", [5, 4])
def test_gradcheck_float64(k):
    gen = torch.Generator().manual_seed(k)
    x = torch.randn(2, 6, 3, dtype=torch.float64, generator=gen).requires_grad_(True)
    w = torch.randn(k, 3, dtype=torch.float64, generator=gen).requires_grad_(True)
    assert torch.autograd.gradcheck(D.DepthwiseConv1d.apply, (x, w))


@pytest.mark.parametrize("k", [33, 7, 4, 2, 1])
def test_dx_is_the_forward_with_reversed_taps_and_swapped_pads(rng, k):
    """What the card runs for dx: the forward on g with flip(w) and pad_lo =
    pad_hi equals autograd's dx through the plain twin."""
    x, w = _case(rng, k, 19, 5)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    tx, tw = torch.from_numpy(x).requires_grad_(True), torch.from_numpy(w)
    D.depthwise_conv1d_plain(tx, tw).backward(g)
    pad_hi = k - 1 - (k - 1) // 2
    torch.testing.assert_close(D.depthwise_conv1d_plain(g, tw.flip(0), pad_hi), tx.grad, rtol=0, atol=1e-5)
    torch.testing.assert_close(D.depthwise_conv1d_forward(g, tw, pad_lo=pad_hi, reverse_taps=True), tx.grad, rtol=0, atol=1e-5)


def test_weight_grad_is_one_contraction(rng):
    x, w = _case(rng, 4, 11, 3)
    g = rng.standard_normal(x.shape).astype(np.float32)
    tx, tw = torch.from_numpy(x), torch.from_numpy(w).requires_grad_(True)
    D.depthwise_conv1d_plain(tx, tw).backward(torch.from_numpy(g))
    torch.testing.assert_close(D.depthwise_conv1d_weight_grad(tx, torch.from_numpy(g), 4), tw.grad, rtol=0, atol=1e-5)


def test_wrapper_rejects_bad_arguments_and_devices():
    x = torch.zeros(2, 5, 8)
    with pytest.raises(ValueError, match="wants x"):
        D.depthwise_conv1d(x, torch.zeros(3, 4))
    with pytest.raises(ValueError, match="w is"):
        D.depthwise_conv1d(x, torch.zeros(3, 8, dtype=torch.bfloat16))
    with pytest.raises(ValueError, match="pad_lo"):
        D.depthwise_conv1d_forward(x, torch.zeros(3, 8), pad_lo=3)
    with pytest.raises(ValueError, match="unsupported device"):
        D.depthwise_conv1d(x.to("meta"), torch.zeros(3, 8, device="meta"))


def test_kernel_size_cap_is_the_kernels_shared_memory_limit():
    """The wrapper's cap is the largest K whose taps and halo fit the
    kernel's shared memory, by the constants of the CUDA source."""
    import re
    from pathlib import Path

    src = (Path(D.__file__).parents[2] / "csrc" / "depthwise_conv.cu").read_text()
    slab, tile = (int(re.search(rf"constexpr int {n} = (\d+);", src).group(1)) for n in ("kSlab", "kTileT"))
    kib = int(re.search(r"smem > (\d+) \* 1024\) return cudaErrorInvalidValue", src).group(1))
    assert (slab, tile, kib * 1024) == (D.SLAB_CHANNELS, D.TILE_ROWS, D.MAX_SHARED_BYTES)

    def shared_bytes(k):
        return 4 * slab * (k + tile + k - 1)

    assert shared_bytes(D.MAX_KERNEL_SIZE) <= kib * 1024 < shared_bytes(D.MAX_KERNEL_SIZE + 1)
    assert D.MAX_KERNEL_SIZE == 195
