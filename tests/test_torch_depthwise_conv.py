"""The depthwise conv's plain twin and autograd Function against the JAX
package's Pallas kernel (interpret mode on the CPU) and its jnp reference.

Tolerances: float32 outputs and dx atol 1e-5 (sums of at most 33 products of
unit-variance inputs, in the same order on both sides); dw atol 1e-5 of its
largest entry (a float32 sum over B·T rows, in the kernel's tile order, not
jnp's);
bfloat16 within 2e-2 plus one bf16 ulp (2^-7) of the float32 result's
value (one bf16 rounding of the inputs and one of the output; the port sums
products in float32, the Pallas body multiplies in bfloat16 first).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
import torch.nn.functional as F

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


def _source_constants() -> dict:
    import re
    from pathlib import Path

    src = (Path(D.__file__).parents[2] / "csrc" / "depthwise_conv.cu").read_text()
    names = ("kSlab", "kRows", "kMaxRowGroups", "kFixedTaps", "kMaxTaps")
    found = {n: int(re.search(rf"constexpr int {n} = (\d+);", src).group(1)) for n in names}
    found["kMaxShared"] = 1024 * int(re.search(r"constexpr size_t kMaxShared = (\d+) \* 1024;", src).group(1))
    return found


def _layout_bytes(kernel, row_groups, k, elem, fixed):
    """A block's shared memory worked out afresh from the layout the CUDA
    source describes: two halo buffers (the tile's rows and K rounded up to
    the rows a thread, 64 channels in x's type), the generic forward's
    float32 taps; for dw two buffers of the tile's rows of g and, with
    generic taps, each row group's float32 per-tap sums."""
    kp = -(-k // 8) * 8
    rows = 8 * row_groups
    if kernel == "conv":
        return 2 * (rows + kp) * 64 * elem + (0 if fixed else kp * 64 * 4)
    return 2 * (2 * rows + kp) * 64 * elem + (0 if fixed else row_groups * kp * 64 * 4)


def test_kernel_size_cap_is_the_kernels_shared_memory_limit():
    """The wrapper's cap is the largest K whose layouts (generic taps, one
    row group, float32) fit a block's shared memory in both kernels, by the
    constants of the CUDA source, and the launchers' own cap; it never falls
    below 195, the first layout's cap."""
    src = _source_constants()
    assert (src["kSlab"], src["kRows"], src["kMaxRowGroups"], src["kFixedTaps"], src["kMaxShared"]) == (
        D.SLAB_CHANNELS, D.ROWS_PER_THREAD, D.MAX_ROW_GROUPS, D.FIXED_TAPS, D.MAX_SHARED_BYTES)
    assert src["kMaxTaps"] == D.MAX_KERNEL_SIZE
    for kernel in ("conv", "dw"):
        assert D.shared_bytes(kernel, 1, D.MAX_KERNEL_SIZE, 4, False) == _layout_bytes(kernel, 1, D.MAX_KERNEL_SIZE, 4, False)
        assert _layout_bytes(kernel, 1, D.MAX_KERNEL_SIZE, 4, False) <= src["kMaxShared"]
    assert _layout_bytes("dw", 1, D.MAX_KERNEL_SIZE + 1, 4, False) > src["kMaxShared"]
    assert D.MAX_KERNEL_SIZE >= 195
    assert D.depthwise_plan(1, 1, 1, D.MAX_KERNEL_SIZE, torch.float32)["fits"]
    assert not D.depthwise_plan(1, 1, 1, D.MAX_KERNEL_SIZE + 1, torch.float32)["fits"]


@pytest.mark.parametrize("k", [33, 32, 195])
@pytest.mark.parametrize("b, t, c", [(16, 235, 512), (4, 938, 512), (16, 235, 1024), (16, 14, 512), (16, 28, 512)])
def test_plan_at_the_paths_shapes(b, t, c, k):
    """`depthwise_plan` at the main paths' shapes (both train steps, the
    Conformer-L width, the Noisy Student buckets): it fits, takes the vector
    layout (C·2 bytes a multiple of 16), keeps the taps in registers at K =
    33 alone, asks each kernel for the shared bytes its layout needs, takes
    the row groups whose tiles compute and stage the fewest rows (rows
    computed plus a quarter of the rows staged), puts as many blocks on the
    H100 as 16 warps an SM hold (never more blocks than a slab's tiles),
    and dw keeps one partial a block of a slab."""
    plan = D.depthwise_plan(b, t, c, k, torch.bfloat16)
    assert plan["fits"] and plan["vectorized"] and plan["vector_bytes"] == 16
    assert plan["fixed_taps"] == (33 if k == 33 else 0)
    assert (plan["rows_per_thread"], plan["channels_per_thread"]) == (8, 2)
    fixed = k == 33
    for kernel, prefix in (("conv", ""), ("dw", "dw_")):
        g = plan[f"{prefix}row_groups"]
        assert plan[f"{prefix}tile_rows"] == 8 * g
        assert plan[f"{prefix}smem_bytes"] == _layout_bytes(kernel, g, k, 2, fixed) <= 227 * 1024
        slabs = -(-c // 64)
        tiles = lambda rg: b * -(-t // (8 * rg))  # noqa: E731
        assert plan[f"{prefix}tiles"] == tiles(g)
        fitting = [rg for rg in (8, 4, 2, 1) if _layout_bytes(kernel, rg, k, 2, fixed) <= 227 * 1024]

        def cost(rg):  # rows computed (padding included) and a quarter of the rows staged, per batch row
            n = -(-t // (8 * rg))
            return n * 8 * rg + n * (8 * rg + -(-k // 8) * 8) / 4

        assert g in fitting and cost(g) == min(cost(rg) for rg in fitting)
        assert g == max(rg for rg in fitting if cost(rg) == cost(g))
        per_slab = plan[f"{prefix}blocks_per_slab"]
        assert per_slab == min(tiles(g), 16 // g * 132 // slabs) and plan[f"{prefix}blocks"] == per_slab * slabs
        assert plan[f"{prefix}blocks"] * g <= 16 * 132  # never more warps than the SMs hold at 16 each
    assert plan["dw_partials"] == plan["dw_blocks_per_slab"]
    assert plan["dw_scratch_bytes"] == 4 * plan["dw_partials"] * k * c
    if (t, k) in ((235, 33), (938, 33)):  # the train steps: 8 row groups, two 256-thread blocks an SM walk the tiles
        assert plan["row_groups"] == plan["dw_row_groups"] == 8 and 256 <= plan["blocks"] <= 264
        assert plan["blocks"] < plan["tiles"] * (c // 64)
    if t in (14, 28):  # a row shorter than a 64-row tile: 2 (16 rows) or 4 (32) row groups, a block a tile
        assert plan["row_groups"] == {14: 2, 28: 4}[t] and plan["blocks"] == plan["tiles"] * (c // 64) == 128


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
@pytest.mark.parametrize("c, vectorized", [(129, False), (130, False), (1, False), (128, True), (1024, True)])
def test_plan_takes_the_scalar_layout_where_16_byte_copies_do_not_fit(dtype, c, vectorized):
    """The vector layout needs rows whose bytes are a multiple of 16 and
    16-byte aligned pointers; C = 129, 130 and 1, or any misaligned view,
    take the scalar layout (element-wide copies), never another route."""
    elem = 2 if dtype == torch.bfloat16 else 4
    plan = D.depthwise_plan(2, 37, c, 33, dtype)
    assert plan["vectorized"] is vectorized and plan["vector_bytes"] == (16 if vectorized else elem)
    assert D.depthwise_plan(2, 37, c, 33, dtype, aligned=False)["vectorized"] is False
    assert plan["smem_bytes"] == _layout_bytes("conv", plan["row_groups"], 33, elem, True)


def test_plan_refuses_what_no_kernel_takes():
    with pytest.raises(ValueError, match="float32 or bfloat16"):
        D.depthwise_plan(1, 1, 1, 3, torch.float64)
    with pytest.raises(ValueError, match="empty"):
        D.depthwise_plan(1, 0, 1, 3, torch.float32)


@pytest.mark.parametrize("k, t, c, b", [(33, 37, 130, 2), (33, 235, 64, 3), (4, 37, 32, 2), (7, 8, 5, 1), (1, 5, 3, 2)])
def test_weight_grad_twin_matches_jax_grad_and_the_direct_sum(rng, k, t, c, b):
    """The dw twin (the plan's tiles dealt to its blocks, the blocks'
    partials added in block order, as the kernel sums) against ``jax.grad`` of
    ``depthwise_conv1d_pallas`` with respect to w (interpret mode) and
    against the direct sum Σ_{b,t} x_padded[b, t + i, c] · g[b, t, c] in
    float64; float32, atol 1e-5 of the largest entry."""
    x, w = _case(rng, k, t, c, b)
    g = rng.standard_normal(x.shape).astype(np.float32)
    _, gw = jax.grad(lambda a, v: (depthwise_conv1d_pallas(a, v) * g).sum(), argnums=(0, 1))(jnp.asarray(x), jnp.asarray(w))
    got = D.depthwise_conv1d_weight_grad(torch.from_numpy(x), torch.from_numpy(g), k)
    assert got.dtype == torch.float32 and got.shape == (k, c)
    assert D.depthwise_conv1d_weight_grad.launches == 0  # a CPU tensor never counts as a kernel launch
    pad_lo = (k - 1) // 2
    xp = np.pad(x.astype(np.float64), ((0, 0), (pad_lo, k - 1 - pad_lo), (0, 0)))
    direct = np.stack([(xp[:, i : i + t] * g).sum(axis=(0, 1)) for i in range(k)])
    gw = np.asarray(gw)
    np.testing.assert_allclose(got.numpy(), gw, atol=1e-5 * np.abs(gw).max())
    np.testing.assert_allclose(got.numpy(), direct, atol=1e-5 * np.abs(direct).max())


@pytest.mark.parametrize("blocks", [1, 2, 5])
@pytest.mark.parametrize("tile_rows", [8, 16, 64])
def test_weight_grad_twin_sums_tiles_of_any_size_alike(rng, tile_rows, blocks):
    """The twin's tiles and blocks are a sum order, not a different
    function: tiles of 8, 16 and 64 rows (partial last tiles, a tile past
    T) dealt to 1, 2 or 5 blocks (some taking fewer tiles than others)
    agree with the default and with pad_lo = pad_hi (the even-K split)."""
    x, w = _case(rng, 4, 37, 9, 3)
    g = torch.from_numpy(rng.standard_normal(x.shape).astype(np.float32))
    x = torch.from_numpy(x)
    blocks = min(blocks, 3 * -(-37 // tile_rows))
    ref = D.depthwise_conv1d_weight_grad_plain(x, g, 4)
    torch.testing.assert_close(D.depthwise_conv1d_weight_grad_plain(x, g, 4, tile_rows=tile_rows, blocks=blocks), ref,
                               rtol=0, atol=1e-5 * ref.abs().max().item())
    other = D.depthwise_conv1d_weight_grad_plain(x, g, 4, pad_lo=2, tile_rows=tile_rows, blocks=blocks)
    xp = F.pad(x.double(), (0, 0, 2, 1))
    direct = torch.stack([(xp[:, i : i + 37] * g.double()).sum(dim=(0, 1)) for i in range(4)])
    torch.testing.assert_close(other.double(), direct, rtol=0, atol=1e-5 * direct.abs().max().item())


def test_weight_grad_twin_keeps_float64_and_reads_bfloat16_as_float32(rng):
    x, w = _case(rng, 5, 11, 3)
    g = rng.standard_normal(x.shape).astype(np.float32)
    got64 = D.depthwise_conv1d_weight_grad(torch.from_numpy(x).double(), torch.from_numpy(g).double(), 5)
    assert got64.dtype == torch.float64
    got16 = D.depthwise_conv1d_weight_grad(torch.from_numpy(x).bfloat16(), torch.from_numpy(g).bfloat16(), 5)
    assert got16.dtype == torch.float32
    ref = D.depthwise_conv1d_weight_grad(torch.from_numpy(x).bfloat16().float(), torch.from_numpy(g).bfloat16().float(), 5)
    torch.testing.assert_close(got16, ref, rtol=0, atol=1e-6 * ref.abs().max().item())
    with pytest.raises(ValueError, match="alike"):
        D.depthwise_conv1d_weight_grad(torch.from_numpy(x), torch.from_numpy(g).double(), 5)
