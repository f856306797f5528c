"""SAME-padded depthwise 1-D convolution: kernel wrappers, plan, autograd
Function and plain twins.

Replaces the TPU kernel
`nn_conformer_for_speech_recognition_tpu/ops/pallas/depthwise_conv.py:_dw_kernel`
(``:50``, ``pallas_call`` ``:79``; called through ``depthwise_conv1d_pallas``):
x (B, T, C), w (K, C) → (B, T, C), ``out[b, t, c] = Σ_i w[i, c] · x[b, t +
i − pad_lo, c]`` with zeros outside [0, T), ``pad_lo = (K − 1) // 2`` and
``pad_hi = K − 1 − pad_lo``; and the weight half of its jnp backward
``_dw_bwd`` (``:107``), ``dw[i, c] = Σ_{b,t} x[b, t + i − pad_lo, c] ·
g[b, t, c]`` over every t in [0, T).  dx is the forward kernel on the
incoming gradient with the taps reversed and the pads swapped, as there.

The CUDA kernels (`csrc/depthwise_conv.cu`) take the data as it lies,
channels-last, with no padded copy and no transposes.  `depthwise_plan`
lays a launch out: a thread owns a channel pair and 8 consecutive rows of a
tile, a block 64 channels and 1-8 such row groups, and as many blocks as the
SMs hold walk a slab's tiles, each copying its next tile's halo in x's own
type (16-byte ``cp.async`` where C and the pointers allow it, else element
by element) while it computes the current one; at the configs' K = 33 the
taps (forward) or the per-tap sums (dw) stay in registers, so one shared
load feeds up to 16 multiply-adds; any other K up to `MAX_KERNEL_SIZE`
takes a generic build with the taps in shared memory.  dw writes one
float32 (K, 64) partial a block and a second launch adds the blocks'
partials in block order: no atomics, bit-equal from launch to launch.

Their bound on the H100 is bytes: x read once and the output written once,
7.7 MB at (16, 235, 512) in bfloat16, ~2.3 µs at 3.35 TB/s (dw reads x and
g), against 2·K float32 operations an element, ~1.9 µs at K = 33.  What
holds them is the multiply-add loop itself at 16 warps an SM (PERF.md,
section 6).  The first version was bound by one shared-memory load per
multiply-add, and its dw was an unfold of x into a (B, T, C, K) float32
tensor (254 MB a call) and an einsum.

Rounding: the TPU kernel multiplies in the inputs' type before it adds into
float32, and its backward sums in x's type; here every product and sum is
float32, so float32 agrees with the JAX package to rounding of the sum
order and bfloat16 to a bfloat16 ulp of the result.
"""

from __future__ import annotations

import functools
from typing import Optional

import torch
import torch.nn.functional as F

# the layout of csrc/depthwise_conv.cu (kSlab, kRows, kMaxRowGroups, kFixedTaps): channels a block, rows a
# thread, row groups (warps along T) a block at most, and the K whose taps stay in registers
SLAB_CHANNELS, ROWS_PER_THREAD, MAX_ROW_GROUPS, FIXED_TAPS = 64, 8, 8, 33
ROW_GROUPS = (8, 4, 2, 1)  # the row groups a launch may take, most first
MAX_SHARED_BYTES = 227 * 1024  # what a block may opt into on the H100
SMS = 132  # the H100 SXM's SMs: the plan's default where no card is asked


def _round_up(a: int, m: int) -> int:
    return -(-a // m) * m


def shared_bytes(kernel: str, row_groups: int, k: int, elem: int, fixed: bool) -> int:
    """A block's shared bytes (``kernel`` "conv" or "dw"): two halo buffers
    (the tile being read and the next one being copied), each (row groups
    · 8 + K rounded up to 8) rows of 64 channels in x's type; the forward's
    taps as float32 when they are not in registers; dw's two buffers of the
    tile's rows of g, and each row group's per-tap sums as float32 when they
    are not in registers.  `csrc/depthwise_conv.cu`'s ``shared_bytes`` is
    the same, and its launchers check it."""
    kp = _round_up(k, ROWS_PER_THREAD)
    tile = row_groups * ROWS_PER_THREAD
    halo = (tile + kp) * SLAB_CHANNELS * elem
    if kernel == "dw":
        return 2 * (halo + tile * SLAB_CHANNELS * elem) + (0 if fixed else row_groups * kp * SLAB_CHANNELS * 4)
    return 2 * halo + (0 if fixed else kp * SLAB_CHANNELS * 4)


# the largest K whose generic layouts fit one block at one row group in float32 (dw's is the larger): the
# kernels' kMaxTaps
MAX_KERNEL_SIZE = max(k for k in range(1, 1024)
                      if max(shared_bytes(kernel, 1, k, 4, False) for kernel in ("conv", "dw")) <= MAX_SHARED_BYTES)
RESIDENT_WARPS = 16  # warps a plan puts on each SM: two blocks of 8 row groups (the fixed builds' registers allow two)


def _tile_cost(t: int, k: int, row_groups: int) -> float:
    """What a batch row's tiles of ``row_groups`` cost: the rows they
    compute, padding past T included, and a quarter of the rows they stage
    (each tile's halo of K rounded up to 8 rows more); the multiply-adds
    bound the kernels, the copies run beside them."""
    rows = row_groups * ROWS_PER_THREAD
    tiles = -(-t // rows)
    return tiles * rows + tiles * (rows + _round_up(k, ROWS_PER_THREAD)) / 4


def depthwise_plan(batch: int, t: int, c: int, k: int, dtype: torch.dtype, *, aligned: bool = True,
                   sms: int = SMS) -> dict:
    """The launches of the forward (and dx) and of dw for x (batch, t, c)
    in ``dtype`` and K = ``k`` taps: two channels and `ROWS_PER_THREAD`
    rows a thread; for each kernel, of the row groups (8, 4, 2, 1) whose
    layout fits a block's shared memory, the one whose tiles cost least
    (`_tile_cost`; the most row groups on a tie), and as many blocks of a
    slab of 64 channels as the SMs hold at `RESIDENT_WARPS` each (never more
    than the slab's tiles, at least one), each walking the slab's tiles
    with that stride; the vector layout (16-byte copies and stores) where
    ``c`` times the element size is a multiple of 16 and ``aligned`` (every
    pointer 16-byte aligned), else the scalar one; the taps in registers at
    K = `FIXED_TAPS`.  dw writes one float32 (K, C) partial per block of a
    slab: ``dw_partials`` of them, ``dw_scratch_bytes`` in all, which its
    reduce adds in block order.  ``fits`` is False past
    `MAX_KERNEL_SIZE`."""
    if dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"depthwise_plan: float32 or bfloat16, got {dtype}")
    if min(batch, t, c, k) < 1:
        raise ValueError(f"depthwise_plan: empty shape (batch {batch}, t {t}, c {c}, k {k})")
    elem = 2 if dtype == torch.bfloat16 else 4
    vec = aligned and c * elem % 16 == 0
    fixed = k == FIXED_TAPS
    slabs = -(-c // SLAB_CHANNELS)
    plan = dict(rows_per_thread=ROWS_PER_THREAD, channels_per_thread=2, vectorized=vec,
                vector_bytes=16 if vec else elem, fixed_taps=FIXED_TAPS if fixed else 0,
                fits=k <= MAX_KERNEL_SIZE)
    for kernel, prefix in (("conv", ""), ("dw", "dw_")):
        fitting = [g for g in ROW_GROUPS if shared_bytes(kernel, g, k, elem, fixed) <= MAX_SHARED_BYTES] or [1]
        g = min(fitting, key=lambda g: _tile_cost(t, k, g))  # the first, most row groups, of equal costs
        tiles = batch * -(-t // (g * ROWS_PER_THREAD))
        per_slab = min(tiles, max(1, RESIDENT_WARPS // g * sms // slabs))
        plan.update({f"{prefix}row_groups": g, f"{prefix}tile_rows": g * ROWS_PER_THREAD, f"{prefix}tiles": tiles,
                     f"{prefix}blocks_per_slab": per_slab, f"{prefix}blocks": per_slab * slabs,
                     f"{prefix}smem_bytes": shared_bytes(kernel, g, k, elem, fixed)})
    plan["dw_partials"] = plan["dw_blocks_per_slab"]
    plan["dw_scratch_bytes"] = 4 * plan["dw_partials"] * k * c
    return plan


KERNELS = ("conv", "dw", "dw_reduce")  # the builds `depthwise_kernel_attributes` reads


def depthwise_kernel_attributes(kernel: str, dtype: torch.dtype, vectorized: bool, fixed_taps: int) -> dict:
    """What the card made of the build of ``kernel`` (one of `KERNELS`) for
    ``dtype``, the vector or scalar layout and ``fixed_taps`` (`FIXED_TAPS`
    or 0, the generic taps): registers a thread and local memory a thread
    (non-zero: spills or a stack frame).  Needs a CUDA device; launches
    nothing."""
    import ctypes

    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    regs, local = ctypes.c_int(0), ctypes.c_int(0)
    build.check(build.library().depthwise_kernel_attributes(
        KERNELS.index(kernel), int(dtype == torch.bfloat16), int(vectorized), fixed_taps, ctypes.byref(regs),
        ctypes.byref(local)), "depthwise_kernel_attributes")
    return dict(registers=regs.value, local_bytes=local.value)


@functools.lru_cache(maxsize=None)
def _sm_count(index: int) -> int:
    return torch.cuda.get_device_properties(index).multi_processor_count


_cached_plan = functools.lru_cache(maxsize=256)(depthwise_plan)  # a launch's plan without its ~12 µs of host time


def _launch_plan(x: torch.Tensor, k: int, *tensors: torch.Tensor) -> dict:
    batch, t, c = x.shape
    aligned = all(p.data_ptr() % 16 == 0 for p in (x, *tensors))
    plan = _cached_plan(batch, t, c, k, x.dtype, aligned=aligned, sms=_sm_count(x.device.index or 0))
    if not plan["fits"]:
        raise ValueError(f"depthwise_conv1d: kernel size {k} above {MAX_KERNEL_SIZE}")
    return plan


def _pads(k: int):
    pad_lo = (k - 1) // 2
    return pad_lo, k - 1 - pad_lo


def _sum_dtype(x: torch.Tensor) -> torch.dtype:
    """float32 for bfloat16 and float32 inputs; float64 stays float64."""
    return torch.promote_types(x.dtype, torch.float32)


def depthwise_conv1d_plain(x: torch.Tensor, w: torch.Tensor, pad_lo: Optional[int] = None) -> torch.Tensor:
    """x (B, T, C), w (K, C) → (B, T, C) in x's dtype, plain PyTorch: K
    shifted multiply-adds in float32 (float64 for float64 inputs), the
    kernel's arithmetic in the kernel's order.  ``pad_lo`` zeros stand before the sequence (SAME
    padding by default) and ``K − 1 − pad_lo`` after it."""
    k, t = w.shape[0], x.shape[1]
    if pad_lo is None:
        pad_lo = _pads(k)[0]
    acc = _sum_dtype(x)
    xp = F.pad(x.to(acc), (0, 0, pad_lo, k - 1 - pad_lo))
    out = torch.zeros(x.shape, dtype=acc, device=x.device)
    for i in range(k):
        out += xp[:, i : i + t] * w[i].to(acc)
    return out.to(x.dtype)


def _check(x: torch.Tensor, w: torch.Tensor, pad_lo: Optional[int]) -> int:
    if x.dim() != 3 or w.dim() != 2 or w.shape[1] != x.shape[2]:
        raise ValueError(f"depthwise_conv1d wants x (B, T, C) and w (K, C), got {tuple(x.shape)} and {tuple(w.shape)}")
    if w.dtype != x.dtype or w.device != x.device:
        raise ValueError(f"depthwise_conv1d: w is {w.dtype} on {w.device}, x is {x.dtype} on {x.device}")
    k = w.shape[0]
    pad_lo = _pads(k)[0] if pad_lo is None else pad_lo
    if not 0 <= pad_lo < k:
        raise ValueError(f"depthwise_conv1d: pad_lo {pad_lo} outside [0, {k})")
    return pad_lo


def _check_cuda(x: torch.Tensor) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"depthwise_conv1d: unsupported device {x.device}")
    if x.dtype not in (torch.float32, torch.bfloat16):
        raise ValueError(f"depthwise_conv1d wants float32 or bfloat16, got {x.dtype}")
    if x.shape[0] > 65535:
        raise ValueError(f"depthwise_conv1d: batch {x.shape[0]} above 65535")


def depthwise_conv1d_forward(
    x: torch.Tensor, w: torch.Tensor, pad_lo: Optional[int] = None, reverse_taps: bool = False
) -> torch.Tensor:
    """The convolution without an autograd graph: the kernel for CUDA
    tensors, the plain twin for CPU ones.  ``reverse_taps`` reads w from its
    last tap to its first (with ``pad_lo = K − 1 − (K − 1) // 2`` that is the
    gradient with respect to x)."""
    pad_lo = _check(x, w, pad_lo)
    k = w.shape[0]
    if x.device.type == "cpu":
        return depthwise_conv1d_plain(x, w.flip(0) if reverse_taps else w, pad_lo)
    _check_cuda(x)
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    x, w = x.contiguous(), w.contiguous()
    out = torch.empty_like(x)
    if out.numel() == 0:
        return out
    batch, t, c = x.shape
    plan = _launch_plan(x, k, w, out)
    err = build.library().depthwise_conv_fwd(
        x.data_ptr(), w.data_ptr(), out.data_ptr(), batch, t, c, k, pad_lo, int(reverse_taps),
        int(x.dtype == torch.bfloat16), plan["row_groups"], plan["fixed_taps"], int(plan["vectorized"]),
        plan["blocks_per_slab"], plan["smem_bytes"], build.stream_of(x),
    )
    build.check(err, "depthwise_conv")
    depthwise_conv1d_forward.launches += 1
    return out


depthwise_conv1d_forward.launches = 0


def depthwise_conv1d_weight_grad_plain(x: torch.Tensor, g: torch.Tensor, k: int, pad_lo: Optional[int] = None,
                                       tile_rows: Optional[int] = None, blocks: Optional[int] = None) -> torch.Tensor:
    """dw (K, C) = Σ_{b,t} x[b, t + i − pad_lo, c] · g[b, t, c], float32
    (float64 for float64 inputs), summed as the kernel sums: the rows cut
    into tiles of ``tile_rows`` (a batch row's tiles in order, then the next
    row's), tile j summed into the partial of block j mod ``blocks``, the
    partials added in block order (by default the plan's tiles and blocks).
    No window tensor: K shifted products of (B, T, C)."""
    b, t, c = x.shape
    pad_lo = _pads(k)[0] if pad_lo is None else pad_lo
    if tile_rows is None or blocks is None:
        plan_dtype = torch.bfloat16 if x.dtype == torch.bfloat16 else torch.float32
        sms = _sm_count(x.device.index or 0) if x.device.type == "cuda" else SMS
        plan = depthwise_plan(b, t, c, k, plan_dtype, sms=sms)
        tile_rows = plan["dw_tile_rows"] if tile_rows is None else tile_rows
        blocks = plan["dw_blocks_per_slab"] if blocks is None else blocks
    acc = _sum_dtype(x)
    per_row = -(-t // tile_rows)
    rounds = -(-b * per_row // blocks)  # tiles a block takes at most
    xp, gf = F.pad(x.to(acc), (0, 0, pad_lo, k - 1 - pad_lo)), g.to(acc)
    part = torch.empty(k, blocks, c, dtype=acc, device=x.device)
    for i in range(k):
        prod = F.pad(xp[:, i : i + t] * gf, (0, 0, 0, per_row * tile_rows - t))  # zero rows fill the last tile
        tiles = prod.view(b * per_row, tile_rows, c).sum(dim=1)
        tiles = F.pad(tiles, (0, 0, 0, rounds * blocks - b * per_row))  # tile j at [j // blocks, j % blocks]
        part[i] = tiles.view(rounds, blocks, c).sum(dim=0)
    dw = part[:, 0].clone()
    for block in range(1, blocks):
        dw += part[:, block]
    return dw


def depthwise_conv1d_weight_grad(x: torch.Tensor, g: torch.Tensor, k: int, pad_lo: Optional[int] = None) -> torch.Tensor:
    """dw (K, C) of the convolution of x (B, T, C) with K taps, against the
    incoming gradient g (B, T, C): float32 (float64 for float64 inputs).
    The kernel and its block-order reduce for CUDA tensors, the plain twin
    for CPU ones."""
    if x.dim() != 3 or g.shape != x.shape or g.dtype != x.dtype or g.device != x.device:
        raise ValueError(f"depthwise_conv1d dw wants x and g alike (B, T, C), got {tuple(x.shape)} {x.dtype} and "
                         f"{tuple(g.shape)} {g.dtype}")
    pad_lo = _pads(k)[0] if pad_lo is None else pad_lo
    if not 0 <= pad_lo < k:
        raise ValueError(f"depthwise_conv1d: pad_lo {pad_lo} outside [0, {k})")
    if x.device.type == "cpu":
        return depthwise_conv1d_weight_grad_plain(x, g, k, pad_lo)
    _check_cuda(x)
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    batch, t, c = x.shape
    if x.numel() == 0:
        return torch.zeros(k, c, device=x.device, dtype=torch.float32)
    x, g = x.contiguous(), g.contiguous()
    plan = _launch_plan(x, k, g)
    part = torch.empty(plan["dw_partials"], k, c, device=x.device, dtype=torch.float32)
    dw = torch.empty(k, c, device=x.device, dtype=torch.float32)
    err = build.library().depthwise_conv_dw(
        x.data_ptr(), g.data_ptr(), part.data_ptr(), dw.data_ptr(), batch, t, c, k, pad_lo,
        int(x.dtype == torch.bfloat16), plan["dw_row_groups"], plan["fixed_taps"], int(plan["vectorized"]),
        plan["dw_blocks_per_slab"], plan["dw_smem_bytes"], build.stream_of(x),
    )
    build.check(err, "depthwise_conv dw")
    depthwise_conv1d_weight_grad.launches += 1
    return dw


depthwise_conv1d_weight_grad.launches = 0


class DepthwiseConv1d(torch.autograd.Function):
    """``depthwise_conv1d_forward`` with its gradients: dx by the same
    forward (the kernel on CUDA) on the incoming gradient with the taps
    reversed and the pads swapped, dw by `depthwise_conv1d_weight_grad`
    (the dw kernel on CUDA)."""

    @staticmethod
    def forward(ctx, x, w):
        ctx.save_for_backward(x, w)
        return depthwise_conv1d_forward(x, w)

    @staticmethod
    def backward(ctx, g):
        x, w = ctx.saved_tensors
        k = w.shape[0]
        g = g.contiguous()
        dx = dw = None
        if ctx.needs_input_grad[0]:
            dx = depthwise_conv1d_forward(g, w, pad_lo=_pads(k)[1], reverse_taps=True)
        if ctx.needs_input_grad[1]:
            dw = depthwise_conv1d_weight_grad(x, g, k).to(w.dtype)
        return dx, dw


def depthwise_conv1d(x: torch.Tensor, w: torch.Tensor) -> torch.Tensor:
    """x (B, T, C), w (K, C) → (B, T, C), SAME padding, in x's dtype.  The
    kernel for CUDA tensors, the plain twin for CPU ones; differentiable in
    both through `DepthwiseConv1d`."""
    if torch.is_grad_enabled() and (x.requires_grad or w.requires_grad):
        return DepthwiseConv1d.apply(x, w)
    return depthwise_conv1d_forward(x, w)
