"""The LSTM recurrence, forward and backward: kernel wrappers, plain twins
and the autograd Function that joins them.

Replaces the TPU kernels
`nn_conformer_for_speech_recognition_tpu/ops/pallas/lstm.py:_fwd_kernel`
(`lstm_forward`) and `_bwd_kernel` (`lstm_backward` for the BPTT
recurrence, `lstm_weight_grad` for dW_hh), joined by ``_lstm_seq``'s
``custom_vjp`` there and by `LSTMSequence` here.  Gate math matches flax's
LSTMCell (i, f, g, o order); rows freeze once t ≥ length, so padded steps
emit the carried h and the reverse direction starts at each row's own
len-1.  The input projection x·W_ih + b and its gradient stay torch ops
outside, as they are XLA outside the ``custom_vjp`` in the JAX package.

The recurrences take one or more directions (a BiLSTM's two) that share
the lengths, and run them in one launch.  Two routes, chosen by shape before
the launch (`route`):
- the cluster route (H up to 385 on an H100: Conformer-S and -M's H = 320;
  `csrc/lstm.cu`, whose `cluster_plan` owns the layout):
  `lstm_forward_cluster` and `lstm_backward_cluster`.  W_hh is split by
  hidden unit over the shared memory of a 16-CTA thread-block cluster, one
  cluster per direction and 16-row batch tile; each step exchanges h
  (forward) or each unit's partial dh (backward) through distributed shared
  memory and one cluster barrier.
- the grid route (every H past it up to 1024, Conformer-L's 640 among them;
  `csrc/lstm_grid.cu`, laid out by `grid_plan`): `lstm_forward_grid` and
  `lstm_backward_grid`.  W_hh is split by hidden unit over the shared memory
  of one cooperative grid, one CTA an SM (64 a direction at H = 640, both
  directions in one launch); each step exchanges h or the partial dh
  through L2 and meets at one grid barrier of the direction's CTAs.  A
  launch the card cannot hold resident at once is refused and raises.
Either way W_hh is read from memory once per launch, not once per step.
Either way dW_hh = Σ_t h_prevᵀ·dgates_t, which the TPU kernel accumulates
inside its recurrence, is hoisted out of it into one product over all B·T
rows on the tensor cores (`lstm_weight_grad`: TF32 with the 3×TF32 split,
float32 accumulation), split over the rows into slices whose float32
partials a second kernel sums in slice order: no atomics, bit-equal from run
to run.  Each route's wrapper counts its launches (``wrapper.launches``);
one launch serves every direction of the call, except where `grid_plan`
gives one direction a launch (on an H100 past H = 836 at B = 16, past 901
at B = 4).

What bounds the recurrences on the H100: the chain of T dependent steps,
each a (B × H)·(H × 4H) product, so the latency of one step: one CTA's
share of the product on the CUDA cores, the cell update and one exchange
and barrier.
"""

from __future__ import annotations

import ctypes
import functools
from typing import List, Optional, Sequence, Tuple

import torch


def lstm_forward_plain(
    xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, reverse: bool = False
) -> Tuple[torch.Tensor, torch.Tensor, torch.Tensor]:
    """Plain PyTorch twin of the forward kernel: (B, T, 4H) float32 xw,
    (H, 4H) w_hh, (B,) lengths → h and c (B, T, H) and the post-activation
    gates (B, T, 4H), which are 0 on padded steps."""
    b, t, h4 = xw.shape
    hx = xw.new_zeros(b, h4 // 4)
    cx = xw.new_zeros(b, h4 // 4)
    lengths = lengths.to(xw.device)
    hs, cs, gs = [None] * t, [None] * t, [None] * t
    for ti in (range(t - 1, -1, -1) if reverse else range(t)):
        i, f, g, o = (xw[:, ti] + hx @ w_hh).chunk(4, dim=-1)
        i, f, g, o = torch.sigmoid(i), torch.sigmoid(f), torch.tanh(g), torch.sigmoid(o)
        c_new = f * cx + i * g
        h_new = o * torch.tanh(c_new)
        active = (ti < lengths)[:, None]
        hx = torch.where(active, h_new, hx)
        cx = torch.where(active, c_new, cx)
        hs[ti], cs[ti] = hx, cx
        gs[ti] = torch.where(active, torch.cat([i, f, g, o], dim=-1), 0.0)
    return torch.stack(hs, dim=1), torch.stack(cs, dim=1), torch.stack(gs, dim=1)


def lstm_plain(
    xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, reverse: bool = False
) -> torch.Tensor:
    """Plain PyTorch LSTM direction, (B, T, H) hidden states; differentiates
    through autograd (the model's plain path)."""
    return lstm_forward_plain(xw, w_hh, lengths, reverse)[0]


def _previous_in_sequence(x: torch.Tensor, reverse: bool) -> torch.Tensor:
    """x at the previous step in sequence order along T (t+1 when reverse),
    0 at the sequence start."""
    zero = torch.zeros_like(x[:, :1])
    return torch.cat([x[:, 1:], zero], dim=1) if reverse else torch.cat([zero, x[:, :-1]], dim=1)


def lstm_backward_plain(
    gout: torch.Tensor,
    gates: torch.Tensor,
    c: torch.Tensor,
    w_hh: torch.Tensor,
    lengths: torch.Tensor,
    reverse: bool = False,
) -> torch.Tensor:
    """Explicit BPTT, twin of the backward recurrence kernel: upstream
    dL/dh (B, T, H) and the forward's saved gates and c → dxw (B, T, 4H),
    the gradient of the pre-activation gates (0 on padded steps)."""
    b, t, hidden = gout.shape
    lengths = lengths.to(gout.device)
    c_prev = _previous_in_sequence(c, reverse)
    dh = gout.new_zeros(b, hidden)
    dc = gout.new_zeros(b, hidden)
    dxw = [None] * t
    for ti in (range(t) if reverse else range(t - 1, -1, -1)):
        i, f, g, o = gates[:, ti].chunk(4, dim=-1)
        th = torch.tanh(c[:, ti])
        dh_tot = dh + gout[:, ti]
        d_o = dh_tot * th * o * (1.0 - o)
        dct = dc + dh_tot * o * (1.0 - th * th)
        d_i = dct * g * i * (1.0 - i)
        d_f = dct * c_prev[:, ti] * f * (1.0 - f)
        d_g = dct * i * (1.0 - g * g)
        active = (ti < lengths)[:, None]
        dgates = torch.where(active, torch.cat([d_i, d_f, d_g, d_o], dim=-1), 0.0)
        dxw[ti] = dgates
        # a padded step carries h and c: their cotangents pass through
        dh = torch.where(active, dgates @ w_hh.t(), dh_tot)
        dc = torch.where(active, dct * f, dc)
    return torch.stack(dxw, dim=1)


def lstm_weight_grad_plain(h: torch.Tensor, dxw: torch.Tensor, reverse: bool = False) -> torch.Tensor:
    """dW_hh (H, 4H) = Σ_{b,t} h_prev[b, t]ᵀ · dxw[b, t], twin of the GEMM kernel."""
    return torch.einsum("bth,btg->hg", _previous_in_sequence(h, reverse), dxw)


CLUSTER_UNPLACEABLE = -2  # csrc/lstm.cu::kClusterUnplaceable
GRID_NOT_CO_RESIDENT = -3  # csrc/lstm_grid.cu::kNotCoResident
# csrc/lstm_grid.cu's constants: threads a CTA, the backward's dgates column stride, the largest H
GRID_THREADS, GRID_LD_DG, GRID_MAX_HIDDEN = 256, 20, 1024
GRID_TILE_ROWS = (16, 8, 4)  # the rows a grid tile may hold, most first


def _lengths_i32(lengths: torch.Tensor, b: int, device: torch.device) -> torch.Tensor:
    if lengths.shape != (b,):
        raise ValueError("lstm: lengths must be (B,)")
    return lengths.to(device=device, dtype=torch.int32).contiguous()


def _check_hidden(w_hh: torch.Tensor, h4: int, what: str) -> int:
    hidden = h4 // 4
    if (w_hh.shape != (hidden, h4) or h4 % 4 or not 1 <= hidden <= GRID_MAX_HIDDEN
            or w_hh.dtype != torch.float32):
        raise ValueError(f"{what}: w_hh must be (H, 4H) float32 with H <= {GRID_MAX_HIDDEN}, got {tuple(w_hh.shape)}")
    return hidden


def _check_cuda(x: torch.Tensor, what: str) -> None:
    if x.device.type != "cuda":
        raise ValueError(f"{what}: unsupported device {x.device}")


def _check_directions(what: str, *per_direction) -> int:
    """The count of directions, 1 or 2, the same in every per-direction list."""
    n = len(per_direction[0])
    if not 1 <= n <= 2 or any(len(x) != n for x in per_direction):
        raise ValueError(f"{what}: one or two directions, each with every operand")
    return n


def _pair(tensors) -> list:
    """The data pointers of one or two directions' tensors, None for a
    missing one (a second direction, or c and gates of the inference variant)."""
    ptrs = [None if x is None else x.data_ptr() for x in tensors]
    return ptrs + [None] * (2 - len(ptrs))


def _flags(reverse) -> list:
    return [int(r) for r in reverse] + [0] * (2 - len(reverse))


def _check_launch(err: int, kernel: str, what: str = "") -> None:
    """Raises for a launch the C entry refused or that failed; ``what``
    names the shape and plan of a grid launch."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    if err == CLUSTER_UNPLACEABLE:
        raise RuntimeError(f"{kernel}: no thread-block cluster of 16 CTAs with this shared memory can be placed "
                           "on the device")
    if err == GRID_NOT_CO_RESIDENT:
        raise RuntimeError(f"{kernel}: the cooperative grid for {what} cannot be resident on the device at once; "
                           "the launch was refused")
    build.check(err, kernel)


@functools.lru_cache(maxsize=None)
def smem_optin(device_index: int) -> int:
    """The shared memory, in bytes, a block may opt in to on the device."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    out = ctypes.c_int()
    build.check(build.library().lstm_smem_optin(device_index, ctypes.byref(out)), "lstm_smem_optin")
    return out.value


def cluster_plan(batch: int, hidden: int, max_smem: int) -> Tuple[bool, int, int, int]:
    """(fits, CTAs per cluster, batch rows per cluster, shared bytes per
    CTA) of the cluster route at (batch, hidden) on a device whose blocks may
    have ``max_smem`` bytes of shared memory, as
    `csrc/lstm.cu::lstm_cluster_plan`, which owns the layout, works it out.
    Past ``fits`` the grid route runs."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    fits, cluster, rows, smem = (ctypes.c_int() for _ in range(4))
    outs = map(ctypes.byref, (fits, cluster, rows, smem))
    build.check(build.library().lstm_cluster_plan(batch, hidden, max_smem, *outs), "lstm_cluster_plan")
    return bool(fits.value), cluster.value, rows.value, smem.value


def grid_layout(hidden: int, ctas: int, rows: int) -> dict:
    """One grid CTA's shared memory, as `csrc/lstm_grid.cu::grid_layout`
    lays it out for ``ctas`` CTAs a direction and tiles of ``rows`` batch
    rows: ``units`` hidden units a CTA and their 4·units gate columns; the
    forward's floats (W_hh's slice [H][cols], h [H][rows], the partial
    gates of `kslices` slices of K, each of 256 threads a column quad), the
    backward's (W_hh's slice [H][cols + 1], dgates [cols][20], every
    sender's partial dh of this CTA's units [ctas][rows][units]), and the
    exchange buffers' floats a direction (double-buffered).  The launchers
    work out the same layout and refuse a plan's shared bytes or an exchange
    buffer of another size than theirs, so the two cannot drift apart
    unseen."""
    units = -(-hidden // ctas)
    cols = 4 * units
    kslices = max(1, GRID_THREADS // units)
    fwd = hidden * cols + hidden * rows + kslices * rows * cols
    bwd = (hidden * (cols + 1) + 3) // 4 * 4 + cols * GRID_LD_DG + ctas * rows * units
    return dict(units=units, fwd_floats=fwd, bwd_floats=bwd,
                fwd_exchange=2 * hidden * rows, bwd_exchange=2 * ctas * ctas * rows * units)


def grid_plan(batch: int, hidden: int, sms: int, max_smem: int) -> dict:
    """The grid route's launch at (batch, hidden) on a card of ``sms`` SMs
    whose blocks may have ``max_smem`` bytes of shared memory: ``ctas`` a
    direction (one an SM: at most ``sms`` // directions, each holding
    ``units`` hidden units), ``rows`` a tile (at most 16, 8 or 4, the batch's
    rows rounded up to 4 where fewer), ``directions`` a launch (2 or 1), the
    shared bytes a CTA (the larger of the forward's and the backward's
    `grid_layout`) and ``fits``.  Of the layouts that fit, the one that walks a BiLSTM's
    chain the fewest times (tiles a launch × launches for two directions),
    both directions in one launch where that ties.  Conformer-L's H = 640
    takes 64 CTAs of 10 units a direction, both directions in one launch,
    tiles of 16 rows at B = 16 and of 4 at B = 4, on an H100's 132 SMs and
    232,448 bytes.  The launchers check ctas, units, rows, the shared bytes
    and the exchange buffer's floats against their own layout; the card
    checks that the grid can be resident at once."""
    best, refused = None, dict(fits=False)
    if not 1 <= hidden <= GRID_MAX_HIDDEN or batch < 1:
        return refused
    for directions in (2, 1):
        if sms // directions < 1:
            continue
        units = -(-hidden // (sms // directions))
        ctas = -(-hidden // units)
        for cap in GRID_TILE_ROWS:
            rows = 4 * -(-min(batch, cap) // 4)
            layout = grid_layout(hidden, ctas, rows)
            plan = dict(fits=True, ctas=ctas, units=units, rows=rows, directions=directions,
                        smem_bytes=4 * max(layout["fwd_floats"], layout["bwd_floats"]))
            if plan["smem_bytes"] > max_smem or rows * units > GRID_THREADS:
                refused = {**plan, "fits": False}
                continue
            passes = -(-batch // rows) * (2 // directions)
            if best is None or passes < best[0]:
                best = (passes, plan)
    return best[1] if best else refused


def route(batch: int, hidden: int, device: torch.device) -> Tuple[str, Optional[dict]]:
    """The route of the recurrences at (batch, hidden) on ``device``:
    ("cluster", None) where `cluster_plan` fits, else ("grid", `grid_plan`);
    raises where neither does."""
    index = device.index if device.index is not None else torch.cuda.current_device()
    optin = smem_optin(index)
    if cluster_plan(batch, hidden, optin)[0]:
        return "cluster", None
    plan = grid_plan(batch, hidden, torch.cuda.get_device_properties(index).multi_processor_count, optin)
    if not plan["fits"]:
        raise ValueError(f"lstm: (B, H) = ({batch}, {hidden}) fits neither the cluster nor the grid route: {plan}")
    return "grid", plan


def lstm_forward_cluster(xws, w_hhs, lengths, reverse, save: bool) -> List[Tuple[torch.Tensor, ...]]:
    """The cluster forward: one launch for every direction (contiguous
    float32 CUDA tensors, int32 lengths; `lstm_forward_directions` checks
    them) → per direction (h, c, gates), c and gates None without ``save``."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    b, t, h4 = xws[0].shape
    hs = [torch.empty(b, t, h4 // 4, device=xws[0].device, dtype=torch.float32) for _ in xws]
    cs = [torch.empty_like(h) if save else None for h in hs]
    gates = [torch.empty_like(xw) if save else None for xw in xws]
    err = build.library().lstm_fwd_cluster(
        *_pair(xws), *_pair(w_hhs), lengths.data_ptr(), *_pair(hs), *_pair(cs), *_pair(gates), len(xws),
        *_flags(reverse), b, t, h4 // 4, build.stream_of(xws[0]),
    )
    _check_launch(err, "lstm_fwd_cluster")
    lstm_forward_cluster.launches += 1
    return list(zip(hs, cs, gates))


def _plan_args(plan: dict) -> tuple:
    return plan["ctas"], plan["units"], plan["rows"], plan["smem_bytes"]


def lstm_forward_grid(xws, w_hhs, lengths, reverse, save: bool, plan: dict) -> List[Tuple[torch.Tensor, ...]]:
    """The grid forward under ``plan`` (`grid_plan`'s): one cooperative
    launch for every ``plan['directions']`` directions; operands and result
    as `lstm_forward_cluster`'s.  Raises `RuntimeError` where the card
    cannot hold the grid resident (the launch is refused, nothing runs)."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    b, t, h4 = xws[0].shape
    hidden, dev = h4 // 4, xws[0].device
    per = plan["directions"]
    exchange_floats = grid_layout(hidden, plan["ctas"], plan["rows"])["fwd_exchange"]
    outs = []
    for i in range(0, len(xws), per):
        part, rev = xws[i:i + per], reverse[i:i + per]
        hs = [torch.empty(b, t, hidden, device=dev, dtype=torch.float32) for _ in part]
        cs = [torch.empty_like(h) if save else None for h in hs]
        gates = [torch.empty_like(xw) if save else None for xw in part]
        exchange = torch.empty(len(part) * exchange_floats, device=dev, dtype=torch.float32)
        counters = torch.zeros(len(part), device=dev, dtype=torch.int32)
        err = build.library().lstm_fwd_grid(
            *_pair(part), *_pair(w_hhs[i:i + per]), lengths.data_ptr(), *_pair(hs), *_pair(cs), *_pair(gates),
            exchange.data_ptr(), counters.data_ptr(), len(part), *_flags(rev), b, t, hidden, *_plan_args(plan),
            exchange.numel(), build.stream_of(xws[0]),
        )
        _check_launch(err, "lstm_fwd_grid", f"(B, T, H) = {(b, t, hidden)} ({plan})")
        lstm_forward_grid.launches += 1
        outs += zip(hs, cs, gates)
    return outs


def lstm_forward_directions(
    xws: Sequence[torch.Tensor], w_hhs: Sequence[torch.Tensor], lengths: torch.Tensor, reverse: Sequence[bool],
    *, save: bool = False,
) -> List[Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]]:
    """One or two LSTM directions over one padded batch (a BiLSTM's forward
    and reverse), each its own (B, T, 4H) float32 xw and (H, 4H) w_hh →
    per direction (h, c, gates): (B, T, H) float32 hidden states, and with
    ``save`` the cell states and the post-activation gates the backward
    needs (else None).  For CUDA tensors one launch of the cluster kernel,
    or past the cluster's shared memory of the grid kernel, runs every
    direction (`route`); CPU tensors run the plain twin."""
    _check_directions("lstm_forward", xws, w_hhs, reverse)
    if xws[0].device.type == "cpu":
        outs = [lstm_forward_plain(xw, w, lengths, r) for xw, w, r in zip(xws, w_hhs, reverse)]
        return [out if save else (out[0], None, None) for out in outs]
    _check_cuda(xws[0], "lstm_forward")
    b, t, h4 = xws[0].shape
    if any(xw.shape != (b, t, h4) or xw.dtype != torch.float32 or xw.device != xws[0].device for xw in xws):
        raise ValueError("lstm_forward: every direction's xw must be (B, T, 4H) float32 on one device")
    for w in w_hhs:
        hidden = _check_hidden(w, h4, "lstm_forward")
    xws = [xw.contiguous() for xw in xws]
    w_hhs = [w.to(xws[0].device).contiguous() for w in w_hhs]
    lengths = _lengths_i32(lengths, b, xws[0].device)
    kind, plan = route(b, hidden, xws[0].device)
    if kind == "cluster":
        return lstm_forward_cluster(xws, w_hhs, lengths, reverse, save)
    return lstm_forward_grid(xws, w_hhs, lengths, reverse, save, plan)


def lstm_forward(
    xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, *, reverse: bool = False, save: bool = False,
) -> Tuple[torch.Tensor, Optional[torch.Tensor], Optional[torch.Tensor]]:
    """One LSTM direction: `lstm_forward_directions` with one direction."""
    return lstm_forward_directions([xw], [w_hh], lengths, [reverse], save=save)[0]


def lstm_backward_cluster(gouts, gates, cs, w_hhs, lengths, reverse) -> List[torch.Tensor]:
    """The cluster BPTT: one launch for every direction, W_hh as it is (each
    CTA reads its slice by rows) → per direction dxw; checked operands as
    `lstm_forward_cluster`'s."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    b, t, h4 = gates[0].shape
    dxws = [torch.empty_like(g) for g in gates]
    err = build.library().lstm_bwd_cluster(
        *_pair(gouts), *_pair(gates), *_pair(cs), *_pair(w_hhs), lengths.data_ptr(), *_pair(dxws), len(gouts),
        *_flags(reverse), b, t, h4 // 4, build.stream_of(gouts[0]),
    )
    _check_launch(err, "lstm_bwd_cluster")
    lstm_backward_cluster.launches += 1
    return dxws


def lstm_backward_grid(gouts, gates, cs, w_hhs, lengths, reverse, plan: dict) -> List[torch.Tensor]:
    """The grid BPTT under ``plan``: one cooperative launch for every
    ``plan['directions']`` directions, W_hh as it is (each CTA reads its
    slice by rows) → per direction dxw; operands as `lstm_forward_cluster`'s,
    refusals as `lstm_forward_grid`'s."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    b, t, h4 = gates[0].shape
    hidden, dev = h4 // 4, gates[0].device
    per = plan["directions"]
    exchange_floats = grid_layout(hidden, plan["ctas"], plan["rows"])["bwd_exchange"]
    dxws = []
    for i in range(0, len(gouts), per):
        sl = slice(i, i + per)
        out = [torch.empty_like(g) for g in gates[sl]]
        exchange = torch.empty(len(out) * exchange_floats, device=dev, dtype=torch.float32)
        counters = torch.zeros(len(out), device=dev, dtype=torch.int32)
        err = build.library().lstm_bwd_grid(
            *_pair(gouts[sl]), *_pair(gates[sl]), *_pair(cs[sl]), *_pair(w_hhs[sl]), lengths.data_ptr(), *_pair(out),
            exchange.data_ptr(), counters.data_ptr(), len(out), *_flags(reverse[sl]), b, t, hidden,
            *_plan_args(plan), exchange.numel(), build.stream_of(gates[0]),
        )
        _check_launch(err, "lstm_bwd_grid", f"(B, T, H) = {(b, t, hidden)} ({plan})")
        lstm_backward_grid.launches += 1
        dxws += out
    return dxws


def lstm_backward_directions(
    gouts: Sequence[torch.Tensor],
    gates: Sequence[torch.Tensor],
    cs: Sequence[torch.Tensor],
    w_hhs: Sequence[torch.Tensor],
    lengths: torch.Tensor,
    reverse: Sequence[bool],
) -> List[torch.Tensor]:
    """BPTT recurrence of one or two directions → per direction dxw (B, T,
    4H) float32, from the upstream dL/dh (B, T, H) and the forward's saved
    gates and c.  One cluster launch for CUDA tensors (one grid launch past
    the cluster's H; `route`), the plain twin for CPU ones."""
    _check_directions("lstm_backward", gouts, gates, cs, w_hhs, reverse)
    if gouts[0].device.type == "cpu":
        return [lstm_backward_plain(*args) for args in zip(gouts, gates, cs, w_hhs, [lengths] * len(gouts), reverse)]
    _check_cuda(gouts[0], "lstm_backward")
    b, t, h4 = gates[0].shape
    for w in w_hhs:
        hidden = _check_hidden(w, h4, "lstm_backward")
    for name, xs, shape in (("gout", gouts, (b, t, hidden)), ("c", cs, (b, t, hidden)), ("gates", gates, (b, t, h4))):
        for x in xs:
            if x.shape != shape or x.dtype != torch.float32 or x.device != gouts[0].device:
                raise ValueError(f"lstm_backward: {name} must be {shape} float32, got {tuple(x.shape)} {x.dtype}")
    gouts, gates, cs = ([x.contiguous() for x in xs] for xs in (gouts, gates, cs))
    w_hhs = [w.to(gouts[0].device).contiguous() for w in w_hhs]
    lengths = _lengths_i32(lengths, b, gouts[0].device)
    kind, plan = route(b, hidden, gouts[0].device)
    if kind == "cluster":
        return lstm_backward_cluster(gouts, gates, cs, w_hhs, lengths, reverse)
    return lstm_backward_grid(gouts, gates, cs, w_hhs, lengths, reverse, plan)


def lstm_backward(
    gout: torch.Tensor,
    gates: torch.Tensor,
    c: torch.Tensor,
    w_hh: torch.Tensor,
    lengths: torch.Tensor,
    *,
    reverse: bool = False,
) -> torch.Tensor:
    """BPTT of one direction: `lstm_backward_directions` with one direction."""
    return lstm_backward_directions([gout], [gates], [c], [w_hh], lengths, [reverse])[0]


def dwhh_plan(rows: int, hidden: int, sms: int) -> Tuple[int, int]:
    """(slices, rows per slice) of the dW_hh kernel's split over the B·T
    rows on a card of ``sms`` SMs, as `csrc/lstm.cu::lstm_dwhh_plan`, which
    owns the kernel's tile shape, picks it."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    slices, per = ctypes.c_int(), ctypes.c_int()
    build.check(build.library().lstm_dwhh_plan(rows, hidden, sms, ctypes.byref(slices), ctypes.byref(per)),
                "lstm_dwhh_plan")
    return slices.value, per.value


def _aligned(x: torch.Tensor) -> torch.Tensor:
    """x contiguous on a 16-byte boundary, as the kernel's 16-byte copies need."""
    x = x.contiguous()
    return x if x.data_ptr() % 16 == 0 else x.clone()


def lstm_weight_grad(h: torch.Tensor, dxw: torch.Tensor, *, reverse: bool = False) -> torch.Tensor:
    """dW_hh (H, 4H) from the forward's h (B, T, H) and dxw (B, T, 4H).
    The tensor-core kernel for CUDA tensors (one call: the split product
    and, past one slice, the sum of the slices), the plain twin for CPU
    ones."""
    if h.device.type == "cpu":
        return lstm_weight_grad_plain(h, dxw, reverse)
    _check_cuda(h, "lstm_weight_grad")
    b, t, hidden = h.shape
    if dxw.shape != (b, t, 4 * hidden) or h.dtype != torch.float32 or dxw.dtype != torch.float32:
        raise ValueError("lstm_weight_grad: h must be (B, T, H) and dxw (B, T, 4H), float32")
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    h, dxw = _aligned(h), _aligned(dxw)
    slices, per = dwhh_plan(b * t, hidden, torch.cuda.get_device_properties(h.device).multi_processor_count)
    dw = torch.empty(hidden, 4 * hidden, device=h.device, dtype=torch.float32)
    part = torch.empty(slices, hidden, 4 * hidden, device=h.device, dtype=torch.float32) if slices > 1 else None
    err = build.library().lstm_dwhh(
        h.data_ptr(), dxw.data_ptr(), None if part is None else part.data_ptr(), dw.data_ptr(), b, t, hidden,
        int(reverse), per, slices, build.stream_of(h),
    )
    build.check(err, "lstm_dwhh")
    lstm_weight_grad.launches += 1
    return dw


class LSTMSequence(torch.autograd.Function):
    """Per direction (xw, w_hh) → h, for one or two directions over one
    batch, with the backward of ``_lstm_seq`` (its ``custom_vjp`` in the
    JAX package): the forward saves h, c and the gates; the backward runs
    the recurrence of every direction (one launch), then the weight gradient
    of each.  Operands: lengths, the directions' reverse flags, then xw and
    w_hh of each direction in turn."""

    @staticmethod
    def forward(ctx, lengths, reverse, *operands):
        w_hhs = operands[1::2]
        outs = lstm_forward_directions(operands[0::2], w_hhs, lengths, reverse, save=True)
        hs, cs, gates = (list(x) for x in zip(*outs))
        ctx.save_for_backward(lengths, *w_hhs, *hs, *cs, *gates)
        ctx.reverse = reverse
        return tuple(hs)

    @staticmethod
    def backward(ctx, *gouts):
        n = len(ctx.reverse)
        lengths, *saved = ctx.saved_tensors
        w_hhs, hs, cs, gates = (saved[i * n:(i + 1) * n] for i in range(4))
        dxws = lstm_backward_directions([g.float() for g in gouts], gates, cs, w_hhs, lengths, ctx.reverse)
        grads = []
        for i, (h, dxw, reverse) in enumerate(zip(hs, dxws, ctx.reverse)):
            grads += [dxw, lstm_weight_grad(h, dxw, reverse=reverse) if ctx.needs_input_grad[3 + 2 * i] else None]
        return (None, None, *grads)


def lstm_directions(
    xws: Sequence[torch.Tensor], w_hhs: Sequence[torch.Tensor], lengths: torch.Tensor, reverse: Sequence[bool],
) -> List[torch.Tensor]:
    """One or two LSTM directions over one padded batch (a BiLSTM's two in
    one launch of each kernel), per direction (B, T, H) float32 out,
    differentiable in xw and w_hh.  With autograd recording it goes through
    `LSTMSequence` (the forward saving c and gates, then the backward
    kernels); otherwise the forward stores h only.  CPU tensors run the
    plain twins in the same places."""
    reverse = tuple(bool(r) for r in reverse)
    if torch.is_grad_enabled() and any(x.requires_grad for x in (*xws, *w_hhs)):
        return list(LSTMSequence.apply(lengths, reverse, *(x for pair in zip(xws, w_hhs) for x in pair)))
    return [h for h, _, _ in lstm_forward_directions(xws, w_hhs, lengths, reverse)]


def lstm(
    xw: torch.Tensor, w_hh: torch.Tensor, lengths: torch.Tensor, *, reverse: bool = False
) -> torch.Tensor:
    """One LSTM direction over a padded batch, (B, T, H) float32 out,
    differentiable in ``xw`` and ``w_hh``: `lstm_directions` with one
    direction."""
    return lstm_directions([xw], [w_hh], lengths, [reverse])[0]


lstm_forward_cluster.launches = 0
lstm_forward_grid.launches = 0
lstm_backward_cluster.launches = 0
lstm_backward_grid.launches = 0
lstm_weight_grad.launches = 0
