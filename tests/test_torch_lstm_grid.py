"""The LSTM recurrences past the thread-block cluster (H > 385): the grid
route's plan, and the port's BiLSTM at Conformer-L's H = 640 against the
JAX package.

`grid_plan` is host code: it is held here to what the H100 offers (132
SMs, 232,448 bytes of shared memory a block) and to a layout worked out
from first principles.  The grid kernels themselves run only on the card
(`tests/test_torch_cuda_kernels.py`); on the CPU the same entry points run
the plain twins, held here to the JAX package's ``lstm_pallas`` in
interpret mode at H = 640, B = 3, T = 9, lengths (9, 4, 1), from numpy
inputs: h, and jax.grad of sum(h · r) over xw and w_hh, both directions
through one call.  Tolerance 1e-5 (1e-5 of the largest entry for dW_hh, a
sum over B·T): the same float32 recurrence on both sides, each step's
640-term products summed in another order.  One JAX run serves the file.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu.ops.pallas.lstm import lstm_pallas
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L

H100_SMS, H100_SMEM = 132, 232448
HIDDEN, LENGTHS = 640, (9, 4, 1)
B, T = len(LENGTHS), max(LENGTHS)
REVERSE = (False, True)
ATOL = 1e-5


@pytest.mark.parametrize("batch, rows", [(16, 16), (4, 4)])
def test_grid_plan_places_conformer_l_in_one_launch(batch, rows):
    """Conformer-L's H = 640 at the 30 s batch (16) and the long-form one
    (4): both directions in one launch of 64 CTAs each (10 units, 40 gate
    columns), 128 of the 132 SMs, within a block's shared memory."""
    plan = L.grid_plan(batch, HIDDEN, H100_SMS, H100_SMEM)
    assert plan == dict(fits=True, ctas=64, units=10, rows=rows, directions=2, smem_bytes=plan["smem_bytes"])
    assert plan["smem_bytes"] <= H100_SMEM and plan["ctas"] * plan["directions"] <= H100_SMS


@pytest.mark.parametrize("batch", [16, 4, 1, 33])
def test_grid_plan_places_every_hidden_past_the_cluster(batch):
    """Every H from 386 (the first the cluster refuses) to 1024 (the largest
    the kernels take) is placed: its CTAs cover H with none empty, at most
    one an SM, tiles of at most 16 rows and no more row groups than the
    batch has, the cell update's rows × units within a CTA's 256 threads.
    The route refuses nothing a BiLSTM there needs."""
    for hidden in range(386, 1025):
        plan = L.grid_plan(batch, hidden, H100_SMS, H100_SMEM)
        assert plan["fits"], (hidden, plan)
        ctas, units, rows = plan["ctas"], plan["units"], plan["rows"]
        assert (ctas - 1) * units < hidden <= ctas * units
        assert ctas * plan["directions"] <= H100_SMS and plan["directions"] in (1, 2)
        assert rows in (4, 8, 12, 16) and rows <= 4 * -(-batch // 4) and rows * units <= L.GRID_THREADS
        assert plan["smem_bytes"] <= H100_SMEM


@pytest.mark.parametrize("hidden, batch", [(386, 16), (640, 16), (640, 4), (700, 16), (1024, 16), (1024, 1)])
def test_grid_plan_shared_bytes_are_what_its_layout_needs(hidden, batch):
    """The plan's shared bytes a CTA are the larger of what the forward and
    the backward lay out, counted here from their parts: the forward's
    W_hh slice (H × 4U), h (H × rows) and the partial gates of its K slices
    (each of 256 threads a column quad: 256 // U slices × rows × 4U);
    the backward's W_hh slice (H × (4U + 1), an odd row for conflict-free
    reads by row, rounded to 16 bytes), dgates (4U × 20) and every sender's
    partial dh of its units (CTAs × rows × U)."""
    plan = L.grid_plan(batch, hidden, H100_SMS, H100_SMEM)
    ctas, u, rows = plan["ctas"], plan["units"], plan["rows"]
    fwd = hidden * 4 * u + hidden * rows + (256 // u) * rows * 4 * u
    bwd = -(-hidden * (4 * u + 1) // 4) * 4 + 4 * u * 20 + ctas * rows * u
    assert plan["smem_bytes"] == 4 * max(fwd, bwd)
    layout = L.grid_layout(hidden, ctas, rows)
    assert (layout["fwd_floats"], layout["bwd_floats"]) == (fwd, bwd)
    assert layout["bwd_exchange"] == 2 * ctas * ctas * rows * u and layout["fwd_exchange"] == 2 * hidden * rows


def test_grid_plan_refuses_what_it_cannot_place():
    """Past the kernels' H, or with no room in a block's shared memory, the
    plan does not fit; on a card with half the H100's shared memory the
    same H takes one direction a launch or fewer rows a tile."""
    assert not L.grid_plan(16, 1025, H100_SMS, H100_SMEM)["fits"]
    assert not L.grid_plan(16, 640, H100_SMS, 40_000)["fits"]
    small = L.grid_plan(16, 640, H100_SMS, H100_SMEM // 2)
    assert small["fits"] and (small["directions"], small["rows"]) != (2, 16)
    assert small["smem_bytes"] <= H100_SMEM // 2


@pytest.fixture(scope="module")
def case():
    """Numpy inputs of both directions at H = 640 and the JAX package's h
    and gradients of sum(h · r) for each, through the Pallas kernel's
    custom_vjp in interpret mode."""
    rng = np.random.default_rng(13)
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
def test_bilstm_at_conformer_l_width_matches_pallas_interpret(case, save):
    """h of both directions from one call at H = 640, with and without the
    saved c and gates, against the JAX package's per-direction kernel."""
    xws, whs, lens = _torch(case)
    for (h, c, gates), ref in zip(L.lstm_forward_directions(xws, whs, lens, REVERSE, save=save), case["h"]):
        assert h.shape == (B, T, HIDDEN) and (c is None) == (gates is None) == (not save)
        np.testing.assert_allclose(h.numpy(), ref, atol=ATOL)


def test_bilstm_gradients_at_conformer_l_width_match_pallas_interpret(case):
    """d(Σ_directions sum(h · r)) / d(xw, w_hh) of both directions at H =
    640 through the one autograd Function (BPTT twin, hoisted dW_hh),
    against jax.grad of each direction."""
    xws, whs, lens = _torch(case, grad=True)
    hs = L.lstm_directions(xws, whs, lens, REVERSE)
    sum((h * torch.from_numpy(r)).sum() for h, r in zip(hs, case["rs"])).backward()
    for x, w, h, ref_h, (ref_dx, ref_dw) in zip(xws, whs, hs, case["h"], case["grads"]):
        np.testing.assert_allclose(h.detach().numpy(), ref_h, atol=ATOL)
        np.testing.assert_allclose(x.grad.numpy(), ref_dx, atol=ATOL)
        np.testing.assert_allclose(w.grad.numpy(), ref_dw, atol=ATOL * max(1.0, np.abs(ref_dw).max()))
