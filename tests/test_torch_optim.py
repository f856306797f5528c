"""The port's hand-written Adafactor, Adam and AdamW and its schedule
against the JAX package's ``make_optimizer`` (``optax.adafactor``,
``optax.adam``, ``optax.adamw``) and ``make_schedule``.

Five steps on identical gradients, made with numpy in the JAX package's
layout and transposed into the port's (Linear (out, in), Conv2d (out, in,
kh, kw), depthwise (C, 1, K)), so the factored axes must be picked on the
logical (flax) axes to agree.  Tolerance atol 1e-6 on the parameters
(magnitude ~1, updates ~lr = 1e-2; float32 on both sides, means taken in
another order); the schedule rtol 1e-6.
"""

import functools

import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as JCFG
from nn_conformer_for_speech_recognition_tpu.train.optim import make_optimizer as jax_make_optimizer
from nn_conformer_for_speech_recognition_tpu.train.optim import make_schedule as jax_make_schedule
from nn_conformer_for_speech_recognition_tpu_torch import config as TCFG
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer, make_schedule

# port name → (flax shape, flax → port axes)
PARAMS = {
    "bias": ((300,), (0,)),
    "square.weight": ((128, 128), (1, 0)),  # Dense (in, out), factored
    "rect.weight": ((200, 130), (1, 0)),  # rectangular Dense, factored
    "narrow.weight": ((8, 300), (1, 0)),  # one axis < 128: not factored
    "conv.weight": ((3, 3, 128, 160), (3, 2, 0, 1)),  # NHWC conv kernel, factored over in/out
    "depthwise.weight": ((33, 1, 256), (2, 1, 0)),  # not factored (33 < 128)
    "lstm_fwd_0_w_hh": ((160, 640), (0, 1)),  # packed LSTM: same layout both sides
}


@pytest.mark.parametrize(
    "opt_cfg",
    [dict(learning_rate=1e-2), dict(learning_rate=1e-2, weight_decay=1e-3),
     dict(learning_rate=1e-2, schedule="transformer", warmup_steps=3)],
    ids=["plain", "weight_decay", "transformer_schedule"],
)
def test_adafactor_matches_optax(rng, opt_cfg):
    init = {k: rng.standard_normal(shape).astype(np.float32) for k, (shape, _) in PARAMS.items()}
    grads = [{k: rng.standard_normal(shape).astype(np.float32) * (1 + 3 * rng.random())
              for k, (shape, _) in PARAMS.items()} for _ in range(5)]

    tx = jax_make_optimizer(JCFG.OptimizerConfig(**opt_cfg))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)

    torch_params = {k: torch.nn.Parameter(torch.from_numpy(init[k].transpose(axes).copy()))
                    for k, (_, axes) in PARAMS.items()}
    opt = make_optimizer(TCFG.OptimizerConfig(**opt_cfg), torch_params.items())
    for g in grads:
        for k, (_, axes) in PARAMS.items():
            torch_params[k].grad = torch.from_numpy(g[k].transpose(axes).copy())
        opt.step()

    for k, (_, axes) in PARAMS.items():
        ref = np.asarray(params[k]).transpose(axes)
        assert np.abs(ref - init[k].transpose(axes)).max() > 1e-3, k  # the parameter moved
        np.testing.assert_allclose(torch_params[k].detach().numpy(), ref, atol=1e-6, err_msg=k)
    factored = {k for k, st in opt.state.items() if "v_row" in st}
    assert factored == {"square.weight", "rect.weight", "conv.weight", "lstm_fwd_0_w_hh"}


@pytest.mark.parametrize("cfg", [dict(), dict(schedule="transformer", warmup_steps=10, learning_rate=1e-3)])
def test_schedule_matches_jax(cfg):
    ours, ref = make_schedule(TCFG.OptimizerConfig(**cfg)), jax_make_schedule(JCFG.OptimizerConfig(**cfg))
    for step in range(30):
        want = ref(jnp.int32(step)) if callable(ref) else ref
        got = ours(step) if callable(ours) else ours
        np.testing.assert_allclose(got, float(want), rtol=1e-6, err_msg=str(step))


@pytest.mark.parametrize(
    "opt_cfg",
    [dict(name="adam", learning_rate=1e-2), dict(name="adamw", learning_rate=1e-2, weight_decay=1e-2),
     dict(name="adamw", learning_rate=1e-2), dict(name="adam", learning_rate=1e-2, schedule="transformer", warmup_steps=3)],
    ids=["adam", "adamw", "adamw_no_decay", "adam_transformer_schedule"],
)
def test_adam_matches_optax(rng, opt_cfg):
    """``make_optimizer``'s Adam and AdamW against ``optax.adam`` and
    ``optax.adamw`` over five steps of identical gradients, parameters atol
    1e-6 (the Adafactor bar); elementwise, so the layouts do not matter."""
    shapes = {"w.weight": (24, 40), "b.bias": (40,), "e.weight": (7, 5, 3)}
    init = {k: rng.standard_normal(s).astype(np.float32) for k, s in shapes.items()}
    grads = [{k: rng.standard_normal(s).astype(np.float32) * (1 + 3 * rng.random()) for k, s in shapes.items()}
             for _ in range(5)]
    tx = jax_make_optimizer(JCFG.OptimizerConfig(**opt_cfg))
    params = {k: jnp.asarray(v) for k, v in init.items()}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
    torch_params = {k: torch.nn.Parameter(torch.from_numpy(v.copy())) for k, v in init.items()}
    opt = make_optimizer(TCFG.OptimizerConfig(**opt_cfg), torch_params.items())
    for g in grads:
        for k in shapes:
            torch_params[k].grad = torch.from_numpy(g[k])
        opt.step()
    assert opt.count == 5 and set(opt.state["w.weight"]) == {"mu", "nu"}
    for k in shapes:
        assert np.abs(np.asarray(params[k]) - init[k]).max() > 1e-3, k
        np.testing.assert_allclose(torch_params[k].detach().numpy(), np.asarray(params[k]), atol=1e-6, err_msg=k)


def test_adamw_default_decay_is_optax_default():
    """``LMTrainer`` uses ``optax.adamw(lr)``: its default decay is the port's."""
    import inspect

    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import ADAMW_WEIGHT_DECAY

    assert inspect.signature(optax.adamw).parameters["weight_decay"].default == ADAMW_WEIGHT_DECAY


def test_every_optimizer_name_is_built_and_an_unknown_one_refused():
    """Every optimizer name of the JAX package is built; an unknown one is
    refused with the JAX package's ValueError."""
    for name in ("adafactor", "adam", "adamw"):
        make_optimizer(TCFG.OptimizerConfig(name=name), [])
    with pytest.raises(ValueError, match="unknown optimizer"):
        make_optimizer(TCFG.OptimizerConfig(name="sgd"), [])
    with pytest.raises(ValueError, match="unknown optimizer"):
        jax_make_optimizer(JCFG.OptimizerConfig(name="sgd"))


# -- the multi-tensor kernels' table (`ops/cuda/adafactor.py`).  Here, where no card is, the table is held to its
# geometry, and a plain-torch walk of its four passes (`_walk_step`, below) to the per-tensor loop; the card tests
# hold the kernels themselves to the loop.  The bars are the loop's against optax: parameters atol 1e-6 after 5
# steps; the slots 1e-5 of their largest magnitude (the momentum crosses zero, so a bar per element would read its
# cancellation).


def _ranges(jobs: np.ndarray) -> np.ndarray:
    """The elements (or outputs) of ``jobs`` (kind, param, first, count), each job's run in order."""
    starts, counts = jobs[:, 2].astype(np.int64), jobs[:, 3].astype(np.int64)
    before = np.cumsum(counts) - counts
    return np.repeat(starts - before, counts) + np.arange(counts.sum())


def _walk_index(w, i, sets: int = 1):
    """A walk of the meta table (``w``: nd, sizes, ``sets`` sets of strides) of the flat indices ``i`` (a tensor or
    a slice; row-major over the sizes): the offsets under each set of strides."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.adafactor import MAX_DIMS

    nd, out = w[0], []
    for s in range(sets):
        at = 1 + (s + 1) * MAX_DIMS
        grid = torch.zeros((), dtype=torch.int64)
        for size, stride in zip(w[1:1 + nd], w[at:at + nd]):
            grid = grid[..., None] + torch.arange(size) * stride
        out.append(grid.reshape(-1)[i])
    return tuple(out)


def _walk_step(table, params, state, *, lr, keep, take, eps, clipping_threshold, momentum, weight_decay_rate):
    """`adafactor_step`'s four passes in plain torch: the same table, job lists and pass order, each job's elements
    or outputs indexed through the meta rows' walks and strides, updating the same tensors in place.  The sums are
    torch's, in its order."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import adafactor as K

    slots, meta = K._slots(table, params, state), table.meta.tolist()
    usq, rf, cf = torch.zeros(table.chunks), torch.zeros(table.rows), torch.zeros(table.cols)
    flat = [(p.view(-1), g.reshape(-1), a.view(-1) if b is not None else a.permute(tuple(np.argsort(axes))).view(-1),
             None if b is None else b.view(-1), None if e is None else e.permute(tuple(np.argsort(axes))).view(-1))
            for (_, _, axes, _, _), (p, g, a, b, e) in zip(params, slots)]

    def runs(jobs):
        """(kind, parameter, elements) of each run of consecutive jobs of one kind and parameter."""
        j = jobs.numpy().astype(np.int64)
        cuts = np.flatnonzero(np.any(j[1:, :2] != j[:-1, :2], axis=1)) + 1
        return [(int(r[0, 0]), int(r[0, 1]), r, torch.from_numpy(_ranges(r))) for r in np.split(j, cuts) if len(r)]

    def update(i, e):
        m, (_, g, a, _, _) = meta[i], flat[i]
        if params[i][3] is None:
            return g[e] * a[e].pow(-0.5)
        r, c = _walk_index(m[K.WALK_ELEM:], e, sets=2)
        return g[e] * rf[m[K.ROW0] + r] * cf[m[K.COL0] + c]

    def chunk_sums(i, jobs, u2):
        seg = torch.from_numpy(np.repeat(np.arange(len(jobs)), jobs[:, 3]))
        usq[meta[i][K.CHUNK0] + torch.from_numpy(jobs[:, 2] // K.CHUNK)] = torch.zeros(len(jobs)).index_add_(0, seg, u2)

    clip = clipping_threshold is not None
    for kind, i, jobs, o in runs(table.moments):  # pass 1
        m, (_, g, a, b, _) = meta[i], flat[i]
        if kind == K.UNFACTORED:
            a[o] = keep * a[o] + take * (g[o] * g[o] + eps)
            if clip:
                chunk_sums(i, jobs, update(i, o).square())
            continue
        walk, length, stride, slot = ((K.WALK_ROW, K.L0, K.S0, a) if kind == K.ROW_SUMS else (K.WALK_COL, K.L1, K.S1, b))
        elems = _walk_index(m[walk:], o)[0][:, None] + torch.arange(m[length]) * m[stride]
        slot[o] = keep * slot[o] + take * (g[elems] * g[elems] + eps).mean(dim=1)
    for kind, i, jobs, o in runs(table.factors):  # pass 2
        m, (_, _, a, b, _) = meta[i], flat[i]
        if kind == K.COL_FACTORS:
            cf[m[K.COL0] + o] = b[o].pow(-0.5)
            continue
        entries = _walk_index(m[K.WALK_BATCH:], o)[0][:, None] + torch.arange(m[K.L1]) * m[K.RS1]
        rf[m[K.ROW0] + entries] = (a[entries] / a[entries].mean(dim=1, keepdim=True)).pow(-0.5)
    if clip:
        for _, i, jobs, o in runs(table.clip_sums):  # pass 3
            chunk_sums(i, jobs, update(i, o).square())
    for _, i, jobs, o in runs(table.apply):  # pass 4
        m, (p, _, _, _, mom) = meta[i], flat[i]
        u = update(i, o)
        if clip:
            ms = usq[m[K.CHUNK0]:m[K.CHUNK0] + m[K.CHUNKS]].sum() / m[K.N]
            u = u / torch.clamp_min(ms.sqrt() / clipping_threshold, 1.0)
        u = lr * u
        if momentum is not None:
            u = (1.0 - momentum) * u + momentum * mom[o]
            mom[o] = u
        if weight_decay_rate is not None:
            u = u + weight_decay_rate * p[o]
        p[o] = p[o] - u


def _module(tensors):
    """A module whose named parameters are ``tensors`` (names with dots)."""
    root = torch.nn.Module()
    for name, t in tensors.items():
        owner, *path = root, *name.split(".")
        for part in path[:-1]:
            if not hasattr(owner, part):
                owner.add_module(part, torch.nn.Module())
            owner = getattr(owner, part)
        owner.register_parameter(path[-1], torch.nn.Parameter(t))
    return root


@functools.lru_cache(maxsize=None)
def _initial_params(which):
    if which == "PARAMS":
        gen = np.random.default_rng(0)
        return {k: torch.from_numpy(gen.standard_normal(shape).astype(np.float32).transpose(axes).copy())
                for k, (shape, axes) in PARAMS.items()}
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC

    torch.manual_seed(0)
    model = ConformerCTC(TCFG.conformer_m(use_pallas=True), 1024)
    return {k: p.detach() for k, p in model.named_parameters()}


def _optimizer_params(which):
    """{port name: initial tensor} of the PARAMS set or of Conformer-M's 514 parameters, a fresh copy."""
    return {k: t.clone() for k, t in _initial_params(which).items()}


def _walked(monkeypatch):
    """Adafactor takes the kernels' route on the CPU, with `_walk_step` in place of the launches."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import adafactor as K
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import Adafactor

    monkeypatch.setattr(Adafactor, "_on_kernels", lambda self: True)
    monkeypatch.setattr(K, "adafactor_step", _walk_step)
    return K


def _grads(tensors, steps, seed=1):
    """Gradients that grow from step to step, so that the clip binds."""
    gen = torch.Generator().manual_seed(seed)
    return [{k: torch.randn(t.shape, generator=gen) * (1 + 2 * s) for k, t in tensors.items()} for s in range(steps)]


def _assert_same_state(opt, ref, atol=1e-6):
    for (name, p, *_), (_, q, *_) in zip(opt.params, ref.params):
        np.testing.assert_allclose(p.detach().numpy(), q.detach().numpy(), atol=atol, rtol=0, err_msg=name)
        for k, slot in ref.state[name].items():
            got = opt.state[name][k]
            assert got.shape == slot.shape, (name, k)
            scale = float(slot.abs().max())
            np.testing.assert_allclose(got.numpy(), slot.numpy(), rtol=0, atol=1e-5 * scale, err_msg=f"{name}.{k}")


@pytest.mark.parametrize(
    "which, opt_cfg",
    [("PARAMS", dict(learning_rate=1e-2)), ("PARAMS", dict(learning_rate=1e-2, weight_decay=1e-3)),
     ("PARAMS", dict(learning_rate=1e-2, momentum=None, clip_threshold=None))],
    ids=["PARAMS", "PARAMS-weight_decay", "PARAMS-no_momentum_no_clip"],
)
def test_kernel_table_walk_matches_the_loop(monkeypatch, which, opt_cfg):
    """Five steps of the kernels' passes, walked over their own table,
    against the per-tensor loop from the same parameters and gradients."""
    init = _optimizer_params(which)
    grads = _grads(init, 5)
    ref_params = {k: torch.nn.Parameter(t.clone()) for k, t in init.items()}
    ref = make_optimizer(TCFG.OptimizerConfig(**opt_cfg), ref_params.items())
    for g in grads:
        for k, p in ref_params.items():
            p.grad = g[k]
        ref.step()
    _walked(monkeypatch)
    params = {k: torch.nn.Parameter(t.clone()) for k, t in init.items()}
    opt = make_optimizer(TCFG.OptimizerConfig(**opt_cfg), params.items())
    for g in grads:
        for k, p in params.items():
            p.grad = g[k].clone()
        opt.step()
    assert opt._table is not None and len(opt._table.meta) == len(init)
    for k, t in init.items():
        assert float((params[k].detach() - t).abs().max()) > 1e-3, k  # the parameter moved
    _assert_same_state(opt, ref)


@pytest.mark.parametrize("name", sorted(PARAMS))
def test_kernel_table_covers_the_geometry(name):
    """Each pass's jobs cover a parameter's elements (chunks) or outputs (v_row
    and v_col entries, batch slices) once each, in order; the meta rows hold
    the factored axes, the batch axes and the slots' strides: the JAX shape
    over the port's memory order."""
    from nn_conformer_for_speech_recognition_tpu_torch.convert import factored_dims
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import adafactor as K

    shape, to_port = PARAMS[name]
    p = torch.nn.Parameter(torch.zeros(tuple(shape[a] for a in to_port)))
    opt = make_optimizer(TCFG.OptimizerConfig(), [(name, p)])
    axes = opt.params[0][2]  # port → JAX
    assert tuple(p.permute(axes).shape) == shape
    table = K.AdafactorTable.build(opt.params)
    meta, n, dims = table.meta[0].tolist(), p.numel(), factored_dims(shape)
    assert table.slot_strides[0] == torch.empty(p.shape).permute(axes).stride()
    assert meta[K.N] == n and meta[K.CHUNKS] == -(-n // K.CHUNK)

    def covered(jobs, kind):
        j = jobs.numpy().astype(np.int64)
        return _ranges(j[j[:, 0] == kind]).tolist()

    assert covered(table.apply, K.APPLY) == list(range(n))
    if dims is None:
        assert covered(table.moments, K.UNFACTORED) == list(range(n)) and len(table.factors) == 0
        assert table.rows == table.cols == 0
        return
    d1, d0 = dims
    rows, cols = n // shape[d0], n // shape[d1]
    assert (table.rows, table.cols) == (rows, cols) == (opt.state[name]["v_row"].numel(),
                                                       opt.state[name]["v_col"].numel())
    assert covered(table.moments, K.ROW_SUMS) == list(range(rows))
    assert covered(table.moments, K.COL_SUMS) == list(range(cols))
    assert covered(table.factors, K.BATCH_MEANS) == list(range(rows // shape[d1]))
    assert covered(table.factors, K.COL_FACTORS) == list(range(cols))
    assert covered(table.clip_sums, K.CLIP_SUMS) == list(range(n))
    assert (meta[K.L0], meta[K.L1]) == (shape[d0], shape[d1])
    # each v_row entry's elements are the g² it averages: the mean over the largest JAX axis
    g = torch.arange(n, dtype=torch.float32).reshape(p.shape)
    base, = _walk_index(meta[K.WALK_ROW:], torch.arange(rows))
    lines = g.view(-1)[base[:, None] + torch.arange(shape[d0]) * meta[K.S0]]
    np.testing.assert_array_equal(lines.mean(dim=1).numpy(), g.permute(axes).mean(dim=d0).reshape(-1).numpy())
    base, = _walk_index(meta[K.WALK_COL:], torch.arange(cols))
    lines = g.view(-1)[base[:, None] + torch.arange(shape[d1]) * meta[K.S1]]
    np.testing.assert_array_equal(lines.mean(dim=1).numpy(), g.permute(axes).mean(dim=d1).reshape(-1).numpy())
    # each element's v_row and v_col entries
    r, c = _walk_index(meta[K.WALK_ELEM:], torch.arange(n), sets=2)
    jax = torch.arange(n).reshape(p.shape).permute(axes)  # port offsets in the JAX layout
    want_r = torch.empty(n, dtype=torch.int64)
    want_r[jax.movedim(d0, -1).reshape(-1)] = torch.arange(rows).repeat_interleave(shape[d0])
    want_c = torch.empty(n, dtype=torch.int64)
    want_c[jax.movedim(d1, -1).reshape(-1)] = torch.arange(cols).repeat_interleave(shape[d1])
    assert torch.equal(r, want_r) and torch.equal(c, want_c)


def test_kernel_table_of_conformer_m():
    """Conformer-M's 514 parameters (152 factored) in one table: 4 launches a
    step (3 without the clip); each pass's jobs run over every parameter in
    chunks, in order, and the scratch holds a partial a chunk and a factor a
    v_row and v_col entry; the slots `Adafactor` creates are laid out as the
    table reads them, so the first step copies none."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import adafactor as K

    params = {k: torch.nn.Parameter(t) for k, t in _initial_params("conformer_m").items()}
    opt = make_optimizer(TCFG.OptimizerConfig(), params.items())
    table = K.AdafactorTable.build(opt.params)
    factored = [dims is not None for _, _, _, dims, _ in opt.params]
    assert (len(opt.params), sum(factored)) == (514, 152)
    assert (table.launches(clip=True), table.launches(clip=False)) == (4, 3)
    meta = table.meta.numpy()
    sizes = np.array([p.numel() for _, p, *_ in opt.params])
    chunks = -(-sizes // K.CHUNK)
    assert np.array_equal(meta[:, K.N], sizes) and np.array_equal(meta[:, K.CHUNKS], chunks)
    assert np.array_equal(meta[:, K.CHUNK0], np.cumsum(chunks) - chunks) and table.chunks == chunks.sum()
    for jobs, kind, which in ((table.apply, K.APPLY, [True] * len(sizes)), (table.clip_sums, K.CLIP_SUMS, factored),
                              (table.moments, K.UNFACTORED, [not f for f in factored])):
        j = jobs.numpy().astype(np.int64)
        j = j[j[:, 0] == kind]
        want = [i for i, w in enumerate(which) if w]
        assert np.array_equal(np.unique(j[:, 1]), want) and np.all(np.diff(j[:, 1]) >= 0)
        for i in want:  # chunks of CHUNK elements from 0, the last one short
            mine = j[j[:, 1] == i]
            assert np.array_equal(mine[:, 2], np.arange(0, sizes[i], K.CHUNK)) and mine[:, 3].sum() == sizes[i]
    assert (table.rows, table.cols) == (sum(st["v_row"].numel() for st in opt.state.values() if "v_row" in st),
                                        sum(st["v_col"].numel() for st in opt.state.values() if "v_col" in st))
    for (name, *_), strides in zip(opt.params, table.slot_strides):
        for k in ("v", "ema"):
            if k in opt.state[name]:
                assert opt.state[name][k].stride() == strides, (name, k)


def test_kernel_route_rule(monkeypatch):
    """The kernels take float32 CUDA tensors only, and Adafactor's step only
    without a tensor-parallel plan; CPU parameters take the loop, which
    launches nothing and leaves the kernels' counter alone."""
    from types import SimpleNamespace

    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import adafactor as K
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import Axis, TensorParallelPlan

    card = SimpleNamespace(is_cuda=True, dtype=torch.float32)
    assert K.on_kernel_route([card, card])
    assert not K.on_kernel_route([])
    assert not K.on_kernel_route([card, None])
    assert not K.on_kernel_route([card, SimpleNamespace(is_cuda=True, dtype=torch.bfloat16)])
    assert not K.on_kernel_route([card, torch.zeros(2)])
    params = {k: torch.nn.Parameter(t) for k, t in _optimizer_params("PARAMS").items()}
    opt = make_optimizer(TCFG.OptimizerConfig(), params.items())
    assert not opt._on_kernels()
    before = K.adafactor_step.params, K.adafactor_step.launches
    for p in params.values():
        p.grad = torch.ones_like(p)
    opt.step()
    assert (K.adafactor_step.params, K.adafactor_step.launches) == before and opt._table is None
    monkeypatch.setattr(K, "on_kernel_route", lambda tensors: True)  # as though every parameter were on a card
    assert opt._on_kernels()
    plan = TensorParallelPlan(axis=Axis("model", 1, 0), specs={})
    assert not make_optimizer(TCFG.OptimizerConfig(), params.items(), plan=plan)._on_kernels()


def test_kernel_step_keeps_the_optimizer_interface(monkeypatch):
    """What the benchmark reads after `type(opt).step(opt)`: the same
    ``params`` tuples, ``count``, and every slot under its name in its JAX
    shape; v_row and v_col contiguous, v and ema JAX-shaped views of
    port-ordered memory, the very tensors `Adafactor` created."""
    _walked(monkeypatch)
    params = {k: torch.nn.Parameter(t) for k, t in _optimizer_params("PARAMS").items()}
    opt = make_optimizer(TCFG.OptimizerConfig(), params.items())
    entries = list(opt.params)
    created = {name: dict(st) for name, st in opt.state.items()}
    shapes = {name: {k: tuple(v.shape) for k, v in st.items()} for name, st in opt.state.items()}
    for g in _grads(params, 2):
        for k, p in params.items():
            p.grad = g[k]
        type(opt).step(opt)
    assert opt.count == 2 and opt.params == entries and all(a is b for a, b in zip(opt.params, entries))
    assert {name: {k: tuple(v.shape) for k, v in st.items()} for name, st in opt.state.items()} == shapes
    assert all(opt.state[name][k] is v for name, st in created.items() for k, v in st.items())
    for name, p, axes, dims, _ in opt.params:
        st = opt.state[name]
        for k in ("v", "ema"):
            if k in st:
                assert st[k].permute(tuple(np.argsort(axes))).is_contiguous(), (name, k)
        if dims is not None:
            assert st["v_row"].is_contiguous() and st["v_col"].is_contiguous(), name


def test_restored_and_copied_states_step_on_their_own_tensors(monkeypatch, tmp_path):
    """A state restored from a checkpoint, one whose slots were laid out as
    the JAX package's (contiguous), and a deep copy each take the kernels'
    step on their own tensors: each agrees with the loop from the same
    state, and the original is left as it was."""
    import copy

    from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import restore_state, save_state
    from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState

    init = _optimizer_params("PARAMS")
    grads = _grads(init, 3)

    def state():
        model = _module({k: t.clone() for k, t in init.items()})
        return TrainState.create(model, make_optimizer(TCFG.OptimizerConfig(), model.named_parameters()), 0)

    def step(st, g):
        for k, p in st.model.named_parameters():
            p.grad = g[k].clone()
        st.apply_gradients()

    ref = state()  # the loop throughout
    step(ref, grads[0])
    step(ref, grads[1])
    _walked(monkeypatch)
    first = state()
    step(first, grads[0])
    save_state(str(tmp_path / "ckpt"), first)
    restored = restore_state(str(tmp_path / "ckpt"), state())
    laid_out = copy.deepcopy(first)
    for st in laid_out.optimizer.state.values():
        for k in st:
            st[k] = st[k].contiguous()
    copied = copy.deepcopy(first)
    held = {k: t.detach().clone() for k, t in first.model.state_dict().items()}
    held_slots = {(n, k): t.clone() for n, st in first.optimizer.state.items() for k, t in st.items()}
    for st in (restored, laid_out, copied):
        step(st, grads[1])
        _assert_same_state(st.optimizer, ref.optimizer)
    assert all(torch.equal(first.model.state_dict()[k], t) for k, t in held.items())
    assert all(torch.equal(first.optimizer.state[n][k], t) for (n, k), t in held_slots.items())
    step(first, grads[1])  # the original, left alone by its copies' steps, steps on its own tensors
    _assert_same_state(first.optimizer, ref.optimizer)
    for st in (restored, laid_out, copied):
        step(st, grads[2])
    step(ref, grads[2])
    for st in (restored, laid_out, copied):
        _assert_same_state(st.optimizer, ref.optimizer)


@pytest.mark.parametrize("which", ["PARAMS", "conformer_m"])
def test_global_norm_walk_matches_the_loop(which):
    """The norm's chunk jobs cover every gradient once, in order; a float32
    sum of squares a job, added in job order in float64, against
    ``optax_global_norm`` (float32) and a float64 sum of squares."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import adafactor as K
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import optax_global_norm

    grads = list(_grads(_optimizer_params(which), 1)[0].values())
    exact = float(torch.sqrt(sum(g.double().square().sum() for g in grads)))
    jobs = K.norm_jobs(tuple(g.numel() for g in grads))
    partials = []
    for i, g in enumerate(grads):
        mine = jobs[jobs[:, 1] == i]
        assert _ranges(mine).tolist() == list(range(g.numel()))
        seg = torch.from_numpy(np.repeat(np.arange(len(mine)), mine[:, 3]))
        partials.append(torch.zeros(len(mine)).index_add_(0, seg, g.reshape(-1).square()))
    walked = float(torch.cat(partials).double().sum().sqrt().float())
    assert abs(walked - exact) <= 1e-6 * exact
    assert abs(float(optax_global_norm(grads)) - exact) <= 1e-5 * exact
