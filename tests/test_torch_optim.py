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
