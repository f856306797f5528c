"""The port's hand-written Adafactor and schedule against the JAX package's
``make_optimizer`` (``optax.adafactor``) and ``make_schedule``.

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


def test_only_adafactor_is_ported():
    with pytest.raises(NotImplementedError):
        make_optimizer(TCFG.OptimizerConfig(name="adam"), [])
