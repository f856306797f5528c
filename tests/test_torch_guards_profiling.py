"""The port's `utils.guards` and `utils.profiling` against the JAX package's.

The finite reports of both packages on the same seeded arrays, with NaN and
Inf planted, are equal key for key and count for count; `check_step`
raises on a NaN loss (a train step of the tiny model on audio holding a
NaN) and on a NaN gradient with a finite loss; `StepTimer`'s summary keys
are the JAX class's; `trace` writes a Chrome trace that holds an
`annotate` region.  Exact comparisons: these are counts, keys and names.
"""

import glob
import json

import numpy as np
import pytest
import torch

from _torch_multiproc_helpers import model_config

from nn_conformer_for_speech_recognition_tpu.utils import guards as JG
from nn_conformer_for_speech_recognition_tpu.utils import profiling as JP
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_train_step
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState
from nn_conformer_for_speech_recognition_tpu_torch.utils import guards as G
from nn_conformer_for_speech_recognition_tpu_torch.utils import profiling as P


def _planted(rng):
    """A nested tree of float32 arrays, NaN and Inf in some leaves, and an
    integer leaf the reports skip."""
    tree = {"encoder": {"w": rng.standard_normal((4, 3)).astype(np.float32),
                        "b": rng.standard_normal(3).astype(np.float32)},
            "head": {"kernel": rng.standard_normal((3, 2)).astype(np.float32)},
            "count": np.arange(4), "scale": np.float32(2.0)}
    tree["encoder"]["w"][1, 2] = np.nan
    tree["encoder"]["w"][3, 0] = np.inf
    tree["head"]["kernel"][:, 1] = -np.inf
    tree["encoder"]["b"][0] = np.nan
    return tree


def _to_torch(tree):
    return {k: _to_torch(v) if isinstance(v, dict) else torch.as_tensor(np.asarray(v)) for k, v in tree.items()}


def test_finite_report_matches_jax_on_a_nested_tree(rng):
    tree = _planted(rng)
    ref = JG.tree_finite_report(tree)
    assert ref == {"encoder/b": (1, 0), "encoder/w": (1, 1), "head/kernel": (0, 3)}
    assert G.tree_finite_report(_to_torch(tree)) == ref


def test_finite_report_matches_jax_on_a_state_dict_and_a_module(rng):
    model = torch.nn.Sequential(torch.nn.Linear(3, 4), torch.nn.BatchNorm1d(4))
    with torch.no_grad():
        model[0].weight[2, 1] = float("nan")
        model[1].running_var[3] = float("inf")
    converted = {k: v.numpy() for k, v in model.state_dict().items()}
    ref = JG.tree_finite_report(converted)
    assert ref == {"0.weight": (1, 0), "1.running_var": (0, 1)}
    assert G.tree_finite_report(model) == G.tree_finite_report(model.state_dict()) == ref
    assert G.tree_finite_report(torch.nn.Linear(2, 2)) == {}


def test_assert_all_finite_raises_in_both(rng):
    tree = _planted(rng)
    for fn, t in ((JG.assert_all_finite, tree), (G.assert_all_finite, _to_torch(tree))):
        with pytest.raises(FloatingPointError, match="non-finite values in params"):
            fn(t, "params")
    G.assert_all_finite({"ok": torch.ones(3)})


def test_nan_guard_passes_the_value_and_reports(capsys):
    x = torch.tensor([1.0, float("nan")])
    assert G.nan_guard(x, "logits") is x
    assert "NaN/Inf detected in logits" in capsys.readouterr().out
    y = torch.ones(2)
    assert G.nan_guard(y, "fine") is y and capsys.readouterr().out == ""
    flags = G.FiniteFlags()
    G.nan_guard(y, "a", flags)
    G.nan_guard(x, "b", flags)
    G.nan_guard(y, "b", flags)  # a flag once set stays set
    assert flags.bad() == ["b"] and capsys.readouterr().out == ""
    if torch.cuda.is_available():  # a device tensor needs flags: a print would wait for the card
        with pytest.raises(ValueError, match="FiniteFlags"):
            G.nan_guard(y.cuda(), "c")


@pytest.fixture(scope="module")
def tiny_step():
    model = init_params(ConformerCTC(model_config(), 7), torch.Generator().manual_seed(0))
    state = TrainState.create(model, make_optimizer(TC.OptimizerConfig(), model.named_parameters()), 0)
    feat = TC.FeatureConfig(n_fft=256, hop_length=256, n_mels=13)
    step = G.check_step(make_train_step(model, feat, TC.SpecAugmentConfig(), blank_id=0, use_specaugment=False))
    rng = np.random.default_rng(0)
    audio = torch.from_numpy(0.1 * rng.standard_normal((2, 4000)).astype(np.float32))
    args = (torch.tensor([4000, 3000]), torch.tensor([[3, 4], [5, 0]]), torch.tensor([2, 1]))
    return step, state, audio, args


def test_check_step_passes_a_finite_step(tiny_step):
    step, state, audio, args = tiny_step
    error, (state, metrics) = step(state, audio, *args)
    assert error.get() is None and torch.isfinite(metrics["loss"])
    error.throw()
    assert "loss" in error.names and sum(n.startswith("grad/") for n in error.names) == len(list(state.model.parameters()))


def test_check_step_raises_on_a_nan_loss(tiny_step):
    step, state, audio, args = tiny_step
    bad = audio.clone()
    bad[0, 10] = float("nan")
    error, (_, metrics) = step(state, bad, *args)
    assert not torch.isfinite(metrics["loss"])
    with pytest.raises(FloatingPointError, match="non-finite values in loss"):
        error.throw()


def test_check_step_raises_on_a_nan_gradient():
    """A finite loss whose gradient is NaN in one parameter (a hook plants it)."""
    model = torch.nn.Linear(3, 1)
    model.weight.register_hook(lambda g: torch.full_like(g, float("nan")))

    class State:
        pass

    state = State()
    state.model = model

    def step(state, x):
        loss = model(x).sum()
        loss.backward()
        return state, {"loss": loss.detach()}

    error, (_, metrics) = G.check_step(step)(state, torch.ones(2, 3))
    assert torch.isfinite(metrics["loss"])
    assert error.get() == "non-finite values in grad/weight"
    with pytest.raises(FloatingPointError, match="grad/weight"):
        error.throw()


def test_step_timer_keys_match_jax():
    mine, ref = P.StepTimer(sample_rate=16000), JP.StepTimer(sample_rate=16000)
    for timer in (mine, ref):
        for _ in range(2):
            timer.data_ready()
            timer.step_done(16000)
    assert mine.summary().keys() == ref.summary().keys()
    assert mine.summary()["steps"] == ref.summary()["steps"] == 2
    assert mine.device_seconds() == 0.0  # no card, no events


def test_trace_writes_an_annotated_chrome_trace(tmp_path):
    with P.trace(str(tmp_path)) as prof:
        with P.annotate("nst_label_pass"):
            torch.ones(64, 64) @ torch.ones(64, 64)
    files = glob.glob(str(tmp_path / "trace_*.json"))
    assert len(files) == 1
    names = {e.get("name") for e in json.load(open(files[0]))["traceEvents"]}
    assert "nst_label_pass" in names
    groups = P.kernel_groups(prof)
    assert all(ms == 0 and n == 0 for ms, n in groups.values())  # the CPU launches no kernel
