"""Sequence parallelism over processes: the port's Ulysses rel-pos attention
against the JAX package's on a 2-device mesh, and ``seq_parallel=True``
training on two gloo processes against one process.

One launch of two workers (`_torch_multiproc_helpers.
scenario_sequence_parallel`: two data ranks, 2 of the tiny model's 4 heads
each) and the same scenario in this process, where no second rank exists
and every attention layer falls back with its reason.  The weights are the
port's seeded initialisation with noise.

Tolerances.  The Ulysses function against the JAX function: forward atol
5e-5, the gradients of q, k, v and the table atol 5e-4 (JAX
``test_sharding.py``'s bars).  The sequence-parallel step against one
process: loss and gradient norm, and every parameter and batch statistic
after the step, atol 1e-5 (``test_sharding.py``'s step bar), the rel-pos
projections as `_torch_multiproc_helpers.assert_params_close` holds them
(their gradient along the sinusoid's near-constant columns is float
noise); `evaluate` loss rtol 1e-5, WER, texts and pseudo-labels equal.  The
fallback counters: exact.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from _torch_multiproc_helpers import (
    BATCH,
    assert_params_close,
    launch,
    scenario_sequence_parallel,
    tp_model_config,
    ulysses_inputs,
)
from _torch_trainer_helpers import make_corpus

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.parallel import mesh as jmesh
from nn_conformer_for_speech_recognition_tpu.parallel.sequence import ulysses_relpos_attention as jax_ulysses
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
from nn_conformer_for_speech_recognition_tpu_torch.parallel import sequence as S
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import make_mesh


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("sp")
    manifests, _, tvocab, _, _ = make_corpus(root / "corpus")
    model = init_params(ConformerCTC(tp_model_config(), len(tvocab)), torch.Generator().manual_seed(0))
    rng = np.random.default_rng(0)
    state = {k: v + 0.05 * torch.from_numpy(rng.standard_normal(v.shape).astype(np.float32))
             for k, v in model.state_dict().items()}
    state = {k: v.abs() + 0.5 if k.endswith("running_var") else v for k, v in state.items()}
    sd_path = str(root / "start.pt")
    torch.save(state, sd_path)
    return dict(root=root, args={"manifests": manifests, "tp_state_dict": sd_path})


@pytest.fixture(scope="module")
def one(setup):
    result, tensors = scenario_sequence_parallel(setup["args"])
    return {**result, "tensors": tensors}


@pytest.fixture(scope="module")
def two(setup):
    return launch("sequence_parallel", 2, setup["args"], str(setup["root"] / "two_out"))


@pytest.fixture(scope="module")
def jax_ulysses_run():
    """The JAX function on a 2-device mesh: outputs and the gradients of
    q, k, v and the table, with the loss the workers take."""
    x = ulysses_inputs()
    mesh = jmesh.make_mesh(C.MeshConfig(), devices=jax.devices()[:2])
    mask = jnp.arange(x["q"].shape[1])[None, :] < jnp.asarray(x["lengths"])[:, None]
    args = tuple(jnp.asarray(x[k]) for k in ("q", "k", "v", "p"))
    out = {}
    for use_pallas in (False, True):
        def fn(q, k, v, p, use_pallas=use_pallas):
            return jax_ulysses(q, k, v, p, jnp.asarray(x["u"]), jnp.asarray(x["vb"]), mask, x["scale"], mesh=mesh,
                               axis="data", use_pallas=use_pallas)

        loss = lambda *a, fn=fn: jnp.sum(jnp.where(mask[..., None, None], fn(*a), 0.0) ** 2)  # noqa: E731
        out[use_pallas] = (np.asarray(jax.jit(fn)(*args)),
                           [np.asarray(g) for g in jax.jit(jax.grad(loss, argnums=(0, 1, 2, 3)))(*args)])
    return out


@pytest.mark.parametrize("use_kernel", [False, True], ids=["einsum", "kernel"])
def test_ulysses_function_matches_jax(two, jax_ulysses_run, use_kernel):
    """Each rank's time shard of the output and of the q, k, v gradients,
    and its heads of the table's gradient, joined, against the JAX
    function's whole ones (the kernel route against JAX's ``use_pallas``)."""
    ref_out, ref_grads = jax_ulysses_run[use_kernel]
    join = lambda name, dim: torch.cat([r["tensors"][f"ulysses.{use_kernel}.{name}"] for r in two], dim).numpy()  # noqa: E731
    np.testing.assert_allclose(join("out", 1), ref_out, atol=5e-5)
    for name, dim, ref in zip(("dq", "dk", "dv", "dp"), (1, 1, 1, 1), ref_grads):
        np.testing.assert_allclose(join(name, dim), ref, atol=5e-4, err_msg=name)


@pytest.mark.parametrize("impl", ["flash", "xla"])
def test_sequence_parallel_step_matches_one_process(one, two, impl):
    for rank in two:
        got, ref = rank[impl], one[impl]
        # one forward of two blocks: two attention layers, each through the Ulysses route
        assert got["calls"] == 2 and got["stats"] == {"engaged": 2, "fallback": 0, "reasons": {}}, got
        np.testing.assert_allclose(got["loss"], ref["loss"], atol=1e-5)
        np.testing.assert_allclose(got["grad_norm"], ref["grad_norm"], atol=1e-5 * max(1.0, ref["grad_norm"]))
    assert one[impl]["calls"] == 0 and one[impl]["stats"]["engaged"] == 0
    assert one[impl]["stats"]["reasons"] == {"axis 'data' has size 1 (need > 1)": 2}
    got, ref = two[0]["tensors"], one["tensors"]
    names = [k for k in ref if k.startswith(f"{impl}.")]
    for k in names:
        assert torch.equal(got[k], two[1]["tensors"][k]), k
        if not k.endswith("mhsa.pos_proj.weight"):
            torch.testing.assert_close(got[k], ref[k], rtol=0, atol=1e-5, msg=k)
    assert_params_close({k: got[k] for k in names if k.endswith("pos_proj.weight")},
                        {k: ref[k] for k in names if k.endswith("pos_proj.weight")}, f"{impl}.")


def test_evaluate_and_labels_under_sequence_parallelism(setup, one, two):
    for rank in two:
        loss, wer, refs, hyps = rank["eval"]
        np.testing.assert_allclose(loss, one["eval"][0], rtol=1e-5)
        assert (wer, refs, hyps) == tuple(one["eval"][1:]) and len(refs) == 8
        assert rank["labels"] == one["labels"] and len(rank["labels"]) == 8


def test_odd_length_falls_back_with_its_reason(one, two):
    """T' = 5 does not divide over two ranks: both attention layers of the
    pseudo-label forward take the dense path, and the counter says why."""
    for rank in two:
        assert rank["odd"] == {"stats": {"engaged": 0, "fallback": 2, "reasons": {"T 5 % mesh 2 != 0": 2}},
                               "calls": 0}
    assert one["odd"]["stats"]["reasons"] == {"axis 'data' has size 1 (need > 1)": 2}


def test_applicability_rule_and_the_ambient_layout():
    """`seq_parallel_applicable` on a layout read without processes (a
    2 × 1 grid: size 2 on 'data'), its reasons joined as the JAX rule joins
    them, one warning per reason, and `sequence_mesh` restoring the
    previous layout."""
    mesh = make_mesh(TC.MeshConfig(), devices=range(2))
    S.reset_fallback_stats()
    assert S.seq_parallel_applicable(mesh, "data", t=14, h=4)
    assert not S.seq_parallel_applicable(mesh, "data", t=13, h=3)
    assert not S.seq_parallel_applicable(mesh, "data", t=13, h=3, record=False)
    assert S.fallback_stats("seq_parallel") == {"engaged": 1, "fallback": 1,
                                                "reasons": {"heads 3 % mesh 2 != 0; T 13 % mesh 2 != 0": 1}}
    with S.sequence_mesh(mesh):
        assert S.active_sequence_mesh() == (mesh, "data") and S.sequence_mesh_engaged()
    assert S.active_sequence_mesh() is None
    with pytest.raises(ValueError, match="no axis 'time'"):
        S.set_sequence_mesh(mesh, "time")
    assert S.kernel_sharding_applicable(mesh, "data", BATCH)
    assert not S.kernel_sharding_applicable(mesh, "data", 7)
    assert S.fallback_stats("shard_map_kernels")["reasons"] == {"batch 7 % mesh 2 != 0": 1}
    S.reset_fallback_stats()
