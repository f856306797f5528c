"""Tensor parallelism over processes: the port's ``('data', 'model')``
layout, rule table, split train step, split Adafactor, checkpoints and
the vocabulary-sharded beam search, held against the port on one process
and against the JAX package on its 8-device virtual CPU mesh.

One launch of two gloo workers (`_torch_multiproc_helpers.
scenario_tensor_parallel`, model axis of 2) and the same scenario in this
process (model axis of 1), from the JAX initialisation of a 4-head tiny
model with noise, converted; one launch of four workers (Adafactor over a
model axis of 4, and the dry run's 2 × 2 layout).

Tolerances.  The rule table and the layout: equal.  The split train step
against one process: loss and gradient norm rtol 1e-5, gradients 1e-5 of
each tensor's largest entry, parameters as
`_torch_multiproc_helpers.assert_params_close` (the data-parallel tests'
bars: a split sums the FFN's and the attention's output over two partial
products, another order than one product); against the JAX trainer under
``MeshConfig(model_parallel_size=2)``: loss rtol 1e-5 and the parameters
as there.  Adafactor on split leaves against the unsplit port and against
``optax.adafactor``: parameters atol 1e-6, as ``test_torch_optim.py`` (a
split takes its means in another order); the slots against the unsplit
port rtol 1e-6 with an atol of 1e-8 (second moments reach ~10; 2.8e-7 apart
at most, relative, was read).  Checkpoints: bit-equal.  The sharded beam:
hypotheses and lengths equal, scores rtol 1e-6.  The LM (split ``out_proj``
and data-parallel) and pretraining (data-parallel) steps against one
process: losses rtol 1e-5, parameters as `assert_params_close`.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch
from jax.sharding import Mesh, PartitionSpec as P

from _torch_multiproc_helpers import (
    ADAFACTOR_LEAVES,
    adafactor_inputs,
    assert_params_close,
    launch,
    run_adafactor,
    scenario_tensor_parallel,
    tp_model_config,
)
from _torch_trainer_helpers import feature_config, make_corpus, model_config, perturbed_variables, train_config

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC as JaxCTC
from nn_conformer_for_speech_recognition_tpu.ops.decode import ctc_beam_search_sharded as jax_sharded_beam
from nn_conformer_for_speech_recognition_tpu.parallel import mesh as jmesh
from nn_conformer_for_speech_recognition_tpu.train.lm_loop import LMTrainer as JaxLMTrainer
from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer as JaxTrainer
from nn_conformer_for_speech_recognition_tpu.train.pretrain_loop import PretrainTrainer as JaxPretrainTrainer
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.convert import (
    flax_to_state_dict,
    lm_flax_to_state_dict,
    pretrain_flax_to_state_dict,
)
from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import ctc_beam_search
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import ShardSpec, make_mesh, param_split
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import restore_state

LM_WORDS = ["go", "stop", "up", "down", "a"]
LM_LEXICON = {"go": ["G", "OW"], "stop": ["S", "T", "AA", "P"], "up": ["AH", "P"], "down": ["D", "AW", "N"],
              "a": ["AH"]}
LM_CFG = dict(num_encoder_layers=1, num_decoder_layers=2, embed_dim=16, num_heads=2, ffn_dim=32, dropout=0.0)


def _jax_tp_config(attention_impl):
    cfg = model_config(C)
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, num_heads=4),
                               attention_impl=attention_impl)


@pytest.fixture(scope="module")
def setup(tmp_path_factory):
    root = tmp_path_factory.mktemp("tp")
    manifests, jvocab, tvocab, jdata, tdata = make_corpus(root / "corpus")
    jt = JaxTrainer(JaxCTC(_jax_tp_config("xla"), vocab_size=len(jvocab)), jvocab, feature_config(C),
                    train_config(C, donate_state=False), C.MeshConfig(model_parallel_size=2), log_fn=lambda _: None)
    jt.init_state(seed=0)
    variables = perturbed_variables(jt, np.random.default_rng(0))
    assert tp_model_config() == dataclasses.replace(model_config(TC), encoder=dataclasses.replace(
        model_config(TC).encoder, num_heads=4), attention_impl="flash")
    sd_path = str(root / "tp_start.pt")
    torch.save(flax_to_state_dict(variables, tp_model_config()), sd_path)
    rng = np.random.default_rng(3)
    logits = rng.standard_normal((3, 12, 16)).astype(np.float32)
    logits[:, :, 0] += 1.0  # blanks in the best paths, and repeats: both merge rules run
    lp = logits - np.log(np.exp(logits).sum(-1, keepdims=True))
    sentences = [" ".join(rng.choice(LM_WORDS, size=rng.integers(1, 6))) for _ in range(16)]
    args = {"manifests": manifests, "tp_state_dict": sd_path, "ckpt_dir": str(root / "ckpt"),
            "beam": {"lp": lp.tolist(), "lengths": [12, 9, 5]},
            "lm": {"sentences": sentences, "lexicon": LM_LEXICON, "words": LM_WORDS, "config": LM_CFG}}
    return dict(root=root, jt=jt, jdata=jdata, variables=variables, args=args, lp=lp)


@pytest.fixture(scope="module")
def one(setup):
    result, tensors = scenario_tensor_parallel(setup["args"])
    return {**result, "tensors": tensors}


@pytest.fixture(scope="module")
def two(setup, one):  # after `one`: the workers restore its checkpoint
    return launch("tensor_parallel", 2, setup["args"], str(setup["root"] / "two_out"))


@pytest.fixture(scope="module")
def four(setup):
    return launch("tensor_parallel_4", 4, {}, str(setup["root"] / "four_out"), timeout=400)


# -- the layout and the rule table (no processes)


@pytest.mark.parametrize("mp", [1, 2, 4, 8])
def test_layout_matches_jax_make_mesh(mp):
    cfg = C.MeshConfig(model_parallel_size=mp)
    ref = jmesh.make_mesh(cfg, devices=jax.devices()[:8])
    ids = np.vectorize(lambda d: d.id)(ref.devices)
    got = make_mesh(TC.MeshConfig(model_parallel_size=mp), devices=range(8))
    np.testing.assert_array_equal(got.devices, ids)
    assert got.shape == dict(ref.shape) and not got.bound
    with pytest.raises(ValueError, match="not divisible by model_parallel_size=3"):
        make_mesh(TC.MeshConfig(model_parallel_size=3), devices=range(8))


def _eval_shape_state(model, rngs, *args, **kw):
    return jax.eval_shape(lambda: model.init(rngs, *args, **kw))


def _trees():
    """(name, flax variables of zeros, their port state dict) of
    Conformer-M's, the LM's and the pretraining model's trees."""
    rngs = {k: jax.random.key(0) for k in ("params", "dropout", "mask", "gumbel")}
    feats, flens = jnp.zeros((2, 101, 80)), jnp.full((2,), 101)
    cm = C.conformer_m(use_pallas=True)
    lm = JaxLMTrainer(C.LMConfig(), 40, 1024, 1, log_fn=lambda _: None).model
    pt = JaxPretrainTrainer(C.conformer_m(), C.PretrainConfig(), C.FeatureConfig(), log_fn=lambda _: None).model
    zeros = lambda tree: jax.tree.map(lambda s: np.zeros(s.shape, np.float32), tree)  # noqa: E731
    shapes = {
        "conformer_m": (_eval_shape_state(JaxCTC(cm, vocab_size=1024), rngs, feats, flens),
                        lambda v: flax_to_state_dict(v, TC.conformer_m(use_pallas=True))),
        "lm": (_eval_shape_state(lm, rngs, jnp.zeros((2, 8), jnp.int32), jnp.zeros((2, 4), jnp.int32)),
               lambda v: lm_flax_to_state_dict(v["params"])),
        "pretrain": (_eval_shape_state(pt, rngs, feats, flens, deterministic=False),
                     pretrain_flax_to_state_dict),
    }
    return {k: (zeros(v), to_port) for k, (v, to_port) in shapes.items()}


@pytest.fixture(scope="module")
def trees():
    return _trees()


@pytest.mark.parametrize("mp", [2, 4])
@pytest.mark.parametrize("tree", ["conformer_m", "lm", "pretrain"])
def test_rule_table_matches_jax_param_shardings(trees, tree, mp):
    """Every leaf is split by the port's rule exactly where the JAX rule
    shards it, at 1/mp of its entries; the split layers' leaves are among
    them."""
    variables, to_port = trees[tree]
    mesh = jmesh.make_mesh(C.MeshConfig(model_parallel_size=mp))
    specs = jmesh.param_shardings(mesh, variables["params"], C.MeshConfig(model_parallel_size=mp))
    jax_split = {}
    for (path, leaf), (_, spec) in zip(jax.tree_util.tree_flatten_with_path(variables["params"])[0],
                                       jax.tree_util.tree_flatten_with_path(specs)[0]):
        jax_split["/".join(getattr(k, "key", str(k)) for k in path)] = any(a is not None for a in spec.spec)
    # the port's names of the same leaves: convert a tree whose leaves are their own flat index
    flat = jax.tree_util.tree_flatten_with_path(variables["params"])[0]
    marked = jax.tree_util.tree_unflatten(jax.tree_util.tree_structure(variables["params"]),
                                          [np.full(leaf.shape, i, np.float32) for i, (_, leaf) in enumerate(flat)])
    port_marked = to_port({**variables, "params": marked})
    split_names = set()
    for name, value in port_marked.items():
        if name.endswith(("running_mean", "running_var")):
            continue
        index = np.unique(port_marked[name].numpy())
        if len(index) != 1:  # a packed LSTM tensor: several flax leaves, none of which the JAX rule shards
            keys = [list(jax_split)[int(i)] for i in index]
            assert not any(jax_split[k] for k in keys), name
            assert param_split(name, value.shape, mp) is None, name
            continue
        key = list(jax_split)[int(index[0])]
        spec = param_split(name, value.shape, mp)
        assert (spec is not None) == jax_split[key], (name, key)
        if spec is not None:
            assert isinstance(spec, ShardSpec) and spec.parts == mp
            local = spec.local(value, 0)
            assert local.numel() * mp == value.numel(), name
            split_names.add(name)
    assert split_names, tree
    expect = {"conformer_m": ("mhsa.qkv.weight", "mhsa.pos_proj.weight", "mhsa.out_proj.weight",
                              "ffn1.fc1.weight", "ffn2.fc2.weight"),
              "lm": ("out_proj.weight",),
              "pretrain": ("context_net.blocks.0.mhsa.qkv.weight", "context_net.blocks.0.ffn1.fc2.weight")}[tree]
    for suffix in expect:
        assert any(n.endswith(suffix) for n in split_names), suffix


def test_qkv_split_is_aligned_to_heads():
    spec = param_split("encoder.blocks.0.mhsa.qkv.weight", (768, 256), 2)
    rows = spec.index(0).numpy()
    # rank 0 holds q, k and v of heads 0 and 1 (64 rows each), not all of q and half of k
    np.testing.assert_array_equal(rows, np.concatenate([np.arange(0, 128), np.arange(256, 384),
                                                        np.arange(512, 640)]))
    whole = torch.arange(768.0)[:, None].expand(768, 3)
    assert torch.equal(spec.whole([spec.local(whole, r) for r in range(2)]), whole)


# -- the split train step


@pytest.fixture(scope="module")
def jax_step(setup):
    jt, variables = setup["jt"], setup["variables"]
    placed = jmesh.shard_params(jt.mesh, variables["params"], jt.mesh_cfg)  # split over the model axis
    jt.state = jt.state.replace(params=placed, batch_stats=variables["batch_stats"], opt_state=jt.tx.init(placed))
    batch = next(setup["jdata"]["train"].epoch(seed=0))
    state, metrics = jt._composed_step(False, 0.0)(jt.state, *jt._put(batch))
    after = flax_to_state_dict(jax.tree.map(np.asarray, {"params": state.params, "batch_stats": state.batch_stats}),
                               tp_model_config())
    return float(metrics["loss"]), after


@pytest.mark.parametrize("impl", ["flash", "xla", "dropout"])
def test_split_step_matches_one_process(one, two, impl):
    """'dropout': every dropout at 0.1, the attention probabilities' too; a
    split activation's mask is drawn whole and sliced, a replicated one's
    alike on both ranks, so the split step drops what one process drops."""
    for rank in two:
        np.testing.assert_allclose(rank[impl]["loss"], one[impl]["loss"], rtol=1e-5)
        np.testing.assert_allclose(rank[impl]["grad_norm"], one[impl]["grad_norm"], rtol=1e-5)
    ref, got = one["tensors"], two[0]["tensors"]
    for k in (k for k in ref if k.startswith(f"{impl}.grad.")):
        scale = float(ref[k].abs().max())
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=1e-5 * scale + 1e-12, msg=k)
    assert_params_close(got, ref, f"{impl}.after.model.")
    for k in (k for k in got if k.startswith(f"{impl}.after.")):  # both model ranks hold the same whole state
        assert torch.equal(got[k], two[1]["tensors"][k]), k


def test_split_step_matches_the_jax_trainer(two, jax_step):
    """The JAX trainer's step under ``MeshConfig(model_parallel_size=2)``
    (einsum attention) against the port's split step on the same route."""
    loss, after = jax_step
    np.testing.assert_allclose(two[0]["xla"]["loss"], loss, rtol=1e-5)
    got = {f"m.{k}": v for k, v in ((k[len("xla.after.model."):], v) for k, v in two[0]["tensors"].items()
                                     if k.startswith("xla.after.model."))}
    assert_params_close(got, {f"m.{k}": v for k, v in after.items()}, "m.")


def test_evaluate_labels_and_the_resident_epoch_split(one, two):
    """`evaluate` with its texts and `generate_labels` after the split
    step, and a fused resident epoch of the split model, against one
    process: losses rtol 1e-5, WER, texts and labels equal."""
    for rank in two:
        np.testing.assert_allclose(rank["eval"][0], one["eval"][0], rtol=1e-5)
        assert rank["eval"][1:] == one["eval"][1:] and rank["labels"] == one["labels"]
        np.testing.assert_allclose(rank["resident"]["train_loss"], one["resident"]["train_loss"], rtol=1e-5)
    assert len(one["labels"]) == 8 and len(one["eval"][2]) == 8
    assert_params_close(two[0]["tensors"], one["tensors"], "resident.")


# -- checkpoints


def test_checkpoint_written_split_loads_whole(setup, two):
    """Written under mp = 2 and restored by one process (mp = 1): the
    tensors the workers held, gathered, bit for bit; the one process's
    checkpoint cut to the workers' shares and gathered again: its tensors."""
    from _torch_multiproc_helpers import port_datasets, tp_trainer, whole_state

    vocab, _ = port_datasets(setup["args"]["manifests"])
    tr = tp_trainer(vocab, setup["args"]["tp_state_dict"], "flash", TC.MeshConfig())
    restore_state(str(setup["root"] / "ckpt" / "mp2"), tr.state)
    got, ref = whole_state(tr), two[0]["tensors"]
    assert got.keys() == {k[len("flash.after."):] for k in ref if k.startswith("flash.after.")}
    for k, v in got.items():
        assert torch.equal(v, ref[f"flash.after.{k}"]), k
    saved = torch.load(setup["root"] / "ckpt" / "mp2" / "state.pt", weights_only=True)
    assert saved["model"]["encoder.blocks.0.mhsa.qkv.weight"].shape == (96, 32)  # whole, not a share


def test_checkpoint_written_whole_loads_split(one, two):
    restored = {k[len("restored."):]: v for k, v in two[0]["tensors"].items() if k.startswith("restored.")}
    ref = {k[len("flash.after."):]: v for k, v in one["tensors"].items() if k.startswith("flash.after.")}
    assert restored.keys() == ref.keys()
    for k, v in restored.items():
        assert torch.equal(v, ref[k]), k
        assert torch.equal(v, two[1]["tensors"][f"restored.{k}"]), k


# -- Adafactor under tensor parallelism


def _optax_adafactor():
    init, grads = adafactor_inputs()
    axes = {k: (1, 0) if len(shape) == 2 else (0,) for k, (shape, _, _) in ADAFACTOR_LEAVES.items()}
    tx = optax.adafactor(1e-2, multiply_by_parameter_scale=False, momentum=0.9, clipping_threshold=1.0)
    params = {k: jnp.asarray(v.transpose(axes[k])) for k, v in init.items()}
    state = tx.init(params)
    for g in grads:
        updates, state = tx.update({k: jnp.asarray(v.transpose(axes[k])) for k, v in g.items()}, state, params)
        params = optax.apply_updates(params, updates)
    return {k: np.asarray(v).transpose(axes[k]) for k, v in params.items()}


@pytest.fixture(scope="module")
def adafactor_refs():
    return run_adafactor(None), _optax_adafactor()


def _check_adafactor(tensors, refs):
    unsplit, optax_params = refs
    init, _ = adafactor_inputs()
    assert tensors.keys() == unsplit.keys()
    for k, ref in unsplit.items():  # second moments reach ~10: their bar is relative
        rtol, atol = (0, 1e-6) if k.startswith("param.") else (1e-6, 1e-8)
        torch.testing.assert_close(tensors[k], ref, rtol=rtol, atol=atol, msg=k)
    for k, ref in optax_params.items():
        assert np.abs(ref - init[k]).max() > 1e-3, k  # the parameter moved
        np.testing.assert_allclose(tensors[f"param.{k}"].numpy(), ref, atol=1e-6, err_msg=k)
    # factored as optax factors the whole parameter, though a share of 64 rows is below the threshold
    assert {k[len("slot."):-len(".v_row")] for k in unsplit if k.endswith(".v_row")} == {
        k for k, (shape, _, _) in ADAFACTOR_LEAVES.items() if len(shape) == 2 and min(shape) >= 128}


def test_adafactor_split_over_two_matches_unsplit_and_optax(two, adafactor_refs):
    tensors = {k[len("adafactor."):]: v for k, v in two[0]["tensors"].items() if k.startswith("adafactor.")}
    _check_adafactor(tensors, adafactor_refs)


def test_adafactor_split_over_four_matches_unsplit_and_optax(four, adafactor_refs):
    _check_adafactor(four[0]["tensors"], adafactor_refs)
    for k, v in four[0]["tensors"].items():
        assert torch.equal(v, four[3]["tensors"][k]), k


# -- the vocabulary-sharded beam search


def test_sharded_beam_matches_jax_and_the_dense_search(setup, two):
    lp, lengths = setup["lp"], np.asarray([12, 9, 5], np.int32)
    kw = dict(blank_id=0, beam=4, prune=4, max_label_len=12)
    mesh = Mesh(np.asarray(jax.devices()[:2]), ("model",))
    f = jax.shard_map(lambda x, n: jax_sharded_beam(x, n, axis="model", **kw), mesh=mesh,
                      in_specs=(P(None, None, "model"), P(None)), out_specs=(P(None), P(None), P(None)),
                      check_vma=False)
    j_toks, j_lens, j_scores = (np.asarray(x) for x in jax.jit(f)(jnp.asarray(lp), jnp.asarray(lengths)))
    d_toks, d_lens, d_scores = ctc_beam_search(torch.from_numpy(lp), torch.from_numpy(lengths), **kw)
    for rank in two:
        t = rank["tensors"]
        np.testing.assert_array_equal(t["beam.tokens"].numpy(), j_toks)
        np.testing.assert_array_equal(t["beam.lengths"].numpy(), j_lens)
        np.testing.assert_allclose(t["beam.scores"].numpy(), j_scores, rtol=1e-6)
        assert torch.equal(t["beam.tokens"], d_toks) and torch.equal(t["beam.lengths"], d_lens)
        torch.testing.assert_close(t["beam.scores"], d_scores, rtol=1e-6, atol=0)
    assert (d_lens[:, 0] > 1).all()


# -- the LM and pretraining trainers over a process group


@pytest.mark.parametrize("layout", ["tp", "dp"])
def test_lm_trainer_over_two_processes(one, two, layout):
    """The attention's key biases move by float noise: a key bias adds the
    same term to every score of a query row, which the softmax drops, so
    their gradient is exactly zero and what is left differs with the
    summation order; Adam turns it into steps of up to lr of either sign.
    They are held within two steps of lr (1e-3) a step; the rest as
    `assert_params_close`."""
    for rank in two:
        np.testing.assert_allclose(rank[f"lm_{layout}"]["losses"], one[f"lm_{layout}"]["losses"], rtol=1e-5)
        np.testing.assert_allclose(rank[f"lm_{layout}"]["eval"], one[f"lm_{layout}"]["eval"], rtol=1e-5)
    got, ref = two[0]["tensors"], one["tensors"]
    noise = {k for k in ref if k.startswith(f"lm_{layout}.") and k.endswith("key.bias")}
    assert noise
    for k in noise:
        torch.testing.assert_close(got[k], ref[k], rtol=0, atol=2 * 2 * 1e-3, msg=k)
    assert_params_close({k: v for k, v in got.items() if k not in noise and ".opt." not in k},
                        {k: v for k, v in ref.items() if k not in noise and ".opt." not in k}, f"lm_{layout}.")
    assert one["lm_tp"]["losses"][1] < one["lm_tp"]["losses"][0]


def test_lm_checkpoint_written_split_loads_whole(setup, two):
    """The LM written with its ``out_proj`` split over two ranks, AdamW's
    slots with it, restored by one process: the workers' tensors gathered,
    bit for bit."""
    from _torch_multiproc_helpers import lm_trainer

    tr, _ = lm_trainer(setup["args"], TC.MeshConfig())
    restore_state(str(setup["root"] / "ckpt" / "lm_mp2"), tr.state)
    got = {**tr.model.state_dict(),
           **{f"opt.{n}.{k}": v for n, st in tr.state.optimizer.state.items() for k, v in st.items()}}
    ref = {k[len("lm_tp."):]: v for k, v in two[0]["tensors"].items() if k.startswith("lm_tp.")}
    assert got.keys() == ref.keys() and "opt.out_proj.weight.mu" in got
    for k, v in got.items():
        assert torch.equal(v, ref[k]), k


def test_pretrain_trainer_over_two_processes(one, two):
    for rank in two:
        np.testing.assert_allclose(rank["pretrain"]["losses"], one["pretrain"]["losses"], rtol=1e-5)
    assert_params_close(two[0]["tensors"], one["tensors"], "pretrain.")
    for k in (k for k in two[0]["tensors"] if k.startswith("pretrain.")):
        assert torch.equal(two[0]["tensors"][k], two[1]["tensors"][k]), k


# -- the dry run's twin


def test_dryrun_twin_on_four_processes(four):
    for rank in four:
        dry = rank["dryrun"]
        assert dry["mesh"] == {"data": 2, "model": 2} and np.isfinite(dry["loss"])
        assert sorted(int(k) for k in dry["labels"]) == list(range(8))
    assert len({r["dryrun"]["loss"] for r in four}) == 1
