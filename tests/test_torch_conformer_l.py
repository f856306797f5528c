"""Conformer-L's widths (d_model 512, 8 heads of 64, FFN 2048, conv kernel
33, BiLSTM H = 640; `config.conformer_l` cut to 2 blocks), JAX vs port:
the weight conversion, the pseudo-label pass and one float32 train step.

The JAX side runs the product's kernel path as its own tests run it on the
CPU: ``use_pallas=True`` (the Pallas BiLSTM in interpret mode; in eval the
flash attention in interpret mode, in training the einsum route, as at
every T' below 768), ``ctc_impl="pallas"`` (the Pallas CTC in interpret
mode), float32, dropout 0, SpecAugment off, one Adafactor step at lr 1e-3.
The port loads the converted weights and runs the same pass and step on the
CPU through its kernels' plain twins: on the card the same calls reach the
grid LSTM kernels (H = 640 is past the cluster's shared memory).

Tolerances are those of test_torch_slice.py (log-probs atol 1e-4 on valid
frames, greedy ids and lengths equal) and test_torch_train.py (loss and
gradient norm rtol 1e-5; each gradient atol 1e-4 of its tensor's largest
entry; each batch statistic atol 1e-5; each factored update atol 1e-4·lr,
an unfactored one on the entries whose gradient is clear of 0 by 1e-4 of
its tensor's largest, and bounded by 0.1·lr elsewhere), with one case
that those tiny widths never meet: a factored parameter whose gradient has
a row or column at noise level (its largest entry within 1e-4 of the
tensor's largest of 0).  At these widths that is each block's ``pos_proj``:
the input dims where the sinusoidal table is constant over the 2T' - 1
relative positions get, in exact arithmetic, a zero gradient (every query's
softmax gradient sums to 0 over the keys), in float32 ~2e-8 against 0.08.
Adafactor normalises each column by its own scale, so those columns take
full-size steps of noise-determined sign on either side, and the update's
RMS clip, taken over every entry, rescales the whole matrix by a factor
that noise sets (0.986 and 1.003 here).  There the update is held at
1e-4·lr on the rows and columns whose gradient reaches 1e-2 of the largest,
after dividing out that common factor, which is itself held within 0.1 of
1.  Batch: 3 rows of 1 s audio (T' = 16), lengths 16000, 11200, 6000; 4
targets a row, the last row none; vocabulary 48.  One JAX run serves the
file (module-scoped).
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu.ops.features import log_mel_spectrogram
from nn_conformer_for_speech_recognition_tpu.ops.pallas.ctc import ctc_loss_pallas
from nn_conformer_for_speech_recognition_tpu.train import loop as JL
from nn_conformer_for_speech_recognition_tpu.train.optim import make_optimizer as jax_make_optimizer
from nn_conformer_for_speech_recognition_tpu.train.state import TrainState as JaxTrainState
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC as TorchCTC
from nn_conformer_for_speech_recognition_tpu_torch.ops.features import make_featurizer
from nn_conformer_for_speech_recognition_tpu_torch.train import loop as TL
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState

LR, VOCAB, PAD_ID, SAMPLES = 1e-3, 48, 1, 16000


def _config(lib):
    cfg = lib.conformer_l(use_pallas=True, compute_dtype="float32")
    return dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, num_blocks=2, dropout=0.0),
                               decoder=dataclasses.replace(cfg.decoder, dropout=0.0))


@pytest.fixture(scope="module")
def jax_run():
    """The batch, the JAX model's perturbed variables, its pass (log-probs,
    lengths, greedy ids of `make_predict_step`), and one train step: the
    metrics, the gradients of its loss and the updated state, in the port's
    names (`flax_to_state_dict`)."""
    rng = np.random.default_rng(17)
    lengths = np.asarray([SAMPLES, 11200, 6000], np.int32)
    audio = rng.standard_normal((3, SAMPLES)).astype(np.float32) * 0.1
    audio *= np.arange(SAMPLES)[None, :] < lengths[:, None]
    targets = rng.integers(3, VOCAB, size=(3, 4)).astype(np.int32)
    tlen = np.asarray([4, 2, 0], np.int32)
    jcfg, tcfg = _config(C), _config(TC)
    model = ConformerCTC(jcfg, vocab_size=VOCAB)
    feats, flens = log_mel_spectrogram(jnp.asarray(audio), C.FeatureConfig(), jnp.asarray(lengths))
    vs = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, feats, flens)
    vs = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), vs)
    vs["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, vs["batch_stats"])

    log_probs, out_len = jax.jit(lambda f, n: model.apply(vs, f, n, deterministic=True))(feats, flens)
    frozen = types.SimpleNamespace(params=vs["params"], batch_stats=vs["batch_stats"])
    predict = JL.make_predict_step(model, C.FeatureConfig(), PAD_ID)
    ids, ids_len = jax.jit(lambda a, n: predict(frozen, a, n))(jnp.asarray(audio), jnp.asarray(lengths))

    jargs = [jnp.asarray(a) for a in (audio, lengths, targets, tlen)]
    state = JaxTrainState.create(vs["params"], vs["batch_stats"], jax_make_optimizer(C.OptimizerConfig(learning_rate=LR)),
                                 jax.random.key(0))
    step = JL.make_train_step(model, C.FeatureConfig(), C.SpecAugmentConfig(), 0, use_specaugment=False,
                              ctc_impl="pallas")
    new_state, metrics = jax.jit(step)(state, *jargs)

    def loss_fn(params):  # the JAX step's loss, for its gradients
        (lp, ol), _ = model.apply({"params": params, "batch_stats": vs["batch_stats"]}, feats, flens,
                                  deterministic=False, rngs={"dropout": jax.random.key(2)}, mutable=["batch_stats"])
        per_seq = ctc_loss_pallas(lp, jargs[2], ol, jargs[3], blank_id=0, reduction=None, interpret=True)
        w = (jargs[3] > 0).astype(jnp.float32)
        return jnp.sum(per_seq / jnp.maximum(jargs[3], 1) * w) / jnp.maximum(jnp.sum(w), 1.0)

    return dict(
        batch=(audio, lengths, targets, tlen), vs=vs, tcfg=tcfg,
        log_probs=np.asarray(log_probs), out_len=np.asarray(out_len), ids=np.asarray(ids), ids_len=np.asarray(ids_len),
        loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
        grads=flax_to_state_dict({"params": jax.jit(jax.grad(loss_fn))(vs["params"])}, tcfg),
        after=flax_to_state_dict({"params": new_state.params, "batch_stats": new_state.batch_stats}, tcfg),
    )


def _port(run) -> TorchCTC:
    model = TorchCTC(run["tcfg"], VOCAB)
    model.load_state_dict(flax_to_state_dict(run["vs"], run["tcfg"]), strict=True)
    return model


@pytest.fixture(scope="module")
def port_step(jax_run):
    """The port's train step from the converted weights: the model after it,
    its metrics, its state and the weights before it."""
    model = _port(jax_run)
    before = {k: v.clone() for k, v in model.state_dict().items()}
    state = TrainState.create(model, make_optimizer(TC.OptimizerConfig(learning_rate=LR), model.named_parameters()),
                              seed=0)
    step = TL.make_train_step(model, TC.FeatureConfig(), TC.SpecAugmentConfig(), 0, use_specaugment=False)
    state, metrics = step(state, *[torch.from_numpy(a) for a in jax_run["batch"]])
    return dict(model=model, metrics=metrics, state=state, before=before)


def test_every_leaf_maps_once_at_conformer_l_width(jax_run):
    """Every leaf of the JAX variables (the packed BiLSTM layout at H = 640,
    both directions) becomes exactly one tensor of the port's state, and
    every parameter and buffer of the port is filled with its shape."""
    sd = flax_to_state_dict(jax_run["vs"], jax_run["tcfg"])
    assert len(sd) == len(jax.tree.leaves(jax_run["vs"]))
    model = TorchCTC(jax_run["tcfg"], VOCAB)
    assert set(sd) == set(model.state_dict())
    model.load_state_dict(sd, strict=True)
    lstm = jax_run["vs"]["params"]["decoder_lstm"]
    for name in ("fwd", "bwd"):
        w_hh = sd[f"decoder_lstm.lstm_{name}_0_w_hh"]
        assert w_hh.shape == (640, 2560)
        np.testing.assert_array_equal(w_hh.numpy(), np.asarray(lstm[f"lstm_{name}_0_w_hh"]))
    assert sd["encoder.blocks.1.mhsa.qkv.weight"].shape == (3 * 512, 512)


def test_pass_matches_jax_at_conformer_l_width(jax_run):
    """The pseudo-label pass (`make_predict_step`) and the eval forward:
    lengths and greedy ids equal, log-probs within 1e-4 on valid frames."""
    model = _port(jax_run)
    audio, lengths = (torch.from_numpy(a) for a in jax_run["batch"][:2])
    ids, ids_len = TL.make_predict_step(model, TC.FeatureConfig(), PAD_ID)(audio, lengths)
    with torch.inference_mode():
        lp, out_len = model(*make_featurizer(TC.FeatureConfig())(audio, lengths))
    np.testing.assert_array_equal(out_len.numpy(), jax_run["out_len"])
    np.testing.assert_array_equal(ids_len.numpy(), jax_run["ids_len"])
    for row, n in enumerate(out_len.tolist()):
        np.testing.assert_allclose(lp[row, :n].numpy(), jax_run["log_probs"][row, :n], atol=1e-4)
    np.testing.assert_array_equal(ids.numpy(), jax_run["ids"])


def test_train_step_loss_and_norm_match_jax_at_conformer_l_width(jax_run, port_step):
    assert port_step["state"].step == 1 and port_step["state"].optimizer.count == 1
    np.testing.assert_allclose(port_step["metrics"]["loss"].item(), jax_run["loss"], rtol=1e-5)
    np.testing.assert_allclose(port_step["metrics"]["grad_norm"].item(), jax_run["grad_norm"], rtol=1e-5)


def test_train_step_gradients_match_jax_at_conformer_l_width(jax_run, port_step):
    """Every parameter's gradient, the BiLSTM's w_ih, w_hh and bias at H =
    640 among them, within 1e-4 of its tensor's largest entry."""
    for name, p in port_step["model"].named_parameters():
        ref = jax_run["grads"][name].numpy()
        scale = np.abs(ref).max()
        assert scale > 0 and np.all(np.isfinite(p.grad.numpy())), name
        np.testing.assert_allclose(p.grad.numpy(), ref, atol=1e-4 * scale, err_msg=name)


def _noise_level_lines(g: np.ndarray, scale: float) -> bool:
    """Whether a 2-D gradient has a row or column whose largest entry is
    within 1e-4 of the tensor's largest of 0."""
    return g.ndim == 2 and min(np.abs(g).max(0).min(), np.abs(g).max(1).min()) <= 1e-4 * scale


def test_train_step_updates_match_jax_at_conformer_l_width(jax_run, port_step):
    """The updated parameters and batch statistics, as test_torch_train.py
    holds them; a factored parameter with rows or columns of noise-level
    gradient (each block's ``pos_proj``), on its well-conditioned rows and
    columns up to the RMS clip's common factor (the module docstring)."""
    after, before = port_step["model"].state_dict(), port_step["before"]
    grads = dict(port_step["model"].named_parameters())
    opt_state = port_step["state"].optimizer.state
    for name, ref in jax_run["after"].items():
        got, ref, start = after[name].numpy(), ref.numpy(), before[name].numpy()
        if name not in grads:  # a batch statistic
            assert not np.array_equal(ref, start), name
            np.testing.assert_allclose(got, ref, atol=1e-5, err_msg=name)
            continue
        step_ref, step_got = ref - start, got - start
        g_ref = jax_run["grads"][name].numpy()
        scale = np.abs(g_ref).max()
        if "v_row" in opt_state[name] and _noise_level_lines(g_ref, scale):
            rows, cols = np.abs(g_ref).max(1) > 1e-2 * scale, np.abs(g_ref).max(0) > 1e-2 * scale
            got_c, ref_c = step_got[rows][:, cols], step_ref[rows][:, cols]
            clip = (got_c * ref_c).sum() / (ref_c * ref_c).sum()
            assert abs(clip - 1) <= 0.1, (name, clip)
            np.testing.assert_allclose(got_c, clip * ref_c, atol=1e-4 * LR, err_msg=name)
            continue
        if "v_row" in opt_state[name]:  # factored: the update is continuous in g
            np.testing.assert_allclose(step_got, step_ref, atol=1e-4 * LR, err_msg=name)
            continue
        clear = np.abs(g_ref) > 1e-4 * scale
        np.testing.assert_allclose(step_got[clear], step_ref[clear], atol=1e-4 * LR, err_msg=name)
        bound = 0.1 * LR * (1 + 1e-6) + 2 * np.spacing(np.abs(start))
        assert np.all(np.abs(step_got) <= bound), name


def test_conv_module_matches_jax_at_conformer_l_width():
    """The conv module at Conformer-L's width under ``conv_impl='pallas'``
    (d_model 512, C = 1024, K = 33; the JAX ``ConvModule`` with
    ``use_pallas=True``, its ``dw_kernel`` (K, C) leaf converted by
    `flax_to_state_dict`): training mode (batch statistics of the valid
    frames, dropout 0) on B=2 rows of T=37 frames, lengths 37 and 20, the
    Pallas conv in interpret mode.  The output atol 1e-4; the gradients
    with respect to the input and every parameter (``dw_kernel`` through
    the dw twin in tile order) atol 1e-4 of each tensor's largest entry;
    the updated running statistics atol 1e-5."""
    from nn_conformer_for_speech_recognition_tpu.models.conformer import ConvModule as JaxConvModule
    from nn_conformer_for_speech_recognition_tpu_torch.models.conformer import ConvModule

    d_model, k, b, t = 512, 33, 2, 37
    rng = np.random.default_rng(23)
    x = rng.standard_normal((b, t, d_model)).astype(np.float32)
    mask = (np.arange(t)[None, :] < np.asarray([t, 20])[:, None]).astype(np.float32)
    r = rng.standard_normal((b, t, d_model)).astype(np.float32)
    jmod = JaxConvModule(d_model=d_model, kernel_size=k, expansion=2, dropout=0.0, use_pallas=True)
    vs = jmod.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask), deterministic=False)
    vs = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), vs)
    vs["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, vs["batch_stats"])
    assert vs["params"]["dw_kernel"].shape == (k, 2 * d_model)

    def loss(params, xin):
        out, updated = jmod.apply({"params": params, "batch_stats": vs["batch_stats"]}, xin, jnp.asarray(mask),
                                  deterministic=False, mutable=["batch_stats"])
        return (out * r).sum(), (out, updated["batch_stats"])

    (_, (jout, jstats)), (jgp, jgx) = jax.value_and_grad(loss, argnums=(0, 1), has_aux=True)(vs["params"], jnp.asarray(x))

    def port_names(tree):  # the module's leaves under the port's names, as a block's "conv." subtree converts
        state = flax_to_state_dict({name: {"conv": sub} for name, sub in tree.items()}, _config(TC))
        return {name.removeprefix("conv."): value for name, value in state.items()}

    module = ConvModule(d_model, k, 2, 0.0, use_kernel=True)
    module.load_state_dict(port_names(vs), strict=True)
    module.train()
    xt = torch.from_numpy(x).requires_grad_(True)
    out = module(xt, torch.from_numpy(mask).bool())
    (out * torch.from_numpy(r)).sum().backward()
    np.testing.assert_allclose(out.detach().numpy(), np.asarray(jout), atol=1e-4)
    np.testing.assert_allclose(xt.grad.numpy(), np.asarray(jgx), atol=1e-4 * np.abs(np.asarray(jgx)).max())
    grads = port_names({"params": jgp})
    assert set(grads) == {n for n, _ in module.named_parameters()}
    for name, p in module.named_parameters():
        want = grads[name].numpy()
        np.testing.assert_allclose(p.grad.numpy(), want, atol=1e-4 * np.abs(want).max(), err_msg=name)
    stats = port_names({"batch_stats": jstats})
    for name, buf in module.named_buffers():
        np.testing.assert_allclose(buf.numpy(), stats[name].numpy(), atol=1e-5, err_msg=name)
