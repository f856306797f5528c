"""The supervised train step, JAX vs port, and the port's train-mode faults.

The JAX side runs the product's kernel path as its own tests run it on the
CPU: ``use_pallas=True`` (the Pallas BiLSTM in interpret mode; attention on
the einsum path, as at every T below 768), ``ctc_impl="pallas"`` (the
Pallas CTC in interpret mode), float32, dropout 0, SpecAugment off, one
Adafactor step at lr 1e-3.  The port loads the converted weights and runs
the same step on the CPU through its kernels' plain twins.

Tolerances (float32 on both sides, sums in another order): loss and
gradient norm rtol 1e-5; each gradient atol 1e-4 of its tensor's largest
entry; each batch statistic atol 1e-5; each parameter update atol 1e-4·lr,
except, for a parameter Adafactor does not factor, on entries whose
gradient is within 1e-4 of its tensor's largest gradient of 0: there the
first step (±0.1·lr, the sign of the gradient) may take either sign, and
the update is only bounded by 0.1·lr (plus the float32 rounding of the
parameter it is added to).  The subsampling's second conv (512 × 128
channels) is factored, so the factored update is held too.

The same step is held with ``conv_impl='pallas'`` at K = 4 (the JAX side
through its Pallas depthwise conv in interpret mode, the port through
`DepthwiseConv1d` over the plain twin), and with ``attention_impl='flash'`` (d_model 32): the JAX
side then trains through its flash forward and its three backward kernels
in interpret mode, the port through `RelPosFlashAttention` over the plain
twins, under the same tolerances.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.models import conformer as JCM
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu.ops.features import log_mel_spectrogram
from nn_conformer_for_speech_recognition_tpu.ops.pallas.ctc import ctc_loss_pallas
from nn_conformer_for_speech_recognition_tpu.ops.relshift import rel_shift as jax_rel_shift
from nn_conformer_for_speech_recognition_tpu.train import loop as JL
from nn_conformer_for_speech_recognition_tpu.train.optim import make_optimizer as jax_make_optimizer
from nn_conformer_for_speech_recognition_tpu.train.state import TrainState as JaxTrainState
from nn_conformer_for_speech_recognition_tpu.utils import flops as JF
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.models import conformer as TCM
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC as TorchCTC
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import init_params
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.attention import (
    flash_relpos_attention,
    flash_relpos_attention_plain,
)
from nn_conformer_for_speech_recognition_tpu_torch.train import loop as TL
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState
from nn_conformer_for_speech_recognition_tpu_torch.utils import flops as TF

LR, VOCAB = 1e-3, 12


def _tiny(lib, d_model=16, conv_kernel_size=5, **kw):
    enc = lib.ConformerConfig(num_blocks=2, d_model=d_model, num_heads=2, ffn_dim=32, conv_kernel_size=conv_kernel_size,
                              dropout=0.0)
    dec = lib.DecoderConfig(projection_dim=8, lstm_hidden=8, dropout=0.0)
    return lib.ModelConfig(encoder=enc, decoder=dec, use_pallas=True, compute_dtype="float32", **kw)


def _batch(rng):
    lengths = np.asarray([8000, 5600, 3000], np.int32)
    audio = rng.standard_normal((3, 8000)).astype(np.float32) * 0.1
    audio *= np.arange(8000)[None, :] < lengths[:, None]
    targets = rng.integers(3, VOCAB, size=(3, 4)).astype(np.int32)
    tlen = np.asarray([4, 2, 0], np.int32)  # the last row has no target
    return audio, lengths, targets, tlen


def _jax_model(rng, audio, lengths, **cfg):
    model = ConformerCTC(_tiny(C, **cfg), vocab_size=VOCAB)
    feats, flens = log_mel_spectrogram(jnp.asarray(audio), C.FeatureConfig(), jnp.asarray(lengths))
    vs = model.init({"params": jax.random.key(0), "dropout": jax.random.key(1)}, feats, flens)
    vs = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), vs)
    vs["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, vs["batch_stats"])
    return model, vs, feats, flens


def _port(vs, **cfg):
    tm = TorchCTC(_tiny(TC, **cfg), VOCAB)
    tm.load_state_dict(flax_to_state_dict(vs, _tiny(TC, **cfg)), strict=True)
    return tm


def test_train_step_matches_jax(rng):
    _check_train_step_matches_jax(rng)


def test_flash_train_step_matches_jax(rng, monkeypatch):
    """The long-form route at a tiny size: ``attention_impl='flash'`` trains
    through the flash forward (with lse) and the dq, dkv and dband backward
    on both sides, and the step agrees as the einsum-route step does."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as TA

    calls = []
    backward = TA.flash_relpos_attention_backward_plain
    monkeypatch.setattr(TA, "flash_relpos_attention_backward_plain", lambda *a: calls.append(1) or backward(*a))
    _check_train_step_matches_jax(rng, d_model=32, attention_impl="flash")
    assert len(calls) == 2  # one attention backward per block


def test_pallas_conv_train_step_matches_jax(rng, monkeypatch):
    """``conv_impl='pallas'`` at an even kernel size (K = 4, where the pad
    split matters): the JAX side trains through its Pallas depthwise conv
    in interpret mode and its jnp backward, the port through
    `DepthwiseConv1d` over the plain twin; loss, gradient norm, every
    gradient (``dw_kernel``'s included) and every update agree as in the
    'auto' step, and each block's conv ran forward and dx once."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import depthwise_conv as TD

    calls = []
    forward = TD.depthwise_conv1d_forward
    monkeypatch.setattr(TD, "depthwise_conv1d_forward",
                        lambda x, w, pad_lo=None, reverse_taps=False: calls.append((pad_lo, reverse_taps))
                        or forward(x, w, pad_lo, reverse_taps))
    _check_train_step_matches_jax(rng, conv_kernel_size=4, conv_impl="pallas")
    assert sorted(calls, key=str) == sorted([(None, False)] * 2 + [(2, True)] * 2, key=str)


def _check_train_step_matches_jax(rng, **cfg):
    audio, lengths, targets, tlen = _batch(rng)
    model, vs, feats, flens = _jax_model(rng, audio, lengths, **cfg)
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

    ref_grads = flax_to_state_dict({"params": jax.jit(jax.grad(loss_fn))(vs["params"])}, _tiny(TC, **cfg))
    ref_after = flax_to_state_dict({"params": new_state.params, "batch_stats": new_state.batch_stats}, _tiny(TC, **cfg))

    tm = _port(vs, **cfg)
    before = {k: v.clone() for k, v in tm.state_dict().items()}
    tstate = TrainState.create(tm, make_optimizer(TC.OptimizerConfig(learning_rate=LR), tm.named_parameters()), seed=0)
    tstep = TL.make_train_step(tm, TC.FeatureConfig(), TC.SpecAugmentConfig(), 0, use_specaugment=False)
    tstate, tmetrics = tstep(tstate, *[torch.from_numpy(a) for a in (audio, lengths, targets, tlen)])

    assert tstate.step == 1 and tstate.optimizer.count == 1
    np.testing.assert_allclose(tmetrics["loss"].item(), float(metrics["loss"]), rtol=1e-5)
    np.testing.assert_allclose(tmetrics["grad_norm"].item(), float(metrics["grad_norm"]), rtol=1e-5)
    after = tm.state_dict()
    grads = dict(tm.named_parameters())
    for name, ref in ref_after.items():
        got = after[name].numpy()
        if name not in grads:  # a batch statistic
            assert not np.array_equal(ref.numpy(), before[name].numpy()), name
            np.testing.assert_allclose(got, ref.numpy(), atol=1e-5, err_msg=name)
            continue
        g, g_ref = grads[name].grad.numpy(), ref_grads[name].numpy()
        scale = np.abs(g_ref).max()
        assert scale > 0 and np.all(np.isfinite(g)), name
        np.testing.assert_allclose(g, g_ref, atol=1e-4 * scale, err_msg=name)
        step_ref, step_got = ref.numpy() - before[name].numpy(), got - before[name].numpy()
        if "v_row" in tstate.optimizer.state[name]:  # factored: the update is continuous in g
            np.testing.assert_allclose(step_got, step_ref, atol=1e-4 * LR, err_msg=name)
            continue
        clear = np.abs(g_ref) > 1e-4 * scale
        np.testing.assert_allclose(step_got[clear], step_ref[clear], atol=1e-4 * LR, err_msg=name)
        bound = 0.1 * LR * (1 + 1e-6) + 2 * np.spacing(np.abs(before[name].numpy()))  # float32 lr·0.1 and p + u
        assert np.all(np.abs(step_got) <= bound), name


def test_eval_step_matches_jax(rng):
    audio, lengths, targets, tlen = _batch(rng)
    model, vs, _, _ = _jax_model(rng, audio, lengths)
    state = types.SimpleNamespace(params=vs["params"], batch_stats=vs["batch_stats"])
    jax_eval = JL.make_eval_step(model, C.FeatureConfig(), 0, 1, ctc_impl="pallas")
    loss, ids, out_len = jax.jit(lambda *a: jax_eval(state, *a))(*[jnp.asarray(a) for a in (audio, lengths, targets, tlen)])
    tm = _port(vs)
    got_loss, got_ids, got_len = TL.make_eval_step(tm, TC.FeatureConfig(), 0, 1)(
        *[torch.from_numpy(a) for a in (audio, lengths, targets, tlen)])
    np.testing.assert_allclose(got_loss.item(), float(loss), rtol=1e-5)
    np.testing.assert_array_equal(got_len.numpy(), np.asarray(out_len))
    np.testing.assert_array_equal(got_ids.numpy(), np.asarray(ids))


def test_masked_batchnorm_update_matches_jax(rng):
    x = rng.standard_normal((3, 7, 5)).astype(np.float32) * 2 + 1
    mask = np.arange(7)[None, :] < np.asarray([7, 4, 1])[:, None]
    jm = JCM.MaskedBatchNorm()
    vs = jm.init(jax.random.key(0), jnp.asarray(x), jnp.asarray(mask))
    vs = {"params": {"scale": np.full(5, 1.5, np.float32), "bias": np.full(5, 0.2, np.float32)},
          "batch_stats": {"mean": rng.standard_normal(5).astype(np.float32), "var": np.full(5, 2.0, np.float32)}}
    ref, upd = jm.apply(vs, jnp.asarray(x), jnp.asarray(mask), mutable=["batch_stats"])
    tm = TCM.MaskedBatchNorm(5)
    tm.load_state_dict(flax_to_state_dict(vs, None), strict=True)
    got = tm.train()(torch.from_numpy(x), torch.from_numpy(mask))
    np.testing.assert_allclose(got.detach().numpy()[mask], np.asarray(ref)[mask], atol=1e-5)
    np.testing.assert_allclose(tm.running_mean.numpy(), np.asarray(upd["batch_stats"]["mean"]), atol=1e-6)
    np.testing.assert_allclose(tm.running_var.numpy(), np.asarray(upd["batch_stats"]["var"]), atol=1e-6)


# -- faults of the port's train mode ---------------------------------------


def test_attention_route():
    """Fault 1 and its long-form sequel: eval goes through the kernel at
    every length; training with 'flash' does too; training with 'auto'
    switches to the kernel at 768 subsampled frames, where the JAX package
    switches (below it the einsum route, which drops probabilities); 'xla'
    and ``use_pallas=False`` never take the kernel."""
    cfg = TC.conformer_m(use_pallas=True)
    assert TC.ATTENTION_KERNEL_MIN_T_TRAINING == C.FLASH_ATTENTION_MIN_T == 768
    for t in (1, 235, 767, 768, 938):
        assert TC.attention_route(cfg, training=False, t=t) == "kernel"
        assert TC.attention_route(cfg, training=True, t=t) == ("kernel" if t >= 768 else "einsum")
        flash = dataclasses.replace(cfg, attention_impl="flash")
        assert TC.attention_route(flash, False, t) == TC.attention_route(flash, True, t) == "kernel"
        xla = dataclasses.replace(cfg, attention_impl="xla")
        assert TC.attention_route(xla, False, t) == TC.attention_route(xla, True, t) == "einsum"
        assert TC.attention_route(TC.conformer_m(), True, t) == TC.attention_route(TC.conformer_m(), False, t) == "einsum"
        assert TC.attention_route(TC.conformer_m(attention_impl="flash"), True, t) == "einsum"


def test_attention_route_in_the_model_follows_the_length(rng, monkeypatch):
    """'auto' in training: the encoder gets the kernel route from 768
    frames on and the einsum route below; the switch is passed the
    subsampled length."""
    from nn_conformer_for_speech_recognition_tpu_torch.models import asr as TA

    seen = []
    route = TC.attention_route
    monkeypatch.setattr(TA, "attention_route", lambda c, tr, t: seen.append((tr, t)) or route(c, tr, t))
    tm = init_params(TorchCTC(_tiny(TC), VOCAB), torch.Generator().manual_seed(0))
    kernel = []
    tm.encoder.register_forward_pre_hook(lambda _, args: kernel.append(args[2]))
    feats = torch.from_numpy(rng.standard_normal((1, 3069, 40)).astype(np.float32))
    with torch.no_grad():
        tm.train()(feats, torch.tensor([3069]))  # 3069 frames → 768
        tm.train()(feats[:, :3064], torch.tensor([3064]))  # → 766
        tm.eval()(feats[:, :64], torch.tensor([64]))
    assert seen == [(True, 768), (True, 766), (False, 16)]
    assert kernel == [True, False, True]


def test_attention_gradients_reach_every_input(rng):
    """The wrapper differentiates (it once refused inputs that need a
    gradient): through `RelPosFlashAttention` the gradients of qu, qv, k,
    v and p equal autograd's through the plain attention (atol 1e-5), and
    without a gradient or under ``no_grad`` it returns a plain tensor."""
    arrays = [rng.standard_normal((2, 5, 2, 8)).astype(np.float32) for _ in range(4)]
    arrays.append(rng.standard_normal((9, 2, 8)).astype(np.float32))
    lens, r = torch.tensor([5, 3]), torch.from_numpy(rng.standard_normal((2, 5, 2, 8)).astype(np.float32))
    grads = []
    for fn in (flash_relpos_attention, flash_relpos_attention_plain):
        leaves = [torch.from_numpy(a).clone().requires_grad_(True) for a in arrays]
        out = fn(*leaves, lens, 0.35)
        assert out.requires_grad
        (out * r).sum().backward()
        grads.append([x.grad for x in leaves])
    for name, got, ref in zip(("qu", "qv", "k", "v", "p"), *grads):
        assert got is not None and got.abs().max() > 0, name
        torch.testing.assert_close(got, ref, rtol=0, atol=1e-5, msg=name)
    plain = [torch.from_numpy(a) for a in arrays]
    assert not flash_relpos_attention(*plain, lens, 0.35).requires_grad
    with torch.no_grad():
        assert not flash_relpos_attention(plain[0].clone().requires_grad_(True), *plain[1:], lens, 0.35).requires_grad


def test_train_step_gives_every_parameter_a_gradient(rng):
    """Fault 1: with the kernel path configured (use_pallas, attention
    'auto'), a train step reaches every parameter with a finite, non-zero
    gradient, and the loss falls on a repeated batch."""
    cfg = dataclasses.replace(_tiny(TC), encoder=dataclasses.replace(_tiny(TC).encoder, dropout=0.1))
    tm = init_params(TorchCTC(cfg, VOCAB), torch.Generator().manual_seed(0))
    state = TrainState.create(tm, make_optimizer(TC.OptimizerConfig(learning_rate=3e-2), tm.named_parameters()), seed=1)
    step = TL.make_train_step(tm, TC.FeatureConfig(), TC.SpecAugmentConfig(), 0, emit_ids=True)
    batch = [torch.from_numpy(a) for a in _batch(rng)]
    losses = []
    for i in range(6):
        state, metrics = step(state, *batch)
        losses.append(metrics["loss"].item())
        if i == 0:
            for name, p in tm.named_parameters():
                assert p.grad is not None and torch.isfinite(p.grad).all() and p.grad.abs().max() > 0, name
    assert metrics["ids"].shape == (3, 4) and metrics["out_lengths"].tolist() == [4, 3, 2]
    assert losses[-1] < losses[0], losses


def _jax_einsum_attention(qu, qv, k, v, p, lengths, scale, keep, rate):
    """The JAX einsum path (models/conformer.RelPositionMHSA) with the
    probability-dropout mask applied by hand as flax's nn.Dropout does."""
    ac = jnp.einsum("bihd,bjhd->bhij", qu, k)
    bd = jax_rel_shift(jnp.einsum("bihd,lhd->bhil", qv, p))
    scores = jnp.where(JCM.length_mask(lengths, qu.shape[1])[:, None, None, :], (ac + bd) * scale, JCM.NEG_INF)
    attn = jax.nn.softmax(scores, axis=-1)
    attn = jnp.where(keep, attn / (1.0 - rate), 0.0)
    return jnp.einsum("bhij,bjhd->bihd", attn, v)


def test_attention_probability_dropout(rng, monkeypatch):
    """Fault 2: the einsum route drops attention probabilities in
    training.  Under one fixed keep-mask the plain attention equals the JAX
    einsum path (atol 1e-5); the module passes its rate in train mode only."""
    b, t, h, dh, rate = 2, 6, 2, 4, 0.3
    arrays = [rng.standard_normal((b, t, h, dh)).astype(np.float32) for _ in range(4)]
    arrays.append(rng.standard_normal((2 * t - 1, h, dh)).astype(np.float32))
    lens = np.asarray([6, 4], np.int32)
    keep = rng.random((b, h, t, t)) >= rate
    ref = _jax_einsum_attention(*[jnp.asarray(a) for a in arrays], jnp.asarray(lens), 0.5, jnp.asarray(keep), rate)
    got = flash_relpos_attention_plain(*[torch.from_numpy(a) for a in arrays], torch.from_numpy(lens), 0.5,
                                       dropout=rate, keep=torch.from_numpy(keep))
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=1e-5)

    seen = []
    monkeypatch.setattr(TCM, "flash_relpos_attention_plain",
                        lambda *a, dropout: seen.append(dropout) or flash_relpos_attention_plain(*a, dropout=dropout))
    mhsa = TCM.RelPositionMHSA(8, 2, rate)
    x = torch.randn(2, 6, 8)
    rel = torch.from_numpy(TCM.sinusoidal_rel_positions(6, 8))
    mhsa.train()(x, torch.from_numpy(lens), rel)
    mhsa.eval()(x, torch.from_numpy(lens), rel)
    assert seen == [rate, 0.0]


def test_remat_recomputes_each_block_and_keeps_the_gradients(rng):
    """Fault 3: ``remat=True`` runs each block's forward twice in a step (the
    recompute in the backward), replays the same dropout masks there, and
    leaves gradients, loss and batch statistics as without it (atol 1e-6)."""
    audio, lengths, targets, tlen = (torch.from_numpy(a) for a in _batch(rng))
    feats, flens = TL.make_augment_step(TC.FeatureConfig(), TC.SpecAugmentConfig(), False)(
        torch.Generator(), audio, lengths)
    base = init_params(TorchCTC(_tiny(TC), VOCAB), torch.Generator().manual_seed(0)).state_dict()
    runs = []
    for remat in (False, True):
        cfg = _tiny(TC, remat=remat)
        cfg = dataclasses.replace(cfg, encoder=dataclasses.replace(cfg.encoder, dropout=0.2, attention_dropout=0.2))
        tm = TorchCTC(cfg, VOCAB)
        tm.load_state_dict(base)
        calls = [0] * len(tm.encoder.blocks)
        for i, block in enumerate(tm.encoder.blocks):
            block.register_forward_pre_hook(lambda *_, i=i: calls.__setitem__(i, calls[i] + 1))
        state = TrainState.create(tm, make_optimizer(TC.OptimizerConfig(learning_rate=LR), tm.named_parameters()), seed=3)
        _, metrics = TL.make_feature_train_step(tm, 0)(state, feats, flens, targets, tlen)
        runs.append((calls, metrics["loss"].item(), {n: p.grad.clone() for n, p in tm.named_parameters()},
                     {n: b.clone() for n, b in tm.named_buffers()}))
    (calls_plain, loss_plain, grads_plain, stats_plain), (calls_remat, loss_remat, grads_remat, stats_remat) = runs
    assert calls_plain == [1, 1] and calls_remat == [2, 2]
    assert loss_remat == pytest.approx(loss_plain, rel=1e-6)
    for name in grads_plain:
        torch.testing.assert_close(grads_remat[name], grads_plain[name], rtol=0, atol=1e-6, msg=name)
    for name in stats_plain:
        torch.testing.assert_close(stats_remat[name], stats_plain[name], rtol=0, atol=1e-6, msg=name)


def test_flops_copy_equal_and_peak_by_card_name():
    for preset in ("conformer_s", "conformer_m", "conformer_l"):
        for args in ((1024, 16, 938), (32, 3, 101)):
            assert TF.conformer_forward_flops(getattr(TC, preset)(), *args) == JF.conformer_forward_flops(
                getattr(C, preset)(), *args)
            assert TF.train_step_flops(getattr(TC, preset)(), *args) == JF.train_step_flops(getattr(C, preset)(), *args)
    assert TF.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12
    assert TF.peak_bf16_flops("NVIDIA H100 PCIe") == 756e12
    with pytest.raises(ValueError):
        TF.peak_bf16_flops("TPU v5 lite")


@pytest.mark.parametrize(
    "kernel, group",
    [
        ("void attention_relpos_kernel<__nv_bfloat16, 64, true>(AttnArgs)", "attention forward + lse"),
        ("void (anonymous namespace)::attention_relpos_tc_kernel<64, true>(__nv_bfloat16 const*, float*, int, int, float)",
         "attention forward + lse"),
        ("void (anonymous namespace)::attention_relpos_tc_kernel<64, false>(__nv_bfloat16 const*, int, int, float)",
         "attention forward + lse"),
        ("void bwd_dkv_kernel<float, 64>(BwdArgs)", "attention bwd dkv"),
        ("void (anonymous namespace)::bwd_dkv_tc_kernel<64>(__nv_bfloat16 const*, __nv_bfloat16*, int, int, float)",
         "attention bwd dkv"),
        ("void bwd_dband_kernel<float, 64>(BwdArgs)", "attention bwd dband (+ reduce)"),
        ("void (anonymous namespace)::bwd_dq_tc_kernel<64>(__nv_bfloat16 const*, int, int, float)", "attention bwd dq"),
        ("void (anonymous namespace)::bwd_dband_tc_kernel<64>(__nv_bfloat16 const*, float*, int, int, float)",
         "attention bwd dband (+ reduce)"),
        ("void dband_reduce_kernel<__nv_bfloat16>(float const*, __nv_bfloat16*, int, int)", "attention bwd dband (+ reduce)"),
        ("void lstm_fwd_kernel<true>(LstmArgs)", "lstm_fwd"),
        ("void (anonymous namespace)::lstm_fwd_grid_kernel<true, 4>((anonymous namespace)::FwdArgs, "
         "(anonymous namespace)::GridLayout)", "lstm_fwd"),
        ("void (anonymous namespace)::lstm_bwd_grid_kernel<4>((anonymous namespace)::BwdArgs, "
         "(anonymous namespace)::GridLayout)", "lstm_bwd"),
        ("void (anonymous namespace)::lstm_bwd_cluster_kernel<4>((anonymous namespace)::ClusterBwdArgs, "
         "(anonymous namespace)::ClusterLayout)", "lstm_bwd"),
        ("void (anonymous namespace)::stft_logmel_tc_kernel<(anonymous namespace)::Tile<1, 2, 512> >(float const*, "
         "float const*, float const*, float const*, int const*, float*, int, int, int, int, int, int, int, int, "
         "float)", "stft_logmel"),
        ("void (anonymous namespace)::lstm_dwhh_kernel<4>(float const*, float const*, float*, int)",
         "lstm_dwhh (+ reduce)"),
        ("void (anonymous namespace)::lstm_dwhh_reduce_kernel(float4 const*, float4*, int, int)", "lstm_dwhh (+ reduce)"),
        ("void (anonymous namespace)::depthwise_conv_kernel<__nv_bfloat16>(__nv_bfloat16 const*)", "depthwise_conv"),
        ("void (anonymous namespace)::depthwise_conv_kernel<__nv_bfloat16, true, 33>(__nv_bfloat16 const*, "
         "__nv_bfloat16 const*, __nv_bfloat16*, int, int, int, int, int)", "depthwise_conv"),
        ("void (anonymous namespace)::depthwise_dw_kernel<__nv_bfloat16, true, 33>(__nv_bfloat16 const*, "
         "__nv_bfloat16 const*, float*, int, int, int, int)", "depthwise_conv dw (+ reduce)"),
        ("void (anonymous namespace)::depthwise_dw_reduce_kernel(float const*, float*, int, int)",
         "depthwise_conv dw (+ reduce)"),
        ("nvjet_tst_128x64_64x8_2x1_v_bz_TNN", "GEMMs (cuBLAS)"),
        ("sm90_xmma_wgrad_implicit_gemm_bf16", "convolutions (cuDNN)"),
        ("void at::native::vectorized_elementwise_kernel<4, MulFunctor>", "elementwise, reductions, copies"),
    ],
)
def test_profile_step_groups_kernels_by_name(kernel, group):
    """`utils.profile_step` sums device time by the first group whose words
    the kernel's name holds: a convolution's implicit GEMM is cuDNN's, and
    cuBLAS's `nvjet` kernels are GEMMs."""
    from nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step import group_of

    assert group_of(kernel) == group


def test_package_data_ships_every_kernel_source():
    """What `ops/cuda/build.py` compiles and hashes (`csrc/*.cu`, `*.cuh`) is
    what an installed package holds."""
    import pathlib
    import tomllib

    root = pathlib.Path(__file__).resolve().parents[1]
    patterns = tomllib.loads((root / "pyproject.toml").read_text())["tool"]["setuptools"]["package-data"][
        "nn_conformer_for_speech_recognition_tpu_torch"]
    package = root / "nn_conformer_for_speech_recognition_tpu_torch"
    shipped = {p.name for pattern in patterns for p in package.glob(pattern)}
    assert shipped == {p.name for p in (package / "csrc").iterdir() if p.is_file()}
    assert {"attention_relpos.cuh", "depthwise_conv.cu"} <= shipped
