"""The port's contrastive pretraining against the JAX package's
(`models/pretrain.py`, `train/pretrain_loop.py`, ``cli pretrain``), from
converted weights, on the CPU, with the JAX side's uniform draws (mask,
Gumbel noise, distractor offsets) recorded and injected into the port.

The configs are the JAX tests' ``_pt_cfgs`` (`tests/test_lm_pretrain.py`):
one Conformer block of width 16, target_dim 16 (BiLSTM H = 8, through the
LSTM kernels' plain twins here), 3 distractors; dropout 0.  Tolerances:
the context on valid frames atol 1e-4 and the targets atol 1e-5;
`contrastive_loss` rtol 1e-5 and its gradients atol 1e-4 of the largest;
one `PretrainTrainer` step loss rtol 1e-5, gradients atol 1e-4 of their
tensor's largest, batch statistics atol 1e-5 and updated parameters atol
1e-5 (entries whose gradient lies within 1e-4 of the tensor's largest of 0
only bounded by the Adam step, whose first step lr·g/(|g| + eps) may take
either sign there).

The hand-off of a pretraining checkpoint to ``Trainer.load_encoder_only``
is pinned in both packages: it changes nothing, because neither
pretraining model names a parameter ``encoder`` or ``subsampling``.
"""

import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.data import datasets as JD
from nn_conformer_for_speech_recognition_tpu.data.vocab import WordVocab as JaxWordVocab
from nn_conformer_for_speech_recognition_tpu.models import pretrain as JP
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu.ops.features import log_mel_spectrogram
from nn_conformer_for_speech_recognition_tpu.train import loop as JL
from nn_conformer_for_speech_recognition_tpu.train.pretrain_loop import PretrainTrainer as JaxPretrainTrainer
from nn_conformer_for_speech_recognition_tpu.utils.rng import dropout_key
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.cli.main import build_parser, main
from nn_conformer_for_speech_recognition_tpu_torch.convert import pretrain_flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.data import audio as TA
from nn_conformer_for_speech_recognition_tpu_torch.data import datasets as TD
from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import WordVocab
from nn_conformer_for_speech_recognition_tpu_torch.models import pretrain as TP
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC as TorchCTC
from nn_conformer_for_speech_recognition_tpu_torch.train import loop as TL
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import STATE_FILE
from nn_conformer_for_speech_recognition_tpu_torch.train.pretrain_loop import PretrainTrainer

LR = 1e-3


def _pt_cfgs(lib, **pretrain):
    enc = lib.ConformerConfig(num_blocks=1, d_model=16, num_heads=2, ffn_dim=32, conv_kernel_size=5, dropout=0.0)
    mcfg = lib.ModelConfig(encoder=enc, decoder=lib.DecoderConfig(projection_dim=8, lstm_hidden=8), n_mels=8,
                           subsampling=lib.SubsamplingConfig(channels=(4, 4)))
    return mcfg, lib.PretrainConfig(target_dim=16, distractors_k=3, **pretrain)


def _feat(lib):
    return lib.FeatureConfig(n_fft=256, hop_length=256, n_mels=8)


def _recording_uniform():
    """Swaps ``jax.random.uniform`` for a recorder while traced code runs;
    the JAX package draws every pretraining uniform through it."""
    orig, rec = jax.random.uniform, []

    def uniform(*a, **k):
        out = orig(*a, **k)
        rec.append(out)
        return out

    return orig, uniform, rec


def _draws_by_shape(rec, b, t, cfg):
    """The recorded uniforms as the port's draws: (B, T') the mask,
    (B, T', target_dim) the Gumbel noise, (B, T', K) the distractors."""
    by_shape = {tuple(x.shape): torch.from_numpy(np.array(x)) for x in rec}
    assert len(by_shape) == len(rec)
    return TP.PretrainDraws(mask=by_shape[(b, t)], gumbel=by_shape.get((b, t, cfg.target_dim)),
                            distractors=by_shape.get((b, t, cfg.distractors_k)))


def test_pretrain_config_copy_equal():
    ours, ref = TC.PretrainConfig(), C.PretrainConfig()
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert repr(ours) == repr(ref)


@pytest.fixture(scope="module")
def model_run():
    """A JAX PretrainModel's perturbed variables (the quantizer adds no
    parameter) and its train-mode forwards with each quantizer and its
    eval-mode forward (where the quantizer does nothing), with their
    recorded draws."""
    rng = np.random.default_rng(0)
    feats = rng.standard_normal((3, 40, 8)).astype(np.float32)
    flens = np.asarray([40, 26, 9], np.int32)  # T' = 10, 7 and 3
    keys = {"params": jax.random.key(0), "mask": jax.random.key(1), "gumbel": jax.random.key(2),
            "dropout": jax.random.key(3)}
    model = JP.PretrainModel(*_pt_cfgs(C, mask_probability=0.4))
    vs = jax.jit(lambda f, l: model.init(keys, f, l, deterministic=False))(feats, flens)  # noqa: E741
    vs = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32), vs)
    vs["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, vs["batch_stats"])

    def run(vs, f, l, gumbel, train):  # noqa: E741
        model = JP.PretrainModel(*_pt_cfgs(C, mask_probability=0.4, use_gumbel_quantizer=gumbel))
        orig, uniform, rec = _recording_uniform()
        jax.random.uniform = uniform
        try:
            rngs = {"mask": jax.random.key(4), "gumbel": jax.random.key(5), "dropout": jax.random.key(6)}
            outs, upd = model.apply(vs, f, l, deterministic=not train, rngs=rngs, mutable=["batch_stats"])
        finally:
            jax.random.uniform = orig
        return outs, upd, rec

    out = {(g, t): jax.tree.map(np.asarray, jax.jit(run, static_argnums=(3, 4))(vs, feats, flens, g, t))
           for g, t in ((False, True), (True, True), (False, False))}
    out[True, False] = out[False, False]
    return feats, flens, vs, out


@pytest.mark.parametrize("gumbel", [False, True], ids=["linear", "gumbel"])
@pytest.mark.parametrize("train", [True, False], ids=["train", "eval"])
def test_pretrain_model_matches_jax(model_run, gumbel, train):
    feats, flens, vs, out = model_run
    (ctx, tgt, mask_pos, lengths), upd, rec = out[gumbel, train]
    mcfg, pcfg = _pt_cfgs(TC, mask_probability=0.4, use_gumbel_quantizer=gumbel)
    tm = TP.PretrainModel(mcfg, pcfg)
    tm.load_state_dict(pretrain_flax_to_state_dict(vs), strict=True)
    tm.train(train)
    draws = _draws_by_shape(rec, 3, 10, pcfg) if train else None
    assert (len(rec) == 1 + gumbel) if train else not rec
    with torch.no_grad():
        got = tm(torch.from_numpy(feats), torch.from_numpy(flens), draws)
    np.testing.assert_array_equal(got[3].numpy(), lengths)
    np.testing.assert_array_equal(got[2].numpy(), mask_pos)
    assert mask_pos.any() == train and not mask_pos[2, 3:].any()
    valid = np.arange(10)[None, :] < lengths[:, None]
    np.testing.assert_allclose(got[0].numpy()[valid], ctx[valid], atol=1e-4)
    np.testing.assert_allclose(got[1].numpy(), tgt, atol=1e-5)
    if train:  # the masked BatchNorm's running statistics after the step
        ref_stats = pretrain_flax_to_state_dict({"batch_stats": upd["batch_stats"]})
        for name, ref in ref_stats.items():
            np.testing.assert_allclose(tm.state_dict()[name].numpy(), ref.numpy(), atol=1e-5, err_msg=name)


def test_converter_maps_every_pretrain_leaf_once(model_run):
    vs = model_run[2]
    converted = pretrain_flax_to_state_dict(vs)
    tm = TP.PretrainModel(*_pt_cfgs(TC))
    cells = len(jax.tree.leaves(vs["params"]["decoder"]))  # 2 OptimizedLSTMCells of 12 leaves → 2 × 3 packed
    assert cells == 24
    assert len(converted) == len(jax.tree.leaves(vs["params"])) - cells + 6 + len(jax.tree.leaves(vs["batch_stats"]))
    assert set(converted) == set(tm.state_dict())
    assert {k.split(".")[0] for k in converted} == {"conv_subsampling", "quant_proj", "pre_context", "context_net",
                                                    "decoder"}
    assert sorted(vs["params"]) == ["ConvSubsampling_0", "context_net", "decoder", "pre_context", "quant_proj"]


@pytest.mark.parametrize("alpha", [0.1, 0.0])
def test_contrastive_loss_and_gradient_match_jax(alpha):
    """Padded rows (a row of length 1 among them), K = 5 distractors from
    the JAX function's own draw of ``u``; the loss rtol 1e-5, the gradients
    of the context and the targets atol 1e-4 of their largest."""
    rng = np.random.default_rng(1)
    b, t, d, k = 4, 9, 6, 5
    ctx = rng.standard_normal((b, t, d)).astype(np.float32)
    tgt = rng.standard_normal((b, t, d)).astype(np.float32)
    lengths = np.asarray([9, 5, 1, 7], np.int32)
    mask = (rng.random((b, t)) < 0.5) & (np.arange(t)[None, :] < lengths[:, None])
    ctx[1, 6] = 0.0  # a zero frame: _unit's gradient stays finite
    key = jax.random.key(2)
    fn = lambda c, g: JP.contrastive_loss(c, g, jnp.asarray(mask), jnp.asarray(lengths), key,  # noqa: E731
                                          k_distractors=k, diversity_alpha=alpha)
    ref, (rc, rg) = jax.jit(jax.value_and_grad(fn, argnums=(0, 1)))(ctx, tgt)
    u = torch.from_numpy(np.array(jax.random.uniform(key, (b, t, k))))
    c, g = torch.from_numpy(ctx).requires_grad_(True), torch.from_numpy(tgt).requires_grad_(True)
    loss = TP.contrastive_loss(c, g, torch.from_numpy(mask), torch.from_numpy(lengths), u, diversity_alpha=alpha)
    loss.backward()
    np.testing.assert_allclose(loss.item(), float(ref), rtol=1e-5)
    for got, want in ((c.grad, rc), (g.grad, rg)):
        want = np.asarray(want)
        assert np.isfinite(got.numpy()).all()
        np.testing.assert_allclose(got.numpy(), want, atol=1e-4 * np.abs(want).max())


def test_contrastive_loss_prefers_aligned_and_never_picks_the_frame_itself():
    gen = torch.Generator().manual_seed(0)
    tgt = torch.randn(2, 12, 8, generator=gen)
    mask, lengths = torch.ones(2, 12, dtype=torch.bool), torch.tensor([12, 12])
    u = torch.rand(2, 12, 5, generator=gen)
    good = TP.contrastive_loss(tgt, tgt, mask, lengths, u, diversity_alpha=0.0)
    bad = TP.contrastive_loss(torch.randn(2, 12, 8, generator=gen), tgt, mask, lengths, u, diversity_alpha=0.0)
    assert good.item() < bad.item()
    # the largest draw still lands on another frame: 1 + floor(u·(len-1)) ≤ len - 1
    edge = torch.full((2, 12, 5), float(np.nextafter(np.float32(1.0), np.float32(0.0))))
    assert torch.isfinite(TP.contrastive_loss(tgt, tgt, mask, lengths, edge)).item()


@pytest.fixture(scope="module")
def step_run(tmp_path_factory):
    """One JAX PretrainTrainer step at lr 1e-3 on a batch of 8 unlabelled
    clips (the JAX trainer shards a batch over 8 devices), its gradients
    and its draws; and the same trainer's checkpoint."""
    root = str(tmp_path_factory.mktemp("pretrain"))
    man = TA.make_synthetic_corpus(root, ["go", "stop"], n_train=0, n_val=0, n_test=0, n_unlabeled=8, seed=0,
                                   max_words_per_utt=2)
    mcfg, pcfg = _pt_cfgs(C, learning_rate=LR, mask_probability=0.3)
    feat = _feat(C)
    vocab = JaxWordVocab(["<blank>", "<pad>", "<unk>"])
    jds = JD.BucketedDataset(JD.load_manifest(man["unlabeled"]), vocab, batch_size=8)
    tr = JaxPretrainTrainer(mcfg, pcfg, feat, log_fn=lambda _: None)
    tr.init_state(seed=0)
    batch = next(iter(jds.epoch(seed=0)))
    audio, alen = batch.audio, batch.audio_lengths.astype(np.int32)
    rng = np.random.default_rng(3)
    params0 = jax.tree.map(lambda a: np.asarray(a) + 0.1 * rng.standard_normal(a.shape).astype(np.float32),
                           tr.state.params)
    stats0 = jax.tree.map(lambda a: np.abs(np.asarray(a)) + 0.5, tr.state.batch_stats)
    place = lambda new, old: jax.tree.map(lambda n, o: jax.device_put(n, o.sharding), new, old)  # noqa: E731
    placed = place(params0, tr.state.params)
    state0 = tr.state.replace(params=placed, opt_state=tr.tx.init(placed),
                              batch_stats=place(stats0, tr.state.batch_stats))

    def ref(state, audio, alen):  # the JAX step's draws and gradients, from the step's own keys
        _, m_rng, g_rng, d_rng = jax.random.split(state.rng, 4)
        d_rng = dropout_key(d_rng)
        feats, flens = log_mel_spectrogram(audio, feat, alen)

        def loss_fn(params):
            (ctx, tgt, mask_pos, lengths), _ = tr.model.apply(
                {"params": params, "batch_stats": state.batch_stats}, feats, flens, deterministic=False,
                rngs={"mask": m_rng, "gumbel": g_rng, "dropout": d_rng}, mutable=["batch_stats"])
            return JP.contrastive_loss(ctx, tgt, mask_pos, lengths, d_rng, k_distractors=pcfg.distractors_k,
                                       temperature=pcfg.temperature, diversity_alpha=pcfg.diversity_alpha)

        orig, uniform, rec = _recording_uniform()
        jax.random.uniform = uniform
        try:
            grads = jax.grad(lambda p: (loss_fn(p), rec), has_aux=True)(state.params)
        finally:
            jax.random.uniform = orig
        return grads

    grads, rec = jax.tree.map(np.asarray, jax.jit(ref)(state0, audio, alen))
    state1, loss = tr._train_step(state0, audio, alen)
    tr.state = state1
    tr.save(os.path.join(root, "jax_ckpt"))
    return types.SimpleNamespace(root=root, man=man, audio=audio, alen=alen, grads=grads, rec=rec, loss=float(loss),
                                 vs0={"params": params0, "batch_stats": stats0},
                                 vs1=jax.tree.map(np.asarray, {"params": state1.params,
                                                               "batch_stats": state1.batch_stats}))


def test_pretrain_trainer_step_matches_jax(step_run):
    r = step_run
    mcfg, pcfg = _pt_cfgs(TC, learning_rate=LR, mask_probability=0.3)
    tr = PretrainTrainer(mcfg, pcfg, _feat(TC), device="cpu", log_fn=lambda _: None)
    tr.init_state(seed=0, variables=r.vs0)
    t_sub = mcfg.subsampled_length(_feat(TC).num_frames(r.audio.shape[1]))
    draws = _draws_by_shape(r.rec, 8, t_sub, pcfg)
    assert draws.gumbel is None and draws.distractors is not None and (draws.mask < 0.3).any()
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.state, metrics = tr._train_step(tr.state, torch.from_numpy(r.audio), torch.from_numpy(r.alen), draws)
    assert tr.state.step == 1 and tr.state.optimizer.count == 1
    np.testing.assert_allclose(metrics["loss"].item(), r.loss, rtol=1e-5)
    ref_grads = pretrain_flax_to_state_dict({"params": r.grads})
    ref_after = pretrain_flax_to_state_dict(r.vs1)
    params = dict(tr.model.named_parameters())
    after = tr.model.state_dict()
    for name, ref in ref_after.items():
        got = after[name].numpy()
        if name not in params:  # a batch statistic
            assert not np.array_equal(ref.numpy(), before[name].numpy()), name
            np.testing.assert_allclose(got, ref.numpy(), atol=1e-5, err_msg=name)
            continue
        g, g_ref = params[name].grad.numpy(), ref_grads[name].numpy()
        scale = np.abs(g_ref).max()
        assert scale > 0 and np.isfinite(g).all(), name
        np.testing.assert_allclose(g, g_ref, atol=1e-4 * scale, err_msg=name)
        step_got, step_ref = got - before[name].numpy(), ref.numpy() - before[name].numpy()
        clear = np.abs(g_ref) > 1e-4 * scale
        np.testing.assert_allclose(step_got[clear], step_ref[clear], atol=1e-5, err_msg=name)
        assert np.all(np.abs(step_got) <= LR * (1 + 1e-5) + 2 * np.spacing(np.abs(before[name].numpy()))), name


def test_pretrain_trainer_loss_falls_and_saves(step_run, tmp_path):
    """The JAX test's run (8 epochs at lr 1e-3, mask probability 0.3) on
    the port: the loss falls; the checkpoint holds the pretraining model."""
    mcfg, pcfg = _pt_cfgs(TC, learning_rate=LR, mask_probability=0.3)
    ds = TD.BucketedDataset(TD.load_manifest(step_run.man["unlabeled"]), WordVocab(["<blank>", "<pad>", "<unk>"]),
                            batch_size=8, bucket_boundaries=[8000], max_target_len=4)
    tr = PretrainTrainer(mcfg, pcfg, _feat(TC), device="cpu", log_fn=lambda _: None)
    tr.init_state(seed=0)
    h = tr.train(ds, epochs=8)["pretrain_loss"]
    assert len(h) == 8 and all(np.isfinite(h)) and h[-1] < h[0], h
    tr.save(str(tmp_path / "ckpt"))
    saved = torch.load(str(tmp_path / "ckpt" / STATE_FILE), weights_only=True)
    assert saved["model"].keys() == tr.model.state_dict().keys() and saved["optimizer"]["count"] == tr.state.step


def _asr_cfg(lib):
    mcfg, _ = _pt_cfgs(lib)
    return dataclasses.replace(mcfg, compute_dtype="float32")


def test_load_encoder_only_from_a_pretrain_checkpoint_changes_nothing_in_either_package(step_run, tmp_path):
    """The hand-off as the JAX package does it: its ``restore_encoder_params``
    takes leaves under ``encoder`` and ``subsampling``, and the pretraining
    tree (``ConvSubsampling_0``, ``context_net``, ...) has neither, so the
    ASR parameters stay as they were.  The port names its submodules so
    that it does the same, although the context network's blocks have the
    ASR encoder's shapes."""
    r = step_run
    jvocab = JaxWordVocab(["<blank>", "<pad>", "<unk>", "go", "stop"])
    tcfg = C.TrainConfig(batch_size=8, use_specaugment=False, donate_state=False)
    jt = JL.Trainer(ConformerCTC(_asr_cfg(C), vocab_size=len(jvocab)), jvocab, _feat(C), tcfg, log_fn=lambda _: None)
    jt.init_state(seed=0)
    before = jax.tree.map(np.asarray, jt.state.params)
    jt.load_encoder_only(os.path.join(r.root, "jax_ckpt"))
    for a, b in zip(jax.tree.leaves(jax.tree.map(np.asarray, jt.state.params)), jax.tree.leaves(before)):
        np.testing.assert_array_equal(a, b)

    mcfg, pcfg = _pt_cfgs(TC)
    pt = PretrainTrainer(mcfg, pcfg, _feat(TC), device="cpu", log_fn=lambda _: None)
    pt.init_state(seed=1)
    pt.save(str(tmp_path / "pretrained"))
    vocab = WordVocab(["<blank>", "<pad>", "<unk>", "go", "stop"])
    tt = TL.Trainer(TorchCTC(_asr_cfg(TC), len(vocab)), vocab, _feat(TC), TC.TrainConfig(batch_size=8), device="cpu",
                    log_fn=lambda _: None)
    tt.init_state(seed=0)
    state = {k: v.clone() for k, v in tt.model.state_dict().items()}
    shared = {k for k in pt.model.state_dict() if k.startswith("context_net.")}
    assert {"encoder." + k[len("context_net."):] for k in shared} <= set(state)  # the same blocks, another name
    tt.load_encoder_only(str(tmp_path / "pretrained"))
    for k, v in tt.model.state_dict().items():
        assert torch.equal(v, state[k]), k


def test_cli_pretrain_then_train_from_its_save(step_run, tmp_path):
    """``pretrain --device cpu`` on the unlabelled split, then ``train
    --encoder-checkpoint`` from its save: the ASR model starts as from its
    seed alone."""
    from nn_conformer_for_speech_recognition_tpu_torch.cli import main as cli

    corpus = os.path.dirname(step_run.man["unlabeled"])
    save = str(tmp_path / "pretrained")
    assert main(["pretrain", "--manifest-dir", corpus, "--model", "reference", "--n-mels", "8", "--epochs", "1",
                 "--batch-size", "8", "--lr", "1e-3", "--save", save, "--device", "cpu"]) == 0
    saved = torch.load(os.path.join(save, STATE_FILE), weights_only=True)
    assert "decoder.lstm_fwd_0_w_hh" in saved["model"] and saved["step"] == 1
    assert saved["model"]["decoder.lstm_fwd_0_w_hh"].shape == (160, 640)  # target_dim 320: H = 160
    argv = ["train", "--manifest-dir", corpus, "--model", "reference", "--n-mels", "8", "--device", "cpu"]
    fresh, _, _ = cli._build(build_parser().parse_args(argv))
    handed, _, _ = cli._build(build_parser().parse_args(argv + ["--encoder-checkpoint", save]))
    for (k, a), b in zip(fresh.model.state_dict().items(), handed.model.state_dict().values()):
        assert torch.equal(a, b), k
