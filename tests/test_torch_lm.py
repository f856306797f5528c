"""The port's language models and LM fusion against the JAX package's
(`models/lm.py`, `train/lm_loop.py`, the ``lm_apply`` hooks of
`train/loop.py`), from converted weights, on the CPU.

Inputs are seeded numpy; dropout 0.  Tolerances: LM logits (encoder-decoder
and causal, with a padded and an all-padded row) atol 1e-5;
`make_pron_lm_apply` and `shallow_fusion` atol 1e-5; the eval steps and
`Trainer.evaluate` with ``lm_apply`` loss rtol 1e-5 and ids equal; one
`LMTrainer` step loss rtol 1e-5, gradients atol 1e-4 of their tensor's
largest, updated parameters atol 1e-6 (entries whose gradient lies within
1e-4 of the tensor's largest of 0 only bounded by the AdamW step: there
the first Adam step, lr·g/(|g| + eps), may take either sign, and the
attention's key bias, which the softmax cannot see, has only such
entries); `evaluate` rtol 1e-5; `fuse_lm_weights_into_asr` bit for bit.
"""

import dataclasses
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.data import lm_corpus as JLC
from nn_conformer_for_speech_recognition_tpu.data.vocab import WordVocab as JaxWordVocab
from nn_conformer_for_speech_recognition_tpu.models import lm as JLM
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu.parallel import mesh as pmesh
from nn_conformer_for_speech_recognition_tpu.train import loop as JL
from nn_conformer_for_speech_recognition_tpu.train.lm_loop import LMTrainer as JaxLMTrainer
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict, lm_flax_to_state_dict
from nn_conformer_for_speech_recognition_tpu_torch.data import lm_corpus as TLC
from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import WordVocab
from nn_conformer_for_speech_recognition_tpu_torch.models import lm as TLM
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC as TorchCTC
from nn_conformer_for_speech_recognition_tpu_torch.train import loop as TL
from nn_conformer_for_speech_recognition_tpu_torch.train.lm_loop import LMTrainer

from _torch_trainer_helpers import feature_config, jax_trainer, make_corpus, perturbed_variables, port_trainer

SRC_V, TGT_V, D, HEADS = 11, 9, 16, 2


def _noisy(tree, rng, scale=0.1):
    """Every leaf moved off its initial value (the biases start at 0)."""
    return jax.tree.map(lambda a: np.asarray(a) + scale * rng.standard_normal(a.shape).astype(np.float32), tree)


@pytest.fixture(scope="module")
def lms():
    """A JAX TransformerLM and CausalWordLM with perturbed parameters, and
    the port's from the converted trees."""
    rng = np.random.default_rng(0)
    jlm = JLM.TransformerLM(src_vocab=SRC_V, tgt_vocab=TGT_V, d=D, heads=HEADS, ffn=32, enc_layers=2, dec_layers=2,
                            dropout=0.0)
    jparams = _noisy(jax.jit(jlm.init)(jax.random.key(0), jnp.zeros((1, 7), jnp.int32),
                                       jnp.zeros((1, 5), jnp.int32))["params"], rng)
    tlm = TLM.TransformerLM(SRC_V, TGT_V, d=D, heads=HEADS, ffn=32, enc_layers=2, dec_layers=2, dropout=0.0)
    tlm.load_state_dict(lm_flax_to_state_dict(jparams), strict=True)
    jword = JLM.CausalWordLM(vocab=TGT_V, d=D, heads=HEADS, ffn=32, layers=2, dropout=0.0)
    jwparams = _noisy(jax.jit(jword.init)(jax.random.key(1), jnp.zeros((1, 6), jnp.int32))["params"], rng)
    tword = TLM.CausalWordLM(TGT_V, d=D, heads=HEADS, ffn=32, layers=2, dropout=0.0)
    tword.load_state_dict(lm_flax_to_state_dict({"params": jwparams}), strict=True)
    return types.SimpleNamespace(jlm=jlm, jparams=jparams, tlm=tlm.eval(), jword=jword, jwparams=jwparams,
                                 tword=tword.eval())


def test_lm_config_copy_equal():
    ours, ref = TC.LMConfig(), C.LMConfig()
    assert [(f.name, f.default) for f in dataclasses.fields(ours)] == [(f.name, f.default) for f in dataclasses.fields(ref)]
    assert repr(ours) == repr(ref)


@pytest.mark.parametrize("which", ["TransformerLM", "CausalWordLM"])
def test_converter_maps_every_lm_leaf_once(lms, which):
    params = lms.jparams if which == "TransformerLM" else lms.jwparams
    model = lms.tlm if which == "TransformerLM" else lms.tword
    converted = lm_flax_to_state_dict(params)
    assert len(converted) == len(jax.tree.leaves(params)) == len(model.state_dict())
    assert set(converted) == set(model.state_dict())
    # an unknown leaf is refused, not dropped
    with pytest.raises(ValueError, match="unexpected LM leaf"):
        lm_flax_to_state_dict({**params, "extra": {"kernel": np.zeros((2, 2), np.float32)}})


@pytest.mark.parametrize("masked", [True, False], ids=["masked", "unmasked"])
def test_transformer_lm_logits_match_jax(lms, masked):
    """Row 0 full, row 1 padded, row 2 all padded (a row of length 0 in
    the source and the target: flax attends uniformly there)."""
    rng = np.random.default_rng(1)
    src = rng.integers(0, SRC_V, (3, 7)).astype(np.int32)
    tgt = rng.integers(0, TGT_V, (3, 5)).astype(np.int32)
    masks = {}
    if masked:
        masks = dict(src_mask=np.arange(7)[None, :] < np.asarray([7, 4, 0])[:, None],
                     tgt_mask=np.arange(5)[None, :] < np.asarray([5, 2, 0])[:, None])
    ref = np.asarray(jax.jit(lms.jlm.apply)({"params": lms.jparams}, src, tgt,
                                            **{k: jnp.asarray(v) for k, v in masks.items()}))
    with torch.no_grad():
        got = lms.tlm(torch.from_numpy(src).long(), torch.from_numpy(tgt).long(),
                      **{k: torch.from_numpy(v) for k, v in masks.items()}).numpy()
    assert np.isfinite(got).all() and np.abs(ref).max() > 0.1
    np.testing.assert_allclose(got, ref, atol=1e-5)


def test_causal_word_lm_logits_match_jax(lms):
    ids = np.random.default_rng(2).integers(0, TGT_V, (3, 8)).astype(np.int32)
    ref = np.asarray(jax.jit(lms.jword.apply)({"params": lms.jwparams}, ids))
    with torch.no_grad():
        got = lms.tword(torch.from_numpy(ids).long()).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    # causal: a later token does not move earlier logits
    ids2 = ids.copy()
    ids2[:, -1] = (ids2[:, -1] + 1) % TGT_V
    with torch.no_grad():
        np.testing.assert_allclose(lms.tword(torch.from_numpy(ids2).long()).numpy()[:, :-1], got[:, :-1], atol=1e-6)


def test_attention_dropout_is_shared_across_batch_and_heads():
    """flax's broadcast dropout: one mask of (Tq, Tk) for every row and head."""
    attn = TLM.MultiHeadAttention(8, 2, dropout=0.5).train()
    x = torch.randn(1, 5, 8).expand(3, 5, 8)
    torch.manual_seed(0)
    out = attn(x, x)
    assert torch.allclose(out[0], out[1]) and torch.allclose(out[1], out[2])
    torch.manual_seed(0)
    assert not torch.allclose(out, attn.eval()(x, x))


@pytest.mark.parametrize("lm_weight", [0.5, 0.0])
def test_shallow_fusion_matches_jax(lms, lm_weight):
    asr = np.random.default_rng(3).standard_normal((2, 6, TGT_V)).astype(np.float32)
    asr_lp = np.array(jax.nn.log_softmax(asr, axis=-1))
    ref = np.asarray(jax.jit(lambda lp: JLM.shallow_fusion(
        lp, lambda ids: lms.jword.apply({"params": lms.jwparams}, ids), lm_weight=lm_weight))(asr_lp))
    with torch.no_grad():
        got = TLM.shallow_fusion(torch.from_numpy(asr_lp), lms.tword, lm_weight=lm_weight).numpy()
    np.testing.assert_allclose(got, ref, atol=1e-5)
    assert np.allclose(got, asr_lp) == (lm_weight == 0.0)


def test_make_pron_lm_apply_matches_jax(lms):
    """The table lookup in place of the one-hot matmul gives the same
    source stream, hence the same logits."""
    rng = np.random.default_rng(4)
    table = rng.integers(0, SRC_V, size=(TGT_V, 3)).astype(np.int32)
    table[2, 1:] = 0  # a pronunciation padded with 0
    ctx = rng.integers(0, TGT_V, (2, 5)).astype(np.int32)
    ref = np.asarray(jax.jit(JLM.make_pron_lm_apply(lms.jlm, {"params": lms.jparams}, table))(ctx))
    got = TLM.make_pron_lm_apply(lms.tlm, table)(torch.from_numpy(ctx).long())
    assert got.shape == (2, 5, TGT_V)
    np.testing.assert_allclose(got.numpy(), ref, atol=1e-5)


@pytest.fixture(scope="module")
def asr_tree():
    """A JAX ConformerCTC's (config, perturbed params, batch stats): 3 blocks at the LMs' width."""
    cfg = dataclasses.replace(
        C.ModelConfig(encoder=C.ConformerConfig(num_blocks=3, d_model=D, num_heads=HEADS, ffn_dim=32,
                                                conv_kernel_size=5, dropout=0.0),
                      decoder=C.DecoderConfig(projection_dim=8, lstm_hidden=8, dropout=0.0), n_mels=8),
        compute_dtype="float32")
    model = ConformerCTC(cfg, vocab_size=TGT_V)
    vs = jax.jit(model.init)({"params": jax.random.key(3), "dropout": jax.random.key(4)}, jnp.zeros((1, 16, 8)),
                             jnp.full((1,), 16))
    return cfg, _noisy(vs["params"], np.random.default_rng(5)), jax.tree.map(np.asarray, vs["batch_stats"])


def _port_cfg(cfg):
    return TC.ModelConfig(**{f.name: getattr(cfg, f.name) for f in dataclasses.fields(TC.ModelConfig)
                             if f.name not in ("subsampling", "encoder", "decoder")},
                          subsampling=TC.SubsamplingConfig(**dataclasses.asdict(cfg.subsampling)),
                          encoder=TC.ConformerConfig(**dataclasses.asdict(cfg.encoder)),
                          decoder=TC.DecoderConfig(**dataclasses.asdict(cfg.decoder)))


@pytest.mark.parametrize("scale", [1.0, 0.5, 0.3])
def test_fuse_lm_weights_matches_jax_bit_for_bit(lms, asr_tree, scale):
    """Encoder layers 0-1 into blocks 0-1, decoder layers' cross-attention
    into blocks 2-1 (mirrored); the fused port state dict equals the
    converted fused JAX tree exactly, and every other tensor is the
    input's own."""
    cfg, params, stats = asr_tree
    fused_ref = flax_to_state_dict({"params": JLM.fuse_lm_weights_into_asr(params, lms.jparams, scale),
                                    "batch_stats": stats}, _port_cfg(cfg))
    asr = flax_to_state_dict({"params": params, "batch_stats": stats}, _port_cfg(cfg))
    fused = TLM.fuse_lm_weights_into_asr(asr, lms.tlm.state_dict(), scale)
    assert fused.keys() == fused_ref.keys()
    changed = {k for k in fused if not torch.equal(fused[k], asr[k])}
    assert changed == {f"encoder.blocks.{i}.mhsa.{w}.weight" for i in range(3) for w in ("qkv", "out_proj")}
    for k in fused:
        assert torch.equal(fused[k], fused_ref[k]), k
    # the encoder's own state dict (no "encoder." prefix) fuses the same way
    enc = {k[len("encoder."):]: v for k, v in asr.items() if k.startswith("encoder.")}
    for k, v in TLM.fuse_lm_weights_into_asr(enc, lms.tlm.state_dict(), scale).items():
        assert torch.equal(v, fused[f"encoder.{k}"]), k
    TorchCTC(_port_cfg(cfg), TGT_V).load_state_dict(fused, strict=True)


def test_fuse_zero_lm_is_a_noop_and_mismatched_dims_are_skipped(lms, asr_tree):
    cfg, params, stats = asr_tree
    asr = flax_to_state_dict({"params": params, "batch_stats": stats}, _port_cfg(cfg))
    zero = {k: torch.zeros_like(v) for k, v in lms.tlm.state_dict().items()}
    for k, v in TLM.fuse_lm_weights_into_asr(asr, zero).items():
        assert torch.equal(v, asr[k]), k
    # an LM of another width: every block skipped, in both packages
    narrow = JLM.TransformerLM(src_vocab=SRC_V, tgt_vocab=TGT_V, d=8, heads=HEADS, ffn=16, enc_layers=1, dec_layers=1)
    nparams = jax.jit(narrow.init)(jax.random.key(6), jnp.zeros((1, 4), jnp.int32), jnp.zeros((1, 3), jnp.int32))["params"]
    for a, b in zip(jax.tree.leaves(JLM.fuse_lm_weights_into_asr(params, nparams)), jax.tree.leaves(params)):
        np.testing.assert_array_equal(np.asarray(a), np.asarray(b))
    for k, v in TLM.fuse_lm_weights_into_asr(asr, lm_flax_to_state_dict(nparams)).items():
        assert torch.equal(v, asr[k]), k
    # a tree without Conformer blocks (the pretraining model's) is left as it is
    other = {"context_net.blocks.0.mhsa.qkv.weight": asr["encoder.blocks.0.mhsa.qkv.weight"]}
    assert TLM.fuse_lm_weights_into_asr(other, lms.tlm.state_dict()) == other


# -- the eval steps and the Trainer with shallow fusion

def _tiny_asr(lib):
    enc = lib.ConformerConfig(num_blocks=2, d_model=16, num_heads=2, ffn_dim=32, conv_kernel_size=5, dropout=0.0)
    dec = lib.DecoderConfig(projection_dim=8, lstm_hidden=8, dropout=0.0)
    return lib.ModelConfig(encoder=enc, decoder=dec, use_pallas=True, compute_dtype="float32")


@pytest.fixture(scope="module")
def fused_eval(lms):
    """A tiny ASR model over the causal LM's vocabulary, both packages, and
    a batch of 3 clips (the last without a target)."""
    rng = np.random.default_rng(6)
    lengths = np.asarray([8000, 5600, 3000], np.int32)
    audio = rng.standard_normal((3, 8000)).astype(np.float32) * 0.1
    audio *= np.arange(8000)[None, :] < lengths[:, None]
    targets = rng.integers(3, TGT_V, size=(3, 4)).astype(np.int32)
    tlen = np.asarray([4, 2, 0], np.int32)
    model = ConformerCTC(_tiny_asr(C), vocab_size=TGT_V)
    feats = jnp.zeros((1, 16, 40))
    vs = jax.jit(model.init)({"params": jax.random.key(7), "dropout": jax.random.key(8)}, feats, jnp.full((1,), 16))
    vs = jax.tree.map(lambda a: np.asarray(a) + 0.05 * rng.standard_normal(a.shape).astype(np.float32), vs)
    vs["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, vs["batch_stats"])
    tm = TorchCTC(_tiny_asr(TC), TGT_V)
    tm.load_state_dict(flax_to_state_dict(vs, _tiny_asr(TC)), strict=True)
    return types.SimpleNamespace(model=model, vs=vs, tm=tm, batch=(audio, lengths, targets, tlen))


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_eval_steps_with_lm_apply_match_jax(lms, fused_eval, decode):
    """``make_eval_step`` / ``make_eval_beam_step`` with ``lm_apply`` (the
    causal LM, weight 1) against the JAX steps: loss rtol 1e-5, ids equal;
    the fused loss differs from the port's unfused one."""
    e = fused_eval
    state = types.SimpleNamespace(params=e.vs["params"], batch_stats=e.vs["batch_stats"])
    j_lm = lambda ids: lms.jword.apply({"params": lms.jwparams}, ids)  # noqa: E731
    beam = dict(beam=4, prune=4, max_label_len=6)
    jargs = [jnp.asarray(a) for a in e.batch]
    targs = [torch.from_numpy(a) for a in e.batch]
    lm, tlm = dict(lm_apply=j_lm, lm_weight=1.0), dict(lm_apply=lms.tword, lm_weight=1.0)
    if decode == "greedy":
        jstep = JL.make_eval_step(e.model, C.FeatureConfig(), 0, 1, ctc_impl="pallas", **lm)
        make = lambda **kw: TL.make_eval_step(e.tm, TC.FeatureConfig(), 0, 1, **kw)  # noqa: E731
    else:
        jstep = JL.make_eval_beam_step(e.model, C.FeatureConfig(), 0, ctc_impl="pallas", **beam, **lm)
        make = lambda **kw: TL.make_eval_beam_step(e.tm, TC.FeatureConfig(), 0, **beam, **kw)  # noqa: E731
    ref = jax.jit(lambda *a: jstep(state, *a))(*jargs)
    got = make(**tlm)(*targs)
    np.testing.assert_allclose(got[0].item(), float(ref[0]), rtol=1e-5)
    for g, r in zip(got[1:], ref[1:]):
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    unfused = make()(*targs)[0].item()
    assert np.isfinite(got[0].item()) and abs(got[0].item() - unfused) > 1e-4


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("lm_corpus"), n_train=16, n_val=8, n_unlabeled=0)


@pytest.mark.parametrize("decode", ["greedy", "beam"])
def test_trainer_with_lm_apply_matches_jax(corpus, decode):
    """``Trainer(lm_apply=..., lm_weight=...)``: `evaluate` of the port
    against the JAX Trainer's from the same weights, loss rtol 1e-5, WER
    equal, and the LM moved the loss."""
    _, jvocab, tvocab, jdata, tdata = corpus
    v = len(tvocab)
    jword = JLM.CausalWordLM(vocab=v, d=D, heads=HEADS, ffn=32, layers=1, dropout=0.0)
    jwp = _noisy(jax.jit(jword.init)(jax.random.key(9), jnp.zeros((1, 4), jnp.int32))["params"], np.random.default_rng(7), 0.5)
    tword = TLM.CausalWordLM(v, d=D, heads=HEADS, ffn=32, layers=1, dropout=0.0)
    tword.load_state_dict(lm_flax_to_state_dict(jwp), strict=True)
    jt = jax_trainer(jvocab)
    vs = perturbed_variables(jt, np.random.default_rng(8))
    jf = JL.Trainer(jt.model, jvocab, jt.feat_cfg, jt.train_cfg, log_fn=lambda _: None,
                    lm_apply=lambda ids: jword.apply({"params": jwp}, ids), lm_weight=0.8)
    jf.state = jt.state.replace(params=vs["params"], batch_stats=vs["batch_stats"])
    tf = port_trainer(tvocab, vs)
    plain_loss, _ = tf.evaluate(tdata["validation"], decode=decode)
    tf = TL.Trainer(tf.model, tvocab, feature_config(TC), tf.train_cfg, device="cpu", log_fn=lambda _: None,
                    lm_apply=tword.eval(), lm_weight=0.8)
    tf.init_state(seed=0, variables=vs)
    ref_loss, ref_wer = jf.evaluate(jdata["validation"], decode=decode)
    loss, wer = tf.evaluate(tdata["validation"], decode=decode)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-5)
    assert wer == ref_wer
    assert abs(loss - plain_loss) > 1e-4


# -- LMTrainer

WORDS = ["go", "stop", "up", "down", "a"]
LEXICON = {"go": ["G", "OW"], "stop": ["S", "T", "AA", "P"], "up": ["AH", "P"], "down": ["D", "AW", "N"], "a": ["AH"]}
LM_CFG = dict(num_encoder_layers=1, num_decoder_layers=2, embed_dim=16, num_heads=2, ffn_dim=32, dropout=0.0)


@pytest.fixture(scope="module")
def lm_run():
    """One JAX LMTrainer step and evaluate on a corpus of 16 sentences
    (batches of 8: the JAX trainer shards a batch over 8 devices), and the
    JAX gradients of that step."""
    rng = np.random.default_rng(10)
    sentences = [" ".join(rng.choice(WORDS, size=rng.integers(1, 6))) for _ in range(16)]
    specials = ["<blank>", "<pad>", "<unk>"]
    jcorpus = JLC.LMCorpus(sentences, JLC.Lexicon(LEXICON), JaxWordVocab(specials + WORDS), max_src_len=12, max_tgt_len=6)
    tcorpus = TLC.LMCorpus(sentences, TLC.Lexicon(LEXICON), WordVocab(specials + WORDS), max_src_len=12, max_tgt_len=6)
    src_v, tgt_v = len(jcorpus.phoneme_vocab), len(jcorpus.word_vocab)
    jt = JaxLMTrainer(C.LMConfig(**LM_CFG), src_v, tgt_v, jcorpus.word_vocab.pad_id, learning_rate=1e-3,
                      log_fn=lambda _: None)
    jt.init_state(seed=0)
    params0 = _noisy(jt.state.params, rng)
    placed = pmesh.shard_params(jt.mesh, params0, jt.mesh_cfg)
    jt.state = jt.state.replace(params=placed, opt_state=jt.tx.init(placed))
    batch = next(jcorpus.batches(8, seed=0))
    eval_before = jt.evaluate(jcorpus, batch_size=8)
    state1, loss = jt._train_step(jt.state, *jt._put(*batch))
    pad = jcorpus.word_vocab.pad_id

    def loss_fn(params):
        src, slen, tgt, tlen = (jnp.asarray(a) for a in batch)
        src_mask = jnp.arange(src.shape[1])[None, :] < slen[:, None]
        tgt_mask = jnp.arange(tgt.shape[1])[None, :] < tlen[:, None]
        dec_in = jnp.pad(tgt[:, :-1], ((0, 0), (1, 0)), constant_values=pad)
        logits = jt.model.apply({"params": params}, src, dec_in, src_mask=src_mask, tgt_mask=tgt_mask)
        ce = -jnp.take_along_axis(jax.nn.log_softmax(logits), tgt[..., None], axis=-1)[..., 0]
        w = tgt_mask.astype(ce.dtype)
        return jnp.sum(ce * w) / jnp.maximum(jnp.sum(w), 1.0)

    grads = jax.jit(jax.grad(loss_fn))(params0)
    jt.state = state1
    return types.SimpleNamespace(tcorpus=tcorpus, src_v=src_v, tgt_v=tgt_v, pad=pad, params0=params0, batch=batch,
                                 loss=float(loss), params1=jax.tree.map(np.asarray, state1.params), grads=grads,
                                 eval_before=eval_before, eval_after=jt.evaluate(jcorpus, batch_size=8))


def test_lm_trainer_step_and_evaluate_match_jax(lm_run, tmp_path):
    r = lm_run
    tr = LMTrainer(TC.LMConfig(**LM_CFG), r.src_v, r.tgt_v, r.pad, learning_rate=1e-3, device="cpu",
                   log_fn=lambda _: None)
    tr.init_state(seed=0, params=r.params0)
    np.testing.assert_allclose(tr.evaluate(r.tcorpus, batch_size=8), r.eval_before, rtol=1e-5)
    before = {k: v.clone() for k, v in tr.model.state_dict().items()}
    tr.state, loss = tr._train_step(tr.state, *tr._put(*r.batch))
    np.testing.assert_allclose(loss.item(), r.loss, rtol=1e-5)
    ref_grads = lm_flax_to_state_dict(r.grads)
    ref_after = lm_flax_to_state_dict(r.params1)
    lr = tr.learning_rate
    top = max(np.abs(g.numpy()).max() for g in ref_grads.values())
    for name, p in tr.model.named_parameters():
        g, g_ref = p.grad.numpy(), ref_grads[name].numpy()
        # a gradient that is 0 in exact arithmetic (the key bias) is float32 noise on both sides: held to the
        # model's largest gradient
        scale = max(np.abs(g_ref).max(), 1e-2 * top)
        np.testing.assert_allclose(g, g_ref, atol=1e-4 * scale, err_msg=name)
        step_got = p.detach().numpy() - before[name].numpy()
        step_ref = ref_after[name].numpy() - before[name].numpy()
        clear = np.abs(g_ref) > 1e-4 * scale
        np.testing.assert_allclose(step_got[clear], step_ref[clear], atol=1e-6, err_msg=name)
        decay = 1e-4 * np.abs(before[name].numpy())
        assert np.all(np.abs(step_got) <= lr * (1 + 1e-5 + decay) + 2 * np.spacing(np.abs(before[name].numpy()))), name
    assert sum(int((np.abs(ref_grads[n].numpy()) > 0).any()) for n in ref_grads) > len(ref_grads) // 2
    np.testing.assert_allclose(tr.evaluate(r.tcorpus, batch_size=8), r.eval_after, rtol=1e-5)


def test_lm_trainer_trains_and_saves(lm_run, tmp_path):
    """Epochs fill ``history`` with the loss and its perplexity; the loss
    falls; ``save`` writes a checkpoint that restores into a fresh trainer."""
    from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import restore_state
    from nn_conformer_for_speech_recognition_tpu_torch.train.metrics import perplexity

    r = lm_run
    tr = LMTrainer(TC.LMConfig(**LM_CFG), r.src_v, r.tgt_v, r.pad, learning_rate=1e-2, device="cpu",
                   log_fn=lambda _: None)
    tr.init_state(seed=3)
    hist = tr.train(r.tcorpus, epochs=4, batch_size=8)
    assert len(hist["lm_loss"]) == 4 and hist["lm_loss"][-1] < hist["lm_loss"][0]
    assert hist["lm_ppl"] == [perplexity(x) for x in hist["lm_loss"]]
    tr.save(str(tmp_path / "lm"))
    fresh = LMTrainer(TC.LMConfig(**LM_CFG), r.src_v, r.tgt_v, r.pad, device="cpu", log_fn=lambda _: None)
    restore_state(str(tmp_path / "lm"), fresh.init_state(seed=4))
    for (k, a), b in zip(tr.model.state_dict().items(), fresh.model.state_dict().values()):
        assert torch.equal(a, b), k
    assert fresh.state.optimizer.count == tr.state.optimizer.count == 8
