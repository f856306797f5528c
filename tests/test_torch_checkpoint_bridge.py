"""The JAX-checkpoint bridge (``tools/jax_checkpoint_to_torch.py`` over
`convert.train_state_from_flax`): a checkpoint that the JAX `Trainer`
wrote with orbax, read by the port.

The JAX trainer of ``test_torch_trainer.py``'s tiny model trains two steps
(16 clips, batch 8; Adafactor with momentum, lr 1e-3, dropout and
SpecAugment off) and saves through its `CheckpointManager`; the bridge
converts the newest step.  Tolerances: `evaluate` of both packages from
the one checkpoint, loss rtol 1e-4 (float32, sums in another order), WER
and strings equal; one further train step in both, loss rtol 1e-4 and
parameters rtol 1e-4 with an atol of 1e-4 of each tensor's largest entry.
The rel-pos projections are held through the projected table with its
mean over positions removed, at atol 5e-4: their gradient is float noise
along the sinusoid's near-constant columns, and Adafactor's normalised
update gives those entries a step of either sign
(``test_torch_data_parallel.py``).  A control converts the parameters
alone (a fresh optimizer) and must miss those bars.  The packing of flax
LSTM gate statistics into the port's packed blocks is held to the port's
Adafactor run on the packed parameters, rtol 1e-6.  ``cli eval
--checkpoint`` of the port reads a converted checkpoint of the
``reference`` preset, held to the JAX `Trainer.evaluate` at the same bars.
"""

import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from _torch_multiproc_helpers import assert_params_close
from _torch_trainer_helpers import jax_trainer, make_corpus, perturbed_variables, port_trainer

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.data import datasets as JD
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC as JaxCTC
from nn_conformer_for_speech_recognition_tpu.train import checkpoint as JCK
from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer as JaxTrainer
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict, optimizer_state_from_optax
from nn_conformer_for_speech_recognition_tpu_torch.data import datasets as TD
from nn_conformer_for_speech_recognition_tpu_torch.train.checkpoint import restore_state
from nn_conformer_for_speech_recognition_tpu_torch.train.optim import Adafactor

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
_spec = importlib.util.spec_from_file_location("jax_checkpoint_to_torch",
                                               os.path.join(REPO, "tools", "jax_checkpoint_to_torch.py"))
bridge = importlib.util.module_from_spec(_spec)
_spec.loader.exec_module(bridge)


def _one_batch(lib, dataset):
    """The first 8 clips of ``dataset``: one batch, for one further step."""
    return lib.BucketedDataset(dataset.utterances[:8], dataset.vocab, batch_size=8, bucket_boundaries=[14000],
                               max_target_len=4)


@pytest.fixture(scope="module")
def bridged(tmp_path_factory):
    root = tmp_path_factory.mktemp("bridge")
    _, jvocab, tvocab, jdata, tdata = make_corpus(root / "corpus", n_train=16)
    jt = jax_trainer(jvocab)
    start = perturbed_variables(jt, np.random.default_rng(0))
    jt.state = jt.state.replace(params=start["params"], batch_stats=start["batch_stats"])
    jt.train(jdata["train"], epochs=1)
    assert int(jt.state.step) == 2
    JCK.CheckpointManager(str(root / "jax_ckpts")).save(jt.state, iterator={"epoch": 1, "step": 0})
    JCK.save_state(str(root / "jax_state"), jt.state, iterator={"epoch": 1, "step": 0})
    cfg = port_trainer(tvocab).model.config
    out = bridge.convert(str(root / "jax_ckpts"), str(root / "port"), cfg, seed=0)
    assert out == str(root / "port" / "state.pt")
    tt = port_trainer(tvocab)
    _, cursor = restore_state(str(root / "port"), tt.state, with_iterator=True)
    return dict(root=root, jt=jt, tt=tt, cursor=cursor, jdata=jdata, tdata=tdata, tvocab=tvocab, cfg=cfg)


def test_the_converted_state_is_complete(bridged):
    tt, jt = bridged["tt"], bridged["jt"]
    assert (tt.state.step, tt.state.optimizer.count, tt.state.seed) == (2, 2, 0)
    assert bridged["cursor"] == {"epoch": 1, "step": 0}
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jt.state.params),
                              "batch_stats": jax.tree.map(np.asarray, jt.state.batch_stats)}, bridged["cfg"])
    got = tt.model.state_dict()
    assert got.keys() == ref.keys() and all(torch.equal(got[k], ref[k]) for k in ref)
    # the manager's newest step and the state directory convert alike
    bridge.convert(str(bridged["root"] / "jax_state"), str(bridged["root"] / "port2"), bridged["cfg"])
    a = torch.load(bridged["root"] / "port" / "state.pt", weights_only=True)
    b = torch.load(bridged["root"] / "port2" / "state.pt", weights_only=True)
    assert a["optimizer"]["state"].keys() == b["optimizer"]["state"].keys()
    for name, slots in a["optimizer"]["state"].items():
        assert all(torch.equal(slots[k], b["optimizer"]["state"][name][k]) for k in slots)
    # the generator is seeded from the seed, as a fresh state's is
    assert torch.equal(tt.state.generator.get_state(), torch.Generator().manual_seed(0).get_state())


def test_evaluate_from_one_checkpoint_matches_jax(bridged):
    loss, wer, refs, hyps = bridged["tt"].evaluate(bridged["tdata"]["validation"], return_texts=True)
    ref_loss, ref_wer, ref_refs, ref_hyps = bridged["jt"].evaluate(bridged["jdata"]["validation"], return_texts=True)
    np.testing.assert_allclose(loss, ref_loss, rtol=1e-4)
    assert (wer, refs, hyps) == (ref_wer, ref_refs, ref_hyps) and any(hyps)


@pytest.fixture(scope="module")
def further(bridged):
    """One more step in both packages, and in the control (the parameters
    converted, the optimizer fresh)."""
    jt, tt = bridged["jt"], bridged["tt"]
    before = {k: v.clone() for k, v in tt.model.state_dict().items()}
    control = port_trainer(bridged["tvocab"])
    control.model.load_state_dict(before)
    jh = jt.train(_one_batch(JD, bridged["jdata"]["train"]), epochs=1)["train_loss"][-1]
    th = tt.train(_one_batch(TD, bridged["tdata"]["train"]), epochs=1)["train_loss"][-1]
    control.train(_one_batch(TD, bridged["tdata"]["train"]), epochs=1)
    ref = flax_to_state_dict({"params": jax.tree.map(np.asarray, jt.state.params),
                              "batch_stats": jax.tree.map(np.asarray, jt.state.batch_stats)}, bridged["cfg"])
    return dict(jax_loss=jh, port_loss=th, before=before, ref=ref, got=tt.model.state_dict(),
                control=control.model.state_dict())


def test_one_further_step_matches_jax(further):
    np.testing.assert_allclose(further["port_loss"], further["jax_loss"], rtol=1e-4)
    assert_params_close(further["got"], further["ref"], "", rtol=1e-4)
    moved = max(float((further["ref"][k] - further["before"][k]).abs().max()) for k in further["ref"])
    assert moved > 5e-4, "the step moved nothing: the comparison is vacuous"


def test_a_fresh_optimizer_misses_the_bar(further):
    with pytest.raises(AssertionError):
        assert_params_close(further["control"], further["ref"], "", rtol=1e-4)


@pytest.mark.parametrize("in_dim,hidden", [(130, 128), (16, 16)])
def test_lstm_gate_statistics_pack_into_the_port_blocks(in_dim, hidden):
    """optax's Adafactor on the flax cell's eight gate leaves and the port's
    on the packed w_ih, w_hh and bias see the same gradients for 3 steps;
    the converted gate state equals the port's (factored at (130, 128):
    rows and columns trade places between a gate and its packed block)."""
    rng = np.random.default_rng(0)
    gates = "ifgo"
    params = {"decoder_lstm": {"OptimizedLSTMCell_0": {
        **{f"i{g}": {"kernel": rng.standard_normal((in_dim, hidden)).astype(np.float32)} for g in gates},
        **{f"h{g}": {"kernel": rng.standard_normal((hidden, hidden)).astype(np.float32),
                     "bias": rng.standard_normal(hidden).astype(np.float32)} for g in gates}}}}
    tx = optax.adafactor(1e-3, multiply_by_parameter_scale=False, momentum=0.9, clipping_threshold=1.0)
    state = tx.init(params)
    cells = params["decoder_lstm"]["OptimizedLSTMCell_0"]
    port = {"decoder_lstm.lstm_fwd_0_w_ih": np.concatenate([cells[f"i{g}"]["kernel"] for g in gates], 1),
            "decoder_lstm.lstm_fwd_0_w_hh": np.concatenate([cells[f"h{g}"]["kernel"] for g in gates], 1),
            "decoder_lstm.lstm_fwd_0_bias": np.concatenate([cells[f"h{g}"]["bias"] for g in gates])}
    packed = {k: torch.nn.Parameter(torch.from_numpy(v)) for k, v in port.items()}
    opt = Adafactor(packed.items(), 1e-3, momentum=0.9, clipping_threshold=1.0)
    p = jax.tree.map(jnp.asarray, params)
    for _ in range(3):
        grads = jax.tree.map(lambda a: rng.standard_normal(a.shape).astype(np.float32), params)
        updates, state = tx.update(jax.tree.map(jnp.asarray, grads), state, p)
        p = optax.apply_updates(p, updates)
        g = grads["decoder_lstm"]["OptimizedLSTMCell_0"]
        for name, leaf, axis in (("w_ih", "i{}", 1), ("w_hh", "h{}", 1)):
            packed[f"decoder_lstm.lstm_fwd_0_{name}"].grad = torch.from_numpy(
                np.concatenate([g[leaf.format(x)]["kernel"] for x in gates], axis))
        packed["decoder_lstm.lstm_fwd_0_bias"].grad = torch.from_numpy(np.concatenate([g[f"h{x}"]["bias"] for x in gates]))
        opt.step()
    count, converted = optimizer_state_from_optax(jax.tree.map(np.asarray, state), params, lstm_layout=lambda: (1, False))
    assert count == opt.count == 3 and converted.keys() == opt.state.keys()
    for name, slots in opt.state.items():
        assert converted[name].keys() == slots.keys(), name
        for k in slots:
            if k == "ema":  # the momentum of each gate's own (per-block) update, concatenated
                assert converted[name][k].shape == slots[k].shape
                continue
            torch.testing.assert_close(converted[name][k], slots[k], rtol=1e-6, atol=0, msg=f"{name}.{k}")
    if in_dim == 130:
        assert set(opt.state["decoder_lstm.lstm_fwd_0_w_ih"]) == {"v_row", "v_col", "ema"}


def test_cli_eval_reads_a_converted_checkpoint(tmp_path, capsys):
    """The ``reference`` preset, initialised and saved by the JAX package,
    converted by the bridge's command line, evaluated by the port's
    ``eval --checkpoint`` as by the JAX `Trainer`."""
    from nn_conformer_for_speech_recognition_tpu.data.audio import make_synthetic_corpus
    from nn_conformer_for_speech_recognition_tpu.data.vocab import build_vocab as jax_build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.cli.main import main

    corpus = str(tmp_path / "corpus")
    make_synthetic_corpus(corpus, ["go", "stop", "yes", "no"], n_train=8, n_val=8, n_test=0, n_unlabeled=0,
                          max_words_per_utt=2, seed=0)
    val = JD.load_manifest(os.path.join(corpus, "validation.tsv"))
    vocab = jax_build_vocab("word", [u.transcript for u in JD.load_manifest(os.path.join(corpus, "train.tsv"))], 1024)
    kw = dict(compute_dtype="float32", use_pallas=True, n_mels=40)
    jt = JaxTrainer(JaxCTC(C.MODEL_PRESETS["reference"](**kw), vocab_size=len(vocab)), vocab, C.FeatureConfig(),
                    C.TrainConfig(batch_size=8), log_fn=lambda _: None)
    jt.init_state(seed=0)
    jt.save(str(tmp_path / "jax"))
    assert bridge.main([str(tmp_path / "jax"), str(tmp_path / "port"), "--model", "reference"]) == 0
    capsys.readouterr()
    assert main(["eval", "--manifest-dir", corpus, "--split", "validation", "--model", "reference", "--compute-dtype",
                 "float32", "--use-pallas", "--batch-size", "8", "--max-target-len", "4", "--device", "cpu",
                 "--checkpoint", str(tmp_path / "port")]) == 0
    import json

    got = json.loads(capsys.readouterr().out.strip().splitlines()[-1])
    ref_loss, ref_wer = jt.evaluate(JD.BucketedDataset(val, vocab, batch_size=8, max_target_len=4))
    np.testing.assert_allclose(got["loss"], ref_loss, rtol=1e-4)
    assert got["wer"] == pytest.approx(100 * ref_wer, rel=1e-12)
