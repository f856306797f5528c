"""Shared by ``test_torch_trainer.py`` and ``test_torch_nst.py``: one tiny
synthetic corpus read by both packages' datasets, one tiny Conformer under
``use_pallas=True, conv_impl='pallas'`` (float32, dropout 0, the JAX side's
Pallas kernels in interpret mode on the CPU), and a `Trainer` of each
package started from the same weights."""

import jax
import numpy as np
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.data import datasets as JD
from nn_conformer_for_speech_recognition_tpu.data.audio import make_synthetic_corpus
from nn_conformer_for_speech_recognition_tpu.data.vocab import build_vocab as jax_build_vocab
from nn_conformer_for_speech_recognition_tpu.models.asr import ConformerCTC
from nn_conformer_for_speech_recognition_tpu.train.loop import Trainer as JaxTrainer
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.data import datasets as TD
from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC as TorchCTC
from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

WORDS = ["yes", "no", "go", "stop"]
LR = 1e-3
BATCH = 8  # the JAX trainer shards a batch over the 8 virtual CPU devices


def model_config(lib, dropout=0.0):
    enc = lib.ConformerConfig(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64, conv_kernel_size=7, dropout=dropout)
    dec = lib.DecoderConfig(projection_dim=16, lstm_hidden=16, dropout=dropout)
    return lib.ModelConfig(encoder=enc, decoder=dec, n_mels=13, use_pallas=True, conv_impl="pallas",
                           compute_dtype="float32")


def feature_config(lib):
    return lib.FeatureConfig(n_fft=256, hop_length=256, n_mels=13)


def train_config(lib, **kw):
    kw = {"use_specaugment": False, "log_every": 0, **kw}
    return lib.TrainConfig(batch_size=BATCH, optimizer=lib.OptimizerConfig(learning_rate=LR), **kw)


def make_corpus(root, n_train=32, n_val=8, n_unlabeled=8):
    """Manifests, and the datasets of both packages over them."""
    manifests = make_synthetic_corpus(str(root), WORDS, n_train=n_train, n_val=n_val, n_test=0,
                                      n_unlabeled=n_unlabeled, max_words_per_utt=2, seed=0)
    transcripts = [u.transcript for u in JD.load_manifest(manifests["train"])]
    jvocab, tvocab = jax_build_vocab("word", transcripts), build_vocab("word", transcripts)
    kw = dict(batch_size=BATCH, bucket_boundaries=[14000], max_target_len=4)
    jdata = {k: JD.BucketedDataset(JD.load_manifest(v), jvocab, **kw) for k, v in manifests.items()}
    tdata = {k: TD.BucketedDataset(TD.load_manifest(v), tvocab, **kw) for k, v in manifests.items()}
    return manifests, jvocab, tvocab, jdata, tdata


def jax_trainer(vocab, variables=None, **train_kw):
    """A JAX `Trainer`; with ``variables`` its state starts from them."""
    model = ConformerCTC(model_config(C), vocab_size=len(vocab))
    trainer = JaxTrainer(model, vocab, feature_config(C), train_config(C, donate_state=False, **train_kw),
                         log_fn=lambda _: None)
    trainer.init_state(seed=0)
    if variables is not None:
        trainer.state = trainer.state.replace(params=variables["params"], batch_stats=variables["batch_stats"])
    return trainer


def perturbed_variables(trainer, rng):
    """The JAX trainer's initial variables moved off their symmetric start:
    noise on every leaf, positive running variances, and the blank's output
    bias lowered so that greedy decodes are not empty."""
    vs = {"params": jax.tree.map(np.asarray, trainer.state.params),
          "batch_stats": jax.tree.map(np.asarray, trainer.state.batch_stats)}
    vs = jax.tree.map(lambda a: a + 0.05 * rng.standard_normal(a.shape).astype(np.float32), vs)
    vs["batch_stats"] = jax.tree.map(lambda a: np.abs(a) + 0.5, vs["batch_stats"])
    vs["params"]["final_fc"]["bias"][0] -= 3.0
    return vs


def port_trainer(vocab, variables=None, dropout=0.0, **train_kw):
    trainer = Trainer(TorchCTC(model_config(TC, dropout), len(vocab)), vocab, feature_config(TC),
                      train_config(TC, **train_kw), device="cpu", log_fn=lambda _: None)
    trainer.init_state(seed=0, variables=variables)
    return trainer


def state_tensors(trainer):
    """Every tensor a resumed run must reproduce."""
    st = trainer.state
    out = {f"model.{k}": v for k, v in st.model.state_dict().items()}
    for name, slots in st.optimizer.state.items():
        out.update({f"opt.{name}.{k}": v for k, v in slots.items()})
    out["generator"] = st.generator.get_state()
    return out


def assert_same_state(a, b):
    ta, tb = state_tensors(a), state_tensors(b)
    assert ta.keys() == tb.keys()
    for k in ta:
        assert torch.equal(ta[k], tb[k]), k
    assert (a.state.step, a.state.seed, a.state.optimizer.count) == (b.state.step, b.state.seed, b.state.optimizer.count)


class KilledAfter:
    """Dataset proxy that raises mid-epoch after ``n`` batches: a process
    kill, for the resume tests."""

    def __init__(self, ds, n):
        self._ds, self._n = ds, n

    def epoch(self, seed):
        for i, b in enumerate(self._ds.epoch(seed=seed)):
            if i >= self._n:
                raise KeyboardInterrupt("killed mid-epoch")
            yield b

    def __getattr__(self, k):
        return getattr(self._ds, k)
