"""Data parallelism on the card: the process group at world size 1 over
NCCL (``cpu:gloo,cuda:nccl``, a tcp rendezvous on 127.0.0.1).  Needs a CUDA
device and nvcc; each test skips without a device.  This file imports no
jax; on a machine without it run it without the repo's conftest:
python -m pytest --noconftest -m cuda tests/test_torch_cuda_dp.py

Bit-equal, no tolerance: an all-reduce over one rank copies, so the
data-parallel path (the masked BatchNorm's two all-reduces, the global row
count, the flat gradient all-reduce) must give the plain path's bits.  The
train steps run with ``cudnn.deterministic``: cuDNN's float32 weight
gradients of the subsampling convs otherwise sum in no fixed order, and
one process differs from itself run to run.
"""

import socket

import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu_torch import config as TC

pytestmark = pytest.mark.cuda


@pytest.fixture
def nccl():
    """A one-rank process group with the port's backend, left at the end."""
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    import torch.distributed as dist

    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import BACKEND

    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        port = s.getsockname()[1]

    def start():
        dist.init_process_group(BACKEND, init_method=f"tcp://127.0.0.1:{port}", rank=0, world_size=1)

    yield start
    if dist.is_initialized():
        dist.destroy_process_group()


def _small(dtype):
    enc = TC.ConformerConfig(num_blocks=2, d_model=64, num_heads=2, ffn_dim=128, conv_kernel_size=7, dropout=0.1)
    dec = TC.DecoderConfig(projection_dim=32, lstm_hidden=32, dropout=0.1)
    return TC.ModelConfig(encoder=enc, decoder=dec, n_mels=40, use_pallas=True, compute_dtype=dtype)


@pytest.mark.parametrize("dtype", [torch.bfloat16, torch.float32])
def test_masked_batchnorm_is_bit_equal_at_world_size_1(nccl, dtype):
    from nn_conformer_for_speech_recognition_tpu_torch.models.conformer import MaskedBatchNorm, length_mask

    gen = torch.Generator().manual_seed(0)
    x0 = (torch.randn(4, 50, 64, generator=gen) * 2 + 1).to("cuda", dtype)
    mask = length_mask(torch.tensor([50, 31, 7, 0], device="cuda"), 50)
    probe = torch.randn(4, 50, 64, generator=gen).to("cuda", dtype)

    def run():
        bn = MaskedBatchNorm(64).cuda().train()
        x = x0.clone().requires_grad_(True)
        y = bn(x, mask)
        (y * probe).sum().backward()
        return y.detach(), x.grad, bn.weight.grad, bn.running_mean, bn.running_var

    plain = run()
    nccl()
    for a, b in zip(plain, run()):
        assert torch.equal(a, b)


@pytest.mark.parametrize("dtype", ["bfloat16", "float32"])
def test_data_parallel_steps_are_bit_equal_at_world_size_1(nccl, tmp_path, dtype, monkeypatch):
    """Two train steps of a small model with dropout and SpecAugment on,
    through `Trainer.train`, without and with the process group."""
    monkeypatch.setattr(torch.backends.cudnn, "deterministic", True)
    from nn_conformer_for_speech_recognition_tpu_torch.data.audio import make_synthetic_corpus
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset, load_manifest
    from nn_conformer_for_speech_recognition_tpu_torch.data.vocab import build_vocab
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import Trainer

    man = make_synthetic_corpus(str(tmp_path / "corpus"), ["yes", "no", "go", "stop"], n_train=16, n_val=8, n_test=0,
                                n_unlabeled=0, max_words_per_utt=2, seed=0)
    utts = load_manifest(man["train"])
    vocab = build_vocab("word", [u.transcript for u in utts])
    data = BucketedDataset(utts, vocab, 8, bucket_boundaries=[14000], max_target_len=4)
    val = BucketedDataset(load_manifest(man["validation"]), vocab, 8, bucket_boundaries=[14000], max_target_len=4)

    def run():
        tr = Trainer(ConformerCTC(_small(dtype), len(vocab)), vocab, TC.FeatureConfig(),
                     TC.TrainConfig(batch_size=8, log_every=0), learning_rate=1e-3, log_fn=lambda _: None)
        tr.init_state(seed=0)
        tr.train(data, epochs=1)
        state = {k: v.clone() for k, v in tr.model.state_dict().items()}
        state.update({f"opt.{n}.{k}": v.clone() for n, s in tr.state.optimizer.state.items() for k, v in s.items()})
        return tr, state, tr.evaluate(val, return_texts=True), tr.generate_labels(val)

    plain, plain_state, plain_eval, plain_labels = run()
    nccl()
    dp, dp_state, dp_eval, dp_labels = run()
    assert plain.shard is None and dp.shard is not None and dp.shard.world == 1
    assert dp.history["train_loss"] == plain.history["train_loss"] and np.isfinite(dp.history["train_loss"]).all()
    assert dp_state.keys() == plain_state.keys()
    assert [k for k in dp_state if not torch.equal(dp_state[k], plain_state[k])] == []
    assert dp_eval == plain_eval and dp_labels == plain_labels
