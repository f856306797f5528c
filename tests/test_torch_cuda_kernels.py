"""The port's hand-written CUDA kernels vs their plain PyTorch twins.

Needs a CUDA device and nvcc; each test skips without a device.  This file
imports no jax, so on a machine without it run it without the repo's
conftest:  python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: float32 log-mel 1e-3 (log of sums of 512-term products taken
in another order), float32 attention 1e-4 and bfloat16 attention 2e-2 (one
bf16 rounding of the output and of the probabilities), LSTM 1e-4 (235
float32 steps).
"""

import pytest
import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import lstm as L
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import stft_logmel as S

pytestmark = pytest.mark.cuda


@pytest.fixture
def cuda():
    if not torch.cuda.is_available():
        pytest.skip("needs a CUDA device")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    return torch.Generator().manual_seed(0)


def _close(got, ref, atol):
    torch.cuda.synchronize()
    err = (got.float() - ref.float()).abs().max().item()
    assert err <= atol, err


@pytest.mark.parametrize(
    "kw, samples", [({}, 480000), ({}, 12345), (dict(n_fft=400, hop_length=160), 16001)]
)
def test_stft_logmel_kernel(cuda, kw, samples):
    cfg = FeatureConfig(**kw)
    audio = (torch.randn(3, samples, generator=cuda) * 0.1).cuda()
    before = S.stft_logmel.launches
    got = S.stft_logmel(audio, cfg)
    assert S.stft_logmel.launches == before + 1
    _close(got, S.stft_logmel_plain(audio, cfg), 1e-3)


@pytest.mark.parametrize("dtype, atol", [(torch.float32, 1e-4), (torch.bfloat16, 2e-2)])
@pytest.mark.parametrize("t, dh", [(1, 64), (33, 32), (235, 64), (70, 128), (40, 16)])
def test_attention_relpos_kernel(cuda, dtype, atol, t, dh):
    b, h = 3, 2
    qu, qv, k, v = ((torch.randn(b, t, h, dh, generator=cuda) * 0.5).cuda().to(dtype) for _ in range(4))
    p = (torch.randn(2 * t - 1, h, dh, generator=cuda) * 0.5).cuda().to(dtype)
    lengths = torch.tensor([t, max(1, t // 2), max(1, t - 3)], dtype=torch.int32).cuda()
    args = (qu, qv, k, v, p, lengths, dh ** -0.5)
    got = A.flash_relpos_attention(*args)
    assert got.dtype == dtype and got.shape == qu.shape
    _close(got, A.flash_relpos_attention_plain(*args), atol)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [320, 100])
def test_lstm_kernel(cuda, reverse, hidden):
    b, t = 4, 235
    xw = torch.randn(b, t, 4 * hidden, generator=cuda).cuda()
    w_hh = (torch.randn(hidden, 4 * hidden, generator=cuda) * hidden ** -0.5).cuda()
    lengths = torch.tensor([t, 100, 1, 234], dtype=torch.int32).cuda()
    got = L.lstm(xw, w_hh, lengths, reverse=reverse)
    _close(got, L.lstm_plain(xw, w_hh, lengths, reverse), 1e-4)


def test_wrappers_reject_what_the_kernels_do_not_take(cuda):
    x = torch.zeros(2, 5, 2, 24, device="cuda")
    with pytest.raises(ValueError):
        A.flash_relpos_attention(x, x, x, x, torch.zeros(9, 2, 24, device="cuda"),
                                 torch.ones(2, dtype=torch.int32, device="cuda"), 1.0)
    with pytest.raises(ValueError):
        L.lstm(torch.zeros(1, 3, 8, device="cuda", dtype=torch.float64),
               torch.zeros(2, 8, device="cuda"), torch.ones(1, device="cuda"))
