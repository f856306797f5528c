"""The log-mel kernel's host tables, and a model of its arithmetic (CPU).

The CUDA kernel (`csrc/stft_logmel.cu`) cannot run here, so what surrounds
it is held here: the folded DFT basis and its padding
(`ops/features.py::kernel_constants`), the TF32 split the kernel applies to
both operands (`split_tf32` below: big rounded, small truncated), the mel bands,
and a model of the kernel's arithmetic (fold, 3×TF32 products with float32
sums started afresh every 32 basis rows, the banded mel sum, the Nyquist
bin) against the JAX package's `log_mel_spectrogram`.  Tolerances: the
split within 2^-20 of each entry; the model within ATOL = 1e-4 of the JAX
package, the bar its Pallas kernel meets against jnp; against float64 the
model within that bar, and one TF32 pass (the control) outside it.
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.ops import features as JF
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.ops import features as TF
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import stft_logmel as S

ATOL = 1e-4
N_FFTS = [512, 400, 1024, 401]
SUM_ROWS = 32  # csrc/stft_logmel.cu: kSumRows, the basis rows whose products a fresh float32 sum takes


def split_tf32(x: np.ndarray):
    """x ≈ big + small, both TF32 (float32 with the low 13 mantissa bits
    zero), as the tensor cores see the kernel's `split_tf32_finite`: big
    rounded to nearest with ties away from zero (``cvt.rna.tf32.f32``),
    small the remainder truncated (the tensor cores read a TF32 operand's
    top 19 bits): the 3×TF32 split."""
    mask = np.uint32(0xFFFFE000)
    big = ((np.asarray(x, np.float32).view(np.uint32) + np.uint32(0x1000)) & mask).view(np.float32)
    return big, ((np.asarray(x, np.float32) - big).view(np.uint32) & mask).view(np.float32)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_folded_basis_holds_the_dft(rng, n_fft):
    """Its rows are `dft_basis`'s own (cosine rows 1 .. n/2, sine rows past
    n/2), and the folded frame against them gives the real DFT below the
    Nyquist bin."""
    real_b, imag_b = TF.dft_basis(n_fft)
    folded = TF.folded_dft_basis(n_fft)
    half, pairs = n_fft // 2, (n_fft + 1) // 2
    assert folded.shape == (2, half, pairs)
    np.testing.assert_array_equal(folded[0], real_b[1 : half + 1, :pairs])
    np.testing.assert_array_equal(folded[1, : n_fft - 1 - half], imag_b[half + 1 :, :pairs])
    assert not folded[1, n_fft - 1 - half :].any()
    x = rng.standard_normal((3, n_fft))
    p = np.arange(1, (n_fft + 1) // 2)
    v = x.copy()
    v[:, p], v[:, n_fft - p] = x[:, p] + x[:, n_fft - p], x[:, n_fft - p] - x[:, p]
    re = v[:, :1] + v[:, 1 : half + 1] @ folded[0]
    im = v[:, half + 1 :] @ folded[1, : n_fft - 1 - half]
    np.testing.assert_allclose(re, (x @ real_b)[:, :pairs], atol=1e-4)
    np.testing.assert_allclose(im, (x @ imag_b)[:, :pairs], atol=1e-4)


@pytest.mark.parametrize("n_fft", N_FFTS)
def test_split_halves_rebuild_the_basis_and_the_padding_is_zero(n_fft):
    """The padded table the kernel reads holds the folded basis and zeros.
    The kernel splits each entry to TF32 on the card; `split_tf32` models
    that split (only the card tests run the kernel's own), and its halves
    rebuild the basis within 2^-20."""
    cfg = TC.FeatureConfig(n_fft=n_fft, hop_length=n_fft // 4)
    basis, bands = TF.kernel_constants(cfg, torch.device("cpu"))
    folded = TF.folded_dft_basis(n_fft)
    rows, cols = folded.shape[1:]
    assert basis.shape[1] % TF.STFT_K_TILE == 0 and basis.shape[2] % TF.STFT_BIN_TILE == 0
    assert basis.shape[1] >= rows and basis.shape[2] >= cols and bands.dtype == torch.int32
    np.testing.assert_array_equal(basis[:, :rows, :cols].numpy(), folded)
    assert not basis[:, rows:].any() and not basis[:, :, cols:].any()
    big, small = split_tf32(folded)
    for half in (big, small):
        assert not (half.view(np.uint32) & np.uint32(0x1FFF)).any()  # TF32: the low 13 mantissa bits are zero
    rebuilt = big.astype(np.float64) + small
    assert (np.abs(rebuilt - folded) <= 2.0 ** -20 * np.abs(folded)).all()


@pytest.mark.parametrize("n_fft, n_mels", [(512, 40), (400, 80), (1024, 128), (512, 160), (2048, 256)])
@pytest.mark.parametrize("htk", [False, True])
def test_mel_bands_cover_every_nonzero(n_fft, n_mels, htk):
    """Past 128 mels the kernel takes them in blocks of 128; at (512, 160)
    HTK leaves some filters with no bin, whose band is empty, (1, 0)."""
    fb = TF.mel_filterbank(16000, n_fft, n_mels, 0.0, 8000.0, htk)
    bands = TF.mel_bands(fb)
    assert bands.shape == (n_mels, 2)
    rows = np.arange(fb.shape[0])[:, None]
    inside = (rows >= bands[:, 0]) & (rows <= bands[:, 1])
    assert not (fb[~inside] != 0).any()
    full = fb.any(axis=0)
    assert (bands[~full] == (1, 0)).all()
    assert (bands[full, 0] <= bands[full, 1]).all() and (fb[bands[full, 0], np.flatnonzero(full)] != 0).all()
    # a bin weighs into at most two mels: the banded sum is ~2 multiply-adds a bin
    assert inside.sum(axis=1).max() <= 2


def _kernel_model(audio: torch.Tensor, cfg, passes: int = 3) -> torch.Tensor:
    """The kernel's arithmetic on the CPU: the windowed frame folded in
    float32, both operands split to TF32 by `split_tf32`, the ``passes``
    products of each `SUM_ROWS` rows summed afresh in float32 and added to the
    running sums, re gaining v[0], power, the banded mel sum in ascending bin
    order with the Nyquist bin, log of the clamp."""
    n = cfg.n_fft
    window, _, _, mel_fb = TF.feature_constants(cfg, torch.device("cpu"))
    x = (TF.frame_signal(audio, n, cfg.hop_length) * window).numpy()
    half, p = n // 2, np.arange(1, (n + 1) // 2)
    v = x.copy()
    v[..., p], v[..., n - p] = x[..., p] + x[..., n - p], x[..., n - p] - x[..., p]
    folded = TF.folded_dft_basis(n)
    a_big, a_small = split_tf32(v)
    b_big, b_small = split_tf32(folded)

    def gemm(first, table, rows):
        out = np.zeros(v.shape[:-1] + (folded.shape[2],), np.float32)
        for r0 in range(0, rows, SUM_ROWS):
            cols, k = slice(first + r0, first + min(rows, r0 + SUM_ROWS)), slice(r0, min(rows, r0 + SUM_ROWS))
            part = a_big[..., cols] @ b_big[table, k]
            if passes == 3:
                part = (a_small[..., cols] @ b_big[table, k] + a_big[..., cols] @ b_small[table, k]) + part
            out += part
        return out

    re = gemm(1, 0, half) + v[..., :1]
    im = gemm(half + 1, 1, n - 1 - half)
    power, fb = re * re + im * im, mel_fb.numpy()
    nyquist = (v[..., : half + 1] * (-1.0) ** np.arange(half + 1)).sum(-1, dtype=np.float32) ** 2
    mel = np.zeros(v.shape[:-1] + (fb.shape[1],), np.float32)
    for m, (lo, hi) in enumerate(TF.mel_bands(fb)):
        top = min(hi, power.shape[-1] - 1)
        if lo <= top:
            mel[..., m] = power[..., lo : top + 1] @ fb[lo : top + 1, m]
        if n % 2 == 0 and lo <= half <= hi:
            mel[..., m] += nyquist * fb[half, m]
    return torch.from_numpy(np.log(np.maximum(mel, np.float32(cfg.log_floor))))


@pytest.mark.parametrize("samples", [16001, 20000])
def test_kernel_arithmetic_model_matches_jax(rng, samples):
    """The 3×TF32 model agrees with the JAX package's log-mel within ATOL and
    lies within ATOL of float64; one TF32 pass, the control, misses that bar."""
    jcfg, tcfg = C.FeatureConfig(normalize="none"), TC.FeatureConfig(normalize="none")
    x = rng.standard_normal((2, samples)).astype(np.float32) * 0.1
    audio = torch.from_numpy(x)
    model = _kernel_model(audio, tcfg)
    ref, _ = JF.log_mel_spectrogram(jnp.asarray(x), jcfg)
    assert model.shape == ref.shape
    np.testing.assert_allclose(model.numpy(), np.asarray(ref), atol=ATOL)
    ref64 = S.stft_logmel_float64(audio, tcfg)
    three = (model.double() - ref64).abs().max().item()
    one = (_kernel_model(audio, tcfg, passes=1).double() - ref64).abs().max().item()
    assert three <= ATOL < one, (three, one)
