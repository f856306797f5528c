"""Port's log-mel featurisation vs the JAX package (CPU, plain twins).

Tolerance atol 1e-4 on log-mel: the bar the Pallas kernel meets against
the jnp reference (test_pallas.py::test_stft_logmel_matches_jnp); the two
sides sum the DFT matmuls in different orders.
"""

import dataclasses

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu import config as C
from nn_conformer_for_speech_recognition_tpu.ops import features as JF
from nn_conformer_for_speech_recognition_tpu.ops.pallas.stft_logmel import stft_logmel_pallas
from nn_conformer_for_speech_recognition_tpu_torch import config as TC
from nn_conformer_for_speech_recognition_tpu_torch.ops import features as TF
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda.stft_logmel import stft_logmel

ATOL = 1e-4


def _configs(**kw):
    return C.FeatureConfig(**kw), TC.FeatureConfig(**kw)


def test_filterbank_helpers_are_exact_copies():
    f = np.linspace(0.0, 8000.0, 97)
    for htk in (False, True):
        np.testing.assert_array_equal(TF.hz_to_mel(f, htk), JF.hz_to_mel(f, htk))
        m = JF.hz_to_mel(f, htk)
        np.testing.assert_array_equal(TF.mel_to_hz(m, htk), JF.mel_to_hz(m, htk))
        np.testing.assert_array_equal(
            TF.mel_filterbank(16000, 512, 40, 0.0, 8000.0, htk),
            JF.mel_filterbank(16000, 512, 40, 0.0, 8000.0, htk),
        )
    for win, n_fft in ((512, 512), (400, 512)):
        np.testing.assert_array_equal(TF.hann_window(win, n_fft), JF.hann_window(win, n_fft))
    for a, b in zip(TF.dft_basis(400), JF.dft_basis(400)):
        np.testing.assert_array_equal(a, b)


@pytest.mark.parametrize(
    "kw, samples, lengths",
    [
        (dict(normalize="none"), 16000, None),
        (dict(normalize="none"), 12345, None),  # odd length: ragged last frame
        (dict(normalize="minmax"), 16001, [16001, 7000, 513]),
        (dict(normalize="meanvar"), 9000, [9000, 4321, 2500]),
        (dict(n_fft=400, hop_length=160, normalize="none"), 3201, None),
    ],
)
def test_log_mel_matches_jax(rng, kw, samples, lengths):
    jcfg, tcfg = _configs(**kw)
    n = 3 if lengths is None else len(lengths)
    x = rng.standard_normal((n, samples)).astype(np.float32) * 0.1
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    ref, ref_len = JF.log_mel_spectrogram(jnp.asarray(x), jcfg, jl)
    got, got_len = TF.log_mel_spectrogram(torch.from_numpy(x), tcfg, tl)
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)
    if lengths is not None:
        np.testing.assert_array_equal(got_len.numpy(), np.asarray(ref_len))
    # the featurizer (kernel wrapper → plain twin on the CPU) agrees too
    feats, _ = TF.make_featurizer(tcfg)(torch.from_numpy(x), tl)
    np.testing.assert_allclose(feats.numpy(), np.asarray(ref), atol=ATOL)


@pytest.mark.parametrize("samples", [16000, 20000, 7777])
def test_stft_wrapper_matches_pallas_interpret(rng, samples):
    jcfg, tcfg = _configs(normalize="none")
    x = rng.standard_normal((3, samples)).astype(np.float32) * 0.1
    ref = stft_logmel_pallas(jnp.asarray(x), jcfg, interpret=True)
    got = stft_logmel(torch.from_numpy(x), tcfg)
    assert got.shape == ref.shape
    np.testing.assert_allclose(got.numpy(), np.asarray(ref), atol=ATOL)


def test_feature_pipeline_golden():
    """The chirp of test_golden.py gives the pinned mean -16.107."""
    t = np.arange(16000) / 16000.0
    chirp = np.sin(2 * np.pi * (200 + 1500 * t) * t).astype(np.float32)
    feats, _ = TF.log_mel_spectrogram(torch.from_numpy(chirp[None]), TC.FeatureConfig(normalize="none"))
    assert abs(feats.mean().item() - (-16.107)) < 0.15
    assert torch.isfinite(feats).all()


def test_featurizer_impl_choice(rng):
    _, tcfg = _configs()
    x = torch.from_numpy(rng.standard_normal((2, 8000)).astype(np.float32))
    lengths = torch.tensor([8000, 3000], dtype=torch.int32)
    a, la = TF.make_featurizer(tcfg)(x, lengths)
    b, lb = TF.make_featurizer(dataclasses.replace(tcfg, impl="xla"))(x, lengths)
    torch.testing.assert_close(a, b)
    torch.testing.assert_close(la, lb)
    with pytest.raises(ValueError):
        TF.make_featurizer(dataclasses.replace(tcfg, impl="fft"))
