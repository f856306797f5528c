"""The port's SpecAugment against the JAX package's, and its own draws.

Random streams cannot match across the two frameworks, so the parity test
derives the draws from the JAX key with the same ``jax.random`` calls as
``_specaugment_single``, hands them to `apply_specaugment` and compares
with the JAX `specaugment` on the same key: masks exactly, warped values
within atol 5e-5.  Against the eager JAX warp the port is exact; the
jitted JAX function fuses the float32 arithmetic of the source coordinate
and lands a few ulps (~4e-6 of a frame at T=40) away, which the
interpolation scales by the step between neighbouring frames (≤ ~8 here).  The port's own draws (`draw_specaugment`) are held to
their distributions by statistical checks with wide bounds (≥ 5 standard
errors).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu.config import SpecAugmentConfig as JaxSpecAugmentConfig
from nn_conformer_for_speech_recognition_tpu.ops.specaugment import specaugment as jax_specaugment
from nn_conformer_for_speech_recognition_tpu_torch.config import SpecAugmentConfig
from nn_conformer_for_speech_recognition_tpu_torch.ops.specaugment import (
    SpecAugmentDraws,
    add_gaussian_noise,
    apply_specaugment,
    draw_specaugment,
)


def _jax_draws(key, frame_lengths, n_mels, cfg) -> SpecAugmentDraws:
    """The draws `_specaugment_single` makes for each example of the batch."""
    rows = []
    for k, tau in zip(jax.random.split(key, len(frame_lengths)), frame_lengths):
        k_warp, k_freq, k_time = jax.random.split(k, 3)
        tau_f = jnp.float32(tau)
        warp = []
        for i in range(cfg.time_warp_n if cfg.time_warp_w > 0 else 0):
            k1, k2 = jax.random.split(jax.random.fold_in(k_warp, i))
            lo = jnp.float32(cfg.time_warp_w)
            hi = jnp.maximum(tau_f - cfg.time_warp_w, lo + 1.0)
            w0 = jnp.floor(jax.random.uniform(k1, (), minval=lo, maxval=hi))
            w = jnp.round(jax.random.uniform(k2, (), minval=-float(cfg.time_warp_w), maxval=float(cfg.time_warp_w)))
            warp.append((float(w0), float(jnp.where(tau_f > 2.0 * cfg.time_warp_w + 1.0, w, 0.0))))

        def masks(key, n, axis_size, max_width):
            out = []
            for km in jax.random.split(key, n):
                kw, kp = jax.random.split(km)
                width = jax.random.randint(kw, (), 0, jnp.maximum(max_width, 1) + 1)
                out.append((int(jax.random.randint(kp, (), 0, jnp.maximum(axis_size - width, 0) + 1)), int(width)))
            return out

        freq = masks(k_freq, cfg.freq_mask_n, jnp.int32(n_mels), jnp.int32(cfg.freq_mask_f))
        t_param = jnp.floor(cfg.ps * tau_f).astype(jnp.int32) if cfg.adaptive_size else jnp.int32(cfg.time_mask_t)
        mt = cfg.time_mask_n
        if cfg.adaptive_multiplicity:
            mt = min(mt, int(np.floor(np.float32(cfg.pm) * np.float32(tau))))
        time = masks(k_time, cfg.time_mask_n, jnp.int32(tau), t_param)
        rows.append((warp, freq, time, mt))

    warp = torch.tensor([r[0] for r in rows], dtype=torch.float32).reshape(len(rows), -1, 2)
    freq = torch.tensor([r[1] for r in rows], dtype=torch.int64).reshape(len(rows), -1, 2)
    time = torch.tensor([r[2] for r in rows], dtype=torch.int64).reshape(len(rows), -1, 2)
    return SpecAugmentDraws(
        warp[..., 0], warp[..., 1], freq[..., 0], freq[..., 1], time[..., 0], time[..., 1],
        torch.tensor([r[3] for r in rows], dtype=torch.int64),
    )


CONFIGS = {
    "default": {},
    "adaptive_two_warps": dict(time_warp_w=3, time_warp_n=2, adaptive_size=True, adaptive_multiplicity=True,
                               ps=0.2, pm=0.1, time_mask_n=3),
    "wide_masks": dict(time_warp_w=2, freq_mask_f=12, freq_mask_n=3, time_mask_t=9, mask_value=-1.5),
}


@pytest.mark.parametrize("name", sorted(CONFIGS))
def test_apply_matches_jax_with_the_jax_draws(rng, name):
    cfg, jcfg = SpecAugmentConfig(**CONFIGS[name]), JaxSpecAugmentConfig(**CONFIGS[name])
    lengths = np.asarray([40, 23, 7, 31], np.int32)
    feats = rng.standard_normal((4, 40, 16)).astype(np.float32)
    key = jax.random.key(3)
    ref = np.asarray(jax_specaugment(jnp.asarray(feats), jnp.asarray(lengths), key, jcfg))
    draws = _jax_draws(key, lengths, 16, jcfg)
    got = apply_specaugment(torch.from_numpy(feats), torch.from_numpy(lengths), draws, cfg)
    assert not np.allclose(ref, feats)  # something was augmented
    np.testing.assert_allclose(got.numpy(), ref, atol=5e-5)


def test_own_draws_in_range_and_independent_per_row():
    cfg = SpecAugmentConfig(time_warp_w=2, freq_mask_f=5, freq_mask_n=2, time_mask_t=6, time_mask_n=2,
                            adaptive_multiplicity=True, pm=0.05)
    n, n_mels = 4096, 40
    lengths = torch.randint(1, 200, (n,), generator=torch.Generator().manual_seed(1))
    d = draw_specaugment(lengths, n_mels, cfg, torch.Generator().manual_seed(0))
    tau = lengths[:, None].float()
    # warp: centre in [W, max(tau - W, W + 1)), integer shift in [-W, W], 0 for short rows
    assert torch.all(d.warp_center >= 2) and torch.all(d.warp_center < torch.clamp_min(tau - 2, 3))
    assert torch.all(d.warp_shift.abs() <= 2) and torch.all(d.warp_shift == d.warp_shift.round())
    assert torch.all(d.warp_shift[lengths <= 5] == 0)
    # frequency masks: width uniform in [0, F], start in [0, n_mels - width]
    assert torch.all((0 <= d.freq_width) & (d.freq_width <= 5))
    assert torch.all((0 <= d.freq_start) & (d.freq_start + d.freq_width <= n_mels))
    counts = torch.bincount(d.freq_width.flatten(), minlength=6).float() / d.freq_width.numel()
    assert torch.all((counts - 1 / 6).abs() < 5 * (1 / 6 * 5 / 6 / d.freq_width.numel()) ** 0.5), counts
    # time masks stay inside the valid frames; adaptive multiplicity
    assert torch.all(d.time_start + d.time_width <= torch.clamp_min(tau, d.time_width.float()))
    assert torch.equal(d.time_active, torch.clamp_max(torch.floor(0.05 * lengths.float()).long(), 2))
    # rows draw independently: the two masks of a row, and neighbouring rows
    first, second = d.freq_start[:, 0].float(), d.freq_start[:, 1].float()
    for a, b in ((first, second), (first[:-1], first[1:])):
        corr = torch.corrcoef(torch.stack([a, b]))[0, 1]
        assert abs(corr) < 5 / n ** 0.5, corr


def test_padding_frames_untouched():
    """Warp and time masks stay in the valid frames of rows at least as long
    as the widest time mask (a shorter row's mask starts at 0 and may run
    past its end, as in the JAX package)."""
    cfg = SpecAugmentConfig(time_warp_w=2, freq_mask_n=0, time_mask_t=8, time_mask_n=3)
    gen = torch.Generator().manual_seed(0)
    feats = torch.randn(16, 50, 8, generator=gen)
    lengths = torch.randint(8, 51, (16,), generator=gen)
    out = apply_specaugment(feats, lengths, draw_specaugment(lengths, 8, cfg, gen), cfg)
    pad = torch.arange(50)[None, :] >= lengths[:, None]
    assert torch.equal(out[pad], feats[pad])
    assert not torch.equal(out[~pad], feats[~pad])


def test_gaussian_noise():
    audio = torch.zeros(4, 20000)
    noisy = add_gaussian_noise(audio, torch.Generator().manual_seed(0), std=0.05)
    assert abs(noisy.std().item() - 0.05) < 5e-3 and abs(noisy.mean().item()) < 5e-3
    assert torch.equal(noisy, add_gaussian_noise(audio, torch.Generator().manual_seed(0), std=0.05))

