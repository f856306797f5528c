"""The benchmark's frozen copies equal the originals they were copied from."""

import importlib

import pytest
import torch

from benchmark import harness as H
from benchmark import yardstick as Y


@pytest.mark.parametrize("name", ["conformer_m"])
@pytest.mark.parametrize("batch,frames", [(256, 3001), (64, 12001), (3, 17)])
def test_flops_equal_the_ports(name, batch, frames):
    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.utils import flops

    cfg = H.read_json(H.ROOT / "configs" / f"{name}.json")
    port = getattr(C, name)(use_pallas=True, n_mels=cfg["model"]["n_mels"])
    assert Y.train_step_flops(cfg["model"], 1024, batch, frames) == flops.train_step_flops(port, 1024, batch, frames)
    assert Y.conformer_forward_flops(cfg["model"], 1024, batch, frames) == flops.conformer_forward_flops(
        port, 1024, batch, frames)


def test_groups_equal_profile_steps():
    from nn_conformer_for_speech_recognition_tpu_torch.utils import profile_step

    assert Y.GROUPS == profile_step.GROUPS and Y.REST == profile_step.REST
    names = ("lstm_fwd_cluster_kernel", "ampere_bf16_s16816gemm", "void at::native::elementwise", "ctc_beta_kernel")
    for name in names:
        assert Y.group_of(name) == profile_step.group_of(name)


def test_peaks_equal_the_ports():
    from nn_conformer_for_speech_recognition_tpu_torch.utils import flops

    assert Y.BF16_PEAK_FLOPS == flops.BF16_PEAK_FLOPS
    assert Y.peak_bf16_flops("NVIDIA H100 80GB HBM3") == 989e12


@pytest.mark.parametrize("moved,ops,kind", [(1e9, 1e9, "fp32"), (1e6, 1e13, "bf16"), (5e8, 2e12, "tf32")])
def test_bound_equals_chip_smokes(moved, ops, kind):
    chip_smoke = importlib.import_module("chip_smoke")
    dtype = {"fp32": torch.float32, "bf16": torch.bfloat16, "tf32": "tf32"}[kind]
    assert Y.bound_s(moved, ops, kind) * 1e3 == pytest.approx(
        chip_smoke.numbers(0.0, 1.0, 1.0, moved, ops, dtype)["bound_ms"], rel=1e-12)


def test_config_file_is_the_ports_preset_with_the_papers_features():
    """Conformer-M's widths are the port's preset; its features and
    SpecAugment are the paper's (80 mels, 25 ms windows, 10 ms hops; F=27,
    ten time masks of at most 5% of a row), set in the file."""
    from nn_conformer_for_speech_recognition_tpu_torch import config as C

    cfg = H.read_json(H.ROOT / "configs" / "conformer_m.json")
    model, feat, train = H.port_configs(cfg, {"batch": 8, "specaugment": True}, 0)
    assert model == C.conformer_m(use_pallas=True, n_mels=80)
    assert feat == C.FeatureConfig(n_mels=80, n_fft=512, win_length=400, hop_length=160)
    assert train.optimizer == C.OptimizerConfig()
    assert train.specaugment == C.SpecAugmentConfig(time_warp_w=0, freq_mask_f=27, freq_mask_n=2, time_mask_n=10,
                                                    adaptive_size=True, ps=0.05)
    assert cfg["vocab_size"] == 1024 and cfg["reduced"] == ["conv_kernel_size"]
    assert cfg["model"]["encoder"]["conv_kernel_size"] == 33


def test_step_bounds_count_real_lengths():
    cfg = H.read_json(H.ROOT / "configs" / "conformer_m.json")
    full = Y.step_bounds(cfg, [480000] * 4, [81] * 4, True)
    short = Y.step_bounds(cfg, [320000] * 4, [54] * 4, True)
    assert set(full) == {"stft_logmel", "lstm", "lstm_dwhh", "ctc", "attention"}
    assert all(short[k] < full[k] for k in full)
    label = Y.step_bounds(cfg, [480000] * 4, [0] * 4, False)
    assert set(label) == {"stft_logmel", "lstm", "attention"} and label["lstm"] < full["lstm"]
