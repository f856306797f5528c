"""Where one bf16 train step, or one pseudo-label batch, spends the card's
time, by kernel group.

    python -m nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step long    # B=4 × 120 s, 400 targets
    python -m nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step short   # B=16 × 30 s, 100 targets
    python -m nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step pass    # pseudo-labels, B=16 × 30 s
    python -m nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step short pallas   # conv_impl='pallas'
    python -m nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step short conformer_l

A further word ``pallas`` profiles the configuration whose depthwise conv is
the hand-written kernel (``conv_impl='pallas'``) instead of the grouped
conv1d; ``conformer_l`` profiles Conformer-L (its BiLSTM, H = 640, on the
grid kernels) instead of Conformer-M.  Builds the hand-written kernels,
warms the preset's train step
(`train.loop.make_train_step`: log-mel, SpecAugment, forward, CTC,
backward, Adafactor) or its pseudo-label pass (`train.loop.make_predict_step`:
log-mel, forward, greedy decode), weights and audio from a seed, up over
two calls, times five calls unprofiled, then runs three under
``torch.profiler`` and prints the device time per call by kernel group
(first match of `GROUPS` on the kernel's name; whatever matches none is
elementwise work, reductions and copies), the launches per call, the
card's busy share, and the host and device time per call of each phase span
the step holds (`utils.profiling.phase_table`).  Needs a CUDA device.
"""

from __future__ import annotations

import subprocess
import sys
import time

import torch

SHAPES = {"long": (4, 120.0, 400), "short": (16, 30.0, 100)}  # batch, clip seconds, targets per row
VOCAB, SEED, PROFILED_STEPS = 1024, 3, 3
REST = "elementwise, reductions, copies"
GROUPS = (
    # every rel-pos kernel: the tensor-core one in bf16 (attention_relpos_tc_kernel, bwd_*_tc_kernel), the
    # CUDA-core one in float32
    ("attention forward + lse", ("attention_relpos_kernel", "attention_relpos_tc_kernel")),
    ("attention bwd dq", ("bwd_dq_kernel", "bwd_dq_tc_kernel")),
    ("attention bwd dkv", ("bwd_dkv_kernel", "bwd_dkv_tc_kernel")),
    ("attention bwd dband (+ reduce)", ("bwd_dband_kernel", "bwd_dband_tc_kernel", "dband_reduce_kernel")),
    # every LSTM recurrence: the cluster route (lstm_fwd_cluster_kernel, both directions in one launch) and the
    # grid route past it (lstm_fwd_grid_kernel)
    ("lstm_fwd", ("lstm_fwd_",)),
    ("lstm_bwd", ("lstm_bwd_",)),
    ("lstm_dwhh (+ reduce)", ("lstm_dwhh_kernel", "lstm_dwhh_reduce_kernel")),
    ("ctc alpha + beta", ("ctc_alpha_kernel", "ctc_beta_kernel")),
    ("stft_logmel", ("stft_logmel_tc_kernel",)),
    # kernel 10: one kernel for the forward and dx, and dw's kernel with its tile-order reduce
    ("depthwise_conv", ("depthwise_conv_kernel",)),
    ("depthwise_conv dw (+ reduce)", ("depthwise_dw_kernel", "depthwise_dw_reduce_kernel")),
    ("convolutions (cuDNN)", ("conv", "cudnn", "wgrad", "dgrad")),
    ("GEMMs (cuBLAS)", ("gemm", "cutlass", "cublas", "xmma", "nvjet")),
)


def group_of(kernel_name: str) -> str:
    key = kernel_name.lower()
    return next((group for group, words in GROUPS if any(w in key for w in words)), REST)


def profile_main_path(batch: int, seconds: float, target_len: int, conv_impl: str = "auto",
                       predict: bool = False, preset: str = "conformer_m") -> None:
    """Profiles ``preset``'s bf16 train step at (batch, seconds,
    target_len), or with ``predict`` its pseudo-label pass at (batch,
    seconds)."""
    from torch.profiler import ProfilerActivity, profile

    from nn_conformer_for_speech_recognition_tpu_torch import config as C
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, OptimizerConfig, SpecAugmentConfig
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_predict_step, make_train_step
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState
    from nn_conformer_for_speech_recognition_tpu_torch.utils.profiling import kernel_groups, phase_table, reset_phases

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.build()
    gen = torch.Generator().manual_seed(SEED)
    model = init_params(ConformerCTC(getattr(C, preset)(use_pallas=True, conv_impl=conv_impl), VOCAB), gen).cuda()
    n_samples = int(seconds * FeatureConfig().sample_rate)
    freqs = 100.0 + 3000.0 * torch.rand(batch, 1, generator=gen)
    tones = torch.sin(2 * torch.pi * freqs * torch.arange(n_samples) / 16000.0)
    audio = (0.1 * tones + 0.05 * torch.randn(batch, n_samples, generator=gen)).cuda()
    audio_lengths = torch.full((batch,), n_samples, device="cuda")
    if predict:
        model.eval()
        predict_step = make_predict_step(model, FeatureConfig(), pad_id=0)
        call = lambda: predict_step(audio, audio_lengths)  # noqa: E731
        what = f"{preset} bf16 pseudo-label pass (conv_impl={conv_impl!r}), B={batch}, {seconds:.0f} s clips"
    else:
        state = TrainState.create(model, make_optimizer(OptimizerConfig(), model.named_parameters()), SEED)
        train_step = make_train_step(model, FeatureConfig(), SpecAugmentConfig(), blank_id=0)
        args = (audio, audio_lengths, torch.randint(3, VOCAB, (batch, target_len), generator=gen).cuda(),
                torch.full((batch,), target_len, device="cuda"))

        def call():
            nonlocal state
            state, _ = train_step(state, *args)

        what = (f"{preset} bf16 train step (conv_impl={conv_impl!r}), B={batch}, {seconds:.0f} s clips, {target_len} "
                "targets")

    def run(n: int) -> float:
        """Milliseconds per call over ``n`` calls, host clock around a synchronise."""
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            call()
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    run(2)  # warm-up
    plain_ms = run(5)
    reset_phases()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = run(PROFILED_STEPS)
    groups = kernel_groups(prof, PROFILED_STEPS)
    device_ms, launches = sum(g[0] for g in groups.values()), sum(g[1] for g in groups.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"{what}: {plain_ms:.2f} ms/call unprofiled over 5 calls, {profiled_ms:.2f} ms/call under the profiler over "
          f"{PROFILED_STEPS}; kernel device time {device_ms:.2f} ms/call in {launches:.0f} launches/call; busy share "
          f"{device_ms / plain_ms:.3f} of the unprofiled call, {device_ms / profiled_ms:.3f} under the profiler  [{card}]")
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {ms:.3f} ms/call ({ms / device_ms:.1%}), {count:.0f} launches/call")
    for name, (count, host_s, device_s) in phase_table().items():
        print(f"  span {name}: {count / PROFILED_STEPS:.0f}/call, host {host_s * 1e3 / PROFILED_STEPS:.3f} ms/call, "
              f"device {device_s * 1e3 / PROFILED_STEPS:.3f} ms/call")


if __name__ == "__main__":
    words = sys.argv[2:]
    if sys.argv[1:2] not in (["long"], ["short"], ["pass"]) or any(w not in ("pallas", "conformer_l") for w in words):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    shape = SHAPES["short" if sys.argv[1] == "pass" else sys.argv[1]]
    profile_main_path(*shape, conv_impl="pallas" if "pallas" in words else "auto", predict=sys.argv[1] == "pass",
                      preset="conformer_l" if "conformer_l" in words else "conformer_m")
