"""Where one bf16 train step spends the card's time, by kernel group.

    python -m nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step long    # B=4 × 120 s, 400 targets
    python -m nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step short   # B=16 × 30 s, 100 targets
    python -m nn_conformer_for_speech_recognition_tpu_torch.utils.profile_step short pallas   # conv_impl='pallas'

A second word ``pallas`` profiles the configuration whose depthwise conv is
the hand-written kernel (``conv_impl='pallas'``) instead of the grouped
conv1d.  Builds the hand-written kernels, warms Conformer-M's train step
(`train.loop.make_train_step`: log-mel, SpecAugment, forward, CTC,
backward, Adafactor; weights and audio from a seed) up over two steps,
times five steps unprofiled, then runs three under ``torch.profiler`` and
prints the device time per step by kernel group (first match of `GROUPS`
on the kernel's name; whatever matches none is elementwise work,
reductions and copies), the launches per step and the card's busy share.
Needs a CUDA device.
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
    ("attention forward + lse", ("attention_relpos_kernel",)),
    ("attention bwd dq", ("bwd_dq_kernel",)),
    ("attention bwd dkv", ("bwd_dkv_kernel",)),
    ("attention bwd dband (+ reduce)", ("bwd_dband_kernel", "dband_reduce_kernel")),
    ("lstm_fwd", ("lstm_fwd_kernel",)),
    ("lstm_bwd", ("lstm_bwd_kernel",)),
    ("lstm_dwhh", ("lstm_dwhh_kernel",)),
    ("ctc alpha + beta", ("ctc_alpha_kernel", "ctc_beta_kernel")),
    ("stft_logmel", ("stft_logmel_kernel",)),
    ("depthwise_conv", ("depthwise_conv_kernel",)),
    ("convolutions (cuDNN)", ("conv", "cudnn", "wgrad", "dgrad")),
    ("GEMMs (cuBLAS)", ("gemm", "cutlass", "cublas", "xmma", "nvjet")),
)


def group_of(kernel_name: str) -> str:
    key = kernel_name.lower()
    return next((group for group, words in GROUPS if any(w in key for w in words)), REST)


def profile_train_step(batch: int, seconds: float, target_len: int, conv_impl: str = "auto") -> None:
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile

    from nn_conformer_for_speech_recognition_tpu_torch.config import (
        FeatureConfig, OptimizerConfig, SpecAugmentConfig, conformer_m,
    )
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC, init_params
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build
    from nn_conformer_for_speech_recognition_tpu_torch.train.loop import make_train_step
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import make_optimizer
    from nn_conformer_for_speech_recognition_tpu_torch.train.state import TrainState

    card = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
                          capture_output=True, text=True, check=True).stdout.strip().splitlines()[0]
    build.build()
    gen = torch.Generator().manual_seed(SEED)
    model = init_params(ConformerCTC(conformer_m(use_pallas=True, conv_impl=conv_impl), VOCAB), gen).cuda()
    state = TrainState.create(model, make_optimizer(OptimizerConfig(), model.named_parameters()), SEED)
    step = make_train_step(model, FeatureConfig(), SpecAugmentConfig(), blank_id=0)
    n_samples = int(seconds * FeatureConfig().sample_rate)
    freqs = 100.0 + 3000.0 * torch.rand(batch, 1, generator=gen)
    tones = torch.sin(2 * torch.pi * freqs * torch.arange(n_samples) / 16000.0)
    audio = (0.1 * tones + 0.05 * torch.randn(batch, n_samples, generator=gen)).cuda()
    args = (audio, torch.full((batch,), n_samples, device="cuda"),
            torch.randint(3, VOCAB, (batch, target_len), generator=gen).cuda(),
            torch.full((batch,), target_len, device="cuda"))

    def run(n: int) -> float:
        """Milliseconds per step over ``n`` steps, host clock around a synchronise."""
        nonlocal state
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        for _ in range(n):
            state, _ = step(state, *args)
        torch.cuda.synchronize()
        return (time.perf_counter() - t0) / n * 1e3

    run(2)  # warm-up
    plain_ms = run(5)
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        profiled_ms = run(PROFILED_STEPS)
    groups = {name: [0.0, 0.0] for name in (*(g for g, _ in GROUPS), REST)}
    for event in prof.key_averages():
        if event.device_type == DeviceType.CUDA:  # kernel rows only: the op rows repeat their kernels' time
            entry = groups[group_of(event.key)]
            entry[0] += event.self_device_time_total / 1e3 / PROFILED_STEPS
            entry[1] += event.count / PROFILED_STEPS
    device_ms, launches = sum(g[0] for g in groups.values()), sum(g[1] for g in groups.values())
    if device_ms <= 0:
        raise RuntimeError("the profiler recorded no device time")
    print(f"bf16 train step (conv_impl={conv_impl!r}), B={batch}, {seconds:.0f} s clips, {target_len} targets: {plain_ms:.2f} ms/step unprofiled "
          f"over 5 steps, {profiled_ms:.2f} ms/step under the profiler over {PROFILED_STEPS}; kernel device time "
          f"{device_ms:.2f} ms/step in {launches:.0f} launches/step; busy share {device_ms / plain_ms:.3f} of the "
          f"unprofiled step, {device_ms / profiled_ms:.3f} under the profiler  [{card}]")
    for name, (ms, count) in sorted(groups.items(), key=lambda kv: -kv[1][0]):
        print(f"  {name}: {ms:.3f} ms/step ({ms / device_ms:.1%}), {count:.0f} launches/step")


if __name__ == "__main__":
    if sys.argv[1:2] not in (["long"], ["short"]) or sys.argv[2:] not in ([], ["pallas"]):
        raise SystemExit(__doc__)
    if not torch.cuda.is_available():
        raise SystemExit("profile_step: no CUDA device")
    profile_train_step(*SHAPES[sys.argv[1]], conv_impl="pallas" if sys.argv[2:] else "auto")
