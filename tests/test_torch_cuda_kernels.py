"""The port's hand-written CUDA kernels vs their plain PyTorch twins.

Needs a CUDA device and nvcc; each test skips without a device.  This file
imports no jax, so on a machine without it run it without the repo's
conftest:  python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: float32 log-mel 1e-3 (log of sums of 512-term products taken
in another order; the kernel's 3×TF32 products also within twice the twin's
error against float64, and bit-equal from launch to launch), float32 attention 1e-4 and bfloat16 attention 2e-2 (one
bf16 rounding of the output and of the probabilities), and the bfloat16
tensor-core forward also one bf16 ulp at the twin's largest entry, the
attention lse and backward (dqu, dqv, dk, dv, dp) 5e-4 in float32, the bar
the JAX package holds its Pallas backward to, and in bfloat16 one bf16 ulp
at the reference's largest entry (2^-7 of it; the sums are float32 and
rounded once; the tensor-core kernels also round P and ds to bf16 once
before their products, and a band one row off misses that bar), LSTM
forward, its
saved c and gates, and the backward's dxw 1e-4 (235 or 938 float32 steps), dW_hh
1e-4 of its largest entry (a sum over B·T rows; the kernel's 3×TF32
products keep float32's accuracy, one-pass TF32 would not), and bit-equal
from launch to launch; CTC: alpha within
1e-5 of its magnitude plus 1e-3 (log-space sums of up to 938 frames),
ll within 1e-5 relative, demit 5e-4 (posteriors exp(α + β − ll) formed
from log-space values of ~1.5e3, where one float32 ulp is 1.2e-4), and
against torch's own CTC the loss 1e-5 relative and the logit gradient
1e-3.  The depthwise conv: float32 1e-5 on unit-variance inputs and taps
of variance 1/K (33 float32 multiply-adds in the twin's order, fused here),
bfloat16 one bf16 ulp at the reference's largest entry (both sum in float32
and round once); dw against its twin (the same tile order) 1e-5 of its
largest entry and through the Function 1e-4 of it (a float32 sum over B·T
rows), bit-equal from launch to launch.  The bias-input attention: against its twin on
every query row 1e-4 in float32 and in bfloat16 one bf16 ulp at the
reference's largest entry, on a bias wide enough that a kernel which
ignores it misses that bar fourfold; its gradients (plain
einsums behind the kernel's forward) 5e-4 against autograd through the twin;
the beam search on the card against its own CPU run: tokens and lengths
equal, scores 1e-3 (60 float32 logaddexp steps in two libraries).
"""

import pytest
import torch

from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig
from nn_conformer_for_speech_recognition_tpu_torch.ops import ctc as TC
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import attention as A
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import ctc as K
from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import depthwise_conv as D
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
    "kw, samples",
    [
        ({}, 480000), ({}, 12345), (dict(n_fft=400, hop_length=160), 16001),
        ({}, 1920000),  # 11,253 frames: the 64-frame tile
        ({}, 960000),  # 5,628 frames: too few for a 64-frame block on each of 132 SMs, the 32-frame tile
        ({}, 257),  # one frame, reflected at both ends
        ({}, 40000),  # 79 frames a row: the 16-frame tiles of a short batch straddle rows, the last ragged
        (dict(win_length=400), 16000),  # the window zero-padded to n_fft
        (dict(htk=True, n_mels=80), 16000),
        (dict(n_fft=1024, hop_length=256, n_mels=128), 400000),  # the 32-frame tile past n_fft = 512
        (dict(n_fft=401, hop_length=100), 8001),  # odd n_fft: no Nyquist bin, unaligned frames
        (dict(n_mels=160), 16000),  # a second block of mels (grid.y), 32 of them
        (dict(n_fft=2048, hop_length=512, n_mels=256), 48000),  # the 16-frame tile past 1024, two mel blocks
        (dict(n_fft=4096, hop_length=1024, n_mels=128), 48000),  # the 8-frame tile past 2305, 64-row stages
        (dict(n_fft=5889, hop_length=1500), 20000),  # the longest frame it takes, odd
    ],
)
def test_stft_logmel_kernel(cuda, kw, samples):
    cfg = FeatureConfig(**kw)
    audio = (torch.randn(3, samples, generator=cuda) * 0.1).cuda()
    before = S.stft_logmel.launches
    got = S.stft_logmel(audio, cfg)
    assert S.stft_logmel.launches == before + 1
    _close(got, S.stft_logmel_plain(audio, cfg), 1e-3)


def test_stft_logmel_silence_and_quiet_rows(cuda):
    """A row of zeros gives log_floor exactly (every split of 0 is 0), as
    the twin does; a row at 1e-3 amplitude beside rows at 0.1 agrees with the
    twin as they do."""
    cfg = FeatureConfig()
    audio = torch.randn(4, 48000, generator=cuda) * 0.1
    audio[1] = 0.0
    audio[2] *= 1e-2
    audio = audio.cuda()
    got, ref = S.stft_logmel(audio, cfg), S.stft_logmel_plain(audio, cfg)
    floor = torch.log(torch.tensor(cfg.log_floor, device="cuda"))
    assert torch.equal(got[1], torch.full_like(got[1], floor.item())) and torch.equal(got[1], ref[1])
    _close(got[2], ref[2], 1e-3)
    _close(got, ref, 1e-3)


def test_stft_logmel_carries_a_nan_as_the_twin_does(cuda):
    """A NaN sample makes the frames that read it NaN in every mel, as in
    the twin and the JAX package (``jnp.maximum`` keeps a NaN); the other
    frames and rows agree as usual."""
    cfg = FeatureConfig()
    audio = torch.randn(2, 16000, generator=cuda) * 0.1
    audio[0, 8000] = float("nan")
    audio = audio.cuda()
    got, ref = S.stft_logmel(audio, cfg), S.stft_logmel_plain(audio, cfg)
    nan = torch.isnan(ref)
    assert nan[0].any() and torch.equal(torch.isnan(got), nan)
    _close(got[~nan], ref[~nan], 1e-3)


def test_stft_logmel_kernel_is_as_close_to_float64_as_the_twin(cuda):
    """Against the same function in float64, the 3×TF32 kernel's largest
    error is at most twice the float32 twin's (one TF32 pass would be ~100×)."""
    cfg = FeatureConfig()
    audio = (torch.randn(4, 160000, generator=cuda) * 0.1).cuda()
    ref = S.stft_logmel_float64(audio, cfg)
    kernel = (S.stft_logmel(audio, cfg).double() - ref).abs().max().item()
    twin = (S.stft_logmel_plain(audio, cfg).double() - ref).abs().max().item()
    assert kernel <= 2 * twin, (kernel, twin)


def test_stft_logmel_kernel_is_bit_equal_from_launch_to_launch(cuda):
    cfg = FeatureConfig()
    audio = (torch.randn(3, 100000, generator=cuda) * 0.1).cuda()
    assert torch.equal(S.stft_logmel(audio, cfg), S.stft_logmel(audio, cfg))


def test_stft_logmel_rows_are_bit_equal_whatever_tile_the_batch_takes(cuda):
    """Every tile sums a frame's products and mels in the same order, so a
    row's log-mel does not depend on the batch around it: 16 rows of 30 s
    take the 64-frame tile, 5 the 32-frame one, 1 the 16-frame one."""
    cfg = FeatureConfig()
    audio = (torch.randn(16, 480000, generator=cuda) * 0.1).cuda()
    full = S.stft_logmel(audio, cfg)
    for rows in (5, 1):
        assert torch.equal(S.stft_logmel(audio[:rows], cfg), full[:rows]), rows


@pytest.mark.parametrize(
    "n_fft, frames", [(512, 15008), (512, 4690), (512, 896), (1024, 4689), (2048, 282), (4096, 141), (5889, 42)]
)
def test_stft_logmel_plan(cuda, n_fft, frames):
    """No spill, at least one block an SM, and the tile the launch rule picks:
    the largest whose rows fit (64 frames up to n_fft 513, 32 up to 1031)
    and that gives every SM a block, else 16 (up to 2305), else 8."""
    plan = S.stft_logmel_tc_plan(n_fft, frames)
    sms = torch.cuda.get_device_properties(0).multi_processor_count
    fits = [f for f, most in ((64, 513), (32, 1031)) if n_fft <= most and -(-frames // f) >= sms]
    assert plan["local_bytes"] == 0 and plan["blocks_per_sm"] >= 1, plan
    assert plan["frames_per_block"] == (fits[0] if fits else 16 if n_fft <= 2305 else 8), plan


def test_stft_logmel_rejects_what_the_kernel_does_not_take(cuda):
    with pytest.raises(ValueError):
        S.stft_logmel(torch.zeros(2, 8000, device="cuda"), FeatureConfig(n_fft=5890, hop_length=1024))
    with pytest.raises(ValueError):
        S.stft_logmel(torch.zeros(2, 256, device="cuda"), FeatureConfig())


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
    with pytest.raises(ValueError, match="states exceed"):  # L = 512 labels: S = 1025 > 1024 threads
        K.ctc_alpha(torch.zeros(1, 3, 1025, device="cuda"), torch.zeros(1, 1025, dtype=torch.bool, device="cuda"),
                    torch.tensor([1025], device="cuda"), torch.tensor([3], device="cuda"))


def _attention_case(gen, dtype, b, t, h, dh, lengths):
    qu, qv, k, v, g = ((torch.randn(b, t, h, dh, generator=gen) * 0.5).cuda().to(dtype) for _ in range(5))
    p = (torch.randn(2 * t - 1, h, dh, generator=gen) * 0.5).cuda().to(dtype)
    return (qu, qv, k, v, p, torch.tensor(lengths, dtype=torch.int32).cuda(), dh ** -0.5), g


def test_attention_gradients_reach_every_input(cuda):
    """The kernel path differentiates: gradients in qu, qv, k, v and p equal
    autograd's through the plain attention, through one launch of each of
    the four training kernels and none of the inference forward."""
    args, r = _attention_case(cuda, torch.float32, 2, 70, 2, 32, [70, 41])
    wrappers = (A.flash_relpos_attention, A.flash_relpos_attention_forward_lse, A.flash_relpos_attention_bwd_dq,
                A.flash_relpos_attention_bwd_dkv, A.flash_relpos_attention_bwd_dband)
    grads = []
    for fn in (A.flash_relpos_attention, A.flash_relpos_attention_plain):
        leaves = [x.clone().requires_grad_(True) for x in args[:5]]
        before = [w.launches for w in wrappers]
        (fn(*leaves, *args[5:]) * r).sum().backward()
        grads.append(([x.grad for x in leaves], [w.launches - n for w, n in zip(wrappers, before)]))
    (got, counts), (ref, _) = grads
    assert counts == [0, 1, 1, 1, 1]
    for g, r in zip(got, ref):
        _close(g, r, 5e-4)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b, t, h, dh, lengths",
    [(1, 1, 1, 64, [1]), (3, 33, 2, 32, [33, 16, 30]), (4, 235, 4, 64, [235, 117, 20, 234]),
     (2, 70, 2, 128, [70, 5]), (3, 40, 2, 16, [40, 0, 37]), (2, 938, 4, 64, [938, 300])],
)
@pytest.mark.parametrize("kernel", ["lse", "dq", "dkv", "dband"])
def test_attention_backward_kernels(cuda, kernel, b, t, h, dh, lengths, dtype):
    """The lse forward and the three backward kernels against their plain
    twins, from the twin's saved output and lse (float32 dq and dband: the
    CUDA-core kernels; bfloat16: the tensor-core ones).  A bfloat16 gradient is
    held to one bf16 ulp at its reference's largest entry (and no tighter
    than the float32 bar, for a reference that is all but zero)."""
    args, g = _attention_case(cuda, dtype, b, t, h, dh, lengths)
    out, lse = A.flash_relpos_attention_plain(*args, return_lse=True)
    if kernel == "lse":
        before = A.flash_relpos_attention_forward_lse.launches
        got_out, got_lse = A.flash_relpos_attention_forward_lse(*args)
        assert A.flash_relpos_attention_forward_lse.launches == before + 1
        assert got_lse.shape == (b, h, t) and got_lse.dtype == torch.float32 and got_out.dtype == dtype
        _close(got_out, out, 2e-2 if dtype == torch.bfloat16 else 1e-4)
        rows = torch.tensor(lengths).cuda() > 0  # a row without a valid key has lse ≈ -1e30 on both sides
        _close(got_lse[rows], lse[rows], 5e-4)
        return
    ref = A.flash_relpos_attention_backward_plain(*args, out, lse, g)
    call = (*args, lse, A.attention_delta(out, g), g)
    if kernel == "dq":
        got, want = A.flash_relpos_attention_bwd_dq(*call), ref[0:2]
    elif kernel == "dkv":
        got, want = A.flash_relpos_attention_bwd_dkv(*call), ref[2:4]
    else:
        got, want = (A.flash_relpos_attention_bwd_dband(*call),), ref[4:5]
        again = A.flash_relpos_attention_bwd_dband(*call)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again)  # the batch sum is ordered: bit-equal from run to run
    for x, r in zip(got, want):
        assert x.dtype == dtype and x.shape == r.shape
        _close(x, r, max(2.0 ** -7 * r.abs().max().item(), 5e-4) if dtype == torch.bfloat16 else 5e-4)


def _bf16_bar(ref):
    return max(2.0 ** -7 * ref.abs().max().item(), 5e-4)


def _edge_lengths(t):
    """A full row, a row at a 64-row tile edge (half the row below one
    tile), a row with no valid key, a row shorter than one tile."""
    return [t, (t // 64) * 64 or max(t // 2, 1), 0, min(5, t)]


@pytest.mark.parametrize("t", [14, 28, 63, 64, 65, 235, 938])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("kernel", ["dq", "dband"])
def test_attention_backward_tensor_core_kernels(cuda, kernel, dh, t):
    """bfloat16 dq and dband (the tensor-core kernels, one launch each)
    against their twins at every compiled head width, across the 64-row
    tile edges, within `_bf16_bar`; dband bit-equal from launch to launch."""
    lengths = _edge_lengths(t)
    args, g = _attention_case(cuda, torch.bfloat16, len(lengths), t, 2, dh, lengths)
    out, lse = A.flash_relpos_attention_plain(*args, return_lse=True)
    ref = A.flash_relpos_attention_backward_plain(*args, out, lse, g)
    call = (*args, lse, A.attention_delta(out, g), g)
    wrapper = A.flash_relpos_attention_bwd_dq if kernel == "dq" else A.flash_relpos_attention_bwd_dband
    before = wrapper.launches
    got = wrapper(*call)
    assert wrapper.launches == before + 1
    if kernel == "dq":
        want = ref[0:2]
    else:
        got, want = (got,), ref[4:5]
        again = A.flash_relpos_attention_bwd_dband(*call)
        torch.cuda.synchronize()
        assert torch.equal(got[0], again)
    for x, r in zip(got, want):
        assert x.dtype == torch.bfloat16 and x.shape == r.shape
        assert bool(torch.isfinite(x).all())
        _close(x, r, _bf16_bar(r))


@pytest.mark.parametrize("t", [63, 235, 938])
def test_attention_backward_bar_sees_a_one_row_shift(cuda, t):
    """The control: the twin on a band shifted by one row (the skew and
    unskew off by one) misses `_bf16_bar` in dqv and dp, where the kernels
    meet it."""
    lengths = _edge_lengths(t)
    args, g = _attention_case(cuda, torch.bfloat16, len(lengths), t, 2, 64, lengths)
    out, lse = A.flash_relpos_attention_plain(*args, return_lse=True)
    ref = A.flash_relpos_attention_backward_plain(*args, out, lse, g)
    p = args[4]
    shifted_p = torch.cat([p[1:], torch.zeros_like(p[:1])])
    shifted = A.flash_relpos_attention_backward_plain(*args[:4], shifted_p, *args[5:], out, lse, g)
    call = (*args, lse, A.attention_delta(out, g), g)
    got = (A.flash_relpos_attention_bwd_dq(*call)[1], A.flash_relpos_attention_bwd_dband(*call))
    torch.cuda.synchronize()
    for x, miss, r in zip(got, (shifted[1], shifted[4]), (ref[1], ref[4])):
        bar = _bf16_bar(r)
        assert (x.float() - r.float()).abs().max().item() <= bar
        assert (miss.float() - r.float()).abs().max().item() > bar


@pytest.mark.parametrize("kernel", A.TC_KERNELS)
def test_attention_backward_tensor_core_plan(cuda, kernel):
    """At dh = 64 the tensor-core kernels (the forward without and with lse,
    dq, dkv, dband) spill nothing and two blocks share an SM; every head
    width opts in to its shared memory."""
    plans = {dh: A.relpos_tc_plan(kernel, dh) for dh in A.HEAD_DIMS}
    assert plans[64]["local_bytes"] == 0 and plans[64]["blocks_per_sm"] >= 2, plans[64]
    assert all(plan["blocks_per_sm"] >= 1 for plan in plans.values()), plans


@pytest.mark.parametrize("t", [1, 14, 28, 63, 64, 65, 235, 938])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
@pytest.mark.parametrize("with_lse", [False, True])
def test_attention_forward_tensor_core_kernel(cuda, with_lse, dh, t):
    """bfloat16 forward (the tensor-core kernel, one launch), without and
    with lse, against its twin at every compiled head width, across the
    64-row tile edges, with a row of length 0 (the mean of v over every
    key, on both sides): the output within `_bf16_bar` (never below the
    float32 forward bar 1e-4), lse within 5e-4 on rows with a valid key and
    within 1e-6 of its size (~-1e30) on the others; bit-equal from launch
    to launch."""
    lengths = _edge_lengths(t)
    args, _ = _attention_case(cuda, torch.bfloat16, len(lengths), t, 2, dh, lengths)
    ref, ref_lse = A.flash_relpos_attention_plain(*args, return_lse=True)
    wrapper = A.flash_relpos_attention_forward_lse if with_lse else A.flash_relpos_attention
    before = wrapper.launches
    got = wrapper(*args)
    again = wrapper(*args)
    assert wrapper.launches == before + 2
    out, lse = got if with_lse else (got, None)
    torch.cuda.synchronize()
    assert out.dtype == torch.bfloat16 and out.shape == ref.shape and bool(torch.isfinite(out).all())
    assert torch.equal(out, again[0] if with_lse else again)
    _close(out, ref, max(2.0 ** -7 * ref.abs().max().item(), 1e-4))
    if with_lse:
        assert lse.dtype == torch.float32 and lse.shape == ref_lse.shape and torch.equal(lse, again[1])
        rows = torch.tensor(lengths).cuda() > 0
        _close(lse[rows], ref_lse[rows], 5e-4)
        torch.testing.assert_close(lse[~rows], ref_lse[~rows], rtol=1e-6, atol=0)


@pytest.mark.parametrize("t", [1, 14, 28, 63, 64, 65, 235, 938])
@pytest.mark.parametrize("dh", [16, 32, 64, 128])
def test_attention_dkv_tensor_core_kernel(cuda, dh, t):
    """bfloat16 dk and dv (the tensor-core dkv kernel, one launch) against
    their twins at every compiled head width, across the 64-row tile edges,
    with a row of length 0 (zeros on both sides), within `_bf16_bar`;
    bit-equal from launch to launch."""
    lengths = _edge_lengths(t)
    args, g = _attention_case(cuda, torch.bfloat16, len(lengths), t, 2, dh, lengths)
    out, lse = A.flash_relpos_attention_plain(*args, return_lse=True)
    ref = A.flash_relpos_attention_backward_plain(*args, out, lse, g)
    call = (*args, lse, A.attention_delta(out, g), g)
    before = A.flash_relpos_attention_bwd_dkv.launches
    got = A.flash_relpos_attention_bwd_dkv(*call)
    again = A.flash_relpos_attention_bwd_dkv(*call)
    assert A.flash_relpos_attention_bwd_dkv.launches == before + 2
    torch.cuda.synchronize()
    for x, y, r in zip(got, again, ref[2:4]):
        assert x.dtype == torch.bfloat16 and x.shape == r.shape and bool(torch.isfinite(x).all())
        assert torch.equal(x, y)
        _close(x, r, _bf16_bar(r))


# the cluster route's forward and backward, dW_hh, then the grid route's forward and backward
LSTM_COUNTERS = (L.lstm_forward_cluster, L.lstm_backward_cluster, L.lstm_weight_grad, L.lstm_forward_grid,
                 L.lstm_backward_grid)


def _lstm_case(gen, hidden, reverse, t=235):
    b = 4
    xw = torch.randn(b, t, 4 * hidden, generator=gen).cuda()
    w_hh = (torch.randn(hidden, 4 * hidden, generator=gen) * hidden ** -0.5).cuda()
    lengths = torch.tensor([t, 100, 1, t - 1], dtype=torch.int32).cuda()
    return xw, w_hh, lengths


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden, t", [(320, 235), (100, 235), (320, 938)])
def test_lstm_training_forward_kernel(cuda, reverse, hidden, t):
    xw, w_hh, lengths = _lstm_case(cuda, hidden, reverse, t)
    got = L.lstm_forward(xw, w_hh, lengths, reverse=reverse, save=True)
    ref = L.lstm_forward_plain(xw, w_hh, lengths, reverse)
    for g, r in zip(got, ref):
        _close(g, r, 1e-4)
    assert L.lstm_forward(xw, w_hh, lengths, reverse=reverse)[1:] == (None, None)


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden, t", [(320, 235), (100, 235), (37, 235), (320, 938)])
def test_lstm_backward_kernels(cuda, reverse, hidden, t):
    xw, w_hh, lengths = _lstm_case(cuda, hidden, reverse, t)
    h, c, gates = L.lstm_forward_plain(xw, w_hh, lengths, reverse)
    gout = torch.randn(h.shape, generator=cuda).cuda()
    dxw = L.lstm_backward(gout, gates, c, w_hh, lengths, reverse=reverse)
    _close(dxw, L.lstm_backward_plain(gout, gates, c, w_hh, lengths, reverse), 1e-4)
    ref = L.lstm_weight_grad_plain(h, dxw, reverse)
    _close(L.lstm_weight_grad(h, dxw, reverse=reverse), ref, 1e-4 * ref.abs().max().item())


@pytest.mark.parametrize("reverse", [False, True])
@pytest.mark.parametrize("hidden", [37, 100, 160, 320, 640])
@pytest.mark.parametrize("b, t", [(16, 14), (16, 235), (4, 938), (3, 347)])
def test_lstm_weight_grad_kernel(cuda, b, t, hidden, reverse):
    """dW_hh on the tensor cores (3×TF32, split over the B·T rows) against
    the float32 einsum: 1e-4 of its largest entry, at the NST bucket's 224
    rows, the 30 s step's 3,760, the 120 s step's 3,752 and 1,041 rows (a
    multiple of neither the 32-row slab nor the slice count); H = 37 and 100
    take the edge of a tile (37: 4-byte copies of h).  Two launches on the
    same inputs are bit-equal: the slices are summed in order, no atomics."""
    h = torch.randn(b, t, hidden, generator=cuda).cuda()
    dxw = torch.randn(b, t, 4 * hidden, generator=cuda).cuda()
    before = L.lstm_weight_grad.launches
    got = L.lstm_weight_grad(h, dxw, reverse=reverse)
    again = L.lstm_weight_grad(h, dxw, reverse=reverse)
    assert L.lstm_weight_grad.launches == before + 2
    ref = L.lstm_weight_grad_plain(h, dxw, reverse)
    assert got.shape == (hidden, 4 * hidden) and got.dtype == torch.float32
    _close(got, ref, 1e-4 * ref.abs().max().item())
    assert torch.equal(got, again)


@pytest.mark.parametrize("rows, hidden, want", [
    (3760, 320, (6, 640)),  # the 30 s step, B=16 × T'=235: 50 tiles × 6 slices, 300 blocks
    (3752, 320, (6, 640)),  # the 120 s step, B=4 × T'=938
    (224, 320, (4, 64)),  # the NST phase's short bucket, B=16 × T'=14: as many slices as 64-row slices hold
    (940, 37, (15, 64)),  # 2 tiles: the 16-slice cap, rounded to whole slabs
    (3760, 1024, (1, 3776)),  # 512 tiles fill the card alone: no partials, no second kernel
    (1, 320, (1, 32)),
])
def test_lstm_dwhh_plan_covers_the_rows_in_whole_slabs(cuda, rows, hidden, want):
    """The dW_hh kernel's split over the B·T rows, as the CUDA source picks
    it for 132 SMs: whole 32-row slabs, every row in one slice, no empty
    slice, at most 16 slices, and as many as two waves of the SMs ask for
    where the rows allow."""
    slices, per = L.dwhh_plan(rows, hidden, 132)
    assert per % 32 == 0 and (slices - 1) * per < rows <= slices * per
    assert 1 <= slices <= 16
    assert (slices, per) == want


@pytest.mark.parametrize("reverse", [False, True])
def test_lstm_gradients_reach_xw_and_w_hh(cuda, reverse):
    """The kernel path differentiates: gradients in xw and w_hh equal those
    of autograd through the plain loop, through one launch of each kernel."""
    xw, w_hh, lengths = _lstm_case(cuda, 320, reverse)
    r = torch.randn(4, 235, 320, generator=cuda).cuda()
    grads = []
    for fn in (L.lstm, lambda *a, reverse: L.lstm_plain(*a, reverse)):
        x, w = xw.clone().requires_grad_(True), w_hh.clone().requires_grad_(True)
        before = [k.launches for k in LSTM_COUNTERS]
        (fn(x, w, lengths, reverse=reverse) * r).sum().backward()
        after = [k.launches for k in LSTM_COUNTERS]
        grads.append((x.grad, w.grad, [a - b for a, b in zip(after, before)]))
    (dx, dw, counts), (dx_ref, dw_ref, _) = grads
    assert counts == [1, 1, 1, 0, 0]
    _close(dx, dx_ref, 1e-4)
    _close(dw, dw_ref, 1e-4 * dw_ref.abs().max().item())



def _bilstm_case(gen, b, t, hidden):
    """Both directions' xw and w_hh, and lengths that hold T, 1, 0 and
    T//2+1 (as far as B allows; 0 and 1 clipped to T), then random ones."""
    xws = [torch.randn(b, t, 4 * hidden, generator=gen).cuda() for _ in range(2)]
    w_hhs = [(torch.randn(hidden, 4 * hidden, generator=gen) * hidden ** -0.5).cuda() for _ in range(2)]
    pattern = [t, 1, 0, t // 2 + 1]
    lengths = torch.randint(0, t + 1, (b,), generator=gen)
    lengths[:4] = torch.tensor(pattern[: min(b, 4)])
    return xws, w_hhs, lengths.to(torch.int32).cuda()


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("t", [1, 14, 235, 938])
@pytest.mark.parametrize("b", [1, 4, 16, 17, 33])
@pytest.mark.parametrize("hidden", [13, 16, 160, 320])
def test_lstm_cluster_forward_kernel(cuda, hidden, b, t, save):
    """The cluster forward, both template variants, against the twin for
    each direction: one launch for both directions, and each direction
    alone, bit-equal to it.  H = 13 does not divide by the 16 CTAs (the
    last ones own no unit); B = 17 and 33 take a second and third 16-row
    tile (the third of one row); H = 160 is the pretraining decoder's."""
    xws, w_hhs, lengths = _bilstm_case(cuda, b, t, hidden)
    before = L.lstm_forward_cluster.launches
    both = L.lstm_forward_directions(xws, w_hhs, lengths, (False, True), save=save)
    alone = [L.lstm_forward(xw, w, lengths, reverse=r, save=save) for xw, w, r in zip(xws, w_hhs, (False, True))]
    assert L.lstm_forward_cluster.launches == before + 3
    for xw, w, reverse, got, one in zip(xws, w_hhs, (False, True), both, alone):
        ref = L.lstm_forward_plain(xw, w, lengths, reverse)
        assert (got[1] is None) == (got[2] is None) == (not save)
        for g, o, r in zip(got, one, ref):
            if g is not None:
                _close(g, r, 1e-4)
                assert torch.equal(g, o)


@pytest.mark.parametrize("t", [1, 14, 235, 938])
@pytest.mark.parametrize("b", [1, 4, 16, 17, 33])
@pytest.mark.parametrize("hidden", [13, 16, 160, 320])
def test_lstm_cluster_backward_kernel(cuda, hidden, b, t):
    """The cluster BPTT against the twin for each direction, from the
    twin's saved gates and c: one launch for both directions, each
    direction alone bit-equal to it, and a second launch bit-equal to the
    first (the 16 partials of a unit are added in rank order, no atomics)."""
    xws, w_hhs, lengths = _bilstm_case(cuda, b, t, hidden)
    saved = [L.lstm_forward_plain(xw, w, lengths, r) for xw, w, r in zip(xws, w_hhs, (False, True))]
    gouts = [torch.randn(b, t, hidden, generator=cuda).cuda() for _ in range(2)]
    gates, cs = [s[2] for s in saved], [s[1] for s in saved]
    before = L.lstm_backward_cluster.launches
    both = L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, (False, True))
    again = L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, (False, True))
    alone = [L.lstm_backward(*args, lengths, reverse=r) for *args, r in zip(gouts, gates, cs, w_hhs, (False, True))]
    assert L.lstm_backward_cluster.launches == before + 4
    for i, reverse in enumerate((False, True)):
        _close(both[i], L.lstm_backward_plain(gouts[i], gates[i], cs[i], w_hhs[i], lengths, reverse), 1e-4)
        assert torch.equal(both[i], again[i]) and torch.equal(both[i], alone[i])


@pytest.mark.parametrize("b, t", [(16, 14), (16, 28), (16, 235)])
def test_pretrain_decoder_trains_through_the_cluster_kernels(cuda, b, t):
    """The pretraining model's decoder, `BiLSTM` from Conformer-M's width
    256 to H = 160 (``PretrainConfig().target_dim // 2``), at the pretrain
    step's and the pretrain command's shapes: its output and the gradients
    of every parameter and of x equal those of the plain loop's autograd,
    through one cluster forward, one cluster backward and two dW_hh launches
    (the grid route takes none)."""
    from nn_conformer_for_speech_recognition_tpu_torch.config import PretrainConfig
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import BiLSTM, init_params

    hidden = PretrainConfig().target_dim // 2
    assert L.route(b, hidden, torch.device("cuda"))[0] == "cluster"
    lstm = init_params(BiLSTM(256, hidden), torch.Generator().manual_seed(0)).cuda()
    x = torch.randn(b, t, 256, generator=cuda).cuda()
    lengths = torch.randint(1, t + 1, (b,), generator=cuda).to(torch.int32).cuda()
    lengths[0] = t
    r = torch.randn(b, t, 2 * hidden, generator=cuda).cuda()
    runs = []
    for use_kernel in (True, False):
        lstm.use_kernel = use_kernel
        lstm.zero_grad(set_to_none=True)
        leaf = x.clone().requires_grad_(True)
        before = [k.launches for k in LSTM_COUNTERS]
        out = lstm(leaf, lengths)
        valid = (torch.arange(t, device="cuda")[None, :] < lengths[:, None])[..., None]
        (out * r * valid).sum().backward()
        runs.append((out.detach() * valid, [leaf.grad] + [p.grad for p in lstm.parameters()],
                     [k.launches - n for k, n in zip(LSTM_COUNTERS, before)]))
    (out, grads, counts), (out_ref, grads_ref, counts_ref) = runs
    assert counts == [1, 1, 2, 0, 0] and counts_ref == [0, 0, 0, 0, 0]
    _close(out, out_ref, 1e-4)
    for g, ref in zip(grads, grads_ref):
        _close(g, ref, 1e-4 * max(1.0, ref.abs().max().item()))


def test_lstm_two_directions_differentiate_in_one_launch_each(cuda):
    """`lstm_directions` with autograd: h and the gradients in xw and w_hh of
    both directions equal those of autograd through the plain loop, through
    one cluster forward, one cluster backward and two dW_hh launches."""
    xws, w_hhs, lengths = _bilstm_case(cuda, 16, 235, 320)
    rs = [torch.randn(16, 235, 320, generator=cuda).cuda() for _ in range(2)]
    runs = []
    for fn in (L.lstm_directions, lambda x, w, n, rev: [L.lstm_plain(*a, n, r) for *a, r in zip(x, w, rev)]):
        leaves = [t.clone().requires_grad_(True) for t in (*xws, *w_hhs)]
        before = [k.launches for k in LSTM_COUNTERS]
        hs = fn(leaves[:2], leaves[2:], lengths, (False, True))
        sum((h * r).sum() for h, r in zip(hs, rs)).backward()
        runs.append(([h.detach() for h in hs], [x.grad for x in leaves],
                     [k.launches - n for k, n in zip(LSTM_COUNTERS, before)]))
    (hs, grads, counts), (hs_ref, grads_ref, _) = runs
    assert counts == [1, 1, 2, 0, 0]
    for h, ref in zip(hs, hs_ref):
        _close(h, ref, 1e-4)
    for g, ref in zip(grads, grads_ref):
        _close(g, ref, 1e-4 * max(1.0, ref.abs().max().item()))


def _counts(before):
    return [k.launches - n for k, n in zip(LSTM_COUNTERS, before)]


@pytest.mark.parametrize("save", [False, True])
@pytest.mark.parametrize("b", [1, 4, 16, 17, 33])
@pytest.mark.parametrize("hidden", [386, 513, 640, 1024])
def test_lstm_grid_forward_kernel(cuda, hidden, b, save):
    """The grid forward (H past the cluster's shared memory), both template
    variants, against the twin for each direction (1e-4): the directions in
    one cooperative launch where `grid_plan` places both (one a launch at H
    = 1024), each direction alone and a second launch bit-equal to it.  B =
    17 and 33 run a second and third tile in the same launch (the third of
    one row); lengths hold T, 1 and 0."""
    t = 47
    xws, w_hhs, lengths = _bilstm_case(cuda, b, t, hidden)
    plan = L.grid_plan(b, hidden, torch.cuda.get_device_properties(0).multi_processor_count, L.smem_optin(0))
    before = [k.launches for k in LSTM_COUNTERS]
    both = L.lstm_forward_directions(xws, w_hhs, lengths, (False, True), save=save)
    again = L.lstm_forward_directions(xws, w_hhs, lengths, (False, True), save=save)
    alone = [L.lstm_forward(xw, w, lengths, reverse=r, save=save) for xw, w, r in zip(xws, w_hhs, (False, True))]
    assert _counts(before) == [0, 0, 0, 2 * (2 // plan["directions"]) + 2, 0]
    for xw, w, reverse, got, twice, one in zip(xws, w_hhs, (False, True), both, again, alone):
        ref = L.lstm_forward_plain(xw, w, lengths, reverse)
        assert (got[1] is None) == (got[2] is None) == (not save)
        for g, g2, o, r in zip(got, twice, one, ref):
            if g is not None:
                _close(g, r, 1e-4)
                assert torch.equal(g, g2) and torch.equal(g, o)


@pytest.mark.parametrize("b", [1, 4, 16, 17, 33])
@pytest.mark.parametrize("hidden", [386, 513, 640, 1024])
def test_lstm_grid_backward_kernel(cuda, hidden, b):
    """The grid BPTT against the twin for each direction (1e-4, the bar of
    `TOL['lstm_backward']`), from the twin's saved gates and c: a second
    launch bit-equal to the first (each unit's partials are added in rank
    order, no atomics), and each direction alone bit-equal to the launch of
    both."""
    t = 47
    xws, w_hhs, lengths = _bilstm_case(cuda, b, t, hidden)
    saved = [L.lstm_forward_plain(xw, w, lengths, r) for xw, w, r in zip(xws, w_hhs, (False, True))]
    gouts = [torch.randn(b, t, hidden, generator=cuda).cuda() for _ in range(2)]
    gates, cs = [s[2] for s in saved], [s[1] for s in saved]
    plan = L.grid_plan(b, hidden, torch.cuda.get_device_properties(0).multi_processor_count, L.smem_optin(0))
    before = [k.launches for k in LSTM_COUNTERS]
    both = L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, (False, True))
    again = L.lstm_backward_directions(gouts, gates, cs, w_hhs, lengths, (False, True))
    alone = [L.lstm_backward(*args, lengths, reverse=r) for *args, r in zip(gouts, gates, cs, w_hhs, (False, True))]
    assert _counts(before) == [0, 0, 0, 0, 2 * (2 // plan["directions"]) + 2]
    for i, reverse in enumerate((False, True)):
        _close(both[i], L.lstm_backward_plain(gouts[i], gates[i], cs[i], w_hhs[i], lengths, reverse), 1e-4)
        assert torch.equal(both[i], again[i]) and torch.equal(both[i], alone[i])


@pytest.mark.parametrize("hidden, b, want", [
    (320, 16, [1, 1, 2, 0, 0]),  # Conformer-M: the cluster route
    (640, 16, [0, 0, 2, 1, 1]),  # Conformer-L: the grid route, both directions a launch
    (640, 4, [0, 0, 2, 1, 1]),
    (1024, 16, [0, 0, 2, 2, 2]),  # one direction a launch
])
def test_lstm_launches_by_route(cuda, hidden, b, want):
    """A BiLSTM's forward and backward through `lstm_directions` launch the
    route's kernels only, as many times as the plan says, and agree with
    autograd through the plain loop."""
    xws, w_hhs, lengths = _bilstm_case(cuda, b, 31, hidden)
    rs = [torch.randn(b, 31, hidden, generator=cuda).cuda() for _ in range(2)]
    runs = []
    for fn in (L.lstm_directions, lambda x, w, n, rev: [L.lstm_plain(*a, n, r) for *a, r in zip(x, w, rev)]):
        leaves = [t.clone().requires_grad_(True) for t in (*xws, *w_hhs)]
        before = [k.launches for k in LSTM_COUNTERS]
        sum((h * r).sum() for h, r in zip(fn(leaves[:2], leaves[2:], lengths, (False, True)), rs)).backward()
        runs.append(([x.grad for x in leaves], _counts(before)))
    (grads, counts), (grads_ref, _) = runs
    assert counts == want
    for g, ref in zip(grads, grads_ref):
        _close(g, ref, 1e-4 * max(1.0, ref.abs().max().item()))


def test_lstm_grid_refuses_a_grid_it_cannot_hold(cuda):
    """A grid whose CTAs cannot all be resident at once (1,000 a direction,
    passed through the C entry with a layout of its own) is refused before
    it runs: `RuntimeError` naming the shape, no fallback, and the card
    stays usable."""
    xws, w_hhs, lengths = _bilstm_case(cuda, 16, 9, 640)
    plan = L.grid_plan(16, 640, torch.cuda.get_device_properties(0).multi_processor_count, L.smem_optin(0))
    layout = L.grid_layout(640, 1000, plan["rows"])
    forced = {**plan, "ctas": 1000, "units": 1, "smem_bytes": 4 * max(layout["fwd_floats"], layout["bwd_floats"])}
    before = [k.launches for k in LSTM_COUNTERS]
    with pytest.raises(RuntimeError, match=r"\(B, T, H\) = \(16, 9, 640\).*cannot be resident"):
        L.lstm_forward_grid(xws, w_hhs, lengths, (False, True), False, forced)
    with pytest.raises(RuntimeError, match="kernel launch failed"):  # a layout other than the launcher's own
        L.lstm_forward_grid(xws, w_hhs, lengths, (False, True), False, {**plan, "units": plan["units"] + 1})
    assert _counts(before) == [0, 0, 0, 0, 0]
    _close(L.lstm_directions(xws, w_hhs, lengths, (False, True))[0], L.lstm_plain(xws[0], w_hhs[0], lengths), 1e-4)


def test_lstm_grid_launch_refuses_an_exchange_off_its_layout(cuda):
    """The launchers take the exchange buffer's size in floats and refuse,
    launching nothing, one float more or less than the kernel writes
    (directions × 2 × H × rows for the forward, directions × 2 × CTAs² ×
    rows × units for the backward); with the exact size both launch and the
    forward's h is bit-equal to the wrapper's."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    b, t, hidden = 16, 9, 640
    xws, w_hhs, lengths = _bilstm_case(cuda, b, t, hidden)
    plan = L.grid_plan(b, hidden, torch.cuda.get_device_properties(0).multi_processor_count, L.smem_optin(0))
    layout = L.grid_layout(hidden, plan["ctas"], plan["rows"])
    plan_args = (plan["ctas"], plan["units"], plan["rows"], plan["smem_bytes"])
    ptrs = lambda xs: [x.data_ptr() for x in xs]  # noqa: E731
    gouts = [torch.randn(b, t, hidden, generator=cuda).cuda() for _ in range(2)]
    saved = [L.lstm_forward_plain(xw, w, lengths, r) for xw, w, r in zip(xws, w_hhs, (False, True))]
    for delta in (-1, 1, 0):
        hs = [torch.zeros(b, t, hidden, device="cuda") for _ in range(2)]
        dxws = [torch.zeros(b, t, 4 * hidden, device="cuda") for _ in range(2)]
        errs = []
        for kind, per_direction in (("fwd", layout["fwd_exchange"]), ("bwd", layout["bwd_exchange"])):
            exchange = torch.empty(2 * per_direction + delta, device="cuda")
            counters = torch.zeros(2, device="cuda", dtype=torch.int32)
            if kind == "fwd":
                operands = (*ptrs(xws), *ptrs(w_hhs), lengths.data_ptr(), *ptrs(hs), None, None, None, None)
                launch = build.library().lstm_fwd_grid
            else:
                operands = (*ptrs(gouts), *ptrs(s[2] for s in saved), *ptrs(s[1] for s in saved), *ptrs(w_hhs),
                            lengths.data_ptr(), *ptrs(dxws))
                launch = build.library().lstm_bwd_grid
            errs.append(launch(*operands, exchange.data_ptr(), counters.data_ptr(), 2, 0, 1, b, t, hidden,
                               *plan_args, exchange.numel(), build.stream_of(xws[0])))
        torch.cuda.synchronize()
        if delta:
            assert all(errs) and not any(h.any() for h in hs) and not any(d.any() for d in dxws), errs
        else:
            assert errs == [0, 0]
            for h, (ref, _, _) in zip(hs, L.lstm_forward_directions(xws, w_hhs, lengths, (False, True))):
                assert torch.equal(h, ref)


def test_lstm_grid_plan_on_this_card(cuda):
    """`grid_plan` on the card's own SMs and shared memory: Conformer-L's H
    = 640 at both train shapes takes both directions in one launch, and
    every H from 386 to 1024 is placed."""
    sms, optin = torch.cuda.get_device_properties(0).multi_processor_count, L.smem_optin(0)
    for b in (16, 4):
        assert L.grid_plan(b, 640, sms, optin)["directions"] == 2
        assert all(L.grid_plan(b, h, sms, optin)["fits"] for h in range(386, 1025))


@pytest.mark.parametrize("batch, hidden, want", [
    (16, 320, (True, 16, 16, 166400)),  # Conformer-M: 100 KB of w_hh's slice, double-buffered h, partial gates
    (4, 320, (True, 16, 4, 166400)),    # the long-form batch: one tile of 4 rows
    (33, 13, (True, 16, 16, 4048)),     # one unit a CTA, the last three own none
    (4, 385, (True, 16, 4, 232032)),    # the largest H whose forward fits 232,448 bytes
    (4, 386, (False, 16, 4, 232560)),
    (16, 640, (False, 16, 16, 537600)),  # Conformer-L: the grid route
    (4, 640, (False, 16, 4, 537600)),    # and at the long-form batch
    (16, 1024, (False, 16, 16, 1253376)),  # the grid's largest H
])
def test_lstm_cluster_plan(cuda, batch, hidden, want):
    """The cluster route's plan, as the CUDA source works it out for the
    H100's 232,448 bytes of shared memory a block: whether it fits, CTAs per
    cluster, rows per cluster, the larger of the forward's and the
    backward's shared memory per CTA."""
    assert L.cluster_plan(batch, hidden, 232448) == want


def _ctc_case(gen, b=16, t=235, length=100, vocab=1024):
    """Main-path shapes: random labels, one row of repeated pairs, one empty
    label, one impossible alignment (100 labels in 60 frames)."""
    labels = torch.randint(1, vocab, (b, length), generator=gen)
    labels[1] = labels[1, : length // 2].repeat_interleave(2)
    label_lengths = torch.full((b,), length)
    label_lengths[2] = 0
    input_lengths = torch.randint(2 * length + 20, t + 1, (b,), generator=gen)
    input_lengths[0], input_lengths[3] = t, 60
    logits = torch.randn(b, t, vocab, generator=gen) * 2
    return [x.cuda() for x in (logits, labels, input_lengths, label_lengths)]


@pytest.mark.parametrize("b, t, length", [(16, 235, 100), (4, 938, 400)])  # the 30 s and the 120 s train step
def test_ctc_kernels(cuda, b, t, length):
    logits, labels, in_len, lab_len = _ctc_case(cuda, b, t, length)
    ext, can_skip, _, ext_len = TC.extended_labels(labels, lab_len, 0)
    emit = TC.emit_log_probs(torch.log_softmax(logits, -1), ext)
    alpha = K.ctc_alpha(emit, can_skip, ext_len, in_len)
    alpha_ref = K.ctc_alpha_plain(emit, can_skip, ext_len, in_len)
    torch.cuda.synchronize()
    finite = alpha_ref > TC.LOG_EPS / 2
    assert torch.equal(alpha > TC.LOG_EPS / 2, finite)
    assert torch.all((alpha - alpha_ref).abs()[finite] <= 1e-3 + 1e-5 * alpha_ref.abs()[finite])
    ll, ll_ref = K.final_ll(alpha[:, -1], ext_len), K.final_ll(alpha_ref[:, -1], ext_len)
    assert ll_ref[3] == TC.LOG_EPS and torch.all(ll_ref[[0, 1, 2]] > TC.LOG_EPS / 2)
    torch.testing.assert_close(ll, ll_ref, rtol=1e-5, atol=0)
    g = torch.randn(b, generator=cuda).cuda()
    demit = K.ctc_beta(emit, alpha, can_skip, ext_len, in_len, ll, g)
    _close(demit, K.ctc_beta_plain(emit, alpha, can_skip, ext_len, in_len, ll, g), 5e-4)
    assert torch.isfinite(demit).all()
    # each state has one owner thread and nothing is atomic: two launches give the same bits
    assert torch.equal(alpha, K.ctc_alpha(emit, can_skip, ext_len, in_len))
    assert torch.equal(demit, K.ctc_beta(emit, alpha, can_skip, ext_len, in_len, ll, g))


def _ctc_rows(gen, in_len, lab_len, t, vocab=64):
    """Emit log-probs at the extended labels of random labels: rows of
    ``in_len`` frames (of ``t``) and ``lab_len`` labels, as the kernels take
    them, on the card."""
    labels = torch.randint(1, vocab, (len(in_len), max(lab_len)), generator=gen)
    lab_len, in_len = torch.tensor(lab_len), torch.tensor(in_len)
    ext, can_skip, _, ext_len = TC.extended_labels(labels, lab_len, 0)
    logits = torch.randn(len(in_len), t, vocab, generator=gen) * 2
    emit = TC.emit_log_probs(torch.log_softmax(logits, -1), ext)
    return [x.cuda() for x in (emit, can_skip, ext_len, in_len)]


def _ctc_against_twins(gen, emit, can_skip, ext_len, in_len):
    """Both kernels against their twins at the bars of `test_ctc_kernels`,
    and each bit-equal over two launches."""
    alpha = K.ctc_alpha(emit, can_skip, ext_len, in_len)
    alpha_ref = K.ctc_alpha_plain(emit, can_skip, ext_len, in_len)
    torch.cuda.synchronize()
    finite = alpha_ref > TC.LOG_EPS / 2
    assert torch.equal(alpha > TC.LOG_EPS / 2, finite)
    assert torch.all((alpha - alpha_ref).abs()[finite] <= 1e-3 + 1e-5 * alpha_ref.abs()[finite])
    ll, ll_ref = K.final_ll(alpha[:, -1], ext_len), K.final_ll(alpha_ref[:, -1], ext_len)
    torch.testing.assert_close(ll, ll_ref, rtol=1e-5, atol=0)
    g = torch.randn(emit.shape[0], generator=gen).cuda()
    demit = K.ctc_beta(emit, alpha, can_skip, ext_len, in_len, ll, g)
    _close(demit, K.ctc_beta_plain(emit, alpha, can_skip, ext_len, in_len, ll, g), 5e-4)
    assert torch.isfinite(demit).all()
    assert torch.equal(alpha, K.ctc_alpha(emit, can_skip, ext_len, in_len))
    assert torch.equal(demit, K.ctc_beta(emit, alpha, can_skip, ext_len, in_len, ll, g))
    return alpha, demit


@pytest.mark.parametrize("in_len, lab_len, t", [
    ([14, 7, 1, 0], [0, 0, 0, 0], 14),  # S = 1: every label empty
    ([1, 1, 0], [1, 0, 1], 1),  # T = 1: the init alone
    ([14, 12, 10, 9, 14, 11, 13, 8] * 2, [8, 5, 7, 3, 8, 2, 6, 4] * 2, 14),  # the NST buckets' T' = 14 and 28, S = 17
    ([28, 20, 25, 9, 28, 17, 26, 14] * 2, [8, 5, 7, 3, 8, 2, 6, 4] * 2, 28),
    ([37, 30, 5, 37, 21], [6, 6, 4, 1, 6], 37),  # T odd, not a multiple of the 8 frames copied ahead; S = 13
    ([235, 0, 235, 180], [100, 100, 60, 90], 235),  # a row of input length 0 between full rows
    ([1100, 1060], [511, 500], 1100),  # S = 1023, below the cap: alpha K = 5 in 7 warps, beta 32 warps
])
def test_ctc_kernels_at_the_edges(cuda, in_len, lab_len, t):
    _ctc_against_twins(cuda, *_ctc_rows(cuda, in_len, lab_len, t))


def test_ctc_kernels_on_unaligned_rows(cuda):
    """Emit at an offset of one float, so no frame starts 16-byte aligned and
    the outputs' rows (stored straight from registers) start elsewhere in
    their 16 bytes than the inputs'; and an even S, which no label gives,
    with skips drawn at random."""
    emit, can_skip, ext_len, in_len = _ctc_rows(cuda, [235, 200, 120, 235], [100, 90, 40, 7], 235)
    shifted = torch.empty(emit.numel() + 1, device="cuda")[1:].view(emit.shape)
    shifted.copy_(emit)
    assert shifted.data_ptr() % 16 == 4
    alpha, demit = _ctc_against_twins(cuda, shifted, can_skip, ext_len, in_len)
    assert torch.equal(alpha, K.ctc_alpha(emit, can_skip, ext_len, in_len))
    b, t, s = 3, 21, 12
    emit = torch.log_softmax(torch.randn(b, t, s, generator=cuda), -1).cuda()
    can_skip = (torch.rand(b, s, generator=cuda) < 0.5).cuda()
    _ctc_against_twins(cuda, emit, can_skip, torch.tensor([12, 9, 5]).cuda(), torch.tensor([21, 15, 2]).cuda())


def test_ctc_kernels_refuse_past_the_cap(cuda):
    """S = 1025 (512 labels) is past the kernels' cap: a ValueError, never
    the twin."""
    emit, can_skip, ext_len, in_len = _ctc_rows(cuda, [1100], [512], 1100)
    assert emit.shape[2] == K.MAX_STATES + 1
    with pytest.raises(ValueError, match="exceed"):
        K.ctc_alpha(emit, can_skip, ext_len, in_len)
    with pytest.raises(ValueError, match="exceed"):
        K.ctc_beta(emit, emit, can_skip, ext_len, in_len, torch.zeros(1).cuda(), torch.ones(1).cuda())


def test_ctc_launch_refuses_a_plan_off_its_layout(cuda):
    """The launch takes `ctc_plan`'s frames ahead and shared bytes and checks
    them against the kernels' own layout: the plan's are taken, and one
    float more or less of shared memory, another count of frames ahead or a
    K with no build is refused; no build spills."""
    import ctypes

    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    emit, can_skip, ext_len, in_len = _ctc_rows(cuda, [40, 33], [15, 12], 40)
    can_skip, ext_len, in_len = K.kernel_inputs(can_skip, ext_len, in_len, emit.device)
    b, t, s = emit.shape
    out = torch.empty_like(emit)
    lib, stream = build.library(), build.stream_of(emit)

    def alpha(threads, k, ahead, smem):
        return lib.ctc_alpha(emit.data_ptr(), can_skip.data_ptr(), ext_len.data_ptr(), in_len.data_ptr(),
                             out.data_ptr(), b, t, s, threads, k, ahead, smem, stream)

    def beta(threads, ahead, smem):
        ones = torch.ones(b, device="cuda")
        return lib.ctc_beta(emit.data_ptr(), emit.data_ptr(), can_skip.data_ptr(), ext_len.data_ptr(),
                            in_len.data_ptr(), ones.data_ptr(), ones.data_ptr(), out.data_ptr(), b, t, s, threads,
                            ahead, smem, stream)

    pa, pb = K.ctc_plan(s, "alpha"), K.ctc_plan(s, "beta")
    assert alpha(pa["threads"], pa["states_per_thread"], pa["ahead"], pa["smem_bytes"]) == 0
    assert beta(pb["threads"], pb["ahead"], pb["smem_bytes"]) == 0
    torch.cuda.synchronize()
    for off in (-4, 4):
        assert alpha(pa["threads"], pa["states_per_thread"], pa["ahead"], pa["smem_bytes"] + off) != 0
        assert beta(pb["threads"], pb["ahead"], pb["smem_bytes"] + off) != 0
    assert alpha(pa["threads"], pa["states_per_thread"], pa["ahead"] // 2, pa["smem_bytes"]) != 0
    assert beta(pb["threads"], pb["ahead"] * 2, pb["smem_bytes"]) != 0
    assert alpha(pa["threads"], 2, pa["ahead"], 4 * (4 * pa["warps"] + K.AHEAD * 2 * pa["threads"])) != 0  # no K = 2
    for kernel, ks in K.STATES_PER_THREAD.items():
        for k in ks:
            assert K.ctc_kernel_attributes(kernel, k)["local_bytes"] == 0, (kernel, k)
    with pytest.raises(RuntimeError):
        K.ctc_kernel_attributes("beta", 3)


def test_ctc_loss_kernel_matches_torch_ctc(cuda):
    logits, labels, in_len, lab_len = _ctc_case(cuda)
    x, w = logits.clone().requires_grad_(True), logits.clone().requires_grad_(True)
    before = (K.ctc_alpha.launches, K.ctc_beta.launches)
    ours = K.ctc_loss_kernel(torch.log_softmax(x, -1), labels, in_len, lab_len, reduction=None)
    ref = torch.nn.functional.ctc_loss(torch.log_softmax(w, -1).transpose(0, 1), labels, in_len, lab_len,
                                       reduction="none", zero_infinity=True)
    ours.sum().backward()
    ref.sum().backward()
    assert (K.ctc_alpha.launches - before[0], K.ctc_beta.launches - before[1]) == (1, 1)
    assert ours[3] == 0 and torch.all(x.grad[3] == 0)
    torch.testing.assert_close(ours, ref, rtol=1e-5, atol=1e-5)
    _close(x.grad, w.grad, 1e-3)


def _conv_case(gen, dtype, b, t, c, k):
    x = torch.randn(b, t, c, generator=gen).cuda().to(dtype)
    w = (torch.randn(k, c, generator=gen) * k ** -0.5).cuda().to(dtype)
    return x, w


def _conv_bar(ref, dtype):
    return max(2.0 ** -7 * ref.abs().max().item(), 1e-5) if dtype == torch.bfloat16 else 1e-5


def _conv_counts():
    return D.depthwise_conv1d_forward.launches, D.depthwise_conv1d_weight_grad.launches


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b, t, c, k",
    [(16, 235, 512, 33), (4, 938, 512, 33), (2, 100, 1024, 33), (16, 235, 1024, 33), (2, 8, 32, 33), (3, 37, 130, 7),
     (2, 235, 130, 4), (1, 1, 1, 1), (2, 65, 129, 2), (16, 28, 512, 33), (16, 14, 512, 33),
     (2, 70, 130, D.MAX_KERNEL_SIZE), (2, 70, 130, 195), (2, 50, 129, 33), (3, 41, 64, 32)],
)
def test_depthwise_conv_kernel(cuda, dtype, b, t, c, k):
    """Forward, dx (the same kernel, taps reversed, pads swapped) and dw
    against the plain twins, at the plan's layout for the shape (vector or
    scalar, fixed or generic taps); one launch each."""
    x, w = _conv_case(cuda, dtype, b, t, c, k)
    g = torch.randn(x.shape, generator=cuda).cuda().to(dtype)
    before = _conv_counts()
    got = D.depthwise_conv1d(x, w)
    assert _conv_counts() == (before[0] + 1, before[1])
    assert got.dtype == dtype and got.shape == x.shape
    ref = D.depthwise_conv1d_plain(x, w)
    _close(got, ref, _conv_bar(ref, dtype))
    pad_hi = k - 1 - (k - 1) // 2
    dx = D.depthwise_conv1d_forward(g, w, pad_lo=pad_hi, reverse_taps=True)
    dx_ref = D.depthwise_conv1d_plain(g, w.flip(0), pad_hi)
    _close(dx, dx_ref, _conv_bar(dx_ref, dtype))
    dw = D.depthwise_conv1d_weight_grad(x, g, k)
    assert _conv_counts() == (before[0] + 2, before[1] + 1)
    assert dw.dtype == torch.float32 and dw.shape == (k, c)
    dw_ref = D.depthwise_conv1d_weight_grad_plain(x, g, k)
    _close(dw, dw_ref, 1e-5 * dw_ref.abs().max().item())


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("b, t, c, k", [(16, 235, 512, 33), (4, 938, 512, 33), (16, 235, 1024, 33), (2, 70, 129, 195)])
def test_depthwise_conv_weight_grad_is_bit_equal_across_launches(cuda, dtype, b, t, c, k):
    """dw has no atomics: each block's partial is summed in row-group order
    and the partials in block order, so two launches give the same bits."""
    x, _ = _conv_case(cuda, dtype, b, t, c, k)
    g = torch.randn(x.shape, generator=cuda).cuda().to(dtype)
    first, second = D.depthwise_conv1d_weight_grad(x, g, k), D.depthwise_conv1d_weight_grad(x, g, k)
    torch.cuda.synchronize()
    assert torch.equal(first, second)


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize("c", [128, 130, 1024])
def test_depthwise_conv_misaligned_view_takes_the_scalar_layout(cuda, dtype, c):
    """A view one element into its storage cannot take 16-byte copies: the
    plan gives the scalar layout of the same kernels (never the twin), and
    forward, dx and dw agree with the twins there."""
    k = 33
    store = torch.randn(2 * 37 * c + 1, generator=cuda).cuda().to(dtype)
    x = store[1:].view(2, 37, c)
    g = torch.randn(2, 37, c, generator=cuda).cuda().to(dtype)
    w = (torch.randn(k, c, generator=cuda) * k ** -0.5).cuda().to(dtype)
    assert x.data_ptr() % 16 and not D._launch_plan(x, k, w)["vectorized"]
    before = _conv_counts()
    out, dw = D.depthwise_conv1d_forward(x, w), D.depthwise_conv1d_weight_grad(x, g, k)
    assert _conv_counts() == (before[0] + 1, before[1] + 1)
    ref, dw_ref = D.depthwise_conv1d_plain(x, w), D.depthwise_conv1d_weight_grad_plain(x, g, k)
    _close(out, ref, _conv_bar(ref, dtype))
    _close(dw, dw_ref, 1e-5 * dw_ref.abs().max().item())
    dx = D.depthwise_conv1d_forward(x, w, pad_lo=16, reverse_taps=True)
    dx_ref = D.depthwise_conv1d_plain(x, w.flip(0), 16)
    _close(dx, dx_ref, _conv_bar(dx_ref, dtype))


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
def test_depthwise_conv_plan_builds_do_not_spill(cuda, dtype):
    """Every build a plan can launch keeps its registers: no local memory
    (spills or a stack frame), and the fixed-tap builds stay within the 128
    registers that two 256-thread blocks an SM allow."""
    for kernel in D.KERNELS:
        for vectorized in (True, False):
            for fixed in (D.FIXED_TAPS, 0):
                attrs = D.depthwise_kernel_attributes(kernel, dtype, vectorized, fixed)
                assert attrs["local_bytes"] == 0 and attrs["registers"] <= 128, (kernel, vectorized, fixed, attrs)


def test_depthwise_conv_launch_refuses_a_layout_off_the_plan(cuda):
    """The C launchers check what they are handed against their own layout:
    another shared size, a row-group count they do not build, the fixed taps
    at another K, the vector layout on a misaligned pointer, or more blocks
    a slab than tiles are refused before any launch."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.cuda import build

    b, t, c, k = 4, 70, 128, 33
    x, w = _conv_case(cuda, torch.bfloat16, b, t, c, k)
    out = torch.empty_like(x)
    plan = D.depthwise_plan(b, t, c, k, torch.bfloat16)
    part = torch.empty(plan["dw_tiles"] + 1, k, c, device="cuda")
    dw = torch.empty(k, c, device="cuda")
    lib, stream = build.library(), build.stream_of(x)

    def fwd(x_ptr=x.data_ptr(), groups=plan["row_groups"], taps=plan["fixed_taps"], kk=k,
            blocks=plan["blocks_per_slab"], smem=plan["smem_bytes"]):
        return lib.depthwise_conv_fwd(x_ptr, w.data_ptr(), out.data_ptr(), b, t, c, kk, 16, 0, 1, groups, taps, 1,
                                      blocks, smem, stream)

    def dwk(blocks=plan["dw_blocks_per_slab"], smem=plan["dw_smem_bytes"]):
        return lib.depthwise_conv_dw(x.data_ptr(), x.data_ptr(), part.data_ptr(), dw.data_ptr(), b, t, c, k, 16, 1,
                                     plan["dw_row_groups"], plan["fixed_taps"], 1, blocks, smem, stream)

    assert fwd() == 0 and dwk() == 0
    torch.cuda.synchronize()
    refused = [fwd(smem=plan["smem_bytes"] + 16), fwd(groups=3),
               fwd(kk=31, taps=33, smem=D.shared_bytes("conv", plan["row_groups"], 31, 2, True)),
               fwd(x_ptr=x.data_ptr() + 2), fwd(blocks=plan["tiles"] + 1), fwd(blocks=0),
               dwk(blocks=plan["dw_tiles"] + 1), dwk(smem=plan["dw_smem_bytes"] - 16)]
    assert all(err != 0 for err in refused), refused
    with pytest.raises(RuntimeError, match="kernel launch failed"):  # through the wrapper: the same check
        build.check(fwd(groups=16), "depthwise_conv")


@pytest.mark.parametrize("k", [33, 4])
def test_depthwise_conv_gradients_reach_x_and_w(cuda, k):
    """The kernel path differentiates: dx and dw equal autograd's through
    the plain twin, through two launches of the one kernel (forward, dx)
    and one of dw (with its reduce)."""
    x, w = _conv_case(cuda, torch.float32, 4, 235, 512, k)
    r = torch.randn(x.shape, generator=cuda).cuda()
    grads = []
    for fn in (D.depthwise_conv1d, D.depthwise_conv1d_plain):
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        before = _conv_counts()
        (fn(xl, wl) * r).sum().backward()
        grads.append((xl.grad, wl.grad, tuple(a - b for a, b in zip(_conv_counts(), before))))
    (dx, dw, count), (dx_ref, dw_ref, plain_count) = grads
    assert (count, plain_count) == ((2, 1), (0, 0))
    _close(dx, dx_ref, 1e-5)
    _close(dw, dw_ref, 1e-4 * dw_ref.abs().max().item())


def test_depthwise_conv_wrapper_rejects_what_the_kernel_does_not_take(cuda):
    x = torch.zeros(2, 5, 8, device="cuda")
    with pytest.raises(ValueError):
        D.depthwise_conv1d(x, torch.zeros(3, 4, device="cuda"))
    with pytest.raises(ValueError):
        D.depthwise_conv1d(x, torch.zeros(3, 8, device="cuda", dtype=torch.bfloat16))
    with pytest.raises(ValueError):
        D.depthwise_conv1d(x.double(), torch.zeros(3, 8, device="cuda", dtype=torch.float64))
    with pytest.raises(ValueError, match="above"):  # one tap more than a block's shared memory holds
        D.depthwise_conv1d(x, torch.zeros(D.MAX_KERNEL_SIZE + 1, 8, device="cuda"))
    with pytest.raises(ValueError, match="above"):
        D.depthwise_conv1d_weight_grad(x, x, D.MAX_KERNEL_SIZE + 1)
    assert D.depthwise_conv1d(x[:0], torch.zeros(3, 8, device="cuda")).shape == (0, 5, 8)
    assert torch.equal(D.depthwise_conv1d_weight_grad(x[:0], x[:0], 3), torch.zeros(3, 8, device="cuda"))


@pytest.mark.parametrize("dtype, bias_dtype", [(torch.float32, torch.float32), (torch.bfloat16, torch.bfloat16),
                                               (torch.bfloat16, torch.float32)])
@pytest.mark.parametrize("t, dh, lengths", [
    (1, 64, [1, 1, 1]), (33, 32, [33, 1, 30]), (235, 64, [235, 117, 78]), (70, 128, [70, 35, 64]),
    (40, 16, [40, 0, 32]),
    *((t, dh, [0, 1, t, t // 2 + 1, *(n for n in (64, 128) if n < t)])
      for t in (1, 14, 63, 64, 65, 235, 938) for dh in (16, 32, 64, 128)),
])
def test_attention_bias_kernel(cuda, dtype, bias_dtype, t, dh, lengths):
    """Every query row against the twin, at each compiled head width, with
    lengths 0, 1, full and about half in one batch: a length of 0 gives the
    mean of v on both sides; T = 63, 64, 65 put the edge just inside, on and
    just past a 64-key tile of the bfloat16 kernel (and a 32-key tile of the
    float32 one), and a length of 64 or 128 short of T (or 32, 64 in the
    first five cases) makes a row's walk stop exactly at a tile edge.  The
    bias is drawn wide (its share of a score has spread 4·dh^-0.5, the qu·k
    share about 0.25) so that the softmax follows it, and the bar can see
    it: the same kernel on a zeroed bias must miss the bar fourfold."""
    b, h = len(lengths), 2
    qu, k, v = ((torch.randn(b, t, h, dh, generator=cuda) * 0.5).cuda().to(dtype) for _ in range(3))
    bias = (torch.randn(b, h, t, t, generator=cuda) * 4.0).cuda().to(bias_dtype)
    args = (qu, k, v, bias, torch.tensor(lengths, dtype=torch.int32).cuda(), dh ** -0.5)
    before = A.flash_attention_forward.launches
    out = A.flash_attention(*args)
    assert A.flash_attention_forward.launches == before + 1
    assert out.shape == qu.shape and out.dtype == dtype
    ref = A.flash_attention_plain(*args)
    atol = 1e-4 if dtype == torch.float32 else 2.0 ** -7 * ref.float().abs().max().item()
    _close(out, ref, atol)
    if t > 1:  # with one key the softmax is 1 whatever the bias
        blind = A.flash_attention(qu, k, v, torch.zeros_like(bias), *args[4:])
        assert (blind.float() - ref.float()).abs().max().item() > 4 * atol


def test_attention_bias_gradients_and_checks(cuda):
    """`BiasFlashAttention` on the card: the forward is the kernel, the
    backward the plain einsums; every input gets the gradient autograd
    gives through the twin.  The wrapper refuses what the kernel does not
    take."""
    b, t, h, dh = 2, 70, 2, 32
    qu, k, v, g = ((torch.randn(b, t, h, dh, generator=cuda) * 0.5).cuda() for _ in range(4))
    bias = (torch.randn(b, h, t, t, generator=cuda) * 0.5).cuda()
    lengths = torch.tensor([70, 41], dtype=torch.int32).cuda()
    leaves = [x.clone().requires_grad_(True) for x in (qu, k, v, bias)]
    twins = [x.clone().requires_grad_(True) for x in (qu, k, v, bias)]
    before = A.flash_attention_forward.launches
    A.flash_attention(*leaves, lengths, dh ** -0.5).backward(g)
    assert A.flash_attention_forward.launches == before + 1
    A.flash_attention_plain(*twins, lengths, dh ** -0.5).backward(g)
    for got, ref in zip(leaves, twins):
        _close(got.grad, ref.grad, 5e-4)
    assert not leaves[3].grad[1, :, :, 41:].any()
    with pytest.raises(ValueError, match="head_dim"):
        A.flash_attention(torch.zeros(1, 4, 1, 24, device="cuda"), *(torch.zeros(1, 4, 1, 24, device="cuda"),) * 2,
                          torch.zeros(1, 1, 4, 4, device="cuda"), lengths[:1], 1.0)
    with pytest.raises(ValueError, match="bias must be"):
        A.flash_attention(qu, k, v, bias.to(torch.bfloat16), lengths, 1.0)
    with pytest.raises(ValueError, match="bias must be"):
        A.flash_attention(qu, k, v, bias[:, :, :, :-1], lengths, 1.0)


def test_beam_search_on_the_card_equals_the_cpu(cuda):
    """`ctc_beam_search` runs where its log-probs lie; the same float32
    log-probs give the same hypotheses on both devices."""
    from nn_conformer_for_speech_recognition_tpu_torch.ops.decode import ctc_beam_search

    lp = torch.log_softmax(torch.randn(4, 60, 50, generator=cuda) * 3, dim=-1)
    lengths = torch.tensor([60, 31, 1, 45], dtype=torch.int32)
    kw = dict(beam=8, prune=16, max_label_len=32)
    toks, lens, scores = ctc_beam_search(lp.cuda(), lengths.cuda(), **kw)
    assert toks.is_cuda
    rtoks, rlens, rscores = ctc_beam_search(lp, lengths, **kw)
    assert torch.equal(lens.cpu(), rlens) and torch.equal(toks.cpu(), rtoks)
    _close(scores, rscores.cuda(), 1e-3)
