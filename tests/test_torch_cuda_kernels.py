"""The port's hand-written CUDA kernels vs their plain PyTorch twins.

Needs a CUDA device and nvcc; each test skips without a device.  This file
imports no jax, so on a machine without it run it without the repo's
conftest:  python -m pytest --noconftest -m cuda tests/test_torch_cuda_kernels.py

Tolerances: float32 log-mel 1e-3 (log of sums of 512-term products taken
in another order), float32 attention 1e-4 and bfloat16 attention 2e-2 (one
bf16 rounding of the output and of the probabilities), the attention lse
and backward (dqu, dqv, dk, dv, dp) 5e-4 in float32, the bar the JAX
package holds its Pallas backward to, and in bfloat16 one bf16 ulp at the
reference's largest entry (2^-7 of it; measured: none to half an ulp, the
sums being float32 and rounded once), LSTM forward, its
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
and round once); dw through the Function 1e-4 of its largest entry (a
float32 sum over B·T rows).  The bias-input attention: against its twin on
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
    "kw, samples", [({}, 480000), ({}, 12345), (dict(n_fft=400, hop_length=160), 16001), ({}, 1920000)]
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
    twins, from the twin's saved output and lse.  A bfloat16 gradient is
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
@pytest.mark.parametrize("hidden", [37, 100, 320, 640])
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
        before = (L.lstm_forward.launches, L.lstm_backward.launches, L.lstm_weight_grad.launches)
        (fn(x, w, lengths, reverse=reverse) * r).sum().backward()
        after = (L.lstm_forward.launches, L.lstm_backward.launches, L.lstm_weight_grad.launches)
        grads.append((x.grad, w.grad, [a - b for a, b in zip(after, before)]))
    (dx, dw, counts), (dx_ref, dw_ref, _) = grads
    assert counts == [1, 1, 1]
    _close(dx, dx_ref, 1e-4)
    _close(dw, dw_ref, 1e-4 * dw_ref.abs().max().item())


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


@pytest.mark.parametrize("dtype", [torch.float32, torch.bfloat16])
@pytest.mark.parametrize(
    "b, t, c, k",
    [(16, 235, 512, 33), (4, 938, 512, 33), (2, 100, 1024, 33), (2, 8, 32, 33), (3, 37, 130, 7), (2, 235, 130, 4),
     (1, 1, 1, 1), (2, 65, 129, 2), (16, 28, 512, 33), (16, 14, 512, 33), (2, 70, 130, D.MAX_KERNEL_SIZE)],
)
def test_depthwise_conv_kernel(cuda, dtype, b, t, c, k):
    """Forward and dx (the same kernel, taps reversed, pads swapped) against
    the plain twin; one launch each."""
    x, w = _conv_case(cuda, dtype, b, t, c, k)
    before = D.depthwise_conv1d_forward.launches
    got = D.depthwise_conv1d(x, w)
    assert D.depthwise_conv1d_forward.launches == before + 1
    assert got.dtype == dtype and got.shape == x.shape
    ref = D.depthwise_conv1d_plain(x, w)
    _close(got, ref, _conv_bar(ref, dtype))
    pad_hi = k - 1 - (k - 1) // 2
    dx = D.depthwise_conv1d_forward(x, w, pad_lo=pad_hi, reverse_taps=True)
    dx_ref = D.depthwise_conv1d_plain(x, w.flip(0), pad_hi)
    _close(dx, dx_ref, _conv_bar(dx_ref, dtype))


@pytest.mark.parametrize("k", [33, 4])
def test_depthwise_conv_gradients_reach_x_and_w(cuda, k):
    """The kernel path differentiates: dx and dw equal autograd's through
    the plain twin, through two launches (forward, dx) of the one kernel."""
    x, w = _conv_case(cuda, torch.float32, 4, 235, 512, k)
    r = torch.randn(x.shape, generator=cuda).cuda()
    grads = []
    for fn in (D.depthwise_conv1d, D.depthwise_conv1d_plain):
        xl, wl = x.clone().requires_grad_(True), w.clone().requires_grad_(True)
        before = D.depthwise_conv1d_forward.launches
        (fn(xl, wl) * r).sum().backward()
        grads.append((xl.grad, wl.grad, D.depthwise_conv1d_forward.launches - before))
    (dx, dw, count), (dx_ref, dw_ref, plain_count) = grads
    assert (count, plain_count) == (2, 0)
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
    assert D.depthwise_conv1d(x[:0], torch.zeros(3, 8, device="cuda")).shape == (0, 5, 8)


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
