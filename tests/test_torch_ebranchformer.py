"""The port's E-Branchformer encoder (``ConformerConfig.block='e_branchformer'``)
against the benchmark's plain reference, `benchmark/reference/ebranchformer.py`,
on the CPU at a tiny size (2 blocks, d 32, 2 heads, cgMLP 64, both convs 5
taps): the same seeded weights, float32 on both sides.

Log-probs and every parameter's gradient agree with dropout off and with
dropout on, the masks replayed from the same seed (both draw in the same
order from the global generator).  Tolerance rtol 1e-4, atol 1e-5: both
sides are float32 and compute the same operations, in another order and
grouping (the port's einsum attention and conv layouts against the
reference's); the round-off of a 2-block forward and its backward is some
1e-6 relative, and a wrong term (a dropped gate, a missing bias, a mask in
the wrong place) moves them by far more.  Both conv routes: the library's
grouped conv1d, whose parameters the reference shares by name, and the
hand-written kernel's twin, whose (K, C) taps are the reference's moved.

Also: a row's valid frames do not depend on what its padded frames hold,
since both depthwise convs see them zeroed; the preset's parameter count at
published widths; the refusals under tensor parallelism and in the JAX
checkpoint bridge; the model-FLOPs count against one by hand.
"""

import dataclasses
import math
import types

import pytest
import torch

from benchmark.reference.ebranchformer import EBranchformerCTC
from benchmark.reference.model import Ctx
from benchmark.reference.ops import Rounding
from benchmark.reference.steps import draw_weights
from nn_conformer_for_speech_recognition_tpu_torch import config as C
from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC

VOCAB, MELS = 12, 13
ENC = dict(num_blocks=2, d_model=32, num_heads=2, ffn_dim=64, ffn_expansion_in_block=True, conv_kernel_size=5,
           dropout=0.1, attention_dropout=0.1, use_relative_attention=True, block="e_branchformer", cgmlp_dim=64,
           merge_conv_kernel=5)
SUB = dict(channels=[8, 8], kernel_sizes=[3, 3], time_strides=[2, 2], freq_strides=[2, 2])
DEC = dict(projection_dim=16, lstm_hidden=8, lstm_layers=1, bidirectional=True, dropout=0.1)


def _cfg(dropout: float) -> dict:
    enc = dict(ENC, dropout=dropout, attention_dropout=dropout)
    return {"vocab_size": VOCAB, "model": {"subsampling": SUB, "encoder": enc, "decoder": dict(DEC, dropout=dropout),
                                           "n_mels": MELS, "compute_dtype": "float32"}}


def _port(cfg: dict, conv_impl: str) -> ConformerCTC:
    m = cfg["model"]
    sub = C.SubsamplingConfig(**{k: tuple(v) for k, v in m["subsampling"].items()})
    mcfg = C.ModelConfig(subsampling=sub, encoder=C.ConformerConfig(**m["encoder"]),
                         decoder=C.DecoderConfig(**m["decoder"]), n_mels=MELS, compute_dtype="float32",
                         use_pallas=True, conv_impl=conv_impl)
    return ConformerCTC(mcfg, VOCAB)


def _port_weights(weights: dict, conv_impl: str) -> dict:
    """The reference's weights in the route's names: the kernel route's
    ``dw_kernel`` (K, C) and ``dw_bias`` for ``depthwise.weight`` (C, 1, K)
    and ``depthwise.bias``."""
    if conv_impl != "pallas":
        return weights
    out = {}
    for name, w in weights.items():
        if name.endswith("depthwise.weight"):
            out[name.replace("depthwise.weight", "dw_kernel")] = w[:, 0, :].t().contiguous()
        elif name.endswith("depthwise.bias"):
            out[name.replace("depthwise.bias", "dw_bias")] = w
        else:
            out[name] = w
    return out


@pytest.mark.parametrize("conv_impl", ["auto", "pallas"])
@pytest.mark.parametrize("dropout", [0.0, 0.1])
def test_log_probs_and_gradients_equal_the_reference(conv_impl, dropout):
    cfg = _cfg(dropout)
    weights = draw_weights(EBranchformerCTC, cfg, 7, torch.device("cpu"))
    ref = EBranchformerCTC(cfg["model"], VOCAB)
    ref.load_state_dict(weights, strict=True)
    port = _port(cfg, conv_impl)
    port.load_state_dict(_port_weights(weights, conv_impl), strict=True)
    port.train()
    gen = torch.Generator().manual_seed(3)
    feats = torch.rand((3, 40, MELS), generator=gen)
    lengths = torch.tensor([40, 33, 21])
    feats = feats * (torch.arange(40)[None, :, None] < lengths[:, None, None])
    torch.manual_seed(11)
    lp_port, ol_port = port(feats, lengths)
    torch.manual_seed(11)
    lp_ref, ol_ref = ref(feats, lengths, Ctx(True, torch.float32, Rounding()), remat=False)
    assert torch.equal(ol_port, ol_ref)
    valid = (torch.arange(lp_ref.shape[1])[None, :] < ol_ref[:, None])[..., None]
    torch.testing.assert_close(lp_port * valid, lp_ref * valid, rtol=1e-4, atol=1e-5)
    cot = torch.randn(lp_ref.shape, generator=gen) * valid
    (lp_port * cot).sum().backward()
    (lp_ref * cot).sum().backward()
    want = _port_weights({n: p.grad for n, p in ref.named_parameters()}, conv_impl)
    got = {n: p.grad for n, p in port.named_parameters()}
    assert set(got) == set(want)
    for n in want:
        scale = float(want[n].abs().max())
        torch.testing.assert_close(got[n], want[n], rtol=1e-4, atol=1e-5 * max(scale, 1.0), msg=n)
        assert scale > 0.0, n  # every parameter takes part


@pytest.mark.parametrize("conv_impl", ["auto", "pallas"])
def test_valid_frames_do_not_depend_on_the_padding(conv_impl):
    """What the encoder's padded frames hold (after the front end they are
    not zero) reaches no valid frame: attention masks them as keys and both
    depthwise convs see them zeroed."""
    port = _port(_cfg(0.0), conv_impl)
    for name, p in port.named_parameters():
        with torch.no_grad():
            p.copy_(torch.randn(p.shape, generator=torch.Generator().manual_seed(len(name))) * 0.3)
    port.eval()
    gen = torch.Generator().manual_seed(5)
    h = torch.randn((2, 12, 32), generator=gen)
    lengths = torch.tensor([12, 7])
    garbage = h.clone()
    garbage[1, 7:] = 100.0 * torch.randn((5, 32), generator=gen)
    with torch.no_grad():
        a = port.encoder(h, lengths)
        b = port.encoder(garbage, lengths)
    torch.testing.assert_close(a[1, :7], b[1, :7], rtol=1e-5, atol=1e-6)
    assert torch.equal(a[0], b[0]) and float(b[1, 7:].abs().max()) == 0.0


def test_preset_parameter_count_at_published_widths():
    """E-Branchformer-L as published (17 blocks, d 512, 8 heads, FFN 1024,
    cgMLP 3072, convs of 31, a front end of two 3x3 convs of 512) with the
    port's head at 5000 units: about 121 M parameters, counted here by hand."""
    cfg = C.e_branchformer_l(n_mels=80)
    with torch.device("meta"):
        model = ConformerCTC(cfg, 5000)
    d, f, c, k = 512, 1024, 3072, 31
    ln = 2 * d
    ffn = ln + d * f + f + f * d + d
    mhsa = ln + 3 * d * d + d * d + d * d + d + 2 * d
    cgmlp = ln + d * c + c + c + (c // 2) * k + c // 2 + (c // 2) * d + d
    merge = (2 * d) * k + 2 * d + 2 * d * d + d
    block = 2 * ffn + mhsa + cgmlp + merge + ln
    front = (1 * 9 * 512 + 512) + (512 * 9 * 512 + 512) + (20 * 512) * d + d
    head = (d * 256 + 256) + 2 * 256 + 2 * (256 * 1280 + 320 * 1280 + 1280) + (640 * 5000 + 5000)
    want = front + 17 * block + ln + head
    got = sum(p.numel() for p in model.parameters())
    assert got == want and 118e6 < got < 124e6, got
    assert [type(b).__name__ for b in model.encoder.blocks] == ["EBranchformerBlock"] * 17


def test_tensor_parallel_refuses_the_block():
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import Axis, shard_module

    mesh = types.SimpleNamespace(data=Axis("data", 1, 0), model=Axis("model", 2, 0))
    with pytest.raises(ValueError, match="E-Branchformer block has no tensor-parallel split"):
        shard_module(_port(_cfg(0.0), "auto"), mesh)


def test_jax_bridge_refuses_the_block():
    from nn_conformer_for_speech_recognition_tpu_torch.convert import flax_to_state_dict, train_state_from_flax

    cfg = _port(_cfg(0.0), "auto").config
    with pytest.raises(ValueError, match="no 'e_branchformer' encoder block"):
        flax_to_state_dict({"params": {}}, cfg)
    with pytest.raises(ValueError, match="no 'e_branchformer' encoder block"):
        train_state_from_flax({"params": {}, "opt_state": {}, "step": 0}, cfg)


def test_flops_count_by_hand():
    """One block of d 4, 2 heads, FFN 8, cgMLP 8, convs of 3, one row of 8
    feature frames of 4 mels, a front end of two 3x3 convs of 2 channels,
    a head of projection 2, LSTM 2, 5 units."""
    from nn_conformer_for_speech_recognition_tpu_torch.utils.flops import conformer_forward_flops, train_step_flops

    enc = C.ConformerConfig(num_blocks=1, d_model=4, num_heads=2, ffn_dim=8, conv_kernel_size=3,
                            block="e_branchformer", cgmlp_dim=8, merge_conv_kernel=3)
    cfg = C.ModelConfig(subsampling=C.SubsamplingConfig(channels=(2, 2), kernel_sizes=(3, 3)), encoder=enc,
                        decoder=C.DecoderConfig(projection_dim=2, lstm_hidden=2), n_mels=4)
    # front end: 8x4 → 4x2 (2 ch, 9 taps of 1) → 2x1 (2 ch, 9 taps of 2) → Linear 2 → 4; T' = 2
    front = 4 * 2 * 2 * 2 * 9 * 1 + 2 * 1 * 2 * 2 * 9 * 2 + 2 * 2 * 2 * 4
    t = 2
    ffns = 2 * (2 * t * 4 * 8 + 2 * t * 8 * 4)
    attention = 2 * t * 4 * 12 + 2 * 2 * t * t * 2 * 2 + 2 * (2 * 2 * t * t * 2) + 2 * 3 * 4 * 4 + 2 * t * 4 * 4
    cgmlp = 2 * t * 4 * 8 + 2 * t * 4 * 3 + 2 * t * 4 * 4
    merge = 2 * t * 8 * 3 + 2 * t * 8 * 4
    head = 2 * t * 4 * 2 + 2 * (2 * t * (2 + 2) * 8) + 2 * t * 4 * 5
    want = front + ffns + attention + cgmlp + merge + head
    assert conformer_forward_flops(cfg, 5, 1, 8) == want
    assert train_step_flops(cfg, 5, 1, 8) == 3 * want
    # one block of the preset at T' = 751: about 7.7 M multiply-adds a frame (cgMLP 2.4 M, merge 0.6 M,
    # FFNs 2.1 M, projections 1.05 M, scores and the rel-pos term 1.5 M)
    big = C.e_branchformer_l(n_mels=80)
    fewer = dataclasses.replace(big, encoder=dataclasses.replace(big.encoder, num_blocks=16))
    one = (conformer_forward_flops(big, 5000, 32, 3001) - conformer_forward_flops(fewer, 5000, 32, 3001)) / 2
    assert math.isclose(one / 32 / 751, 7.7e6, rel_tol=0.02)
