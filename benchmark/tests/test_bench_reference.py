"""The plain reference against the port's plain path at a tiny size on the
CPU (float32 there, every kernel through its plain twin): log-mel,
SpecAugment with the same generator, the forward, the CTC loss, the
gradients and the Adafactor update agree."""

import numpy as np
import pytest
import torch

from benchmark import harness as H
from benchmark import traffic as T
from benchmark.reference import judge as J
from benchmark.reference import ops as R
from benchmark.reference.model import ConformerCTC, Ctx
from benchmark.reference.optim import Adafactor as RefAdafactor
from benchmark.reference.ops import Rounding


def _setup(tiny_cell, name="conformer_m.train", seed=3):
    cell = tiny_cell(name)
    corpus = T.make_corpus(cell["traffic"], cell["cfg"], seed, torch.device("cpu"))
    weights = H.make_weights(cell["cfg"], seed, torch.device("cpu"))
    return cell, corpus, weights


def test_log_mel_and_specaugment_equal_the_ports(tiny_cell):
    from nn_conformer_for_speech_recognition_tpu_torch.config import FeatureConfig, SpecAugmentConfig
    from nn_conformer_for_speech_recognition_tpu_torch.ops.features import log_mel_spectrogram
    from nn_conformer_for_speech_recognition_tpu_torch.ops.specaugment import specaugment

    cell, corpus, _ = _setup(tiny_cell)
    audio, alen, _, _ = J.rows_of(corpus, np.arange(4), torch.device("cpu"))
    got, fl = R.log_mel(audio, alen, cell["cfg"]["features"])
    want, fl2 = log_mel_spectrogram(audio, FeatureConfig(**cell["cfg"]["features"]), alen)
    assert torch.equal(fl, fl2)
    torch.testing.assert_close(got, want, rtol=1e-5, atol=1e-5)
    a = R.specaugment(got, fl, cell["cfg"]["specaugment"], torch.Generator().manual_seed(9))
    b = specaugment(got, fl, SpecAugmentConfig(**cell["cfg"]["specaugment"]), torch.Generator().manual_seed(9))
    assert torch.equal(a, b)


@pytest.mark.parametrize("training", [False, True])
def test_forward_loss_and_gradients_equal_the_ports(tiny_cell, training):
    from nn_conformer_for_speech_recognition_tpu_torch.models.asr import ConformerCTC as Port
    from nn_conformer_for_speech_recognition_tpu_torch.ops.ctc import ctc_loss

    cell, corpus, weights = _setup(tiny_cell)
    cfg = cell["cfg"]
    port = Port(H.port_configs(cfg, cell["traffic"], 0)[0], cfg["vocab_size"])
    port.load_state_dict(weights, strict=True)
    ref = ConformerCTC(cfg["model"], cfg["vocab_size"])
    ref.load_state_dict(weights, strict=True)
    port.train(training)
    audio, alen, targets, tlen = J.rows_of(corpus, np.arange(4), torch.device("cpu"))
    feats, fl = R.log_mel(audio, alen, cfg["features"])
    torch.manual_seed(5)
    lp_port, ol_port = port(feats, fl)
    torch.manual_seed(5)
    lp_ref, ol_ref = ref(feats, fl, Ctx(training, torch.float32, Rounding()))
    assert torch.equal(ol_port, ol_ref)
    valid = torch.arange(lp_ref.shape[1])[None, :] < ol_ref[:, None]
    torch.testing.assert_close(lp_ref[valid], lp_port[valid], rtol=1e-4, atol=1e-4)
    if training:
        a = ctc_loss(lp_port, targets, ol_port, tlen, reduction=None)
        b = R.ctc_nll(lp_ref, targets, ol_ref, tlen, blank=0)
        torch.testing.assert_close(a, b, rtol=1e-5, atol=1e-5)
        a.sum().backward()
        b.sum().backward()
        for (name, p), (_, q) in zip(port.named_parameters(), ref.named_parameters()):
            assert float((p.grad - q.grad).abs().max()) <= 1e-5 * float(q.grad.abs().max()) + 1e-7, name


def test_adafactor_equals_the_ports():
    from nn_conformer_for_speech_recognition_tpu_torch.train.optim import Adafactor as Port

    torch.manual_seed(0)
    # a factored Linear, a factored conv, an unfactored small matrix and a vector
    shapes = {"a.weight": (256, 160), "c.weight": (128, 512, 3, 3), "u_bias": (4, 64), "b.bias": (300,)}
    mod_a, mod_b = torch.nn.Module(), torch.nn.Module()
    for n, s in shapes.items():
        w = torch.randn(s, dtype=torch.float64)  # float64: the two orders of the same sums agree far past the update
        mod_a.register_parameter(n.replace(".", "_"), torch.nn.Parameter(w.clone()))
        mod_b.register_parameter(n.replace(".", "_"), torch.nn.Parameter(w.clone()))
    names = {n.replace(".", "_"): n for n in shapes}
    port = Port([(names[k], p) for k, p in mod_a.named_parameters()], 2e-5, momentum=0.9, clipping_threshold=1.0)
    ref = RefAdafactor(mod_b, 2e-5, 0.9, 1.0)
    for _ in range(3):
        for p, q in zip(mod_a.parameters(), mod_b.parameters()):
            g = torch.randn(p.shape, dtype=torch.float64)
            p.grad, q.grad = g.clone(), g.clone()
        port.step()
        ref.step()
    for (n, p), (_, q) in zip(mod_a.named_parameters(), mod_b.named_parameters()):
        assert float((p - q).abs().max()) <= 1e-9 * 2e-5, n  # a billionth of one step's update


def test_label_gap_is_zero_for_the_greedy_labels_and_grows_with_a_changed_word():
    torch.manual_seed(1)
    lp = torch.log_softmax(torch.randn(3, 12, 10), dim=-1)
    lengths = torch.tensor([12, 9, 5])
    greedy = [[int(x) for x in lp[j, : int(lengths[j])].argmax(-1) if x not in (0, 1)] for j in range(3)]
    assert np.all(J.label_gaps(lp, lengths, greedy) == 0.0)
    changed = [list(x) for x in greedy]
    changed[0][0] = 2 + (changed[0][0] - 2 + 1) % 8
    gaps = J.label_gaps(lp, lengths, changed)
    assert gaps[0] > 0 and gaps[1] == 0
    assert np.isinf(J.label_gaps(lp, lengths, [None, greedy[1], greedy[1] * 3])[[0, 2]]).all()
