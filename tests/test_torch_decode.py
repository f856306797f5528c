"""The port's CTC prefix beam search against the JAX package's, from
numpy-seeded log-probs: the tokens and lengths of every beam bit-equal, the
scores within rtol 1e-5 (float32 ``logaddexp`` chains of T steps in two
libraries' ``exp``/``log1p``; a score is a sum of some tens of log-probs,
so an absolute bar would scale with T).
"""

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu.ops import decode as JD
from nn_conformer_for_speech_recognition_tpu_torch.ops import decode as TD

SCORE_RTOL = 1e-5


def _log_probs(rng, b, t, v, peaky=3.0):
    logits = rng.standard_normal((b, t, v)).astype(np.float32) * peaky
    logits -= logits.max(-1, keepdims=True)
    return logits - np.log(np.exp(logits).sum(-1, keepdims=True))


def _both(lp, lengths=None, **kw):
    jl = None if lengths is None else jnp.asarray(lengths, jnp.int32)
    tl = None if lengths is None else torch.tensor(lengths, dtype=torch.int32)
    ref = [np.asarray(x) for x in JD.ctc_beam_search(jnp.asarray(lp), jl, **kw)]
    got = [x.numpy() for x in TD.ctc_beam_search(torch.from_numpy(lp), tl, **kw)]
    return got, ref


def _assert_same(got, ref):
    (toks, lens, scores), (rtoks, rlens, rscores) = got, ref
    assert toks.dtype == np.int32 and lens.dtype == np.int32 and scores.dtype == np.float32
    np.testing.assert_array_equal(lens, rlens)
    np.testing.assert_array_equal(toks, rtoks)
    np.testing.assert_allclose(scores, rscores, rtol=SCORE_RTOL)


@pytest.mark.parametrize(
    "b, t, v, kw",
    [
        (3, 20, 12, dict(beam=4, prune=4, max_label_len=16)),
        (2, 40, 50, dict(beam=8, prune=16, max_label_len=64)),
        (4, 25, 9, dict(blank_id=1, beam=6, prune=5, max_label_len=32)),
        (1, 30, 6, dict(beam=16, prune=8, max_label_len=32)),  # more beams than distinct short prefixes
    ],
)
def test_beam_search_matches_jax(rng, b, t, v, kw):
    _assert_same(*_both(_log_probs(rng, b, t, v), **kw))


def test_ragged_lengths_carry_the_state_through(rng):
    lp = _log_probs(rng, 4, 24, 10)
    lengths = [24, 1, 13, 7]
    got, ref = _both(lp, lengths, beam=4, prune=6, max_label_len=16)
    _assert_same(got, ref)
    # a row decoded alone at its own length gives the same hypotheses
    alone = TD.ctc_beam_search(torch.from_numpy(lp[2:3, :13]), None, beam=4, prune=6, max_label_len=16)
    np.testing.assert_array_equal(alone[0].numpy()[0], got[0][2])
    np.testing.assert_allclose(alone[2].numpy()[0], got[2][2], rtol=SCORE_RTOL)


def test_prune_is_capped_at_the_non_blank_vocabulary(rng):
    """prune > V − 1: both packages search over the V − 1 non-blank tokens."""
    _assert_same(*_both(_log_probs(rng, 2, 15, 4), beam=4, prune=16, max_label_len=16))


def test_max_label_len_overflow_kills_extensions(rng):
    """Peaky frames that alternate tokens would decode ~T/2 labels: with room
    for 5, every hypothesis stops at 5 in both packages."""
    b, t, v = 2, 30, 6
    lp = np.full((b, t, v), -8.0, np.float32)
    for frame in range(t):
        lp[:, frame, 1 + frame % (v - 1)] = -0.01
    lp += 0.01 * rng.standard_normal(lp.shape).astype(np.float32)
    got, ref = _both(lp, beam=4, prune=4, max_label_len=5)
    _assert_same(got, ref)
    assert got[1].max() == 5 and (got[0][:, 0] >= 0).all()


def test_ties_go_to_the_lower_index():
    """Uniform frames: every extension of a beam ties, and so do whole
    hypotheses; the survivors are the lower-indexed candidates in both
    packages (``lax.top_k`` and the stable ``argsort`` there, stable
    descending sorts here)."""
    b, t, v = 2, 6, 5
    lp = np.full((b, t, v), np.log(1.0 / v), np.float32)
    got, ref = _both(lp, beam=4, prune=4, max_label_len=8)
    _assert_same(got, ref)
    lp[1, :, 2] = lp[1, :, 3] = np.log(0.3)  # two tokens tie for the best, the rest tie below
    lp[1, :, [0, 1, 4]] = np.log(0.4 / 3)
    _assert_same(*_both(lp, beam=3, prune=2, max_label_len=8))


def test_one_best_beats_the_collapsed_greedy_path(rng):
    """The 1-best prefix sums every alignment of it, the greedy path is one
    alignment of its own collapse: with the beam wide enough to keep that
    prefix, the 1-best scores at least the greedy path's log-prob."""
    lp = _log_probs(rng, 3, 18, 7, peaky=4.0)
    toks, lens, scores = TD.ctc_beam_search(torch.from_numpy(lp), None, beam=8, prune=6, max_label_len=32)
    greedy = torch.from_numpy(lp).max(dim=-1).values.sum(dim=1)
    assert (scores[:, 0] >= greedy - 1e-4).all()
    # frames that leave no doubt: the greedy collapse is the 1-best prefix
    sure = _log_probs(rng, 3, 18, 7, peaky=0.1)
    np.put_along_axis(sure, rng.integers(0, 7, (3, 18, 1)), 12.0, axis=-1)  # one token 12 nats above the rest
    toks, lens, _ = TD.ctc_beam_search(torch.from_numpy(sure), None, beam=8, prune=6, max_label_len=32)
    packed, n = TD.collapse_repeats(TD.greedy_decode(torch.from_numpy(sure)), blank_id=0, pad_id=-7)
    for row in range(3):
        assert toks[row, 0, : lens[row, 0]].tolist() == packed[row, : n[row]].tolist()


def test_hash_wraps_like_uint32():
    """The rolling hash of a long prefix, held in int64 and masked, equals
    numpy's uint32 arithmetic with wrap-around."""
    toks = [7, 1023, 3, 500, 42, 9, 77, 1000, 2, 2, 650]
    want = np.uint32(0)
    with np.errstate(over="ignore"):
        for tok in toks:
            want = want * np.uint32(TD._HASH_MULT) + np.uint32(tok + 1)
    got = 0
    for tok in toks:
        got = (got * TD._HASH_MULT + (tok + 1)) & TD._HASH_MASK
    assert got == int(want)
    init = (torch.arange(8) * TD._HASH_INIT_MULT) & TD._HASH_MASK
    with np.errstate(over="ignore"):
        np.testing.assert_array_equal(init.numpy(), (np.arange(8, dtype=np.uint32) * np.uint32(2654435761)).astype(np.int64))


def test_sharded_variant_on_one_rank_is_the_dense_search(rng):
    """`ctc_beam_search_sharded` over a model axis of one process (no
    collective runs) is `ctc_beam_search`, bit for bit; over two processes
    it is held in ``test_torch_tensor_parallel.py``."""
    from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import make_mesh

    logits = torch.from_numpy(rng.standard_normal((3, 12, 16)).astype(np.float32))
    lp, lengths = torch.log_softmax(logits, -1), torch.tensor([12, 8, 5])
    kw = dict(blank_id=0, beam=4, prune=4, max_label_len=12)
    got = TD.ctc_beam_search_sharded(lp, lengths, axis=make_mesh().model, **kw)
    for a, b in zip(got, TD.ctc_beam_search(lp, lengths, **kw)):
        assert torch.equal(a, b)
