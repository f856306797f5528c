"""The port's `parallel.multihost` on two gloo processes against the JAX
package's functions on one process.

One launch of two workers (`_torch_multiproc_helpers.launch`) per file:
each rank gathers its own inputs (a weighted metric, token batches of
uneven N and L, pseudo-labels keyed by global index with transcripts over
1 KB of non-ASCII text) and checks its parameters' sync, then one rank
perturbs a parameter by 1e-7.  The gathered answers must equal the JAX
functions' single-process answers on the concatenated inputs exactly
(integers and strings) or to 1e-12 (the float64 weighted mean).
"""

import numpy as np
import pytest
import torch

from _torch_multiproc_helpers import launch

from nn_conformer_for_speech_recognition_tpu.parallel import multihost as JMH
from nn_conformer_for_speech_recognition_tpu_torch.parallel import multihost as MH
from nn_conformer_for_speech_recognition_tpu_torch.parallel.mesh import DataShard, batch_rows, data_shard

METRICS = [(1.5, 2.0), (4.0, 3.0)]


def long_text(i):
    return f"utt{i} größé ünïcode 音声認識 " + ("lorem ipsum %d " % i) * 80


def _inputs():
    rng = np.random.default_rng(0)
    ids = [rng.integers(3, 50, (3 + r, 5 + r)).astype(np.int32) for r in range(2)]
    lengths = [np.arange(1, 4 + r) for r in range(2)]
    labels = [{i: long_text(i) for i in range(r, 40, 2)} for r in range(2)]
    return ids, lengths, labels


@pytest.fixture(scope="module")
def gathered(tmp_path_factory):
    ids, lengths, labels = _inputs()
    args = {"metrics": METRICS, "ids": [x.tolist() for x in ids], "lengths": [x.tolist() for x in lengths],
            "labels": [{str(k): v for k, v in d.items()} for d in labels]}
    return launch("gathers", 2, args, str(tmp_path_factory.mktemp("gathers")))


def test_both_ranks_ran_multihost(gathered):
    assert [r["world"] for r in gathered] == [2, 2] and all(r["multihost"] for r in gathered)


def test_gather_metric_is_the_weighted_mean(gathered):
    ref = sum(v * w for v, w in METRICS) / sum(w for _, w in METRICS)
    for r in gathered:
        np.testing.assert_allclose(r["mean"], ref, rtol=1e-12)
        assert r["total"] == sum(w for _, w in METRICS)
    # the JAX function on one process: the identity, as the port's
    assert JMH.gather_metric(*METRICS[0]) == MH.gather_metric(*METRICS[0]) == METRICS[0]


def test_gather_token_batches_uneven_rows_and_widths(gathered):
    ids, lengths, _ = _inputs()
    width = max(x.shape[1] for x in ids)
    padded = np.concatenate([np.pad(x, ((0, 0), (0, width - x.shape[1]))) for x in ids])
    ref_ids, ref_lens = JMH.gather_token_batches(padded, np.concatenate(lengths))
    for r in gathered:
        np.testing.assert_array_equal(r["tensors"]["ids"].numpy(), ref_ids)
        np.testing.assert_array_equal(r["lengths"], ref_lens)
    assert ref_ids.shape == (7, 6)


def test_gather_pseudo_labels_is_a_lossless_union(gathered):
    _, _, labels = _inputs()
    union = {**labels[0], **labels[1]}
    ref = JMH.gather_pseudo_labels(union)
    assert max(len(t.encode("utf-8")) for t in ref.values()) > 1024
    for r in gathered:
        assert {int(k): v for k, v in r["labels"].items()} == ref
        assert sorted(int(k) for k in r["labels"]) == list(range(40))


def test_assert_params_in_sync_fails_on_a_perturbed_rank(gathered):
    assert all(r["diverged_detected"] for r in gathered)
    assert gathered[0]["fingerprint"] != gathered[1]["fingerprint"]


def test_single_process_is_the_identity():
    """Without a process group every function returns its input, as the JAX
    module's do in a single process; the fingerprint is the same over a
    module, its state dict and a nested dict, and sees one ulp."""
    ids, lengths, labels = _inputs()
    assert not MH.is_multihost() and data_shard() == DataShard()
    out_ids, out_lens = MH.gather_token_batches(ids[0], lengths[0])
    assert out_ids is ids[0] and out_lens is lengths[0]
    assert MH.gather_pseudo_labels(labels[0]) is labels[0]
    MH.assert_params_in_sync(torch.nn.Linear(2, 2))
    torch.manual_seed(0)
    m = torch.nn.Linear(3, 2)
    nested = {"weight": m.weight, "bias": m.bias}
    assert MH.params_fingerprint(m).tolist() == MH.params_fingerprint(nested).tolist()
    assert MH.params_fingerprint(dict(m.named_parameters())).tolist() == MH.params_fingerprint(nested).tolist()
    before = MH.params_fingerprint(m).tolist()
    with torch.no_grad():
        m.weight[0, 0] = torch.nextafter(m.weight[0, 0], torch.tensor(2.0))
    assert MH.params_fingerprint(m).tolist() != before
    assert MH.host_local_state("state") == "state"
    assert MH.local_mesh().type in ("cpu", "cuda")


def test_batch_rows_takes_a_contiguous_share():
    from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import Batch

    b = Batch(np.arange(8 * 3).reshape(8, 3), np.arange(8), np.zeros((8, 2)), np.ones(8), np.arange(8) - 2)
    parts = [batch_rows(b, r, 4) for r in range(4)]
    assert [p.indices.tolist() for p in parts] == [[-2, -1], [0, 1], [2, 3], [4, 5]]
    np.testing.assert_array_equal(np.concatenate([p.audio for p in parts]), b.audio)
    assert [p.size for p in parts] == [0, 2, 2, 2]
