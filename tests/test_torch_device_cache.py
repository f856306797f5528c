"""The device-resident dataset and the native WAV decode, port against the
JAX package: `gather_rows`, `DeviceResidentDataset` (order matrix, epoch
batches, ``set_targets``, ``with_pseudo_labels``) on the CPU, and
`native_loader.decode_batch` on its native and its pure-Python branch,
with `BucketedDataset.make_batch` over each.  Everything here is exact:
the same samples, indices and targets, bit for bit."""

import subprocess
import sys

import jax.numpy as jnp
import numpy as np
import pytest
import torch

from nn_conformer_for_speech_recognition_tpu.data import device_cache as JDC
from nn_conformer_for_speech_recognition_tpu.data import native_loader as JNL
from nn_conformer_for_speech_recognition_tpu_torch.data import device_cache as TDC
from nn_conformer_for_speech_recognition_tpu_torch.data import native_loader as NL
from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import BucketedDataset

from _torch_trainer_helpers import make_corpus


@pytest.fixture(scope="module")
def corpus(tmp_path_factory):
    return make_corpus(tmp_path_factory.mktemp("corpus"))


@pytest.fixture(scope="module")
def resident(corpus):
    """The train split resident in both packages, and truncated to 13 clips
    (a ragged final batch of 5 at batch 8)."""
    _, _, _, jdata, tdata = corpus
    pairs = {}
    for n in (None, 13):
        jdev, tdev = JDC.DeviceResidentDataset(jdata["train"]), TDC.DeviceResidentDataset(tdata["train"], device="cpu")
        if n is not None:
            jdev.utterances, tdev.utterances = jdev.utterances[:n], tdev.utterances[:n]
        pairs[n] = jdev, tdev
    return pairs


def test_gather_rows_matches_jax():
    rng = np.random.default_rng(0)
    audio = rng.standard_normal((6, 10)).astype(np.float32)
    alen = rng.integers(1, 10, 6).astype(np.int32)
    targets = rng.integers(3, 9, (6, 4)).astype(np.int32)
    tlen = rng.integers(1, 4, 6).astype(np.int32)
    idx = np.asarray([3, -1, 0, 5, -1], np.int32)
    ref = JDC.gather_rows(*(jnp.asarray(a) for a in (audio, alen, targets, tlen, idx)))
    got = TDC.gather_rows(*(torch.from_numpy(a) for a in (audio, alen, targets, tlen, idx)))
    for g, r in zip(got, ref):
        assert g.dtype == torch.from_numpy(np.array(r)).dtype
        np.testing.assert_array_equal(g.numpy(), np.asarray(r))
    assert not got[0][1].any() and got[1][1] == 0 and not got[2][4].any() and got[3][4] == 0


@pytest.mark.parametrize("seed", [0, 1, 2])
def test_order_matrix_matches_jax(resident, seed):
    for n, (jdev, tdev) in resident.items():
        for shuffle in (True, False):
            got, ref = tdev.order_matrix(seed, shuffle), jdev.order_matrix(seed, shuffle)
            assert got.dtype == ref.dtype == np.int32
            np.testing.assert_array_equal(got, ref)
        assert tdev.num_batches() == jdev.num_batches() == (2 if n == 13 else 4)
    assert (resident[13][1].order_matrix(seed)[-1] == -1).sum() == 3  # the ragged final batch


@pytest.mark.parametrize("shuffle", [True, False])
def test_epoch_batches_match_jax(resident, shuffle):
    for jdev, tdev in resident.values():
        got, ref = list(tdev.epoch(seed=5, shuffle=shuffle)), list(jdev.epoch(seed=5, shuffle=shuffle))
        assert len(got) == len(ref) == tdev.num_batches()
        for g, r in zip(got, ref):
            assert isinstance(g.audio, torch.Tensor) and g.audio.device.type == "cpu"
            for name in ("audio", "audio_lengths", "targets", "target_lengths"):
                np.testing.assert_array_equal(getattr(g, name).numpy(), np.asarray(getattr(r, name)), err_msg=name)
            np.testing.assert_array_equal(g.indices, r.indices)
            assert g.size == r.size


def test_resident_arrays_match_the_host_dataset(corpus, resident):
    """Each resident row is the host dataset's clip and targets."""
    _, _, _, _, tdata = corpus
    tdev = resident[None][1]
    host = next(tdata["train"].epoch(shuffle=False))
    audio, alen, targets, tlen = (x.numpy() for x in tdev.device_arrays())
    rows = host.indices[host.indices >= 0]
    np.testing.assert_array_equal(audio[rows], host.audio[: len(rows)])
    np.testing.assert_array_equal(alen[rows], host.audio_lengths[: len(rows)])
    np.testing.assert_array_equal(targets[rows], host.targets[: len(rows)])
    np.testing.assert_array_equal(tlen[rows], host.target_lengths[: len(rows)])


def test_set_targets_and_pseudo_labels_match_jax(corpus):
    _, _, _, jdata, tdata = corpus
    jdev, tdev = JDC.DeviceResidentDataset(jdata["train"]), TDC.DeviceResidentDataset(tdata["train"], device="cpu")
    update = {0: [4, 3], 5: [3, 4, 5, 6, 3, 4], 7: []}  # one longer than max_target_len, one empty
    before = [x.clone() for x in tdev.device_arrays()]
    jdev.set_targets(update)
    tdev.set_targets(update)
    for got, ref in zip(tdev.device_arrays()[2:], jdev.device_arrays()[2:]):
        np.testing.assert_array_equal(got.numpy(), np.asarray(ref))
    untouched = [i for i in range(len(tdev)) if i not in update]
    for got, was in zip(tdev.device_arrays(), before):
        assert torch.equal(got[untouched], was[untouched])
    labels = {0: "yes no", 1: "", 2: "stop go yes no stop", 3: "zzz qqq", 4: " go "}
    got = [(u.audio_path, u.transcript) for u in tdev.with_pseudo_labels(labels)]
    ref = [(u.audio_path, u.transcript) for u in jdev.with_pseudo_labels(labels)]
    assert got == ref and len(got) == 2


def _wav_paths(corpus):
    _, _, _, _, tdata = corpus
    return [u.audio_path for u in tdata["train"].utterances[:8]]


def test_decode_batch_native_matches_python_and_jax(corpus, monkeypatch):
    paths = _wav_paths(corpus)
    assert NL.native_available()

    def decode(fn, rows=10, samples=12000):
        out = np.full((rows, samples), 7.0, np.float32)  # rows past the paths stay untouched
        lens = np.full((rows,), -1, np.int32)
        fn(paths, out, lens)
        return out, lens

    native = decode(NL.decode_batch)
    ref = decode(JNL.decode_batch)
    monkeypatch.setattr(NL, "_load_native", lambda: None)
    python = decode(NL.decode_batch)
    for got in (native, python):
        np.testing.assert_array_equal(got[0], ref[0])
        np.testing.assert_array_equal(got[1], ref[1])
    assert (native[1][:8] > 0).all() and (native[1][8:] == -1).all() and (native[0][8:] == 7.0).all()
    assert (native[1][:8] == 12000).any() and (native[1][:8] < 12000).any()  # clips cut at S, and shorter ones


@pytest.mark.parametrize("branch", ["native", "python"])
def test_decode_missing_file_raises(corpus, monkeypatch, branch):
    if branch == "python":
        monkeypatch.setattr(NL, "_load_native", lambda: None)
    out, lens = np.zeros((2, 100), np.float32), np.zeros((2,), np.int32)
    with pytest.raises(OSError):
        NL.decode_batch([_wav_paths(corpus)[0], "/nonexistent/file.wav"], out, lens)


def test_make_batch_same_on_both_branches(corpus, monkeypatch):
    """The length probe and the batch, with the cache off (every row a
    miss, decoded in one batched call) and on, are equal whichever branch
    decodes; and equal to the JAX package's batch."""
    _, _, tvocab, jdata, tdata = corpus
    utts = tdata["train"].utterances
    idxs = np.asarray([5, 0, 17, 3])

    def batches():
        out = []
        for cache in (False, True):
            ds = BucketedDataset(utts, tvocab, batch_size=8, bucket_boundaries=[14000], max_target_len=4,
                                 cache_audio=cache)
            out.append((ds._lengths, ds.make_batch(idxs, 14000), ds.make_batch(idxs[:2], 14000)))
        return out

    native = batches()
    monkeypatch.setattr(NL, "_load_native", lambda: None)
    python = batches()
    ref = jdata["train"].make_batch(idxs, 14000)
    for (n_len, n_batch, n_again), (p_len, p_batch, p_again) in zip(native, python):
        np.testing.assert_array_equal(n_len, p_len)
        for name in ("audio", "audio_lengths", "targets", "target_lengths", "indices"):
            np.testing.assert_array_equal(getattr(n_batch, name), getattr(p_batch, name), err_msg=name)
            np.testing.assert_array_equal(getattr(n_batch, name), getattr(ref, name), err_msg=name)
            np.testing.assert_array_equal(getattr(n_again, name), getattr(p_again, name), err_msg=name)


def test_concurrent_builds_both_load(tmp_path, corpus):
    """Two processes that build the decoder into one empty directory at the
    same time both load it and decode, and leave one library and no
    temporary file behind."""
    path = _wav_paths(corpus)[0]
    code = (
        "import sys, numpy as np\n"
        "from nn_conformer_for_speech_recognition_tpu_torch.data import native_loader as NL\n"
        "w = NL.load(NL.build(sys.argv[1]))\n"
        "out, lens = np.zeros((1, 20000), np.float32), np.zeros((1,), np.int32)\n"
        "w.decode_batch([sys.argv[2]], out, lens)\n"
        "print(int(lens[0]), w.__name__)\n"
    )
    procs = [subprocess.Popen([sys.executable, "-c", code, str(tmp_path), path], stdout=subprocess.PIPE,
                              stderr=subprocess.PIPE, text=True, cwd=str(NL.PACKAGE_DIR.parent)) for _ in range(2)]
    outs = [p.communicate(timeout=120) for p in procs]
    assert [p.returncode for p in procs] == [0, 0], outs
    lens = {out.split()[0] for out, _ in outs}
    assert len(lens) == 1 and int(lens.pop()) > 0
    assert all(out.split()[1] == NL.MODULE_NAME for out, _ in outs)
    assert sorted(p.name for p in tmp_path.iterdir()) == sorted([NL.library_path(tmp_path).name, "wavio.lock"])
