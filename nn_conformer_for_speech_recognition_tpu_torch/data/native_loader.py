"""Native batched WAV decode and background prefetch, port of the JAX
package's ``data/native_loader.py`` (``_load_native``, ``native_available``,
``decode_batch``, ``PrefetchIterator``).

The decoder is the repository's own C++ extension, ``native/wavio.cpp``
(multithreaded, GIL released): `build` compiles it with the host's ``g++``
and the flags of ``native/build.py`` into the package's git-ignored
``_build/`` (named by a hash of the source, the flags and the interpreter's
extension suffix), to a temporary name first and then `os.replace`, under a
file lock, so that processes that build at once never load a half-written
file; `load` imports it under a dotted name of this package's, never the
bare ``wavio`` that the JAX package's loader may already have put in
``sys.modules``.  Where there is no compiler (or the build fails)
``decode_batch`` reads each file through `data/audio.read_wav`, with the
same samples.  This is host I/O: no device is involved.
"""

from __future__ import annotations

import fcntl
import hashlib
import importlib.util
import os
import queue
import subprocess
import sysconfig
import threading
from pathlib import Path
from types import ModuleType
from typing import Iterator, Optional, Sequence

import numpy as np

PACKAGE_DIR = Path(__file__).resolve().parents[1]
BUILD_DIR = PACKAGE_DIR / "_build"
SOURCE = PACKAGE_DIR.parent / "native" / "wavio.cpp"
GXX_FLAGS = ("-O3", "-shared", "-fPIC", "-std=c++17", "-pthread")
MODULE_NAME = f"{PACKAGE_DIR.name}._build.wavio"

_wavio: Optional[ModuleType] = None
_tried = False
_lock = threading.Lock()  # the first callers may be a thread pool's (`BucketedDataset`'s length probe)


def library_path(build_dir: Path = BUILD_DIR) -> Path:
    include = sysconfig.get_path("include")
    digest = hashlib.sha256(" ".join((*GXX_FLAGS, include, sysconfig.get_config_var("EXT_SUFFIX") or "")).encode())
    digest.update(SOURCE.read_bytes())
    return Path(build_dir) / f"wavio-{digest.hexdigest()[:16]}.so"


def build(build_dir: Path = BUILD_DIR) -> Path:
    """Compiles ``native/wavio.cpp`` unless the library for this source,
    these flags and this interpreter exists; returns its path."""
    out = library_path(build_dir)
    if out.exists():
        return out
    out.parent.mkdir(parents=True, exist_ok=True)
    with open(out.parent / "wavio.lock", "w") as lock:
        fcntl.flock(lock, fcntl.LOCK_EX)  # released when the file closes, or when the process dies
        if not out.exists():  # another process may have built it while this one waited
            tmp = out.with_suffix(f".{os.getpid()}.tmp")
            try:
                subprocess.run(["g++", *GXX_FLAGS, f"-I{sysconfig.get_path('include')}", str(SOURCE), "-o", str(tmp)],
                               check=True, capture_output=True)
                os.replace(tmp, out)
            finally:
                tmp.unlink(missing_ok=True)
    return out


def load(path: Path) -> ModuleType:
    """The extension at ``path``, imported as `MODULE_NAME` (its init
    function is found by the name's last part, ``wavio``)."""
    spec = importlib.util.spec_from_file_location(MODULE_NAME, path)
    module = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(module)
    return module


def _load_native() -> Optional[ModuleType]:
    """The decoder, built and loaded once a process; None where it cannot
    be built or loaded."""
    global _wavio, _tried
    with _lock:
        if not _tried:
            _tried = True
            try:
                _wavio = load(build())
            except (OSError, ImportError, subprocess.CalledProcessError):
                _wavio = None
    return _wavio


def native_available() -> bool:
    return _load_native() is not None


def decode_batch(
    paths: Sequence[str],
    out: np.ndarray,
    lengths: np.ndarray,
    num_threads: int = 8,
) -> None:
    """Fill ``out`` (B, S) f32 / ``lengths`` (B,) i32 from WAV files; rows
    beyond ``len(paths)`` are untouched.  A file that cannot be read
    raises ``OSError``."""
    w = _load_native()
    if w is not None:
        w.decode_batch(list(paths), out[: len(paths)], lengths[: len(paths)], num_threads=num_threads)
        return
    from nn_conformer_for_speech_recognition_tpu_torch.data.audio import read_wav

    for i, p in enumerate(paths):
        x, _sr = read_wav(p)
        n = min(len(x), out.shape[1])
        out[i, :n] = x[:n]
        out[i, n:] = 0.0
        lengths[i] = n


class PrefetchIterator:
    """Wrap a batch iterator: produce batches on a background thread so the
    next host-side batch build overlaps device compute.  An exception in
    the producer is raised on the consumer's side, after the batches made
    before it."""

    _SENTINEL = object()

    def __init__(self, iterator: Iterator, depth: int = 2):
        self._q: "queue.Queue" = queue.Queue(maxsize=depth)
        self._err: Optional[BaseException] = None

        def run():
            try:
                for item in iterator:
                    self._q.put(item)
            except BaseException as e:  # surfaced on the consumer side
                self._err = e
            finally:
                self._q.put(self._SENTINEL)

        self._thread = threading.Thread(target=run, daemon=True)
        self._thread.start()

    def __iter__(self):
        return self

    def __next__(self):
        item = self._q.get()
        if item is self._SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item
