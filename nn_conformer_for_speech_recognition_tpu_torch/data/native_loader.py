"""Background prefetch of host-side batches, the ``PrefetchIterator`` of the
JAX package's ``data/native_loader.py``.

The native batched WAV decoder of that module (``decode_batch`` over
``native/wavio.cpp``) is not ported yet: the port reads WAV files through
`data/audio.read_wav`.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, Optional


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
