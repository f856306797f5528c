"""Streaming dataset for 960h-scale corpora (LibriSpeech full, LibriLight),
port of `nn_conformer_for_speech_recognition_tpu/data/streaming.py`.

`BucketedDataset` memoises decoded audio in host RAM: right for
SpeechCommands (1 s clips), impossible for 960 h (≈110 GB of float32
samples).  This subclass streams instead:

  * **no RAM cache**: audio is decoded per batch and dropped after the step;
  * **producer pool → bounded queue**: ``num_workers`` threads assemble
    batches concurrently (each decodes its WAV files in one batched call of
    the native decoder, `data/native_loader.decode_batch`, into a buffer of
    its own), and at
    most ``queue_depth`` ready batches exist at any moment, so host RSS is
    bounded by ``queue_depth · batch_bytes`` regardless of corpus size;
  * **order-preserving**: workers deposit into per-slot boxes and the
    consumer reads them in plan order, so an epoch's batch sequence is
    IDENTICAL to `BucketedDataset.epoch` with the same seed, so resume
    cursors (`train/checkpoint.py`) carry over unchanged;
  * init header-probes files in parallel (inherited `_probe_lengths`), and
    per-host manifest sharding composes via `shard_utterances`.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterator, List, Optional

from nn_conformer_for_speech_recognition_tpu_torch.data.datasets import (
    Batch,
    BucketedDataset,
)


class StreamingDataset(BucketedDataset):
    def __init__(self, *args, num_workers: int = 4, queue_depth: int = 4, **kwargs):
        kwargs["cache_audio"] = False
        super().__init__(*args, **kwargs)
        self.num_workers = max(1, num_workers)
        self.queue_depth = max(1, queue_depth)

    def epoch(self, seed: Optional[int] = None, shuffle: bool = True) -> Iterator[Batch]:
        plan = self._epoch_plan(seed, shuffle)
        n = len(plan)
        if n == 0:
            return
        # tickets bound how far ahead producers run: a worker must take a
        # ticket before assembling a batch, the consumer returns one per
        # batch consumed → ≤ queue_depth + num_workers batches in flight.
        tickets = threading.Semaphore(self.queue_depth)
        boxes: List["queue.Queue[object]"] = [queue.Queue(maxsize=1) for _ in range(n)]
        cursor = threading.Lock()
        next_job = [0]

        def worker():
            while True:
                # ticket BEFORE claiming the job: claiming first can deadlock
                # (a worker holding the lowest unconsumed job blocks on a
                # ticket while the others hold them all; the consumer only
                # releases tickets after consuming that very job)
                tickets.acquire()
                with cursor:
                    j = next_job[0]
                    if j >= n:
                        tickets.release()
                        return
                    next_job[0] = j + 1
                b, idxs = plan[j]
                try:
                    boxes[j].put(self.make_batch(idxs, self.bucket_boundaries[b]))
                except BaseException as e:  # surfaced at the consumer
                    boxes[j].put(e)
                    return

        threads = [
            threading.Thread(target=worker, daemon=True)
            for _ in range(min(self.num_workers, n))
        ]
        for t in threads:
            t.start()
        try:
            for j in range(n):
                item = boxes[j].get()
                tickets.release()
                if isinstance(item, BaseException):
                    raise item
                yield item
        finally:
            # unblock any producer waiting on a ticket so threads exit
            with cursor:
                next_job[0] = n
            for _ in threads:
                tickets.release()
