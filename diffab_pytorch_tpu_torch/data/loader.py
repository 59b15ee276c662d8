"""Host-to-device input pipeline: a prefetch thread and asynchronous
copies (`diffab_pytorch_tpu/data/loader.py`).

A worker thread pulls host batches (CPU tensors, `PatchDataset.batches`)
from the iterator, puts them in page-locked memory and issues their copy
to the card with non_blocking=True on a CUDA stream of its own, up to
`prefetch` batches ahead of the consumer, so that assembly and copy
overlap the current step.  Each batch carries an event recorded after its
copy: the consumer's stream waits on it before the batch is used, and
every tensor is marked with `record_stream` for the consumer's stream, so
the allocator does not hand its memory to a later copy while a step still
reads it.  A worker exception is raised to the consumer.  On the CPU the
batches pass through as they are.
"""

from __future__ import annotations

import dataclasses
import queue
import threading
import time
from typing import Iterable

import torch

_END = object()


class PrefetchLoader:
    """Iterate (batch on `device`, info) over a host iterator of
    (ProteinBatch, info) pairs (or bare batches, info None).
    `batch_seconds`: the worker's time for each batch (assembly, pinning
    and issuing the copy)."""

    def __init__(self, batch_iter: Iterable, device, prefetch: int = 2, sharding=None):
        if sharding is not None:
            raise NotImplementedError("sharded loading is not ported yet (ROADMAP A14, "
                                      "parallelism)")
        self.device = torch.device(device)
        self.batch_seconds: list[float] = []
        self._iter = batch_iter
        self._q: queue.Queue = queue.Queue(maxsize=max(1, prefetch))
        self._stop = threading.Event()
        self._done = False
        self._stream = (torch.cuda.Stream(self.device) if self.device.type == "cuda"
                        else None)
        self._thread = threading.Thread(target=self._worker, daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Queue `item` unless the loader is closed first."""
        while not self._stop.is_set():
            try:
                self._q.put(item, timeout=0.1)
                return True
            except queue.Full:
                continue
        return False

    def _to_device(self, batch):
        if self._stream is None:
            return batch.to(self.device), None
        with torch.cuda.device(self.device), torch.cuda.stream(self._stream):
            out = batch.pin_memory().to(self.device, non_blocking=True)
            event = torch.cuda.Event()
            event.record(self._stream)
        return out, event

    def _worker(self) -> None:
        try:
            it = iter(self._iter)
            while not self._stop.is_set():
                t0 = time.perf_counter()
                try:
                    item = next(it)
                except StopIteration:
                    break
                batch, info = item if isinstance(item, tuple) else (item, None)
                batch, event = self._to_device(batch)
                self.batch_seconds.append(time.perf_counter() - t0)
                if not self._put((batch, info, event)):
                    return
        except Exception as e:  # surfaced to the consumer by __next__
            self._put(e)
        self._put(_END)

    def __iter__(self):
        return self

    def __next__(self):
        if self._done:
            raise StopIteration
        item = self._q.get()
        if item is _END:
            self._done = True
            raise StopIteration
        if isinstance(item, Exception):
            self._done = True
            raise item
        batch, info, event = item
        if event is not None:
            stream = torch.cuda.current_stream(self.device)
            stream.wait_event(event)
            for f in dataclasses.fields(batch):
                v = getattr(batch, f.name)
                if v is not None:
                    v.record_stream(stream)
        return batch, info

    def close(self, timeout: float = 30.0) -> None:
        """Stop the worker, drain the queue and wait for the thread."""
        self._stop.set()
        self._done = True
        deadline = time.monotonic() + timeout
        while True:
            try:
                while True:
                    self._q.get_nowait()
            except queue.Empty:
                pass
            if not self._thread.is_alive():
                return
            if time.monotonic() > deadline:
                raise RuntimeError("the prefetch worker did not stop")
            self._thread.join(timeout=0.1)
