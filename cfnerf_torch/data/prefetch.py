"""Double-buffered host->device batch prefetch; counterpart of
cfnerf_tpu/data/prefetch.py, with its contract: batches come in step order,
a worker's error surfaces on the consumer's next(), close() stops and joins
the worker.

A background thread samples and uploads batch n+1 while the device runs
step n.  On the card the upload needs one more thing than JAX's device_put:
the current CUDA stream belongs to each thread, so the worker copies on a
stream of its own and records an event after the copy; next() makes the
consumer's current stream wait on that event (on the device, the host does
not block) and marks the batch's tensors as used on the consumer's stream,
so the caching allocator does not hand their memory back to the worker's
stream while the step still reads it.

Spans (utils/trace.py, while a profile records): cfnerf.feed.make around a
batch's make_batch on the worker thread ("cfnerf.feed"), cfnerf.feed.next
around next() on the consumer's, each with its step; the counter feed.empty
counts the next() calls that found no batch ready.
"""
from __future__ import annotations

import queue
import threading
from typing import Any, Callable, Tuple

import torch

from cfnerf_torch.utils.device import DeviceLike, resolve_device
from cfnerf_torch.utils.trace import count, span


def _cuda_tensors(tree):
    if isinstance(tree, torch.Tensor):
        if tree.is_cuda:
            yield tree
    elif isinstance(tree, dict):
        for v in tree.values():
            yield from _cuda_tensors(v)
    elif isinstance(tree, (list, tuple)):
        for v in tree:
            yield from _cuda_tensors(v)


class BatchPrefetcher:
    """Produces (step, device_batch) pairs for steps start+1, start+2, ...

    make_batch(step) runs on the worker thread: it samples the host batch
    AND moves it to `device` (tensors, e.g. with .to(device,
    non_blocking=True) from pinned memory).  With a CUDA device it runs
    under the worker's own stream, and next() orders the consumer's stream
    after the copy.  The device is the CUDA device unless device="cpu" is
    passed (without a CUDA device that raises).  depth=2 is classic double
    buffering: one batch in flight on the device, one staged."""

    def __init__(self, make_batch: Callable[[int], Any], start_step: int,
                 depth: int = 2, device: DeviceLike = None):
        self._make = make_batch
        # (step, batch, the event recorded after its copy or None)
        self._q: queue.Queue = queue.Queue(maxsize=depth)
        self._stop = threading.Event()
        self._error = None
        self._start_step = start_step
        self._next_step = start_step + 1  # the step next() hands out next
        dev = resolve_device(device)
        self._stream = torch.cuda.Stream(dev) if dev.type == "cuda" else None
        self._thread = threading.Thread(target=self._worker, name="cfnerf.feed", daemon=True)
        self._thread.start()

    def _produce(self, step: int):
        with span("cfnerf.feed.make", step):
            if self._stream is None:
                return step, self._make(step), None
            with torch.cuda.stream(self._stream):
                batch = self._make(step)
                copied = torch.cuda.Event()
                copied.record(self._stream)
            return step, batch, copied

    def _worker(self):
        step = self._start_step
        try:
            while not self._stop.is_set():
                step += 1
                item = self._produce(step)
                while not self._stop.is_set():
                    try:
                        self._q.put(item, timeout=0.1)
                        break
                    except queue.Full:
                        continue
        except Exception as e:  # surfaced on the consumer's next() call
            self._error = e

    def next(self) -> Tuple[int, Any]:
        with span("cfnerf.feed.next", self._next_step):
            if self._q.empty():
                count("feed.empty")  # the step will wait for its batch
            while True:
                if self._error is not None:
                    raise self._error
                try:
                    step, batch, copied = self._q.get(timeout=0.5)
                except queue.Empty:
                    if not self._thread.is_alive() and self._error is None:
                        raise RuntimeError("prefetch worker exited unexpectedly")
                    continue
                if copied is not None:
                    consumer = torch.cuda.current_stream(self._stream.device)
                    consumer.wait_event(copied)
                    for t in _cuda_tensors(batch):
                        t.record_stream(consumer)
                self._next_step = step + 1
                return step, batch

    def close(self):
        self._stop.set()
        # drain so a blocked put wakes up
        try:
            while True:
                self._q.get_nowait()
        except queue.Empty:
            pass
        self._thread.join(timeout=2.0)
