"""Input-pipeline overlap (port of `data/prefetch.py`): a background thread
that runs ahead of the training loop and stages the next batches onto the
device, and an order-preserving threaded map for host-side decode.

    for dev_batch in prefetch_to_device(batches, device, size=2):
        step(state, dev_batch)
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Any, Iterable, Iterator

import torch


class _End:
    pass


class _Raised:
    def __init__(self, exc: BaseException):
        self.exc = exc


def prefetch(iterable: Iterable, size: int = 2) -> Iterator:
    """Run `iterable` in a background thread, buffering up to `size` items.
    Exceptions re-raise at the consumer; the thread is a daemon, so an
    abandoned iterator never blocks interpreter exit."""
    q: "queue.Queue[Any]" = queue.Queue(maxsize=max(1, size))

    def fill():
        try:
            for item in iterable:
                q.put(item)
        except BaseException as e:  # noqa: BLE001 - forwarded to the consumer
            q.put(_Raised(e))
        else:
            q.put(_End)

    threading.Thread(target=fill, daemon=True).start()
    while True:
        item = q.get()
        if item is _End:
            return
        if isinstance(item, _Raised):
            raise item.exc
        yield item


def to_device(batch, device: torch.device) -> torch.Tensor:
    """A host batch (numpy array or tensor) as a contiguous f32 tensor on
    `device`. For a CUDA device the batch goes through pinned memory and a
    non-blocking copy, so the transfer overlaps what the device is running."""
    t = torch.as_tensor(batch, dtype=torch.float32)
    if device.type == "cuda" and t.device.type == "cpu":
        t = t.contiguous().pin_memory()
    return t.to(device, non_blocking=True).contiguous()


def prefetch_to_device(iterable: Iterable, device: torch.device, size: int = 2) -> Iterator:
    """`prefetch` with each batch staged by `to_device` from the background
    thread."""
    return prefetch((to_device(item, device) for item in iterable), size=size)


def parallel_map(fn, items, num_workers: int = 8) -> list:
    """Order-preserving threaded map for host-side decode (the native
    decoder and scipy's release the GIL while they read)."""
    if num_workers <= 1 or len(items) <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=num_workers) as pool:
        return list(pool.map(fn, items))
