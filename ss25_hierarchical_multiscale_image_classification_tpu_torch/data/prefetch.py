"""Background-thread batch prefetching.

Copy of the JAX package's ``data/prefetch.py`` (``Prefetcher``), held to it
by an exact test on order and content. The host-side batch gather (packed-
store reads, resize) is the serial tail of each device step; ``Prefetcher``
moves it onto a daemon thread with a small bounded queue, so the producer
stays ``depth`` batches ahead of the device.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator

_SENTINEL = object()


class Prefetcher:
    """Wrap any (re-iterable) batch iterable with N-deep thread prefetch."""

    def __init__(self, iterable: Iterable, depth: int = 2):
        self.iterable = iterable
        self.depth = max(1, depth)

    def __len__(self) -> int:
        return len(self.iterable)  # type: ignore[arg-type]

    def __iter__(self) -> Iterator:
        q: queue.Queue = queue.Queue(maxsize=self.depth)
        error: list[BaseException] = []

        def producer():
            try:
                for item in self.iterable:
                    q.put(item)
            except BaseException as e:  # surface in the consumer thread
                error.append(e)
            finally:
                q.put(_SENTINEL)

        thread = threading.Thread(target=producer, daemon=True)
        thread.start()
        while True:
            item = q.get()
            if item is _SENTINEL:
                break
            yield item
        thread.join()
        if error:
            raise error[0]
