"""Background input prefetch (host threads).

Counterpart of the JAX package's ``data/prefetch.py``: collation (audio
reads, numpy mixing) runs on a host thread ahead of the train loop while
the card runs the previous steps.

  * ``prefetch(it, depth)``: a daemon thread drains ``it`` into a bounded
    queue; items come out in order, and an exception of the producer is
    raised in the consumer after the items before it.
  * ``parallel_map_io``: an order-preserving thread-pool map for audio file
    reads (decoders release the GIL while they read and decode).
"""

from __future__ import annotations

import queue
import threading
from concurrent.futures import ThreadPoolExecutor
from typing import Callable, Iterable, Iterator, List, Optional, Sequence, TypeVar

T = TypeVar("T")
U = TypeVar("U")

_SENTINEL = object()


class PrefetchIterator(Iterator[T]):
    """Iterate ``src`` on a background thread through a bounded queue.

    An exception of the producer is raised in the consumer. The thread is a
    daemon and also stops soon after ``close()``: every put waits on the
    queue with a timeout and gives up once closed.
    """

    def __init__(self, src: Iterable[T], depth: int = 4):
        self._q: queue.Queue = queue.Queue(maxsize=max(depth, 1))
        self._err: Optional[BaseException] = None
        self._closed = threading.Event()
        self._thread = threading.Thread(target=self._produce, args=(iter(src),), daemon=True)
        self._thread.start()

    def _put(self, item) -> bool:
        """Put unless closed first; returns whether it was put."""
        while not self._closed.is_set():
            try:
                self._q.put(item, timeout=0.5)
                return True
            except queue.Full:
                continue
        return False

    def _produce(self, it: Iterator[T]) -> None:
        try:
            for item in it:
                if not self._put(item):
                    return
        except BaseException as e:  # noqa: BLE001 -- raised again in the consumer
            self._err = e
        self._put(_SENTINEL)

    def __iter__(self) -> "PrefetchIterator[T]":
        return self

    def __next__(self) -> T:
        item = self._q.get()
        if item is _SENTINEL:
            if self._err is not None:
                raise self._err
            raise StopIteration
        return item

    def close(self) -> None:
        self._closed.set()


def prefetch(src: Iterable[T], depth: int = 4) -> PrefetchIterator[T]:
    return PrefetchIterator(src, depth)


def parallel_map_io(fn: Callable[[T], U], items: Sequence[T], workers: int = 8) -> List[U]:
    """Order-preserving thread-pool map for IO-bound per-item work."""
    if len(items) <= 1 or workers <= 1:
        return [fn(x) for x in items]
    with ThreadPoolExecutor(max_workers=min(workers, len(items)),
                            thread_name_prefix="audio-io") as pool:
        return list(pool.map(fn, items))
