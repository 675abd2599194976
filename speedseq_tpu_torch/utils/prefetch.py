"""Double-buffered input prefetching (the mbuffer analog).

The reference decouples producer/consumer rates with ``mbuffer -q -m 1G``
(bin/speedseq:1960; src/mbuffer/mbuffer.c).  Here a background thread
reads/parses/pads the next FASTQ (or BAM) batches while the device chews
on the current one, so host IO never stalls the accelerator.
"""

from __future__ import annotations

import queue
import threading
from typing import Iterable, Iterator, TypeVar

T = TypeVar("T")

_SENTINEL = object()


def prefetch(it: Iterable[T], depth: int = 2) -> Iterator[T]:
    """Iterate ``it`` on a background thread with a bounded buffer."""
    q: "queue.Queue" = queue.Queue(maxsize=depth)
    err = []

    def worker():
        try:
            for item in it:
                q.put(item)
        except BaseException as e:  # propagate to consumer
            err.append(e)
        finally:
            q.put(_SENTINEL)

    t = threading.Thread(target=worker, daemon=True)
    t.start()
    while True:
        item = q.get()
        if item is _SENTINEL:
            if err:
                raise err[0]
            return
        yield item

