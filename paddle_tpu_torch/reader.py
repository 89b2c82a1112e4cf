"""``paddle.reader`` decorators (counterpart of ``paddle_tpu/reader.py``):
generator combinators of the legacy feeding pipeline."""
from __future__ import annotations

import itertools
import random as _random

__all__ = ["cache", "map_readers", "buffered", "compose", "chain",
           "shuffle", "firstn", "xmap_readers", "multiprocess_reader"]


def cache(reader):
    data = None

    def rd():
        nonlocal data
        if data is None:
            data = list(reader())
        yield from data

    return rd


def map_readers(func, *readers):
    def rd():
        for items in zip(*[r() for r in readers]):
            yield func(*items)

    return rd


def shuffle(reader, buf_size):
    def rd():
        buf = []
        for s in reader():
            buf.append(s)
            if len(buf) >= buf_size:
                _random.shuffle(buf)
                yield from buf
                buf = []
        if buf:
            _random.shuffle(buf)
            yield from buf

    return rd


def chain(*readers):
    def rd():
        for r in readers:
            yield from r()

    return rd


def compose(*readers, **kwargs):
    check_alignment = kwargs.get("check_alignment", True)

    def rd():
        iters = [r() for r in readers]
        for items in (zip(*iters) if check_alignment
                      else itertools.zip_longest(*iters)):
            out = []
            for it in items:
                if isinstance(it, tuple):
                    out.extend(it)
                else:
                    out.append(it)
            yield tuple(out)

    return rd


def buffered(reader, size):
    """Thread-backed prefetch buffer (reference uses a worker thread)."""
    import queue
    import threading

    def rd():
        q = queue.Queue(maxsize=size)
        end = object()

        def produce():
            for s in reader():
                q.put(s)
            q.put(end)

        t = threading.Thread(target=produce, daemon=True)
        t.start()
        while True:
            s = q.get()
            if s is end:
                break
            yield s
        t.join()

    return rd


def firstn(reader, n):
    def rd():
        yield from itertools.islice(reader(), n)

    return rd


def xmap_readers(mapper, reader, process_num, buffer_size, order=False):
    """Thread-pool map over a reader (reference spawns worker threads)."""
    from concurrent.futures import ThreadPoolExecutor

    def rd():
        with ThreadPoolExecutor(max_workers=process_num) as ex:
            it = reader()
            for out in ex.map(mapper, it):
                yield out

    return rd


def multiprocess_reader(readers, use_pipe=True, queue_size=1000):
    return chain(*readers)
