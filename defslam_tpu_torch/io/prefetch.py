"""A threaded prefetching frame reader: the port's counterpart of the JAX
package's native ``FramePipeline`` (``defslam_tpu/native.py``,
``native/frame_pipeline.cc``), in Python threads and numpy.

Worker threads decode images ahead of the tracking loop into a bounded
buffer; frames come out in index order.  Each is decoded to float32 grey
(``io.datasets._imread_gray``: PNGs through ``io.png``), remapped when
rectification maps are given, and resized when its size differs from the
one asked for.  A file that cannot be read (missing, corrupt) gives a zero
frame, as in the native reader; any other error is raised in the consumer.
The decode inflates with the GIL released and runs no per-pixel Python
loop, so the workers leave the tracking thread the GIL most of the time.
"""

from __future__ import annotations

import threading
import time

import numpy as np

from defslam_tpu_torch.io import datasets


class FramePipeline:
    """Iterate to get (index, float32 frame of (height, width)).

    ``stats`` holds one dict per decoded frame (``index``, ``decode_ms``,
    ``remap_ms``, ``resize_ms``, wall times on its worker) and ``wait_s``
    the seconds the consumer waited for each frame it took."""

    def __init__(self, paths: list[str], width: int, height: int, n_threads: int = 3,
                 capacity: int = 8,
                 rectify_maps: tuple[np.ndarray, np.ndarray] | None = None):
        self.paths = list(paths)
        self.width, self.height = width, height
        self.capacity = max(1, capacity)
        if rectify_maps is not None:
            mx = np.ascontiguousarray(rectify_maps[0], np.float32)
            my = np.ascontiguousarray(rectify_maps[1], np.float32)
            if mx.shape != (height, width) or my.shape != (height, width):
                raise ValueError(f"rectification maps of {mx.shape}, not {(height, width)}")
            self._rect = (mx, my)
        else:
            self._rect = None
        self._tables: dict = {}  # remap tables by source image size
        self.stats: list[dict] = []
        self.wait_s: list[float] = []
        self._cond = threading.Condition()
        self._ready: dict[int, np.ndarray] = {}
        self._next_job = 0
        self._next_emit = 0
        self._stop = False
        self._error: BaseException | None = None
        self._workers = [threading.Thread(target=self._work, daemon=True,
                                          name=f"FramePipeline-{i}")
                         for i in range(max(1, n_threads))]
        for t in self._workers:
            t.start()

    def _load(self, index: int) -> np.ndarray:
        t0 = time.perf_counter()
        try:
            img = datasets._imread_gray(self.paths[index])
        except (OSError, ValueError):  # unreadable: a zero frame (frame_pipeline.cc:56)
            img = None
        t1 = time.perf_counter()
        if img is None:
            img = np.zeros((self.height, self.width), np.float32)
        elif self._rect is not None:
            table = self._tables.get(img.shape)
            if table is None:  # once per source size (a race computes it twice, alike)
                table = self._tables[img.shape] = datasets.remap_table(*self._rect, img.shape)
            img = datasets.remap_apply(img, table, (self.height, self.width))
        t2 = time.perf_counter()
        if img.shape != (self.height, self.width):
            img = datasets.resize_linear(img, self.width, self.height)
        t3 = time.perf_counter()
        self.stats.append(dict(index=index, decode_ms=(t1 - t0) * 1e3,
                               remap_ms=(t2 - t1) * 1e3, resize_ms=(t3 - t2) * 1e3))
        return img

    def _work(self) -> None:
        while True:
            with self._cond:
                if self._stop or self._next_job >= len(self.paths):
                    return
                index = self._next_job
                self._next_job += 1
            try:
                img = self._load(index)
            except Exception as e:  # raised in the consumer
                with self._cond:
                    self._error = self._error or e
                    self._cond.notify_all()
                return
            with self._cond:
                # at most ``capacity`` frames ahead of the consumer
                self._cond.wait_for(lambda: self._stop
                                    or index < self._next_emit + self.capacity)
                if self._stop:
                    return
                self._ready[index] = img
                self._cond.notify_all()

    def __iter__(self):
        while True:
            t0 = time.perf_counter()
            with self._cond:
                if self._stop or self._next_emit >= len(self.paths):
                    return
                index = self._next_emit
                self._cond.wait_for(lambda: self._stop or self._error is not None
                                    or index in self._ready)
                if self._error is not None:
                    raise self._error
                if self._stop:
                    return
                img = self._ready.pop(index)
                self._next_emit += 1
                self._cond.notify_all()
            self.wait_s.append(time.perf_counter() - t0)
            yield index, img

    def close(self) -> None:
        """Stop the workers and join them; an iteration in progress ends."""
        with self._cond:
            self._stop = True
            self._cond.notify_all()
        for t in self._workers:
            if t is not threading.current_thread():
                t.join()

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        if hasattr(self, "_workers"):
            self.close()
