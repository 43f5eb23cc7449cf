"""Host->device prefetching data loader (SURVEY §2.4 pipelining row).

Streams stereo pairs (or calibration images) to the device while the
previous batch computes: JPEG decode runs in background threads through
the native libjpeg binding (the C call releases the GIL, so decode truly
overlaps), and `jax.device_put` is issued ahead of consumption so the
host->device copy also overlaps. This replaces the
reference's synchronous cv2.imread loop (BASELINE config 5).
"""

from __future__ import annotations

import concurrent.futures
import queue
from typing import Iterator, List, Sequence, Tuple

import jax
import numpy as np

from stereo_reconstruction_cv_tpu import native


def _decode(path: str, gray: bool = True) -> np.ndarray:
    img = native.load_image(path, gray=gray)
    if img is None:  # no native lib / non-jpeg: PIL fallback
        from stereo_reconstruction_cv_tpu.io.image import load_gray, load_rgb

        img = load_gray(path) if gray else load_rgb(path)
    return img


class PrefetchLoader:
    """Iterate batches of decoded images with lookahead.

    items: sequence of path tuples, e.g. [(left0, right0), (left1, right1)].
    Yields tuples of stacked device arrays, one per path column.
    """

    def __init__(
        self,
        items: Sequence[Tuple[str, ...]],
        batch_size: int = 1,
        prefetch: int = 2,
        gray: bool = True,
        sharding=None,
        num_threads: int = 4,
    ):
        self.items = list(items)
        self.batch_size = batch_size
        self.prefetch = max(1, prefetch)
        self.gray = gray
        self.sharding = sharding
        self.pool = concurrent.futures.ThreadPoolExecutor(num_threads)

    def _batches(self) -> List[List[Tuple[str, ...]]]:
        b = self.batch_size
        return [self.items[i : i + b] for i in range(0, len(self.items), b)]

    def _load_batch(self, batch: List[Tuple[str, ...]]):
        ncols = len(batch[0])
        futs = [
            [self.pool.submit(_decode, row[c], self.gray) for row in batch]
            for c in range(ncols)
        ]
        arrays = [np.stack([f.result() for f in col]) for col in futs]
        if self.sharding is not None:
            return tuple(jax.device_put(a, self.sharding) for a in arrays)
        if len({a.shape for a in arrays}) == 1 and ncols > 1:
            # One stacked host->device copy for the whole batch: per-column
            # puts pay the per-transfer setup once per column.
            stacked = jax.device_put(np.stack(arrays))
            return tuple(stacked[c] for c in range(ncols))
        return tuple(jax.device_put(a) for a in arrays)

    def __iter__(self) -> Iterator[Tuple[jax.Array, ...]]:
        batches = self._batches()
        if not batches:
            return
        # Lookahead pipeline: keep `prefetch` batches in flight.
        pending: "queue.Queue" = queue.Queue()
        inflight = [None] * len(batches)

        def submit(i):
            inflight[i] = self.pool.submit(self._load_batch, batches[i])

        for i in range(min(self.prefetch, len(batches))):
            submit(i)
        for i in range(len(batches)):
            nxt = i + self.prefetch
            if nxt < len(batches):
                submit(nxt)
            yield inflight[i].result()

    def __len__(self):
        return (len(self.items) + self.batch_size - 1) // self.batch_size
