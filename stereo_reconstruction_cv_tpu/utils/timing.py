"""Device timing: the host clock around work that ends in
`block_until_ready`.

JAX dispatches asynchronously, so a timing that does not wait for the
result measures only the enqueue. Each timed call here blocks on every
output leaf before the clock stops.
"""

from __future__ import annotations

import time

import jax


def warm_time(fn, args, iters: int = 3):
    """Time `fn(*args)`: (seconds of the first call, which compiles; median
    seconds of `iters` further calls; the last output)."""
    t0 = time.perf_counter()
    out = jax.block_until_ready(fn(*args))
    first = time.perf_counter() - t0
    ts = []
    for _ in range(iters):
        out = None  # free the last output before the next call allocates
        t0 = time.perf_counter()
        out = jax.block_until_ready(fn(*args))
        ts.append(time.perf_counter() - t0)
    return first, sorted(ts)[len(ts) // 2], out


def timed(fn, args, iters: int = 5) -> float:
    """Median warm seconds per call of `fn(*args)` (see `warm_time`)."""
    return warm_time(fn, args, iters)[1]
