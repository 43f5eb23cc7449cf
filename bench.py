"""Benchmark driver shim — the suite lives in the package (cli `bench`).

Runs all five BASELINE.json configs; one JSON line per config, with the
headline metric (720p full 8-path SGBM, 128 disparities) printed LAST:
  {"metric": "sgbm_disparity_720p_128disp", "value": N, "unit": "MPix/s",
   "vs_baseline": N}
vs_baseline is the speedup over cv2 (same parameters) on this host's CPU.
Restrict configs with STEREO_BENCH_CONFIGS=2 (comma-separated) or argv.

A device measurement needs the device: the shim exits non-zero when JAX
finds no GPU, and never falls back to the CPU.
"""

import sys

import jax

from stereo_reconstruction_cv_tpu import benchmarks

if __name__ == "__main__":
    if jax.default_backend() != "gpu":
        sys.exit(f"bench.py: no GPU found (JAX backend {jax.default_backend()!r})")
    sys.exit(benchmarks.main(sys.argv[1:] or None))
