"""The Triton SGM sweeps (ops/pallas/sgm_triton.py) against the XLA scans.

The kernels run here in the Pallas interpreter; on a GPU the same kernels
are compiled by Triton (chip_smoke.py phase (d) checks the bits there).
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from stereo_reconstruction_cv_tpu.config import SGBMConfig
from stereo_reconstruction_cv_tpu.ops import disparity as DP
from stereo_reconstruction_cv_tpu.ops.pallas.sgm_triton import sgm_aggregate_triton

P1, P2 = 200, 800


def _cost(rng, shape):
    return jnp.asarray(rng.integers(0, 3000, size=shape).astype(np.int16))


# (H, Wc, D): a tall frame whose diagonals enter and leave through the top
# and bottom, a wide one where they cross the side edges, and disparity
# counts that are not powers of two (padded lanes along D).
@pytest.mark.parametrize("shape", [(13, 9, 8), (9, 14, 12)])
@pytest.mark.parametrize("direction", DP.DIRS_8)
def test_sweep_matches_scan(rng, shape, direction):
    C = _cost(rng, shape)
    want = DP.sgm_aggregate(C, P1, P2, [direction], chunk=None)
    got = sgm_aggregate_triton(C, P1, P2, [direction], interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


@pytest.mark.parametrize("directions", [DP.DIRS_5, DP.DIRS_8])
def test_all_directions_accumulate_in_place(rng, directions):
    """S accumulates across directions (first writes, later add in place),
    with a band size that does not divide the line count."""
    C = _cost(rng, (10, 11, 16))
    want = DP.sgm_aggregate(C, P1, P2, directions, chunk=None)
    got = sgm_aggregate_triton(C, P1, P2, directions, interpret=True)
    np.testing.assert_array_equal(np.asarray(got), np.asarray(want))


def _lowered_text(cfg, platform):
    C = jax.ShapeDtypeStruct((8, 24, 16), jnp.int16)
    f = jax.jit(lambda c: DP.sgm_aggregate_auto(c, cfg))
    return f.trace(C).lower(lowering_platforms=(platform,)).as_text()


@pytest.mark.parametrize("platform,kernel", [("cuda", True), ("cpu", False)])
def test_aggregation_route_follows_lowering_platform(platform, kernel):
    """sgm_aggregate_auto takes the Triton sweeps exactly when the program
    is lowered for CUDA, whatever the default backend of the process."""
    text = _lowered_text(SGBMConfig(num_disparities=16), platform)
    assert ("__gpu$xla.gpu.triton" in text) == kernel


def test_chunked_scan_never_takes_the_kernel():
    """The chunked (approximate) scan has no kernel: XLA route on CUDA."""
    cfg = SGBMConfig(num_disparities=16, scan_chunk=4, scan_halo=2)
    assert "__gpu$xla.gpu.triton" not in _lowered_text(cfg, "cuda")
