"""Acceptance tests: SGBM vs cv2.StereoSGBM (BASELINE gate: within 1 px on
>=95% of jointly-valid pixels), plus unit tests for each stage."""

import cv2
import numpy as np
import jax.numpy as jnp
import pytest

from stereo_reconstruction_cv_tpu.config import SGBMConfig
from stereo_reconstruction_cv_tpu.ops import disparity as DP


def make_stereo_pair(rng, H=120, W=160, dmax=24):
    """Synthetic rectified pair: textured background + shifted foreground."""
    base = rng.uniform(0, 255, size=(H, W + dmax)).astype(np.float32)
    base = cv2.GaussianBlur(base, (5, 5), 1.2) * 2.0 % 255  # texture
    left = base[:, dmax:].copy()
    right = base[:, :-dmax].copy() if dmax else base.copy()
    # ground truth: constant disparity dmax? No: left[x] = base[x+dmax],
    # right[x] = base[x] -> left(x) == right(x + dmax)?? left pixel x matches
    # right pixel x - d with d such that base[x+dmax] == base[x-d+0+...].
    # Simpler: right is left shifted right by d0 -> disparity = d0 everywhere.
    d0 = dmax // 2
    right = np.zeros_like(left)
    right[:, : W - d0] = left[:, d0:]
    right[:, W - d0 :] = left[:, -1:]
    # left pixel x corresponds to right pixel x - d0? right[x] = left[x+d0]
    # -> left[xl] = right[xl - d0]. disparity = d0. yes.
    return left.astype(np.uint8), right.astype(np.uint8), d0


def cv2_sgbm(left, right, cfg: SGBMConfig, mode=None):
    if mode is None:
        mode = cv2.STEREO_SGBM_MODE_SGBM if cfg.num_directions == 5 else cv2.STEREO_SGBM_MODE_HH
    m = cv2.StereoSGBM_create(
        minDisparity=cfg.min_disparity,
        numDisparities=cfg.num_disparities,
        blockSize=cfg.block_size,
        P1=cfg.p1,
        P2=cfg.p2,
        disp12MaxDiff=cfg.disp12_max_diff,
        preFilterCap=cfg.pre_filter_cap,
        uniquenessRatio=cfg.uniqueness_ratio,
        speckleWindowSize=cfg.speckle_window_size,
        speckleRange=cfg.speckle_range,
        mode=mode,
    )
    return m.compute(left, right).astype(np.float32) / 16.0


def agreement(ours_disp, ours_valid, cv_disp, tol=1.0):
    cv_valid = cv_disp > -1 + 1e-6  # cv2 invalid = (mindisp-1)
    both = np.asarray(ours_valid) & cv_valid
    if both.sum() == 0:
        return 0.0, both
    diff = np.abs(np.asarray(ours_disp) - cv_disp)
    return float((diff[both] <= tol).mean()), both


class TestStages:
    def test_xsobel_interior(self, rng):
        img = rng.integers(0, 255, size=(20, 30)).astype(np.uint8)
        out = np.asarray(DP.xsobel_clip(jnp.asarray(img), 63))
        i32 = img.astype(np.int64)
        y, x = 7, 11
        d = (
            (i32[y - 1, x + 1] - i32[y - 1, x - 1])
            + 2 * (i32[y, x + 1] - i32[y, x - 1])
            + (i32[y + 1, x + 1] - i32[y + 1, x - 1])
        )
        assert out[y, x] == np.clip(d, -63, 63) + 63
        assert out.min() >= 0 and out.max() <= 126

    def test_block_sum_matches_boxfilter(self, rng):
        v = rng.uniform(0, 10, size=(17, 23, 3)).astype(np.float32)
        ours = np.asarray(DP.block_sum(jnp.asarray(v), 5))
        for d in range(3):
            ref = cv2.boxFilter(
                v[:, :, d], -1, (5, 5), normalize=False, borderType=cv2.BORDER_REPLICATE
            )
            np.testing.assert_allclose(ours[:, :, d], ref, rtol=1e-5)

    def test_bt_cost_zero_for_identical_at_true_disp(self, rng):
        left, right, d0 = make_stereo_pair(rng)
        sl = DP.xsobel_clip(jnp.asarray(left), 63)
        sr = DP.xsobel_clip(jnp.asarray(right), 63)
        C = np.asarray(DP.bt_cost_volume(sl, sr, jnp.asarray(left), jnp.asarray(right), 16))
        # at the true disparity, interior cost must be zero
        interior = C[2:-2, 40:-8, d0]
        assert (interior == 0).mean() > 0.99

    def test_wta_finds_planted_minimum(self):
        S = np.full((4, 5, 8), 100, np.int32)
        S[:, :, 3] = 10
        disp, valid = DP.wta_disparity(jnp.asarray(S), 0, 0)
        np.testing.assert_allclose(np.asarray(disp), 3.0)
        assert np.asarray(valid).all()

    def test_uniqueness_rejects_ambiguous(self):
        S = np.full((2, 2, 8), 100, np.int32)
        S[:, :, 2] = 10
        S[:, :, 6] = 10  # equal far-away minimum -> ambiguous
        _, valid = DP.wta_disparity(jnp.asarray(S), 0, 10)
        assert not np.asarray(valid).any()

    def test_speckle_removes_small_islands(self):
        disp = np.zeros((30, 30), np.float32)
        valid = np.ones((30, 30), bool)
        disp[10:13, 10:13] = 50.0  # 9-px island, diff 50 > 32 from surround
        keep = np.asarray(
            DP.speckle_filter(jnp.asarray(disp), jnp.asarray(valid), 20, 32.0)
        )
        assert not keep[10:13, 10:13].any()
        assert keep[0, 0] and keep[-1, -1]


class TestVsOpenCV:
    @pytest.mark.parametrize("ndirs", [5, 8])
    def test_synthetic_constant_disparity(self, rng, ndirs):
        left, right, d0 = make_stereo_pair(rng, H=96, W=128, dmax=16)
        cfg = SGBMConfig(
            num_disparities=16, num_directions=ndirs, speckle_window_size=0
        )
        disp, valid = DP.sgbm_disparity(jnp.asarray(left), jnp.asarray(right), cfg)
        cv = cv2_sgbm(left, right, cfg)
        frac, both = agreement(disp, valid, cv)
        assert both.mean() > 0.5, f"too few jointly valid: {both.mean()}"
        assert frac >= 0.95, f"only {frac:.3f} within 1px of cv2 ({ndirs} dirs)"

    def test_real_pair_downscaled(self, rng):
        """The BASELINE gate on real data: dataset/d2 pair, downscaled."""
        imL = cv2.imread("/root/reference/dataset/d2/img1.jpg", cv2.IMREAD_GRAYSCALE)
        imR = cv2.imread("/root/reference/dataset/d2/img2.jpg", cv2.IMREAD_GRAYSCALE)
        assert imL is not None and imR is not None
        imL = cv2.resize(imL, (320, 180))
        imR = cv2.resize(imR, (320, 180))
        cfg = SGBMConfig(num_disparities=32, num_directions=5, speckle_window_size=0)
        disp, valid = DP.sgbm_disparity(jnp.asarray(imL), jnp.asarray(imR), cfg)
        cv = cv2_sgbm(imL, imR, cfg)
        frac, both = agreement(disp, valid, cv)
        assert both.mean() > 0.15, f"too few jointly valid: {both.mean()}"
        assert frac >= 0.95, f"only {frac:.3f} within 1px of cv2 on real pair"

    def test_reference_wrapper_semantics(self, rng):
        left, right, _ = make_stereo_pair(rng, H=64, W=96, dmax=8)
        out = np.asarray(DP.compute_disparity_map(jnp.asarray(left), jnp.asarray(right), 16, 0))
        assert (out >= 0).all()  # non-positive zeroed (cell 10 +38-39)


class TestTiled:
    @pytest.mark.slow
    def test_tiled_matches_untiled(self, rng):
        imL = cv2.resize(cv2.imread("/root/reference/dataset/d2/img1.jpg", 0), (320, 256))
        imR = cv2.resize(cv2.imread("/root/reference/dataset/d2/img2.jpg", 0), (320, 256))
        cfg = SGBMConfig(num_disparities=32, num_directions=8)
        d1, v1 = DP.sgbm_disparity(jnp.asarray(imL), jnp.asarray(imR), cfg)
        d2, v2 = DP.sgbm_disparity_tiled(
            jnp.asarray(imL), jnp.asarray(imR), cfg, tile_rows=96, halo=32
        )
        b = np.asarray(v1) & np.asarray(v2)
        diff = np.abs(np.asarray(d1) - np.asarray(d2))
        assert (diff[b] <= 1).mean() >= 0.99
        iou = (np.asarray(v1) & np.asarray(v2)).sum() / (np.asarray(v1) | np.asarray(v2)).sum()
        assert iou > 0.9


class TestSpeckleExact:
    """speckle_backend='exact' == cv2.filterSpeckles, 100% mask agreement.
    cv2 operates on x16 int16 fixed-point, so both
    filters are fed the same /16-quantized disparities."""

    def _parity(self, imL, imR, cfg):
        core = cfg.with_(speckle_window_size=0)
        disp, valid = DP.sgbm_disparity(jnp.asarray(imL), jnp.asarray(imR), core)
        disp = np.asarray(disp)
        valid = np.asarray(valid)
        d16 = np.round(disp * 16).astype(np.int16)
        dq = d16.astype(np.float32) / 16.0
        # Ours: the jitted exact path on the quantized map.
        import jax

        keep = np.asarray(
            jax.jit(
                lambda d, v: DP.speckle_filter_exact(
                    d, v, cfg.speckle_window_size, float(cfg.speckle_range)
                )
            )(jnp.asarray(dq), jnp.asarray(valid))
        )
        # cv2: int16 fixed point, newVal marks filtered, maxDiff scaled x16.
        INVALID = np.int16((cfg.min_disparity - 1) * 16)
        dcv = np.where(valid, d16, INVALID).astype(np.int16)
        cv2.filterSpeckles(dcv, int(INVALID), cfg.speckle_window_size,
                           16 * cfg.speckle_range)
        keep_cv = valid & (dcv != INVALID)
        agree = np.mean(keep == keep_cv)
        assert agree == 1.0, f"mask agreement {agree:.6f} != 1"

    def test_d2_parity(self):
        # 320x180/32 keeps a real pair's speckle structure while the
        # input-producing SGBM stays inside the fast-tier budget; the
        # full-size parities live in the slow tier below.
        imL = cv2.resize(cv2.imread("/root/reference/dataset/d2/img1.jpg", 0), (320, 180))
        imR = cv2.resize(cv2.imread("/root/reference/dataset/d2/img2.jpg", 0), (320, 180))
        self._parity(imL, imR, SGBMConfig(num_disparities=32))

    @pytest.mark.slow
    def test_4k_parity(self):
        imL = cv2.imread("/root/reference/dataset/d1/img1.jpg", 0)
        imR = cv2.imread("/root/reference/dataset/d1/img2.jpg", 0)
        assert imL.shape == (2160, 3840)
        cfg = SGBMConfig(num_disparities=64)
        core = cfg.with_(speckle_window_size=0)
        disp, valid = DP.sgbm_disparity_tiled(
            jnp.asarray(imL), jnp.asarray(imR), core, tile_rows=512
        )
        disp = np.asarray(disp)
        valid = np.asarray(valid)
        d16 = np.round(disp * 16).astype(np.int16)
        dq = d16.astype(np.float32) / 16.0
        from stereo_reconstruction_cv_tpu import native

        keep = native.filter_speckles(dq, valid, cfg.speckle_window_size,
                                      float(cfg.speckle_range))
        INVALID = np.int16((cfg.min_disparity - 1) * 16)
        dcv = np.where(valid, d16, INVALID).astype(np.int16)
        cv2.filterSpeckles(dcv, int(INVALID), cfg.speckle_window_size,
                           16 * cfg.speckle_range)
        keep_cv = valid & (dcv != INVALID)
        agree = np.mean(keep == keep_cv)
        assert agree == 1.0, f"4K mask agreement {agree:.6f} != 1"


class TestAutoDispatch:
    def test_auto_matches_direct_small(self, rng):
        """sgbm_disparity_auto == sgbm_disparity when the frame fits."""
        base = rng.uniform(0, 255, size=(64, 128 + 16)).astype(np.float32)
        l = jnp.asarray(base[:, 16:].astype(np.uint8))
        r = jnp.asarray(base[:, :-16].astype(np.uint8))
        cfg = SGBMConfig(num_disparities=16, speckle_window_size=0)
        d1, v1 = DP.sgbm_disparity(l, r, cfg)
        d2, v2 = DP.sgbm_disparity_auto(l, r, cfg)
        np.testing.assert_array_equal(np.asarray(d1), np.asarray(d2))
        np.testing.assert_array_equal(np.asarray(v1), np.asarray(v2))


class TestWholeFrameBound:
    """Whole frame vs row tiles, from the device's free memory and the
    compiler's own memory analysis of the whole-frame program."""

    CFG = SGBMConfig(num_disparities=16, speckle_window_size=0)

    def test_bytes_per_cell_from_memory_analysis(self):
        bpc = DP.whole_frame_bytes_per_cell(32, 64, self.CFG)
        # The int16 cost volume alone is 2 B/cell; the int32 aggregate 4.
        assert 6.0 <= bpc < 1000.0

    @pytest.mark.parametrize("free,whole", [(None, True), (10**12, True), (10**4, False)])
    def test_stubbed_limit_decides(self, monkeypatch, free, whole):
        monkeypatch.setattr(DP, "_device_bytes_free", lambda: free)
        assert DP.fits_whole_frame(32, 64, self.CFG) is whole

    def test_auto_tiles_when_the_frame_does_not_fit(self, monkeypatch, rng):
        monkeypatch.setattr(DP, "_device_bytes_free", lambda: 10**4)
        calls = []
        monkeypatch.setattr(DP, "sgbm_disparity_tiled",
                            lambda l, r, cfg, tile_rows: calls.append(tile_rows) or "tiled")
        l = jnp.zeros((32, 64), jnp.uint8)
        assert DP.sgbm_disparity_auto(l, l, self.CFG, tile_rows=16) == "tiled"
        assert calls == [16]

    def test_cpu_reports_no_limit(self):
        assert DP._device_bytes_free() is None


class TestCostBound:
    @pytest.mark.parametrize("cap,block,ok", [(63, 11, True), (103, 11, True),
                                              (104, 11, False), (200, 5, True),
                                              (0, 11, False)])
    def test_int16_block_sum_bound(self, cap, block, ok):
        """block_size^2 * (2*cap + 63) <= 32767: the int16 cost volume
        cannot overflow (121 * (2*104 + 63) = 32791 does)."""
        cfg = SGBMConfig(num_disparities=16, pre_filter_cap=cap, block_size=block,
                         speckle_window_size=0)
        l = jnp.zeros((16, 48), jnp.uint8)
        if ok:
            DP.sgbm_disparity(l, l, cfg)
        else:
            with pytest.raises(ValueError, match="pre_filter_cap"):
                DP.sgbm_disparity(l, l, cfg)


class TestSpeckleConvergent:
    """The device (scan-based, while_loop-to-convergence) speckle filter is
    exact: 100% cv2.filterSpeckles mask agreement."""

    def _agree(self, dq, v):
        from stereo_reconstruction_cv_tpu import native

        keep = np.asarray(DP.speckle_filter(jnp.asarray(dq), jnp.asarray(v), 100, 32.0))
        ref = native.filter_speckles(dq, v.copy(), 100, 32.0)
        return (keep == ref).mean()

    @pytest.mark.slow
    def test_adversarial_percolation_exact(self, rng):
        disp = rng.uniform(0, 64, (240, 320)).astype(np.float32)
        valid = rng.uniform(size=(240, 320)) > 0.35
        assert self._agree(disp, valid) == 1.0

    @pytest.mark.slow
    def test_d2_device_path_exact(self):
        imL = cv2.resize(cv2.imread("/root/reference/dataset/d2/img1.jpg", 0), (640, 360))
        imR = cv2.resize(cv2.imread("/root/reference/dataset/d2/img2.jpg", 0), (640, 360))
        cfg = SGBMConfig(num_disparities=64, speckle_window_size=0)
        d, v = DP.sgbm_disparity(jnp.asarray(imL), jnp.asarray(imR), cfg)
        dq = np.round(np.asarray(d) * 16).astype(np.int16).astype(np.float32) / 16.0
        assert self._agree(dq, np.asarray(v)) == 1.0
