"""XFeat-style model tests: shapes, training step, learned matching sanity."""

import os

import numpy as np
import jax
import jax.numpy as jnp
import pytest

from stereo_reconstruction_cv_tpu.models import xfeat as XF
from stereo_reconstruction_cv_tpu.ops import matching as M


@pytest.fixture(scope="module")
def model():
    return XF.XFeatNet()


@pytest.fixture(scope="module")
def state_tx(model):
    return XF.create_train_state(jax.random.PRNGKey(0), model, (64, 96))


_HERE = os.path.dirname(os.path.abspath(__file__))
_V4 = os.path.join(_HERE, "..", "checkpoints", "xfeat_v4.npz")


class TestPlainJaxNet:
    def test_forward_matches_recorded_outputs(self, model):
        """The shipped checkpoint through the plain-JAX net reproduces the
        outputs recorded from the same weights (f32, precision highest)."""
        from stereo_reconstruction_cv_tpu.models import checkpoint as CK

        params = CK.load_params(_V4)
        z = np.load(os.path.join(_HERE, "data", "xfeat_v4_forward.npz"))
        x = np.stack([z["left"], z["right"]]).astype(np.float32)[..., None] / 255.0
        with jax.default_matmul_precision("highest"):
            logits, desc, rel = model.apply(params, jnp.asarray(x))
        np.testing.assert_allclose(np.asarray(logits), z["logits"], atol=1e-4)
        np.testing.assert_allclose(np.asarray(desc), z["desc"], atol=1e-5)
        np.testing.assert_allclose(np.asarray(rel), z["reliability"], atol=1e-5)

    def test_init_has_the_checkpoint_tree(self, model):
        from stereo_reconstruction_cv_tpu.models import checkpoint as CK

        fresh = model.init(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 1)))
        CK.load_params(_V4, like=fresh)  # raises on any path/shape mismatch

    def test_max_pool_same(self):
        x = jnp.asarray(np.arange(20, dtype=np.float32).reshape(4, 5))
        got = np.asarray(XF.max_pool_same(x, 3))
        want = np.array([[max(x[max(i - 1, 0):i + 2, max(j - 1, 0):j + 2].ravel())
                          for j in range(5)] for i in range(4)])
        np.testing.assert_array_equal(got, want)


class TestNpzCheckpoint:
    def test_roundtrip_by_tree_path(self, tmp_path):
        from stereo_reconstruction_cv_tpu.models import checkpoint as CK

        params = {"params": {"a": {"kernel": jnp.ones((2, 3))},
                             "b": {"bias": jnp.arange(4.0)}}}
        path = str(tmp_path / "ck")
        CK.save_params(path, params)
        assert sorted(np.load(path + ".npz").files) == ["params/a/kernel", "params/b/bias"]
        back = CK.load_params(path, like=params)
        for x, y in zip(jax.tree_util.tree_leaves(params), jax.tree_util.tree_leaves(back)):
            np.testing.assert_array_equal(np.asarray(x), np.asarray(y))

    def test_mismatch_is_refused(self, tmp_path):
        from stereo_reconstruction_cv_tpu.models import checkpoint as CK

        path = str(tmp_path / "ck.npz")
        CK.save_params(path, {"params": {"a": jnp.ones((2, 3))}})
        with pytest.raises(ValueError, match="params/a"):
            CK.load_params(path, like={"params": {"a": jnp.ones((3, 2))}})


@pytest.mark.slow
class TestShapes:
    def test_forward_shapes(self, model, state_tx):
        state, _ = state_tx
        x = jax.random.uniform(jax.random.PRNGKey(5), (2, 64, 96, 1))
        logits, desc, rel = model.apply(state.params, x)
        assert logits.shape == (2, 8, 12, 65)
        assert desc.shape == (2, 8, 12, 64)
        assert rel.shape == (2, 8, 12)
        np.testing.assert_allclose(
            np.asarray(jnp.linalg.norm(desc, axis=-1)), 1.0, atol=1e-4
        )

    def test_detect_static_shapes(self, model, state_tx, rng):
        state, _ = state_tx
        img = rng.integers(0, 255, size=(64, 96)).astype(np.uint8)
        feats = XF.detect(state.params, model, jnp.asarray(img), max_keypoints=128)
        assert feats.keypoints.shape == (128, 2)
        assert feats.descriptors.shape == (128, 64)

    def test_detect_pair_matches_detect(self, model, state_tx, rng):
        """detect_pair (one batched B=2 forward) must reproduce two
        independent detect calls exactly (r4 bench-config-4 path)."""
        state, _ = state_tx
        imL = rng.integers(0, 255, size=(64, 96)).astype(np.uint8)
        imR = rng.integers(0, 255, size=(64, 96)).astype(np.uint8)
        fl, fr = XF.detect_pair(state.params, model, jnp.asarray(imL),
                                jnp.asarray(imR), max_keypoints=64)
        sl = XF.detect(state.params, model, jnp.asarray(imL), max_keypoints=64)
        sr = XF.detect(state.params, model, jnp.asarray(imR), max_keypoints=64)
        for a, b in ((fl, sl), (fr, sr)):
            np.testing.assert_allclose(np.asarray(a.keypoints),
                                       np.asarray(b.keypoints), atol=1e-5)
            np.testing.assert_allclose(np.asarray(a.descriptors),
                                       np.asarray(b.descriptors), atol=1e-5)

    def test_tiled_topk_matches_flat(self, model, state_tx, rng):
        """The 4x4 tile-max reduction before top_k must select the same
        peak set as the flat top_k (NMS guarantees one peak per tile)."""
        state, _ = state_tx
        img = rng.integers(0, 255, size=(64, 96)).astype(np.uint8)
        x = (jnp.asarray(img).astype(jnp.float32) / 255.0)[None, ..., None]
        logits, _, _ = model.apply(state.params, x)
        heat = XF.heatmap_from_logits(logits)[0]
        k = 9
        pooled = XF.max_pool_same(heat, k)
        scores = jnp.where((heat == pooled) & (heat > 0), heat, 0.0)
        H, W = scores.shape
        flat_top, flat_idx = jax.lax.top_k(scores.ravel(), 32)
        feats = XF.detect(state.params, model, jnp.asarray(img),
                          max_keypoints=32, image_refine=False)
        got = {(int(round(float(y))), int(round(float(x_))))
               for (x_, y), s in zip(np.asarray(feats.keypoints),
                                     np.asarray(feats.scores)) if s > 0}
        want = {(int(i) // W, int(i) % W)
                for i, s in zip(np.asarray(flat_idx), np.asarray(flat_top))
                if s > 0}
        assert got == want



@pytest.mark.slow
class TestTraining:
    def test_loss_decreases(self, model, rng):
        state, tx = XF.create_train_state(jax.random.PRNGKey(1), model, (64, 96))
        # textured batch
        imgs = rng.uniform(0, 255, size=(4, 64, 96)).astype(np.float32)
        import scipy.ndimage as ndi

        imgs = np.stack([ndi.gaussian_filter(i, 2.0) * 4 % 255 for i in imgs])
        imgs_j = jnp.asarray(imgs)
        step = jax.jit(lambda s, i, k: XF.train_step(s, tx, model, i, k))
        losses = []
        key = jax.random.PRNGKey(2)
        for it in range(30):
            key, sub = jax.random.split(key)
            state, loss = step(state, imgs_j, sub)
            losses.append(float(loss))
        assert losses[-1] < losses[0] * 0.8, losses[::10]

    def test_harris_teacher_targets(self, rng):
        """The keypoint teacher puts a corner cell's target at the corner
        and sends flat cells to the dustbin (r3: consistency-only training
        left the heatmap flat and keypoints non-repeatable)."""
        img = np.zeros((64, 64), np.float32)
        img[16:, 16:] = 200.0  # one strong corner at (16, 16): cell (2, 2)
        t, resp = XF.harris_cell_targets(jnp.asarray(img)[None])
        t = np.asarray(t[0])
        assert t[2, 2] != 64  # corner cell has a real target position
        assert t[0, 0] == 64  # flat cell -> dustbin
        # in-cell position of the corner target is the corner pixel area
        py, px = divmod(int(t[2, 2]), XF.CELL)
        assert abs((2 * XF.CELL + py) - 16) <= 2
        assert abs((2 * XF.CELL + px) - 16) <= 2

    def test_trained_descriptors_match_under_warp(self, model, rng):
        """After brief training, corresponding cells should be mutual NNs."""
        state, tx = XF.create_train_state(jax.random.PRNGKey(1), model, (64, 96))
        import scipy.ndimage as ndi

        imgs = rng.uniform(0, 255, size=(4, 64, 96)).astype(np.float32)
        imgs = np.stack([ndi.gaussian_filter(i, 1.5) * 6 % 255 for i in imgs])
        imgs_j = jnp.asarray(imgs)
        step = jax.jit(lambda s, i, k: XF.train_step(s, tx, model, i, k))
        key = jax.random.PRNGKey(3)
        for _ in range(60):
            key, sub = jax.random.split(key)
            state, loss = step(state, imgs_j, sub)
        # identity-warp pair: descriptors of the same image must self-match
        x = (imgs_j[:1, ..., None] / 255.0).astype(jnp.float32)
        _, desc, _ = model.apply(state.params, x)
        d = desc[0].reshape(-1, 64)
        res = M.knn2_match(d, d + 0.001, ratio=1.0)
        acc = float(jnp.mean(res.indices == jnp.arange(d.shape[0])))
        assert acc > 0.9, acc
