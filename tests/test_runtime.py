"""Run-time plumbing: the compile-cache rule and the device timer."""

import os

import jax
import jax.numpy as jnp

from stereo_reconstruction_cv_tpu.utils import compile_cache as CC
from stereo_reconstruction_cv_tpu.utils import timing


def _record_updates(monkeypatch):
    calls = []
    monkeypatch.setattr(jax.config, "update", lambda k, v: calls.append((k, v)))
    return calls


def test_cache_follows_environment_variable(monkeypatch, tmp_path):
    """JAX reads JAX_COMPILATION_CACHE_DIR itself: nothing else is set."""
    monkeypatch.setenv(CC.ENV_VAR, str(tmp_path))
    calls = _record_updates(monkeypatch)
    assert CC.enable_compile_cache() == str(tmp_path)
    assert calls == []


def test_cache_defaults_to_checkout(monkeypatch):
    monkeypatch.delenv(CC.ENV_VAR, raising=False)
    calls = _record_updates(monkeypatch)
    path = CC.enable_compile_cache()
    assert path == os.path.join(CC.CHECKOUT, ".jax_cache")
    assert os.path.isfile(os.path.join(CC.CHECKOUT, "chip_smoke.py"))
    assert calls == [("jax_compilation_cache_dir", path)]


def test_warm_time_blocks_on_every_call():
    seen = []

    def fn(x):
        seen.append(1)
        return jnp.sin(x) * 2

    first, warm, out = timing.warm_time(fn, (jnp.ones(8),), iters=4)
    assert first >= 0 and warm >= 0
    assert len(seen) == 5
    assert out.shape == (8,)
    assert timing.timed(fn, (jnp.ones(8),), iters=3) >= 0
