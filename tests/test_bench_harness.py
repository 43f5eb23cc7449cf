"""Benchmark-harness mechanics: headline-first-and-
last emission, per-config alarm caps, suite-budget skips. Uses stub
configs — the real suite runs on the GPU via bench.py."""

import json
import time

import pytest

from stereo_reconstruction_cv_tpu import benchmarks as B


@pytest.fixture()
def stub_configs(monkeypatch):
    calls = []

    def headline():
        calls.append(2)
        return {"metric": "sgbm_disparity_720p_128disp", "value": 1.0,
                "unit": "MPix/s", "vs_baseline": None}

    def quick():
        calls.append(1)
        return {"metric": "quick", "value": 2.0, "unit": "x", "vs_baseline": None}

    def hang():
        calls.append(5)
        time.sleep(30)
        return {"metric": "hang", "value": 0.0, "unit": "x", "vs_baseline": None}

    def boom():
        calls.append(3)
        raise RuntimeError("kaput")

    monkeypatch.setattr(B, "_CONFIGS", {1: quick, 2: headline, 3: boom, 5: hang})
    monkeypatch.setattr(B, "_CAPS", {1: 60, 2: 60, 3: 60, 5: 1})
    return calls


def _emitted(capsys):
    return [json.loads(line) for line in capsys.readouterr().out.splitlines()]


def test_headline_emits_first_and_last(stub_configs, capsys, monkeypatch):
    monkeypatch.setenv("STEREO_BENCH_BUDGET_S", "600")
    assert B.main([2, 1, 3]) == 0
    out = _emitted(capsys)
    assert out[0]["metric"] == "sgbm_disparity_720p_128disp"
    assert out[-1]["metric"] == "sgbm_disparity_720p_128disp"
    # The failing config emits an error line without killing the suite.
    assert any("kaput" in o.get("error", "") for o in out)
    assert stub_configs == [2, 1, 3]


def test_alarm_cap_kills_overrunning_config(stub_configs, capsys, monkeypatch):
    monkeypatch.setenv("STEREO_BENCH_BUDGET_S", "600")
    t0 = time.monotonic()
    assert B.main([2, 5, 1]) == 0
    assert time.monotonic() - t0 < 20  # the 30 s hang was cut at its 1 s cap
    out = _emitted(capsys)
    assert any(o.get("error") == "budget" for o in out)
    # Configs after the overrun still ran; headline still re-emitted last.
    assert any(o["metric"] == "quick" for o in out)
    assert out[-1]["metric"] == "sgbm_disparity_720p_128disp"


def test_suite_budget_skips_remaining(stub_configs, capsys, monkeypatch):
    monkeypatch.setenv("STEREO_BENCH_BUDGET_S", "0")
    assert B.main([2, 1]) == 0
    out = _emitted(capsys)
    assert all("skipped" in o for o in out)
