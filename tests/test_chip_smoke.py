"""``chip_smoke.py``: refuses to run without a GPU, and its phases pass at
tiny sizes on the CPU (the card runs them at full size)."""
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest

REPO = Path(__file__).resolve().parents[1]
sys.path.insert(0, str(REPO))
import chip_smoke  # noqa: E402

SZ = chip_smoke.TINY
CLOCK = chip_smoke.Clock("cpu")


@pytest.mark.parametrize("argv", [[], ["--four-cards"]])
def test_exits_nonzero_without_gpu(argv, tmp_path):
    env = {**os.environ, "JAX_PLATFORMS": "cpu"}
    r = subprocess.run([sys.executable, str(REPO / "chip_smoke.py"), *argv],
                       capture_output=True, text=True, env=env, timeout=300,
                       cwd=tmp_path)
    assert r.returncode != 0
    assert '"ok"' not in r.stdout
    assert "no GPU" in r.stderr


@pytest.fixture(scope="module")
def target():
    return chip_smoke.phase_target(SZ, 0, CLOCK)


def test_phase_target(target):
    assert target["engine"].last_metrics["method"] == "direct"  # last call
    assert target["d"].shape == (1, SZ.k)
    assert (np.diff(target["d"], axis=1) >= 0).all()


def test_phase_smile(target):
    chip_smoke.phase_smile(SZ, target, CLOCK)


def test_phase_backtest(target):
    chip_smoke.phase_backtest(SZ, 0, target, CLOCK)


def test_phase_reference():
    chip_smoke.phase_reference(SZ, 0, CLOCK)


def test_phase_generation():
    chip_smoke.phase_generation(SZ, 0, CLOCK)


def test_phase_four_cards():
    chip_smoke.phase_four_cards(SZ, 0, CLOCK)


def test_tie_window_swaps():
    d = np.array([[0.1, 0.2, 0.3]])
    i = np.array([[[0, 1], [0, 2], [0, 3]]])
    assert chip_smoke.tie_window_swaps("same", d, i, d, i) == 0
    # a swap at the cut inside the f32 window is counted
    d2 = np.array([[0.1, 0.2, 0.3 + 1e-7]])
    i2 = np.array([[[0, 1], [0, 2], [5, 5]]])
    assert chip_smoke.tie_window_swaps("tie", d2, i2, d, i) == 1
    # any other difference fails
    d3 = np.array([[0.1, 0.2, 0.29]])
    with pytest.raises(AssertionError, match="tie window"):
        chip_smoke.tie_window_swaps("far", d3, i2, d, i)


def test_host_distances_match_engine(target):
    obj = target["engine"]
    ref = chip_smoke.host_distances(obj, target["ds_host"], target["ctx"],
                                    target["i"])
    np.testing.assert_allclose(target["d"], ref, rtol=1e-5)
