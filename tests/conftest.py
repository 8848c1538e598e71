"""Test configuration: run JAX on a virtual 8-device CPU platform.

Must set the environment before the first ``jax`` import anywhere in the
test session. Tests that need a GPU carry the ``gpu`` marker and skip here
(see the ``gpu`` fixture); ``chip_smoke.py`` runs the package on the card.
"""
import os

# force the CPU, unless a GPU run was asked for explicitly
# (`JAX_PLATFORMS=cuda python -m pytest -m gpu tests/` on the card)
if os.environ.get("JAX_PLATFORMS") not in ("cuda", "gpu"):
    os.environ["JAX_PLATFORMS"] = "cpu"
_flags = os.environ.get("XLA_FLAGS", "")
if "xla_force_host_platform_device_count" not in _flags:
    os.environ["XLA_FLAGS"] = (
        _flags + " --xla_force_host_platform_device_count=8"
    ).strip()

import shutil  # noqa: E402
import subprocess  # noqa: E402
import sys  # noqa: E402

import numpy as np  # noqa: E402
import pytest  # noqa: E402
import jax  # noqa: E402


def _ensure_native_built():
    """Build the C shard-loader extension in-place so ``tests/test_native.py``
    runs by default (it used to skip whenever the checked-in tree had no
    built ``.so``). Skipping is only legitimate when no C compiler exists;
    a failed build WITH a compiler present is a real failure and raises.
    Happens at conftest import time so ``pytest.importorskip`` sees the
    extension during collection."""
    try:
        import shadowing_tpu.native  # noqa: F401
        return  # already built and importable
    except ImportError:
        pass
    if not (shutil.which("cc") or shutil.which("gcc") or shutil.which("g++")):
        return  # no toolchain: test_native.py's importorskip fires honestly
    repo = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
    env = {**os.environ, "SHADOWING_TPU_NO_NATIVE": "0"}
    r = subprocess.run(
        [sys.executable, "setup.py", "build_ext", "--inplace"],
        cwd=repo, env=env, capture_output=True, text=True, timeout=300,
    )
    if r.returncode != 0:
        raise RuntimeError(
            "native extension build failed with a compiler present:\n"
            + r.stdout[-2000:] + r.stderr[-2000:]
        )


_ensure_native_built()

# jax may have been imported before this file ran (a plugin, a startup
# hook), in which case the env var above is too late — force the platform
# through the config as well.
jax.config.update("jax_platforms", os.environ["JAX_PLATFORMS"])

# persistent compilation cache makes repeat test runs fast
from shadowing_tpu.utils import enable_compile_cache  # noqa: E402

enable_compile_cache()
jax.config.update("jax_persistent_cache_min_compile_time_secs", 0.5)


def pytest_configure(config):
    config.addinivalue_line(
        "markers", "gpu: needs an NVIDIA GPU; skipped elsewhere (request the "
        "`gpu` fixture). Run them on the card with `JAX_PLATFORMS=cuda "
        "python -m pytest -m gpu tests/`.")


@pytest.fixture()
def rng():
    return np.random.default_rng(0)


@pytest.fixture()
def gpu():
    """Skip unless JAX's default backend is a GPU. Decided here, at test
    time — never while modules import or tests collect, so every worker
    collects the same tests."""
    if jax.default_backend() != "gpu":
        pytest.skip("needs an NVIDIA GPU (JAX default backend is "
                    f"{jax.default_backend()!r})")
