"""Every contraction that can change a result runs at the precision named in
``ops/precision.py`` — asserted on the lowered program, where a GPU would
otherwise pick TF32 for a float32 dot left at the default."""
import re

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shadowing_tpu import Identity, RelativeMSE
from shadowing_tpu.models.scattering.moments import _scattering_stats_flat
from shadowing_tpu.models.scattering.wavelets import build_filter_bank
from shadowing_tpu.ops import factored, precision
from shadowing_tpu.ops.sliding import sliding_dot
from shadowing_tpu.pricing.hedged_mc import _hmc_prices
from shadowing_tpu.shadow import engine


def _contractions(fn, *args):
    """The dot_general / convolution ops of ``fn``'s lowered StableHLO."""
    text = jax.jit(fn).lower(*args).as_text()
    ops = [ln for ln in text.splitlines()
           if re.search(r"stablehlo\.(dot_general|convolution)", ln)]
    assert ops, "no contraction found"
    return ops


def _all_highest(ops):
    for op in ops:
        assert "HIGHEST" in op, op


def _y(R=16, T=300):
    return jnp.asarray(np.random.default_rng(0).normal(
        0, 0.02, size=(R, 1, T)).astype(np.float32))


KERNEL = jnp.asarray(Identity(20).kernel)
N_OUT = 300 - 20 - 20 + 1


@pytest.mark.parametrize("name,fn,args", [
    ("window norms, general kernel",
     lambda y, k: engine._window_norms(y, k, n_out=N_OUT, n_splits=1,
                                       identity_fast=False), (_y(), KERNEL)),
    ("window norms, diagonal kernel",
     lambda y, k: engine._window_norms(y, k, n_out=N_OUT, n_splits=1,
                                       identity_fast=True), (_y(), KERNEL)),
    ("combined filters", engine._prep_context,
     (jnp.ones((3, 1, 20)), KERNEL)),
    ("sliding dot at its default", lambda y, k: sliding_dot(y, k, N_OUT),
     (_y(), KERNEL)),
    ("direct oracle",
     lambda y, x, k: engine._direct_search(
         y, x, k, k=4, n_out=N_OUT, n_splits=1, distance=RelativeMSE()),
     (_y(), jnp.ones((2, 20)), KERNEL)),
    ("exact rescore",
     lambda x, p, k: engine._exact_rescore(x, p, k, distance=RelativeMSE()),
     (jnp.ones((2, 20)), jnp.ones((2, 5, 1, 20)), KERNEL)),
    ("hedged-MC regressions",
     lambda p, w, s: _hmc_prices(p, w, s, jnp.float32(1.0), n_basis=6),
     (jnp.ones((64, 11)) + jnp.linspace(0, 1, 64)[:, None],
      jnp.full((64,), 1 / 64), jnp.ones((3,)))),
    ("scattering statistics",
     lambda x, psi: _scattering_stats_flat(x, psi, J=4),
     (jnp.ones((2, 256)), jnp.asarray(build_filter_bank(256, 4).psi_hat))),
])
def test_selection_and_exact_contractions_are_float32(name, fn, args):
    _all_highest(_contractions(fn, *args))


def _factored_problem():
    y = _y(R=32)
    norms = engine._window_norms(y, KERNEL, n_out=N_OUT, n_splits=1,
                                 identity_fast=True)
    y3, n2 = factored.pad_views(y, norms, N_OUT, 20)
    nbt = factored.tiling(32, N_OUT)[1]
    E, nt = factored.build_factored(y3, n2, KERNEL, nbt=nbt)
    return y3, n2, E, nt, nbt


def test_factored_build_and_plain_pass1_are_float32():
    y3, n2, E, nt, nbt = _factored_problem()
    _all_highest(_contractions(
        lambda a, b, k: factored.build_factored(a, b, k, nbt=nbt),
        y3, n2, KERNEL))
    _all_highest(_contractions(factored.blockmin_xla, E, nt,
                               jnp.ones((3, 20))))
    _all_highest(_contractions(
        lambda *a: factored.pass2_from_bmin(*a, k=8, n_out=N_OUT),
        jnp.ones((3, n2.shape[0] * n2.shape[1] // factored.L)), y3, n2,
        jnp.ones((3, 1, 20))))


def test_kernel_product_runs_bf16x3():
    """The Triton kernel's product is precision.KERNEL, a three-product
    bf16 algorithm (lowered here through the interpreter)."""
    assert precision.KERNEL == jax.lax.DotAlgorithmPreset.BF16_BF16_F32_X3
    _, _, E, nt, _ = _factored_problem()
    ops = _contractions(
        lambda e, n, x: factored.blockmin_triton(e, n, x, interpret=True),
        E, nt, jnp.ones((3, 20)))
    for op in ops:
        assert "bf16" in op and "num_primitive_operations = 3" in op, op
