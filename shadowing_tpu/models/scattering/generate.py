"""Scattering-spectra analysis and dataset generation (public API).

Rebuilds the ``scatspectra`` ``generate`` / ``analyze`` surface consumed by
the reference (``/root/reference/scripts/snp_generation.py:39-50``,
``tutorial.ipynb`` cell 0): estimate scattering-spectra statistics on an
observed series, then synthesise ``R`` independent series matching them,
with on-disk caching compatible with the reference's job-array sharding
(each task writes its own shard; ``batch_npy_files`` regroups).

Scale handling: the statistic vector is estimated on the *standardised*
log-returns (all Phi statistics are scale- and mean-invariant, so this is
lossless), seeds are synthesised at unit scale, and outputs are rescaled by
the observed std/mean. This keeps the optimisation well-conditioned
regardless of the data's units.
"""
from __future__ import annotations

import hashlib
import time
from pathlib import Path
from typing import Optional, Union

import jax
import jax.numpy as jnp
import numpy as np

from shadowing_tpu.array_types import Array
from shadowing_tpu.data.price_data import PriceData
from shadowing_tpu.models.scattering.moments import (
    ScatteringStats,
    scattering_stats,
)
from shadowing_tpu.models.scattering.synthesis import synthesize_batch
from shadowing_tpu.models.scattering.wavelets import build_filter_bank


def _as_log_returns(x: Union[PriceData, Array]) -> np.ndarray:
    if isinstance(x, PriceData):
        dlnx = x.dlnx
    else:
        dlnx = np.asarray(x)
    return np.ravel(dlnx).astype(np.float64)


def analyze(x: Union[PriceData, Array], J: int = 9) -> ScatteringStats:
    """Scattering-spectra statistics of an observed series (log-returns)."""
    dlnx = _as_log_returns(x)
    std = dlnx.std()
    z = (dlnx - dlnx.mean()) / std
    bank = build_filter_bank(len(z), J)
    flat = np.asarray(scattering_stats(jnp.asarray(z, jnp.float32), bank))
    # restore the raw mean/variance in the named view
    flat = flat.copy()
    flat[0] = dlnx.mean() * np.sqrt(len(z)) / std
    flat[1] = np.log(std**2)
    return ScatteringStats(J=J, flat=flat, T=len(z))


def generate(
    x: Union[PriceData, Array],
    R: int = 1,
    J: int = 9,
    T: Optional[int] = None,
    gen_log_returns: bool = True,
    tol_optim: float = 1e-2,
    max_iterations: int = 1000,
    cache_path: Optional[Union[Path, str]] = None,
    load_cache: bool = True,
    verbose: bool = False,
    cuda: Optional[bool] = None,   # API parity; placement is JAX's
    seed: int = 0,
    batch: int = 256,
    lr=None,
    mesh=None,
    init: str = "auto",
    shard_walls: Optional[list] = None,
) -> np.ndarray:
    """Generate ``R`` synthetic log-return trajectories calibrated to ``x``.

    :param x: observed series (``PriceData`` or log-return array)
    :param R: number of trajectories
    :param J: number of dyadic wavelet scales
    :param T: trajectory length (default: next power of two >= observed)
    :param tol_optim: per-seed RMS statistic mismatch target
    :param max_iterations: optimiser step budget per seed
    :param cache_path: directory for the generation cache (shards of
        ``batch`` trajectories, resumable — a crashed run re-uses finished
        shards, the reference's de-facto restart story)
    :param seed: base PRNG seed; shard ``i`` uses ``fold_in(seed, i)`` so
        job-array tasks (reference ``-ntot``/``-tid``) produce disjoint,
        reproducible streams
    :param mesh: synthesise data-parallel over a device mesh (an int device
        count or a ``Mesh`` with a ``"data"`` axis); seeds shard over
        devices, same schedule/results as ``mesh=None`` up to float-ulp
        amplification (see :func:`synthesize_batch`)
    :param init: seed initialisation — ``"auto"`` (default: spectrum
        coloured + per-seed-calibrated MRW volatility envelope, see
        :func:`synthesize_batch`), ``"coloured"`` (spectrum only) or
        ``"white"``
    :param shard_walls: if a list, one ``(wall_seconds, from_cache)`` tuple
        is appended per shard — shard-to-shard variance observability for
        sustained-throughput benchmarks (bench.py ``gen_full_R``)
    :return: ``(R, 1, T)`` float32 log-returns
    """
    del cuda
    if not gen_log_returns:
        raise NotImplementedError(
            "only log-return generation is supported (the reference "
            "workflow, snp_generation.py:41)"
        )
    dlnx = _as_log_returns(x)
    if T is None:
        T = 1 << int(np.ceil(np.log2(len(dlnx))))
    mean, std = dlnx.mean(), dlnx.std()

    # target statistics on the standardised observed series, at length T:
    # wavelet stats are time-averages, so estimating on the (shorter)
    # observed grid and matching on the T grid is consistent scale by scale.
    # The estimation runs on the HOST backend when one exists: a single
    # short series is latency-bound (~ms of FLOPs at an observed-length
    # shape nothing else compiles, so an accelerator would spend its time
    # compiling it), and the CPU result is bit-identical across job-array
    # tasks regardless of their accelerator, so every task derives the
    # same shard-cache tag.
    z_obs = (dlnx - mean) / std
    bank_obs = build_filter_bank(len(z_obs), J)
    try:
        host = jax.devices("cpu")[0]
    except RuntimeError:
        host = None
    if host is not None:
        with jax.default_device(host):
            target = jnp.asarray(np.asarray(
                scattering_stats(jnp.asarray(z_obs, jnp.float32), bank_obs)))
    else:
        target = scattering_stats(jnp.asarray(z_obs, jnp.float32), bank_obs)

    bank_gen = build_filter_bank(T, J)

    cache_dir = None
    if cache_path is not None:
        tag = hashlib.sha1(
            np.asarray(target).tobytes()
            + f"T{T}_J{J}_tol{tol_optim:g}_it{max_iterations}_lr{lr}"
            f"_seed{seed}_b{batch}_init{init}".encode()
        ).hexdigest()[:12]
        cache_dir = Path(cache_path) / f"scatgen_{tag}"
        cache_dir.mkdir(parents=True, exist_ok=True)

    # shards land in a preallocated output (no end-of-run concatenate —
    # at R=32768 x T=4096 that copy plus the out-of-place rescale cost two
    # extra 0.5 GB host passes)
    z_all = np.empty((R, T), np.float32)
    n_shards = -(-R // batch)
    t_start = time.perf_counter()
    for i in range(n_shards):
        t_shard = time.perf_counter()
        shard_file = (
            cache_dir / f"shard{i:05d}.npy" if cache_dir is not None else None
        )
        if load_cache and shard_file is not None and shard_file.exists():
            z = np.load(shard_file)
            if shard_walls is not None:
                shard_walls.append((time.perf_counter() - t_shard, True))
        else:
            key = jax.random.fold_in(jax.random.PRNGKey(seed), i)
            ckpt = (
                cache_dir / f"shard{i:05d}.ckpt.npz"
                if cache_dir is not None else None
            )
            z, rms = synthesize_batch(
                key, target, bank_gen, batch=batch,
                max_iterations=max_iterations, tol=tol_optim, lr=lr,
                verbose=verbose, checkpoint_path=ckpt, mesh=mesh,
                init=init,
            )
            if shard_file is not None:
                np.save(shard_file, z)
            if shard_walls is not None:
                shard_walls.append((time.perf_counter() - t_shard, False))
            if verbose:
                done = min((i + 1) * batch, R)
                rate = done / (time.perf_counter() - t_start)
                print(
                    f"shard {i + 1}/{n_shards}: rms mismatch median "
                    f"{np.median(rms):.4f} | {rate:.1f} paths/s",
                    flush=True,
                )
        r0 = i * batch
        z_all[r0 : min(r0 + batch, R)] = z[: min(batch, R - r0)]
    z_all *= std
    z_all += mean
    return z_all[:, None, :]
