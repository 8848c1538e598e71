"""Gradient-based scattering-spectra synthesis (max-entropy generation).

Implements the generation scheme behind the reference's
``snp_generation.py`` (``/root/reference/scripts/snp_generation.py:39-50``):
start from white noise and gradient-descend each seed until its *own*
scattering-spectra statistics match the target vector estimated on the
observed series (the microcanonical model of arXiv:2204.10177).

Design: every seed is an independent optimisation of a length-T vector;
seeds are vmapped into batches and stepped together under one jitted
``lax.scan`` (Adam in normalised coordinates). The loss is the mean squared
mismatch of the ~2+2J+J(J-1)+2|triples| statistics; a seed "converges" when
its RMS mismatch falls below ``tol``.

Converged seeds stop costing FLOPs: between scan segments the host retires
seeds whose RMS fell below ``tol`` and repacks the survivors into the
smallest of at most six bucketed batch shapes (batch, ~b/2, ..., ~b/32), so
straggler-bound batches pay gradients only for the stragglers. The
gather -> Adam-scan -> scatter round trip is one jitted dispatch per segment
(state stays on device; only the per-seed losses reach the host).
"""
from __future__ import annotations

import threading
import time
from functools import partial
from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np

from shadowing_tpu.models.mrw import _sample_stationary
from shadowing_tpu.models.scattering.moments import _scattering_stats_flat
from shadowing_tpu.models.scattering.wavelets import FilterBank


def default_lr_schedule(max_iterations: int) -> tuple:
    """The measured-best schedule: cosine 0.06 -> 0.005 over HALF the step
    budget (most seeds converge well before ``max_iterations``; decaying
    over the full budget leaves the lr needlessly high through the bulk of
    the optimisation). Exposed so callers that pre-warm jit executables
    (bench.py) use the exact static lr tuple the timed runs will."""
    return ("cos", 0.06, 0.005, max(1, max_iterations // 2))


def _lr_at(lr, t):
    """Learning rate at (1-based, float) step ``t``.

    ``lr`` is either a constant float or a cosine schedule tuple
    ``("cos", lr0, lr1, horizon)``: lr0 -> lr1 over ``horizon`` steps.
    Measured on the S&P target (J=9, T=4096, tol 1e-2): cosine
    0.06 -> 0.005 converges ~23% fewer seed-steps than the constant 0.03
    and reaches a higher converged fraction (98% vs 96% at step 1000);
    halving the cosine horizon (see :func:`default_lr_schedule`) and the
    faster second-moment decay in :func:`_adam_scan` together cut a
    further ~25% (9.1k -> 6.7k seed-steps per 32 at 25-step resolution,
    two seeds).
    """
    if isinstance(lr, tuple):
        _, lr0, lr1, horizon = lr
        frac = jnp.minimum(t / float(horizon), 1.0)
        return lr1 + (lr0 - lr1) * 0.5 * (1.0 + jnp.cos(jnp.pi * frac))
    return lr


def _standardize(z):
    z = z - z.mean(axis=-1, keepdims=True)
    return z / z.std(axis=-1, keepdims=True)


#: jitted twin for host-loop call sites (one dispatch instead of one per
#: eager jnp op)
_standardize_jit = jax.jit(_standardize)


@jax.jit
def _standardize_rows(z, idx):
    """Standardized view of ``z[idx]`` — the end-of-run splice fetch for
    rows still being optimised when the overlapped output snapshot was
    taken (see ``synthesize_batch``). Single-axis ROW gather with a
    contiguous last dim."""
    return _standardize(z[idx])


def should_standardize(target) -> bool:
    """True when the target's mean/logvar entries say "standardized series"
    (|mean| and |logvar| ~ 0) — then the in-loss projection of
    :func:`_adam_scan` is exact and synthesize_batch enables it. Exposed so
    executable warm-ups (bench.py) key their jits the same way."""
    return bool(abs(float(target[0])) < 1e-3 and abs(float(target[1])) < 1e-3)


def _adam_scan(z, m, v, i0, target, psi_hat, J, n_steps, lr, bands=None,
               standardize=False):
    """``n_steps`` Adam steps on a (B, T) seed batch (trace-time body).

    ``b2=0.95``: the loss is deterministic (no minibatch noise), so the
    second moment only tracks curvature — a short memory adapts the
    per-coordinate scale faster. Measured on the S&P target (J=9, T=4096,
    tol 1e-2, batch 32, two seeds): ~11% fewer seed-steps than 0.999 at
    the same 100% converged fraction, independent of the lr schedule.

    ``standardize``: evaluate the statistics on the per-seed standardized
    series (gradients flow through the projection). Valid when the target
    itself is standardized (mean/logvar entries ~0 — callers rescale the
    output, so seeds are *defined* as normalised series): the mean/logvar
    statistics are then matched exactly by construction instead of by
    gradient descent. Profiling showed the seed means drifting while Adam
    fixes the other statistics and then converging SLOWEST of all families
    (~40% of the remaining squared error at step 200); projecting them out
    measured ~28% fewer seed-steps (5.4k/4.8k -> 3.9k/3.4k per 32, two
    seeds, auto init).
    """
    b1, b2, eps = 0.9, 0.95, 1e-8

    def loss_fn(z):
        zs = _standardize(z) if standardize else z
        stats = _scattering_stats_flat(zs, psi_hat, J=J, bands=bands)
        # sum of per-seed means: gradients don't depend on the batch split
        return ((stats - target[None]) ** 2).mean(axis=-1).sum(), stats

    def per_seed_loss(stats):
        return ((stats - target[None]) ** 2).mean(axis=-1)

    def step(carry, i):
        z, m, v = carry
        (_, stats), g = jax.value_and_grad(loss_fn, has_aux=True)(z)
        m = b1 * m + (1 - b1) * g
        v = b2 * v + (1 - b2) * g**2
        t = (i0 + i + 1).astype(jnp.float32)
        mh = m / (1 - b1**t)
        vh = v / (1 - b2**t)
        z = z - _lr_at(lr, t) * mh / (jnp.sqrt(vh) + eps)
        return (z, m, v), None

    (z, m, v), _ = jax.lax.scan(step, (z, m, v), jnp.arange(n_steps))
    _, stats = loss_fn(z)
    return z, m, v, per_seed_loss(stats)


def _adam_scan_chunked(z, m, v, i0, target, psi_hat, J, n_steps, lr,
                       bands=None, standardize=False, chunk=0):
    """:func:`_adam_scan`, row-chunked INSIDE the program when the batch
    exceeds ``chunk`` rows: per-seed math is independent, so the batch is
    reshaped to (nc, chunk, T) and the scan ``lax.map``-ed over chunks —
    one dispatch, same executable count (see ``_SEG_CHUNK`` for the chunk
    size). ``chunk=0`` (or an indivisible batch, or any sharded/mesh run —
    the reshape would cross shards) keeps the plain single-scan form."""
    B = z.shape[0]
    if not chunk or B <= chunk or B % chunk:
        return _adam_scan(z, m, v, i0, target, psi_hat, J, n_steps, lr,
                          bands, standardize)
    nc = B // chunk

    def one(args):
        zc, mc, vc = args
        return _adam_scan(zc, mc, vc, i0, target, psi_hat, J, n_steps, lr,
                          bands, standardize)

    r3 = lambda a: a.reshape(nc, chunk, a.shape[-1])
    zc, mc, vc, lc = jax.lax.map(one, (r3(z), r3(m), r3(v)))
    return (zc.reshape(z.shape), mc.reshape(m.shape), vc.reshape(v.shape),
            lc.reshape(B))


@partial(jax.jit, static_argnames=("J", "n_steps", "lr", "bands",
                                   "standardize", "chunk"))
def _optimize_segment(
    z: jax.Array,          # (B, T) normalised series being optimised
    m: jax.Array,          # Adam state
    v: jax.Array,
    i0: jax.Array,         # () step offset
    target: jax.Array,     # (n_stats,)
    psi_hat: jax.Array,    # (J, T)
    J: int,
    n_steps: int,
    lr: float = 0.03,
    bands: tuple = None,   # per-scale support bins (FilterBank.band_hi)
    standardize: bool = False,  # see _adam_scan
    chunk: int = 0,        # in-program row chunking (_adam_scan_chunked)
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Run ``n_steps`` Adam steps on the full batch; returns (z, m, v, loss)."""
    return _adam_scan_chunked(z, m, v, i0, target, psi_hat, J, n_steps, lr,
                              bands, standardize, chunk)


@partial(jax.jit, static_argnames=("J", "n_steps", "lr", "bands",
                                   "standardize", "chunk"))
def _optimize_segment_compact(
    z_full: jax.Array,     # (batch, T) all seeds (converged ones frozen)
    m_full: jax.Array,
    v_full: jax.Array,
    idx: jax.Array,        # (nb,) int32 rows to step; padded by cycling the
    #                        active rows, so duplicate indices carry
    #                        *identical* values and the scatter is exact
    i0: jax.Array,
    target: jax.Array,
    psi_hat: jax.Array,
    J: int,
    n_steps: int,
    lr: float = 0.03,
    bands: tuple = None,
    standardize: bool = False,  # see _adam_scan
    chunk: int = 0,        # in-program row chunking (_adam_scan_chunked)
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """Gather the active seeds, Adam-step them, scatter back — one dispatch.

    Compile cost is keyed by ``(nb, n_steps)``; the caller quantises ``nb``
    to at most six bucket sizes so retirement never causes a recompile
    cascade.
    """
    z, m, v, losses = _adam_scan_chunked(
        z_full[idx], m_full[idx], v_full[idx], i0, target, psi_hat,
        J, n_steps, lr, bands, standardize, chunk,
    )
    return (
        z_full.at[idx].set(z),
        m_full.at[idx].set(m),
        v_full.at[idx].set(v),
        losses,
    )


@partial(jax.jit, static_argnames=("J", "sub_steps", "lr", "bands",
                                   "standardize", "chunk"))
def _optimize_drain(
    z_full: jax.Array,     # (batch, T) all seeds (converged ones frozen)
    m_full: jax.Array,
    v_full: jax.Array,
    idx: jax.Array,        # (nb,) int32 rows to drain (padded by cycling)
    i0: jax.Array,         # () f32 global step offset at drain entry
    budget_subs: jax.Array,  # () int32 sub-segments the step budget allows
    tol: jax.Array,        # () f32 convergence threshold on the RMS
    target: jax.Array,
    psi_hat: jax.Array,
    J: int,
    sub_steps: int,        # retirement granularity inside the drain
    lr=0.03,
    bands: tuple = None,
    standardize: bool = False,
    chunk: int = 0,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array, jax.Array]:
    """ONE-dispatch straggler drain: gather the last active rows, then run
    ``sub_steps``-long Adam sub-segments under a ``lax.while_loop`` that
    freezes each row the moment its RMS falls below ``tol`` and exits as
    soon as every row is frozen (or the step budget runs out).

    Rationale: small-bucket segments are dominated by their fixed
    per-dispatch cost and host sync, not by compute, so the host-driven
    drain paid that cost 4-8 times per run. Fusing the whole drain into one
    dispatch pays it once, and freezing at every ``sub_steps`` boundary is
    FINER retirement granularity than the host loop's
    ``_drain_factor``-lengthened segments (fewer overstepped seed-steps,
    not more). Frozen rows still occupy their bucket row (static shapes) —
    exactly like bucket padding, and counted as paid the same way.

    Returns ``(z_full, m_full, v_full, losses, n_subs)`` where ``losses``
    holds each drained row's loss at freeze time (recomputing a frozen
    row's loss is a fixpoint, so no masking is needed beyond the update)
    and ``n_subs`` is the number of sub-segments actually executed.
    """
    z, m, v = z_full[idx], m_full[idx], v_full[idx]
    nb = z.shape[0]
    tol2 = tol * tol  # losses are squared-RMS

    def cond(c):
        _, _, _, frozen, _, k = c
        return (k < budget_subs) & jnp.logical_not(frozen.all())

    def body(c):
        z, m, v, frozen, losses, k = c
        i = i0 + (k * sub_steps).astype(jnp.float32)
        z2, m2, v2, l2 = _adam_scan_chunked(
            z, m, v, i, target, psi_hat, J, sub_steps, lr,
            bands, standardize, chunk,
        )
        keep = frozen[:, None]
        z = jnp.where(keep, z, z2)
        m = jnp.where(keep, m, m2)
        v = jnp.where(keep, v, v2)
        losses = jnp.where(frozen, losses, l2)
        frozen = frozen | (losses < tol2)
        return (z, m, v, frozen, losses, k + 1)

    init = (z, m, v,
            jnp.zeros((nb,), bool),
            jnp.full((nb,), jnp.inf, jnp.float32),
            jnp.asarray(0, jnp.int32))
    z, m, v, frozen, losses, k = jax.lax.while_loop(cond, body, init)
    return (z_full.at[idx].set(z), m_full.at[idx].set(m),
            v_full.at[idx].set(v), losses, k)


def _colour_filter(target: jax.Array, psi_hat: jax.Array, J: int) -> jax.Array:
    """Spectral colouring ``H(w)`` that maps unit white noise to the
    target's per-scale wavelet powers.

    The target vector stores ``logpower_j = log(<|W_j x|^2> / Var)``
    (moments.py layout: [mean, logvar, logpower(J), ...]). For white noise
    ``<|W_j z|^2> = mean_w |psi_j|^2``, so shaping the seed spectrum by

        H(w)^2 = sum_j u_j(w) * target_p2_j / white_p2_j,
        u_j(w) = |psi_j(w)|^2 / sum_k |psi_k(w)|^2   (soft scale assignment)

    starts the optimisation with Phi_2 already matched (H = 1 on bins no
    wavelet covers); Adam only has to fix phase/envelope statistics.
    Measured at the reference config (J=9, T=4096, tol 1e-2): ~28% fewer
    seed-steps to the same converged fraction vs white-noise init.
    """
    p2_target = jnp.exp(target[2 : 2 + J])               # (J,)
    S = jnp.abs(psi_hat) ** 2                            # (J, T)
    p2_white = S.mean(axis=-1)                           # (J,)
    tot = S.sum(axis=0)                                  # (T,)
    u = S / jnp.maximum(tot, 1e-20)[None]
    T = psi_hat.shape[-1]
    mirror = jnp.minimum(jnp.arange(T), T - jnp.arange(T))
    # overlapping wavelets mix the per-scale ratios, so refine by fixpoint:
    # predict the coloured powers analytically and correct multiplicatively
    # (3 rounds leave the start log-power within ~0.1 of target, tested)
    r = p2_target / jnp.maximum(p2_white, 1e-30)
    for _ in range(3):
        h2 = jnp.where(tot > 1e-12, (u * r[:, None]).sum(0), 1.0)
        h2m = h2[mirror]                                 # Hermitian
        varc = h2m.mean()                                # Var of coloured z
        achieved = (S * h2[None]).mean(-1) / jnp.maximum(varc, 1e-30)
        r = r * p2_target / jnp.maximum(achieved, 1e-30)
    h2 = jnp.where(tot > 1e-12, (u * r[:, None]).sum(0), 1.0)
    # analytic filters only define H on non-negative bins: mirror onto the
    # negative half so the coloured spectrum stays Hermitian (real output)
    return jnp.sqrt(h2)[mirror]                          # (T,) real, even


@partial(jax.jit, static_argnames=("batch", "T", "J"))
def _coloured_noise(key, batch, T, target, psi_hat, J):
    """Unit-variance coloured Gaussian seeds matching the target spectrum."""
    z = jax.random.normal(key, (batch, T), jnp.float32)
    H = _colour_filter(target, psi_hat, J)
    zf = jnp.fft.fft(z, axis=-1) * H[None]
    z = jnp.real(jnp.fft.ifft(zf, axis=-1))
    z = z - z.mean(axis=-1, keepdims=True)
    return z / z.std(axis=-1, keepdims=True)


# intermittency grid for the auto-calibrated init: 0.0 = plain coloured
# noise (Gaussian envelopes), so non-intermittent targets never regress
_INIT_LAMBDAS = (0.0, 0.15, 0.25, 0.35)


@partial(jax.jit, static_argnames=("batch", "T", "J", "bands"))
def _calibrated_seeds(key, batch, T, target, psi_hat, J, sq_oms, bands=None):
    """Coloured seeds modulated by a log-normal (MRW-style) volatility
    envelope, intermittency picked PER SEED by initial loss.

    Coloured Gaussian noise matches the target spectrum (Phi_2) but starts
    with Gaussian envelopes — zero envelope correlations (Phi_4), zero
    phase-envelope terms (Phi_3), sparsity pinned at the Gaussian pi/4.
    Financial targets are intermittent; multiplying by ``exp(omega)`` with
    ``omega`` log-correlated (the Bacry–Muzy–Delour MRW volatility field,
    reused from ``models/mrw.py``) starts those statistics near-matched
    too. Each seed keeps the candidate (one per ``_INIT_LAMBDAS`` entry,
    same underlying noise) with the smallest initial mismatch — one jitted
    dispatch, ~len(grid) forward evals, repaying itself ~40x over.
    Measured (S&P target, J=9, T=4096, tol 1e-2, two seeds, with the
    b2=0.95 / half-horizon optimizer): ~6.8k -> ~5.1k seed-steps per 32.
    """
    k1, k2 = jax.random.split(key)
    zc = _coloured_noise(k1, batch, T, target, psi_hat, J)

    def one(sq_om):
        # no MRW-style mean shift on omega: a constant factor exp(mean_om)
        # on z cancels exactly in the per-seed standardization below
        om = _sample_stationary(k2, sq_om, T, batch)
        z = zc * jnp.exp(om)
        z = z - z.mean(axis=-1, keepdims=True)
        return z / z.std(axis=-1, keepdims=True)

    cands = jnp.stack(
        [zc] + [one(sq_oms[i]) for i in range(sq_oms.shape[0])]
    )                                                    # (n_cand, B, T)

    def loss_of(z):
        stats = _scattering_stats_flat(z, psi_hat, J=J, bands=bands)
        return ((stats - target[None]) ** 2).mean(axis=-1)

    losses = jax.vmap(loss_of)(cands)                    # (n_cand, B)
    best = jnp.argmin(losses, axis=0)                    # (B,)
    return jnp.take_along_axis(cands, best[None, :, None], axis=0)[0]


#: device-resident constants reused across synthesize_batch calls, so a call
#: does not re-upload the filter bank (~300 KB) and envelope spectra
#: (~100 KB). Keyed by the deterministic build parameters.
_DEV_CONST_CACHE: dict = {}


def _dev_cached(key, build):
    arr = _DEV_CONST_CACHE.get(key)
    if arr is None or arr.is_deleted():
        arr = build()
        _DEV_CONST_CACHE[key] = arr
    return arr


def _psi_device(bank: FilterBank) -> jax.Array:
    # keyed by filter CONTENT, not just (T, J): two banks with the same
    # geometry but different psi_hat (custom filters, in-place edits) must
    # not alias each other's device copy — the optimiser would silently run
    # against the wrong filters while ``bands`` came from the new bank.
    # Digesting the (J, T) float32 block costs ~0.1 ms per synthesize_batch
    # call, amortised over the whole optimisation.
    import hashlib

    digest = hashlib.sha1(np.ascontiguousarray(bank.psi_hat)).hexdigest()
    return _dev_cached(("psi", bank.T, bank.J, digest),
                       lambda: jnp.asarray(bank.psi_hat))


def _auto_seeds(key, batch, T, target, psi_hat, J, bands=None):
    """Host wrapper: precompute the envelope circulant spectra (numpy FFTs,
    one per non-zero grid entry) and call the jitted candidate selection."""
    from shadowing_tpu.models.mrw import (
        _circulant_sqrt_spectrum,
        _omega_cov,
    )

    def build():
        lams = [l for l in _INIT_LAMBDAS if l > 0.0]
        sq = [_circulant_sqrt_spectrum(_omega_cov(T, lam, T)) for lam in lams]
        return jnp.asarray(np.stack(sq), jnp.float32)

    return _calibrated_seeds(
        key, batch, T, target, psi_hat, J,
        _dev_cached(("sq_oms", T), build),
        bands=bands,
    )


def _bucket_sizes(batch: int, quantum: int = 1) -> list:
    """Descending batch buckets: [batch, ~b/2, ..., ~b/32] (<= 6 shapes),
    each rounded up to a multiple of ``quantum`` (the mesh size, so every
    bucketed gather keeps an even per-device row count). Six halvings keep
    the compile count bounded while letting straggler-tail segments run
    near the true active-set size (4 levels left the last ~300 steps of a
    256-seed run paying a 32-wide bucket for a handful of seeds)."""
    q = max(1, quantum)
    rnd = lambda n: -(-n // q) * q
    sizes = [rnd(batch)]
    while sizes[-1] > q and len(sizes) < 6:
        nxt = rnd(-(-sizes[-1] // 2))
        if nxt == sizes[-1]:
            break
        sizes.append(nxt)
    return sizes


def _bucket(n: int, sizes: list) -> int:
    """Smallest listed bucket >= n."""
    for s in reversed(sizes):
        if s >= n:
            return s
    return sizes[0]


#: in-program row-chunk size for segment executables: bigger batches
#: lax.map the Adam scan over 128-row chunks INSIDE one dispatch (see
#: _adam_scan_chunked). The value was tuned for another accelerator and is
#: queued for measurement on the GPU (ROADMAP A9). Mesh runs never chunk
#: (the reshape would cross the batch sharding).
_SEG_CHUNK = 128


def _drain_factor(n_active: int, batch: int) -> int:
    """Segment-length multiplier for the straggler drain.

    Once the active set is a small fraction of the batch, a tail segment
    computes in less time than its host sync, so retirement granularity
    buys nothing — the drain is sync-bound. Lengthening drain segments cuts
    the syncs;
    overstepping a seed that converges mid-segment costs only its own
    tiny-bucket seed-steps. A pure function of the TRUE active count (not
    the bucket size), so single-device and mesh runs keep identical
    schedules (the mesh-invariance contract)."""
    if n_active * 16 <= batch:
        return 4
    if n_active * 8 <= batch:
        return 2
    return 1


#: Bridge-segment length: the short segment submitted while a LARGE
#: segment's losses are still in flight (compact runs only). Mass
#: retirement happens at large-segment boundaries; harvesting them
#: synchronously idles the device for the fetch + redispatch, while
#: lagging them a full tail segment pays every retiring seed ~25 stale
#: steps (measured +18% seed-steps when everything was full-length-lagged).
#: A 16-step bridge keeps the device fed across the harvest and costs a
#: retiring seed only 16 stale steps. Retirement is then observed one
#: bridge late; re-entry semantics are unchanged (the bridge's refreshed
#: losses are harvested like any segment's).
_BRIDGE = 16


def _tail_segment(segment: int) -> int:
    """Segment length after the first segment: ``segment // 4`` (>= 25).

    Retirement is only observed at segment boundaries, so granularity is
    wasted seed-steps: with the calibrated init + standardized loss the
    retirement curve is steep (nobody converges in the first ~75 steps,
    ~45% by 100, ~97% by 150 at the production config), and a flat
    ``segment=100`` schedule pays every seed to the NEXT boundary past its
    convergence (measured 52k seed-steps where the curve's integral is
    ~29k). Quarter-length tail segments recover most of that at the cost
    of a few extra per-segment host syncs; the first segment stays long
    because nothing retires early anyway. Compile count is unchanged: the
    tail length replaces the full length in the compact-bucket executables
    (one ``n_steps`` value each for full and tail). Exposed to bench.py so
    its warm-up compiles the same shapes."""
    return max(25, segment // 4)


def warmup_executables(target, bank, batch: int, segment: int = 100,
                       max_iterations: int = 1000, lr=None,
                       compact: bool = True,
                       fused_drain: bool = True) -> int:
    """Compile + program-load every single-device segment executable a
    ``synthesize_batch`` run with these parameters can dispatch (one short
    blocking call per distinct ``(rows, n_steps, path)`` key).

    Warm-up code (bench.py) must hit the EXACT executables the timed runs
    will, or a missed shape's compile lands inside the measurement.
    Enumerates the dispatch
    policy of the segment loop: bucketed shapes, the in-program row
    chunking, and the drain-lengthened ``n_steps``
    (:func:`_drain_factor`). Returns the number of executables touched.
    Budget-cap remainder shapes (a run hitting ``max_iterations``
    mid-segment) are not enumerable and stay cold. Mesh runs dispatch
    differently (no chunking, sharded programs) — not covered.
    """
    if lr is None:
        lr = default_lr_schedule(max_iterations)
    std = should_standardize(target)
    psi = _psi_device(bank)
    z0 = jnp.zeros((batch, bank.T), jnp.float32)
    bands = bank.band_hi or None
    sizes = _bucket_sizes(batch)
    tail = _tail_segment(segment)
    seen = set()

    def touch(nb, n, use_compact):
        key = (nb, n, use_compact)
        if key in seen:
            return
        seen.add(key)
        if use_compact:
            out = _optimize_segment_compact(
                z0, z0, z0, jnp.zeros((nb,), jnp.int32), jnp.asarray(0, jnp.float32),
                target, psi, J=bank.J, n_steps=n, lr=lr, bands=bands,
                standardize=std, chunk=_SEG_CHUNK,
            )
        else:
            out = _optimize_segment(
                z0[:nb], z0[:nb], z0[:nb], jnp.asarray(0, jnp.float32), target, psi,
                J=bank.J, n_steps=n, lr=lr, bands=bands, standardize=std,
                chunk=_SEG_CHUNK,
            )
        np.asarray(out[-1][:1])  # block on a tiny fetch

    def touch_drain(nb):
        key = ("drain", nb, tail)
        if key in seen:
            return
        seen.add(key)
        # budget_subs=0: the while_loop exits immediately, so the dispatch
        # pays the compile (the point of warm-up) at ~zero compute. Scalar construction mirrors the run EXACTLY (strong f32
        # i0/tol, strong int32 budget) — weak-typed scalars key DIFFERENT
        # executables (see the jit-key note in CLAUDE.md).
        out = _optimize_drain(
            z0, z0, z0, jnp.zeros((nb,), jnp.int32),
            jnp.asarray(0, jnp.float32), jnp.asarray(0, jnp.int32),
            jnp.asarray(0.01, jnp.float32), target, psi,
            J=bank.J, sub_steps=tail, lr=lr, bands=bands,
            standardize=std, chunk=_SEG_CHUNK,
        )
        np.asarray(out[-1])  # block on the (scalar) sub-segment count

    # with the fused drain, every active set <= batch/8 is handled by ONE
    # _optimize_drain executable per bucket; the host-driven
    # _drain_factor-lengthened segments for those sizes are unreachable
    # (warming them would compile dead shapes)
    drain_fused = compact and fused_drain
    touch(batch, min(segment, max_iterations), False)    # first segment
    for a in range(1, batch + 1):                # every possible active size
        if drain_fused and a * 8 <= batch:
            if segment + tail <= max_iterations:
                touch_drain(_bucket(a, sizes))
            continue
        n = tail * _drain_factor(a, batch)
        if segment + n > max_iterations:
            continue  # budget-cap remainders are not enumerable
        use_c = compact and a < batch
        touch(_bucket(a, sizes) if use_c else batch, n, use_c)
    if compact and segment + _BRIDGE <= max_iterations:
        # bridge segments: the follower of any in-flight LARGE segment
        # (full batch after the first segment; any bucket once compaction
        # has started — re-entries can land the stale active set anywhere).
        # With the fused drain, active sets <= batch/8 never reach the host
        # segment path, so their buckets' bridges are dead shapes too.
        min_bucket = _bucket(batch // 8 + 1, sizes) if drain_fused else 0
        touch(batch, _BRIDGE, False)
        for s in sizes:
            if s >= min_bucket:
                touch(s, _BRIDGE, True)
    if std:
        # output-fetch executables: the full standardize (snapshot + the
        # non-overlapped fallback) and, for compact runs, every bucket-
        # padded splice gather the overlapped fetch can dispatch (the
        # refetch set is the union of post-snapshot active sets — usually
        # <= batch/4, but re-entries can push it into any bucket)
        np.asarray(_standardize_jit(z0))
        seen.add(("std", batch))
        if compact and batch >= 4:
            for s in sizes:
                np.asarray(_standardize_rows(
                    z0, jnp.zeros((s,), jnp.int32)))
                seen.add(("std_rows", s))
    return len(seen)


def synthesize_batch(
    key: jax.Array,
    target: jax.Array,
    bank: FilterBank,
    batch: int,
    max_iterations: int = 1000,
    tol: float = 1e-2,
    segment: int = 100,
    lr=None,
    verbose: bool = False,
    checkpoint_path=None,
    compact: bool = True,
    work_log: dict = None,
    mesh=None,
    init: str = "auto",
    checkpoint_min_interval_s: float = 30.0,
    overlap_fetch: bool = True,
    fused_drain: bool = True,
) -> Tuple[np.ndarray, np.ndarray]:
    """Synthesise ``batch`` series matching ``target`` statistics.

    Returns (normalised series ``(batch, T)``, per-seed RMS losses).
    The caller rescales by the target std / adds the target mean.

    :param checkpoint_path: optional ``.npz`` file; the optimiser state
        (series, Adam moments, step count) is saved there at pipeline
        flushes (every ``2*segment`` steps for compact runs; every segment
        otherwise), so an interrupted long generation resumes mid-shard.
    :param checkpoint_min_interval_s: minimum wall seconds between
        checkpoint WRITES (default 30). A write fetches the full
        (z, m, v) state to the host (~12 MB at the production config),
        which would multiply the cost of a fast shard for restart
        granularity nobody needs; fast shards therefore write no mid-shard
        state at all. Writes are pure
        IO — skipping them cannot change results (the flush schedule does
        not depend on them). Pass 0 to write at every flush.
    :param compact: retire converged seeds between segments (default).
        ``False`` reproduces the full-batch-until-all-converged schedule
        (kept for benchmarking the compaction gain).
    :param work_log: optional dict; filled with ``seed_steps`` (total
        per-seed Adam steps actually paid) and ``steps`` (wall steps).
    :param lr: ``None`` (default) uses the measured-best cosine schedule
        0.06 -> 0.005 over ``max_iterations // 2``
        (:func:`default_lr_schedule`); a float keeps a constant rate
        (round-1 behavior: 0.03).
    :param mesh: data-parallel synthesis over a device mesh (an int device
        count or a ``jax.sharding.Mesh`` with a ``"data"`` axis). Seeds are
        an ideal dp workload — per-seed independent losses, zero cross-seed
        collectives — so the batch axis of the SAME jitted segments is
        sharded and GSPMD partitions every step; compaction keeps working
        (buckets are rounded to mesh multiples so gathers stay balanced).
        The seed init is array-identical to ``mesh=None`` for any mesh
        size; series values agree up to float-ulp differences between the
        partitioned and single-device programs amplified through Adam
        (~1e-3 after tens of steps — tested). The step/retirement schedule
        matches too unless a seed's rms lands inside that ulp band of
        ``tol`` at a segment boundary, in which case it can retire one
        segment later on one partitioning than the other.
    :param init: ``"auto"`` (default) starts each seed as spectrum-coloured
        noise modulated by an MRW-style log-normal volatility envelope,
        intermittency auto-picked per seed by initial loss over a small
        grid that includes zero (:func:`_calibrated_seeds` — spectrum AND
        envelope statistics start near-matched; never worse than
        ``"coloured"`` by construction); ``"coloured"`` skips the envelope
        (Phi_2-only matching, round-3 early behavior); ``"white"`` keeps
        the flat-spectrum start.
    :param overlap_fetch: fetch the output WHILE the straggler drain runs
        (default). Once a submission's active set is <= batch/4, the full
        standardized series is snapshot-fetched on a host thread, so the
        fetch overlaps the drain dispatches; the end-of-run fetch then
        shrinks to the still-active rows via a
        bucket-padded row gather. Bit-identical output: standardization is
        per-row and compact active sets shrink monotonically, so rows
        outside the snapshot's active set are final (tested). ``False``
        keeps the single end-of-run fetch (timing diagnostics).
    :param fused_drain: once the active set falls to <= batch/8, finish the
        whole straggler tail in ONE :func:`_optimize_drain` dispatch
        (in-program freeze at every ``segment // 4``-step boundary, early
        exit when everyone froze) instead of 4-8 host-driven small-bucket
        segments that each pay a fixed dispatch and sync cost (default). ``False`` keeps the round-4 host-driven drain
        (``_drain_factor``-lengthened segments — diagnostics baseline).
    """
    t_start = time.monotonic()
    if lr is None:
        lr = default_lr_schedule(max_iterations)
    # standardized targets: match mean/logvar exactly by projection instead
    # of by gradient descent (see _adam_scan) — ~28% fewer seed-steps
    std = should_standardize(target)
    T = bank.T
    psi = _psi_device(bank)
    quantum = 1
    sharding = None
    if mesh is not None:
        from shadowing_tpu.parallel.sharding import DATA_AXIS, data_mesh

        if not hasattr(mesh, "shape"):
            mesh = data_mesh(int(mesh))
        quantum = mesh.shape[DATA_AXIS]
        if batch % quantum:
            raise ValueError(
                f"batch {batch} must be a multiple of the mesh size {quantum}"
            )
        sharding = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec(DATA_AXIS, None)
        )
    if init == "auto":
        z = _auto_seeds(key, batch, T, target, psi, J=bank.J,
                        bands=bank.band_hi or None)
    elif init == "coloured":
        z = _coloured_noise(key, batch, T, target, psi, J=bank.J)
    elif init == "white":
        z = jax.random.normal(key, (batch, T), jnp.float32)
    else:
        raise ValueError(
            f"init must be 'auto', 'coloured' or 'white', got {init!r}")
    if sharding is not None:
        z = jax.device_put(z, sharding)
    m = jnp.zeros_like(z)
    v = jnp.zeros_like(z)
    t_init = time.monotonic() - t_start  # seed build is submit-side only

    # Active-set compaction: converged seeds retire and stop costing
    # gradients; survivors are repacked into <= 6 bucketed shapes (bounded
    # recompiles). ``rms_full`` records each seed's RMS at retirement (or at
    # budget exhaustion). The active set and retirement RMS are part of the
    # checkpoint, so a resumed run continues the exact same schedule (no
    # re-stepping of already-retired seeds).
    sizes = _bucket_sizes(batch, quantum)
    active = np.arange(batch)
    rms_full = np.full(batch, np.inf, np.float32)
    seed_steps = 0

    done = 0
    if checkpoint_path is not None and checkpoint_path.exists():
        ckpt = np.load(checkpoint_path)
        if ckpt["z"].shape == (batch, T) and int(ckpt["done"]) <= max_iterations:
            put = (
                (lambda a: jax.device_put(jnp.asarray(a), sharding))
                if sharding is not None else jnp.asarray
            )
            z = put(ckpt["z"])
            m = put(ckpt["m"])
            v = put(ckpt["v"])
            done = int(ckpt["done"])
            if "active" in ckpt:  # older checkpoints: everyone active
                active = np.asarray(ckpt["active"])
                rms_full = np.asarray(ckpt["rms_full"])
            if verbose:
                print(f"  resumed synthesis from step {done} "
                      f"({batch - active.size}/{batch} already converged)",
                      flush=True)
    # Fully pipelined segment loop (compact runs): every segment k+1 goes
    # to the device on the retirement state known BEFORE segment k's
    # losses are fetched, so the device queue stays fed through the
    # per-segment host sync (jax dispatch is async; fetching k's losses
    # then overlaps k+1's execution — a drain segment can compute in less
    # time than the sync, which would otherwise idle the device).
    # While a LARGE segment's losses are in flight, the follower is a
    # short ``_BRIDGE`` segment: mass retirement happens at large-segment
    # boundaries, and lagging it a full tail segment would pay every
    # retiring seed ~25 stale steps (measured +18% seed-steps), while
    # harvesting synchronously idled the device at every boundary.
    # Staleness costs each straggler at most one
    # in-flight segment; a seed whose refreshed rms pops back above
    # ``tol`` when that segment lands simply re-enters the active set.
    # Non-compact runs (the diagnostics baseline) harvest every segment
    # synchronously — their full-batch segments have no drain to overlap.
    # Harvest points are a deterministic function of the observed loss
    # sequence, so checkpointed, uncheckpointed and resumed runs follow
    # ONE schedule (resume bit-identity is tested); checkpoints are only
    # written at flush points, where arrays/rms/active are consistent.
    pending = None   # (losses, active or None, nb, n, end, thread, box)
    last_ckpt = done
    last_save = time.monotonic()
    # overlapped output snapshot (see the overlap_fetch docstring):
    # (fetch thread, result box, mask of rows stepped after the snapshot)
    snap = None
    # optimistic refetch of the drained rows, started at drain submit so
    # the transfer overlaps the drain's device execution: (rows, thread,
    # box) — finalize uses it iff no later dispatch stepped more rows
    snap_refetch = None
    can_snap = (overlap_fetch and compact and std and sharding is None)
    tail = _tail_segment(segment)
    chunk_val = _SEG_CHUNK if sharding is None else 0

    _tm = {"harvest_s": 0.0, "n_harvests": 0}

    def _fetch_on_thread(dev_val, key, transform=None):
        """Fetch a device value on a daemon thread into a result box.

        The blocking device fetch releases the GIL, so the fetch overlaps
        the host loop. Errors are captured into ``box["err"]`` and
        re-raised by the caller at its join point."""
        box = {"t_start": time.monotonic()}

        def fetch():
            try:
                out = np.asarray(dev_val)
                box[key] = transform(out) if transform is not None else out
                box["t_done"] = time.monotonic()
            except BaseException as e:
                box["err"] = e

        th = threading.Thread(target=fetch, daemon=True)
        th.start()
        return th, box

    def _start_snapshot():
        """Snapshot-fetch the CURRENT standardized series on a host thread.

        The snapshot device value is immutable and already reflects every
        dispatch submitted so far (including any still-executing pending
        segment — ``z`` is its future result), so the returned stepped-mask
        starts EMPTY: only rows stepped by dispatches submitted after this
        point need the end-of-run refetch (each later submission marks its
        rows, including rare re-entries)."""
        th, box = _fetch_on_thread(_standardize_jit(z), "out")
        return th, box, np.zeros(batch, bool)

    def _prefetch(losses):
        """Fetch a segment's losses on a host thread, started at submission
        time, so the harvest does not pay each fetch serially on the host
        chain."""
        return _fetch_on_thread(losses, "rms", np.sqrt)

    def _harvest(p):
        losses_p, act_p, nb_p, n_p, end_p, th_p, box_p = p
        t_h = time.monotonic()
        th_p.join()
        if "err" in box_p:
            raise box_p["err"]
        arr = box_p["rms"]
        _tm["harvest_s"] += time.monotonic() - t_h
        _tm["n_harvests"] += 1
        if act_p is None:
            rms_full[:] = arr
            act_p = np.arange(batch)
        else:
            rms_full[act_p] = arr[: act_p.size]
        if verbose:
            print(
                f"  synthesis step {end_p:5d}: rms mismatch "
                f"median={np.median(rms_full):.4f} max={rms_full.max():.4f} "
                f"| {int((rms_full < tol).sum())}/{batch} converged",
                flush=True,
            )
        # ALL currently-unconverged rows, not just the harvested segment's
        # (act_p filtered): a row re-entered by an earlier harvest but
        # absent from this pending's active set must stay in play — the
        # drain-entry harvest replaces `active` wholesale, and filtering to
        # act_p there abandoned such a row unconverged with budget left
        # (found by review, reproduced at tol=2e-4). rms_full rows outside
        # act_p hold their last harvested value, which is exactly the
        # conservative answer.
        return np.flatnonzero(rms_full >= tol)

    _tm["submits"] = []   # per-iteration dispatch wall (observability: a
    _tm["harvests"] = []  # blocked submit vs a long harvest tell apart a
    #                       host stall and a device-bound wait)
    while (done < max_iterations and active.size) or pending is not None:
        if (compact and fused_drain and done < max_iterations
                and active.size and active.size * 8 <= batch):
            # ---- fused one-dispatch straggler drain (terminal phase) ----
            # the active set is small enough that a segment's wall is ~all
            # fixed dispatch cost; flush the pipeline and finish the whole
            # tail in one _optimize_drain dispatch (in-program freeze at
            # every `tail`-step boundary, early exit when everyone froze).
            # The pipeline is flushed BEFORE the budget check below, so a
            # small active set never reaches the host path with a pending
            # large segment — small-bucket BRIDGE shapes stay truly
            # unreachable (warmup_executables enumerates on exactly that).
            if pending is not None:
                active = _harvest(pending)
                pending = None
                if not (active.size and done < max_iterations
                        and active.size * 8 <= batch):
                    continue  # harvest re-entered rows / emptied the set
            if max_iterations - done >= tail:
                if snap is None and can_snap:
                    # snapshot the PRE-drain series first so its host fetch
                    # overlaps the drain's (single, long) device execution
                    snap = _start_snapshot()
                t_dr = time.monotonic()
                nb = _bucket(active.size, sizes)
                idx = np.resize(active, nb)  # pad by cycling active rows
                z, m, v, losses_d, k_d = _optimize_drain(
                    z, m, v, jnp.asarray(idx, jnp.int32),
                    jnp.asarray(done, jnp.float32),
                    jnp.asarray((max_iterations - done) // tail, jnp.int32),
                    jnp.asarray(tol, jnp.float32), target, psi,
                    J=bank.J, sub_steps=tail, lr=lr,
                    bands=bank.band_hi or None, standardize=std,
                    chunk=chunk_val,
                )
                if snap is not None:
                    snap[2][active] = True
                    # optimistic final-rows refetch: the stepped rows' final
                    # values are a deterministic function of the already-
                    # submitted program (immutable device buffers), so gather +
                    # fetch them on a thread NOW — the transfer overlaps the
                    # drain's device execution instead of running serially in
                    # the finalize (which uses it only if no later dispatch
                    # steps more rows; a rare post-drain re-entry falls back to
                    # the synchronous refetch)
                    pre_rows = np.flatnonzero(snap[2])
                    nb_r = _bucket(pre_rows.size, sizes)
                    rows_dev = _standardize_rows(
                        z, jnp.asarray(np.resize(pre_rows, nb_r), jnp.int32))
                    snap_refetch = (pre_rows,
                                    *_fetch_on_thread(rows_dev, "out"))
                t_sub = time.monotonic() - t_dr
                losses_h, k_h = jax.device_get((losses_d, k_d))  # one sync
                n_subs = int(k_h)
                done += n_subs * tail
                seed_steps += nb * tail * n_subs
                rms_full[active] = np.sqrt(losses_h[: active.size])
                _tm.setdefault("drain", []).append(
                    {"rows": int(active.size), "bucket": nb,
                     "subs": n_subs, "sub_steps": tail,
                     "submit_s": round(t_sub, 4),
                     "wall_s": round(time.monotonic() - t_dr, 4)})
                if verbose:
                    print(f"  drain: {active.size} stragglers, bucket {nb}, "
                          f"{n_subs} x {tail}-step subs in one dispatch | "
                          f"{int((rms_full < tol).sum())}/{batch} converged",
                          flush=True)
                active = active[rms_full[active] >= tol]
                continue
            # else: remaining budget < one sub-segment — fall through to
            # the host path, which submits the remainder shape (a
            # documented-cold budget-cap executable, same class as before
            # the fused drain existed)
        submitted = None
        submit_size = 0
        t_it = time.monotonic()
        if done < max_iterations and active.size:
            submit_size = active.size
            # first segment long (nothing retires early); a short bridge
            # while a large segment's mass retirement is still in flight
            # (see the policy comment above); then fine-grained tail
            # segments so converged seeds stop paying promptly —
            # lengthened again in the sync-bound drain (_drain_factor)
            pend_large = pending is not None and (
                batch if pending[1] is None else pending[1].size
            ) > batch // 4
            if done == 0:
                seg_now = segment
            elif compact and pend_large:
                seg_now = _BRIDGE
            else:
                seg_now = (_tail_segment(segment)
                           * _drain_factor(active.size, batch))
            n = min(seg_now, max_iterations - done)
            chunk = _SEG_CHUNK if sharding is None else 0
            if compact and active.size < batch:
                nb = _bucket(active.size, sizes)
                idx = np.resize(active, nb)  # pad by cycling active rows
                z, m, v, losses = _optimize_segment_compact(
                    z, m, v, jnp.asarray(idx, jnp.int32),
                    jnp.asarray(done, jnp.float32), target, psi,
                    J=bank.J, n_steps=n, lr=lr, bands=bank.band_hi or None,
                    standardize=std, chunk=chunk,
                )
                submitted = (losses, active.copy(), nb, n, done + n,
                             *_prefetch(losses))
            else:
                z, m, v, losses = _optimize_segment(
                    z, m, v, jnp.asarray(done, jnp.float32), target, psi,
                    J=bank.J, n_steps=n, lr=lr, bands=bank.band_hi or None,
                    standardize=std, chunk=chunk,
                )
                submitted = (losses, None, batch, n, done + n,
                             *_prefetch(losses))
            done += n
            seed_steps += submitted[2] * n
            # any dispatch after the drain's optimistic refetch makes it
            # stale — even when it steps exactly the same row SET (a
            # budget-remainder segment after a budget-exhausted drain did:
            # the row sets matched, the values did not — found by review,
            # reproduced). Later drains recreate the prefetch.
            snap_refetch = None
            if snap is not None:
                # every row stepped after the snapshot must be refetched —
                # including rare RE-ENTRIES (a retired row whose rms pops
                # back above tol when its in-flight extra segment lands is
                # re-activated, and need not be in the snapshot-trigger
                # submission's active set)
                if submitted[1] is None:   # full-batch: everyone stepped
                    snap[2][:] = True
                else:
                    snap[2][submitted[1]] = True
            if (snap is None and can_snap and submitted[1] is not None
                    and submit_size <= batch // 4):
                # rows outside this submission's active set are final from
                # here on (modulo the re-entry tracking above) — snapshot-
                # fetch the whole standardized series on a thread; the
                # drain's dispatches proceed underneath it. The snapshot
                # value includes THIS submission's result (immutable device
                # buffer), so its rows are not marked as stepped.
                snap = _start_snapshot()
        _tm["submits"].append(round(time.monotonic() - t_it, 4))
        if pending is not None:
            t_h0 = time.monotonic()
            active = _harvest(pending)
            _tm["harvests"].append(round(time.monotonic() - t_h0, 4))
        pending = submitted
        if pending is not None and (not compact
                                    or done - last_ckpt >= 2 * segment):
            # flush: harvest the just-submitted segment now. Triggers:
            # (a) non-compact runs — full-batch segments have no drain to
            # overlap, and the no-compaction baseline keeps its simple
            # synchronous schedule; (b) every ``2*segment`` steps — bound
            # pipeline depth so checkpoint state stays fresh.
            active = _harvest(pending)
            pending = None
            last_ckpt = done
            if (checkpoint_path is not None and
                    time.monotonic() - last_save >= checkpoint_min_interval_s):
                last_save = time.monotonic()
                tmp = checkpoint_path.with_suffix(".tmp.npz")
                np.savez(tmp, z=np.asarray(z), m=np.asarray(m),
                         v=np.asarray(v), done=done, active=active,
                         rms_full=rms_full)
                tmp.replace(checkpoint_path)
    if not np.isfinite(rms_full).all():
        # resumed exactly at the step budget: evaluate losses only
        _, _, _, losses = _optimize_segment(
            z, m, v, jnp.asarray(done, jnp.float32), target, psi,
            J=bank.J, n_steps=0, lr=lr, bands=bank.band_hi or None,
            standardize=std,
        )
        rms_full = np.sqrt(np.asarray(losses))
    if work_log is not None:
        work_log["seed_steps"] = seed_steps
        work_log["steps"] = done
        work_log["t_loop_s"] = time.monotonic() - t_start
        work_log["t_init_s"] = t_init
        work_log["t_harvest_s"] = _tm["harvest_s"]
        work_log["n_harvests"] = _tm["n_harvests"]
        work_log["t_submits"] = _tm["submits"]
        work_log["t_harvests"] = _tm["harvests"]
        if "drain" in _tm:  # fused one-dispatch straggler drain, if it ran
            work_log["drain"] = _tm["drain"]
    if checkpoint_path is not None and checkpoint_path.exists():
        checkpoint_path.unlink()  # shard finished: drop the mid-shard state
    t_fin = time.monotonic()
    if snap is not None:
        th, box, stepped = snap
        still = np.flatnonzero(stepped)
        # refetch ONLY the rows stepped after the snapshot (bucket-padded:
        # static gather shapes only — per-run shapes would compile inside
        # every run). The drain-overlapped prefetch covers
        # the common terminal shape; empty `still` (nothing dispatched
        # after the snapshot) needs no refetch at all.
        if still.size == 0:
            rows = None
        elif (snap_refetch is not None
                and np.array_equal(snap_refetch[0], still)):
            snap_refetch[1].join()
            if "err" in snap_refetch[2]:
                raise snap_refetch[2]["err"]
            rows = snap_refetch[2]["out"]
        else:
            nb = _bucket(still.size, sizes)
            rows = np.asarray(_standardize_rows(
                z, jnp.asarray(np.resize(still, nb), jnp.int32)))
        t_rows = time.monotonic() - t_fin
        th.join()
        if "err" in box:
            raise box["err"]
        if work_log is not None:
            work_log["t_refetch_s"] = round(t_rows, 4)
            work_log["refetch_rows"] = int(still.size)
            work_log["refetch_prefetched"] = rows is not None and (
                snap_refetch is not None
                and np.array_equal(snap_refetch[0], still))
            work_log["t_snap_join_s"] = round(time.monotonic() - t_fin
                                              - t_rows, 4)
            work_log["t_snap_fetch_s"] = round(
                box["t_done"] - box["t_start"], 4)
        out = box["out"]
        if still.size:
            if not out.flags.writeable:
                out = out.copy()
            out[still] = rows[: still.size]
    else:
        if std:
            # the loss/rms describe the per-seed standardized series —
            # return exactly that (the raw variable may carry a residual
            # mean/scale the projection absorbed)
            z = _standardize_jit(z)
        out = np.asarray(z)
    if work_log is not None:
        # phase timestamps (observability: the loop/fetch split tells which
        # side a regression lives on)
        work_log["overlap_fetch"] = snap is not None
        work_log["t_finalize_s"] = time.monotonic() - t_fin
        work_log["t_total_s"] = time.monotonic() - t_start
    return out, rms_full
