"""Drive shadowing_tpu's main path once on an NVIDIA GPU and check it.

    python chip_smoke.py                # one card: phases 1-6
    python chip_smoke.py --four-cards   # four cards: the mesh phase only

Every phase runs through the public API at the sizes the system's users
run, with data drawn from ``--seed``, and checks its results against the
package's plain references: ``method="direct"`` (the literal search
oracle), a float64 recomputation on the host, and JAX's CPU backend. Any
failure raises, so the script exits non-zero and prints no result line. It
also exits non-zero when JAX finds no GPU. The last line of standard output
is exactly one JSON object::

    {"ok": true, "device": {"platform": "gpu", "kind": "...", "count": N}}

Times printed on the way are single runs (first call = compile + run) with
the card's name and power limit beside them; they are not a benchmark.
"""
from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from dataclasses import dataclass
from pathlib import Path

import numpy as np

#: f32 tie window at the k boundary (the one tests/test_fuzz.py documents):
#: two candidates closer than this in distance, or in squared distance
#: (the expansion scores resolve squared differences only to ~f32 eps of
#: ``||x||^2``), have no better-defined f32 order, so a route may keep
#: either one at the cut.
_TIE_ATOL, _TIE_RTOL = 1e-6, 1e-5
_SQ_WINDOW = 256 * 1.19e-7
#: returned distances against a float64 recomputation from the dataset:
#: the device rescores winners at full float32, ~1e-7 relative
_DIST_RTOL = 1e-5
#: scattering statistics, card against CPU: the two backends' FFTs and
#: reductions sum in different orders, ~1e-6 relative on the spectra
_STATS_RTOL, _STATS_ATOL = 1e-4, 1e-6
#: implied vols, card against a float64 smile of the same paths, on the
#: cells where the CPU backend's float32 smile meets float64 to this bound
#: (the well-conditioned hedge regressions): there both float32 backends
#: land within ~1.4e-5 of float64 on an H100; 1e-4 is a hundredth of a vol
#: point
_VOL_ATOL = 1e-4
#: bandwidth of the Gaussian-kernel path weights of the target's smile
_ETA_SMILE = 0.075
#: backtest predictions against the direct oracle's: identical winner sets
#: give identical paths, and swaps inside the tie window move the softmax
#: weights by ~eps
_PRED_RTOL = 1e-4


@dataclass(frozen=True)
class Sizes:
    """One run's shapes. :data:`REAL` is what the script runs; tests run
    the same phases at :data:`TINY`."""

    R: int = 32768                  # target / backtest dataset rows
    T: int = 4096
    w: int = 20
    horizon: int = 20
    k: int = 1024
    Ts: tuple = (5, 10, 20)
    n_moneyness: int = 9
    ref_R: int = 131072             # reference deployment
    ref_k: int = 10000
    ref_horizon: int = 252
    bt_dates: int = 2048
    bt_chunk: int = 64
    bt_big_dates: int = 256
    bt_big_k: int = 16384
    gen_batch: int = 1024
    gen_J: int = 9
    gen_T: int = 4096
    gen_tol: float = 1e-2
    gen_iters: int = 1000
    gen_min_converged: float = 0.95
    mesh_steps: int = 5


REAL = Sizes()
TINY = Sizes(R=96, T=256, k=32, ref_R=64, ref_k=48, ref_horizon=100,
             bt_dates=128, bt_big_dates=64, bt_big_k=256, gen_batch=8,
             gen_J=4, gen_T=256, gen_tol=0.1, gen_iters=200,
             gen_min_converged=0.5, mesh_steps=2)


def log(*a) -> None:
    print(*a, flush=True)


def card_line() -> str:
    """``nvidia-smi``'s name and power limit of every card, as it prints
    them ("no nvidia-smi" where there is none)."""
    try:
        out = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True)
    except (OSError, subprocess.SubprocessError):
        return "no nvidia-smi"
    return out.stdout.strip()


class Clock:
    """Wall times tagged with the card they ran on."""

    def __init__(self, card: str):
        self.card = card.splitlines()[0] if card else "unknown card"

    def __call__(self, label, fn, *a, **kw):
        t0 = time.perf_counter()
        out = fn(*a, **kw)
        log(f"  {label}: {time.perf_counter() - t0:.3f} s [{self.card}]")
        return out


# --------------------------------------------------------------------------
# checks
# --------------------------------------------------------------------------

def host_distances(engine, ds_host, x_ctx, idces) -> np.ndarray:
    """Float64 distances of the returned winners, recomputed on the host
    from the dataset slices their indices name."""
    kernel = engine.embedding.kernel.astype(np.float64)
    w = kernel.shape[-1]
    ctx = np.asarray(x_ctx, np.float64).reshape(len(idces), -1, w)
    r, t = idces[..., 0], idces[..., 1]
    win = ds_host[r[..., None], :, t[..., None] + np.arange(w)]  # B,k,w,C
    win = np.moveaxis(win, -1, -2).astype(np.float64)            # B,k,C,w
    e = np.einsum("bkcw,dcw->bkd", win, kernel)
    x_emb = np.einsum("bcw,dcw->bd", ctx, kernel)
    return engine.distance.forward_host(x_emb[:, None, :], e)


def check_distances(name, d, engine, ds_host, x_ctx, idces) -> None:
    ref = host_distances(engine, ds_host, x_ctx, idces)
    err = np.abs(d - ref) / np.maximum(np.abs(ref), 1e-30)
    log(f"  {name}: distances vs host float64: max rel err {err.max():.3e}")
    if not err.max() <= _DIST_RTOL:
        raise AssertionError(f"{name}: distances off the float64 "
                             f"recomputation by {err.max():.3e}")


def tie_window_swaps(name, d_a, i_a, d_d, i_d) -> int:
    """Compare route ``a``'s winner sets with the direct oracle's. Returns
    how many winners were swapped inside the f32 tie window at the cut;
    raises on any other difference."""
    swaps = 0
    for b in range(len(d_a)):
        sa = {tuple(x): v for x, v in zip(i_a[b].tolist(), d_a[b])}
        sd = {tuple(x): v for x, v in zip(i_d[b].tolist(), d_d[b])}
        only = [(x, v) for x, v in sa.items() if x not in sd]
        only += [(x, v) for x, v in sd.items() if x not in sa]
        if not only:
            continue
        cut = float(d_d[b, -1])
        for x, v in only:
            near = abs(v - cut) <= _TIE_ATOL + _TIE_RTOL * abs(cut) or abs(
                float(v) ** 2 - cut**2) <= _SQ_WINDOW
            if not near:
                raise AssertionError(
                    f"{name}: context {b} winner {x} at distance {v} is not "
                    f"in both sets and not within the tie window of the "
                    f"cut {cut}")
        swaps += len(only) // 2
    return swaps


def compare_routes(name, engine, ds_host, x_ctx, k, clock):
    """``shadow(method="auto")`` against ``shadow(method="direct")`` on the
    card, and both against float64. Returns the auto route's result."""
    d_a, p_a, i_a = clock(f"{name} shadow(auto) first call", engine.shadow,
                          x_ctx, k=k)
    d_a, p_a, i_a = clock(f"{name} shadow(auto)", engine.shadow, x_ctx, k=k)
    route = engine.last_metrics["method"]
    redo = engine.last_metrics["redo_contexts"]
    d_d, _, i_d = clock(f"{name} shadow(direct)", engine.shadow, x_ctx, k=k,
                        method="direct")
    swaps = tie_window_swaps(name, d_a, i_a, d_d, i_d)
    log(f"  {name}: auto route={route}, redo_contexts={redo}, index sets "
        f"equal to direct apart from {swaps} tie-window swap(s)")
    check_distances(f"{name} auto", d_a, engine, ds_host, x_ctx, i_a)
    check_distances(f"{name} direct", d_d, engine, ds_host, x_ctx, i_d)
    return d_a, p_a, i_a


def device_dataset(key_seed: int, R: int, T: int):
    """(R, 1, T) float32 returns drawn on the device (set-up, not timed)."""
    import jax
    import jax.numpy as jnp

    return jax.random.normal(jax.random.key(key_seed), (R, 1, T),
                             jnp.float32) * 0.011


# --------------------------------------------------------------------------
# phases
# --------------------------------------------------------------------------

def phase_device(want_count: int) -> dict:
    import jax

    devs = jax.devices()
    d0 = devs[0]
    stats = d0.memory_stats() or {}
    log(f"[1] devices: {devs}")
    log(f"    device_kind={d0.device_kind!r} platform={d0.platform!r} "
        f"bytes_limit={stats.get('bytes_limit')}")
    card = card_line()
    log(f"    nvidia-smi: {card}")
    if d0.platform != "gpu":
        raise SystemExit(f"no GPU: JAX's first device is on {d0.platform!r}")
    if len(devs) < want_count:
        raise SystemExit(f"need {want_count} GPUs, JAX sees {len(devs)}")
    return {"card": card, "kind": d0.device_kind}


def phase_target(sz: Sizes, seed: int, clock: Clock) -> dict:
    """Target search: predict_and_smile + auto vs direct."""
    from shadowing_tpu import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        SPDaily,
        realized_variance,
    )

    log(f"[2] target search: R={sz.R} x 1 x {sz.T}, Identity({sz.w}), "
        f"horizon {sz.horizon}, k={sz.k}")
    ds = device_dataset(seed, sz.R, sz.T)
    ds_host = np.asarray(ds)
    ctx = SPDaily().dlnx[0, 0, -sz.w:].astype(np.float32)[None, None]
    obj = PathShadowing(Identity(sz.w), RelativeMSE(), ds,
                        PredictionContext(horizon=sz.horizon))
    Ts = np.asarray(sz.Ts)
    Ms = np.linspace(-2.0, 2.0, sz.n_moneyness)
    to_predict = lambda x: realized_variance(x[:, :, 0, :], Ts=Ts, vol=False)
    for label in ("predict_and_smile first call", "predict_and_smile"):
        avg, std, smiles = clock(
            label, obj.predict_and_smile, ctx, k=sz.k, to_predict=to_predict,
            Ts=Ts, Ms=Ms, eta=0.1, eta_smile=_ETA_SMILE)
    if not (avg.shape == (1, len(Ts)) and np.isfinite(avg).all()
            and (avg > 0).all()):
        raise AssertionError(f"bad variance prediction {avg}")
    vols = smiles[0].vols
    if vols.shape != (len(Ts), sz.n_moneyness):
        raise AssertionError(f"bad smile grid {vols.shape}")
    # vols are checked against the CPU backend in phase 6
    log(f"  predicted variance {avg[0]}, ATM vols "
        f"{vols[:, sz.n_moneyness // 2]}")
    d, p, i = compare_routes("target", obj, ds_host, ctx, sz.k, clock)
    for line in obj.routing_log:
        log(f"  route: {line}")
    return {"engine": obj, "ds_host": ds_host, "ctx": ctx, "d": d, "p": p,
            "i": i}


def phase_backtest(sz: Sizes, seed: int, st: dict, clock: Clock) -> None:
    """Rolling backtest on the target dataset, first chunk vs direct, then
    the large-k run."""
    from shadowing_tpu import realized_variance, windows
    from shadowing_tpu.backtest import rolling_backtest

    obj, ds_host = st["engine"], st["ds_host"]
    log(f"[4] backtest: {sz.bt_dates} dates in {sz.bt_chunk}-date chunks, "
        f"k={sz.k}")
    rng = np.random.default_rng(seed + 4)
    series = (rng.standard_normal(sz.bt_dates + sz.w + max(sz.Ts) - 1)
              * 0.011).astype(np.float32)
    n_chunks = -(-sz.bt_dates // sz.bt_chunk)
    for label in ("rolling_backtest first call", "rolling_backtest"):
        res = clock(label, rolling_backtest, obj, series, w=sz.w, Ts=sz.Ts,
                    k=sz.k, n_context_splits=n_chunks)
    if not (res.predicted.shape == (sz.bt_dates, len(sz.Ts))
            and np.isfinite(res.predicted).all()):
        raise AssertionError("backtest predictions missing or not finite")
    log(f"  backtest redo_contexts={obj.last_metrics['redo_contexts']}, "
        f"route={obj.last_metrics['method']}, "
        f"rmse(vol)={res.rmse()}")
    first = windows(series, w=sz.w + max(sz.Ts), s=1)[: sz.bt_chunk, :sz.w]
    first = first[:, None, :]
    compare_routes("backtest chunk 0", obj, ds_host, first, sz.k, clock)
    to_predict = lambda x: realized_variance(x[:, :, 0, :],
                                             Ts=np.asarray(sz.Ts), vol=False)
    direct, _ = clock("backtest chunk 0 predict(direct)", obj.predict, first,
                      k=sz.k, to_predict=to_predict, eta=0.1,
                      method="direct")
    err = np.abs(direct - res.predicted[: sz.bt_chunk]) / np.abs(direct)
    log(f"  backtest chunk 0: predictions vs direct max rel err "
        f"{err.max():.3e}")
    if not err.max() <= _PRED_RTOL:
        raise AssertionError("backtest chunk 0 predictions differ from the "
                             f"direct oracle's by {err.max():.3e}")

    log(f"  large k: {sz.bt_big_dates} dates at k={sz.bt_big_k}")
    s_big = series[: sz.bt_big_dates + sz.w + max(sz.Ts) - 1]
    res = clock("rolling_backtest large k", rolling_backtest, obj, s_big,
                w=sz.w, Ts=sz.Ts, k=sz.bt_big_k,
                n_context_splits=-(-sz.bt_big_dates // sz.bt_chunk))
    if not np.isfinite(res.predicted).all():
        raise AssertionError("large-k backtest predictions not finite")
    log(f"  large k: redo_contexts={obj.last_metrics['redo_contexts']}, "
        f"route={obj.last_metrics['method']}")


def smile_vols_float64(x, Ts, Ms, weights) -> np.ndarray:
    """Implied vols of the same Hedged-MC smile computed in float64 on the
    CPU backend: the witness both float32 backends are measured against."""
    import jax
    import jax.numpy as jnp

    from shadowing_tpu.pricing.hedged_mc import _smile_all

    with jax.enable_x64(True), jax.default_device(jax.devices("cpu")[0]):
        out = _smile_all(jnp.asarray(x, jnp.float64),
                         jnp.asarray(weights, jnp.float64),
                         jnp.asarray(Ms, jnp.float64), float(x[0, 0]), 0.0,
                         Ts=tuple(int(t) for t in Ts), n_basis=12)
        return np.asarray(out[2])


def phase_smile(sz: Sizes, st: dict, clock: Clock) -> None:
    """Hedged-MC smile of phase 2's winners on the card, on the CPU backend
    and in float64, under uniform and under Gaussian-kernel path weights."""
    import jax

    from shadowing_tpu import PriceData, Softmax, compute_smile

    log("[6] smile of the target winners: card vs CPU backend vs float64")
    fut = np.asarray(st["p"])[0, :, 0, sz.w:]
    x = np.asarray(PriceData(dlnx=fut, x_init=100.0).x)
    Ms = np.linspace(-2.0, 2.0, sz.n_moneyness)
    d64 = np.asarray(st["d"])[0].astype(np.float64)
    z = -0.5 * (d64 / _ETA_SMILE) ** 2
    w_kernel = np.exp(z - z.max())
    for name, ave, w64 in (
            ("uniform", None, np.full(len(x), 1.0 / len(x))),
            (f"softmax eta={_ETA_SMILE}",
             Softmax(np.asarray(st["d"])[0], eta=_ETA_SMILE),
             w_kernel / w_kernel.sum())):
        card = clock(f"compute_smile {name} (card)", compute_smile, x,
                     sz.Ts, Ms, ave=ave)
        with jax.default_device(jax.devices("cpu")[0]):
            cpu = compute_smile(x, sz.Ts, Ms, ave=ave)
        f64 = smile_vols_float64(x, sz.Ts, Ms, w64)
        fin = np.isfinite(card.vols)
        if not (fin == np.isfinite(cpu.vols)).all() or not fin.any():
            raise AssertionError(f"{name} smile NaN pattern differs:\n"
                                 f"{card.vols}\n{cpu.vols}")
        fin &= np.isfinite(f64)
        gap = lambda a, b: np.where(fin, np.abs(a - b), 0.0)
        e_card, e_cpu = gap(card.vols, f64), gap(cpu.vols, f64)
        # cells where the CPU's float32 smile meets float64 to _VOL_ATOL are
        # well conditioned: the card must meet it there too; elsewhere the
        # float32 solve itself is off, and the card may be no further off
        # than the CPU, twice over
        well = fin & (e_cpu <= _VOL_ATOL)
        log(f"  {name}: implied vols, max abs diff per maturity: card vs "
            f"CPU {gap(card.vols, cpu.vols).max(axis=1)}, card vs float64 "
            f"{e_card.max(axis=1)}, CPU vs float64 {e_cpu.max(axis=1)} "
            f"({int(fin.sum())} finite of {fin.size}, {int(well.sum())} "
            f"within {_VOL_ATOL} of float64 on the CPU); prices card vs CPU "
            f"max abs diff {np.abs(card.prices - cpu.prices).max() / 100.0:.3e}"
            " of the spot")
        if not (e_card[well] <= _VOL_ATOL).all():
            raise AssertionError(f"{name}: card implied vols off float64 by "
                                 f"{e_card[well].max():.3e} where the CPU "
                                 f"is within {_VOL_ATOL}")
        ill = fin & ~well
        if not (e_card[ill] <= 2.0 * e_cpu[ill]).all():
            raise AssertionError(f"{name}: card implied vols further from "
                                 "float64 than twice the CPU's error")


def phase_reference(sz: Sizes, seed: int, clock: Clock) -> None:
    """The reference's own predict cell: Foveal 126 -> 34, horizon 252."""
    from shadowing_tpu import (
        Foveal,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        realized_variance,
    )

    emb = Foveal(alpha=1.15, beta=0.9, max_context=126)
    log(f"[3] reference predict: R={sz.ref_R} x 1 x {sz.T}, Foveal 126 -> "
        f"{emb.dim}, horizon {sz.ref_horizon}, k={sz.ref_k}")
    ds = device_dataset(seed + 3, sz.ref_R, sz.T)
    ds_host = np.asarray(ds)
    rng = np.random.default_rng(seed + 3)
    ctx = (rng.standard_normal((1, 1, 126)) * 0.011).astype(np.float32)
    obj = PathShadowing(emb, RelativeMSE(), ds,
                        PredictionContext(horizon=sz.ref_horizon))
    to_predict = lambda x: realized_variance(x, Ts=[2, 7, sz.ref_horizon],
                                             vol=False)
    for label in ("predict first call", "predict"):
        avg, std = clock(label, obj.predict, ctx, k=sz.ref_k,
                         to_predict=to_predict, eta=0.1)
    if not (np.isfinite(avg).all() and (avg > 0).all()):
        raise AssertionError(f"bad reference prediction {avg}")
    log(f"  predict route={obj.last_metrics['method']}, "
        f"redo_contexts={obj.last_metrics['redo_contexts']}")
    compare_routes("reference", obj, ds_host, ctx, sz.ref_k, clock)
    for line in obj.routing_log:
        log(f"  route: {line}")


def phase_generation(sz: Sizes, seed: int, clock: Clock) -> None:
    """synthesize_batch at the production batch; statistics card vs CPU."""
    import jax
    import jax.numpy as jnp

    from shadowing_tpu import SPDaily
    from shadowing_tpu.models.scattering import (
        build_filter_bank,
        scattering_stats,
    )
    from shadowing_tpu.models.scattering.synthesis import synthesize_batch

    log(f"[5] generation: batch {sz.gen_batch}, J={sz.gen_J}, "
        f"T={sz.gen_T}, tol {sz.gen_tol:g}, <= {sz.gen_iters} iterations")
    snp = SPDaily(start="03-01-2000", end="31-12-2014")
    dlnx = np.ravel(snp.dlnx).astype(np.float64)
    z_obs = ((dlnx - dlnx.mean()) / dlnx.std()).astype(np.float32)
    bank_obs = build_filter_bank(len(z_obs), sz.gen_J)
    card = np.asarray(clock("scattering_stats (card)", scattering_stats,
                            jnp.asarray(z_obs), bank_obs))
    with jax.default_device(jax.devices("cpu")[0]):
        cpu = np.asarray(scattering_stats(jnp.asarray(z_obs), bank_obs))
    err = np.abs(card - cpu) - _STATS_RTOL * np.abs(cpu)
    log(f"  scattering_stats card vs CPU: max abs diff "
        f"{np.abs(card - cpu).max():.3e}, max rel diff "
        f"{(np.abs(card - cpu) / np.maximum(np.abs(cpu), 1e-30)).max():.3e}")
    if not err.max() <= _STATS_ATOL:
        raise AssertionError("scattering statistics differ between the "
                             "card and the CPU backend beyond tolerance")
    target = jnp.asarray(cpu)
    bank = build_filter_bank(sz.gen_T, sz.gen_J)
    work = {}
    z, rms = clock("synthesize_batch (compiles included)", synthesize_batch,
                   jax.random.PRNGKey(seed + 5), target, bank,
                   batch=sz.gen_batch, max_iterations=sz.gen_iters,
                   tol=sz.gen_tol, work_log=work)
    conv = float((rms < sz.gen_tol).mean())
    log(f"  converged share {conv:.4f}, rms median {np.median(rms):.4f}, "
        f"seed-steps {work['seed_steps']}")
    if z.shape != (sz.gen_batch, sz.gen_T) or not np.isfinite(z).all():
        raise AssertionError("generated series missing or not finite")
    if conv < sz.gen_min_converged:
        raise AssertionError(f"only {conv:.3f} of the seeds converged")


def phase_four_cards(sz: Sizes, seed: int, clock: Clock) -> None:
    """The data mesh on four cards against one card: the target search
    and a backtest chunk, and the data-parallel synthesis step."""
    import jax
    import jax.numpy as jnp

    from shadowing_tpu import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        SPDaily,
        data_mesh,
        sharded_synthesis_step,
        windows,
    )
    from shadowing_tpu.models.scattering import (
        build_filter_bank,
        scattering_stats,
    )

    log(f"[mesh] target search and one {sz.bt_chunk}-date backtest chunk "
        "on data_mesh(4) vs mesh=None on card 0")
    ds = device_dataset(seed, sz.R, sz.T)
    mk = lambda mesh: PathShadowing(Identity(sz.w), RelativeMSE(), ds,
                                    PredictionContext(horizon=sz.horizon),
                                    mesh=mesh)
    single, meshed = mk(None), mk(data_mesh(4))
    rng = np.random.default_rng(seed + 4)
    series = (rng.standard_normal(sz.bt_chunk + sz.w + max(sz.Ts) - 1)
              * 0.011).astype(np.float32)
    chunk = windows(series, w=sz.w + max(sz.Ts), s=1)[: sz.bt_chunk, :sz.w]
    ctx = SPDaily().dlnx[0, 0, -sz.w:].astype(np.float32)[None, None]
    for name, x in (("target", ctx), ("backtest chunk", chunk[:, None, :])):
        d0, p0, i0 = clock(f"{name} mesh=None", single.shadow, x, k=sz.k)
        dm, pm, im = clock(f"{name} mesh=4 first call", meshed.shadow, x,
                           k=sz.k)
        dm, pm, im = clock(f"{name} mesh=4", meshed.shadow, x, k=sz.k)
        log(f"  {name}: routes single={single.last_metrics['method']} "
            f"mesh={meshed.last_metrics['method']}")
        for a, b, what in ((i0, im, "indices"), (d0, dm, "distances"),
                           (p0, pm, "paths")):
            if not np.array_equal(a, b):
                raise AssertionError(f"{name}: mesh {what} differ from one "
                                     "card")
        log(f"  {name}: indices, distances and paths identical")
    del single, meshed, ds

    log("[mesh] sharded_synthesis_step, 4 cards vs 1")
    T, J, B = sz.gen_T, sz.gen_J, 64
    bank = build_filter_bank(T, J)
    z0 = jax.random.normal(jax.random.key(seed + 6), (B, T), jnp.float32)
    target = scattering_stats(z0[:8], bank)
    psi = jnp.asarray(bank.psi_hat)

    def run(mesh):
        sh = jax.sharding.NamedSharding(
            mesh, jax.sharding.PartitionSpec("data", None))
        z = jax.device_put(z0, sh)
        m = v = jax.device_put(jnp.zeros_like(z0), sh)
        for i in range(sz.mesh_steps):
            z, m, v, loss = sharded_synthesis_step(
                z, m, v, jnp.asarray(i), target, psi, J=J, mesh=mesh)
        return np.asarray(z), float(loss)

    z1, l1 = clock("synthesis steps, 1 card", run, data_mesh(1))
    z4, l4 = clock("synthesis steps, 4 cards", run, data_mesh(4))
    err = np.abs(z4 - z1).max()
    log(f"  after {sz.mesh_steps} steps: max |z4 - z1| {err:.3e}, losses "
        f"{l1:.6f} / {l4:.6f}")
    # per-step gradients differ at float-ulp level between partitionings
    # and Adam amplifies that (synthesize_batch's documented 1e-3 bound)
    if not err <= 1e-3:
        raise AssertionError(f"mesh synthesis step drifted by {err:.3e}")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.splitlines()[0])
    ap.add_argument("--four-cards", action="store_true",
                    help="run only the four-card mesh phase")
    ap.add_argument("--seed", type=int, default=0)
    args = ap.parse_args(argv)
    # the package next to this script, not an installed copy: alone in a
    # directory the script must fail
    sys.path.insert(0, str(Path(__file__).resolve().parent))

    info = phase_device(4 if args.four_cards else 1)
    import jax

    from shadowing_tpu.utils import enable_compile_cache

    log(f"    compile cache: {enable_compile_cache()}")
    clock = Clock(info["card"])
    sz = REAL
    t0 = time.perf_counter()
    if args.four_cards:
        phase_four_cards(sz, args.seed, clock)
    else:
        st = phase_target(sz, args.seed, clock)
        phase_smile(sz, st, clock)
        phase_backtest(sz, args.seed, st, clock)
        del st
        phase_reference(sz, args.seed, clock)
        phase_generation(sz, args.seed, clock)
    log(f"all phases passed in {time.perf_counter() - t0:.1f} s "
        f"[{clock.card}]; peak device bytes "
        f"{(jax.devices()[0].memory_stats() or {}).get('peak_bytes_in_use')}")
    log(info["card"])
    print(json.dumps({"ok": True, "device": {
        "platform": jax.devices()[0].platform,
        "kind": jax.devices()[0].device_kind,
        "count": len(jax.devices())}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
