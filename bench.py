"""Benchmark: end-to-end Path Shadowing Monte Carlo on one GPU.

Prints ONE JSON line:
  {"metric": ..., "value": N, "unit": "s", "vs_baseline": N, "device": ...}

* ``value``: warm end-to-end seconds for the driver target config
  (BASELINE.md): shadow search over R=32768 x 4096 (w=20, k=1024) +
  softmax realized-variance prediction (Ts=5/10/20) + conditional
  Hedged-MC smile (3 maturities x 9 moneyness) — target < 1 s.
* ``vs_baseline``: speedup on the reference's own published benchmark
  (testing.ipynb cell 3: predict() over 131072 x 4096, Foveal 126 -> 34-d,
  k=10000, horizon=252 — 2.65 s on the reference's CUDA GPU).

Extra context (generation throughput, phase timings) goes to stderr. Every
result names the device it ran on (platform, device_kind, count) and the
card's name and power limit. Env knobs: BENCH_SKIP_REF=1 skips the big
reference config, BENCH_SKIP_GEN=1 skips generation throughput.
"""
from __future__ import annotations

import json
import os
import subprocess
import sys
import time

import numpy as np

REF_BASELINE_S = 2.65  # testing.ipynb cell 3 tqdm output (reference GPU)


def log(*a):
    print(*a, file=sys.stderr, flush=True)


def median_time(fn, n=3):
    ts = []
    for _ in range(n):
        t0 = time.perf_counter()
        fn()
        ts.append(time.perf_counter() - t0)
    return float(np.median(ts))


def bench_target_config():
    """Shadow + vol predict + smile, R=32768, w=20, k=1024 (< 1 s target)."""
    from shadowing_tpu import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        SPDaily,
        realized_variance,
    )

    rng = np.random.default_rng(0)
    dataset = (rng.standard_normal((32768, 1, 4096)) * 0.011).astype(np.float32)
    ctx = SPDaily().dlnx[0, 0, -20:].astype(np.float32)
    Ts = np.array([5, 10, 20])
    Ms = np.linspace(-2, 2, 9)

    mesh = None
    if os.environ.get("BENCH_MESH"):  # run the pipeline mesh-sharded instead
        from shadowing_tpu.parallel.sharding import data_mesh

        mesh = data_mesh(int(os.environ["BENCH_MESH"]))
        log(f"[target] mesh mode: {mesh.shape}")
    obj = PathShadowing(
        Identity(20), RelativeMSE(), dataset, PredictionContext(horizon=20),
        mesh=mesh,
    )
    to_predict = lambda x: realized_variance(x[:, :, 0, :], Ts=Ts, vol=False)

    def e2e():
        # one search feeds both the vol prediction and the conditional
        # smile, device-resident end to end; only final grids reach the
        # host (two batched round trips total)
        vars_, _, smiles = obj.predict_and_smile(
            ctx, k=1024, to_predict=to_predict, Ts=Ts, Ms=Ms,
            eta=0.1, eta_smile=0.075,
        )
        return vars_, smiles[0]

    t0 = time.perf_counter()
    e2e()  # compile + norms cache
    log(f"[target] first call (compile + norms): {time.perf_counter()-t0:.1f}s")
    t = median_time(e2e, n=3)
    log(f"[target] warm e2e shadow+predict+smile: {t:.3f}s")

    t_mesh = None
    if mesh is None and os.environ.get("BENCH_SKIP_MESH") != "1":
        # the mesh route at mesh=1: records the mesh-mode overhead vs the
        # single-device engine on this card
        from shadowing_tpu.parallel.sharding import data_mesh

        obj_m = PathShadowing(
            Identity(20), RelativeMSE(), dataset,
            PredictionContext(horizon=20), mesh=data_mesh(1),
        )

        def e2e_mesh():
            return obj_m.predict_and_smile(
                ctx, k=1024, to_predict=to_predict, Ts=Ts, Ms=Ms,
                eta=0.1, eta_smile=0.075,
            )

        t0 = time.perf_counter()
        e2e_mesh()
        log(f"[target] mesh=1 first call: {time.perf_counter()-t0:.1f}s")
        t_mesh = median_time(e2e_mesh, n=3)
        log(f"[target] warm e2e, mesh=1 engine: "
            f"{t_mesh:.3f}s ({t_mesh/t:.2f}x single-device)")
    return t, t_mesh


def bench_reference_config():
    """The reference's perf cell: 131072 x 4096, Foveal -> 34d, k=10000."""
    from shadowing_tpu import (
        Foveal,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
        realized_variance,
    )

    rng = np.random.default_rng(1)
    dataset = (rng.standard_normal((131072, 1, 4096)) * 0.011).astype(np.float32)
    ctx = (rng.standard_normal((1, 1, 126)) * 0.011).astype(np.float32)
    emb = Foveal(alpha=1.15, beta=0.9, max_context=126)
    obj = PathShadowing(
        emb, RelativeMSE(), dataset, PredictionContext(horizon=252)
    )
    to_predict = lambda x: realized_variance(x, Ts=[2, 7, 252], vol=False)

    def predict():
        return obj.predict(ctx, k=10000, to_predict=to_predict, eta=0.1)

    t0 = time.perf_counter()
    predict()
    log(f"[ref-cfg] first call (compile + norms): {time.perf_counter()-t0:.1f}s")
    t = median_time(predict, n=3)
    log(f"[ref-cfg] warm predict(): {t:.3f}s  "
        f"(reference GPU: {REF_BASELINE_S:.2f}s -> {REF_BASELINE_S/t:.1f}x)")
    return t


def bench_generation():
    """Scattering-synthesis throughput on the reference's own generation
    config (snp_generation.py defaults: J=9, tol 1e-2, <=1000 iterations).

    Measures: cold + warm-median paths/s on the device, the gain from
    retiring converged seeds (vs the full-batch-until-all-converged
    schedule), the achieved rms-vs-tol of the produced batch, and a
    *measured* host-CPU baseline (per-seed-step cost at small batch, scaled
    to the identical seed-step workload the device run actually paid).
    """
    import jax
    import jax.numpy as jnp

    from shadowing_tpu import SPDaily
    from shadowing_tpu.models.scattering.moments import scattering_stats
    from shadowing_tpu.models.scattering.synthesis import (
        _optimize_segment,
        should_standardize,
        synthesize_batch,
        warmup_executables,
    )
    from shadowing_tpu.models.scattering.wavelets import build_filter_bank

    # batch 1024 is the production compute batch: the reference CLI
    # generates R=32768 trajectories (snp_generation.py:19) and its "256"
    # is the .npy FILE-shard size (batch_generations.py:45), not a compute
    # batch. The CPU/device ratio is priced per seed-step on both sides
    # (schedule-invariant — see BASELINE.md protocol), so the batch choice
    # favours neither.
    batch, J, T, tol, max_iter, seg = 1024, 9, 4096, 1e-2, 1000, 100

    snp = SPDaily(start="03-01-2000", end="31-12-2014")
    dlnx = np.ravel(snp.dlnx).astype(np.float64)
    z_obs = (dlnx - dlnx.mean()) / dlnx.std()
    bank_obs = build_filter_bank(len(z_obs), J)
    target = scattering_stats(jnp.asarray(z_obs, jnp.float32), bank_obs)
    bank = build_filter_bank(T, J)

    def run(seed, compact=True):
        wl = {}
        t0 = time.perf_counter()
        _, rms = synthesize_batch(
            jax.random.PRNGKey(seed), target, bank, batch=batch,
            max_iterations=max_iter, tol=tol, segment=seg, compact=compact,
            work_log=wl,
        )
        return time.perf_counter() - t0, rms, wl

    dt_cold, _, _ = run(0)
    # warm the jit call cache for every executable shape the runs (both
    # compact and the no-compaction baseline) can dispatch, then one
    # untimed full run, so the timed runs compile nothing
    std = should_standardize(target)
    n_exec = sum(
        warmup_executables(target, bank, batch, segment=seg,
                           max_iterations=max_iter, compact=c)
        for c in (True, False)
    )
    log(f"[gen] warmed {n_exec} segment executables")
    dt_pipe, _, _ = run(99)
    log(f"[gen] cold (compiles + warm-up): {dt_cold:.1f}s, "
        f"pipe-cleaner run: {dt_pipe:.1f}s")
    # median of 5: one stalled rep cannot move the median
    times, rms, wl = [], None, None
    for seed in (1, 2, 3, 4, 5):
        dt, rms, wl = run(seed)
        times.append(dt)
    log(f"[gen] warm run times: {[round(t, 1) for t in times]}s")
    t_warm = float(np.median(times))
    pps = batch / t_warm
    conv = float((rms < tol).mean())
    log(f"[gen] warm {batch} paths (J={J}, T={T}, tol={tol:g}, "
        f"<= {max_iter} iters): {t_warm:.1f}s -> {pps:.1f} paths/s | "
        f"rms median={np.median(rms):.4f} converged={100*conv:.0f}% | "
        f"seed-steps paid={wl['seed_steps']}")
    # phase breakdown of the last warm run: submit/harvest lists localise
    # any blocked dispatch; the fused drain reports its one-dispatch wall.
    t_loop = wl["t_loop_s"]
    log(f"[gen] work_log phases (last warm run, wall {wl['t_total_s']:.2f}s):"
        f" init {wl['t_init_s']:.2f}s"
        f" | loop {t_loop:.2f}s (submits {sum(wl['t_submits']):.2f}s over "
        f"{len(wl['t_submits'])}, harvest joins {wl['t_harvest_s']:.2f}s over"
        f" {wl['n_harvests']})"
        f" | finalize {wl['t_finalize_s']:.2f}s"
        f" (refetch {wl.get('t_refetch_s', 0):.2f}s of "
        f"{wl.get('refetch_rows', 0)} rows, snap join "
        f"{wl.get('t_snap_join_s', 0):.2f}s)"
        f" | drain {wl.get('drain', 'not entered')}")

    dt_nc, _, wl_nc = run(2, compact=False)
    log(f"[gen] no-compaction (full-batch-until-all-converged, same seed "
        f"and lr schedule): {dt_nc:.1f}s ({wl_nc['seed_steps']} seed-steps)"
        f" -> compaction speedup {dt_nc / t_warm:.2f}x")

    # host-CPU baseline: measured per-seed-step cost, scaled to the same
    # seed-step workload the device run paid (CPU FFT cost is batch-linear;
    # small-batch measurement slightly favours the CPU).
    gen_vs_cpu = None
    try:
        cpu = jax.devices("cpu")[0]
    except RuntimeError as e:  # no CPU backend: report the device only
        log(f"[gen] no host CPU backend ({e}); skipping CPU baseline")
        cpu = None
    if cpu is not None:
        b_cpu, steps_cpu = 16, 10
        with jax.default_device(cpu):
            tgt_c = jax.device_put(target, cpu)
            psi_c = jax.device_put(jnp.asarray(bank.psi_hat), cpu)
            z0 = jax.random.normal(jax.random.PRNGKey(0), (b_cpu, T),
                                   jnp.float32)
            zeros = jnp.zeros_like(z0)
            i0 = jnp.asarray(0.0)
            # warm the CPU jit (2 steps), then measure
            np.asarray(_optimize_segment(z0, zeros, zeros, i0, tgt_c, psi_c,
                                         J=J, n_steps=2,
                                         bands=bank.band_hi or None,
                                         standardize=std)[0])
            # MIN over 5 reps: host-clock contention only ever slows the
            # CPU, so the minimum is the fairest (most CPU-favourable)
            # estimate; observed same-day spread on this VM 2.5-8 ms
            ts_cpu = []
            for _ in range(5):
                t0 = time.perf_counter()
                np.asarray(_optimize_segment(z0, zeros, zeros, i0, tgt_c,
                                             psi_c, J=J, n_steps=steps_cpu,
                                             bands=bank.band_hi or None,
                                             standardize=std)[0])
                ts_cpu.append(time.perf_counter() - t0)
            dt_cpu = float(np.min(ts_cpu))
        per_seed_step_cpu = dt_cpu / (steps_cpu * b_cpu)
        cpu_pps = batch / (per_seed_step_cpu * wl["seed_steps"])
        gen_vs_cpu = pps / cpu_pps
        cpu_per_step = per_seed_step_cpu
        log(f"[gen] CPU: {per_seed_step_cpu*1e3:.2f} ms/seed-step "
            f"(min of 5, batch {b_cpu} x {steps_cpu} steps; rep spread "
            f"{min(ts_cpu):.2f}-{max(ts_cpu):.2f}s) -> "
            f"{cpu_pps:.3f} paths/s on this workload -> the device is "
            f"{gen_vs_cpu:.0f}x CPU")

    # in-dispatch seed-step cost: K chained full-batch segments, ONE sync —
    # the device's rate without the host scheduling that wall time pays.
    # Reuses the exact warmed (batch, segment, non-compact) executable.
    from shadowing_tpu.models.scattering.synthesis import (
        _SEG_CHUNK, _psi_device, default_lr_schedule)
    lr = default_lr_schedule(max_iter)
    psi = _psi_device(bank)
    bands = bank.band_hi or None
    zd = jnp.zeros((batch, T), jnp.float32)
    md, vd = zd, zd
    i0 = jnp.asarray(0, jnp.float32)
    K = 3
    t0 = time.perf_counter()
    for _ in range(K):
        zd, md, vd, ld = _optimize_segment(
            zd, md, vd, i0, target, psi, J=J, n_steps=seg, lr=lr,
            bands=bands, standardize=std, chunk=_SEG_CHUNK)
    jax.block_until_ready(ld)
    disp_s = (time.perf_counter() - t0) / (K * seg * batch)
    log(f"[gen] in-dispatch: {disp_s*1e6:.1f} us/seed-step ({K} chained "
        f"{batch}x{seg}-step segments, one sync)")
    return {
        "gen_paths_per_s": round(pps, 2),
        "gen_vs_cpu": round(gen_vs_cpu, 1) if gen_vs_cpu else None,
        "gen_vs_cpu_dispatch": (
            round(cpu_per_step / disp_s, 1) if gen_vs_cpu else None),
        "gen_rms_median": round(float(np.median(rms)), 4),
        "gen_converged_frac": round(conv, 3),
        "gen_compaction_speedup": round(dt_nc / t_warm, 2),
        "gen_us_step_wall": round(t_warm / wl["seed_steps"] * 1e6, 1),
        "gen_us_step_dispatch": round(disp_s * 1e6, 1),
        "gen_overlap_fetch": bool(wl.get("overlap_fetch")),
        "gen_drain": wl.get("drain"),
    }


def bench_full_r():
    """The reference's REAL generation workload: R=32768 trajectories
    (snp_generation.py:19) at the production compute batch, via the public
    ``generate()`` (shard cache + restart exercised live). Must run AFTER
    bench_generation in the same process: the shard executables are warm
    then, so this measures sustained throughput, not compiles."""
    import shutil
    import tempfile
    from pathlib import Path

    from shadowing_tpu import SPDaily
    from shadowing_tpu.models.scattering.generate import generate

    R, batch = (int(os.environ.get("BENCH_FULLR_R", "32768")),
                int(os.environ.get("BENCH_FULLR_BATCH", "1024")))
    snp = SPDaily(start="03-01-2000", end="31-12-2014")
    cache = Path(tempfile.mkdtemp(prefix="bench_fullr_"))
    walls = []
    try:
        t0 = time.perf_counter()
        x = generate(x=snp, R=R, J=9, tol_optim=1e-2, max_iterations=1000,
                     batch=batch, seed=7, cache_path=cache,
                     shard_walls=walls)
        wall = time.perf_counter() - t0
        assert x.shape[0] == R and not any(c for _, c in walls)
        per = [w for w, _ in walls]
        # restart semantics, live: a second identical call must reload
        # every shard from the cache (the job-array crash-recovery story)
        walls2 = []
        t0 = time.perf_counter()
        x2 = generate(x=snp, R=R, J=9, tol_optim=1e-2, max_iterations=1000,
                      batch=batch, seed=7, cache_path=cache,
                      shard_walls=walls2)
        t_restart = time.perf_counter() - t0
        assert x2.shape == x.shape and all(c for _, c in walls2)
    finally:
        shutil.rmtree(cache, ignore_errors=True)
    log(f"[full-R] {R} paths ({len(per)} shards x {batch}): {wall:.1f}s -> "
        f"{R / wall:.1f} paths/s sustained | shard walls "
        f"median {np.median(per):.2f}s spread {min(per):.2f}-{max(per):.2f}s"
        f" | restart (all-cached) pass: {t_restart:.1f}s")
    return {
        "gen_full_R": R,
        "gen_full_R_paths_per_s": round(R / wall, 1),
        "gen_full_R_shard_wall_s": [round(min(per), 2),
                                    round(float(np.median(per)), 2),
                                    round(max(per), 2)],
        "gen_full_R_restart_s": round(t_restart, 1),
    }


def bench_backtest():
    """Rolling-backtest throughput (dates/s): the production workflow,
    chunk-pipelined predict() over many historical dates."""
    from shadowing_tpu import (
        Identity,
        PathShadowing,
        PredictionContext,
        RelativeMSE,
    )
    from shadowing_tpu.backtest import rolling_backtest

    rng = np.random.default_rng(2)
    dataset = (rng.standard_normal((32768, 1, 4096)) * 0.011).astype(np.float32)
    n_dates, w = 2048, 20
    chunk = int(os.environ.get("BENCH_BT_CHUNK", "64"))
    series = (rng.standard_normal(n_dates + w + 20 - 1) * 0.011).astype(
        np.float32
    )
    mesh = None
    if os.environ.get("BENCH_MESH"):
        from shadowing_tpu.parallel.sharding import data_mesh

        mesh = data_mesh(int(os.environ["BENCH_MESH"]))
        log(f"[backtest] mesh mode: {mesh.shape}")
    obj = PathShadowing(
        Identity(w), RelativeMSE(), dataset, PredictionContext(horizon=20),
        mesh=mesh,
    )

    def run():
        return rolling_backtest(
            obj, series, w=w, Ts=[5, 10, 20], k=1024,
            n_context_splits=-(-n_dates // chunk),
        )

    t0 = time.perf_counter()
    run()
    log(f"[backtest] first call (compile): {time.perf_counter()-t0:.1f}s")
    t = median_time(run, n=3)
    rate = n_dates / t
    log(f"[backtest] warm {n_dates} dates (B={chunk} chunks, k=1024, "
        f"R=32768x4096): {t:.2f}s -> {rate:.0f} dates/s "
        f"(factored pass-1: {obj._factored is not None})")
    for line in obj.routing_log:
        log(f"[backtest]   route: {line}")
    out = {"backtest_dates_per_s": round(rate),
           "backtest_factored": obj._factored is not None}

    if mesh is None and os.environ.get("BENCH_SKIP_SCALEK") != "1":
        # BASELINE's scale row (k <= 16,384): a different pass-2 selection
        # regime (cap*block ~ n) than anything k=1024 exercises. Reduced
        # date count — the per-chunk cost is what scales.
        k_big, n_dates_k = 16384, 256
        s_k = series[: n_dates_k + w + 20 - 1]

        def run_k():
            return rolling_backtest(
                obj, s_k, w=w, Ts=[5, 10, 20], k=k_big,
                n_context_splits=-(-n_dates_k // chunk),
            )

        t0 = time.perf_counter()
        run_k()
        log(f"[backtest] k={k_big} first call (compile): "
            f"{time.perf_counter()-t0:.1f}s")
        t_k = median_time(run_k, n=3)
        log(f"[backtest] warm {n_dates_k} dates at k={k_big} (B={chunk} "
            f"chunks, R=32768x4096): {t_k:.2f}s -> {n_dates_k / t_k:.0f} "
            f"dates/s")
        out["backtest_k16384_dates_per_s"] = round(n_dates_k / t_k)

    if mesh is None and os.environ.get("BENCH_SKIP_MESH") != "1":
        # the mesh-mode backtest, shrunk to the cards present: same workload
        # through the sharded engine
        from shadowing_tpu.parallel.sharding import data_mesh

        del obj  # free E + pad views before a second engine builds its own
        obj_m = PathShadowing(
            Identity(w), RelativeMSE(), dataset,
            PredictionContext(horizon=20), mesh=data_mesh(1),
        )

        def run_m():
            return rolling_backtest(
                obj_m, series, w=w, Ts=[5, 10, 20], k=1024,
                n_context_splits=-(-n_dates // chunk),
            )

        t0 = time.perf_counter()
        run_m()
        log(f"[backtest] mesh=1 first call: {time.perf_counter()-t0:.1f}s")
        t_m = median_time(run_m, n=3)
        log(f"[backtest] warm mesh=1 engine: {t_m:.2f}s -> "
            f"{n_dates / t_m:.0f} dates/s ({t_m / t:.2f}x single-device; "
            f"factored: {obj_m._factored is not None})")
        out["backtest_mesh1_dates_per_s"] = round(n_dates / t_m)
        del obj_m  # free its E before the smile engine builds pad views

    if mesh is None and os.environ.get("BENCH_SKIP_SCALEK") != "1":
        # BASELINE scale row (b): conditional smiles at k=16384 over
        # 75-step maturities — the workload the HMC moment-knot grid
        # targets (N >= 2048 routes to the sort-free lognormal-moment
        # knots). B=4 contexts price in ONE vmapped dispatch.
        try:
            del obj  # mesh section may have freed it already
        except NameError:
            pass
        obj_s = PathShadowing(
            Identity(w), RelativeMSE(), dataset,
            PredictionContext(horizon=75),
        )
        ctx = np.stack([series[i: i + w] for i in range(4)])
        Ms = np.linspace(-2.0, 2.0, 7)

        def run_s():
            return obj_s.conditional_smile(ctx, k=16384, Ts=[25, 50, 75],
                                           Ms=Ms)

        t0 = time.perf_counter()
        run_s()
        log(f"[smile] k=16384 first call (compile): "
            f"{time.perf_counter()-t0:.1f}s")
        t_s = median_time(run_s, n=3)
        log(f"[smile] warm conditional_smile B=4 k=16384 Ts=[25,50,75] "
            f"Ms=7: {t_s:.3f}s")
        out["smile_k16384_s"] = round(t_s, 4)
    return out


def probe_host_load():
    """Single-core host probe (~100 ms of fixed numpy work, best of 3).

    The backtest/CPU-baseline numbers are host-sensitive: a concurrent
    host-heavy job swings recorded throughput. Recording the probe
    alongside the results lets a depressed record explain itself."""
    a = np.random.default_rng(0).standard_normal((512, 512))
    ts = []
    for _ in range(3):
        t0 = time.perf_counter()
        for _ in range(40):
            np.fft.rfft(a, axis=-1)
        ts.append(time.perf_counter() - t0)
    return float(min(ts))


def device_info() -> dict:
    """The device every result ran on: JAX's view and nvidia-smi's."""
    import jax

    try:
        smi = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"],
            capture_output=True, text=True, timeout=60, check=True,
        ).stdout.strip()
    except (OSError, subprocess.SubprocessError):
        smi = None
    d0 = jax.devices()[0]
    return {"platform": d0.platform, "kind": d0.device_kind,
            "count": len(jax.devices()), "card": smi}


def main():
    from shadowing_tpu.utils import enable_compile_cache

    enable_compile_cache()
    dev = device_info()
    log(f"[device] {dev}")
    t_probe0 = probe_host_load()
    log(f"[host] single-core load probe: {t_probe0*1e3:.0f} ms")
    t_target, t_mesh = bench_target_config()
    vs = None
    if os.environ.get("BENCH_SKIP_REF") != "1":
        t_ref = bench_reference_config()
        vs = REF_BASELINE_S / t_ref
    bt = {}
    if os.environ.get("BENCH_SKIP_BACKTEST") != "1":
        bt = bench_backtest()
    gen = {}
    if os.environ.get("BENCH_SKIP_GEN") != "1":
        gen = bench_generation()
        if os.environ.get("BENCH_SKIP_FULLR") != "1":
            # needs bench_generation's warm executables in-process
            gen.update(bench_full_r())
    t_probe1 = probe_host_load()
    log(f"[host] single-core load probe at end: {t_probe1*1e3:.0f} ms")
    print(json.dumps({
        "metric": "e2e shadow+vol-predict+smile, R=32768x4096 w=20 k=1024 "
                  "(vs_baseline: speedup on reference testing.ipynb cell-3 "
                  "config, 131072x4096 Foveal k=10000, 2.65s CUDA)",
        "value": round(t_target, 4),
        "unit": "s",
        "vs_baseline": round(vs, 2) if vs is not None else None,
        "e2e_mesh1_s": round(t_mesh, 4) if t_mesh is not None else None,
        **bt,
        **gen,
        "device": dev,
        "host_probe_ms": [round(t_probe0 * 1e3), round(t_probe1 * 1e3)],
    }))


if __name__ == "__main__":
    main()
