"""Generate scattering-spectra realizations calibrated to the bundled
S&P daily series.

Rebuild of ``/root/reference/scripts/snp_generation.py``: same
CLI surface (``-ntot``/``-tid`` job-array sharding, ``-J``, ``-R``,
``--epsilon``) with the same semantics — task ``tid`` of ``ntot`` generates
``R // ntot`` trajectories into a shared cache directory, independently
restartable; ``batch_generations`` then regroups shards for fast loading.

Example (single task):
    python -m shadowing_tpu.cli.snp_generation -R 1024 -J 9 --epsilon 1e-2
Job array (4 tasks):
    python -m shadowing_tpu.cli.snp_generation -ntot 4 -tid $TASK_ID
"""
from __future__ import annotations

import argparse
from pathlib import Path

import numpy as np


def get_args():
    parser = argparse.ArgumentParser(description=__doc__)
    parser.add_argument("-ntot", type=int, default=None,
                        help="total number of job-array tasks (default: the "
                        "JAX process count — on several hosts the "
                        "same invocation on every host partitions the work)")
    parser.add_argument("-tid", type=int, default=None,
                        help="this task's id (default: jax.process_index())")
    parser.add_argument("-J", type=int, default=9, help="number of scales")
    parser.add_argument("-R", type=int, default=32768,
                        help="total number of realizations (over all tasks)")
    parser.add_argument("--epsilon", type=float, default=1e-2,
                        help="per-seed RMS statistic mismatch tolerance")
    parser.add_argument("--max-iterations", type=int, default=1000)
    parser.add_argument("-T", type=int, default=None,
                        help="trajectory length (default: pow2 >= observed)")
    parser.add_argument("--batch", type=int, default=256,
                        help="seeds optimised together per device batch")
    parser.add_argument("--start", default="03-01-2000")
    parser.add_argument("--end", default="31-12-2014")
    parser.add_argument("--data", type=Path, default=None,
                        help="calibration series as an snp_daily-schema .npz "
                        "(produce one from a real date,close CSV with "
                        "shadowing_tpu.cli.ingest_prices); default: the "
                        "bundled synthetic stand-in")
    parser.add_argument("--cache", type=Path,
                        default=Path(__file__).parents[2] / "_cache"
                        / "snp_generation")
    parser.add_argument("--seed", type=int, default=0)
    parser.add_argument("--init", choices=("auto", "coloured", "white"),
                        default="auto",
                        help="seed initialisation: 'auto' (spectrum-coloured"
                        " + per-seed-calibrated volatility envelope),"
                        " 'coloured' (spectrum only) or 'white'")
    parser.add_argument("-q", "--quiet", action="store_true")
    return parser.parse_args()


def main():
    args = get_args()
    from shadowing_tpu import SPDaily, generate
    from shadowing_tpu.parallel.multihost import initialize, task_split
    from shadowing_tpu.utils import enable_compile_cache

    enable_compile_cache()

    initialize()  # no-op single-host; joins the process grid otherwise
    ntot, tid = task_split(args.ntot, args.tid)
    snp = SPDaily(start=args.start, end=args.end, path=args.data)
    r_task = args.R // ntot
    out_file = Path(args.cache) / f"task{tid:05d}_R{r_task}.npy"
    out_file.parent.mkdir(parents=True, exist_ok=True)
    if out_file.exists():
        print(f"{out_file} already exists — skipping (restart semantics)")
        print("FINISHED")
        return

    x_gen = generate(
        x=snp,
        gen_log_returns=True,
        R=r_task,
        J=args.J,
        T=args.T,
        tol_optim=args.epsilon,
        max_iterations=args.max_iterations,
        cache_path=Path(args.cache) / "_shards",
        verbose=not args.quiet,
        # disjoint reproducible stream per task (reference ntot/tid pattern)
        seed=args.seed * ntot + tid,
        batch=args.batch,
        init=args.init,
    )
    np.save(out_file, x_gen.astype(np.float32))
    print(f"wrote {out_file}: {x_gen.shape}")
    print("FINISHED")


if __name__ == "__main__":
    main()
