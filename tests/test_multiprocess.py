"""Multi-HOST smoke: two real JAX processes form one 8-device CPU mesh.

The real thing, not a monkeypatch: each process sees only its own 4
virtual devices, loads only its own global dataset row range from the
"disk" (per-host residency via ``host_row_range``), contributes it with
``shard_dataset_from_local``, and runs the public mesh engine. Results
must be identical across processes and equal to the single-process
oracle. On several GPU hosts the same code path only swaps the backend.
"""
import os
import socket
import subprocess
import sys
from pathlib import Path

import numpy as np

_WORKER = """
import os, sys
pid = int(sys.argv[1]); nproc = int(sys.argv[2]); port = sys.argv[3]
outdir = sys.argv[4]
os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
import jax
jax.config.update("jax_platforms", "cpu")
jax.distributed.initialize(coordinator_address=f"localhost:{port}",
                           num_processes=nproc, process_id=pid)
import numpy as np
from shadowing_tpu import Identity, PathShadowing, PredictionContext, RelativeMSE
from shadowing_tpu.parallel.multihost import (
    host_row_range, shard_dataset_from_local, task_split)
from shadowing_tpu.parallel.sharding import data_mesh

assert jax.process_count() == nproc and jax.process_index() == pid
assert len(jax.devices()) == 4 * nproc and len(jax.local_devices()) == 4

rng = np.random.default_rng(0)
R_true, C, T, w, h, k = 43, 1, 128, 16, 8, 12
full = rng.normal(0, 0.02, size=(R_true, C, T)).astype(np.float32)
ctx = rng.normal(0, 0.02, size=(2, C, w)).astype(np.float32)

mesh = data_mesh()
lo, hi = host_row_range(R_true, mesh)
local_rows = full[lo:min(hi, R_true)]          # per-host residency
g = shard_dataset_from_local(local_rows, mesh, R_true)

obj = PathShadowing(Identity(w), RelativeMSE(), g, PredictionContext(h),
                    mesh=mesh, n_trajectories=R_true)
d, p, i = obj.shadow(ctx, k=k)
assert task_split() == (nproc, pid)
np.savez(f"{outdir}/result_{pid}.npz", d=np.asarray(d), i=np.asarray(i))
print(f"proc {pid}: ok", flush=True)
"""


def _free_port():
    s = socket.socket()
    s.bind(("localhost", 0))
    port = s.getsockname()[1]
    s.close()
    return port


def test_two_process_mesh_matches_single_process(tmp_path):
    worker = tmp_path / "worker.py"
    worker.write_text(_WORKER)
    port = _free_port()
    repo = Path(__file__).parents[1]
    # the workers execute a script from tmp_path, so the repo root is not
    # on their sys.path (python adds the SCRIPT dir, not the cwd) — make
    # the package importable without requiring an installed copy
    env = dict(os.environ)
    # no trailing separator when PYTHONPATH is unset: an empty entry means
    # "current directory" on sys.path, silently widening the import path
    env["PYTHONPATH"] = os.pathsep.join(
        filter(None, [str(repo), env.get("PYTHONPATH")])
    )
    procs = [
        subprocess.Popen(
            [sys.executable, str(worker), str(i), "2", str(port),
             str(tmp_path)],
            stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
            cwd=repo, env=env,
        )
        for i in range(2)
    ]
    outs = []
    for p in procs:
        out, _ = p.communicate(timeout=280)
        outs.append(out)
    for i, (p, o) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"worker {i} failed:\n{o[-3000:]}"

    r0 = np.load(tmp_path / "result_0.npz")
    r1 = np.load(tmp_path / "result_1.npz")
    np.testing.assert_array_equal(r0["d"], r1["d"])
    np.testing.assert_array_equal(r0["i"], r1["i"])

    # single-process oracle (this process: plain engine, no mesh)
    from shadowing_tpu import (
        Identity, PathShadowing, PredictionContext, RelativeMSE,
    )

    rng = np.random.default_rng(0)
    full = rng.normal(0, 0.02, size=(43, 1, 128)).astype(np.float32)
    ctx = rng.normal(0, 0.02, size=(2, 1, 16)).astype(np.float32)
    obj = PathShadowing(Identity(16), RelativeMSE(), full,
                        PredictionContext(8))
    d_ref, _, i_ref = obj.shadow(ctx, k=12)
    np.testing.assert_array_equal(r0["i"], i_ref)
    np.testing.assert_array_equal(r0["d"], d_ref)
