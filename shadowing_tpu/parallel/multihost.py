"""Multi-host seams: process-keyed generation and per-host residency.

The reference scales generation with SLURM job arrays
(``/root/reference/scripts/snp_generation.py:14-20``: ``-ntot``/``-tid``)
and has no multi-host compute at all. The mapping here (SURVEY.md §5) is
single-controller multi-process JAX:

* **Generation (embarrassingly parallel)**: job-array task id maps to
  ``jax.process_index()`` (:func:`task_split`). Each host synthesises its
  own ``R / ntot`` slice with a disjoint, reproducible PRNG stream and
  writes its own shard files — purely host-local compute, the network
  carries nothing; restart stays per host exactly like the reference's job
  array.
* **Shadow search (data-parallel over R)**: the dataset axis is sharded
  over *all* devices of a multi-host mesh. Each host loads only its own
  global row range from disk (:func:`host_row_range` — per-host dataset
  residency) and contributes it with
  ``jax.make_array_from_process_local_data``
  (:func:`shard_dataset_from_local`); the search's one ``all_gather`` of
  (B, k) candidate pairs rides NVLink within a host and the network across
  hosts, payload O(B·k·n_dev) — independent of R, so the dataset itself
  never crosses the network.

Single-process environments run the very same code paths
(``process_count() == 1``), which is what the test suite and the driver's
virtual-device dryrun exercise; a real multi-host run additionally calls
:func:`initialize` (or ``jax.distributed.initialize``) before first JAX use.
"""
from __future__ import annotations

from typing import Optional, Tuple

import numpy as np

from shadowing_tpu.parallel.sharding import DATA_AXIS


def initialize(
    coordinator_address: Optional[str] = None,
    num_processes: Optional[int] = None,
    process_id: Optional[int] = None,
) -> None:
    """Idempotent ``jax.distributed.initialize`` wrapper.

    On a single host (no coordinator configured, no args) this is a no-op,
    so entry points can call it unconditionally. Arguments default to the
    standard env plumbing (``JAX_COORDINATOR_ADDRESS`` etc.).

    CAREFUL inside: ``jax.distributed.initialize`` must run before anything
    that initialises the XLA backends — even ``jax.process_count()`` does —
    so the already-initialised check inspects the distributed client state
    directly instead of touching any backend API.
    """
    import os

    env_has_coord = bool(
        coordinator_address or os.environ.get("JAX_COORDINATOR_ADDRESS")
    )
    if not env_has_coord and num_processes is None:
        return  # single-host run: nothing to join
    try:
        from jax._src import distributed as _dist

        if getattr(_dist.global_state, "client", None) is not None:
            return  # already initialised
    except Exception:
        pass  # private-state probe unavailable: fall through, catch below
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        if "already" in str(e).lower():
            return  # concurrent/repeated init: keep the existing cluster
        raise


def task_split(
    ntot: Optional[int] = None, tid: Optional[int] = None
) -> Tuple[int, int]:
    """Resolve the reference's job-array ``(ntot, tid)`` pair.

    Explicit values win (OS-level job arrays keep working); otherwise the
    JAX process grid supplies them, so the same CLI invocation on every
    host partitions the work automatically.
    """
    import jax

    if ntot is None:
        ntot = jax.process_count()
    if tid is None:
        tid = jax.process_index()
    if not 0 <= tid < ntot:
        raise ValueError(f"task id {tid} out of range for ntot={ntot}")
    return int(ntot), int(tid)


def _mesh_process_blocks(mesh) -> dict:
    """Map ``process_index -> (first, last) device position`` in mesh order.

    Validates that each process's devices are contiguous along the data
    axis — the layout :func:`host_row_range` (and disk layout) relies on.
    """
    devs = list(np.ravel(mesh.devices))
    blocks: dict = {}
    for pos, d in enumerate(devs):
        p = getattr(d, "process_index", 0)
        if p in blocks:
            lo, hi = blocks[p]
            if pos != hi + 1:
                raise ValueError(
                    "mesh devices of one process are not contiguous along "
                    "the data axis — build the mesh in device order "
                    "(jax.devices() is already process-major)"
                )
            blocks[p] = (lo, pos)
        else:
            blocks[p] = (pos, pos)
    return blocks


def host_row_range(R_true: int, mesh) -> Tuple[int, int]:
    """Global dataset row interval ``[start, stop)`` owned by this process.

    R is zero-padded to a multiple of the mesh size (the engine's padding
    contract); each device owns ``R_pad / n_dev`` consecutive rows and each
    process owns its devices' union. Callers load **only** these rows from
    disk — per-host dataset residency; rows at ``>= R_true`` are padding
    the caller fills with zeros (:func:`shard_dataset_from_local` does).
    """
    import jax

    n_dev = mesh.shape[DATA_AXIS]
    r_pad = -(-R_true // n_dev) * n_dev
    rpd = r_pad // n_dev
    lo, hi = _mesh_process_blocks(mesh)[jax.process_index()]
    return lo * rpd, (hi + 1) * rpd


def shard_dataset_from_local(
    y_local: np.ndarray, mesh, R_true: int
) -> "jax.Array":
    """Assemble the global ``(R_pad, C, T)`` dataset from this host's rows.

    :param y_local: this process's rows — either exactly the
        :func:`host_row_range` slab, or the slab clipped at ``R_true``
        (the natural thing to load from disk); missing pad rows are
        zero-filled here.
    :param R_true: true global trajectory count (pre-padding). Pass it on
        to ``PathShadowing(..., n_trajectories=R_true)`` so padded rows
        are masked out of the search.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    start, stop = host_row_range(R_true, mesh)
    y_local = np.asarray(y_local, np.float32)
    if y_local.ndim != 3:
        raise ValueError(f"expected (rows, C, T), got {y_local.shape}")
    want_data = min(stop, R_true) - min(start, R_true)  # non-pad rows here
    if y_local.shape[0] == want_data and stop - start > want_data:
        pad = np.zeros((stop - start - want_data,) + y_local.shape[1:],
                       np.float32)
        y_local = np.concatenate([y_local, pad])
    if y_local.shape[0] != stop - start:
        raise ValueError(
            f"this process owns rows [{start}, {stop}) "
            f"({stop - start} rows, {want_data} of them data) — got "
            f"{y_local.shape[0]} rows"
        )
    sharding = NamedSharding(mesh, P(DATA_AXIS, None, None))
    n_dev = mesh.shape[DATA_AXIS]
    r_pad = -(-R_true // n_dev) * n_dev
    return jax.make_array_from_process_local_data(
        sharding, y_local, (r_pad,) + y_local.shape[1:]
    )
