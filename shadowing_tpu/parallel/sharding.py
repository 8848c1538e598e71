"""Multi-chip sharding of the shadow pipeline and synthesis training step.

The reference has no distributed layer at all (SURVEY.md §0: its only
multi-worker story is job-array generation sharding). The design here is
single-controller JAX over a 1-d device mesh:

* **Shadow pipeline**: the dataset axis R is sharded across the mesh
  (``P("data")``); contexts and the embedding kernel are replicated. Each
  device runs the *same* search the single-device engine uses (the factored
  two-pass search of :mod:`shadowing_tpu.ops.factored` over its own shard's
  responses, or :func:`shadowing_tpu.shadow.engine._fused_search`), then
  the per-device (value, global-index) candidates go through one
  ``all_gather`` and an exact k-way merge.
  Path extraction gathers each winner on the device that owns its trajectory
  and ``psum``-reduces the disjoint contributions; the exact rescore + sort
  run replicated on the tiny (B, k) winner set. Exactness is the same
  streaming-merge property the single-chip engine tests (chunk invariance),
  lifted to devices, so mesh size 1 vs N give identical results.
* **Padding, not errors**: datasets whose R does not divide the mesh are
  zero-padded (:func:`shard_dataset`); padded rows get ``+inf`` window norms
  (:func:`sharded_window_norms`) so they can never win a selection.
* **Synthesis step**: scattering-spectra generation is data-parallel over
  seeds: each device Adam-steps its own seed shard against the replicated
  target statistics; only the scalar convergence metric is ``psum``-reduced.
  (Seeds are independent optimisations — the ideal dp workload.)

Everything here works on any backend; the tests exercise an 8-virtual-device
CPU mesh, and ``chip_smoke.py --four-cards`` runs it on four GPUs. Engine
integration:
``PathShadowing(..., mesh=...)`` routes the whole pipeline through these
functions (``shadowing_tpu/shadow/engine.py``).
"""
from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from shadowing_tpu.models.scattering.moments import _scattering_stats_flat

DATA_AXIS = "data"
CTX_AXIS = "ctx"


def data_mesh(n_devices: Optional[int] = None) -> Mesh:
    """A 1-d mesh over (the first ``n_devices``) available devices."""
    devs = jax.devices()
    if n_devices is not None:
        if n_devices > len(devs):
            raise ValueError(
                f"requested {n_devices} devices, only {len(devs)} available"
            )
        devs = devs[:n_devices]
    return Mesh(np.asarray(devs), (DATA_AXIS,))


def data_ctx_mesh(n_data: int, n_ctx: int) -> Mesh:
    """A 2-d ``(data, ctx)`` mesh: dataset rows shard over ``data``,
    context batches over ``ctx``.

    The scaling story for large backtests (~10k dates at k<=16,384): the
    1-d data mesh stops paying once R/n_dev shards get small while the
    per-context selection state (pass-2 cap x block at large k) and the
    O(B * k * n_dev) merge payload keep
    growing with B. Splitting the context batch over a second axis keeps
    both per-device: each ``ctx`` slice runs the search for B/n_ctx
    contexts against its ``data`` shard, so the merge payload drops to
    O(B/n_ctx * k * n_data) per device and context chunks pipeline in
    parallel instead of serially."""
    devs = jax.devices()
    need = n_data * n_ctx
    if need > len(devs):
        raise ValueError(
            f"requested {n_data}x{n_ctx} mesh, only {len(devs)} devices"
        )
    return Mesh(np.asarray(devs[:need]).reshape(n_data, n_ctx),
                (DATA_AXIS, CTX_AXIS))


def pad_rows_to_mesh(a: jax.Array, mesh: Mesh) -> jax.Array:
    """Zero-pad axis 0 to a multiple of the mesh size."""
    n_dev = mesh.shape[DATA_AXIS]
    pad = (-a.shape[0]) % n_dev
    if pad:
        a = jnp.concatenate([a, jnp.zeros((pad,) + a.shape[1:], a.dtype)])
    return a


def shard_dataset(y: jax.Array, mesh: Mesh) -> jax.Array:
    """Place a ``(R, C, T)`` dataset with R sharded across the mesh.

    R is zero-padded to a multiple of the mesh size; callers track the true
    row count (padded rows are neutralised by ``+inf`` window norms).
    """
    y = pad_rows_to_mesh(jnp.asarray(y), mesh)
    spec = P(DATA_AXIS, *([None] * (y.ndim - 1)))
    return jax.device_put(y, NamedSharding(mesh, spec))


def replicate(a: jax.Array, mesh: Mesh) -> jax.Array:
    """Place an array fully replicated over the mesh."""
    return jax.device_put(a, NamedSharding(mesh, P()))


# --------------------------------------------------------------------------
# sharded shadow pipeline (wraps the engine's single-device kernels)
# --------------------------------------------------------------------------

@partial(
    jax.jit,
    static_argnames=("n_out", "n_splits", "identity_fast", "R_true", "mesh"),
)
def sharded_window_norms(
    y: jax.Array,            # (R_pad, C, T), R sharded over mesh
    kernel: jax.Array,       # (d, C, Kw) replicated
    n_out: int,
    n_splits: int,
    identity_fast: bool,
    R_true: int,
    mesh: Mesh,
) -> jax.Array:              # (R_pad, n_out) sharded; +inf on padded rows
    from shadowing_tpu.shadow.engine import _window_norms

    n_dev = mesh.shape[DATA_AXIS]
    r_loc = y.shape[0] // n_dev

    def local(y_loc):
        ax = jax.lax.axis_index(DATA_AXIS)
        n = _window_norms(y_loc, kernel, n_out=n_out, n_splits=n_splits,
                          identity_fast=identity_fast)
        grow = ax * r_loc + jnp.arange(r_loc, dtype=jnp.int32)
        return jnp.where((grow < R_true)[:, None], n, jnp.inf)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None),),
        out_specs=P(DATA_AXIS, None),
        check_vma=False,
    )(y)


#: trace-time record of every k-merge's gathered payload (per device),
#: keyed by the gathered shape ``(n_dev, B, k_loc) -> bytes``. Shapes are
#: static, so an entry is written when a merge TRACES (not per dispatch);
#: keying by shape means a jit-cache hit (nothing re-traced) still has its
#: entry from the first trace, and merges of different shapes in one
#: process don't clobber each other. Dry-runs
#: (__graft_entry__.dryrun_multichip) assert the collective payload stays
#: O(B * k * n_dev), independent of R.
LAST_MERGE_PAYLOAD: dict = {}


def _topk_merge(vals, idx, k):
    """Gather every device's (B, k_loc) candidates and take the exact
    global k-smallest (payload O(B * k * devices), independent of R)."""
    vals_all = jax.lax.all_gather(vals, DATA_AXIS)       # (n_dev, B, k_loc)
    idx_all = jax.lax.all_gather(idx, DATA_AXIS)
    LAST_MERGE_PAYLOAD[tuple(vals_all.shape)] = (
        vals_all.size * vals_all.dtype.itemsize
        + idx_all.size * idx_all.dtype.itemsize
    )
    B = vals.shape[0]
    vals_all = jnp.moveaxis(vals_all, 0, 1).reshape(B, -1)
    idx_all = jnp.moveaxis(idx_all, 0, 1).reshape(B, -1)
    neg, sel = jax.lax.top_k(-vals_all, k)
    return -neg, jnp.take_along_axis(idx_all, sel, axis=-1)


@partial(
    jax.jit,
    static_argnames=("k", "n_out", "n_splits", "distance", "mesh", "block",
                     "cap"),
)
def sharded_fused_search(
    y: jax.Array,          # (R_pad, C, T), R sharded over mesh
    norms: jax.Array,      # (R_pad, n_out), R sharded, +inf on padded rows
    g: jax.Array,          # (B, C, Kw) combined filters, replicated
    x_norm2: jax.Array,    # (B,)
    k: int,
    n_out: int,
    distance,
    mesh: Mesh,
    n_splits: int = 1,
    block: int = 128,
    cap: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Mesh-sharded fused shadow search.

    Per device: the engine's ``_fused_search`` (Toeplitz ``sliding_dot``
    cross term + tournament top-k, scanned over ``n_splits`` local chunks).
    Then one ``all_gather`` of the (B, k_loc) candidate pairs and an exact
    merge — collective payload is O(B * k * devices), independent of R.

    Returns (values (B, k) ascending, global flat indices (B, k), ok (B,)).
    """
    from shadowing_tpu.shadow.engine import _fused_search

    n_dev = mesh.shape[DATA_AXIS]
    R = y.shape[0]
    if R % n_dev:
        raise ValueError(
            f"R={R} not a multiple of the {n_dev}-device mesh — place the "
            "dataset with shard_dataset (it pads)"
        )
    r_loc = R // n_dev
    k_loc = min(k, r_loc * n_out)
    ns = max(1, min(n_splits, (r_loc * n_out) // k_loc))

    def local(y_loc, n_loc):
        ax = jax.lax.axis_index(DATA_AXIS)
        vals, idx, ok = _fused_search(
            y_loc, n_loc, g, x_norm2, k=k_loc, n_out=n_out,
            n_splits=ns, distance=distance, block=block, cap=cap,
        )
        idx = idx + ax.astype(jnp.int32) * (r_loc * n_out)
        merged_v, merged_i = _topk_merge(vals, idx, k)
        ok_all = jax.lax.all_gather(ok, DATA_AXIS).all(axis=0)
        return merged_v, merged_i, ok_all

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(y, norms)


def shard_contexts(g: jax.Array, x_norm2: jax.Array, mesh: Mesh):
    """Place combined filters (B, C, Kw) + context norms (B,) with B
    sharded over the ``ctx`` axis of a :func:`data_ctx_mesh`."""
    return (
        jax.device_put(jnp.asarray(g),
                       NamedSharding(mesh, P(CTX_AXIS, None, None))),
        jax.device_put(jnp.asarray(x_norm2),
                       NamedSharding(mesh, P(CTX_AXIS))),
    )


@partial(
    jax.jit,
    static_argnames=("k", "n_out", "n_splits", "distance", "mesh", "block",
                     "cap"),
)
def sharded_fused_search_2d(
    y: jax.Array,          # (R_pad, C, T), R sharded over "data"
    norms: jax.Array,      # (R_pad, n_out), R sharded over "data"
    g: jax.Array,          # (B, C, Kw), B sharded over "ctx"
    x_norm2: jax.Array,    # (B,), B sharded over "ctx"
    k: int,
    n_out: int,
    distance,
    mesh: Mesh,            # 2-d (data, ctx) — see data_ctx_mesh
    n_splits: int = 1,
    block: int = 128,
    cap: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """2-d mesh twin of :func:`sharded_fused_search`: R shards over
    ``data``, the context batch over ``ctx``.

    Per device: the engine's ``_fused_search`` for its B/n_ctx contexts
    against its R/n_data rows; then the exact k-merge runs along the
    ``data`` axis only (payload O(B/n_ctx * k * n_data) per device — a
    factor n_ctx below the 1-d mesh), and one ``ctx`` all_gather
    re-assembles the replicated (B, k) result. Same array-identity
    contract as every mesh route: any mesh shape returns identical
    winners (tested at (8,), (4,2), (2,4) vs single-device)."""
    from shadowing_tpu.shadow.engine import _fused_search

    n_data = mesh.shape[DATA_AXIS]
    n_ctx = mesh.shape[CTX_AXIS]
    R, B = y.shape[0], g.shape[0]
    if R % n_data:
        raise ValueError(
            f"R={R} not a multiple of the data axis ({n_data}) — place the "
            "dataset with shard_dataset (it pads)"
        )
    if B % n_ctx:
        raise ValueError(
            f"B={B} contexts not a multiple of the ctx axis ({n_ctx}) — "
            "pad the context batch (a zero context is a valid query)"
        )
    r_loc = R // n_data
    k_loc = min(k, r_loc * n_out)
    ns = max(1, min(n_splits, (r_loc * n_out) // k_loc))

    def local(y_loc, n_loc, g_loc, xn_loc):
        ax = jax.lax.axis_index(DATA_AXIS)
        vals, idx, ok = _fused_search(
            y_loc, n_loc, g_loc, xn_loc, k=k_loc, n_out=n_out,
            n_splits=ns, distance=distance, block=block, cap=cap,
        )
        idx = idx + ax.astype(jnp.int32) * (r_loc * n_out)
        merged_v, merged_i = _topk_merge(vals, idx, k)
        ok_all = jax.lax.all_gather(ok, DATA_AXIS).all(axis=0)
        # re-assemble the context axis: each ctx slice holds the final
        # (B_loc, k) winners for ITS contexts — one gather replicates
        v = jax.lax.all_gather(merged_v, CTX_AXIS).reshape(B, k)
        i = jax.lax.all_gather(merged_i, CTX_AXIS).reshape(B, k)
        okf = jax.lax.all_gather(ok_all, CTX_AXIS).reshape(B)
        return v, i, okf

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None),
                  P(CTX_AXIS, None, None), P(CTX_AXIS)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(y, norms, g, x_norm2)


@partial(jax.jit, static_argnames=("n_out", "w", "mesh"))
def sharded_pad_views(
    y: jax.Array,          # (R_pad, C, T), R sharded over mesh
    norms: jax.Array,      # (R_pad, n_out), R sharded, +inf on padded rows
    n_out: int,
    w: int,
    mesh: Mesh,
) -> Tuple[jax.Array, jax.Array]:
    """Per-device factored pad views, built ONCE per (dataset, plan) — the
    mesh twin of the single-device engine's ``_padded`` cache."""
    from shadowing_tpu.ops.factored import pad_views

    return jax.shard_map(
        lambda y_loc, n_loc: pad_views(y_loc, n_loc, n_out, w),
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None)),
        out_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None)),
        check_vma=False,
    )(y, norms)


@partial(jax.jit, static_argnames=("nbt", "mesh"))
def sharded_build_factored(
    y3: jax.Array,         # (Rp, C, cols) from sharded_pad_views, sharded
    n2: jax.Array,         # (Rp, nblk * L) from sharded_pad_views, sharded
    kernel: jax.Array,     # (d, C, w) plan kernel, replicated
    nbt: int,              # blocks per tile, from tiling() of the local R
    mesh: Mesh,
) -> Tuple[jax.Array, jax.Array]:
    """Per-device factored embedding responses (E, nt), built ONCE per
    (dataset, plan) — the mesh twin of the single-device ``_factored``
    cache. Each device holds only its own row shard's responses, so the
    E footprint scales down with the mesh."""
    from shadowing_tpu.ops.factored import build_factored

    return jax.shard_map(
        lambda y3_loc, n2_loc: build_factored(y3_loc, n2_loc, kernel, nbt),
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None), P(DATA_AXIS, None)),
        out_specs=(P(DATA_AXIS, None, None, None),
                   P(DATA_AXIS, None, None)),
        check_vma=False,
    )(y3, n2)


@partial(
    jax.jit,
    static_argnames=("k", "n_out", "r_loc", "mesh", "cap"),
)
def sharded_factored_search(
    E: jax.Array,          # (NT, d, L, nbt) sharded on NT
    nt: jax.Array,         # (NT, L, nbt) sharded on NT
    y3: jax.Array,         # (Rp, C, cols) sharded (pass-2 rescore)
    n2: jax.Array,         # (Rp, nblk * L) sharded
    g: jax.Array,          # (B, C, w) combined filters, replicated
    x_emb: jax.Array,      # (B, d) context embeddings, replicated
    k: int,
    n_out: int,
    r_loc: int,            # UNPADDED per-device row count (global ids)
    mesh: Mesh,
    cap: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Mesh-sharded factored search: per device
    :func:`shadowing_tpu.ops.factored.two_pass_search_factored` on its local
    E shard, then the same ``all_gather`` k-merge as every other mesh
    route. Row padding inside the views carries +inf norms, so padded rows
    never win and local winner ids stay below ``r_loc * n_out``."""
    from shadowing_tpu.ops import factored

    k_loc = min(k, r_loc * n_out)

    def local(E_loc, nt_loc, y3_loc, n2_loc):
        ax = jax.lax.axis_index(DATA_AXIS)
        vals, idx, ok = factored.two_pass_search_factored(
            E_loc, nt_loc, y3_loc, n2_loc, g, x_emb,
            k=k_loc, n_out=n_out, cap=cap,
        )
        idx = idx + ax.astype(jnp.int32) * (r_loc * n_out)
        merged_v, merged_i = _topk_merge(vals, idx, k)
        ok_all = jax.lax.all_gather(ok, DATA_AXIS).all(axis=0)
        return merged_v, merged_i, ok_all

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None, None),
                  P(DATA_AXIS, None, None),
                  P(DATA_AXIS, None, None), P(DATA_AXIS, None)),
        out_specs=(P(), P(), P()),
        check_vma=False,
    )(E, nt, y3, n2)


@partial(
    jax.jit,
    static_argnames=("k", "n_out", "n_splits", "distance", "R_true", "mesh"),
)
def sharded_direct_search(
    y: jax.Array,          # (R_pad, C, T), R sharded over mesh
    x_emb: jax.Array,      # (B, d) replicated
    kernel: jax.Array,     # (d, C, Kw) replicated
    k: int,
    n_out: int,
    distance,
    R_true: int,
    mesh: Mesh,
    n_splits: int = 1,
) -> Tuple[jax.Array, jax.Array]:
    """Mesh-sharded literal oracle (sort-exact top-k per device + merge)."""
    from shadowing_tpu.shadow.engine import _direct_search

    n_dev = mesh.shape[DATA_AXIS]
    r_loc = y.shape[0] // n_dev
    k_loc = min(k, r_loc * n_out)
    ns = max(1, min(n_splits, (r_loc * n_out) // k_loc))

    def local(y_loc):
        ax = jax.lax.axis_index(DATA_AXIS)
        # mask padding rows globally: rows at ax*r_loc + i >= R_true
        r_valid = jnp.clip(R_true - ax * r_loc, 0, r_loc)
        vals, idx = _direct_search(
            y_loc, x_emb, kernel, k=k_loc, n_out=n_out, n_splits=ns,
            distance=distance, n_valid_rows=r_valid,
        )
        idx = idx + ax.astype(jnp.int32) * (r_loc * n_out)
        return _topk_merge(vals, idx, k)

    return jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None),),
        out_specs=(P(), P()),
        check_vma=False,
    )(y)


@partial(jax.jit, static_argnames=("n_out", "w_extract", "mesh", "budget"))
def sharded_extract(
    y: jax.Array,          # (R_pad, C, T), R sharded over mesh
    flat_idx: jax.Array,   # (B, k) global flat indices, replicated
    n_out: int,
    w_extract: int,
    mesh: Mesh,
    budget: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array]:
    """Gather winner windows from the sharded dataset.

    Each device extracts the winners whose trajectory lives on its shard and
    contributes zeros elsewhere; one ``psum`` assembles the replicated
    (B, k, C, w_extract) result — payload O(B * k * w), independent of R.
    """
    n_dev = mesh.shape[DATA_AXIS]
    r_loc = y.shape[0] // n_dev
    traj = flat_idx // n_out
    t0 = flat_idx % n_out

    def local(y_loc):
        from shadowing_tpu.shadow.engine import _rows_window_slice

        ax = jax.lax.axis_index(DATA_AXIS)
        ltraj = traj - ax * r_loc
        mask = (ltraj >= 0) & (ltraj < r_loc)
        lt = jnp.clip(ltraj, 0, r_loc - 1)
        C = y_loc.shape[1]
        B, k = lt.shape
        # the engine's window extraction, memory-budget chunked per device
        # (see engine._rows_window_slice)
        sl = _rows_window_slice(y_loc, lt.reshape(-1), t0.reshape(-1),
                                w_extract, budget=budget)
        paths = sl.reshape(B, k, C, w_extract)
        paths = jnp.where(mask[..., None, None], paths, 0.0)
        return jax.lax.psum(paths, DATA_AXIS)

    paths = jax.shard_map(
        local, mesh=mesh,
        in_specs=(P(DATA_AXIS, None, None),),
        out_specs=P(),
        check_vma=False,
    )(y)
    idces = jnp.stack([traj, t0], axis=-1).astype(jnp.int32)
    return paths, idces


@partial(jax.jit, static_argnames=("n_out", "w_extract", "distance",
                                   "select_in", "mesh", "budget"))
def sharded_finalize_shadow(
    y: jax.Array,
    flat_idx: jax.Array,
    x_emb: jax.Array,
    kernel: jax.Array,
    n_out: int,
    w_extract: int,
    distance,
    select_in,
    mesh: Mesh,
    budget: Optional[int] = None,
):
    """Sharded extraction + replicated exact rescore + ascending sort —
    the mesh twin of the engine's ``_finalize_shadow``, one dispatch.

    ``flat_idx`` is pre-sorted per context (same canonical tie order as the
    single-device finalize — see ``_finalize_shadow``)."""
    from shadowing_tpu.shadow.engine import _exact_rescore

    flat_idx = jnp.sort(flat_idx, axis=-1)
    paths, idces = sharded_extract(y, flat_idx, n_out=n_out,
                                   w_extract=w_extract, mesh=mesh,
                                   budget=budget)
    in_paths = select_in(paths)
    dists = _exact_rescore(x_emb, in_paths, kernel, distance=distance)
    order = jnp.argsort(dists, axis=-1)
    dists = jnp.take_along_axis(dists, order, axis=-1)
    paths = jnp.take_along_axis(paths, order[..., None, None], axis=1)
    idces = jnp.take_along_axis(idces, order[..., None], axis=1)
    return dists, paths, idces


# --------------------------------------------------------------------------
# data-parallel synthesis step
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("J", "mesh", "lr"))
def sharded_synthesis_step(
    z: jax.Array,          # (R, T) seeds, R sharded over mesh
    m: jax.Array,          # Adam moments, same sharding
    v: jax.Array,
    step_idx: jax.Array,   # ()
    target: jax.Array,     # (n_stats,) replicated
    psi_hat: jax.Array,    # (J, T) replicated
    J: int,
    mesh: Mesh,
    lr: float = 0.03,
) -> Tuple[jax.Array, jax.Array, jax.Array, jax.Array]:
    """One data-parallel synthesis (training) step over the mesh.

    Each device updates its local seed shard; the scalar mean loss is
    ``psum``-averaged for logging/convergence. Returns (z, m, v, loss).
    """

    def local_step(z_loc, m_loc, v_loc):
        def loss_fn(zz):
            stats = _scattering_stats_flat(zz, psi_hat, J=J)
            # sum of per-seed means: each seed's gradient is independent of
            # how seeds are partitioned over devices (exact dp invariance)
            return ((stats - target[None]) ** 2).mean(axis=-1).sum()

        loss, grad = jax.value_and_grad(loss_fn)(z_loc)
        # same Adam constants as synthesis._adam_scan (b2=0.95: see its
        # docstring — deterministic loss, short second-moment memory wins)
        b1, b2, eps = 0.9, 0.95, 1e-8
        m_loc = b1 * m_loc + (1 - b1) * grad
        v_loc = b2 * v_loc + (1 - b2) * grad**2
        t = step_idx.astype(jnp.float32) + 1.0
        mh = m_loc / (1 - b1**t)
        vh = v_loc / (1 - b2**t)
        z_loc = z_loc - lr * mh / (jnp.sqrt(vh) + eps)
        gloss = jax.lax.psum(loss, DATA_AXIS) / z.shape[0]  # global mean
        return z_loc, m_loc, v_loc, gloss

    return jax.shard_map(
        local_step,
        mesh=mesh,
        in_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None)),
        out_specs=(P(DATA_AXIS, None), P(DATA_AXIS, None), P(DATA_AXIS, None), P()),
        check_vma=False,
    )(z, m, v)
