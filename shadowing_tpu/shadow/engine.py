"""Path shadowing engine: embed -> score -> exact top-k -> extract.

A rebuild of the reference's ``PathShadowing``
(``/root/reference/shadowing/path_shadowing/path_shadowing.py:61-301``)
around dense, statically shaped device passes:

* **Scores by expansion.** Every sliding window of every trajectory is
  scored against each context through the quadratic expansion
  ``‖h(x) - h(y_t)‖² = ‖h(x)‖² - 2⟨h(x), h(y_t)⟩ + ‖h(y_t)‖²``. The window
  norms ``‖h(y_t)‖²`` are context-independent — computed once per
  (dataset, embedding, context) and cached on device. Two routes compute
  the cross term:

  - ``"factored"``: the embedding responses ``E = y * kernel_d`` are
    context-independent too, built once per engine
    (:mod:`shadowing_tpu.ops.factored`); every search is then one
    ``(B, d) x (d, windows)`` product with a block-min, and pass 2 rescores
    only the best blocks exactly. The default whenever ``E`` fits the
    device.
  - ``"fused"``: a convolution of the raw trajectories with the *combined*
    filters ``g_b = Σ_d h(x_b)[d] · kernel_d`` (Toeplitz matmuls,
    :mod:`shadowing_tpu.ops.sliding`), streamed over dataset chunks with
    the tournament top-k of :mod:`shadowing_tpu.ops.topk`. It needs no
    resident ``E``.
* **Exact reported distances.** Winners are re-embedded and re-scored
  directly (`PathDistance.forward`) at full float32, so returned distances
  match the direct definition with no expansion round-off. Selection
  resolution boundary: the expansion score resolves squared-distance
  differences down to ~f32 eps of the ``‖h(x)‖²`` scale (cancellation
  against the constant term), so when candidates at the k boundary are
  separated by less than that, the expansion routes may admit a different
  member of the effective tie set than the direct oracle — with its exact
  distance reported (observed only on near-duplicate windows; found by
  tests/test_fuzz.py, which bounds the window).
* **Certified.** Each route returns a per-context flag that proves its
  selection exact; a context that fails is redone (wider selection, then
  the direct oracle) before anything is returned.

``method="direct"`` keeps a literal (chunked broadcast-difference) oracle for
parity testing; the default ``"auto"`` picks an expansion route whenever the
distance supports one.
"""
from __future__ import annotations

import functools
import os
import time
from functools import partial
from pathlib import Path
from typing import Callable, Optional, Tuple, Union

import jax
import jax.numpy as jnp
import numpy as np

from shadowing_tpu.array_types import Array, as_jax_f32, as_numpy, dim_bct
from shadowing_tpu.data.dataset import TimeSeriesDataset
from shadowing_tpu.ops import factored, precision
from shadowing_tpu.ops import topk as topk_ops
from shadowing_tpu.ops.sliding import sliding_dot
from shadowing_tpu.shadow.context import ContextManager, PredictionContext
from shadowing_tpu.shadow.distance import PathDistance
from shadowing_tpu.shadow.embedding import PathEmbedding
from shadowing_tpu.stats.proba import DiscreteProba, Softmax, Uniform

_DN = ("NCH", "OIH", "NCH")
#: flat (traj * n_out + t) candidate ids must fit int32 (monkeypatchable in
#: tests to exercise the overflow escape hatch without 2^31 candidates)
_INT32_LIMIT = np.iinfo(np.int32).max


@functools.lru_cache(maxsize=1)
def _memory_budget() -> int:
    """Byte budget for intermediate score/embedding tensors: a quarter of
    the backend device's memory when it reports one (leaving room for the
    dataset, norms and XLA workspace), else a 4 GB fallback. Cached: it
    sits on the per-call hot path."""
    try:
        stats = jax.devices()[0].memory_stats()
        limit = (stats or {}).get("bytes_limit")
        if limit:
            return max(int(limit) // 4, 256 << 20)
    except Exception:
        pass
    return 4 << 30


def _conv(x: jax.Array, kernel: jax.Array, prec) -> jax.Array:
    return jax.lax.conv_general_dilated(
        x, kernel, window_strides=(1,), padding="VALID",
        dimension_numbers=_DN, precision=prec,
        preferred_element_type=jnp.float32,
    )


def _pad_rows(y: jax.Array, n_splits: int) -> tuple[jax.Array, int]:
    """Pad the trajectory axis to a multiple of ``n_splits`` chunks."""
    R = y.shape[0]
    chunk = -(-R // n_splits)
    pad = chunk * n_splits - R
    if pad:
        y = jnp.concatenate([y, jnp.zeros((pad,) + y.shape[1:], y.dtype)])
    return y, chunk


# --------------------------------------------------------------------------
# window norms ‖h(y_t)‖² — context-independent, cached per engine
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_out", "n_splits", "identity_fast"))
def _window_norms(
    y: jax.Array,            # (R, C, T)
    kernel: jax.Array,       # (d, C, Kw)
    n_out: int,
    n_splits: int,
    identity_fast: bool,
) -> jax.Array:              # (R, n_out)
    R = y.shape[0]
    y, chunk = _pad_rows(y, n_splits)
    w = kernel.shape[-1]

    if identity_fast:
        # exact when every kernel row has at most one nonzero tap (identity
        # banks, incl. gapped/channel-padded context variants): then
        # ||E||^2 = sum_tau (sum_d k[d,c,tau]^2) y[tau]^2 — one sliding dot
        # of y^2 with the squared-tap filter instead of a d-channel pass
        k2 = (kernel**2).sum(axis=0, keepdims=True)     # (1, C, Kw)

        def body(_, y_c):
            n = sliding_dot(y_c * y_c, k2, n_out=n_out,
                            precision=precision.SELECT)[:, 0]
            return None, n
    else:

        def body(_, y_c):
            e = sliding_dot(y_c, kernel, n_out=n_out,
                            precision=precision.SELECT)  # (r, d, T')
            return None, (e * e).sum(axis=1)

    _, norms = jax.lax.scan(body, None, y.reshape(n_splits, chunk, *y.shape[1:]))
    return norms.reshape(-1, n_out)[:R]


# --------------------------------------------------------------------------
# fused search: combined-filter cross term + tournament top-k, scanned
# --------------------------------------------------------------------------

@partial(
    jax.jit,
    static_argnames=("k", "n_out", "n_splits", "distance", "block", "cap"),
)
def _fused_search(
    y: jax.Array,            # (R, C, T)
    norms: jax.Array,        # (R, n_out)
    g: jax.Array,            # (B, C, Kw) combined filters
    x_norm2: jax.Array,      # (B,)
    k: int,
    n_out: int,
    n_splits: int,
    distance: PathDistance,
    block: int = 128,
    cap: Optional[int] = None,
) -> tuple[jax.Array, jax.Array, jax.Array]:
    """Return (scores (B, k) ascending, flat indices (B, k), ok (B,))."""
    R = y.shape[0]
    B = g.shape[0]
    y, chunk = _pad_rows(y, n_splits)
    norms_p = jnp.concatenate(
        [norms, jnp.full((y.shape[0] - R, n_out), jnp.inf, norms.dtype)]
    ) if y.shape[0] != R else norms

    y_chunks = y.reshape(n_splits, chunk, *y.shape[1:])
    n_chunks = norms_p.reshape(n_splits, chunk, n_out)
    starts = jnp.arange(n_splits, dtype=jnp.int32) * chunk

    def body(carry, inp):
        d_run, i_run, ok_run = carry
        y_c, nrm_c, start = inp
        cross = sliding_dot(y_c, g, n_out=n_out,
                            precision=precision.SELECT)        # (r, B, T')
        cross = jnp.moveaxis(cross, 1, 0)                      # (B, r, T')
        s = distance.score(x_norm2[:, None, None], cross, nrm_c[None])
        valid = (start + jnp.arange(chunk, dtype=jnp.int32)) < R
        s = jnp.where(valid[None, :, None], s, jnp.inf).reshape(B, -1)
        # natively batched: vmap(topk_min) scalarises the block gathers
        vals, idx, ok = topk_ops.topk_min_batched(s, k, block=block,
                                                  cap=cap)
        idx = idx + start * n_out
        d_run, i_run = topk_ops.merge_min(d_run, i_run, vals, idx, k)
        return (d_run, i_run, ok_run & ok), None

    init = (
        jnp.full((B, k), jnp.inf, jnp.float32),
        jnp.full((B, k), jnp.iinfo(jnp.int32).max, jnp.int32),
        jnp.ones((B,), bool),
    )
    (d_run, i_run, ok), _ = jax.lax.scan(body, init, (y_chunks, n_chunks, starts))
    return d_run, i_run, ok


@partial(jax.jit, static_argnames=("k", "n_out", "n_splits", "distance"))
def _direct_search(
    y: jax.Array,            # (R, C, T)
    x_emb: jax.Array,        # (B, d)
    kernel: jax.Array,       # (d, C, Kw)
    k: int,
    n_out: int,
    n_splits: int,
    distance: PathDistance,
    n_valid_rows: Optional[jax.Array] = None,
) -> tuple[jax.Array, jax.Array]:
    """Literal oracle: embed every window, broadcast the distance, sort-exact
    top-k — the reference algorithm (``path_shadowing.py:147-173``) in XLA.

    ``n_valid_rows`` (traced, default all) masks trailing rows — mesh shards
    use it to neutralise global zero-padding rows.
    """
    R = y.shape[0] if n_valid_rows is None else n_valid_rows
    B = x_emb.shape[0]
    y, chunk = _pad_rows(y, n_splits)
    y_chunks = y.reshape(n_splits, chunk, *y.shape[1:])
    starts = jnp.arange(n_splits, dtype=jnp.int32) * chunk

    def body(carry, inp):
        d_run, i_run = carry
        y_c, start = inp
        e = _conv(y_c, kernel, precision.EXACT)[..., :n_out]   # (r, d, T')
        e = jnp.moveaxis(e, 1, 2)                              # (r, T', d)
        d = distance.forward(x_emb[:, None, None, :], e[None])  # (B, r, T')
        valid = (start + jnp.arange(chunk, dtype=jnp.int32)) < R
        d = jnp.where(valid[None, :, None], d, jnp.inf).reshape(B, -1)
        neg, idx = jax.lax.top_k(-d, k)
        idx = idx.astype(jnp.int32) + start * n_out
        d_run, i_run = topk_ops.merge_min(d_run, i_run, -neg, idx, k)
        return (d_run, i_run), None

    init = (
        jnp.full((B, k), jnp.inf, jnp.float32),
        jnp.full((B, k), jnp.iinfo(jnp.int32).max, jnp.int32),
    )
    (d_run, i_run), _ = jax.lax.scan(body, init, (y_chunks, starts))
    return d_run, i_run


@partial(jax.jit, static_argnames=())
def _prep_context(x_context: jax.Array, kernel: jax.Array):
    """Context embedding, its norm, and the combined filters — one
    dispatch."""
    x_emb = jnp.einsum("bcw,dcw->bd", x_context, kernel,
                       precision=precision.EXACT)
    x_norm2 = (x_emb * x_emb).sum(axis=-1)
    g = jnp.einsum("bd,dcw->bcw", x_emb, kernel, precision=precision.SELECT)
    return x_emb, x_norm2, g


# --------------------------------------------------------------------------
# extraction + exact rescore
# --------------------------------------------------------------------------

@partial(jax.jit, static_argnames=("n_out", "w_extract", "budget"))
def _extract_paths(
    y: jax.Array,            # (R, C, T)
    flat_idx: jax.Array,     # (B, k) = traj * n_out + t
    n_out: int,
    w_extract: int,
    budget: Optional[int] = None,
) -> tuple[jax.Array, jax.Array]:
    R, C, T = y.shape
    traj = flat_idx // n_out
    t0 = flat_idx % n_out
    B, k = flat_idx.shape
    paths = _rows_window_slice(y, traj.reshape(-1),
                               t0.reshape(-1), w_extract, budget=budget)
    paths = paths.reshape(B, k, C, w_extract)
    idces = jnp.stack([traj, t0], axis=-1).astype(jnp.int32)
    return paths, idces


_L_EXT = 128  # extraction block width (one lane tile)


def _rows_window_slice(
    y: jax.Array,        # (R, C, T)
    traj: jax.Array,     # (N,) winner trajectory per output row
    t0: jax.Array,       # (N,) window start per output row
    w_extract: int,
    budget: Optional[int] = None,
) -> jax.Array:          # (N, C, w_extract)
    """Window extraction, bit-exact, by one of two strategies:

    * ``w_extract <= 128``: flat single-axis row gather of the two
      128-sample blocks covering each window, then an exact TWO-STAGE
      one-hot shift (coarse 8-sample-group select, then fine in-group
      shift) to align each segment to its in-block offset (every output
      element is ``x * 1.0`` plus zeros — still bit-exact). The two-stage
      split moves ~4x fewer operator bytes than a single (2L, w) one-hot
      operator.
    * wider windows: whole-ROW gather (contiguous last dim) + a vmapped
      ``dynamic_slice`` per winner; the one-hot operator scales as
      ``w_extract**2`` per winner and loses in this regime.

    Either way winners stream in chunks sized against the device memory
    budget (a B=64 x k=10^4 row-buffer extraction would otherwise
    materialise ~10 GB)."""
    R, C, T = y.shape
    n = traj.shape[0]

    if w_extract <= _L_EXT:
        Lb = _L_EXT
        nbT = -(-T // Lb)
        y2 = y if T == nbT * Lb else jnp.pad(
            y, ((0, 0), (0, 0), (0, nbT * Lb - T)))
        yf = y2.reshape(R * C * nbT, Lb)
        # the shift decomposes o = 8*(o>>3) + (o&7): a coarse one-hot over
        # 8-sample groups then a fine one-hot over ng*8 samples (59 MB +
        # 0.6 GB of operators at N=65536, w=41, against 2.75 GB for one
        # (2L, w) operator). Both matmuls stay one-hot, so they are
        # bit-exact at HIGHEST (float32 products); a lower precision would
        # round the data.
        ng = -(-(7 + w_extract) // 8)   # 8-groups covering any (o&7) + w
        row_bytes = 4 * (4 * Lb * C + 2 * (32 * ng + 8 * C * ng
                                           + 2 * ng * 8 * w_extract))

        def take(tr, ss):
            b0 = ss // Lb
            o = ss % Lb
            base = (tr[:, None] * C
                    + jnp.arange(C, dtype=tr.dtype)) * nbT     # (m, C)
            # the 2nd block is only read when the window crosses the block
            # boundary (o + w_extract > Lb), in which case it is in range;
            # clamp keeps the gather in-bounds otherwise
            b1 = jnp.minimum(b0 + 1, nbT - 1)
            seg = jnp.concatenate(
                [yf[(base + b0[:, None]).reshape(-1)].reshape(-1, C, Lb),
                 yf[(base + b1[:, None]).reshape(-1)].reshape(-1, C, Lb)],
                axis=-1,
            )                                                  # (m, C, 2L)
            seg8 = seg.reshape(-1, C, 2 * Lb // 8, 8)
            gg = jnp.arange(2 * Lb // 8, dtype=ss.dtype)[None, :, None]
            hh = jnp.arange(ng, dtype=ss.dtype)[None, None, :]
            sel1 = (gg == (o >> 3)[:, None, None] + hh).astype(y.dtype)
            mid = jnp.einsum("mcgs,mgh->mchs", seg8, sel1,
                             precision=jax.lax.Precision.HIGHEST)
            mid = mid.reshape(-1, C, ng * 8)                   # (m, C, 8ng)
            ii = jnp.arange(ng * 8, dtype=ss.dtype)[None, :, None]
            jj = jnp.arange(w_extract, dtype=ss.dtype)[None, None, :]
            sel2 = (ii == (o & 7)[:, None, None] + jj).astype(y.dtype)
            return jnp.einsum("mcs,msj->mcj", mid, sel2,
                              precision=jax.lax.Precision.HIGHEST)
    else:
        row_bytes = C * T * 4

        def take(tr, ss):
            rows = y[tr]                                       # (m, C, T)
            return jax.vmap(
                lambda row, s: jax.lax.dynamic_slice(
                    row, (0, s), (C, w_extract))
            )(rows, ss)

    if budget is None:
        budget = _memory_budget()
    if n * row_bytes <= budget:
        return take(traj, t0)
    n_chunks = -(-(n * row_bytes) // budget)
    chunk = -(-n // n_chunks)
    n_chunks = -(-n // chunk)
    pad = n_chunks * chunk - n
    traj = jnp.pad(traj, (0, pad))
    t0 = jnp.pad(t0, (0, pad))
    _, out = jax.lax.scan(
        lambda _, inp: (None, take(*inp)),
        None,
        (traj.reshape(n_chunks, chunk), t0.reshape(n_chunks, chunk)),
    )
    return out.reshape(-1, C, w_extract)[:n]


@partial(jax.jit, static_argnames=("distance",))
def _exact_rescore(
    x_emb: jax.Array,        # (B, d)
    in_paths: jax.Array,     # (B, k, C, w)
    kernel: jax.Array,       # (d, C, w) *unpadded* embedding kernel
    distance: PathDistance,
) -> jax.Array:
    B, k, C, w = in_paths.shape
    e = _conv(in_paths.reshape(B * k, C, w), kernel, precision.EXACT)
    e = e[:, :, 0].reshape(B, k, -1)                           # (B, k, d)
    return distance.forward(x_emb[:, None, :], e)


@partial(jax.jit, static_argnames=("n_out", "w_extract", "distance",
                                   "select_in", "budget"))
def _finalize_shadow(
    y: jax.Array,
    flat_idx: jax.Array,
    x_emb: jax.Array,
    kernel: jax.Array,
    n_out: int,
    w_extract: int,
    distance: PathDistance,
    select_in,
    budget: Optional[int] = None,
):
    """Extraction + exact rescore + ascending sort, fused into one dispatch.

    ``flat_idx`` is pre-sorted per context so the stable argsort below
    yields the canonical (distance, flat id) order: every method — fused,
    factored, direct, mesh, redo — returns bit-identical winner order even
    when distinct windows tie in f32 distance (observed in practice: two
    windows of a 32768x4096 search tied at rank 905)."""
    flat_idx = jnp.sort(flat_idx, axis=-1)
    paths, idces = _extract_paths(y, flat_idx, n_out=n_out,
                                  w_extract=w_extract, budget=budget)
    in_paths = select_in(paths)
    dists = _exact_rescore(x_emb, in_paths, kernel, distance=distance)
    order = jnp.argsort(dists, axis=-1)
    dists = jnp.take_along_axis(dists, order, axis=-1)
    paths = jnp.take_along_axis(paths, order[..., None, None], axis=1)
    idces = jnp.take_along_axis(idces, order[..., None], axis=1)
    return dists, paths, idces


@partial(jax.jit,
         static_argnames=("to_predict", "proba_name", "eta", "select_out"))
def _aggregate_predictions(distances, paths, to_predict, proba_name, eta,
                           select_out):
    out = select_out(paths)
    if proba_name == "uniform":
        proba = Uniform()
    elif proba_name == "softmax":
        proba = Softmax(distances[:, :, None], eta)
    else:
        raise ValueError(f"unrecognized averaging proba {proba_name!r}")
    values = jnp.asarray(to_predict(out))
    return proba.avg(values, axis=1), proba.std(values, axis=1)


@partial(jax.jit, static_argnames=("eta", "x_init"))
def _smile_inputs(dists, out_paths, eta: float, x_init: float):
    """(B, k, h) futures -> (B, k, h+1) prices anchored at ``x_init`` plus
    Gaussian-kernel path weights — one dispatch for all contexts."""
    fut = out_paths[:, :, 0, :]                               # (B, k, h)
    B, k, _ = fut.shape
    lnx = jnp.concatenate(
        [jnp.zeros((B, k, 1)), jnp.cumsum(fut, axis=-1)], axis=-1
    )
    prices = jnp.exp(lnx) * x_init
    # the one Gaussian-kernel weight definition lives in stats.proba
    w = Softmax(dists, eta).weights_like(fut[..., 0], axis=1)
    return prices, w


# --------------------------------------------------------------------------
# engine
# --------------------------------------------------------------------------

class PathShadowing:
    """Scan a generated dataset for paths shadowing an observed context.

    :param embedding: dimensionality reduction of a path window
    :param distance: distance between embedded windows
    :param dataset: ``(R, C, T)`` array, directory of ``.npy`` shards, or
        :class:`TimeSeriesDataset`
    :param context: what is matched vs predicted
        (default: :class:`PredictionContext` with no horizon)
    :param mesh: run the whole pipeline sharded over a device mesh — a
        ``jax.sharding.Mesh`` (1-d), a device count (builds one), or ``None``
        (single device). The dataset axis R is sharded (zero-padded to the
        mesh size, padded rows neutralised by ``+inf`` norms); search,
        extraction and rescore run per-device with one ``all_gather`` /
        ``psum`` each; results are array-identical to ``mesh=None``.
    :param n_trajectories: true trajectory count when ``dataset`` is a
        pre-assembled *global* sharded array whose R axis was already
        zero-padded to the mesh (the multi-host path:
        :func:`shadowing_tpu.parallel.multihost.shard_dataset_from_local`).
        Rows at index >= ``n_trajectories`` are treated as padding and can
        never win a search. Default: every row is data.
    """

    def __init__(
        self,
        embedding: PathEmbedding,
        distance: PathDistance,
        dataset: Union[Array, Path, str, TimeSeriesDataset],
        context: Optional[ContextManager] = None,
        mesh=None,
        n_trajectories: Optional[int] = None,
    ):
        if isinstance(dataset, (str, Path)):
            dataset = TimeSeriesDataset(dpath=dataset, R=None)
        if isinstance(dataset, TimeSeriesDataset):
            dataset = dataset.load()
        self.dataset = dataset
        self.embedding = embedding
        self.distance = distance
        self.context = context or PredictionContext(horizon=None)
        if mesh is not None and not hasattr(mesh, "shape"):
            from shadowing_tpu.parallel.sharding import data_mesh

            mesh = data_mesh(int(mesh))
        self.mesh = mesh

        self._y: Optional[jax.Array] = None       # device dataset (R', C, T)
        self._norms: Optional[jax.Array] = None   # cached window norms
        self._padded = None                       # cached factored pad views
        self._factored = None                     # cached (E, nt) responses
        #: True once the factored BUILD itself failed — its inputs are
        #: engine-static, so retrying at another (B, k) would pay the
        #: identical doomed multi-GB build again
        self._factored_disabled: bool = False
        #: (B, k) shapes whose factored pass failed at compile/run time
        #: (e.g. a selection temporary that outgrows device memory, which
        #: the byte gate cannot foresee); those shapes reroute to the fused
        #: route, which computes the identical certified result
        self._factored_failed: set = set()
        #: (B, k) -> certified escalated selection cap. When a factored
        #: search fails certification on a thin order-statistic margin and
        #: the wider-cap retry certifies, later searches of the same shape
        #: route straight to the wider cap: one redo per shape, not per
        #: chunk (a 2048-date backtest is 32 same-shape chunks).
        self._cap_memo: dict = {}
        self._R: Optional[int] = n_trajectories   # true trajectory count
        #: routing diagnostics: one line per distinct auto-routing decision
        #: (method picked, gates granted/declined with their byte math).
        #: Inspect after a search, or set SHADOWING_TPU_ROUTE_LOG=1 to print
        #: each line to stderr as it is first recorded.
        self.routing_log: list = []
        #: structured metrics for the most recent public call (entry name,
        #: wall seconds, resolved route, shapes, redo count) — sync-free:
        #: recorded from values the call already materialised, never by
        #: adding device round trips to the hot path.
        self.last_metrics: dict = {}

    def _record_metrics(self, entry: str, t0: float, *, B: int, k: int,
                        redo_contexts: int = 0, **extra) -> None:
        self.last_metrics = {
            "entry": entry,
            "wall_s": round(time.perf_counter() - t0, 6),
            "B": B,
            "k": k,
            **getattr(self, "_last_submit", {}),
            "factored": self._factored is not None,
            "mesh": None if self.mesh is None else dict(self.mesh.shape),
            "redo_contexts": redo_contexts,
            **extra,
        }

    def _reroute_factored(self, e, B: int, k: int,
                          build_done: bool) -> None:
        """Memoize a factored build/search runtime failure, free the
        cache, and log — the caller then falls back to the fused route
        (identical certified results). Search failures are keyed by
        (B, k); a BUILD failure disables the factored route engine-wide
        (its inputs are engine-static — every shape would fail alike)."""
        if build_done:
            self._factored_failed.add((B, k))
        else:
            self._factored_disabled = True
        self._factored = None
        first = (str(e).split("\n", 1)[0] or repr(e))[:160]
        self._log_route(
            f"factored FAILED at B={B}, k={k} "
            f"({'search' if build_done else 'build'}) — rerouting to the "
            f"fused route ({first})")

    def _log_route(self, msg: str) -> None:
        if msg in self.routing_log:
            return  # routing state is engine-static: record each line once
        self.routing_log.append(msg)
        if os.environ.get("SHADOWING_TPU_ROUTE_LOG", "0") not in ("", "0"):
            import sys

            print(f"[route] {msg}", file=sys.stderr, flush=True)

    # -- device state ----------------------------------------------------
    @property
    def y(self) -> jax.Array:
        """Device dataset — R zero-padded to the mesh size in mesh mode."""
        if self._y is None:
            if (
                self.mesh is not None
                and isinstance(self.dataset, jax.Array)
                and not self.dataset.is_fully_addressable
            ):
                # multi-host global array (shard_dataset_from_local): rows
                # were already padded + placed; only validate the contract
                y = self.dataset
                if y.ndim != 3 or y.shape[0] % self.mesh.shape["data"]:
                    raise ValueError(
                        "pre-sharded dataset must be (R_pad, C, T) with "
                        "R_pad a multiple of the mesh — assemble it with "
                        "shadowing_tpu.parallel.multihost."
                        "shard_dataset_from_local"
                    )
                if self._R is None:
                    self._R = y.shape[0]
            else:
                y = as_jax_f32(dim_bct(jnp.asarray(self.dataset)))
                if self._R is None:
                    self._R = y.shape[0]
                if self.mesh is not None:
                    from shadowing_tpu.parallel.sharding import shard_dataset

                    y = shard_dataset(y, self.mesh)
            self._y = y
        return self._y

    @property
    def R(self) -> int:
        """True trajectory count (excluding mesh padding rows)."""
        if self._R is None:
            self.y  # materialise
        return self._R

    def _plan(self) -> tuple[np.ndarray, int]:
        shape = dim_bct(self.dataset).shape
        kernel, n_out = self.context.conv_plan(self.embedding.kernel,
                                               shape[-1])
        if kernel.shape[1] != shape[1]:
            # eager, named error — otherwise this surfaces as a conv
            # feature-dimension mismatch from deep inside jit
            raise ValueError(
                f"embedding/context expect {kernel.shape[1]}-channel data "
                f"(embedding kernel has {self.embedding.kernel.shape[1]} "
                f"channels, the context manager adds "
                f"{self.context.out_channels()}) but the dataset has "
                f"{shape[1]} channels — build the embedding with a "
                f"(d, C, w) kernel matching the dataset"
            )
        return kernel, n_out

    def _auto_splits(self, B: int, n_out: int, d: int,
                     method: str = "direct") -> int:
        R = self.y.shape[0]
        if self.mesh is not None:
            # per-device chunking: each device streams only its own shard
            R = -(-R // self.mesh.shape["data"])
        if method == "fused":
            # fused never materialises per-window embeddings: per chunk it
            # holds the cross term and the scores, (B x r x n_out) each
            per_row = n_out * (2 * B + 1) * 4
        else:
            per_row = n_out * (d + 2 * B) * 4  # embeddings + broadcast dists
        total = R * per_row
        return max(1, -(-total // _memory_budget()))

    def _factored_ok(self, kernel: np.ndarray, n_out: int) -> bool:
        """Whether pass-1 can use the precomputed embedding responses
        (:mod:`shadowing_tpu.ops.factored`): a distance whose selection
        score has the ``norm2 - 2 cross`` form, a padded id space that fits
        int32, a build that has not failed, and an ``E`` that fits next to
        the dataset in device memory. The factored route beat the fused
        route at every context count measured on an H100, one included
        (PERF.md), so nothing else gates it."""
        if not (self.distance.supports_expansion
                and self.distance.factored_score_form):
            self._log_route(
                f"factored declined: distance {type(self.distance).__name__} "
                "lacks the norm2 - 2*cross expansion form")
            return False
        if self._factored_disabled:
            self._log_route("factored declined: its build failed before")
            return False
        d, C, _ = kernel.shape
        # all sizes per DEVICE: in mesh mode each device holds (and pads)
        # only its own row shard
        R = self.y.shape[0]
        if self.mesh is not None:
            R = R // self.mesh.shape["data"]
        ids = factored.id_space(R, n_out)
        if ids >= np.iinfo(np.int32).max:
            self._log_route(
                f"factored declined: padded id space {ids} >= int32 max "
                f"(R={R}, n_out={n_out})")
            return False
        # memory gate: E + the other residents (dataset + pad views +
        # window norms, ~5x the dataset at typical horizons) + >= 2 GB
        # working headroom must fit the device (_memory_budget() is a
        # quarter of the device limit; extraction scratch shrinks to the
        # leftover via _scratch_budget)
        e_bytes = factored.e_bytes(R, n_out, d)
        resident = 5 * R * C * dim_bct(self.dataset).shape[-1] * 4
        limit = 4 * _memory_budget()
        free = limit - resident - (2 << 30)
        if e_bytes > free:
            self._log_route(
                f"factored declined: E needs {e_bytes / 1e9:.2f} GB but only "
                f"{free / 1e9:.2f} GB free (device limit {limit / 1e9:.2f} "
                f"GB - residents {resident / 1e9:.2f} GB - 2 GB headroom)")
            return False
        self._log_route(
            f"factored pass-1 routed: E={e_bytes / 1e9:.2f} GB of "
            f"{free / 1e9:.2f} GB free (device limit {limit / 1e9:.2f} GB)")
        return True

    def _scratch_budget(self) -> Optional[int]:
        """Byte budget for extraction scratch (the one-hot shift operators
        / row buffers): the default quarter-device budget, except when the
        factored responses are resident — then whatever headroom they
        leave."""
        if self._factored is None:
            return None
        resident = sum(a.nbytes for a in self._factored)
        if self._y is not None:
            resident += self._y.nbytes
        if self._padded is not None:
            resident += sum(a.nbytes for a in self._padded)
        if self.mesh is not None:   # sharded residents: per-device share
            resident //= self.mesh.shape["data"]
        limit = 4 * _memory_budget()
        return int(max(256 << 20,
                       min(_memory_budget(), limit - resident - (2 << 30))))

    def window_norms(self, n_splits: Optional[int] = None) -> jax.Array:
        """``‖h(y_t)‖²`` for every window — cached per engine instance.

        In mesh mode the norms are computed shard-locally and padded rows
        get ``+inf`` so they can never win a selection.
        """
        if self._norms is None:
            kernel, n_out = self._plan()
            if n_splits is None:
                n_splits = self._auto_splits(1, n_out, self.embedding.dim)
            # the diagonal fast path is exact iff every embedding row has at
            # most one nonzero tap in the context-adjusted kernel
            diag = bool(
                (np.count_nonzero(kernel.reshape(kernel.shape[0], -1),
                                  axis=1) <= 1).all()
            )
            if self.mesh is not None:
                from shadowing_tpu.parallel.sharding import (
                    sharded_window_norms,
                )

                self._norms = sharded_window_norms(
                    self.y, jnp.asarray(kernel), n_out=n_out,
                    n_splits=n_splits, identity_fast=diag, R_true=self.R,
                    mesh=self.mesh,
                )
            else:
                norms = _window_norms(
                    self.y, jnp.asarray(kernel), n_out=n_out,
                    n_splits=n_splits, identity_fast=diag,
                )
                if self.R < self.y.shape[0]:
                    # explicit n_trajectories below the stored row count:
                    # +inf norms bar the excess rows from every expansion
                    # route (the direct oracle masks via n_valid_rows)
                    norms = norms.at[self.R:].set(jnp.inf)
                self._norms = norms
        return self._norms

    # -- search ------------------------------------------------------------
    def shadow(
        self,
        x_context: Array,
        k: int = 1,
        n_splits: Optional[int] = None,
        method: str = "auto",
        cuda: Optional[bool] = None,  # accepted for API parity; placement is JAX's
        exact_dtype: str = "float32",
    ) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
        """Find the ``k`` dataset windows closest to each context.

        :param x_context: ``(B, C, w)`` contexts (1-d/2-d coerced)
        :param k: number of closest paths to keep
        :param n_splits: dataset chunks (``None``: sized from memory budget)
        :param method: ``"factored"`` or ``"fused"`` (expanded scores +
            exact rescore, see the module docstring), ``"direct"`` (literal
            oracle), or ``"auto"``
        :param exact_dtype: ``"float64"`` re-scores the k winners on the host
            in double precision (selection stays f32 on device) and re-sorts,
            so returned distances match a float64 oracle to ~1e-15 — cheap
            (``B*k*w`` elements) but adds one host round-trip
        :return: distances ``(B, k)`` ascending, paths
            ``(B, k, C, w + out_times)``, indices ``(B, k, 2)`` as
            ``(trajectory, window start)``
        """
        del cuda
        if exact_dtype not in ("float32", "float64"):
            raise ValueError(f"exact_dtype must be float32/float64, got "
                             f"{exact_dtype!r}")
        t0 = time.perf_counter()
        # the certification flag rides the result fetch
        dists, paths, idces, ok, redo = self._submit_shadow(
            x_context, k, n_splits, method
        )
        d_h, p_h, i_h, ok_h = jax.device_get((dists, paths, idces, ok))
        if not ok_h.all():
            dists, paths, idces = redo(ok_h)
            d_h, p_h, i_h = jax.device_get((dists, paths, idces))
        if exact_dtype == "float64":
            out = self._rescore_host_f64(x_context, p_h, i_h)
        else:
            out = d_h, p_h, i_h
        self._record_metrics("shadow", t0, B=len(d_h), k=k,
                             redo_contexts=int((~ok_h).sum()))
        return out

    def _rescore_host_f64(self, x_context, paths, idces):
        """Re-score the winners in host float64 and re-sort (stable), closing
        the f32 rounding gap between returned distances and a float64 oracle
        (BASELINE.md parity row: <= 1e-6 relative)."""
        paths = as_numpy(paths).astype(np.float64)
        idces = as_numpy(idces)
        kernel = self.embedding.kernel.astype(np.float64)
        x_ctx = dim_bct(np.asarray(x_context, dtype=np.float64))
        in_paths = np.asarray(self.context.select_in_context(paths))
        e = np.einsum("bkcw,dcw->bkd", in_paths, kernel)
        x_emb = np.einsum("bcw,dcw->bd", x_ctx, kernel)
        d = self.distance.forward_host(x_emb[:, None, :], e)   # (B, k)
        order = np.argsort(d, axis=-1, kind="stable")
        d = np.take_along_axis(d, order, axis=-1)
        paths = np.take_along_axis(paths, order[..., None, None], axis=1)
        idces = np.take_along_axis(idces, order[..., None], axis=1)
        return d, paths.astype(np.float32), idces

    def shadow_device(
        self,
        x_context: Array,
        k: int = 1,
        n_splits: Optional[int] = None,
        method: str = "auto",
        tournament_cap: Optional[int] = None,
    ) -> Tuple[jax.Array, jax.Array, jax.Array]:
        """:meth:`shadow` returning device arrays — chain device-resident
        pipelines (prediction, pricing) without copying the paths to the
        host."""
        t0 = time.perf_counter()
        dists, paths, idces, ok, redo = self._submit_shadow(
            x_context, k, n_splits, method, tournament_cap
        )
        ok_h = np.asarray(ok)
        if not ok_h.all():
            dists, paths, idces = redo(ok_h)
        self._record_metrics("shadow_device", t0, B=len(ok_h), k=k,
                             redo_contexts=int((~ok_h).sum()))
        return dists, paths, idces

    def _submit_shadow(
        self,
        x_context: Array,
        k: int = 1,
        n_splits: Optional[int] = None,
        method: str = "auto",
        tournament_cap: Optional[int] = None,
    ):
        """Submit search + optimistic finalize with NO host sync.

        Returns device arrays ``(dists, paths, idces, ok)`` plus
        ``redo(ok_host)``, which re-resolves the failed contexts with the
        sort-exact oracle and re-finalizes (the statistically rare
        certification-failure path — the only one that pays extra round
        trips).
        """
        x_context = dim_bct(np.asarray(x_context, dtype=np.float32))
        if x_context.shape[-1] != self.embedding.width:
            raise ValueError(
                f"context length {x_context.shape[-1]} must equal the "
                f"embedding width {self.embedding.width}"
            )
        kernel, n_out = self._plan()
        B = x_context.shape[0]
        d = self.embedding.dim
        n_candidates = self.R * n_out
        if not 1 <= k <= n_candidates:
            raise ValueError(
                f"k={k} must be in [1, {n_candidates}] "
                f"(= R * valid window starts)"
            )
        if method == "pallas":
            raise ValueError(
                'method="pallas" no longer exists: use "auto" (which picks '
                '"factored" or "fused"), "factored", "fused" or "direct"')
        if method == "auto":
            if not self.distance.supports_expansion:
                method = "direct"
            elif self._factored_ok(kernel, n_out):
                method = "factored"
            else:
                method = "fused"
        elif method == "factored" and not self._factored_ok(kernel, n_out):
            raise ValueError("factored search unavailable for this engine "
                             "(the reason is in routing_log)")
        if method == "factored" and (B, k) in self._factored_failed:
            self._log_route(f"factored skipped for (B={B}, k={k}): it failed "
                            "before at this shape — fused route")
            method = "fused"
        if method not in ("factored", "fused", "direct"):
            raise ValueError(f"unknown method {method!r}")
        if n_splits is None:
            n_splits = self._auto_splits(B, n_out, d, method)
            if method != "factored":   # factored tiles by its own layout
                self._log_route(
                    f"auto n_splits={n_splits} for method={method} "
                    f"(B={B}, n_out={n_out}, d={d}, "
                    f"budget={_memory_budget() / 1e9:.2f} GB)")
        # each chunk must hold at least k candidates (chunk-local top-k),
        # so clamp user/auto splits — the split-invariance contract says any
        # n_splits returns identical results, never an opaque top_k error
        n_splits = max(1, min(n_splits, (self.R * n_out) // k))

        y = self.y
        # flat candidate ids (traj * n_out + t) are GLOBAL int32 in both
        # single-device and mesh mode (the mesh k-merge and extraction use
        # global ids — sharding does NOT raise this ceiling), so the whole
        # candidate count must fit int32
        if y.shape[0] * n_out >= _INT32_LIMIT:
            raise ValueError(
                f"R * n_out = {y.shape[0]} * {n_out} exceeds int32 flat "
                "indexing — split the trajectory axis over several "
                "PathShadowing engines and search them as one dataset with "
                "shadowing_tpu.shadow.engine.shadow_sharded_rows"
            )
        kernel_dev = jnp.asarray(kernel)
        # context embedding needs the *unadjusted* kernel (its width equals
        # the context length); the plan kernel drives the dataset pass
        x_emb, x_norm2, g_raw = _prep_context(
            jnp.asarray(x_context), jnp.asarray(self.embedding.kernel)
        )
        # combined filters over the context-adjusted kernel (the fused
        # cross term and the factored pass-2 rescore)
        g = (
            g_raw
            if kernel.shape == self.embedding.kernel.shape
            else jnp.einsum("bd,dcw->bcw", x_emb, kernel_dev,
                            precision=precision.SELECT)
        )
        if self.mesh is not None:
            return self._shadow_mesh(
                x_context, k, n_splits, method, tournament_cap,
                kernel, n_out, x_emb, x_norm2, g,
            )
        escalate = None  # set on the factored route (tier-1 redo, below)

        if method == "factored":
            if self._padded is None:
                # padding copies cost ~2 full-array passes: cache them
                # next to the window norms (same lifetime)
                self._padded = factored.pad_views(
                    y, self.window_norms(), n_out, kernel.shape[-1])
            y3, n2 = self._padded
            cap_eff = (tournament_cap if tournament_cap is not None
                       else self._cap_memo.get((B, k)))
            if cap_eff is not None and tournament_cap is None:
                self._log_route(
                    f"cap memo: routing (B={B}, k={k}) at the previously "
                    f"certified cap={cap_eff}")
            E = nt = None
            try:
                if self._factored is None:
                    # embedding responses E: built once per engine,
                    # amortised over every later search
                    self._factored = factored.build_factored(
                        y3, n2, kernel_dev,
                        nbt=factored.tiling(y.shape[0], n_out)[1])
                E, nt = self._factored
                _, flat_idx, ok = factored.two_pass_search_factored(
                    E, nt, y3, n2, g, x_emb, k=k, n_out=n_out, cap=cap_eff)
            except jax.errors.JaxRuntimeError as e:
                # certified-or-fallback applies to the runtime too: a
                # factored build or compile failure reroutes to the fused
                # route (identical results). E is freed first, locals
                # included, so the fallback gets the memory. Execution
                # failures that surface at the later result fetch are out
                # of this guard's reach.
                build_done = E is not None
                del E, nt
                self._reroute_factored(e, B, k, build_done)
                method = "fused"
            else:
                # tier-1 redo for this route: a certification failure is
                # almost always a THIN ORDER-STATISTIC MARGIN — the cap-th
                # selected block minimum sits inside the self-calibrated
                # pass-1 error band of the k-th winner (see the guard in
                # ops/factored.pass2_from_bmin) — not a wrong result.
                # Re-running the search with ~4x the block slack widens that
                # margin by the same factor while the pass-1 error stays
                # put, so the retry certifies without the direct oracle.
                esc_cap = max(k + 4 * 384, 2 * (cap_eff or 0))

                def escalate():
                    # E is read from the engine, not captured: the closure
                    # must not keep it alive once tier 2 evicts it
                    if self._factored is None:
                        return None
                    return factored.two_pass_search_factored(
                        *self._factored, y3, n2, g, x_emb, k=k, n_out=n_out,
                        cap=esc_cap)

        self._log_route(f"method={method} (B={B}, k={k}, R={self.R}, "
                        f"n_out={n_out}, mesh=none)")
        self._last_submit = {"method": method, "n_splits": n_splits,
                             "n_out": n_out, "R": self.R}
        if method == "fused":
            _, flat_idx, ok = _fused_search(
                y, self.window_norms(), g, x_norm2, k=k, n_out=n_out,
                n_splits=n_splits, distance=self.distance,
                cap=tournament_cap,
            )
        elif method == "direct":
            # mask explicit-n_trajectories excess rows (the expansion
            # routes bar them via +inf window norms instead)
            nvr = (jnp.asarray(self.R, jnp.int32)
                   if self.R < y.shape[0] else None)
            _, flat_idx = _direct_search(
                y, x_emb, kernel_dev, k=k, n_out=n_out, n_splits=n_splits,
                distance=self.distance, n_valid_rows=nvr,
            )
            ok = jnp.ones((x_context.shape[0],), jnp.bool_)

        w_extract = x_context.shape[-1] + self.context.get_out_times()
        kernel_raw = jnp.asarray(self.embedding.kernel)
        budget = self._scratch_budget()
        fin = _finalize_shadow(
            y, flat_idx, x_emb, kernel_raw,
            n_out=n_out, w_extract=w_extract, distance=self.distance,
            select_in=self.context.select_in_context, budget=budget,
        )

        def redo(ok_host):
            # certification failed for some contexts: tier 1 retries the
            # factored search with ~4x block slack (thin-margin failures,
            # the common case); tier 2 resolves anything still uncertified
            # with the sort-exact oracle; then re-finalize
            rows = np.nonzero(~np.asarray(ok_host))[0]
            fi = np.array(flat_idx)  # writable host copy
            esc = ok2 = None
            if escalate is not None:
                try:
                    esc = escalate()   # None once E has been evicted
                    ok2 = None if esc is None else np.asarray(esc[2])
                except jax.errors.JaxRuntimeError as e:
                    # the wider cap's pass-2 temporaries run beside E; if
                    # they do not fit, tier 2 (which evicts E) takes over
                    self._log_route(
                        f"redo: escalated cap={esc_cap} FAILED "
                        f"({(str(e).splitlines() or [''])[0][:160]}) — "
                        "direct oracle")
            if ok2 is not None:
                if tournament_cap is None:
                    # one redo per shape, not per chunk: same-shape
                    # searches route straight to this cap
                    self._cap_memo[(B, k)] = esc_cap
                took = rows[ok2[rows]]
                if took.size:
                    fi[took] = np.asarray(esc[1])[took]
                rows = rows[~ok2[rows]]
                self._log_route(
                    f"redo: escalated cap={esc_cap} certified "
                    f"{took.size}/{took.size + rows.size} failed contexts")
            if rows.size:
                if self._factored is not None:
                    # the direct oracle's scratch budget assumes the memory
                    # the factored E cache occupies — evict it (rebuilt
                    # lazily on the next factored-routed search)
                    self._factored = None
                    self._log_route(
                        "redo: evicted factored E cache for the oracle")
                _, idx_exact = _direct_search(
                    y, x_emb[rows], kernel_dev, k=k, n_out=n_out,
                    # re-budget: direct materialises d-dim embeddings per
                    # row, far more than the fused chunks were sized for
                    n_splits=self._auto_splits(len(rows), n_out, d,
                                               "direct"),
                    distance=self.distance,
                    n_valid_rows=(jnp.asarray(self.R, jnp.int32)
                                  if self.R < y.shape[0] else None),
                )
                fi[rows] = np.asarray(idx_exact)
            return _finalize_shadow(
                y, jnp.asarray(fi), x_emb, kernel_raw,
                n_out=n_out, w_extract=w_extract, distance=self.distance,
                select_in=self.context.select_in_context, budget=budget,
            )

        return (*fin, ok, redo)

    def _shadow_mesh(
        self, x_context, k, n_splits, method, tournament_cap,
        kernel, n_out, x_emb, x_norm2, g,
    ):
        """Mesh twin of the single-device search + finalize flow: per-device
        searches, an ``all_gather`` k-merge, sharded extraction, replicated
        exact rescore — results array-identical to ``mesh=None``. Same
        deferred-certification contract as :meth:`_submit_shadow`."""
        from shadowing_tpu.parallel import sharding as psh

        kernel_dev = jnp.asarray(kernel)
        y = self.y
        d = self.embedding.dim
        B = x_context.shape[0]
        r_loc = y.shape[0] // self.mesh.shape["data"]

        if method == "factored":
            if self._padded is None:
                # per-device pad views, cached like the single-device
                # engine's
                self._padded = psh.sharded_pad_views(
                    y, self.window_norms(), n_out=n_out,
                    w=kernel.shape[-1], mesh=self.mesh,
                )
            y3, n2 = self._padded
            E = nt = None
            try:
                if self._factored is None:
                    self._factored = psh.sharded_build_factored(
                        y3, n2, kernel_dev,
                        nbt=factored.tiling(r_loc, n_out)[1], mesh=self.mesh,
                    )
                E, nt = self._factored
                _, flat_idx, ok = psh.sharded_factored_search(
                    E, nt, y3, n2, g, x_emb, k=k, n_out=n_out,
                    r_loc=r_loc, mesh=self.mesh, cap=tournament_cap,
                )
            except jax.errors.JaxRuntimeError as e:
                # same reroute as the single-device path (see there)
                build_done = E is not None
                del E, nt
                self._reroute_factored(e, B, k, build_done)
                method = "fused"
        self._log_route(f"method={method} (B={B}, k={k}, R={self.R}, "
                        f"n_out={n_out}, mesh={dict(self.mesh.shape)})")
        self._last_submit = {"method": method, "n_splits": n_splits,
                             "n_out": n_out, "R": self.R}
        if method == "fused":
            _, flat_idx, ok = psh.sharded_fused_search(
                y, self.window_norms(), g, x_norm2, k=k, n_out=n_out,
                distance=self.distance, mesh=self.mesh,
                n_splits=n_splits, cap=tournament_cap,
            )
        elif method == "direct":
            _, flat_idx = psh.sharded_direct_search(
                y, x_emb, kernel_dev, k=k, n_out=n_out,
                distance=self.distance, R_true=self.R, mesh=self.mesh,
                n_splits=n_splits,
            )
            ok = jnp.ones((B,), jnp.bool_)

        w_extract = x_context.shape[-1] + self.context.get_out_times()
        kernel_raw = jnp.asarray(self.embedding.kernel)
        budget = self._scratch_budget()
        fin = psh.sharded_finalize_shadow(
            y, flat_idx, x_emb, kernel_raw,
            n_out=n_out, w_extract=w_extract, distance=self.distance,
            select_in=self.context.select_in_context, mesh=self.mesh,
            budget=budget,
        )

        def redo(ok_host):
            rows = np.nonzero(~np.asarray(ok_host))[0]
            _, idx_exact = psh.sharded_direct_search(
                y, x_emb[rows], kernel_dev, k=k, n_out=n_out,
                distance=self.distance, R_true=self.R, mesh=self.mesh,
                n_splits=self._auto_splits(len(rows), n_out, d, "direct"),
            )
            fi = np.array(flat_idx)  # writable host copy
            fi[rows] = np.asarray(idx_exact)
            return psh.sharded_finalize_shadow(
                y, jnp.asarray(fi), x_emb, kernel_raw,
                n_out=n_out, w_extract=w_extract, distance=self.distance,
                select_in=self.context.select_in_context, mesh=self.mesh,
                budget=budget,
            )

        return (*fin, ok, redo)

    # -- prediction --------------------------------------------------------
    @staticmethod
    def init_averaging_proba(
        proba_name: str, distances: Array, eta: Optional[float]
    ) -> DiscreteProba:
        if proba_name == "uniform":
            return Uniform()
        if proba_name == "softmax":
            return Softmax(distances, eta)
        raise ValueError(f"unrecognized averaging proba {proba_name!r}")

    def predict_from_paths(
        self,
        distances: Array,
        paths: Array,
        to_predict: Callable[[Array], Array],
        proba_name: str = "softmax",
        eta: Optional[float] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Aggregate a functional of the out-context over shadowing paths.

        Unlike the reference (``path_shadowing.py:251-252``) the functional
        is evaluated once, not twice — and the whole aggregation runs as one
        jitted dispatch (traced per distinct ``to_predict`` callable).
        """
        avg, std = _aggregate_predictions(
            jnp.asarray(distances), jnp.asarray(paths),
            to_predict=to_predict, proba_name=proba_name,
            eta=eta if eta is None else float(eta),
            select_out=self.context.select_out_context,
        )
        return as_numpy(avg), as_numpy(std)

    def conditional_smile(
        self,
        x_context: Array,
        k: int,
        Ts,
        Ms,
        eta: float = 0.075,
        r: float = 0.0,
        x_init: float = 100.0,
        n_splits: Optional[int] = None,
        method: str = "auto",
    ):
        """Shadow then price: conditional Hedged-MC smiles, one per context.

        Device-resident end to end (search -> futures -> prices -> smiles);
        ALL contexts price in one vmapped dispatch
        (:func:`shadowing_tpu.pricing.hedged_mc.compute_smile_batch`), so a
        B-context smile costs ~the same wall time as one. Equivalent to the
        reference's notebook flow (``tutorial.ipynb`` cells 12-14):
        ``shadow`` + ``Softmax`` + ``PriceData`` + ``compute_smile``.
        """
        from shadowing_tpu.pricing.hedged_mc import compute_smile_batch

        t0 = time.perf_counter()
        dists, paths, _, ok, redo = self._submit_shadow(
            x_context, k, n_splits, method
        )

        def build(dists, paths):
            prices, weights = _smile_inputs(
                dists, self.context.select_out_context(paths),
                eta=float(eta), x_init=float(x_init),
            )
            # prices start at x_init by construction: skip validation
            return compute_smile_batch(prices, Ts, Ms, r, weights=weights,
                                       validate=False)

        smile = build(dists, paths)  # submitted behind the search pipeline
        ok_h = np.asarray(ok)        # ready once the search is
        if not ok_h.all():           # rare: certification failed somewhere
            d2, p2, _ = redo(ok_h)
            smile = build(d2, p2)
        self._record_metrics("conditional_smile", t0, B=len(ok_h), k=k,
                             redo_contexts=int((~ok_h).sum()))
        return smile

    def predict_and_smile(
        self,
        x_context: Array,
        k: int,
        to_predict: Callable[[Array], Array],
        Ts,
        Ms,
        eta: float = 0.1,
        eta_smile: float = 0.075,
        r: float = 0.0,
        x_init: float = 100.0,
        proba_name: str = "softmax",
        n_splits: Optional[int] = None,
        method: str = "auto",
    ):
        """One search, both products: volatility prediction + conditional
        Hedged-MC smiles for every context, from a single device-resident
        pipeline (search -> futures -> aggregate + price). Two host round
        trips total (the smile grids and the prediction aggregates) —
        calling :meth:`predict` and :meth:`conditional_smile` separately
        would search twice and sync four times.

        :return: ``(avg (B, ...), std (B, ...), [B Smile objects])``
        """
        from shadowing_tpu.pricing.hedged_mc import compute_smile_batch

        t0 = time.perf_counter()
        d, p, _, ok, redo = self._submit_shadow(
            x_context, k, n_splits, method
        )

        def build(d, p):
            a, b = _aggregate_predictions(
                d, p, to_predict=to_predict, proba_name=proba_name,
                eta=eta if eta is None else float(eta),
                select_out=self.context.select_out_context,
            )
            prices, weights = _smile_inputs(
                d, self.context.select_out_context(p),
                eta=float(eta_smile), x_init=float(x_init),
            )
            smiles = compute_smile_batch(prices, Ts, Ms, r, weights=weights,
                                         validate=False)
            return a, b, smiles

        a, b, smiles = build(d, p)
        a_h, b_h, ok_h = jax.device_get((a, b, ok))
        if not ok_h.all():  # rare: redo failed contexts with the oracle
            d, p, _ = redo(ok_h)
            a, b, smiles = build(d, p)
            a_h, b_h = jax.device_get((a, b))
        self._record_metrics("predict_and_smile", t0, B=len(a_h), k=k,
                             redo_contexts=int((~ok_h).sum()))
        return np.asarray(a_h), np.asarray(b_h), smiles

    def predict(
        self,
        x_context: Array,
        k: int,
        to_predict: Callable[[Array], Array],
        eta: Optional[float] = None,
        proba_name: str = "softmax",
        n_dataset_splits: Optional[int] = None,
        n_context_splits: int = 1,
        method: str = "auto",
        cuda: Optional[bool] = None,
    ) -> Tuple[np.ndarray, np.ndarray]:
        """Shadow then aggregate: the full prediction pipeline
        (reference ``path_shadowing.py:256-301``).

        Contexts are padded (by repeating the last one) to a multiple of the
        chunk size so every chunk reuses ONE compiled program — a remainder
        chunk would otherwise trace and compile a second shape.
        """
        del cuda
        t0 = time.perf_counter()
        x_context = dim_bct(np.asarray(x_context, dtype=np.float32))
        B = x_context.shape[0]
        chunk = -(-B // n_context_splits)
        pad = (-B) % chunk
        if pad:
            x_context = np.concatenate(
                [x_context, np.repeat(x_context[-1:], pad, axis=0)]
            )

        aggregate = partial(
            _aggregate_predictions, to_predict=to_predict,
            proba_name=proba_name, eta=eta if eta is None else float(eta),
            select_out=self.context.select_out_context,
        )
        # pipeline the chunks with at most two in flight: chunk i+1 is
        # submitted before chunk i's aggregates are fetched, so the device
        # never idles between chunks, while the host cannot run ahead and
        # stack every chunk's buffers on the device at once
        preds, stds, n_redo, n_chunks = [], [], 0, 0

        def harvest(a, b, ok, redo):
            nonlocal n_redo
            a_h, b_h, ok_h = jax.device_get((a, b, ok))
            if not ok_h.all():  # rare: redo with the sort-exact oracle
                n_redo += int((~np.asarray(ok_h)).sum())
                d, p, _ = redo(ok_h)
                a_h, b_h = jax.device_get(aggregate(d, p))
            preds.append(np.asarray(a_h))
            stds.append(np.asarray(b_h))

        pending = None
        for s in range(0, x_context.shape[0], chunk):
            d, p, _, ok, redo = self._submit_shadow(
                x_context[s : s + chunk], k, n_dataset_splits, method
            )
            submitted = (*aggregate(d, p), ok, redo)
            del d, p
            if pending is not None:
                harvest(*pending)
            pending = submitted
            n_chunks += 1
        harvest(*pending)
        self._record_metrics("predict", t0, B=B, k=k,
                             redo_contexts=n_redo,
                             n_context_chunks=n_chunks)
        return np.concatenate(preds)[:B], np.concatenate(stds)[:B]


# --------------------------------------------------------------------------
# int32 escape hatch: search several row-slice engines as one dataset
# --------------------------------------------------------------------------

def shadow_sharded_rows(
    engines,
    x_context: Array,
    k: int = 1,
    n_splits: Optional[int] = None,
    method: str = "auto",
    exact_dtype: str = "float32",
) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """:meth:`PathShadowing.shadow` over several engines holding row-slices
    of one dataset — the escape hatch for candidate spaces whose flat ids
    ``R * n_out`` overflow int32 (the limit each single engine enforces).

    Split the trajectory axis into consecutive slices, build one engine per
    slice (same embedding/distance/context), and call this instead of
    ``shadow``: per-engine exact top-k results are merged into the global
    k-smallest — exact by the same streaming-merge property as ``n_splits``
    chunking (reference ``testing.ipynb`` cell 1) — and winner trajectory
    indices are offset back into the full dataset's row numbering.

    :param engines: engines over consecutive row-slices, in dataset order
    :return: same contract as :meth:`PathShadowing.shadow`
    """
    if not engines:
        raise ValueError("shadow_sharded_rows needs at least one engine")
    outs = []
    offset = total = 0
    for eng in engines:
        _, n_out = eng._plan()
        k_loc = min(k, eng.R * n_out)  # at most k winners come from any slice
        d, p, i = eng.shadow(x_context, k=k_loc, n_splits=n_splits,
                             method=method, exact_dtype=exact_dtype)
        i = np.asarray(i).copy()
        i[..., 0] += offset
        offset += eng.R
        total += eng.R * n_out
        outs.append((np.asarray(d), np.asarray(p), i))
    if k > total:
        raise ValueError(f"k={k} exceeds the {total} total candidates")
    d = np.concatenate([o[0] for o in outs], axis=1)
    p = np.concatenate([o[1] for o in outs], axis=1)
    i = np.concatenate([o[2] for o in outs], axis=1)
    order = np.argsort(d, axis=1, kind="stable")[:, :k]
    return (
        np.take_along_axis(d, order, axis=1),
        np.take_along_axis(p, order[..., None, None], axis=1),
        np.take_along_axis(i, order[..., None], axis=1),
    )
