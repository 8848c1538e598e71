"""Exact k-smallest selection by block-min tournament.

The shadow search needs the k smallest of ~1e8-1e9 window distances. XLA's
general ``lax.top_k`` over such arrays lowers to a near-full sort, so this
module implements an exact **block-min tournament**:

1. view the score array as ``(G, M)`` blocks and take each block's minimum
   (one streaming pass, bandwidth-bound);
2. select the ``cap`` blocks with the smallest minima (``top_k`` over ``G``
   elements — tiny);
3. gather those blocks' elements and run an exact ``top_k`` over the
   ``cap*M`` candidates (tiny).

The result is exact whenever the k-th candidate value ``kappa`` is strictly
smaller than the best minimum among *unselected* blocks (``mu_cap``): every
unselected element is then provably worse than all k winners. The selection
returns an ``ok`` flag certifying this; in the worst spread the k winners
occupy k distinct blocks, so ``cap = 2k + slack`` selected blocks make
failures vanishingly rare. Callers either check ``ok`` on the host and
re-run the sort-based exact path (engine does this), or use
:func:`topk_min_checked` which folds the fallback into a ``lax.cond``.

This replaces the torch ``topk`` + streaming-merge scheme of the reference
(``/root/reference/shadowing/path_shadowing/path_shadowing.py:160-173``,
``path_distance.py:27-48``) with the same exactness guarantee (the
reference's split-invariance property, ``testing.ipynb`` cell 1, holds by
construction: per-element scores are chunk-independent and merges are exact).
"""
from __future__ import annotations

import os
from functools import partial
from typing import NamedTuple

import jax
import jax.numpy as jnp

_DEFAULT_BLOCK = 128

#: byte budget for the candidate-gather source. The gather operand
#: ``blocks.reshape(B * n_blocks, block)`` must be physical, and the
#: budget counts a narrow (block=8) f32 row as padded to 128 lanes (a 16x
#: expansion; the value was sized for another accelerator's memory layout
#: and is queued for measurement on the GPU, ROADMAP A6).
#: ``topk_min_batched`` chunks the gather + final ``top_k`` over batch rows
#: to stay under this budget (bit-identical: rows are independent). Read once at import; tests monkeypatch the attribute (the
#: value is baked into each jit trace, so use fresh shapes after patching).
_GATHER_BUDGET = int(
    os.environ.get("SHADOWING_TPU_TOPK_GATHER_BUDGET", str(1 << 30))
)


class TopKResult(NamedTuple):
    values: jax.Array   # (k,) ascending
    indices: jax.Array  # (k,) int32 flat indices into the input
    ok: jax.Array       # () bool — True iff the tournament result is certified


def _tournament_cap(n: int, k: int, block: int, cap: int | None) -> int:
    n_blocks = -(-n // block)
    if cap is None:
        # in the worst spread every winner sits in its own block, so the
        # certified-exact region needs cap >= k blocks; 2k + slack makes the
        # certification-failure probability negligible for i.i.d.-ish scores
        # (clustered winners only reduce the number of blocks needed).
        cap = max(2 * k + 256, 512)
    cap = min(cap, n_blocks)
    if cap * block < k:
        cap = -(-k // block)
    return min(cap, n_blocks)


def topk_min_sort(scores: jax.Array, k: int) -> TopKResult:
    """Reference-exact k smallest via full ``lax.top_k`` (slow, always correct)."""
    neg, idx = jax.lax.top_k(-scores, k)
    return TopKResult(-neg, idx.astype(jnp.int32), jnp.bool_(True))


@partial(jax.jit, static_argnums=(1, 2, 3), inline=True)
def topk_min(
    scores: jax.Array,
    k: int,
    block: int = _DEFAULT_BLOCK,
    cap: int | None = None,
) -> TopKResult:
    """Exact k smallest values (and flat indices) of a 1-d score array.

    Returns ``ok=False`` (with best-effort values) in the statistically rare
    case the tournament bound cannot certify exactness; callers must then
    fall back to :func:`topk_min_sort`.

    One algorithm, one implementation: this is row 0 of
    :func:`topk_min_batched` on a singleton batch.
    """
    values, indices, ok = topk_min_batched(scores[None], k, block, cap)
    return TopKResult(values[0], indices[0], ok[0])


class TopKBatchResult(NamedTuple):
    values: jax.Array   # (B, k) ascending
    indices: jax.Array  # (B, k) int32 flat indices into each row
    ok: jax.Array       # (B,) bool per-row certification


#: narrow fold width for the large-k regime: candidates shrink to
#: ``8 * cap`` while the fold itself stays one bandwidth-bound pass
_NARROW = 8


@partial(jax.jit, static_argnums=(1, 2, 3), inline=True)
def topk_min_batched(
    scores: jax.Array,  # (B, N)
    k: int,
    block: int = _DEFAULT_BLOCK,
    cap: int | None = None,
) -> TopKBatchResult:
    """Row-wise :func:`topk_min` over a 2-d score array, batched natively.

    Do NOT ``vmap(topk_min)``: its block gathers become batched two-index
    gathers. Here ``lax.top_k`` batches natively and every gather is a
    flattened single-axis ROW gather.

    The tournament is **adaptive** (round 3): at large k the 128-wide block
    candidate set ``cap * block`` approaches n and the tournament degenerates
    into a full gather + full ``top_k``. Two fixes, both certified by the
    same bound: (a) when ``cap * block`` is not a small fraction of n the
    fold narrows to ``_NARROW``-wide blocks, shrinking the candidate set to
    ``8 * cap``; (b) the cap-of-G block-minima selection recurses through
    this same tournament instead of a flat ``top_k`` when G is itself
    large.
    """
    B, n = scores.shape
    if k > n:
        raise ValueError(f"k={k} exceeds number of scores n={n}")
    if n <= 4 * k or n <= 2 * block:
        neg, idx = jax.lax.top_k(-scores, k)
        return TopKBatchResult(-neg, idx.astype(jnp.int32),
                               jnp.ones((B,), jnp.bool_))

    # large-k regime: narrow the fold so candidates stay a small fraction
    # of n (cap is a block COUNT — the certification worst case of k
    # winners in k distinct blocks is width-independent, so the same count
    # stays valid at the narrower width). Width is decided on the
    # *unclamped* cap, then the count is clamped for the chosen width.
    cap0 = cap if cap is not None else max(2 * k + 256, 512)
    if cap0 * block * 4 > n and block > _NARROW:
        block = _NARROW
    cap = _tournament_cap(n, k, block, cap)
    if cap * block * 2 >= n:
        # even the narrow fold cannot shrink the problem: sort-exact
        neg, idx = jax.lax.top_k(-scores, k)
        return TopKBatchResult(-neg, idx.astype(jnp.int32),
                               jnp.ones((B,), jnp.bool_))
    n_blocks = -(-n // block)   # cap <= n_blocks (clamped in _tournament_cap)
    pad = n_blocks * block - n
    if pad:
        scores = jnp.concatenate(
            [scores, jnp.full((B, pad), jnp.inf, scores.dtype)], axis=1
        )
    blocks = scores.reshape(B, n_blocks, block)
    bmin = blocks.min(axis=2)                                # (B, G)

    # cap smallest block minima — recurse through the tournament when G is
    # itself large (the recursion bottoms out in the n <= 4k direct path)
    if n_blocks > 4 * cap:
        mu_sel, bidx, sel_ok = topk_min_batched(
            bmin, cap, _NARROW, cap + 256
        )
    else:
        neg_mu, bidx = jax.lax.top_k(-bmin, cap)             # (B, cap)
        mu_sel = -neg_mu
        bidx = bidx.astype(jnp.int32)
        sel_ok = jnp.ones((B,), jnp.bool_)
    mu_cap = jnp.where(cap < n_blocks, mu_sel[:, -1], jnp.inf)
    bidx = jnp.sort(bidx, axis=-1)

    # candidate gather + final exact top-k, chunked over batch rows when
    # the padded gather source would blow the budget (see _GATHER_BUDGET)
    pad_lanes = block if block >= 128 else 128
    src_bytes = n_blocks * pad_lanes * scores.dtype.itemsize
    b_chunk = max(1, _GATHER_BUDGET // max(src_bytes, 1))
    if b_chunk >= B:
        values, indices = _cand_topk(scores, bidx, k, block, n_blocks)
    else:
        nc = -(-B // b_chunk)
        bpad = nc * b_chunk - B
        sc = jnp.pad(scores, ((0, bpad), (0, 0)), constant_values=jnp.inf)
        bi = jnp.pad(bidx, ((0, bpad), (0, 0)))
        values, indices = jax.lax.map(
            lambda a: _cand_topk(a[0], a[1], k, block, n_blocks),
            (sc.reshape(nc, b_chunk, -1), bi.reshape(nc, b_chunk, -1)),
        )
        values = values.reshape(nc * b_chunk, k)[:B]
        indices = indices.reshape(nc * b_chunk, k)[:B]
    ok = (
        values[:, -1] < mu_cap
        if cap < n_blocks
        else jnp.ones((B,), jnp.bool_)
    )
    return TopKBatchResult(values, indices.astype(jnp.int32),
                           jnp.asarray(ok) & sel_ok)


def _cand_topk(scores, bidx, k, block, n_blocks):
    """Gather the selected blocks' elements and run the exact final top-k.

    ``scores`` is the block-padded ``(Bc, n_blocks * block)`` view. The
    reshape below is the gather operand, so it materializes at its padded
    layout (narrow blocks lane-pad ``block`` -> 128); callers bound ``Bc``
    against :data:`_GATHER_BUDGET`.
    """
    Bc, cap = bidx.shape
    rows = scores.reshape(Bc * n_blocks, block)
    goff = jnp.arange(Bc, dtype=jnp.int32)[:, None] * n_blocks
    cand = rows[(bidx + goff).reshape(-1)].reshape(Bc, cap * block)
    cand_idx = (
        bidx[:, :, None] * block
        + jnp.arange(block, dtype=jnp.int32)[None, None, :]
    ).reshape(Bc, cap * block)
    neg_v, local = jax.lax.top_k(-cand, k)                   # (Bc, k)
    loff = jnp.arange(Bc, dtype=jnp.int32)[:, None] * (cap * block)
    indices = cand_idx.reshape(-1)[(local + loff).reshape(-1)].reshape(Bc, k)
    return -neg_v, indices


@partial(jax.jit, static_argnums=(1, 2, 3), inline=True)
def topk_min_checked(
    scores: jax.Array,
    k: int,
    block: int = _DEFAULT_BLOCK,
    cap: int | None = None,
) -> TopKResult:
    """Exact k smallest with the sort fallback folded in via ``lax.cond``.

    Prefer :func:`topk_min` + host-side ``ok`` check when running under
    ``vmap`` (a vmapped ``cond`` executes both branches).
    """
    n = scores.shape[0]
    if n <= 4 * k or n <= 2 * block:
        return topk_min_sort(scores, k)
    fast = topk_min(scores, k, block, cap)
    return jax.lax.cond(
        fast.ok,
        lambda s: fast,
        lambda s: topk_min_sort(s, k),
        scores,
    )


def merge_min(
    values_a: jax.Array,
    indices_a: jax.Array,
    values_b: jax.Array,
    indices_b: jax.Array,
    k: int,
) -> tuple[jax.Array, jax.Array]:
    """Exact merge of two k-smallest partial results along the last axis.

    On equal values the earlier operand (``a``) wins, matching the
    concat-then-select order of the reference's streaming merge
    (``path_shadowing.py:170-173``).
    """
    v = jnp.concatenate([values_a, values_b], axis=-1)
    i = jnp.concatenate([indices_a, indices_b], axis=-1)
    neg, sel = jax.lax.top_k(-v, k)
    return -neg, jnp.take_along_axis(i, sel, axis=-1)
