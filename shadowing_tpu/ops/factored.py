"""Two-pass shadow search over precomputed embedding responses.

Pass 1 scores every window of every trajectory against each context and
keeps only the minimum of each block of ``L = 128`` consecutive window
starts. The combined context filter is linear in the embedding, so

    cross_b[r, t] = sum_d x_emb[b, d] * E[r, d, t],   E[r, d, t] = (y_r * k_d)[t]

where the responses ``E`` do not depend on the context: they are built once
per engine (:func:`build_factored`) and every later search reduces to a
``(B, d) x (d, windows)`` product plus a block-min (:func:`blockmin`).

Pass 2 (:func:`pass2_from_bmin`) selects the ``cap`` best blocks per
context, rescores their windows exactly from the raw data, takes the exact
top-k of those candidates and certifies it against the best unselected
block minimum, with a guard band calibrated from the pass-1 error it
observes on the selected blocks.

Layout. Blocks are numbered ``n = r * nblk + j`` (trajectory row ``r``,
block ``j`` of its ``nblk``). They are grouped in tiles of ``nbt`` blocks
(a power of two); the row count is padded (with ``+inf`` norms) so that the
tiles cover whole rows. ``E`` is ``(NT, d, L, nbt)``: tile ``t`` is one
contiguous ``(d, L * nbt)`` matrix, so its product with the contexts is a
plain GEMM whose ``(B, L, nbt)`` output folds to block minima over ``L``.

Pass 1 has two implementations of one contract:

* :func:`blockmin_xla`, a ``lax.map`` over tiles of GEMM + min: the
  reference, and the route on every backend but CUDA;
* :func:`blockmin_triton`, a Pallas kernel through Triton that reads each
  tile of ``E`` once and keeps the product and the running minimum over
  ``L`` in registers, writing only ``(B, blocks)`` minima.
"""
from __future__ import annotations

import math
from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as pltriton

from shadowing_tpu.ops import precision
from shadowing_tpu.ops import topk as topk_ops
from shadowing_tpu.ops.sliding import _toeplitz, sliding_dot

L = 128                 # window starts per block (= the tournament block)
#: blocks per tile of E, at most: a (64 contexts x L x 1024) f32 score tile
#: of the plain route is 32 MB, inside the card's 50 MB L2
_TILE_BLOCKS = 1024
#: blocks per tile, at least: the kernel's block columns are a dot operand
#: dimension, which Triton wants >= 16
_MIN_TILE_BLOCKS = 16
#: contexts per kernel launch (the (B, BN) running minimum lives in
#: registers) and block columns per kernel program; num_warps=4,
#: num_stages=3 and 128 columns were the fastest of the variants timed on
#: an H100 at the backtest shape (PERF.md)
_KERNEL_B = 64
_KERNEL_BN = 128


def _seg_blocks(w: int) -> int:
    """L-blocks a segment spans: ``L`` outputs need ``L + w - 1`` samples."""
    return -(-(L + w - 1) // L)


def _pow2_at_least(n: int) -> int:
    return 1 << max(0, n - 1).bit_length()


def tiling(R: int, n_out: int) -> Tuple[int, int]:
    """``(rows, nbt)``: the padded row count and the blocks per tile for an
    ``R``-row dataset with ``n_out`` window starts per row.

    Tiles hold whole rows, so ``rows * nblk`` must be a multiple of
    ``nbt``; the widest tile whose row padding stays within an eighth of
    ``R`` is taken."""
    nblk = -(-n_out // L)
    nbt = max(_MIN_TILE_BLOCKS, min(_TILE_BLOCKS, _pow2_at_least(R * nblk)))
    while True:
        step = nbt // math.gcd(nbt, nblk)    # rows per whole number of tiles
        rows = -(-R // step) * step
        if nbt == _MIN_TILE_BLOCKS or 8 * (rows - R) <= R:
            return rows, nbt
        nbt //= 2


def e_bytes(R: int, n_out: int, d: int) -> int:
    """Device bytes of the responses ``E`` (float32)."""
    rows, _ = tiling(R, n_out)
    return rows * (-(-n_out // L)) * L * d * 4


def id_space(R: int, n_out: int) -> int:
    """Size of the padded flat window-id space ``rows * nblk * L`` that the
    two passes index; callers keep it below int32."""
    rows, _ = tiling(R, n_out)
    return rows * (-(-n_out // L)) * L


@partial(jax.jit, static_argnames=("n_out", "w"))
def pad_views(
    y: jax.Array,        # (R, C, T) trajectories
    norms: jax.Array,    # (R, n_out) window norms
    n_out: int,
    w: int,              # filter width (plan kernel)
) -> Tuple[jax.Array, jax.Array]:
    """``y3 (rows, C, (nblk + m - 1) * L)`` and ``n2 (rows, nblk * L)``: the
    dataset and its norms padded to whole tiles and whole blocks; padded
    windows carry ``+inf`` norms so they never win."""
    R, C, T = y.shape
    rows, _ = tiling(R, n_out)
    nblk = -(-n_out // L)
    t_need = (nblk + _seg_blocks(w) - 1) * L
    y3 = jnp.pad(y, ((0, rows - R), (0, 0), (0, max(0, t_need - T))))
    y3 = y3[:, :, :t_need]
    n2 = jnp.pad(norms, ((0, rows - R), (0, nblk * L - n_out)),
                 constant_values=jnp.inf)
    return y3, n2


@partial(jax.jit, static_argnames=("nbt",))
def build_factored(
    y3: jax.Array,       # (rows, C, cols) from pad_views
    n2: jax.Array,       # (rows, nblk * L) from pad_views
    kernel: jax.Array,   # (d, C, w) embedding bank (the engine's plan kernel)
    nbt: int,            # blocks per tile, from tiling() of the true R
) -> Tuple[jax.Array, jax.Array]:
    """Responses ``E (NT, d, L, nbt)`` and norms ``nt (NT, L, nbt)`` in the
    tiled layout of the module docstring. Built one group of whole tiles at
    a time, so the transient is a group, not a second copy of ``E``."""
    rows, C, cols = y3.shape
    d = kernel.shape[0]
    nblk = n2.shape[1] // L
    step = nbt // math.gcd(nbt, nblk)
    n_groups = rows // step
    tiles_per_group = step * nblk // nbt

    def group(y_g):                                      # (step, C, cols)
        e = sliding_dot(y_g, kernel, n_out=nblk * L,
                        precision=precision.SELECT)      # (step, d, nblk*L)
        e = e.reshape(step, d, nblk, L).transpose(0, 2, 1, 3)
        e = e.reshape(tiles_per_group, nbt, d, L)
        return e.transpose(0, 2, 3, 1)                   # (tpg, d, L, nbt)

    E = jax.lax.map(group, y3.reshape(n_groups, step, C, cols))
    E = E.reshape(n_groups * tiles_per_group, d, L, nbt)
    nt = n2.reshape(-1, nbt, L).transpose(0, 2, 1)        # (NT, L, nbt)
    return E, nt


@jax.jit
def blockmin_xla(E: jax.Array, nt: jax.Array, x_emb: jax.Array) -> jax.Array:
    """``(B, NT * nbt)`` block minima of ``nt - 2 * x_emb @ E`` — one GEMM
    and one min over ``L`` per tile."""
    B = x_emb.shape[0]

    def tile(args):
        e, n = args                                      # (d, L, nbt), (L, nbt)
        cross = jnp.einsum("bd,dln->bln", x_emb, e,
                           precision=precision.SELECT,
                           preferred_element_type=jnp.float32)
        return (n[None] - 2.0 * cross).min(axis=1)       # (B, nbt)

    return jax.lax.map(tile, (E, nt)).transpose(1, 0, 2).reshape(B, -1)


def _blockmin_kernel(x_ref, e_ref, n_ref, o_ref, *, d, nbt, bn):
    """One program: tile ``t``, block columns ``[c * bn, (c + 1) * bn)``.
    ``e_ref`` is E viewed as ``(NT * d, L * nbt)``, ``n_ref`` the norms
    flattened; the contraction dim is padded to ``x_ref``'s width by masked
    loads."""
    t = pl.program_id(0)
    c = pl.program_id(1)
    bp, kp = x_ref.shape
    kk = jnp.arange(kp)
    rows = t * d + kk
    kmask = jnp.broadcast_to((kk < d)[:, None], (kp, bn))
    cols = c * bn + jnp.arange(bn)
    x = x_ref[...]

    def body(l, acc):
        e = pltriton.load(e_ref.at[rows[:, None], (l * nbt + cols)[None, :]],
                       mask=kmask, other=0.0)
        cross = jax.lax.dot_general(
            x, e, (((1,), (0,)), ((), ())), precision=precision.KERNEL,
            preferred_element_type=jnp.float32)
        nrm = pltriton.load(n_ref.at[(t * L + l) * nbt + cols])
        return jnp.minimum(acc, nrm[None, :] - 2.0 * cross)

    acc = jax.lax.fori_loop(0, L, body,
                            jnp.full((bp, bn), jnp.inf, jnp.float32))
    pltriton.store(o_ref.at[jnp.arange(bp)[:, None],
                         (t * nbt + cols)[None, :]], acc)


def kernel_shapes(B: int, d: int, nbt: int) -> Tuple[int, int, int]:
    """``(contexts per launch, padded contraction, block columns per
    program)``: Triton wants power-of-two blocks and every dot dim >= 16."""
    bp = min(_KERNEL_B, max(16, _pow2_at_least(B)))
    return bp, max(16, _pow2_at_least(d)), min(_KERNEL_BN, nbt)


@partial(jax.jit, static_argnames=("interpret",))
def blockmin_triton(E: jax.Array, nt: jax.Array, x_emb: jax.Array,
                    interpret: bool = False) -> jax.Array:
    """:func:`blockmin_xla` as a Triton kernel (same result up to the
    order of float32 sums). ``interpret=True`` runs the Pallas interpreter
    (tests only; the card runs the compiled kernel)."""
    NT, d, _, nbt = E.shape
    B = x_emb.shape[0]
    bp, kp, bn = kernel_shapes(B, d, nbt)
    n_launch = -(-B // bp)
    x = jnp.pad(x_emb, ((0, n_launch * bp - B), (0, kp - d)))
    call = pl.pallas_call(
        partial(_blockmin_kernel, d=d, nbt=nbt, bn=bn),
        grid=(NT, nbt // bn),
        out_shape=jax.ShapeDtypeStruct((bp, NT * nbt), jnp.float32),
        backend="triton",
        compiler_params=pltriton.CompilerParams(num_warps=4, num_stages=3),
        interpret=interpret,
        name="shadow_factored_blockmin",
    )
    e2 = E.reshape(NT * d, L * nbt)
    n1 = nt.reshape(-1)
    out = [call(x[i * bp:(i + 1) * bp], e2, n1) for i in range(n_launch)]
    return jnp.concatenate(out)[:B] if n_launch > 1 else out[0][:B]


def blockmin(E: jax.Array, nt: jax.Array, x_emb: jax.Array) -> jax.Array:
    """Pass-1 block minima: the Triton kernel where the backend is CUDA,
    the plain XLA version everywhere else. This is the package's one
    selection by platform: the kernel compiles only for CUDA, and the plain
    version is the reference it is tested against."""
    return jax.lax.platform_dependent(
        E, nt, x_emb, cuda=blockmin_triton, default=blockmin_xla)


@partial(jax.jit, static_argnames=("k", "n_out", "cap"))
def two_pass_search_factored(
    E: jax.Array,
    nt: jax.Array,
    y3: jax.Array,
    n2: jax.Array,
    g: jax.Array,        # (B, C, w) combined filters (pass-2 exact rescore)
    x_emb: jax.Array,    # (B, d) context embeddings (pass-1 contraction)
    k: int,
    n_out: int,
    cap: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Exact k smallest selection scores over every window.

    Returns (scores (B, k) ascending, flat ids ``traj * n_out + t`` (B, k),
    ok (B,) certification flags)."""
    rows = y3.shape[0]
    nblk = n2.shape[1] // L
    if rows * nblk * L >= jnp.iinfo(jnp.int32).max:
        raise ValueError(
            f"padded flat id space {rows} * {nblk} * {L} exceeds int32 — "
            "split the trajectory axis (see "
            "shadowing_tpu.shadow.engine.shadow_sharded_rows)"
        )
    bmin = blockmin(E, nt, x_emb)                        # (B, rows * nblk)
    return pass2_from_bmin(bmin, y3, n2, g, k=k, n_out=n_out, cap=cap)


@partial(jax.jit, static_argnames=("k", "n_out", "cap"), inline=True)
def pass2_from_bmin(
    bmin_flat: jax.Array,  # (B, rows * nblk) block minima, id = r * nblk + j
    y3: jax.Array,
    n2: jax.Array,
    g: jax.Array,
    k: int,
    n_out: int,
    cap: Optional[int] = None,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Global block selection, exact rescore of the candidate blocks,
    certified final top-k."""
    B, C, w = g.shape
    m = _seg_blocks(w)
    rows, _, cols = y3.shape
    nblk = n2.shape[1] // L
    n_blocks = rows * nblk

    if cap is None:
        # at most k - 1 blocks can hold a value strictly below the k-th
        # winner, so cap = k + slack selects every block that could matter;
        # a failed certification still falls back exactly (engine redo)
        cap = min(max(k + 384, 512), n_blocks)
    cap = min(max(cap, -(-k // L)), n_blocks)

    # banded Toeplitz operator per context, zero-padded to m whole L-blocks
    G = _toeplitz(g, L)                                  # (C, L+w-1, L, B)
    G = jnp.pad(G, ((0, 0), (0, m * L - G.shape[1]), (0, 0), (0, 0)))

    mu_sel, bidx, sel_ok = topk_ops.topk_min_batched(
        bmin_flat, cap, block=L, cap=cap + 128
    )
    mu_cap = jnp.where(cap < n_blocks, mu_sel[:, -1], jnp.inf)   # (B,)
    # sort blocks to flat order (ties match the sort oracle), carrying the
    # pass-1 minima along — they calibrate the certification guard below
    perm = jnp.argsort(bidx, axis=-1)
    bidx = jnp.take_along_axis(bidx, perm, axis=-1)
    mu_sorted = jnp.take_along_axis(mu_sel, perm, axis=-1)
    r = bidx // nblk                                     # (B, cap)
    j = bidx % nblk
    # candidate segments: each candidate needs only its m L-blocks, gathered
    # as rows of an L-column view of the padded dataset
    nb_y = cols // L
    y3f = y3.reshape(rows * C * nb_y, L)
    base = r[..., None] * C + jnp.arange(C, dtype=jnp.int32)  # (B, cap, C)
    seg = jnp.concatenate(
        [
            y3f[(base * nb_y + (j + t)[..., None]).reshape(-1)]
            .reshape(B, cap, C, L)
            for t in range(m)
        ],
        axis=-1,
    )                                                    # (B, cap, C, mL)
    cross = jnp.einsum("bkcs,cslb->bkl", seg, G, precision=precision.EXACT)
    # norms block likewise; clamp the +inf padding to a huge finite loser
    # (downstream arithmetic must stay NaN-free)
    n2f = n2.reshape(n_blocks, L)
    nsel = n2f[(r * nblk + j).reshape(-1)].reshape(B, cap, L)
    nsel = jnp.where(jnp.isinf(nsel), jnp.float32(1e30), nsel)
    s = nsel - 2.0 * cross                               # (B, cap, L)
    flat_idx = (
        (r * nblk + j)[:, :, None] * L
        + jnp.arange(L, dtype=jnp.int32)[None, None, :]
    ).reshape(B, cap * L)
    # final exact selection; the k winners occupy at most k of the cap
    # candidate blocks, so a tight cap is certified-safe
    vals, loc, fin_ok = topk_ops.topk_min_batched(
        s.reshape(B, cap * L), k, block=L, cap=k + 128
    )
    loff = jnp.arange(B, dtype=jnp.int32)[:, None] * (cap * L)
    idx = flat_idx.reshape(-1)[(loc + loff).reshape(-1)].reshape(B, k)
    # certification with a guard band for the pass-1 / pass-2 rounding
    # skew. Pass 2 holds the exact scores of every selected block, so the
    # observed |pass-1 minimum - exact minimum| over them samples the error
    # the unselected blocks carry; 2x its per-context max plus a static
    # floor bounds it (a fixed floor alone missed a boundary block on
    # tightly clustered multi-channel data). Padded blocks are excluded.
    exact_bmin = s.min(axis=2)                           # (B, cap)
    err_obs = jnp.where(
        jnp.isfinite(mu_sorted) & (exact_bmin < 1e29),
        jnp.abs(mu_sorted - exact_bmin), 0.0,
    ).max(axis=1)                                        # (B,)
    guard = 2.0 * err_obs + 1e-5 * jnp.abs(mu_cap) + 1e-12
    ok = jnp.where(jnp.isinf(mu_cap), True, vals[:, -1] + guard < mu_cap)
    ok = ok & sel_ok & fin_ok
    # padded flat ids -> true (traj * n_out + t) ids
    traj = idx // (nblk * L)
    t = idx % (nblk * L)
    return vals, (traj * n_out + t).astype(jnp.int32), ok
