"""Factored two-pass search (``ops/factored.py``): the plain XLA pass-1
against the direct oracle, the Pallas-Triton kernel (interpret mode here,
compiled on the card) against the plain version, the tile and kernel shapes,
and the engine routing around it."""
import jax
import jax.numpy as jnp
import numpy as np
import pytest

from shadowing_tpu import (
    MSE,
    Identity,
    ImputationContext,
    PathEmbedding,
    PathShadowing,
    PredictionContext,
    RelativeMSE,
)
from shadowing_tpu.ops import factored
from shadowing_tpu.ops.factored import (
    L,
    blockmin_triton,
    blockmin_xla,
    build_factored,
    e_bytes,
    id_space,
    kernel_shapes,
    pad_views,
    tiling,
    two_pass_search_factored,
)
from shadowing_tpu.ops.sliding import sliding_dot


def make_problem(rng, R=256, T=700, w=24, d=12, B=9, C=1):
    """Embedding bank + contexts: g = x_emb @ kernel ties the two pass-1
    formulations to the same combined filters."""
    y = rng.normal(0, 0.02, size=(R, C, T)).astype(np.float32)
    kernel = rng.normal(size=(d, C, w)).astype(np.float32)
    x_emb = rng.normal(size=(B, d)).astype(np.float32)
    g = np.einsum("bd,dcw->bcw", x_emb, kernel).astype(np.float32)
    n_out = T - w + 1
    e = np.asarray(sliding_dot(jnp.asarray(y), jnp.asarray(kernel),
                               n_out=n_out))                 # (R, d, n_out)
    norms = (e.astype(np.float64) ** 2).sum(axis=1).astype(np.float32)
    return y, kernel, x_emb, g, norms, n_out


def build(y, kernel, norms, n_out):
    R, w = y.shape[0], kernel.shape[-1]
    y3, n2 = pad_views(jnp.asarray(y), jnp.asarray(norms), n_out, w)
    E, nt = build_factored(y3, n2, jnp.asarray(kernel),
                           nbt=tiling(R, n_out)[1])
    return y3, n2, E, nt


def oracle_scores(y, g, norms, n_out):
    cross = np.einsum(
        "rctw,bcw->brt",
        np.lib.stride_tricks.sliding_window_view(
            y.astype(np.float64), g.shape[-1], axis=-1)[:, :, :n_out],
        g.astype(np.float64))
    return norms[None].astype(np.float64) - 2 * cross         # (B, R, n_out)


def oracle_blockmin(y, g, norms, n_out, rows):
    s = oracle_scores(y, g, norms, n_out)
    B, R, _ = s.shape
    nblk = -(-n_out // L)
    s = np.pad(s, ((0, 0), (0, rows - R), (0, nblk * L - n_out)),
               constant_values=np.inf)
    return s.reshape(B, rows * nblk, L).min(axis=-1)


@pytest.mark.parametrize("R,T,w,d,B,C,k", [
    (256, 700, 24, 12, 9, 1, 64),    # the engine's multi-context case
    (293, 400, 21, 7, 8, 1, 32),     # R off the tile grid, n_out off blocks
    (64, 500, 40, 10, 8, 3, 48),     # several channels
    (40, 500, 20, 20, 1, 1, 200),    # one context, k above a block
    (16, 900, 126, 34, 2, 1, 16),    # reference embedding width and dim
    (64, 900, 252, 12, 2, 1, 32),    # w > 129: segments span 3 L-blocks
    (512, 700, 20, 20, 1, 1, 5000),  # k > 4096: every block selected
    (2048, 700, 20, 20, 1, 1, 5000),  # k > 4096 with blocks left out
])
def test_plain_pass1_matches_oracle(rng, R, T, w, d, B, C, k):
    """The plain factored pass-1 and its certified top-k against float64."""
    y, kernel, x_emb, g, norms, n_out = make_problem(rng, R, T, w, d, B, C)
    y3, n2, E, nt = build(y, kernel, norms, n_out)
    rows = y3.shape[0]
    bmin = np.asarray(blockmin_xla(E, nt, jnp.asarray(x_emb)))
    want = oracle_blockmin(y, g, norms, n_out, rows)
    fin = np.isfinite(want)
    assert (np.isfinite(bmin) == fin).all()      # padding stays +inf
    np.testing.assert_allclose(bmin[fin], want[fin], rtol=1e-4, atol=2e-6)

    vals, idx, ok = two_pass_search_factored(
        E, nt, y3, n2, jnp.asarray(g), jnp.asarray(x_emb), k=k,
        n_out=n_out)
    assert np.asarray(ok).all()
    flat = oracle_scores(y, g, norms, n_out).reshape(B, -1)
    top = np.sort(flat, axis=1)[:, :k]
    np.testing.assert_allclose(np.asarray(vals), top, rtol=1e-4, atol=1e-6)
    got = np.take_along_axis(flat, np.asarray(idx, np.int64), 1)
    np.testing.assert_allclose(got, np.asarray(vals), rtol=1e-4, atol=1e-6)


@pytest.mark.parametrize("R,T,w,d,B", [
    (64, 300, 20, 20, 1),      # one context: a 16-row launch, mostly padding
    (96, 400, 24, 12, 9),
    (40, 260, 16, 7, 64),      # exactly one full launch
    (32, 300, 20, 5, 70),      # two launches, the second ragged
    (300, 300, 20, 20, 4),     # several tiles and several column blocks
])
def test_triton_kernel_matches_plain(rng, R, T, w, d, B):
    """The Pallas-Triton kernel (interpreted) equals the plain version up
    to the order of float32 sums."""
    y, kernel, x_emb, g, norms, n_out = make_problem(rng, R, T, w, d, B)
    _, _, E, nt = build(y, kernel, norms, n_out)
    want = np.asarray(blockmin_xla(E, nt, jnp.asarray(x_emb)))
    got = np.asarray(blockmin_triton(E, nt, jnp.asarray(x_emb),
                                     interpret=True))
    assert got.shape == want.shape
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    np.testing.assert_allclose(got[fin], want[fin], rtol=1e-5, atol=1e-7)


@pytest.mark.parametrize("B,d,nbt,want", [
    (1, 20, 1024, (16, 32, 128)),
    (9, 7, 1024, (16, 16, 128)),
    (33, 34, 256, (64, 64, 128)),
    (64, 20, 1024, (64, 32, 128)),
    (200, 126, 64, (64, 128, 64)),
    (5, 3, 16, (16, 16, 16)),
])
def test_kernel_shapes(B, d, nbt, want):
    """Contexts per launch, padded contraction and block columns: powers
    of two, every dot dimension >= 16, never wider than the tile."""
    assert kernel_shapes(B, d, nbt) == want


@pytest.mark.parametrize("R,n_out", [
    (32768, 4057),     # target / backtest: 32 blocks per row
    (131072, 3719),    # reference: 30 blocks per row
    (293, 380),        # odd block count, small R
    (100, 233),
    (7, 50),           # fewer blocks than the smallest tile
    (8192, 3825),
])
def test_tiling_covers_rows_with_little_padding(R, n_out):
    rows, nbt = tiling(R, n_out)
    nblk = -(-n_out // L)
    assert nbt & (nbt - 1) == 0 and 16 <= nbt <= 1024
    assert rows >= R and (rows * nblk) % nbt == 0
    assert nbt == 16 or 8 * (rows - R) <= R
    assert id_space(R, n_out) == rows * nblk * L
    assert e_bytes(R, n_out, 20) == rows * nblk * L * 20 * 4


def test_e_bytes_at_the_deployments():
    # target / backtest: 10.74 GB (fits the card); reference: 68.4 GB (the
    # engine declines the factored route there)
    assert e_bytes(32768, 4057, 20) == 32768 * 32 * 128 * 20 * 4
    assert e_bytes(131072, 3719, 34) == 131072 * 30 * 128 * 34 * 4


def test_pad_views_bar_padding(rng):
    y, kernel, x_emb, g, norms, n_out = make_problem(rng, R=100, T=300)
    y3, n2 = pad_views(jnp.asarray(y), jnp.asarray(norms), n_out,
                       kernel.shape[-1])
    rows, _ = tiling(100, n_out)
    assert y3.shape[0] == n2.shape[0] == rows
    n2 = np.asarray(n2)
    assert np.isinf(n2[100:]).all() and np.isinf(n2[:, n_out:]).all()
    np.testing.assert_array_equal(n2[:100, :n_out], norms)
    np.testing.assert_array_equal(np.asarray(y3)[:100, :, :300], y)


def test_blockmin_dispatch_uses_plain_version_off_cuda(rng):
    y, kernel, x_emb, g, norms, n_out = make_problem(rng, R=64, T=300)
    _, _, E, nt = build(y, kernel, norms, n_out)
    x = jnp.asarray(x_emb)
    np.testing.assert_array_equal(
        np.asarray(jax.jit(factored.blockmin)(E, nt, x)),
        np.asarray(blockmin_xla(E, nt, x)))


@pytest.mark.gpu
def test_compiled_kernel_matches_plain_on_gpu(gpu, rng):
    y, kernel, x_emb, g, norms, n_out = make_problem(rng, R=512, T=700)
    _, _, E, nt = build(y, kernel, norms, n_out)
    want = np.asarray(blockmin_xla(E, nt, jnp.asarray(x_emb)))
    got = np.asarray(blockmin_triton(E, nt, jnp.asarray(x_emb)))
    fin = np.isfinite(want)
    assert (np.isfinite(got) == fin).all()
    # the kernel's product runs at precision.KERNEL (bf16 x3, ~5e-6
    # relative per product) against the plain version's float32
    scale = np.abs(want[fin]).max()
    np.testing.assert_allclose(got[fin], want[fin], rtol=0,
                               atol=2e-5 * scale)


# --------------------------------------------------------------------------
# engine routing
# --------------------------------------------------------------------------

def _engine(dataset, horizon=16, w=24, **kw):
    return PathShadowing(Identity(w), RelativeMSE(), dataset,
                         PredictionContext(horizon=horizon), **kw)


def test_engine_routes_and_matches(rng):
    """auto takes the factored route at any B and returns results
    array-identical to fused and direct."""
    dataset = rng.normal(0, 0.02, size=(48, 1, 300)).astype(np.float32)
    dataset[11] = dataset[2]                 # force in-k distance ties
    starts = rng.integers(0, 200, size=9)
    ctx = np.stack([dataset[i % 48, :, s : s + 24]
                    for i, s in enumerate(starts)])
    obj = _engine(dataset)
    d_a, p_a, i_a = obj.shadow(ctx, k=40)
    assert obj.last_metrics["method"] == "factored"
    assert obj._factored is not None
    d_f, p_f, i_f = obj.shadow(ctx, k=40, method="fused")
    d_d, p_d, i_d = obj.shadow(ctx, k=40, method="direct")
    np.testing.assert_array_equal(i_a, i_f)
    np.testing.assert_array_equal(i_a, i_d)
    np.testing.assert_array_equal(d_a, d_d)
    np.testing.assert_array_equal(p_a, p_f)
    d1, _, i1 = obj.shadow(ctx[:1], k=40)    # one context: same route
    assert obj.last_metrics["method"] == "factored"
    np.testing.assert_array_equal(i1, i_d[:1])


@pytest.mark.parametrize("dist", [RelativeMSE(), MSE()])
def test_engine_imputation_context(rng, dist):
    """Context-adjusted plans (gap-padded kernel taps) build E from the SAME
    plan kernel as the combined filters — factored must match direct."""
    dataset = rng.normal(0, 0.02, size=(40, 1, 280)).astype(np.float32)
    ctx = np.stack([dataset[i, :, 50 : 50 + 24] for i in range(8)])
    obj = PathShadowing(Identity(24), dist, dataset,
                        ImputationContext((10, 6, 14)))
    d_p, p_p, i_p = obj.shadow(ctx, k=24, method="factored")
    d_d, p_d, i_d = obj.shadow(ctx, k=24, method="direct")
    np.testing.assert_array_equal(i_p, i_d)
    np.testing.assert_array_equal(d_p, d_d)


def test_general_embedding_multichannel(rng):
    dataset = rng.normal(0, 0.02, size=(30, 2, 200)).astype(np.float32)
    emb = PathEmbedding(rng.normal(size=(9, 2, 16)).astype(np.float32))
    obj = PathShadowing(emb, RelativeMSE(), dataset, PredictionContext(8))
    ctx = rng.normal(0, 0.02, size=(3, 2, 16)).astype(np.float32)
    d_p, _, i_p = obj.shadow(ctx, k=20, method="factored")
    d_d, _, i_d = obj.shadow(ctx, k=20, method="direct")
    np.testing.assert_array_equal(i_p, i_d)
    np.testing.assert_allclose(d_p, d_d, rtol=1e-6)


def test_wide_filter_factored_matches_direct(rng):
    """A 200-tap filter: pass 2 gathers 3 L-blocks per candidate segment."""
    dataset = rng.normal(0, 0.02, size=(40, 1, 700)).astype(np.float32)
    emb = PathEmbedding(rng.normal(size=(12, 1, 200)).astype(np.float32))
    obj = PathShadowing(emb, RelativeMSE(), dataset, PredictionContext(8))
    ctx = np.stack([dataset[i, :, 90 + 40 * i: 290 + 40 * i]
                    for i in range(3)])
    d_a, _, i_a = obj.shadow(ctx, k=24)
    assert obj.last_metrics["method"] == "factored"
    d_d, _, i_d = obj.shadow(ctx, k=24, method="direct")
    np.testing.assert_array_equal(i_a, i_d)
    np.testing.assert_allclose(d_a, d_d, rtol=1e-6)


def test_pallas_method_is_gone(rng):
    obj = _engine(rng.normal(0, 0.02, size=(16, 1, 128)).astype(np.float32))
    with pytest.raises(ValueError, match='method="pallas" no longer exists'):
        obj.shadow(np.zeros((1, 1, 24), np.float32) + 0.01, k=4,
                   method="pallas")


def test_routing_log_reasons(rng, monkeypatch):
    """Auto-routing decisions leave one structured reason line each; a
    memory decline names the gate with its byte math and falls back to the
    fused route."""
    import shadowing_tpu.shadow.engine as eng

    dataset = rng.normal(0, 0.02, size=(48, 1, 300)).astype(np.float32)
    ctx = np.repeat(dataset[[2], :, 30:54], 9, axis=0)
    with monkeypatch.context() as mp:
        mp.setattr(eng, "_memory_budget", lambda: 1 << 20)
        obj = _engine(dataset)
        obj.shadow(ctx, k=8)
        assert obj._factored is None
        assert obj.last_metrics["method"] == "fused"
        assert any("factored declined: E needs" in s and "GB free" in s
                   for s in obj.routing_log), obj.routing_log
        with pytest.raises(ValueError, match="factored search unavailable"):
            obj.shadow(ctx, k=8, method="factored")
    obj = _engine(dataset)
    obj.shadow(ctx, k=8)
    assert any(s.startswith("factored pass-1 routed:")
               for s in obj.routing_log), obj.routing_log
    assert any(s.startswith("method=factored") for s in obj.routing_log)


def test_cosine_takes_the_fused_route(rng):
    from shadowing_tpu import CosineDistance

    dataset = rng.normal(0, 0.02, size=(24, 1, 200)).astype(np.float32)
    obj = PathShadowing(Identity(16), CosineDistance(), dataset,
                        PredictionContext(8))
    obj.shadow(dataset[:2, :, 10:26], k=8)
    assert obj.last_metrics["method"] == "fused"
    assert any("lacks the norm2 - 2*cross" in s for s in obj.routing_log)


def test_scratch_budget(rng):
    """With E resident the extraction scratch budget shrinks to the real
    headroom (floored at 256 MB); without it the default budget applies."""
    from shadowing_tpu.shadow.engine import _memory_budget

    dataset = rng.normal(0, 0.02, size=(48, 1, 300)).astype(np.float32)
    obj = _engine(dataset)
    assert obj._scratch_budget() is None          # nothing resident yet
    obj.shadow(np.repeat(dataset[[2], :, 30:54], 9, axis=0), k=8)
    assert obj._factored is not None
    b = obj._scratch_budget()
    assert b is not None and (256 << 20) <= b <= _memory_budget()


def test_search_failure_reroutes_to_fused(rng, monkeypatch):
    """A JaxRuntimeError from the factored search (e.g. a selection
    temporary that outgrows device memory) reroutes to the fused route with
    the IDENTICAL certified result, logs it, and memoizes the (B, k) shape
    so later calls skip the doomed attempt."""
    import shadowing_tpu.shadow.engine as eng

    dataset = rng.normal(0, 0.02, size=(48, 1, 300)).astype(np.float32)
    ctx = np.repeat(dataset[[2], :, 30:54], 9, axis=0)
    obj = _engine(dataset)
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: out of memory")

    monkeypatch.setattr(eng.factored, "two_pass_search_factored", boom)
    d_f, p_f, i_f = obj.shadow(ctx, k=8)
    assert calls["n"] == 1 and (9, 8) in obj._factored_failed
    assert obj.last_metrics["method"] == "fused"
    assert any("factored FAILED at B=9, k=8 (search)" in s
               for s in obj.routing_log), obj.routing_log
    obj.shadow(ctx, k=8)                      # memoized: no new attempt
    assert calls["n"] == 1
    d_d, p_d, i_d = obj.shadow(ctx, k=8, method="direct")
    np.testing.assert_array_equal(i_f, i_d)
    np.testing.assert_array_equal(p_f, p_d)


def test_build_failure_disables(rng, monkeypatch):
    """A runtime failure in build_factored (engine-static inputs) disables
    the factored route engine-wide: a later call at another (B, k) does not
    retry the identical doomed build."""
    import shadowing_tpu.shadow.engine as eng

    dataset = rng.normal(0, 0.02, size=(48, 1, 300)).astype(np.float32)
    ctx = np.repeat(dataset[[2], :, 30:54], 9, axis=0)
    obj = _engine(dataset)
    calls = {"n": 0}

    def boom(*a, **k):
        calls["n"] += 1
        raise jax.errors.JaxRuntimeError("")  # empty message: the handler
        # must not crash extracting its first line

    monkeypatch.setattr(eng.factored, "build_factored", boom)
    d_f, p_f, i_f = obj.shadow(ctx, k=8)
    assert calls["n"] == 1 and obj._factored_disabled
    assert any("factored FAILED at B=9, k=8 (build)" in s
               for s in obj.routing_log), obj.routing_log
    obj.shadow(ctx, k=12)                     # another shape: no retry
    assert calls["n"] == 1
    d_d, p_d, i_d = obj.shadow(ctx, k=8, method="direct")
    np.testing.assert_array_equal(i_f, i_d)
    np.testing.assert_array_equal(p_f, p_d)


def test_factored_redo_escalates_and_memoizes(rng, monkeypatch):
    """Certification failure on the factored route: tier-1 redo retries the
    factored search at a wider cap (not the direct oracle) and memoizes the
    certified cap so the next same-shape search skips the redo."""
    from shadowing_tpu.shadow import engine as eng

    dataset = rng.normal(0, 0.02, size=(32, 1, 256)).astype(np.float32)
    x_context = rng.normal(0, 0.02, size=(4, 1, 24)).astype(np.float32)
    obj = _engine(dataset)
    d_ref, _, i_ref = obj.shadow(x_context, k=32, method="direct")
    orig = eng.factored.two_pass_search_factored
    calls = {"n": 0}

    def forced(*a, **kw):
        calls["n"] += 1
        if calls["n"] == 1:  # cripple only the primary search
            kw["cap"] = 1
        return orig(*a, **kw)

    monkeypatch.setattr(eng.factored, "two_pass_search_factored", forced)
    obj2 = _engine(dataset)
    d, p, i = obj2.shadow(x_context, k=32)
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-6)
    assert calls["n"] == 2  # primary + escalated retry, no third pass
    assert obj2._cap_memo.get((4, 32)) is not None
    assert any("escalated cap" in m for m in obj2.routing_log)
    d2, _, i2 = obj2.shadow(x_context, k=32)   # memoized cap, no redo
    assert calls["n"] == 3
    np.testing.assert_array_equal(i2, i_ref)
    assert any("cap memo" in m for m in obj2.routing_log)


@pytest.mark.parametrize("escalated", ["uncertified", "fails"])
def test_factored_redo_tier2_frees_E(rng, monkeypatch, escalated):
    """When the wider-cap retry leaves contexts uncertified (or fails at
    run time), tier 2 evicts E and nothing keeps it alive while the direct
    oracle runs: the oracle's scratch budget counts on that memory."""
    import gc
    import weakref

    from shadowing_tpu.shadow import engine as eng

    dataset = rng.normal(0, 0.02, size=(32, 1, 256)).astype(np.float32)
    x_context = rng.normal(0, 0.02, size=(4, 1, 24)).astype(np.float32)
    d_ref, p_ref, i_ref = _engine(dataset).shadow(x_context, k=32,
                                                  method="direct")
    orig = eng.factored.two_pass_search_factored
    orig_direct = eng._direct_search
    e_refs, e_alive = [], []

    def crippled(*a, **kw):
        e_refs.append(weakref.ref(a[0]))
        if len(e_refs) == 2 and escalated == "fails":
            raise jax.errors.JaxRuntimeError("RESOURCE_EXHAUSTED: oom")
        kw["cap"] = 1          # one block: certification fails
        return orig(*a, **kw)

    def direct(*a, **kw):
        gc.collect()
        e_alive.append(any(r() is not None for r in e_refs))
        return orig_direct(*a, **kw)

    monkeypatch.setattr(eng.factored, "two_pass_search_factored", crippled)
    monkeypatch.setattr(eng, "_direct_search", direct)
    obj = _engine(dataset)
    d, p, i = obj.shadow(x_context, k=32)
    assert len(e_refs) == 2              # primary + escalated retry
    assert e_alive == [False]            # E gone before the oracle ran
    assert obj._factored is None
    assert any("evicted factored E cache" in m for m in obj.routing_log)
    if escalated == "fails":
        assert any("FAILED" in m and "direct oracle" in m
                   for m in obj.routing_log), obj.routing_log
        assert (4, 32) not in obj._cap_memo
    np.testing.assert_array_equal(i, i_ref)
    np.testing.assert_array_equal(p, p_ref)
    np.testing.assert_allclose(d, d_ref, rtol=1e-6)
