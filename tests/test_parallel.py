"""Multi-device tests on the virtual 8-CPU mesh (conftest sets
xla_force_host_platform_device_count=8)."""

import jax
import numpy as np
import pytest

from kvmatch_tpu import oracle
from kvmatch_tpu.config import IndexConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.rsm_ed import QueryEngine
from kvmatch_tpu.index.build import build_index_numpy, compute_buckets_tpu
from kvmatch_tpu.parallel.build import build_index_sharded
from kvmatch_tpu.parallel.mesh import make_mesh
from kvmatch_tpu.parallel.query import (

    make_dense_query_step, make_sharded_query_step, pack_bucket_stack, pack_segments)

pytestmark = pytest.mark.slow  # multi-minute XLA-compile-heavy; quick lane skips


@pytest.fixture(scope="module")
def mesh():
    assert len(jax.devices()) == 8, "conftest must force 8 CPU devices"
    return make_mesh()


@pytest.fixture(scope="module")
def data():
    return generate_series(40_000, seed=13)


def test_sharded_build_matches_single(mesh, data):
    icfg = IndexConfig()
    ref = build_index_numpy(data, icfg)
    sharded, stack = build_index_sharded(data, mesh, icfg)
    for w in icfg.scales:
        a, b = ref[w], sharded[w]
        np.testing.assert_array_equal(a.keys, b.keys)
        np.testing.assert_array_equal(a.left, b.left)
        np.testing.assert_array_equal(a.right, b.right)
        np.testing.assert_array_equal(a.row_ptr, b.row_ptr)


def _dense_setup(data, icfg, length):
    import jax.numpy as jnp
    buckets = compute_buckets_tpu(data, icfg)
    stack = pack_bucket_stack(buckets, tuple(icfg.scales), data.size, length)
    engine = QueryEngine(data, index=build_index_numpy(data, icfg), icfg=icfg)
    return buckets, stack, engine


def test_dense_single_device_no_false_dismissal(data):
    import jax.numpy as jnp
    icfg = IndexConfig()
    L, eps = 512, 6.0
    buckets, stack, engine = _dense_setup(data, icfg, L)
    step = make_dense_query_step(icfg, L, top_k=4096)
    q = data[9000:9000 + L]
    # Reuse the host planner's segments (dense path takes them as data).
    from kvmatch_tpu.engine.base import _Ctx, QueryStats
    ctx = _Ctx(query=q, length=L, epsilon=eps, eps2=eps * eps, params={},
               stats=QueryStats())
    segs = pack_segments(engine._plan(ctx), tuple(icfg.scales))
    count, idx, d2 = step(jnp.asarray(data, jnp.float32), jnp.asarray(stack),
                          jnp.asarray(q, jnp.float32), segs, jnp.float32(eps * eps))
    count = int(count)
    assert count <= 4096
    got = np.asarray(idx)[np.asarray(d2) <= eps * eps * (1 + 1e-3)]
    oo, _ = oracle.rsm_ed(data, q, eps)
    assert set(oo.tolist()) <= set(got.tolist())  # no false dismissal
    assert 9000 in got.tolist()


def test_sharded_query_matches_oracle(mesh, data):
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    icfg = IndexConfig()
    L, eps = 512, 6.0
    index, stack = build_index_sharded(data, mesh, icfg)
    engine = QueryEngine(data, index=index, icfg=icfg)
    q = data[21000:21000 + L]
    from kvmatch_tpu.engine.base import _Ctx, QueryStats
    ctx = _Ctx(query=q, length=L, epsilon=eps, eps2=eps * eps, params={},
               stats=QueryStats())
    segs = pack_segments(engine._plan(ctx), tuple(icfg.scales))

    n_sh = mesh.devices.size
    pad = (-data.size) % n_sh
    padded = np.concatenate([data, np.zeros(pad)]) if pad else data
    data_sh = jax.device_put(padded.astype(np.float32), NamedSharding(mesh, P("shard")))
    step = make_sharded_query_step(mesh, icfg, L, top_k=512)
    counts, idx, d2 = step(data_sh, stack, jnp.asarray(q, jnp.float32), segs,
                           jnp.float32(eps * eps), jnp.int32(data.size))
    counts = np.asarray(counts)       # (n_sh,) per-shard candidate counts
    assert counts.shape == (mesh.devices.size,)
    assert counts.max() <= 512, "workload overflows per-shard top-K"
    idx, d2 = np.asarray(idx).ravel(), np.asarray(d2).ravel()
    got = idx[d2 <= eps * eps * (1 + 1e-3)]
    oo, _ = oracle.rsm_ed(data, q, eps)
    assert set(oo.tolist()) <= set(got.tolist())
    # and nothing outside the exact answer set once confirmed in f64
    exact = [int(i) for i in got
             if np.sum((data[i:i + L] - q) ** 2) <= eps * eps]
    assert set(exact) == set(oo.tolist())


def test_batched_sharded_query(mesh, data):
    """Multi-query dense SPMD step: every query keeps its answers."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kvmatch_tpu.engine.base import _Ctx, QueryStats
    from kvmatch_tpu.parallel.build import build_index_sharded
    from kvmatch_tpu.parallel.query import (make_sharded_query_step_batched,
                                            pack_segments_batch)
    icfg = IndexConfig()
    L, eps = 512, 6.0
    index, stack = build_index_sharded(data, mesh, icfg)
    engine = QueryEngine(data, index=index, icfg=icfg)
    q_offs = [3000, 15000, 27000, 36000]
    queries = np.stack([data[o:o + L] for o in q_offs])
    seg_lists = []
    for qrow in queries:
        ctx = _Ctx(query=qrow, length=L, epsilon=eps, eps2=eps * eps, params={},
                   stats=QueryStats())
        seg_lists.append(engine._plan(ctx))
    segs = pack_segments_batch(seg_lists, tuple(icfg.scales))

    n_sh = mesh.devices.size
    pad = (-data.size) % n_sh
    padded = np.concatenate([data, np.zeros(pad)]) if pad else data
    data_sh = jax.device_put(padded.astype(np.float32), NamedSharding(mesh, P("shard")))
    step = make_sharded_query_step_batched(mesh, icfg, L, top_k=128)
    eps2 = jnp.full(len(q_offs), eps * eps, jnp.float32)
    totals, idx, d2 = step(data_sh, stack, jnp.asarray(queries, jnp.float32),
                           segs, eps2, jnp.int32(data.size))
    idx = np.asarray(idx)      # (n_sh, Q, K)
    d2 = np.asarray(d2)
    for qi, off in enumerate(q_offs):
        got = idx[:, qi, :][d2[:, qi, :] <= eps * eps * (1 + 1e-3)]
        oo, _ = oracle.rsm_ed(data, queries[qi], eps)
        assert set(oo.tolist()) <= set(got.tolist()), f"query {qi} lost answers"
        exact = [int(i) for i in set(got.tolist())
                 if np.sum((data[i:i + L] - queries[qi]) ** 2) <= eps * eps]
        assert set(exact) == set(oo.tolist())


def test_norm_device_batch_matches_host(data):
    """query_batch_device (dense device probe) == host query_batch, exactly."""
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu.index.build import build_index_numpy
    icfg = IndexConfig()
    engine = NormQueryEngine(data, index=build_index_numpy(data, icfg), icfg=icfg)
    L, eps, a, b = 512, 3.0, 1.3, 12.0
    q_offs = [2500, 14000, 30000]
    queries = np.stack([data[o:o + L] for o in q_offs])
    dev = engine.query_batch_device(queries, eps, alpha=a, beta=b, top_k=4096)
    host = engine.query_batch(queries, eps, alpha=a, beta=b)
    for qi, off in enumerate(q_offs):
        assert set(dev[qi].offsets.tolist()) == set(host[qi].offsets.tolist())
        assert off in dev[qi].offsets.tolist()


def test_rsm_device_batch_matches_host(data):
    from kvmatch_tpu.index.build import build_index_numpy
    icfg = IndexConfig()
    engine = QueryEngine(data, index=build_index_numpy(data, icfg), icfg=icfg)
    L, eps = 512, 6.0
    q_offs = [2000, 17000, 33000]
    queries = np.stack([data[o:o + L] for o in q_offs])
    dev = engine.query_batch_device(queries, eps, top_k=4096)
    host = engine.query_batch(queries, eps)
    for qi, off in enumerate(q_offs):
        assert set(dev[qi].offsets.tolist()) == set(host[qi].offsets.tolist())
        assert off in dev[qi].offsets.tolist()


def test_dtw_device_batch_matches_host(data):
    """The generic device-probe batched driver also serves the DTW engines."""
    from kvmatch_tpu.engine.rsm_dtw import QueryEngineDtw
    from kvmatch_tpu.index.build import build_index_numpy
    icfg = IndexConfig()
    engine = QueryEngineDtw(data, index=build_index_numpy(data, icfg), icfg=icfg)
    L, eps, rho = 256, 4.0, 12
    q_offs = [1800, 22000]
    queries = np.stack([data[o:o + L] for o in q_offs])
    dev = engine.query_batch_device(queries, eps, rho=rho)
    host = engine.query_batch(queries, eps, rho=rho)
    for qi, off in enumerate(q_offs):
        assert set(dev[qi].offsets.tolist()) == set(host[qi].offsets.tolist())
        assert off in dev[qi].offsets.tolist()

def test_sharded_norm_query_matches_oracle(mesh, data):
    """Sharded cNSM step: z-probe + std filter + z-verify per shard keeps the
    exact answer set (guard-banded f32 on device, f64 confirm on host)."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kvmatch_tpu.engine.base import _Ctx, QueryStats
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu.parallel.query import (
        make_sharded_query_step_norm_batched, pack_segments_batch)
    icfg = IndexConfig()
    L, eps, alpha, beta = 256, 2.0, 1.4, 5.0
    index, stack = build_index_sharded(data, mesh, icfg)
    engine = NormQueryEngine(data, index=index, icfg=icfg)
    q_offs = [5000, 18000, 31000]
    queries = np.stack([data[o:o + L] for o in q_offs])
    ctxs, seg_lists = [], []
    for qrow in queries:
        ctx = _Ctx(query=qrow, length=L, epsilon=eps, eps2=eps * eps,
                   params={"alpha": alpha, "beta": beta}, stats=QueryStats())
        seg_lists.append(engine._plan(ctx))
        ctxs.append(ctx)
    segs = pack_segments_batch(seg_lists, tuple(icfg.scales))
    cons = jnp.asarray([[c.params["alpha"], c.params["beta"],
                         c.params["_mu_q"], c.params["_sd_q"]] for c in ctxs],
                       jnp.float32)
    qhat = np.stack([(q - c.params["_mu_q"]) / c.params["_sd_q"]
                     for q, c in zip(queries, ctxs)])

    n_sh = mesh.devices.size
    pad = (-data.size) % n_sh
    padded = np.concatenate([data, np.zeros(pad)]) if pad else data
    data_sh = jax.device_put(padded.astype(np.float32),
                             NamedSharding(mesh, P("shard")))
    step = make_sharded_query_step_norm_batched(mesh, icfg, L, top_k=4096)
    eps2 = jnp.full(len(q_offs), eps * eps, jnp.float32)
    counts, idx, d2, mean, std = step(data_sh, stack,
                                      jnp.asarray(qhat, jnp.float32), segs,
                                      eps2, cons, jnp.int32(data.size))
    counts = np.asarray(counts)       # (n_sh, Q) per-shard candidate counts
    idx, d2 = np.asarray(idx), np.asarray(d2)
    assert counts.max() <= 4096, "workload overflows per-shard top-K"
    for qi in range(len(q_offs)):
        got = idx[:, qi, :][d2[:, qi, :] <= eps * eps * (1 + 1e-2) + 1e-3]
        oo, _ = oracle.nsm_ed(data, queries[qi], eps, alpha=alpha, beta=beta)
        assert set(oo.tolist()) <= set(got.tolist()), f"query {qi} lost answers"
        # f64 confirm: survivors that really satisfy distance + constraints
        exact = []
        mu_q = ctxs[qi].params["_mu_q"]; sd_q = ctxs[qi].params["_sd_q"]
        for i in set(int(v) for v in got.tolist()):
            x = data[i:i + L]
            mu, sd = x.mean(), x.std()
            if sd <= 0 or abs(mu - mu_q) > beta: continue
            if not (1 / alpha <= sd / sd_q <= alpha): continue
            if np.sum(((x - mu) / sd - (queries[qi] - mu_q) / sd_q) ** 2) <= eps * eps:
                exact.append(i)
        assert set(exact) == set(oo.tolist())


def test_sharded_dtw_query_matches_oracle(mesh, data):
    """Sharded RSM-DTW step: envelope probe + on-device banded DP per shard."""
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P
    from kvmatch_tpu.engine.base import _Ctx, QueryStats
    from kvmatch_tpu.engine.rsm_dtw import QueryEngineDtw
    from kvmatch_tpu.parallel.query import (
        make_sharded_query_step_dtw_batched, pack_segments_batch)
    icfg = IndexConfig()
    L, eps, rho = 256, 4.0, 12
    index, stack = build_index_sharded(data, mesh, icfg)
    engine = QueryEngineDtw(data, index=index, icfg=icfg)
    q_offs = [8000, 24000]
    queries = np.stack([data[o:o + L] for o in q_offs])
    seg_lists = []
    for qrow in queries:
        ctx = _Ctx(query=qrow, length=L, epsilon=eps, eps2=eps * eps,
                   params={"rho": rho}, stats=QueryStats())
        seg_lists.append(engine._plan(ctx))
    segs = pack_segments_batch(seg_lists, tuple(icfg.scales))

    n_sh = mesh.devices.size
    pad = (-data.size) % n_sh
    padded = np.concatenate([data, np.zeros(pad)]) if pad else data
    data_sh = jax.device_put(padded.astype(np.float32),
                             NamedSharding(mesh, P("shard")))
    step = make_sharded_query_step_dtw_batched(mesh, icfg, L, rho, top_k=2048)
    eps2 = jnp.full(len(q_offs), eps * eps, jnp.float32)
    counts, idx, d2 = step(data_sh, stack, jnp.asarray(queries, jnp.float32),
                           segs, eps2, jnp.int32(data.size))
    counts = np.asarray(counts)       # (n_sh, Q) per-shard candidate counts
    idx, d2 = np.asarray(idx), np.asarray(d2)
    assert counts.max() <= 2048, "workload overflows per-shard top-K"
    from kvmatch_tpu.ops.dtw import dtw_banded_batch_f64
    for qi in range(len(q_offs)):
        got = idx[:, qi, :][d2[:, qi, :] <= eps * eps * (1 + 1e-2) + 1e-3]
        oo, _ = oracle.rsm_dtw(data, queries[qi], eps, rho)
        assert set(oo.tolist()) <= set(got.tolist()), f"query {qi} lost answers"
        cand = np.asarray(sorted(set(int(v) for v in got.tolist())), np.int64)
        if cand.size:
            w = data[cand[:, None] + np.arange(L)[None, :]]
            dh = dtw_banded_batch_f64(w, queries[qi], rho)
            exact = cand[dh <= eps * eps]
        else:
            exact = np.empty(0, np.int64)
        assert set(exact.tolist()) == set(oo.tolist())


def test_blocked_probe_multi_block_matches_host(data, monkeypatch):
    """Force the blocked dense probe into many position blocks (nb > 1) and
    assert the running top-K merge still yields the host phase-1 answer sets."""
    import kvmatch_tpu.parallel.query as pq
    monkeypatch.setattr(pq, "PROBE_BLOCK_MAX", 4096)
    monkeypatch.setattr(pq, "PROBE_BLOCK_MIN", 4096)
    from kvmatch_tpu.index.build import build_index_numpy
    icfg = IndexConfig()
    engine = QueryEngine(data, index=build_index_numpy(data, icfg), icfg=icfg)
    assert pq.probe_block_for(data.size, 3) == 4096  # ~10 blocks at n=40k
    L, eps = 512, 6.0
    q_offs = [2000, 17000, 33000]
    queries = np.stack([data[o:o + L] for o in q_offs])
    dev = engine.query_batch_device(queries, eps, top_k=4096)
    host = engine.query_batch(queries, eps)
    for qi, off in enumerate(q_offs):
        assert set(dev[qi].offsets.tolist()) == set(host[qi].offsets.tolist())
        assert off in dev[qi].offsets.tolist()

    # norm probe through the same blocked path
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    neng = NormQueryEngine(data, index=engine.index, icfg=icfg)
    ndev = neng.query_batch_device(queries, 3.0, alpha=1.3, beta=12.0,
                                   top_k=4096)
    nhost = neng.query_batch(queries, 3.0, alpha=1.3, beta=12.0)
    for qi in range(len(q_offs)):
        assert set(ndev[qi].offsets.tolist()) == set(nhost[qi].offsets.tolist())
