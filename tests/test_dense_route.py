"""Dense-on-device phase 1 (fly probe) vs host phase 1: identical answers.

The fly probe recomputes bucket ids from the f32 series per position block and
collects candidates by ordered compaction; forcing the route (cutoff=0) on
small CPU fixtures exercises it end-to-end for all four engines."""

import dataclasses

import numpy as np
import pytest

from kvmatch_tpu.config import IndexConfig, QueryConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw
from kvmatch_tpu.engine.norm_ed import NormQueryEngine
from kvmatch_tpu.engine.rsm_dtw import QueryEngineDtw
from kvmatch_tpu.engine.rsm_ed import QueryEngine
from kvmatch_tpu.index.build import build_index_numpy

pytestmark = pytest.mark.slow  # multi-minute XLA-compile-heavy; quick lane skips


N = 50_000


@pytest.fixture(scope="module")
def setup():
    data = generate_series(N, seed=23)
    return data, build_index_numpy(data, IndexConfig())


CASES = [
    (QueryEngine, {}, [(2000, 512, 5.0), (31000, 1024, 9.0)]),
    (QueryEngineDtw, {"rho": 25}, [(2000, 512, 5.0)]),
    (NormQueryEngine, {"alpha": 1.3, "beta": 8.0}, [(7000, 512, 4.0)]),
    (NormQueryEngineDtw, {"alpha": 1.3, "beta": 8.0, "rho": 25},
     [(7000, 512, 3.0)]),
]


@pytest.mark.parametrize("cls,params,cases", CASES)
def test_dense_route_matches_host(setup, cls, params, cases):
    data, idx = setup
    host_cfg = QueryConfig(dense_probe_min_count=None)
    dense_cfg = QueryConfig(dense_probe_min_count=0)
    eh = cls(data, index=idx, icfg=IndexConfig(), qcfg=host_cfg)
    ed = cls(data, index=idx, icfg=IndexConfig(), qcfg=dense_cfg)
    for off, L, eps in cases:
        q = data[off:off + L]
        rh = eh.query(q, eps, **params)
        rd = ed.query(q, eps, **params)
        assert set(rh.offsets.tolist()) == set(rd.offsets.tolist())
        assert off in rd.offsets.tolist()


def test_dense_route_batch_matches_host(setup):
    data, idx = setup
    L = 512
    offs = [1000, 9000, 25000, 40000]
    queries = np.stack([data[o:o + L] for o in offs])
    eh = QueryEngine(data, index=idx, icfg=IndexConfig(),
                     qcfg=QueryConfig(dense_probe_min_count=None))
    ed = QueryEngine(data, index=idx, icfg=IndexConfig(),
                     qcfg=QueryConfig(dense_probe_min_count=0))
    rh = eh.query_batch(queries, 6.0)
    rd = ed.query_batch(queries, 6.0)
    for o, a, b in zip(offs, rh, rd):
        assert set(a.offsets.tolist()) == set(b.offsets.tolist())
        assert o in b.offsets.tolist()


def test_fly_runs_cross_block_boundaries(setup, monkeypatch):
    """Run-compressed candidates must stitch correctly across position blocks:
    force tiny blocks so candidate runs straddle block boundaries."""
    from kvmatch_tpu.parallel import query as pq
    data, idx = setup
    monkeypatch.setattr(pq, "PROBE_BLOCK_MAX", 4096)
    monkeypatch.setattr(pq, "PROBE_BLOCK_MIN", 4096)
    L = 512
    eh = QueryEngine(data, index=idx, icfg=IndexConfig(),
                     qcfg=QueryConfig(dense_probe_min_count=None))
    ed = QueryEngine(data, index=idx, icfg=IndexConfig(),
                     qcfg=QueryConfig(dense_probe_min_count=0))
    for off, eps in [(2000, 8.0), (31000, 12.0)]:  # loose eps -> long runs
        q = data[off:off + L]
        rh = eh.query(q, eps)
        rd = ed.query(q, eps)
        assert set(rh.offsets.tolist()) == set(rd.offsets.tolist())
        assert off in rd.offsets.tolist()
        # run compression is exact: total offsets == sum of run lengths
        # (tiny loads route to the exact host kernel, so count both sides)
        assert rd.stats.n_candidates == (rd.stats.n_device_checked
                                         + rd.stats.n_host_checked)

def test_gap_coalescing_overflow_recovery(setup, monkeypatch):
    """Force a tiny run buffer so the gap=1 probe overflows: the retry
    schedule must coalesce runs (gap=unit, ...) and still produce the exact
    answer set (interior gap positions are over-coverage phase 2 rejects)."""
    from kvmatch_tpu.engine import base as eb
    data, idx = setup
    monkeypatch.setattr(eb.BaseEngine, "DENSE_PROBE_K", 64)
    monkeypatch.setattr(eb.BaseEngine, "DENSE_PROBE_K_BUDGET", 64)
    eh = QueryEngine(data, index=idx, icfg=IndexConfig(),
                     qcfg=QueryConfig(dense_probe_min_count=None))
    ed = QueryEngine(data, index=idx, icfg=IndexConfig(),
                     qcfg=QueryConfig(dense_probe_min_count=0))
    for off, eps in [(2000, 10.0), (31000, 12.0)]:  # loose eps -> many runs
        q = data[off:off + 512]
        rh = eh.query(q, eps)
        rd = ed.query(q, eps)
        assert set(rh.offsets.tolist()) == set(rd.offsets.tolist())
        assert off in rd.offsets.tolist()


def test_gap_probe_intervals_cover_exact(setup):
    """Direct probe-level property: for gap g, emitted intervals (a) have true
    candidate positions as edges, (b) cover every gap=1 candidate, and (c)
    only bridge interior gaps < g."""
    import jax.numpy as jnp
    from kvmatch_tpu.engine.base import _Ctx
    from kvmatch_tpu.engine.base import QueryStats
    data, idx = setup
    eng = QueryEngine(data, index=idx, icfg=IndexConfig(),
                      qcfg=QueryConfig(dense_probe_min_count=0))
    q = data[2000:2512]
    ctx = _Ctx(query=q, length=512, epsilon=10.0, eps2=100.0, params={},
               stats=QueryStats())
    segs = eng._plan(ctx)
    n1, r1, l1_, rr1, _ = eng._device_dense_phase1([ctx], [segs], gap=1)
    ng, rg, lg_, rrg, _ = eng._device_dense_phase1([ctx], [segs], gap=100)
    assert n1[0] == ng[0]                     # candidate count is gap-invariant
    assert rg[0] <= r1[0]
    k1, kg = int(r1[0]), int(rg[0])
    iv1 = list(zip(l1_[0][:k1].tolist(), rr1[0][:k1].tolist()))
    ivg = list(zip(lg_[0][:kg].tolist(), rrg[0][:kg].tolist()))
    exact_edges = {x for l, r in iv1 for x in (l, r)}
    for l, r in ivg:
        assert l in exact_edges and r in exact_edges     # (a)
    covered = [(l, r) for l, r in ivg]
    for l, r in iv1:
        assert any(cl <= l and r <= cr for cl, cr in covered)   # (b)
    # (c): consecutive coalesced intervals are separated by >= gap
    for (l0, r0), (l1b, _) in zip(ivg, ivg[1:]):
        assert l1b - r0 > 100

def test_flags_probe_matches_run_probe(setup):
    """The flag probe's bitmap must flag exactly the FLAG_BLOCK-blocks that
    hold at least one gap=1 candidate, with exact candidate counts."""
    from kvmatch_tpu.engine.base import _Ctx, QueryStats
    data, idx = setup
    eng = QueryEngine(data, index=idx, icfg=IndexConfig(),
                      qcfg=QueryConfig(dense_probe_min_count=0))
    q = data[2000:2512]
    ctx = _Ctx(query=q, length=512, epsilon=10.0, eps2=100.0, params={},
               stats=QueryStats())
    segs = eng._plan(ctx)
    n1, r1, l1_, rr1, _ = eng._device_dense_phase1([ctx], [segs], gap=1)
    nf, flags, F = eng._device_dense_phase1_flags([ctx], [segs])
    assert int(nf[0]) == int(n1[0]) > 0
    k = int(r1[0])
    expected = np.zeros(flags.shape[1], bool)
    for l, r in zip(l1_[0][:k].tolist(), rr1[0][:k].tolist()):
        expected[l // F: r // F + 1] = True
    assert np.array_equal(flags[0], expected)
    # interval expansion covers every candidate run and stays in range
    m = N - 512 + 1
    fl, fr = eng._flags_to_intervals(flags[0], m, F)
    assert np.all(fr < m) and np.all(fl >= 0) and np.all(fl <= fr)
    for l, r in zip(l1_[0][:k].tolist(), rr1[0][:k].tolist()):
        assert np.any((fl <= l) & (r <= fr))


def test_flags_emit_route_exact_answers(setup):
    """dense_probe_emit='flags' — the GPU-default emission that skips the run
    ladder entirely — must return the exact answer set for both engine
    families (over-coverage is rejected by the exact phase 2)."""
    data, idx = setup
    for cls, params, (off, L, eps) in [
            (QueryEngine, {}, (2000, 512, 10.0)),
            (NormQueryEngine, {"alpha": 1.3, "beta": 8.0}, (7000, 512, 4.0))]:
        eh = cls(data, index=idx, icfg=IndexConfig(),
                 qcfg=QueryConfig(dense_probe_min_count=None))
        ef = cls(data, index=idx, icfg=IndexConfig(),
                 qcfg=QueryConfig(dense_probe_min_count=0,
                                  dense_probe_emit="flags"))
        q = data[off:off + L]
        rh = eh.query(q, eps, **params)
        rf = ef.query(q, eps, **params)
        assert set(rh.offsets.tolist()) == set(rf.offsets.tolist())
        assert off in rf.offsets.tolist()


def test_flags_fallback_exact_answers(setup, monkeypatch):
    """With a 1-run buffer both gap stages overflow, so the engine must take
    the flag probe and still return the exact answer set."""
    from kvmatch_tpu.engine import base as eb
    data, idx = setup
    monkeypatch.setattr(eb.BaseEngine, "DENSE_PROBE_K", 1)
    monkeypatch.setattr(eb.BaseEngine, "DENSE_PROBE_K_BUDGET", 1)
    for cls, params, (off, L, eps) in [
            (QueryEngine, {}, (2000, 512, 10.0)),
            (NormQueryEngine, {"alpha": 1.3, "beta": 8.0}, (7000, 512, 4.0))]:
        eh = cls(data, index=idx, icfg=IndexConfig(),
                 qcfg=QueryConfig(dense_probe_min_count=None))
        ed = cls(data, index=idx, icfg=IndexConfig(),
                 qcfg=QueryConfig(dense_probe_min_count=0))
        q = data[off:off + L]
        rh = eh.query(q, eps, **params)
        rd = ed.query(q, eps, **params)
        assert set(rh.offsets.tolist()) == set(rd.offsets.tolist())
        assert off in rd.offsets.tolist()
