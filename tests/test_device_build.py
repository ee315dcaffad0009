"""Device-side index build (index/device_build.py) vs its NumPy twin and the
engines: grouping pipeline equality, lazy host materialization, and answer
parity with a host-built index."""

import numpy as np
import pytest

from kvmatch_tpu.config import IndexConfig, QueryConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.index import device_build as db
from kvmatch_tpu.index.build import build_index_numpy

N = 60_000


@pytest.fixture(scope="module")
def data():
    return generate_series(N, seed=31)


def test_pipeline_matches_numpy_twin(data):
    import jax.numpy as jnp
    from kvmatch_tpu.ops.sliding import build_buckets

    cfg = IndexConfig()
    cap = cfg.maximum_diff - 1
    buckets = build_buckets(jnp.asarray(data, jnp.float32),
                            tuple(cfg.scales), cfg.pos_of_d)
    for w in cfg.scales:
        b = np.asarray(buckets[w])
        lo = int(b.min()) - 1
        m = b.size
        a = db._pipeline_a_jit()(jnp.asarray(b), jnp.int32(lo), jnp.int32(m),
                                 cap)
        ma = [np.asarray(x) for x in a[:6]]
        n_rows = int(ma[1])
        # host merge over the pulled metadata (the same path build uses)
        counts = ma[3][:n_rows].astype(np.int64)
        row_offs = ma[4][:n_rows].astype(np.int64)
        joins = ma[5].reshape(db.GMAX, db.DMAX)[:n_rows]
        grp, n_groups = db._merge_scan(counts, row_offs, joins,
                                       cfg.merge_count_factor,
                                       cfg.merge_shrink_factor, cap)
        row_bucket = ma[2][:n_rows].astype(np.int64)
        gb = row_bucket[np.concatenate(([True], grp[1:] != grp[:-1]))]
        pad = np.zeros(db.GMAX, np.int32)
        pad[:n_rows] = grp
        out = db._pipeline_b_jit()(a[6], a[7], a[8], a[0], jnp.asarray(pad),
                                   cap)
        np_pieces = int(out[0])
        p_l = np.asarray(out[1])[:np_pieces]
        p_r = np.asarray(out[2])[:np_pieces]
        p_row = np.asarray(out[3])[:np_pieces]
        g_iv = np.asarray(out[4])[:n_groups]
        g_off = np.asarray(out[5])[:n_groups]

        tl, tr, trow, tgb, tg_iv, tg_off = db._numpy_twin_scale(
            b, cap, cfg.merge_count_factor, cfg.merge_shrink_factor)
        assert np_pieces == tl.size and n_groups == tgb.size, w
        assert np.array_equal(p_l, tl), w
        assert np.array_equal(p_r, tr), w
        assert np.array_equal(p_row, trow), w
        assert np.array_equal(gb, tgb), w
        assert np.array_equal(g_iv, tg_iv), w
        assert np.array_equal(g_off, tg_off), w
        # intervals tile the valid position space exactly once
        assert int((p_r - p_l + 1).sum()) == m
        assert (p_r - p_l + 1).max() <= cap


def test_device_index_lazy_materialization(data):
    idx = db.build_index_device(data)
    for w, sc in idx.items():
        assert sc.dev_pos_view is not None
        assert sc._left is None            # not pulled yet
        assert sc.num_intervals == int(sc.row_ptr[-1])
        _ = sc.memory_bytes()              # must not trigger D2H
        assert sc._left is None
        left = sc.left                     # first access materializes
        assert left is not None and sc._left is not None
        assert left.size == sc.num_intervals
        # CSR consistency: per-row interval lists are position-sorted and the
        # row_ptr from device stats matches the counting-sorted layout
        for r in (0, sc.num_rows // 2, sc.num_rows - 1):
            l_r, r_r = sc.row_slice(r)
            assert np.all(np.diff(l_r) > 0) if l_r.size > 1 else True
            assert np.all(l_r <= r_r)
        # pos-sorted view equals the device view and tiles positions
        p_l, p_r, p_row = sc.pos_sorted()
        assert np.all(np.diff(p_l) > 0)
        assert int((p_r - p_l + 1).sum()) == sc.n - w + 1


@pytest.mark.parametrize("engine,params", [
    ("rsm_ed", {}),
    ("rsm_dtw", {"rho": 25}),
    ("norm_ed", {"alpha": 1.3, "beta": 8.0}),
    ("norm_dtw", {"alpha": 1.3, "beta": 8.0, "rho": 25}),
])
def test_engine_parity_device_vs_host_index(data, engine, params):
    from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu.engine.rsm_dtw import QueryEngineDtw
    from kvmatch_tpu.engine.rsm_ed import QueryEngine

    cls = {"rsm_ed": QueryEngine, "rsm_dtw": QueryEngineDtw,
           "norm_ed": NormQueryEngine, "norm_dtw": NormQueryEngineDtw}[engine]
    icfg = IndexConfig()
    host_idx = build_index_numpy(data, icfg)
    dev_idx = db.build_index_device(data, icfg)
    eh = cls(data, index=host_idx, icfg=icfg, qcfg=QueryConfig())
    ed = cls(data, index=dev_idx, icfg=icfg, qcfg=QueryConfig())
    off, L, eps = 12000, 512, 4.0
    q = data[off:off + L]
    rh = eh.query(q, eps, **params)
    rd = ed.query(q, eps, **params)
    assert set(rh.offsets.tolist()) == set(rd.offsets.tolist())
    assert off in rd.offsets.tolist()

def test_spill_mode_identical_index(data):
    """Spill-to-host build (large-n path) must produce byte-identical index
    content to the device-resident build."""
    keep = db.build_index_device(data)
    spill = db.build_index_device(data, spill_threshold=1)
    for w in keep:
        a, b = keep[w], spill[w]
        assert b.dev_pos_view is None and b._left is not None
        assert np.array_equal(a.keys, b.keys), w
        assert np.array_equal(a.row_ptr, b.row_ptr), w
        assert np.array_equal(a.left, b.left), w
        assert np.array_equal(a.right, b.right), w
        pa, pb = a.pos_sorted(), b.pos_sorted()
        for x, y in zip(pa, pb):
            assert np.array_equal(x, y), w


def test_stats_only_build_exact_histograms(data):
    """Serving-mode build: per-bucket offset/interval stats must equal a
    direct NumPy histogram with the cap-RLE interval counting."""
    import jax.numpy as jnp
    from kvmatch_tpu.ops.sliding import build_buckets

    cfg = IndexConfig()
    cap = cfg.maximum_diff - 1
    st = {}
    index = db.build_index_device_stats(data, cfg, stats=st)
    assert st["mpts_per_second"] > 0
    buckets = build_buckets(jnp.asarray(data, jnp.float32),
                            tuple(cfg.scales), cfg.pos_of_d)
    from kvmatch_tpu.utils import rounding
    for w, sc in index.items():
        assert sc.stats_only
        b = np.asarray(buckets[w]).astype(np.int64)
        ub, counts = np.unique(b, return_counts=True)
        np.testing.assert_allclose(sc.keys,
                                   rounding.bucket_to_key(ub, cfg.pos_of_d))
        np.testing.assert_array_equal(np.diff(sc.cum_offsets,
                                              prepend=0), counts)
        # capped interval counts: RLE runs split at cap
        pos = np.arange(b.size)
        change = np.concatenate(([True], b[1:] != b[:-1]))
        run_start = np.maximum.accumulate(np.where(change, pos, -1))
        start = change | ((pos - run_start) % cap == 0)
        iv_counts = np.zeros(ub.size, np.int64)
        np.add.at(iv_counts, np.searchsorted(ub, b[start]), 1)
        np.testing.assert_array_equal(np.diff(sc.cum_intervals, prepend=0),
                                      iv_counts)
        with pytest.raises(RuntimeError, match="stats-only"):
            _ = sc.left


def test_stats_only_index_serves_fly_route_exactly(data):
    """cNSM engine over a stats-only index (device dense-probe phase 1) must
    return the exact answer set."""
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu.oracle import nsm_ed

    cfg = IndexConfig()
    index = db.build_index_device_stats(data, cfg)
    qcfg = QueryConfig.tuned(dense_probe_min_count=0)
    eng = NormQueryEngine(data, index=index, icfg=cfg, qcfg=qcfg)
    rng = np.random.default_rng(5)
    for o in rng.integers(0, N - 512, 3):
        q = data[o:o + 512]
        res = eng.query(q, 5.0, alpha=1.3, beta=8.0)
        ref_o, _ = nsm_ed(data, q, 5.0, alpha=1.3, beta=8.0)
        assert sorted(res.offsets.tolist()) == sorted(ref_o.tolist())
