"""Answer-set parity: RSM-ED engine vs the float64 brute-force oracle."""

import numpy as np
import pytest

from kvmatch_tpu import oracle
from kvmatch_tpu.config import IndexConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.rsm_ed import QueryEngine
from kvmatch_tpu.index.build import build_index_tpu

N = 60_000


@pytest.fixture(scope="module")
def setup():
    data = generate_series(N, seed=7)
    icfg = IndexConfig()
    index = build_index_tpu(data, icfg)
    engine = QueryEngine(data, index=index, icfg=icfg)
    return data, engine


def _check(engine, data, offset, length, epsilon):
    res = engine.query_at(offset, length, epsilon)
    oo, od = oracle.rsm_ed(data, data[offset:offset + length], epsilon)
    got = dict(zip(res.offsets.tolist(), res.distances.tolist()))
    want = dict(zip(oo.tolist(), od.tolist()))
    assert set(got) == set(want), (
        f"offset={offset} L={length} eps={epsilon}: "
        f"missing={sorted(set(want) - set(got))[:5]} extra={sorted(set(got) - set(want))[:5]}")
    for k in want:
        assert got[k] == pytest.approx(want[k], abs=1e-9)
    assert offset in got and got[offset] == pytest.approx(0.0, abs=1e-9)


@pytest.mark.parametrize("offset,length,epsilon", [
    (123, 400, 5.0),
    (1234, 1600, 10.0),
    (30000, 4096, 20.0),
    (7777, 800, 1.0),
    (50, 25, 0.5),
])
def test_self_query_parity(setup, offset, length, epsilon):
    data, engine = setup
    _check(engine, data, offset, length, epsilon)


def test_random_queries_parity(setup):
    data, engine = setup
    rng = np.random.default_rng(3)
    for _ in range(8):
        length = int(rng.choice([100, 250, 775, 1525, 3000]))
        offset = int(rng.integers(0, N - length))
        epsilon = float(rng.choice([0.5, 3.0, 15.0, 40.0]))
        _check(engine, data, offset, length, epsilon)


def test_noise_query_no_false_dismissal(setup):
    """Query not cut from the data: engine must still match the oracle exactly."""
    data, engine = setup
    rng = np.random.default_rng(11)
    q = data[5000:5000 + 512] + rng.normal(0, 0.05, 512)
    for eps in (1.0, 2.0, 8.0):
        res = engine.query(q, eps)
        oo, _ = oracle.rsm_ed(data, q, eps)
        assert set(res.offsets.tolist()) == set(oo.tolist())


def test_stats_populated(setup):
    data, engine = setup
    res = engine.query_at(2000, 800, 5.0)
    s = res.stats
    assert s.n_answers >= 1
    assert s.n_candidates >= s.n_answers
    assert s.n_scans >= 1 and s.n_segments_used >= 1
    assert s.t_total_ms > 0


@pytest.mark.parametrize("length", [25, 113, 1037])
def test_non_multiple_lengths(setup, length):
    """L = 25 exactly and L not a multiple of the unit window: the DP covers
    floor(L/25) units, phase 2 verifies the full L (reference semantics)."""
    data, engine = setup
    offset = 4321
    _check(engine, data, offset, length, 3.0)


def test_tuned_config_same_answers():
    """The device-fitted cost model changes only WHEN phase 1 stops, never the
    answer set (phase 2 verifies whatever phase 1 hands it)."""
    import numpy as np
    from kvmatch_tpu.config import IndexConfig, QueryConfig
    from kvmatch_tpu.data.generators import generate_series
    from kvmatch_tpu.engine.rsm_ed import QueryEngine
    from kvmatch_tpu.index.build import build_index_numpy

    data = generate_series(50_000, seed=9)
    icfg = IndexConfig()
    index = build_index_numpy(data, icfg)
    e1 = QueryEngine(data, index=index, icfg=icfg)
    e2 = QueryEngine(data, index=index, icfg=icfg, qcfg=QueryConfig.tuned())
    for off, L, eps in [(4000, 512, 6.0), (30000, 1024, 10.0)]:
        r1 = e1.query_at(off, L, eps)
        r2 = e2.query_at(off, L, eps)
        assert set(r1.offsets.tolist()) == set(r2.offsets.tolist())
        assert off in r2.offsets.tolist()


def test_host_verify_route_matches_device_route():
    """Tiny phase-2 loads route to the exact f64 host kernel (no device
    launch); the answer set must equal the device route's bit-for-bit, and the
    route flag must show in the stats."""
    import numpy as np
    from kvmatch_tpu.config import IndexConfig, QueryConfig
    from kvmatch_tpu.data.generators import generate_series
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu.engine.rsm_ed import QueryEngine
    from kvmatch_tpu.index.build import build_index_numpy

    data = generate_series(60_000, seed=11)
    icfg = IndexConfig()
    index = build_index_numpy(data, icfg)
    host = QueryEngine(data, index=index, icfg=icfg,
                       qcfg=QueryConfig(host_verify_max_points=1 << 62))
    dev = QueryEngine(data, index=index, icfg=icfg,
                      qcfg=QueryConfig(host_verify_max_points=0))
    for off, L, eps in [(4000, 512, 6.0), (30000, 1024, 10.0)]:
        rh = host.query_at(off, L, eps)
        rd = dev.query_at(off, L, eps)
        assert rh.stats.n_host_checked > 0
        assert rd.stats.n_host_checked == 0
        assert rh.offsets.tolist() == rd.offsets.tolist()
        assert np.allclose(rh.distances, rd.distances)
        assert off in rh.offsets.tolist()

    nhost = NormQueryEngine(data, index=index, icfg=icfg,
                            qcfg=QueryConfig(host_verify_max_points=1 << 62))
    ndev = NormQueryEngine(data, index=index, icfg=icfg,
                           qcfg=QueryConfig(host_verify_max_points=0))
    q = data[7000:7000 + 512]
    rh = nhost.query(q, 3.0, alpha=1.3, beta=10.0)
    rd = ndev.query(q, 3.0, alpha=1.3, beta=10.0)
    assert rh.stats.n_host_checked > 0 and rd.stats.n_host_checked == 0
    assert rh.offsets.tolist() == rd.offsets.tolist()
    assert np.allclose(rh.distances, rd.distances)
