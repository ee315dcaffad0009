"""Fly-probe memory-budget regressions (a Q=128 probe program once compiled
past device memory): trace-time shape math bounding the probe program's working
set, plus the DENSE_PROBE_GROUP sub-batching of query_batch_device.  Fast lane
— these must run before every commit."""

import numpy as np
import pytest

from kvmatch_tpu.config import IndexConfig, QueryConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.rsm_ed import QueryEngine
from kvmatch_tpu.index.build import build_index_numpy


def test_probe_working_set_budget_q128():
    """At the bench shape (Q=128 batch, n=1e8) the fly-probe program's
    estimated working set — PROBE_TEMP_COUNT live (group, block) f32 temps
    plus both (group, K+1) i32 run buffers — must stay under 75% of a 16 GB
    device (the CPU stand-in).  Pure shape math; no device needed."""
    from kvmatch_tpu.engine.base import BaseEngine
    from kvmatch_tpu.parallel import query as pq
    hbm = pq.CPU_DEVICE_MEM_BYTES
    n = 100_000_000
    for Q in (128, 64, 32, 8, 1):
        group = min(Q, BaseEngine.DENSE_PROBE_GROUP)
        blk = pq.probe_block_for(n, group)
        cand_k = max(BaseEngine.DENSE_PROBE_K,
                     min(1 << 25, BaseEngine.DENSE_PROBE_K_BUDGET // group))
        temps = pq.PROBE_TEMP_COUNT * 4 * group * blk
        run_buffers = 2 * 4 * group * (cand_k + 1)
        assert temps + run_buffers < 0.75 * hbm, (
            f"Q={Q}: temps={temps/1e9:.1f}GB + runs={run_buffers/1e9:.1f}GB")


def test_probe_budget_is_width_aware():
    """probe_mem_budget must divide detected memory by the live-temp count,
    not budget a single accumulator (the round-3 bug)."""
    from kvmatch_tpu.parallel import query as pq
    per_temp_bytes = pq.probe_mem_budget() * 4
    assert (per_temp_bytes * pq.PROBE_TEMP_COUNT
            <= pq._device_mem_bytes() * pq.PROBE_HBM_FRACTION
            + pq.PROBE_BLOCK_MIN * 4 * pq.PROBE_TEMP_COUNT)


@pytest.fixture(scope="module")
def setup():
    data = generate_series(50_000, seed=23)
    return data, build_index_numpy(data, IndexConfig())


def test_query_batch_device_subbatches(setup, monkeypatch):
    """query_batch_device must probe in DENSE_PROBE_GROUP-query programs, not
    one full-batch program (the out-of-memory path, engine/base.py), and the
    sub-batched results must still match the host route exactly."""
    from kvmatch_tpu.engine import base as eb
    data, idx = setup
    monkeypatch.setattr(eb.BaseEngine, "DENSE_PROBE_GROUP", 2)
    seen_sizes = []
    orig = eb.BaseEngine._dense_probe_retry

    def spy(self, ctxs, seg_lists):
        seen_sizes.append(len(ctxs))
        return orig(self, ctxs, seg_lists)

    monkeypatch.setattr(eb.BaseEngine, "_dense_probe_retry", spy)
    L = 512
    offs = [1000, 9000, 17000, 25000, 40000]
    queries = np.stack([data[o:o + L] for o in offs])
    eh = QueryEngine(data, index=idx, icfg=IndexConfig(),
                     qcfg=QueryConfig(dense_probe_min_count=None))
    ed = QueryEngine(data, index=idx, icfg=IndexConfig(),
                     qcfg=QueryConfig(dense_probe_min_count=0))
    rd = ed.query_batch_device(queries, 6.0)
    rh = eh.query_batch(queries, 6.0)
    assert seen_sizes and max(seen_sizes) <= 2
    assert sum(seen_sizes) >= len(offs)
    for o, a, b in zip(offs, rh, rd):
        assert set(a.offsets.tolist()) == set(b.offsets.tolist())
        assert o in b.offsets.tolist()
