"""IndexConfig invariants: the planner DP maps wu_list position k-1 to segment
width unit*k (QueryEngine.java:464-474 iterates Wu multiples of WuList[0]), so
the list must be a dense unit ladder with an enabled mask — a sparse list used
to yield silently empty query plans (fixed alongside scripts/big_demo.py)."""

import numpy as np
import pytest

from kvmatch_tpu.config import IndexConfig, QueryConfig


def test_default_config_valid():
    icfg = IndexConfig()
    assert icfg.unit == 25
    assert icfg.scales == (25, 50, 100, 200, 400)


def test_scale_subset_ladder_plans():
    # The big-demo scale subset {100, 400} in its valid ladder form must
    # produce a non-empty plan (this exact shape regressed to zero segments).
    from kvmatch_tpu.data.generators import generate_series
    from kvmatch_tpu.engine.rsm_ed import QueryEngine
    from kvmatch_tpu.index.build import build_index_tpu

    icfg = IndexConfig(wu_list=(100, 200, 300, 400),
                       wu_enabled=(True, False, False, True), pos_of_d=1)
    data = generate_series(200_000, seed=3)
    index = build_index_tpu(data, icfg, backend="host")
    eng = QueryEngine(data, index=index, icfg=icfg,
                      qcfg=QueryConfig.tuned())
    res = eng.query_at(54_321, 8192, 10.0)
    assert res.found and int(res.offsets[0]) == 54_321
    assert res.stats.n_segments_used >= 1


def test_sparse_wu_list_rejected():
    with pytest.raises(ValueError, match="consecutive multiples"):
        IndexConfig(wu_list=(100, 200, 400), wu_enabled=(True, False, True))


def test_disabled_unit_rejected():
    with pytest.raises(ValueError, match="unit scale"):
        IndexConfig(wu_list=(25, 50), wu_enabled=(False, True))


def test_length_mismatch_rejected():
    with pytest.raises(ValueError, match="lengths differ"):
        IndexConfig(wu_list=(25, 50), wu_enabled=(True,))
