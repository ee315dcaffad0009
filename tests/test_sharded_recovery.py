"""Sharded cNSM-DTW step + top-K overflow recovery policy.

Covers the fourth sharded engine variant (NormQueryEngineDtw.java:44) and the
overflow recovery (detecting overflow is not enough): answer-set parity against a float64 NumPy oracle, plus the
documented escalate-K / host-fallback recovery ladder.
"""

import numpy as np
import pytest

import jax
import jax.numpy as jnp
from jax.sharding import NamedSharding, PartitionSpec as P

from kvmatch_tpu.config import IndexConfig, QueryConfig
from kvmatch_tpu.data.generators import generate_series
from kvmatch_tpu.engine.base import QueryStats, _Ctx
from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw
from kvmatch_tpu.ops.dtw import dtw_banded_batch_f64
from kvmatch_tpu.parallel.build import build_index_sharded
from kvmatch_tpu.parallel.mesh import AXIS, make_mesh
from kvmatch_tpu.parallel.query import (
    make_sharded_query_step_norm_dtw_batched, pack_segments_batch,
    run_sharded_step_with_recovery)

N = 8 * 2048
LENGTH = 256
RHO = 10
ALPHA, BETA, EPS = 1.5, 8.0, 2.0


@pytest.fixture(scope="module")
def setup():
    icfg = IndexConfig()
    data = generate_series(N, seed=11)
    mesh = make_mesh(jax.devices()[:8])
    index, stack = build_index_sharded(data, mesh, icfg)
    data_sh = jax.device_put(data.astype(np.float32),
                             NamedSharding(mesh, P(AXIS)))

    eng = NormQueryEngineDtw.__new__(NormQueryEngineDtw)
    eng.data, eng.n, eng.icfg, eng.index = data, data.size, icfg, index
    eng.qcfg = QueryConfig()
    q_offs = [N // 4, N // 2]
    queries = np.stack([data[o:o + LENGTH] for o in q_offs])
    ctxs, seg_lists = [], []
    for qrow in queries:
        c = _Ctx(query=qrow, length=LENGTH, epsilon=EPS, eps2=EPS * EPS,
                 params={"alpha": ALPHA, "beta": BETA, "rho": RHO},
                 stats=QueryStats())
        seg_lists.append(eng._plan(c))
        ctxs.append(c)
    segs = pack_segments_batch(seg_lists, tuple(icfg.scales))
    cons = jnp.asarray([[c.params["alpha"], c.params["beta"],
                         c.params["_mu_q"], c.params["_sd_q"]] for c in ctxs],
                       jnp.float32)
    qhat = np.stack([(qr - c.params["_mu_q"]) / c.params["_sd_q"]
                     for qr, c in zip(queries, ctxs)])
    inputs = (data_sh, stack, jnp.asarray(qhat, jnp.float32), segs,
              jnp.full(2, EPS * EPS, jnp.float32), cons, jnp.int32(N))
    return dict(icfg=icfg, data=data, mesh=mesh, inputs=inputs, ctxs=ctxs,
                q_offs=q_offs, qhat=qhat)


def _oracle_answers(data, ctx, zq):
    """Exact float64 cNSM-DTW answer offsets (constraints + banded z-DP)."""
    L, rho = ctx.length, ctx.params["rho"]
    m = data.size - L + 1
    win = np.lib.stride_tricks.sliding_window_view(data, L)[:m].astype(np.float64)
    mu = win.mean(axis=1)
    sd = np.sqrt(np.maximum(np.mean(win * win, axis=1) - mu * mu, 0.0))
    mu_q, sd_q = ctx.params["_mu_q"], ctx.params["_sd_q"]
    ratio = sd / sd_q
    ok = ((np.abs(mu - mu_q) <= ctx.params["beta"])
          & (ratio <= ctx.params["alpha"])
          & (ratio >= 1.0 / ctx.params["alpha"]) & (sd > 0))
    cand = np.flatnonzero(ok)
    z = (win[cand] - mu[cand, None]) / sd[cand, None]
    d2 = dtw_banded_batch_f64(z, zq, rho, ub=ctx.eps2)
    return set(cand[d2 <= ctx.eps2].tolist())


def test_norm_dtw_sharded_parity_and_no_false_dismissal(setup):
    s = setup
    per = N // 8
    step = make_sharded_query_step_norm_dtw_batched(
        s["mesh"], s["icfg"], LENGTH, RHO, top_k=per)
    counts, idx, d2, mean, std = (np.asarray(a) for a in step(*s["inputs"]))
    assert counts.shape == (8, 2)
    assert counts.max() <= per, "top_k=per-shard positions cannot truncate"
    for qi, (off, ctx) in enumerate(zip(s["q_offs"], s["ctxs"])):
        got = idx[:, qi, :][d2[:, qi, :] <= EPS * EPS + 1e-3]
        got = set(int(g) for g in got.tolist())
        assert off in got, "lost the self-match"
        oracle = _oracle_answers(s["data"], ctx, s["qhat"][qi])
        # no false dismissal: every exact answer is produced by the step
        assert oracle <= got, f"missing {sorted(oracle - got)[:5]}"
        # soundness with a borderline guard: clear step answers are real
        clear = idx[:, qi, :][d2[:, qi, :] <= EPS * EPS * (1 - 1e-3)]
        assert set(int(g) for g in clear.tolist()) <= oracle


def test_recovery_escalates_top_k(setup):
    s = setup
    per = N // 8
    calls = []

    def factory(k):
        calls.append(k)
        return make_sharded_query_step_norm_dtw_batched(
            s["mesh"], s["icfg"], LENGTH, RHO, top_k=k)

    # the z/envelope bound is unselective at this tiny n, so per-shard counts
    # far exceed 8 and the ladder must escalate to the cap in one step
    out, used_k = run_sharded_step_with_recovery(
        factory, s["inputs"], top_k=8, k_cap=per, growth=per)
    counts = np.asarray(out[0])
    assert calls == [8, per]
    assert used_k == per and counts.max() <= used_k
    idx, d2 = np.asarray(out[1]), np.asarray(out[2])
    for qi, off in enumerate(s["q_offs"]):
        got = idx[:, qi, :][d2[:, qi, :] <= EPS * EPS + 1e-3]
        assert off in got.tolist()


def test_recovery_cap_raises_or_falls_back(setup):
    s = setup

    def factory(k):
        return make_sharded_query_step_norm_dtw_batched(
            s["mesh"], s["icfg"], LENGTH, RHO, top_k=k)

    with pytest.raises(OverflowError):
        run_sharded_step_with_recovery(factory, s["inputs"], top_k=8, k_cap=8)

    sentinel = object()
    out, used_k = run_sharded_step_with_recovery(
        factory, s["inputs"], top_k=8, k_cap=8,
        host_fallback=lambda: sentinel)
    assert out is sentinel and used_k == 0
