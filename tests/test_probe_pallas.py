"""Fused probe kernel (Pallas through Triton) vs the XLA flags step.

The kernel (ops/probe_pallas.py) must reproduce the XLA fly probe's candidate
counts exactly and its flags at 128-position granularity: on a GPU the engine
routes `_device_dense_phase1_flags` through it (engine/base.py), so any
numeric divergence would silently change phase-1 coverage.  Here it runs in
Pallas interpret mode; the compiled kernel is compared with the XLA step on
the card by chip_smoke.py.
"""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvmatch_tpu.config import IndexConfig
from kvmatch_tpu.ops.probe_pallas import (FLAG, TILE, probe_flags_tiles,
                                          probe_kernel_for)
from kvmatch_tpu.parallel.query import (_dense_probe, _dense_probe_norm,
                                        pack_segments_batch)
from kvmatch_tpu.plan import QuerySegment


def _mk_segments(data, offs, L, icfg, widths):
    seg_lists = []
    for o in offs:
        q = data[o:o + L]
        segs, pos = [], 0
        for w in widths:
            if (pos + 1) * icfg.unit + w > L:
                break
            mean = q[pos * icfg.unit: pos * icfg.unit + w].mean()
            segs.append(QuerySegment(order=pos + 1, w=w, mean_lo=mean,
                                     mean_hi=mean, count=1))
            pos += w // icfg.unit
        seg_lists.append(segs)
    return seg_lists


@pytest.mark.parametrize("norm", [False, True])
def test_probe_kernel_matches_xla_probe(norm):
    icfg = IndexConfig()
    rng = np.random.default_rng(0)
    L, Q = 512, 2
    NT = 3                       # three tiles
    blk = NT * TILE
    n = blk - 700                # m inside the block; tail positions masked
    data = np.cumsum(rng.normal(0, 0.1, blk + L + 400)).astype(np.float64)
    offs = rng.integers(0, n - L, Q)
    seg_lists = _mk_segments(data, offs, L, icfg, [100, 50, 25, 200, 25])
    segs = pack_segments_batch(seg_lists, tuple(icfg.scales))
    eps2 = jnp.asarray([1.0, 25.0], jnp.float32)
    if norm:
        cons = jnp.asarray(
            [[1.2, 5.0, data[o:o + L].mean(), data[o:o + L].std()]
             for o in offs], jnp.float32)
    else:
        cons = jnp.zeros((Q, 4), jnp.float32)

    # reference: the XLA probe's per-position bound over the same bucket rows
    from kvmatch_tpu.ops.sliding import build_buckets
    bk = build_buckets(jnp.asarray(data, jnp.float32), tuple(icfg.scales),
                       icfg.pos_of_d)
    stack = jnp.stack([bk[w][: blk + L] for w in icfg.scales])
    slack = np.float32(icfg.probe_guard)
    m = n - L + 1
    if norm:
        acc = jax.vmap(lambda sg, c: _dense_probe_norm(
            stack, sg, icfg.unit, icfg.d, blk, slack,
            c[0], c[1], c[2], c[3], L))(segs, cons)
    else:
        acc = jax.vmap(lambda sg: _dense_probe(
            stack, sg, icfg.unit, icfg.d, blk, slack))(segs)
    pos = np.arange(blk)
    mask = (np.asarray(acc) <= np.asarray(eps2)[:, None]) & (pos[None, :] < m)
    ref_counts = mask.sum(axis=1)
    ref_flags = mask.reshape(Q, blk // FLAG, FLAG).any(axis=2)

    flags, counts = probe_flags_tiles(
        stack, segs.scale_idx, segs.order, segs.valid.astype(jnp.int32),
        segs.mean_lo, segs.mean_hi, segs.width, eps2, cons,
        jnp.asarray([0, 0, m], jnp.int32), n_tiles=NT,
        length=L, unit=icfg.unit, d=icfg.d, slack=float(icfg.probe_guard),
        norm=norm, interpret=True)
    np.testing.assert_array_equal(np.asarray(counts), ref_counts)
    np.testing.assert_array_equal(np.asarray(flags), ref_flags)
    assert ref_counts.min() >= 1  # self-query offsets must be candidates


def test_probe_kernel_column_offset():
    """iscal[0] moves the window the kernel reads: probing columns from c0
    equals probing a stack that starts at c0."""
    icfg = IndexConfig()
    rng = np.random.default_rng(4)
    L, NT, c0 = 256, 2, 3 * 128 + 5
    stack = jnp.asarray(rng.integers(0, 40, (len(icfg.scales),
                                             c0 + NT * TILE + L)), jnp.int32)
    segs = pack_segments_batch(
        [[QuerySegment(order=1, w=25, mean_lo=1.0, mean_hi=1.0, count=1),
          QuerySegment(order=3, w=50, mean_lo=0.5, mean_hi=0.6, count=1)]],
        tuple(icfg.scales))
    args = (segs.scale_idx, segs.order, segs.valid.astype(jnp.int32),
            segs.mean_lo, segs.mean_hi, segs.width,
            jnp.asarray([0.5], jnp.float32), jnp.zeros((1, 4), jnp.float32))
    kw = dict(n_tiles=NT, length=L, unit=icfg.unit, d=icfg.d,
              slack=float(icfg.probe_guard), norm=False, interpret=True)
    m = NT * TILE
    f1, c1 = probe_flags_tiles(stack, *args, jnp.asarray([c0, 0, m]), **kw)
    f2, c2 = probe_flags_tiles(stack[:, c0:], *args, jnp.asarray([0, 0, m]),
                               **kw)
    np.testing.assert_array_equal(np.asarray(f1), np.asarray(f2))
    np.testing.assert_array_equal(np.asarray(c1), np.asarray(c2))
    assert 0 < int(c1[0]) < m


@pytest.mark.parametrize("platform,route", [("gpu", "triton"),
                                            ("cpu", "xla")])
def test_probe_kernel_for(platform, route):
    assert probe_kernel_for(platform) == route


def test_probe_kernel_for_unknown_platform():
    with pytest.raises(ValueError):
        probe_kernel_for("metal")


def test_flags_pallas_step_constraint_and_sound():
    """The full fused flag step (blocked driver + device constraint AND for
    cNSM) must (a) never dismiss an exact answer's block, (b) only REMOVE
    flags relative to the probe-only bitmap, (c) keep probe-exact counts."""
    from kvmatch_tpu.data.generators import generate_series
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu.index.build import build_index_tpu
    from kvmatch_tpu.oracle import nsm_ed
    from kvmatch_tpu.parallel.query import (
        FLY_FILL, fly_pad_for, make_dense_probe_step_flags,
        make_dense_probe_step_flags_pallas)

    icfg = IndexConfig()
    n, L, Q = 60_000, 512, 2
    data = generate_series(n, seed=11)
    index = build_index_tpu(data, icfg, backend="host")
    eng = NormQueryEngine(data, index=index, icfg=icfg)
    rng = np.random.default_rng(3)
    offs = rng.integers(0, n - L, Q)
    alpha, beta, eps = 1.3, 8.0, 6.0
    # plans + cons exactly as the engine builds them
    from kvmatch_tpu.engine.base import QueryStats, _Ctx
    ctxs, seg_lists = [], []
    for o in offs:
        ctx = _Ctx(query=data[o:o + L], length=L, epsilon=eps, eps2=eps * eps,
                   params={"alpha": alpha, "beta": beta}, stats=QueryStats())
        seg_lists.append(eng._plan(ctx))
        ctxs.append(ctx)
    segs = pack_segments_batch(seg_lists, tuple(icfg.scales))
    cons = jnp.asarray([[alpha, beta, c.params["_mu_q"], c.params["_sd_q"]]
                        for c in ctxs], jnp.float32)
    eps2 = jnp.full(Q, eps * eps, jnp.float32)
    pad = fly_pad_for(L, max(icfg.scales))
    data_p = jnp.concatenate([jnp.asarray(data, jnp.float32),
                              jnp.full(pad, FLY_FILL, jnp.float32)])

    pal = make_dense_probe_step_flags_pallas(icfg, L, norm=True,
                                             interpret=True)
    n_off, flags = pal(data_p, segs, eps2, cons, jnp.int32(n))
    n_off, flags = np.asarray(n_off), np.asarray(flags)
    xla = make_dense_probe_step_flags(icfg, L, flag_block=FLAG, norm=True)
    nx, fx = (np.asarray(a) for a in xla(data_p, segs, eps2, cons,
                                         jnp.int32(n)))
    # (c) probe-exact counts unchanged by the constraint AND
    np.testing.assert_array_equal(n_off, nx)
    k = min(flags.shape[1], fx.shape[1])
    # (b) constraint only removes flags
    assert not (flags[:, :k] & ~fx[:, :k]).any()
    # (a) every exact cNSM answer lands in a flagged block
    for qi, o in enumerate(offs):
        ans, _ = nsm_ed(data, data[o:o + L], eps, alpha=alpha, beta=beta)
        assert len(ans) >= 1 and o in ans.tolist()
        blocks = np.asarray(ans) // FLAG
        assert flags[qi][blocks].all(), f"query {qi}: answer block dismissed"
    # the constraint must actually prune something at this workload
    assert flags.sum() < fx[:, :k].sum()
    # cached-stats variant (precomputed window stats) is bit-identical
    from kvmatch_tpu.parallel.query import make_cons_stats_prog
    pal_c = make_dense_probe_step_flags_pallas(
        icfg, L, norm=True, interpret=True, cached_stats=True)
    stats3 = make_cons_stats_prog(L)(data_p)
    n_off_c, flags_c = pal_c(data_p, segs, eps2, cons, jnp.int32(n), stats3)
    np.testing.assert_array_equal(np.asarray(n_off_c), n_off)
    np.testing.assert_array_equal(np.asarray(flags_c), flags)
    # cached-buckets variant (precomputed query-independent bucket stack) is
    # bit-identical: shifted reads for unmasked positions never touch the
    # stack's sentinel tail (p + shift <= n - w for every valid segment)
    from kvmatch_tpu.parallel.query import make_bucket_stack_prog
    pal_b = make_dense_probe_step_flags_pallas(
        icfg, L, norm=True, interpret=True, cached_stats=True,
        cached_buckets=True)
    bstack3 = make_bucket_stack_prog(icfg, tuple(icfg.scales))(data_p)
    n_off_b, flags_b = pal_b(data_p, segs, eps2, cons, jnp.int32(n),
                             stats3=stats3, bstack3=bstack3)
    np.testing.assert_array_equal(np.asarray(n_off_b), n_off)
    np.testing.assert_array_equal(np.asarray(flags_b), flags)
