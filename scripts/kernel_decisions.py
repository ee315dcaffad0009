#!/usr/bin/env python
"""Kernel decisions on the card: each hand-written kernel against the plain
XLA form it replaces, end to end through the engines and alone.

    python scripts/kernel_decisions.py [--n N] [--out kernel_decisions.json]

Runs on one GPU.  Every comparison alternates the two routes (A, B, B, A) in
one process and reports each route's median wall seconds:

* flood probe: cNSM-ED query_batch at n=1e8, L=8192, Q=8 through the device
  dense route with (a) the fused Triton flag probe, (b) the XLA flags step,
  (c) the run-ladder emission; plus the probe pass alone;
* banded DTW: the DP stage alone, then RSM-DTW (L=1024, rho=51) and
  cNSM-DTW (L=8192, rho=409) queries with the CUDA kernel vs the XLA scan
  form;
* the cost model of QueryConfig.tuned, refit at n=1e6, L in {512, 2048, 8192}.

Prints one JSON object (also written to --out) with every number.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import json
import statistics
import subprocess
import sys
import time
from pathlib import Path

import numpy as np

sys.path.insert(0, str(Path(__file__).resolve().parents[1]))


def wall(fn, reps=3):
    """Median wall seconds of fn() after one warm-up call."""
    import jax
    jax.block_until_ready(fn())
    ts = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        ts.append(time.perf_counter() - t0)
    return statistics.median(ts)


def abba(fa, fb, reps=3):
    """A, B, B, A: returns (median seconds of A, of B)."""
    a1 = wall(fa, reps)
    b1 = wall(fb, reps)
    b2 = wall(fb, reps)
    a2 = wall(fa, reps)
    return statistics.median([a1, a2]), statistics.median([b1, b2])


@contextlib.contextmanager
def patched(module, name, value):
    old = getattr(module, name)
    setattr(module, name, value)
    try:
        yield
    finally:
        setattr(module, name, old)


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=100_000_000)
    ap.add_argument("--out", default="kernel_decisions.json")
    ap.add_argument("--skip", default="",
                    help="comma list of probe,dtw,rsm_e2e,cost")
    args = ap.parse_args()
    skip = set(filter(None, args.skip.split(",")))

    import jax
    import jax.numpy as jnp

    from kvmatch_tpu.config import IndexConfig, QueryConfig
    from kvmatch_tpu.data.generators import generate_series
    from kvmatch_tpu.engine.base import QueryStats, _Ctx
    from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu.engine.rsm_dtw import QueryEngineDtw
    from kvmatch_tpu.engine.rsm_ed import QueryEngine
    from kvmatch_tpu.index.build import build_index_tpu
    from kvmatch_tpu.index.device_build import build_index_device_stats
    from kvmatch_tpu.ops import dtw as dtw_ops
    from kvmatch_tpu.ops import probe_pallas
    from kvmatch_tpu.utils.compile_cache import enable_compile_cache
    from kvmatch_tpu.utils.profiling import fit_cost_model

    enable_compile_cache()
    dev = jax.devices()[0]
    if dev.platform != "gpu":
        raise SystemExit(f"needs a GPU, found {dev.platform}")
    smi = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                          "--format=csv,noheader"], capture_output=True,
                         text=True, check=True).stdout.strip()
    out = {"device_kind": dev.device_kind, "card": smi}
    print(f"[decisions] {dev.device_kind} / {smi}", flush=True)
    icfg = IndexConfig()
    qcfg = QueryConfig.tuned()
    rng = np.random.default_rng(7)

    def emit(key, value):
        out[key] = value
        print(f"[decisions] {key} = {value}", flush=True)
        Path(args.out).parent.mkdir(parents=True, exist_ok=True)
        Path(args.out).write_text(json.dumps(out, indent=1))

    # ------------------------------------------------------------ cost model
    if "cost" not in skip:
        d6 = generate_series(1_000_000, seed=20260816)
        idx6 = build_index_tpu(d6, icfg, backend="device")
        rsm6 = QueryEngine(d6, index=idx6, icfg=icfg, qcfg=qcfg)
        batches = []
        for L in (512, 2048, 8192):
            offs = rng.integers(0, d6.size - L, 24)
            batches.append(np.stack([d6[o:o + L] for o in offs]))
        base = dataclasses.replace(QueryConfig(), enable_early_termination=False)
        rsm6.qcfg = base
        for b in batches:  # compile every launch bucket first
            rsm6.query_batch(b, 8.0)
        fit = fit_cost_model(rsm6, batches, 8.0, repeats=2)
        emit("cost_ed", {"a": fit.phase2_cost_a, "b": fit.phase2_cost_b,
                         "intercept_ms": fit.phase2_cost_intercept})
        deng6 = QueryEngineDtw(d6, index=idx6, icfg=icfg, qcfg=base,
                               device_data=rsm6.data_dev)
        for b in batches:
            deng6.query_batch(b, 6.0, rho=b.shape[1] // 20)
        rows = []
        for b in batches:
            f = fit_cost_model(deng6, [b], 6.0, rho=b.shape[1] // 20)
            rows.append((b.shape[1], f.phase2_cost_a_dtw, f.phase2_cost_b_dtw,
                         f.phase2_cost_intercept))
        emit("cost_dtw_per_L", rows)

    if skip != {"probe", "dtw"}:
        data = generate_series(args.n, seed=20260817)
        data_dev = jnp.asarray(data, jnp.float32)
        index_stats = build_index_device_stats(data, icfg, data_dev=data_dev)

    # ---------------------------------------------------------- flood probe
    if "probe" not in skip:
        L = 8192
        offs = rng.integers(0, data.size - L, 8)
        qs = np.stack([data[o:o + L] for o in offs])
        kw = dict(alpha=1.2, beta=5.0)
        dense = dataclasses.replace(qcfg, dense_probe_min_count=0)
        eng = NormQueryEngine(data, index=index_stats, icfg=icfg, qcfg=dense,
                              device_data=data_dev)
        eng_runs = NormQueryEngine(
            data, index=index_stats, icfg=icfg, device_data=data_dev,
            qcfg=dataclasses.replace(dense, dense_probe_emit="runs"))
        eng_flags = NormQueryEngine(
            data, index=index_stats, icfg=icfg, device_data=data_dev,
            qcfg=dataclasses.replace(dense, dense_probe_emit="flags"))

        def batch(e):
            return lambda: [r.offsets for r in e.query_batch(qs, 4.0, **kw)]

        xla_route = lambda platform: "xla"  # noqa: E731
        t_ker, t_runs = abba(batch(eng_flags), batch(eng_runs))
        emit("probe_e2e_flags_triton_s", t_ker)
        emit("probe_e2e_runs_s", t_runs)
        with patched(probe_pallas, "probe_kernel_for", xla_route):
            t_xla = wall(batch(eng_flags))
        emit("probe_e2e_flags_xla_s", t_xla)
        ctxs = [_Ctx(query=q, length=L, epsilon=4.0, eps2=16.0,
                     params=dict(kw), stats=QueryStats()) for q in qs]
        plans = eng._plan_batch(ctxs)
        t_pk = wall(lambda: eng._device_dense_phase1_flags(ctxs, plans)[1])
        with patched(probe_pallas, "probe_kernel_for", xla_route):
            t_px = wall(lambda: eng._device_dense_phase1_flags(ctxs, plans)[1])
        emit("probe_pass_triton_s", t_pk)
        emit("probe_pass_xla_s", t_px)
        del eng, eng_runs, eng_flags

    # ----------------------------------------------------------- banded DTW
    if "dtw" not in skip:
        xla_route = lambda p, r, L: "xla"  # noqa: E731
        index_full = build_index_tpu(data, icfg, backend="device")
        deng = QueryEngineDtw(data, index=index_full, icfg=icfg, qcfg=qcfg,
                              device_data=data_dev)
        o = int(rng.integers(0, data.size - 1024))
        q = data[o:o + 1024]

        def rsm():
            return deng.query(q, 6.0, rho=51).offsets

        for L, r, B in ((1024, 51, 4096), (8192, 409, 1024)):
            offs = jnp.asarray(rng.integers(0, data.size - L, B), jnp.int32)
            qm = jnp.asarray(data[:L][None], jnp.float32)
            qids = jnp.zeros(B, jnp.int32)
            tc = wall(lambda: dtw_ops._dtw_stage_multi_cuda(
                deng.data_dev, qm, offs, qids, L, r))
            tx = wall(lambda: dtw_ops._dtw_stage_multi_xla(
                deng.data_dev, qm, offs, qids, L, r))
            emit(f"dtw_stage_L{L}_B{B}_cuda_s", tc)
            emit(f"dtw_stage_L{L}_B{B}_xla_s", tx)
            emit(f"dtw_stage_L{L}_cuda_cells_per_s", B * L * (2 * r + 1) / tc)
        if "rsm_e2e" not in skip:
            t_c = wall(rsm)
            with patched(dtw_ops, "dtw_kernel_for", xla_route):
                t_x = wall(rsm)
            t_c2 = wall(rsm)
            emit("dtw_rsm_e2e_cuda_s", min(t_c, t_c2))
            emit("dtw_rsm_e2e_xla_s", t_x)
        cdeng = NormQueryEngineDtw(data, index=index_full, icfg=icfg,
                                   qcfg=qcfg, device_data=data_dev)
        o = int(rng.integers(0, data.size - 8192))
        qs = data[o:o + 8192][None]

        def cnsm():
            return [r.offsets for r in cdeng.query_batch(
                qs, 4.0, rho=409, alpha=1.2, beta=5.0)]

        t_c = wall(cnsm, reps=1)
        emit("dtw_cnsm_e2e_cuda_s", t_c)
        # the XLA route costs ~10x more: run it only where that stays short
        if t_c < 15.0:
            with patched(dtw_ops, "dtw_kernel_for", xla_route):
                t_x = wall(cnsm, reps=1)
            emit("dtw_cnsm_e2e_xla_s", t_x)
        del deng, cdeng, index_full

    Path(args.out).parent.mkdir(parents=True, exist_ok=True)
    Path(args.out).write_text(json.dumps(out, indent=1))
    print(json.dumps(out), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
