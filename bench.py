#!/usr/bin/env python
"""Benchmark harness — prints ONE JSON line with the headline metric.

Headline: the reference's only published number, the README demo query
(RSM-ED, synthetic n=1e6, self-query at offset 123456, L=8192, eps=10 ->
T=176 ms total on the authors' machine, /root/reference/README.md:72-77).
``value`` is our median total latency for the same query; ``vs_baseline`` is the
speedup (176 / value).  Extra fields report index-build throughput and batched
query throughput for RSM-ED and cNSM-ED.

EVERY section runs under a crash guard: a section that fails records its
error in extras["section_errors"], the JSON line still lands, and the process
exits non-zero.  Without a GPU the run fails at once.

Run: python bench.py [--n N] [--quick]
"""

import argparse
import dataclasses
import json
import statistics
import sys
import time
import traceback

import numpy as np

BASELINE_DEMO_MS = 176.0


SECTION_ERRORS: dict = {}


class _Section:
    """Crash guard: records any exception in SECTION_ERRORS and on stderr so
    the remaining sections still run; main() exits non-zero afterwards."""

    def __init__(self, name: str):
        self.name = name
        self.ok = True

    def __enter__(self):
        return self

    def __exit__(self, et, ev, tb):
        if et is not None:
            self.ok = False
            SECTION_ERRORS[self.name] = f"{et.__name__}: {ev}"[:200]
            print(f"[bench] section '{self.name}' failed: {et.__name__}: "
                  f"{ev}", file=sys.stderr)
            traceback.print_exc(limit=4, file=sys.stderr)
        return True  # suppress


def main() -> int:
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=1_000_000)
    ap.add_argument("--batch", type=int, default=128)
    ap.add_argument("--quick", action="store_true")
    ap.add_argument("--northstar", action=argparse.BooleanOptionalAction,
                    default=True,
                    help="run the n=1e8 cNSM north-star shape (build + "
                         "engine batch + one measured twin query)")
    args = ap.parse_args()

    import jax
    import jax.numpy as jnp

    from kvmatch_tpu.utils.compile_cache import enable_compile_cache

    if jax.devices()[0].platform != "gpu":
        print(f"bench.py needs a GPU; JAX found {jax.devices()[0].platform}",
              file=sys.stderr)
        return 2
    enable_compile_cache()

    from kvmatch_tpu.config import IndexConfig, QueryConfig
    from kvmatch_tpu.data.generators import generate_series
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu.engine.rsm_ed import QueryEngine
    from kvmatch_tpu.index.build import build_index_tpu
    from kvmatch_tpu.index.structure import total_memory_bytes

    n = args.n
    data = generate_series(n, seed=20260816)

    # --- index build ---------------------------------------------------------
    icfg = IndexConfig()
    stats: dict = {}
    index = build_index_tpu(data, icfg, stats=stats, backend="device")
    build_mpts = stats.get("mpts_per_second", 0.0)

    qcfg = QueryConfig.tuned()
    engine = QueryEngine(data, index=index, icfg=icfg, qcfg=qcfg)

    # --- README demo query ---------------------------------------------------
    L, eps, demo_off = 8192, 10.0, 123_455  # 0-based = reference offset 123456
    demo_ms, demo_ok = float("nan"), False
    demo_lat: list = []
    with _Section("demo"):
        res = engine.query_at(demo_off, L, eps)  # compile warmup
        demo_ok = bool(res.found and int(res.offsets[0]) == demo_off
                       and res.distances[0] == 0.0)
        for _ in range(3 if args.quick else 7):
            r = engine.query_at(demo_off, L, eps)
            demo_lat.append(round(r.stats.t_total_ms, 2))
        demo_ms = statistics.median(demo_lat)

    # --- batched RSM-ED throughput ------------------------------------------
    rng = np.random.default_rng(1)
    nq = 64 if args.quick else args.batch
    offs = rng.integers(0, n - L, nq)
    queries = np.stack([data[o:o + L] for o in offs])
    rsm_qps = ref_rsm_qps = 0.0
    rsm_p1_ms = rsm_p2_ms = 0.0
    rsm_cands = rsm_near = found = 0
    rsm_qps_reps: list = []
    with _Section("rsm_batch"):
        engine.query_batch(queries, eps)  # warmup (compiles all launch buckets)
        for _ in range(2):
            t0 = time.perf_counter()
            batch_res = engine.query_batch(queries, eps)
            rsm_qps_reps.append(round(nq / (time.perf_counter() - t0), 1))
            rsm_qps = max(rsm_qps, rsm_qps_reps[-1])
        found = sum(1 for o, r in zip(offs, batch_res)
                    if int(o) in r.offsets.tolist())
        # Reference's own fitted phase-2 model (QueryEngine.java:55-57) applied
        # to the measured candidate loads: what the Java engine's verify step
        # would cost per query on ITS hardware for this exact workload.
        ref_ms = [4.0707589132278 * r.stats.n_disjoint
                  + 0.269833135638498 * r.stats.n_candidates / 1e5 * L
                  for r in batch_res]
        ref_rsm_qps = 1000.0 / max(float(np.mean(ref_ms)), 1e-9)
        rsm_p1_ms = float(np.mean([r.stats.t_phase1_ms for r in batch_res]))
        rsm_p2_ms = float(np.mean([r.stats.t_phase2_ms for r in batch_res]))
        rsm_cands = int(np.sum([r.stats.n_candidates for r in batch_res]))
        rsm_near = int(np.sum([r.stats.n_host_rechecked for r in batch_res]))

    # --- batched cNSM-ED throughput -----------------------------------------
    nq2 = 32 if args.quick else 128
    offs2 = offs[:nq2]
    q2 = queries[:nq2]
    cnsm_qps = ref_cnsm_qps = 0.0
    nfound = 0
    neng = None
    cnsm_qps_reps: list = []
    with _Section("cnsm_batch"):
        neng = NormQueryEngine(data, index=index, icfg=icfg, qcfg=qcfg,
                               device_data=engine.data_dev)
        neng.query_batch(q2, 4.0, alpha=1.2, beta=5.0)  # warmup
        for _ in range(2):
            t0 = time.perf_counter()
            nres = neng.query_batch(q2, 4.0, alpha=1.2, beta=5.0)
            cnsm_qps_reps.append(round(nq2 / (time.perf_counter() - t0), 1))
            cnsm_qps = max(cnsm_qps, cnsm_qps_reps[-1])
        nfound = sum(1 for o, r in zip(offs2, nres)
                     if int(o) in r.offsets.tolist())
        nref_ms = [9.72276547123376 * r.stats.n_disjoint
                   + 0.0106737255022236 * r.stats.n_candidates / 1e5 * L
                   for r in nres]
        ref_cnsm_qps = 1000.0 / max(float(np.mean(nref_ms)), 1e-9)

    # --- device-resident batched paths (probed in DENSE_PROBE_GROUP
    # sub-batches with a memory-aware block budget) --------------------------
    dev_qps = 0.0
    dev_found = 0
    with _Section("rsm_device_batch"):
        engine.query_batch_device(queries, eps, top_k=32768)  # warmup/compile
        for _ in range(2):
            t0 = time.perf_counter()
            dres = engine.query_batch_device(queries, eps, top_k=32768)
            dev_qps = max(dev_qps, nq / (time.perf_counter() - t0))
        dev_found = sum(1 for o, r in zip(offs, dres)
                        if int(o) in r.offsets.tolist())

    ndev_qps = 0.0
    ndev_found = 0
    with _Section("cnsm_device_batch"):
        if neng is None:
            raise RuntimeError("cnsm_batch section failed; no engine")
        neng.query_batch_device(q2, 4.0, top_k=32768, alpha=1.2, beta=5.0)
        for _ in range(2):
            t0 = time.perf_counter()
            ndres = neng.query_batch_device(q2, 4.0, top_k=32768,
                                            alpha=1.2, beta=5.0)
            ndev_qps = max(ndev_qps, nq2 / (time.perf_counter() - t0))
        ndev_found = sum(1 for o, r in zip(offs2, ndres)
                         if int(o) in r.offsets.tolist())

    # --- RSM-DTW single-query latency ---------------------------------------
    from kvmatch_tpu.engine.rsm_dtw import QueryEngineDtw
    dtw_L, rho = 1024, 51
    rsm_dtw_ms, dtw_ok = float("nan"), False
    with _Section("rsm_dtw"):
        deng = QueryEngineDtw(data, index=index, icfg=icfg, qcfg=qcfg,
                              device_data=engine.data_dev)
        deng.query_at(demo_off, dtw_L, 6.0, rho=rho)  # warmup
        dt = []
        for _ in range(3):
            r = deng.query_at(demo_off, dtw_L, 6.0, rho=rho)
            dt.append(r.stats.t_total_ms)
        rsm_dtw_ms = statistics.median(dt)
        dtw_ok = bool(r.found and int(r.offsets[0]) == demo_off)

    # --- MEASURED reference baseline (scalar C twin, single thread) ----------
    # The container has no JVM, so the Java reference can't run here; the twin
    # engines replay its exact phase-2 scalar loops (QueryEngine.java:343-363,
    # NormQueryEngine.java:454-527, QueryEngineDtw.java:385-452) compiled from
    # C — faster than the Java they stand in for, so ratios are conservative.
    from kvmatch_tpu.baseline_twin import (ScalarTwinDtw, ScalarTwinEd,
                                           ScalarTwinNormEd)
    from kvmatch_tpu.config import QueryConfig as _QC
    twin_cfg = _QC()  # reference cost-model coefficients drive its termination
    twin_demo_ms = twin_rsm_ms = twin_cnsm_ms = twin_dtw_ms = float("nan")
    with _Section("twin_ed"):
        twin = ScalarTwinEd(data, index=index, icfg=icfg, qcfg=twin_cfg,
                            device_data=engine.data_dev)
        tdemo = []
        for _ in range(3):
            tr = twin.query_at(demo_off, L, eps)
            tdemo.append(tr.stats.t_total_ms)
        twin_demo_ms = statistics.median(tdemo)
        nq_t = min(16, nq)
        t0 = time.perf_counter()
        for qrow in queries[:nq_t]:
            twin.query(qrow, eps)
        twin_rsm_ms = (time.perf_counter() - t0) * 1e3 / nq_t

    with _Section("twin_cnsm"):
        ntwin = ScalarTwinNormEd(data, index=index, icfg=icfg, qcfg=twin_cfg,
                                 device_data=engine.data_dev)
        nq_nt = min(8, nq2)
        t0 = time.perf_counter()
        for qrow in q2[:nq_nt]:
            ntwin.query(qrow, 4.0, alpha=1.2, beta=5.0)
        twin_cnsm_ms = (time.perf_counter() - t0) * 1e3 / nq_nt

    with _Section("twin_dtw"):
        dtwin = ScalarTwinDtw(data, index=index, icfg=icfg, qcfg=twin_cfg,
                              device_data=engine.data_dev)
        tdd = []
        for _ in range(3):
            tr = dtwin.query_at(demo_off, dtw_L, 6.0, rho=rho)
            tdd.append(tr.stats.t_total_ms)
        twin_dtw_ms = statistics.median(tdd)

    # --- cNSM-DTW at the north-star shape (n=1e6, L=8192, rho=409) -----------
    # Engine q/s with the double-single device confirm,
    # against the measured scalar-C twin on identical queries.
    from kvmatch_tpu.baseline_twin import ScalarTwinNormDtw
    from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw
    cnsm_dtw_qps = twin_cnsm_dtw_ms = 0.0
    cd_found = 0
    cd_rechecked = -1
    nq_cd = 16
    cd_qps_reps: list = []
    with _Section("cnsm_dtw"):
        if args.quick:
            raise RuntimeError("skipped in --quick")
        cdeng = NormQueryEngineDtw(data, index=index, icfg=icfg, qcfg=qcfg,
                                   device_data=engine.data_dev)
        q_cd = queries[:nq_cd]
        rho_ns = int(0.05 * L)
        cdeng.query_batch(q_cd[:2], 4.0, rho=rho_ns, alpha=1.2, beta=5.0)
        for _ in range(3):  # median-of-3
            t0 = time.perf_counter()
            cd_res = cdeng.query_batch(q_cd, 4.0, rho=rho_ns,
                                       alpha=1.2, beta=5.0)
            cd_qps_reps.append(round(nq_cd / (time.perf_counter() - t0), 3))
        cnsm_dtw_qps = statistics.median(cd_qps_reps)
        cd_found = sum(1 for o, r in zip(offs[:nq_cd], cd_res)
                       if int(o) in r.offsets.tolist())
        cd_rechecked = int(np.sum([r.stats.n_host_rechecked for r in cd_res]))
        cdtwin = ScalarTwinNormDtw(data, index=index, icfg=icfg, qcfg=twin_cfg,
                                   device_data=engine.data_dev)
        t0 = time.perf_counter()
        for qrow in q_cd[:2]:
            cdtwin.query(qrow, 4.0, rho=rho_ns, alpha=1.2, beta=5.0)
        twin_cnsm_dtw_ms = (time.perf_counter() - t0) * 1e3 / 2

    # --- north-star shape: cNSM-ED at n=1e8 ----------------------------------
    northstar = {}
    if not args.quick and args.northstar:
        with _Section("northstar"):
            import gc
            from kvmatch_tpu.index.build import build_index_tpu as _hbuild
            from kvmatch_tpu.index.device_build import build_index_device_stats
            n8 = 100_000_000
            data8 = generate_series(n8, seed=20260817)
            # Serving-mode device build: the statistics the fly-probe +
            # device-verify path actually consumes, built entirely on the
            # device (no interval materialization, no D2H beyond 8 MB/scale).
            # The full interval build (build_index_device) serves the host
            # phase-1 route and persistence and is exercised by tests.
            # one H2D of the f32 series, shared by the build and the engine
            t0 = time.perf_counter()
            data_dev8 = jnp.asarray(data8, jnp.float32)
            data_dev8.block_until_ready()
            northstar["series_h2d_s"] = round(time.perf_counter() - t0, 2)
            bst: dict = {}
            index8 = build_index_device_stats(data8, icfg, stats=bst,
                                              data_dev=data_dev8)
            northstar["device_build_mpts_per_s_1e8_cold"] = round(
                bst["mpts_per_second"], 1)
            bst = {}
            index8 = build_index_device_stats(data8, icfg, stats=bst,
                                              data_dev=data_dev8)
            northstar["device_build_mpts_per_s_1e8"] = round(
                bst["mpts_per_second"], 1)
            for k in ("build_seconds", "h2d_seconds", "device_seconds",
                      "host_group_seconds"):
                if k in bst:
                    northstar[k] = round(float(bst[k]), 2)
            rng8 = np.random.default_rng(2)
            offs8 = rng8.integers(0, n8 - L, 8)
            q8 = np.stack([data8[o:o + L] for o in offs8])
            # Serving route: device fly probe (fused flags kernel with the
            # guarded alpha/beta constraint AND) + device verify.
            # dense_probe_min_count=0: at n=1e8 even "selective" plans cost
            # ~1-2 s of host interval algebra per query, while the fused
            # probe answers the whole batch in ~0.3 s — route everything
            # through the device.
            qcfg_fly = dataclasses.replace(qcfg, dense_probe_min_count=0)
            eng8 = NormQueryEngine(data8, index=index8, icfg=icfg,
                                   qcfg=qcfg_fly, device_data=data_dev8)
            # warm with the FULL batch: probe programs are shape-keyed on Q,
            # so a smaller warmup leaves the real program's compile inside
            # the timed region (engine repeats do not memoize)
            eng8.query_batch(q8, 4.0, alpha=1.2, beta=5.0)
            qps_reps = []
            for _ in range(3):
                t0 = time.perf_counter()
                r8 = eng8.query_batch(q8, 4.0, alpha=1.2, beta=5.0)
                qps_reps.append(round(8 / (time.perf_counter() - t0), 2))
            northstar["cnsm_ed_1e8_qps"] = statistics.median(qps_reps)
            northstar["cnsm_ed_1e8_qps_reps"] = qps_reps
            northstar["cnsm_ed_1e8_self_found"] = sum(
                1 for o, r in zip(offs8, r8) if int(o) in r.offsets.tolist())
            northstar["cnsm_ed_1e8_cands_per_query"] = int(
                np.mean([r.stats.n_candidates for r in r8]))
            northstar["cnsm_ed_1e8_p1_ms"] = round(float(
                np.mean([r.stats.t_phase1_ms for r in r8])), 1)
            northstar["cnsm_ed_1e8_p2_ms"] = round(float(
                np.mean([r.stats.t_phase2_ms for r in r8])), 1)
            # probe-pass wall time at Q=8
            from kvmatch_tpu.engine.base import QueryStats as _QS, _Ctx as _C
            ctxs8 = [
                _C(query=q8[i], length=L, epsilon=4.0, eps2=16.0,
                   params={"alpha": 1.2, "beta": 5.0}, stats=_QS())
                for i in range(8)]
            plans8 = eng8._plan_batch(ctxs8)
            t0 = time.perf_counter()
            eng8._device_dense_phase1_flags(ctxs8, plans8)
            northstar["probe_pass_s_q8"] = round(time.perf_counter() - t0, 3)
            # measured scalar-C twin at the SAME shape over a host-built
            # index (the twin's phase 1 needs host intervals; the serving
            # index holds none).  One query — minutes of single-thread time;
            # the ratio is the point.
            t0 = time.perf_counter()
            index8h = _hbuild(data8, icfg, backend="host")
            northstar["host_build_s_for_twin"] = round(
                time.perf_counter() - t0, 1)
            twin8 = ScalarTwinNormEd(data8, index=index8h, icfg=icfg,
                                     qcfg=twin_cfg,
                                     device_data=eng8.data_dev)
            t0 = time.perf_counter()
            twin8.query(q8[0], 4.0, alpha=1.2, beta=5.0)
            northstar["twin_cnsm_1e8_ms"] = round(
                (time.perf_counter() - t0) * 1e3, 0)
            northstar["cnsm_1e8_speedup_vs_twin_measured"] = round(
                northstar["twin_cnsm_1e8_ms"]
                * northstar["cnsm_ed_1e8_qps"] / 1000.0, 2)
            del twin8, eng8, index8, index8h, data8, data_dev8
            gc.collect()

    def _r(x, nd=1):
        try:
            v = round(float(x), nd)
            return v if np.isfinite(v) else None
        except Exception:
            return None

    out = {
        "metric": "RSM-ED demo query latency (n=1e6, L=8192, eps=10, self-query)",
        "value": _r(demo_ms, 2),
        "unit": "ms",
        "vs_baseline": _r(BASELINE_DEMO_MS / demo_ms, 2),
        "extras": {
            "baseline_ms": BASELINE_DEMO_MS,
            "index_build_mpts_per_s": _r(build_mpts, 2),
            "index_memory_mb": _r(total_memory_bytes(index) / 1e6, 1),
            "rsm_ed_batch_qps": _r(rsm_qps, 1),
            "cnsm_ed_batch_qps": _r(cnsm_qps, 1),
            # per-repetition values for the headline metrics (run-to-run
            # spread must be visible in the artifact)
            "demo_ms_reps": demo_lat,
            "rsm_ed_batch_qps_reps": rsm_qps_reps,
            "cnsm_ed_batch_qps_reps": cnsm_qps_reps,
            "cnsm_dtw_batch_qps_reps": cd_qps_reps,
            "rsm_ed_batch_speedup_vs_ref_demo_rate": _r(
                rsm_qps / (1000.0 / BASELINE_DEMO_MS), 1),
            "ref_costmodel_rsm_qps_est": _r(ref_rsm_qps, 2),
            "ref_costmodel_cnsm_qps_est": _r(ref_cnsm_qps, 3),
            "rsm_speedup_vs_ref_costmodel": _r(rsm_qps / max(ref_rsm_qps, 1e-9), 1),
            "cnsm_speedup_vs_ref_costmodel": _r(cnsm_qps / max(ref_cnsm_qps, 1e-9), 1),
            # measured single-thread scalar-C twin of the reference (see
            # kvmatch_tpu/baseline_twin.py); ratios vs these are MEASURED
            # Caveat for the twin ratios: the twin REUSES this engine's
            # phase 0/1 (only phase 2 is the reference's scalar loop), so it
            # benefits from every host-side improvement here.
            "twin_note": "twin shares our phase 0/1",
            "twin_demo_ms_measured": _r(twin_demo_ms, 1),
            "twin_rsm_ms_per_query_measured": _r(twin_rsm_ms, 1),
            "twin_cnsm_ms_per_query_measured": _r(twin_cnsm_ms, 1),
            "twin_rsm_dtw_ms_measured": _r(twin_dtw_ms, 1),
            "demo_speedup_vs_twin_measured": _r(twin_demo_ms / demo_ms, 1),
            "rsm_batch_speedup_vs_twin_measured": _r(
                twin_rsm_ms * rsm_qps / 1000.0, 1),
            "cnsm_batch_speedup_vs_twin_measured": _r(
                twin_cnsm_ms * cnsm_qps / 1000.0, 1),
            "rsm_dtw_speedup_vs_twin_measured": _r(
                twin_dtw_ms / rsm_dtw_ms, 1),
            "rsm_dtw_query_ms": _r(rsm_dtw_ms, 1),
            "cnsm_dtw_batch_qps": _r(cnsm_dtw_qps, 3),
            "twin_cnsm_dtw_ms_measured": _r(twin_cnsm_dtw_ms, 0),
            "cnsm_dtw_speedup_vs_twin_measured": _r(
                twin_cnsm_dtw_ms * cnsm_dtw_qps / 1000.0, 1),
            "cnsm_dtw_host_rechecked": cd_rechecked,
            "northstar": northstar,
            "rsm_ed_device_batch_qps": _r(dev_qps, 1),
            "cnsm_ed_device_batch_qps": _r(ndev_qps, 1),
            "rsm_batch_p1_ms": _r(rsm_p1_ms, 2),
            "rsm_batch_p2_ms": _r(rsm_p2_ms, 2),
            "rsm_batch_candidates": rsm_cands,
            "rsm_batch_host_rechecked": rsm_near,
            "n": n,
            "device": {"platform": jax.devices()[0].platform,
                       "kind": jax.devices()[0].device_kind,
                       "count": len(jax.devices())},
            "section_errors": SECTION_ERRORS,
            # correctness fields appear ONLY for sections that actually ran
            # (a skipped section's "0/16" would read as 16 false dismissals)
            "correctness": {
                k: v for k, v, sec in [
                    ("demo_exact", demo_ok, "demo"),
                    ("rsm_batch_self_found", f"{found}/{nq}", "rsm_batch"),
                    ("cnsm_batch_self_found", f"{nfound}/{nq2}", "cnsm_batch"),
                    ("rsm_device_self_found", f"{dev_found}/{nq}",
                     "rsm_device_batch"),
                    ("cnsm_device_self_found", f"{ndev_found}/{nq2}",
                     "cnsm_device_batch"),
                    ("dtw_self_found", dtw_ok, "rsm_dtw"),
                    ("cnsm_dtw_batch_self_found", f"{cd_found}/{nq_cd}",
                     "cnsm_dtw"),
                ] if sec not in SECTION_ERRORS
            },
        },
    }
    print(json.dumps(out))
    return 1 if SECTION_ERRORS else 0


if __name__ == "__main__":
    sys.exit(main())
