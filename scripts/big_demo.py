#!/usr/bin/env python
"""Single-chip demo at n >= 1e10 — the reference's LongRandomQueryTest scales
(mapreduce/experiments/LongRandomQueryTest.java:33-50 runs n = 10^10..10^12 on
a Hadoop/HBase cluster; here one chip + one host).

Pipeline:
  1. chunked synthetic generation (independent seeded segments, matching the
     reference generator's segment-concatenation design) into ONE f32 host
     array (no f64 shadow: 1e10 points = 40 GB);
  2. StreamingIndexBuilder over the f64 chunks (scale subset, reference-default
     d=0.5 via pos_of_d=1) — global row merge, int64 positions;
  3. engines in device_data='stream' mode: host phase 0/1 over the int64
     index, phase 2 stages candidate regions H2D and runs the device cascade.

Usage: python scripts/big_demo.py [--n 10000000000] [--queries 4]
Prints one JSON line per section.

Persistence: --save-dir writes data (raw f32) + index (npz) after the build so
a later --resume-dir run skips the ingest+build.  Everything runs in one
process, the only one that opens the device.
"""
import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, ".")


def log(**kw):
    print(json.dumps(kw), flush=True)


def main():
    ap = argparse.ArgumentParser()
    ap.add_argument("--n", type=int, default=10_000_000_000)
    ap.add_argument("--chunk", type=int, default=250_000_000)
    ap.add_argument("--queries", type=int, default=4)
    ap.add_argument("--length", type=int, default=8192)
    ap.add_argument("--eps-ed", type=float, default=10.0)
    ap.add_argument("--eps-cnsm", type=float, default=4.0)
    ap.add_argument("--pos-of-d", type=int, default=1)  # d = 0.5 (ref default)
    ap.add_argument("--dtw", action="store_true",
                    help="also run one cNSM-DTW self-query")
    ap.add_argument("--save-dir", default=None,
                    help="persist data+index here after the build")
    ap.add_argument("--resume-dir", default=None,
                    help="skip ingest+build; load data+index from this dir")
    ap.add_argument("--build-only", action="store_true",
                    help="stop after the build (and --save-dir)")
    ap.add_argument("--host-only", action="store_true",
                    help="run the query section with NO device at all: "
                         "host phase 1 + the exact-f64 host verify route; "
                         "queries whose candidate load exceeds "
                         "host_verify_max_points are skipped with a log line")
    args = ap.parse_args()

    from kvmatch_tpu.config import IndexConfig, QueryConfig
    from kvmatch_tpu.data.generators import generate_series
    from kvmatch_tpu.index.streaming import StreamingIndexBuilder
    from kvmatch_tpu.index.structure import total_memory_bytes
    from kvmatch_tpu.storage.file import IndexNpzStore

    n = args.n
    # Scale subset {100, 400}: unit 100 serves L >= 100; fewer/wider scales
    # keep the interval count (and host RAM) bounded at n=1e10.  wu_list must
    # be the dense unit*k ladder with an enabled mask (reference WuList form).
    icfg = IndexConfig(wu_list=(100, 200, 300, 400),
                       wu_enabled=(True, False, False, True),
                       pos_of_d=args.pos_of_d)
    log(section="config", n=n, scales=list(icfg.scales), d=icfg.d,
        length=args.length)

    if args.resume_dir:
        t0 = time.perf_counter()
        data32 = np.lib.format.open_memmap(
            os.path.join(args.resume_dir, "data32.npy"), mode="r")
        n = args.n = data32.shape[0]
        index = IndexNpzStore(
            os.path.join(args.resume_dir, "index.npz")).load()
        log(section="resume", sec=round(time.perf_counter() - t0, 1),
            n=n, index_gb=round(total_memory_bytes(index) / 1e9, 2))
    else:
        data32 = np.empty(n, np.float32)
        builder = StreamingIndexBuilder(icfg)
        t0 = time.perf_counter()
        t_gen = t_append = 0.0
        pos = 0
        i = 0
        while pos < n:
            m = min(args.chunk, n - pos)
            t1 = time.perf_counter()
            chunk = generate_series(m, seed=910_000 + i)
            t2 = time.perf_counter()
            builder.append(chunk)
            t3 = time.perf_counter()
            data32[pos:pos + m] = chunk
            t_gen += t2 - t1
            t_append += t3 - t2
            pos += m
            i += 1
            if i % 8 == 0:
                log(section="progress", pts=pos, gen_s=round(t_gen, 1),
                    append_s=round(t_append, 1))
        del chunk
        log(section="ingest", sec=round(time.perf_counter() - t0, 1),
            gen_s=round(t_gen, 1), append_s=round(t_append, 1),
            append_mpts_per_s=round(n * len(icfg.scales) / max(t_append, 1e-9)
                                    / 1e6, 1))

        t0 = time.perf_counter()
        index = builder.build()
        build_s = time.perf_counter() - t0
        log(section="build", sec=round(build_s, 1),
            total_mpts_per_s=round(n * len(icfg.scales)
                                   / max(t_append + build_s, 1e-9) / 1e6, 1),
            rows={w: int(s.keys.size) for w, s in index.items()},
            intervals={w: int(s.num_intervals) for w, s in index.items()},
            index_gb=round(total_memory_bytes(index) / 1e9, 2))
        # Drop the builder's run caches before querying (tens of GB at 1e10).
        del builder

        if args.save_dir:
            t0 = time.perf_counter()
            os.makedirs(args.save_dir, exist_ok=True)
            mm = np.lib.format.open_memmap(
                os.path.join(args.save_dir, "data32.npy"), mode="w+",
                dtype=np.float32, shape=(n,))
            mm[:] = data32
            mm.flush()
            del mm
            IndexNpzStore(os.path.join(args.save_dir, "index.npz")).save(index)
            log(section="saved", dir=args.save_dir,
                sec=round(time.perf_counter() - t0, 1))

    mode = "stream"
    if args.host_only:
        mode = "host"
        log(section="host_only", note="no device; tiny-load exact-f64 route")
    else:
        if args.build_only:
            log(section="done", mode="build-only")
            return
        from kvmatch_tpu.utils.compile_cache import enable_compile_cache
        enable_compile_cache()

    from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu.engine.rsm_ed import QueryEngine

    qcfg = QueryConfig.tuned()
    if args.host_only:
        # Allow bigger loads on the exact host route before bailing: 64M
        # points ~= 0.5 GB of f32 window reads per query.
        import dataclasses
        qcfg = dataclasses.replace(qcfg, host_verify_max_points=1 << 26)
    rng = np.random.default_rng(7)
    offs = np.sort(rng.integers(0, n - args.length, args.queries))
    L = args.length

    def run_query(section, eng, off, **kw):
        q = data32[off:off + L].astype(np.float64)
        t0 = time.perf_counter()
        try:
            r = eng.query(q, **kw)
        except RuntimeError as exc:  # host-only overflow: skip, keep going
            log(section=section, offset=off, skipped=str(exc)[:140])
            return
        log(section=section, offset=off,
            ms=round((time.perf_counter() - t0) * 1e3, 1),
            found=bool(off in r.offsets.tolist()),
            answers=int(r.stats.n_answers), cands=int(r.stats.n_candidates),
            p1_ms=round(r.stats.t_phase1_ms, 1),
            p2_ms=round(r.stats.t_phase2_ms, 1))

    eng = QueryEngine(data32, index=index, icfg=icfg, qcfg=qcfg,
                      device_data=mode)
    for tag, off in [("warm", int(offs[0]))] + \
            [(f"q{j}", int(o)) for j, o in enumerate(offs)]:
        run_query(f"rsm_ed_{tag}", eng, off, epsilon=args.eps_ed)

    neng = NormQueryEngine(data32, index=index, icfg=icfg, qcfg=qcfg,
                           device_data=mode)
    for tag, off in [("warm", int(offs[0]))] + \
            [(f"q{j}", int(o)) for j, o in enumerate(offs)]:
        run_query(f"cnsm_ed_{tag}", neng, off, epsilon=args.eps_cnsm,
                  alpha=1.2, beta=5.0)

    if args.dtw:
        deng = NormQueryEngineDtw(data32, index=index, icfg=icfg, qcfg=qcfg,
                                  device_data=mode)
        for tag, off in [(f"q{j}", int(o)) for j, o in enumerate(offs)]:
            run_query(f"cnsm_dtw_{tag}", deng, off, epsilon=args.eps_cnsm,
                      rho=int(0.05 * L), alpha=1.2, beta=5.0)
    log(section="done")


if __name__ == "__main__":
    main()
