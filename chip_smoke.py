#!/usr/bin/env python
"""Run the four engines on one GPU through their public entry points and
check every answer.

    python chip_smoke.py              # all phases, one card

Phases (one process, one card):

1. device   — fail unless JAX's first device is a GPU; print its kind and
              the card's name and power limit.
2. exact    — the CLI path (generate-data, build-index --backend device,
              query for all four engines) at n=1e6; answer sets must EQUAL
              kvmatch_tpu/oracle.py.
3. real     — n=1e8 series resident on the card: both device index builds,
              then every engine on a few queries (cNSM-ED as a Q=8 batch
              through the device dense probe).  Self-queries must find their
              own offset, every answer is re-checked in float64 on the host,
              and one L=1024 query per ED engine must equal the oracle.
4. kernels  — each hand-written kernel against its plain reference at the
              engines' widths, with the tolerance printed; the FFT error
              constant and the double-single DTW confirm re-measured.

Any failed check raises, so the process exits non-zero.  The last line of
standard output is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import contextlib
import dataclasses
import io
import json
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import numpy as np

HERE = Path(__file__).resolve().parent
PHASES = ("device", "exact", "real", "kernels")
N_EXACT = 1_000_000            # largest n where the host oracle takes minutes
N_BIG = 100_000_000            # the reference's evaluation scale


def log(msg: str) -> None:
    print(msg, flush=True)


class Check(Exception):
    """A smoke check failed."""


def require(ok: bool, what: str) -> None:
    if not ok:
        raise Check(what)


# --------------------------------------------------------------- bookkeeping
class CompileClock:
    """Sums XLA backend-compile seconds reported by JAX."""

    def __init__(self):
        import jax.monitoring

        self.total = 0.0

        def on_event(name, secs, **_):
            if name == "/jax/core/compile/backend_compile_duration":
                self.total += secs

        jax.monitoring.register_event_duration_secs_listener(on_event)


def device_report(dev, clock: CompileClock, label: str) -> None:
    stats = dev.memory_stats() or {}
    log(f"[{label}] compile_s={clock.total:.1f} "
        f"peak_bytes_in_use={stats.get('peak_bytes_in_use')}")


# ------------------------------------------------------------- host checks
def check_ed_answers(data, q, offs, dists, eps):
    """Re-check ED answers in float64: distance <= eps and as reported."""
    from kvmatch_tpu import oracle
    d2 = oracle._exact_ed(data, np.asarray(q, np.float64), np.asarray(offs))
    require(bool(np.all(d2 <= eps * eps)), "ED answer above epsilon")
    require(bool(np.allclose(np.sqrt(d2), dists, rtol=1e-9, atol=1e-9)),
            "ED answer distance differs from float64")


def check_nsm_answers(data, q, offs, dists, eps, alpha, beta):
    L = q.size
    mu_q = q.mean()
    sd_q = np.sqrt(max((q * q).mean() - mu_q * mu_q, 0.0))
    zq = (q - mu_q) / sd_q
    for o, d in zip(np.asarray(offs), np.asarray(dists)):
        w = data[o:o + L]
        mu = w.mean()
        sd = np.sqrt(max((w * w).mean() - mu * mu, 0.0))
        require(sd > 0 and abs(mu - mu_q) <= beta
                and 1.0 / alpha <= sd / sd_q <= alpha,
                f"cNSM answer {o} violates the alpha/beta constraint")
        d2 = float(np.sum(((w - mu) / sd - zq) ** 2))
        require(d2 <= eps * eps + 1e-9 * L, f"cNSM answer {o} above epsilon")
        require(abs(np.sqrt(d2) - d) <= 1e-6 * (1 + d),
                f"cNSM answer {o} distance differs from float64")


def check_dtw_answers(data, q, offs, dists, eps, rho, norm=False):
    """Re-check DTW answers with the float64 DP (all host cores)."""
    from kvmatch_tpu import oracle
    offs = np.asarray(offs)
    if offs.size == 0:
        return
    L = q.size
    qq = np.asarray(q, np.float64)
    cols = np.arange(L)[None, :]

    def windows_of(ci):
        w = data[ci[:, None] + cols]
        if not norm:
            return w
        mu = w.mean(axis=1, keepdims=True)
        sd = np.sqrt(np.maximum((w * w).mean(axis=1, keepdims=True) - mu * mu,
                                0.0))
        return (w - mu) / sd

    if norm:
        mq = qq.mean()
        qq = (qq - mq) / np.sqrt(max((qq * qq).mean() - mq * mq, 0.0))
    order = np.argsort(offs)
    got, d64 = oracle._dtw_chunks(windows_of, offs[order], qq, eps, rho, L)
    require(np.array_equal(got, offs[order]), "DTW answer above epsilon")
    # Answers accepted by the double-single device confirm report its value,
    # which carries the f32 rounding of the window (verify.ds_guard).
    rep = np.asarray(dists)[order]
    require(bool(np.all(np.abs(rep ** 2 - d64 ** 2) <= 1e-3 * (1.0 + d64 ** 2))),
            "DTW answer distance differs from float64 beyond 1e-3 relative")


def same_set(got, want, what: str) -> None:
    got, want = set(np.asarray(got).tolist()), set(np.asarray(want).tolist())
    require(got == want,
            f"{what}: {len(got)} answers vs oracle {len(want)} "
            f"(missing {sorted(want - got)[:5]}, extra {sorted(got - want)[:5]})")


# -------------------------------------------------------------- 1. device
def phase_device():
    import jax

    devs = jax.devices()
    dev = devs[0]
    require(dev.platform == "gpu", f"no GPU: JAX's device is {dev.platform}")
    smi = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True, text=True, timeout=60)
    require(smi.returncode == 0, f"nvidia-smi failed: {smi.stderr.strip()}")
    log(f"[device] {dev.device_kind} x{len(devs)}")
    log(f"[device] nvidia-smi: {smi.stdout.strip().splitlines()[0]}")
    return dev


# ------------------------------------------------------------- 2. exactness
EXACT_CASES = (
    # (engine, 0-based offset, L, eps, extra CLI args, oracle params)
    ("rsm-ed", 123455, 8192, 10.0, [], {}),           # README demo
    ("rsm-ed", 54321, 2048, 8.0, [], {}),
    ("cnsm-ed", 7000, 1024, 4.0, ["--alpha", "1.2", "--beta", "5"],
     {"alpha": 1.2, "beta": 5.0}),
    ("rsm-dtw", 54321, 1024, 6.0, ["--rho", "0.05"], {"rho": 51}),
    ("cnsm-dtw", 7000, 512, 3.0,
     ["--rho", "0.05", "--alpha", "1.3", "--beta", "10"],
     {"rho": 25, "alpha": 1.3, "beta": 10.0}),
    ("cnsm-dtw", 1000, 1024, 4.0,
     ["--rho", "0.05", "--alpha", "1.2", "--beta", "5"],
     {"rho": 51, "alpha": 1.2, "beta": 5.0}),
)


def oracle_answers(engine: str, data, q, eps, p):
    from kvmatch_tpu import oracle
    if engine == "rsm-ed":
        return oracle.rsm_ed(data, q, eps)[0]
    if engine == "cnsm-ed":
        return oracle.nsm_ed(data, q, eps, p["alpha"], p["beta"])[0]
    if engine == "rsm-dtw":
        return oracle.rsm_dtw(data, q, eps, p["rho"])[0]
    return oracle.cnsm_dtw(data, q, eps, p["rho"], p["alpha"], p["beta"])[0]


def run_cli(argv) -> str:
    from kvmatch_tpu import cli
    buf = io.StringIO()
    with contextlib.redirect_stdout(buf):
        rc = cli.main(argv)
    require(rc == 0, f"cli {argv[0]} returned {rc}")
    return buf.getvalue()


def phase_exact(n: int, workdir: Path):
    from kvmatch_tpu.cli import _load_data
    data_path = str(workdir / f"data-{n}")
    idx_path = str(workdir / f"index-{n}.npz")
    t0 = time.perf_counter()
    run_cli(["generate-data", str(n), "--seed", "5", "--out", data_path])
    out = run_cli(["build-index", data_path, "--out", idx_path,
                   "--backend", "device"])
    log(f"[exact] n={n} build-index {time.perf_counter() - t0:.1f}s: "
        f"{out.strip().splitlines()[-1]}")
    data = _load_data(data_path)
    for engine, off, L, eps, extra, p in EXACT_CASES:
        t0 = time.perf_counter()
        out = run_cli(["query", data_path, "--index", idx_path,
                       "--engine", engine, "--offset", str(off),
                       "--length", str(L), "--epsilon", str(eps), *extra])
        t_q = time.perf_counter() - t0
        got = [int(line.split(",")[0]) for line in out.splitlines()
               if line[:1].isdigit()]
        t0 = time.perf_counter()
        want = oracle_answers(engine, data, data[off:off + L], eps, p)
        same_set(got, want, f"{engine} L={L} off={off}")
        require(off in got, f"{engine} L={L}: self-match {off} missing")
        log(f"[exact] {engine} L={L} eps={eps}: {len(got)} answers == "
            f"oracle (query {t_q:.1f}s, oracle "
            f"{time.perf_counter() - t0:.1f}s)")


# ------------------------------------------------------------ 3. real size
@dataclasses.dataclass
class Big:
    data: np.ndarray
    data_dev: object
    index_stats: object
    index_full: object


def make_big(n: int) -> Big:
    import jax.numpy as jnp
    from kvmatch_tpu.config import IndexConfig
    from kvmatch_tpu.data.generators import generate_series
    from kvmatch_tpu.index.build import build_index_tpu
    from kvmatch_tpu.index.device_build import build_index_device_stats

    icfg = IndexConfig()
    t0 = time.perf_counter()
    data = generate_series(n, seed=20260817)
    data_dev = jnp.asarray(data, jnp.float32)
    data_dev.block_until_ready()
    log(f"[real] n={n} generated + resident in {time.perf_counter() - t0:.1f}s")
    for rep in ("cold", "warm"):
        st: dict = {}
        index_stats = build_index_device_stats(data, icfg, stats=st,
                                               data_dev=data_dev)
        log(f"[real] build_index_device_stats ({rep}): "
            f"{st['build_seconds']:.2f}s, {st['mpts_per_second']:.1f} Mpts/s")
    st = {}
    index_full = build_index_tpu(data, icfg, stats=st, backend="device")
    log(f"[real] build_index_tpu(backend='device'): {st['build_seconds']:.1f}s,"
        f" {st['mpts_per_second']:.1f} Mpts/s")
    return Big(data, data_dev, index_stats, index_full)


def self_queries(data, L, k, seed):
    rng = np.random.default_rng(seed)
    offs = rng.integers(0, data.size - L, k)
    return offs, np.stack([data[o:o + L] for o in offs])


def timed_batch(fn, *args, **kw):
    t0 = time.perf_counter()
    res = fn(*args, **kw)
    return res, time.perf_counter() - t0


def phase_real(big: Big, dev, clock: CompileClock):
    from kvmatch_tpu import oracle
    from kvmatch_tpu.config import IndexConfig, QueryConfig
    from kvmatch_tpu.engine.norm_dtw import NormQueryEngineDtw
    from kvmatch_tpu.engine.norm_ed import NormQueryEngine
    from kvmatch_tpu.engine.rsm_dtw import QueryEngineDtw
    from kvmatch_tpu.engine.rsm_ed import QueryEngine

    icfg, data = IndexConfig(), big.data
    qcfg = QueryConfig.tuned()
    dense = dataclasses.replace(qcfg, dense_probe_min_count=0)

    # RSM-ED, L=LONG, eps=10: host phase 1 over the full index.
    eng = QueryEngine(data, index=big.index_full, icfg=icfg, qcfg=qcfg,
                      device_data=big.data_dev)
    offs, qs = self_queries(data, LONG, 4, 1)
    eng.query_batch(qs, 10.0)
    res, dt = timed_batch(eng.query_batch, qs, 10.0)
    for o, q, r in zip(offs, qs, res):
        require(int(o) in r.offsets.tolist(), f"RSM-ED lost self-match {o}")
        check_ed_answers(data, q, r.offsets, r.distances, 10.0)
    log(f"[real] rsm-ed L={LONG} Q=4: {dt:.2f}s warm, answers "
        f"{[int(r.stats.n_answers) for r in res]}, candidates "
        f"{[int(r.stats.n_candidates) for r in res]}")
    # one L=SHORT query against the float64 oracle over all n windows
    o1 = data.size * 314 // 1000
    q1 = data[o1:o1 + SHORT]
    r1 = eng.query(q1, 8.0)
    same_set(r1.offsets, oracle.rsm_ed_fft(data, q1, 8.0)[0],
             f"rsm-ed n={data.size} L={SHORT}")
    log(f"[real] rsm-ed L={SHORT} eps=8: {r1.stats.n_answers} answers == oracle")
    device_report(dev, clock, "real rsm-ed")

    # cNSM-ED, L=LONG, alpha=1.2, beta=5, eps=4, Q=8 via the device probe.
    neng = NormQueryEngine(data, index=big.index_stats, icfg=icfg, qcfg=dense,
                           device_data=big.data_dev)
    offs, qs = self_queries(data, LONG, 8, 2)
    kw = dict(alpha=1.2, beta=5.0)
    neng.query_batch(qs, 4.0, **kw)
    res, dt = timed_batch(neng.query_batch, qs, 4.0, **kw)
    for o, q, r in zip(offs, qs, res):
        require(int(o) in r.offsets.tolist(), f"cNSM-ED lost self-match {o}")
        check_nsm_answers(data, q, r.offsets, r.distances, 4.0, **kw)
    log(f"[real] cnsm-ed L={LONG} Q=8: {dt:.2f}s warm, answers "
        f"{[int(r.stats.n_answers) for r in res]}, candidates "
        f"{[int(r.stats.n_candidates) for r in res]}")
    r1 = neng.query_batch(data[o1:o1 + SHORT][None], 4.0, **kw)[0]
    same_set(r1.offsets,
             oracle.nsm_ed_fft(data, data[o1:o1 + SHORT], 4.0, **kw)[0],
             f"cnsm-ed n={data.size} L={SHORT}")
    log(f"[real] cnsm-ed L={SHORT} eps=4: {r1.stats.n_answers} answers == oracle")
    device_report(dev, clock, "real cnsm-ed")

    # RSM-DTW, L=SHORT, rho=0.05 L.
    deng = QueryEngineDtw(data, index=big.index_full, icfg=icfg, qcfg=qcfg,
                          device_data=big.data_dev)
    offs, qs = self_queries(data, SHORT, 2, 3)
    deng.query(qs[0], RSM_DTW_EPS, rho=SHORT // 20)  # compiles
    for o, q in zip(offs, qs):
        r, dt = timed_batch(deng.query, q, RSM_DTW_EPS, rho=SHORT // 20)
        require(int(o) in r.offsets.tolist(), f"RSM-DTW lost self-match {o}")
        check_dtw_answers(data, q, r.offsets, r.distances, RSM_DTW_EPS,
                          SHORT // 20)
        log(f"[real] rsm-dtw L={SHORT} rho={SHORT // 20} eps={RSM_DTW_EPS}: {dt:.2f}s, "
            f"{r.stats.n_answers} answers, {r.stats.n_candidates} candidates")
    device_report(dev, clock, "real rsm-dtw")

    # cNSM-DTW, L=LONG, rho=0.05 L.
    cdeng = NormQueryEngineDtw(data, index=big.index_full, icfg=icfg,
                               qcfg=qcfg, device_data=big.data_dev)
    offs, qs = self_queries(data, LONG, 2, 4)
    kw = dict(rho=LONG // 20, alpha=1.2, beta=5.0)
    cdeng.query_batch(qs, CNSM_DTW_EPS, **kw)
    res, dt = timed_batch(cdeng.query_batch, qs, CNSM_DTW_EPS, **kw)
    for o, q, r in zip(offs, qs, res):
        require(int(o) in r.offsets.tolist(), f"cNSM-DTW lost self-match {o}")
        check_dtw_answers(data, q, r.offsets, r.distances, CNSM_DTW_EPS,
                          LONG // 20, norm=True)
    log(f"[real] cnsm-dtw L={LONG} rho={LONG // 20} eps={CNSM_DTW_EPS} Q=2: {dt:.2f}s "
        f"warm, answers {[int(r.stats.n_answers) for r in res]}, candidates "
        f"{[int(r.stats.n_candidates) for r in res]}")
    device_report(dev, clock, "real cnsm-dtw")
    return neng


RSM_DTW_EPS = 3.0
CNSM_DTW_EPS = 4.0
LONG, SHORT = 8192, 1024       # query lengths of the real-size phase


# -------------------------------------------------------------- 4. kernels
def phase_kernels(big: Big, neng, dev):
    import jax.numpy as jnp
    from kvmatch_tpu import verify as vf
    from kvmatch_tpu.config import IndexConfig, QueryConfig
    from kvmatch_tpu.engine.base import QueryStats, _Ctx
    from kvmatch_tpu.engine.rsm_ed import QueryEngine
    from kvmatch_tpu.ops import dtw as dtw_ops
    from kvmatch_tpu.ops.dtw_cuda import dtw_banded_cuda
    from kvmatch_tpu.ops.probe_pallas import FLAG
    from kvmatch_tpu.ops.regions import FFT_ERR_C, _correlate
    from kvmatch_tpu.parallel.query import (make_dense_probe_step_flags,
                                            make_dense_probe_step_flags_pallas,
                                            pack_segments_batch)

    icfg, data = IndexConfig(), big.data
    rng = np.random.default_rng(9)

    # Probe kernel vs the XLA flags step on the n=1e8 stack, Q=8, L=8192.
    L = 8192
    reng = QueryEngine(data, index=big.index_stats, icfg=icfg,
                       qcfg=neng.qcfg, device_data=big.data_dev)
    for norm in (False, True):
        offs, qs = self_queries(data, L, 8, 5)
        params = {"alpha": 1.2, "beta": 5.0} if norm else {}
        eps = 4.0 if norm else 10.0
        ctxs = [_Ctx(query=q, length=L, epsilon=eps, eps2=eps * eps,
                     params=dict(params), stats=QueryStats()) for q in qs]
        plans = (neng if norm else reng)._plan_batch(ctxs)
        segs = pack_segments_batch(plans, tuple(icfg.scales))
        eps2 = jnp.full(8, eps * eps, jnp.float32)
        cons = (jnp.asarray([[c.params["alpha"], c.params["beta"],
                              c.params["_mu_q"], c.params["_sd_q"]]
                             for c in ctxs], jnp.float32) if norm
                else jnp.zeros((8, 4), jnp.float32))
        data_p = neng._fly_padded_dev(L)
        bstack3 = neng._fly_bucket_stack(L)
        stats3 = neng._fly_cons_stats(L) if norm else None
        ker = make_dense_probe_step_flags_pallas(
            icfg, L, norm=norm, cached_stats=norm, cached_buckets=True)
        xla = make_dense_probe_step_flags(icfg, L, flag_block=2 * FLAG,
                                          norm=norm)
        nk, fk = (np.asarray(a) for a in ker(data_p, segs, eps2, cons,
                                             jnp.int32(big.data.size),
                                             stats3=stats3, bstack3=bstack3))
        nx, fx = (np.asarray(a) for a in xla(data_p, segs, eps2, cons,
                                             jnp.int32(big.data.size)))
        log(f"[kernels] probe norm={norm}: kernel counts {nk.tolist()}")
        log(f"[kernels] probe norm={norm}: xla    counts {nx.tolist()}")
        require(np.array_equal(nk, nx), "probe kernel counts differ from XLA")
        k = min(fk.shape[1] // 2, fx.shape[1])
        fk2 = fk[:, :2 * k].reshape(8, k, 2).any(axis=2)
        if norm:
            # the kernel step also ANDs the alpha/beta constraint: subset
            require(not (fk2 & ~fx[:, :k]).any(), "probe kernel flags extra")
        else:
            require(np.array_equal(fk2, fx[:, :k]), "probe kernel flags differ")
        for qi, o in enumerate(offs):
            require(bool(fk[qi, o // FLAG]), "probe kernel dropped self-match")
        log(f"[kernels] probe norm={norm}: flags == XLA at 256 (tolerance: "
            f"counts equal, {'subset' if norm else 'equal'} flags)")

    # DTW kernel vs the float64 DP, and vs the XLA form, at the engines'
    # widths.  Tolerance: the engines' f32 guard above the float64 value.
    guard = QueryConfig().verify_guard
    for L, r, B in ((1024, 51, 512), (8192, 409, 128)):
        offs = rng.integers(0, data.size - L, B)
        w = data[offs[:, None] + np.arange(L)[None, :]].astype(np.float32)
        q = data[:L].astype(np.float32)
        qids = jnp.zeros(B, jnp.int32)
        got = np.asarray(dtw_banded_cuda(jnp.asarray(w), jnp.asarray(q[None]),
                                         qids, r), np.float64)
        ref = dtw_ops.dtw_banded_batch_f64(w.astype(np.float64),
                                           q.astype(np.float64), r)
        xla = np.asarray(dtw_ops.dtw_banded_batch_multi(
            jnp.asarray(w), jnp.broadcast_to(jnp.asarray(q), (B, L)), r),
            np.float64)
        tol = np.array([vf.guard_threshold(d, L, guard) for d in ref])
        err_k = np.abs(got - ref) / tol
        err_x = np.abs(xla - ref) / tol
        log(f"[kernels] dtw L={L} r={r} B={B}: max |cuda-f64| / tol = "
            f"{err_k.max():.3e}, max |xla-f64| / tol = {err_x.max():.3e}, "
            f"max rel |cuda-f64|/f64 = {np.max(np.abs(got - ref) / ref):.3e}; "
            f"tol = guard_threshold(d2, L, {guard}) = {guard}*(d2+1)+1e-4*L")
        require(bool(np.all(err_k <= 1.0)), "CUDA DTW outside the f32 guard")

    # Double-single confirm vs the float64 DP on the same f32 inputs.
    L, r, B = 8192, 409, 64
    offs = rng.integers(0, data.size - L, B)
    qm = jnp.asarray(data[:L][None], jnp.float32)
    hi, lo, amax = dtw_ops.dtw_stage_ds_multi(
        big.data_dev, qm, jnp.asarray(offs, jnp.int32),
        jnp.zeros(B, jnp.int32), L, r)
    ds = dtw_ops.ds_value(hi, lo)
    w = data[offs[:, None] + np.arange(L)[None, :]].astype(np.float32)
    ref = dtw_ops.dtw_banded_batch_f64(w.astype(np.float64),
                                       np.asarray(qm[0], np.float64), r)
    rel = np.abs(ds - ref) / np.maximum(ref, 1e-30)
    dsg = vf.ds_guard(ref, L, np.asarray(amax, np.float64))
    log(f"[kernels] ds-confirm L={L} r={r}: max rel err {rel.max():.3e} "
        f"(f32 cell rounding 2^-24 = {2.0 ** -24:.3e}); max |ds-f64| / "
        f"ds_guard = {np.max(np.abs(ds - ref) / dsg):.3e}")
    require(bool(np.all(np.abs(ds - ref) <= dsg)), "DS confirm outside ds_guard")

    # cuFFT correlation error vs float64 at the region widths the engines
    # launch (FFT length up to 16384 at L=8192).
    worst = 0.0
    for L, M in ((1024, 512), (1024, 1024), (8192, 512), (8192, 8192)):
        R = M + L - 1
        N = 1 << int(np.ceil(np.log2(R)))
        starts = rng.integers(0, data.size - R, 64)
        x32 = data[starts[:, None] + np.arange(R)[None, :]].astype(np.float32)
        q32 = (data[:L] - data[:L].mean()).astype(np.float32)
        c32 = np.asarray(_correlate(jnp.asarray(x32), jnp.asarray(q32)),
                         np.float64)
        x64, q64 = x32.astype(np.float64), q32.astype(np.float64)
        c64 = np.fft.irfft(np.fft.rfft(x64, N) * np.fft.rfft(q64[::-1], N)[None],
                           N)[:, L - 1:R]
        cs = np.concatenate([np.zeros((64, 1)), np.cumsum(x64 * x64, axis=1)],
                            axis=1)
        s2 = cs[:, L:] - cs[:, :-L]
        rel = np.abs(c32 - c64) / np.sqrt(s2 * float(q64 @ q64))
        worst = max(worst, float(rel.max()))
        log(f"[kernels] fft corr L={L} M={M} N={N}: max "
            f"|err|/(||x|| ||q||) = {rel.max():.3e}")
    log(f"[kernels] FFT_ERR_C = {FFT_ERR_C:.1e}, measured max {worst:.3e}")
    require(worst * 10 <= FFT_ERR_C, "FFT error constant lacks a 10x margin")


# ---------------------------------------------------------------------- main
def main() -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    ap.add_argument("--phases", default=",".join(PHASES),
                    help="comma-separated subset of " + ",".join(PHASES))
    args = ap.parse_args()
    phases = set(args.phases.split(","))
    require(phases <= set(PHASES), f"unknown phase in {args.phases}")

    sys.path.insert(0, str(HERE))
    from kvmatch_tpu.utils.compile_cache import enable_compile_cache

    import jax

    enable_compile_cache()
    clock = CompileClock()
    dev = phase_device()
    if "exact" in phases:
        with tempfile.TemporaryDirectory() as tmp:
            phase_exact(N_EXACT, Path(tmp))
        device_report(dev, clock, "exact")
    big = neng = None
    if phases & {"real", "kernels"}:
        big = make_big(N_BIG)
        device_report(dev, clock, "build")
    if "real" in phases:
        neng = phase_real(big, dev, clock)
    if "kernels" in phases:
        if neng is None:
            from kvmatch_tpu.config import IndexConfig, QueryConfig
            from kvmatch_tpu.engine.norm_ed import NormQueryEngine
            neng = NormQueryEngine(big.data, index=big.index_stats,
                                   icfg=IndexConfig(),
                                   qcfg=QueryConfig.tuned(),
                                   device_data=big.data_dev)
        phase_kernels(big, neng, dev)
        device_report(dev, clock, "kernels")
    devs = jax.devices()
    print(json.dumps({"ok": True, "device": {
        "platform": devs[0].platform, "kind": devs[0].device_kind,
        "count": len(devs)}}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
