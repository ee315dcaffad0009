#!/usr/bin/env python
"""Measure the true f32 banded-DTW DP error vs the f64 twin.

The phase-2 DTW guard decides which near-threshold candidates get the exact
(expensive) f64 confirmation; a guard of 1e-2*(eps2+1) + 1e-4*L has an
absolute term ~50x the actual f32 error scale.  This script measures
max |d2_f32 - d2_f64| across adversarial batches — z-normalized and raw
windows, random-walk and sine data, multiple (L, rho) — against the
L*eps32-scaled bound the tightened guard will use, on whichever backend JAX
picks (run once with --cpu and once on the GPU).
"""
import os
import sys

import numpy as np

if "--cpu" in sys.argv:
    os.environ["JAX_PLATFORMS"] = "cpu"
    import jax
    jax.config.update("jax_platforms", "cpu")
else:
    import jax

import jax.numpy as jnp  # noqa: E402

sys.path.insert(0, os.path.join(os.path.dirname(os.path.abspath(__file__)), ".."))
from kvmatch_tpu.ops.dtw import (dtw_banded_batch_multi,  # noqa: E402
                                 dtw_banded_batch_ds_multi, ds_value,
                                 _dtw_banded_batch_f64_np)

EPS32 = float(np.finfo(np.float32).eps)  # 2^-23


def series(kind, n, rng):
    if kind == "walk":
        return np.cumsum(rng.standard_normal(n) * 0.5)
    if kind == "sine":
        t = np.arange(n)
        return 5 * np.sin(2 * np.pi * t / 97) + 0.2 * rng.standard_normal(n)
    if kind == "spiky":
        x = rng.standard_normal(n)
        x[rng.integers(0, n, n // 50)] *= 40
        return x
    raise ValueError(kind)


def main():
    print("backend:", jax.devices()[0])
    rng = np.random.default_rng(7)
    B = 64
    worst = []
    for kind in ("walk", "sine", "spiky"):
        for (L, rho) in ((512, 25), (1024, 51), (8192, 409)):
            n = 200_000
            x = series(kind, n, rng)
            offs = rng.integers(0, n - L, B)
            win = np.stack([x[o:o + L] for o in offs])
            # near-match rows: query = a window + small noise (the regime the
            # guard protects — near-threshold candidates)
            qbase = x[offs[0]:offs[0] + L]
            for mode in ("znorm", "raw"):
                if mode == "znorm":
                    w = (win - win.mean(1, keepdims=True)) / win.std(1, keepdims=True)
                    q = (qbase - qbase.mean()) / qbase.std()
                else:
                    w = win
                    q = qbase
                # mix: far candidates + near-threshold ones (query + noise)
                near = q[None, :] + rng.standard_normal((B // 2, L)) * 0.05
                wall = np.concatenate([w[:B // 2], near])
                d64 = _dtw_banded_batch_f64_np(wall, q, rho)
                wall32 = jnp.asarray(wall, jnp.float32)
                qb32 = jnp.asarray(np.broadcast_to(q, wall.shape), jnp.float32)
                d32 = np.asarray(dtw_banded_batch_multi(wall32, qb32, rho),
                                 np.float64)
                dds = ds_value(*dtw_banded_batch_ds_multi(wall32, qb32, rho))
                # ds error vs the f64 twin on the same (f64) inputs: what
                # remains is f32 INPUT rounding of the windows/query only.
                ds_err = np.abs(dds - d64)
                amp = float(np.abs(wall).max() + np.abs(q).max())
                ds_denom = EPS32 * np.sqrt(L * (d64 + 1.0)) * amp
                cds = (ds_err / ds_denom).max()
                print(f"    ds: max|err|={ds_err.max():9.3e}  "
                      f"C_ds_needed={cds:7.3f}  (amp={amp:.1f})")
                err = np.abs(d32 - d64)
                # proposed bound shape: C * eps32 * L * (d2 + s2) with s2 the
                # cell-magnitude scale (z-norm: ~8; raw: data range dependent)
                s2 = 8.0 if mode == "znorm" else float((wall.max() - wall.min()) ** 2)
                denom = EPS32 * L * (d64 + s2)
                c_needed = (err / denom).max()
                i = int((err / denom).argmax())
                worst.append((kind, mode, L, rho, c_needed))
                print(f"{kind:6s} {mode:6s} L={L:5d} rho={rho:4d}  "
                      f"max|err|={err.max():9.3e}  C_needed={c_needed:7.3f}  "
                      f"(at d2={d64[i]:9.3f}, s2={s2:.1f})")
    cmax = max(w[-1] for w in worst)
    print(f"\nmax C_needed over all cases: {cmax:.3f}")
    print(f"guard with C=8 at L=8192, eps2=16 (znorm): "
          f"{8 * EPS32 * 8192 * (16 + 8):.4f}  (round-2 guard was 0.9892)")


if __name__ == "__main__":
    main()
