"""Soundness of the double-single banded-DTW device confirm.

The DS kernel (ops/dtw.dtw_banded_batch_ds_multi) replaces most of the host
f64 confirmation of near-threshold DTW candidates; correctness of the final
answer set then rests on ``verify.ds_guard`` really bounding

    |ds_distance(f32 inputs)  -  f64_distance(f64 inputs)|

so these are adversarial property tests, not smoke tests: spiky data, large
common-mode offsets, and near-threshold pairs (query + small noise) across
several (L, rho)."""

import numpy as np
import pytest

from kvmatch_tpu import verify as vf
from kvmatch_tpu.ops.dtw import (_dtw_banded_batch_f64_np, ds_value,
                                 dtw_banded_batch_ds_multi,
                                 dtw_banded_batch_multi)


def _series(kind, n, rng):
    if kind == "walk":
        return np.cumsum(rng.standard_normal(n) * 0.5)
    if kind == "spiky":
        x = rng.standard_normal(n)
        x[rng.integers(0, n, n // 50)] *= 40.0
        return x
    if kind == "offset":  # large common-mode value: worst case for f32 rounding
        return 300.0 + np.cumsum(rng.standard_normal(n) * 0.1)
    raise ValueError(kind)


def _windows(kind, B, L, rng):
    x = _series(kind, 50_000, rng)
    offs = rng.integers(0, x.size - L, B)
    win = np.stack([x[o:o + L] for o in offs])
    q = x[offs[0]:offs[0] + L].copy()
    # half the batch: near-threshold candidates (query + small noise), the
    # regime the guard actually protects
    win[B // 2:] = q[None, :] + rng.standard_normal((B - B // 2, L)) * 0.05
    return win, q


@pytest.mark.parametrize("kind", ["walk", "spiky", "offset"])
@pytest.mark.parametrize("L,rho", [(256, 12), (1024, 51)])
def test_ds_matches_f64_on_same_inputs(kind, L, rho):
    """DS accumulation on identical f32-rounded inputs: the only rounding left
    is the f32 cell value (a-q)^2 itself (~eps32 relative per cell, so
    ~eps32*d2 along a path) — the double-single sums and mins add nothing
    measurable on top.  This keeps the kernel's intrinsic error an order below
    ds_guard, whose budget is INPUT rounding (eps32 * amp * sqrt(2L*d2))."""
    rng = np.random.default_rng(hash((kind, L)) % 2**32)
    win, q = _windows(kind, 32, L, rng)
    w32 = win.astype(np.float32)
    q32 = np.broadcast_to(q.astype(np.float32), w32.shape)
    d64_same = _dtw_banded_batch_f64_np(w32.astype(np.float64),
                                        q32[0].astype(np.float64), rho)
    dds = ds_value(*dtw_banded_batch_ds_multi(w32, q32, rho))
    err = np.abs(dds - d64_same)
    eps32 = float(np.finfo(np.float32).eps)
    assert np.all(err <= 8.0 * eps32 * (d64_same + 1.0)), \
        (err / (eps32 * (d64_same + 1.0))).max()


@pytest.mark.parametrize("kind", ["walk", "spiky", "offset"])
@pytest.mark.parametrize("L,rho", [(256, 12), (1024, 51), (2048, 102)])
def test_ds_guard_bounds_raw_pipeline(kind, L, rho):
    """Raw-data path: f32-rounded windows through DS vs f64 windows through the
    exact DP — |diff| <= ds_guard, with >=4x slack on the measured max."""
    rng = np.random.default_rng(hash((kind, L, 7)) % 2**32)
    win, q = _windows(kind, 32, L, rng)
    d64 = _dtw_banded_batch_f64_np(win, q, rho)
    w32 = win.astype(np.float32)
    q32 = np.broadcast_to(q.astype(np.float32), w32.shape)
    dds = ds_value(*dtw_banded_batch_ds_multi(w32, q32, rho))
    amax = np.abs(w32).max(axis=1).astype(np.float64)
    amp = amax + abs(float(q.max())) + 1.0
    g = vf.ds_guard(d64, L, amp)
    err = np.abs(dds - d64)
    assert np.all(err <= g / 4.0), (err / g).max()


@pytest.mark.parametrize("kind", ["walk", "spiky", "offset"])
@pytest.mark.parametrize("L,rho", [(256, 12), (1024, 51)])
def test_ds_guard_bounds_znorm_pipeline(kind, L, rho):
    """Z-norm path (cNSM-DTW): host-exact f64 mean/std rounded to f32, device
    f32 z-normalization + DS DP, vs the all-f64 pipeline."""
    rng = np.random.default_rng(hash((kind, L, 13)) % 2**32)
    win, q = _windows(kind, 32, L, rng)
    mu = win.mean(axis=1)
    sd = win.std(axis=1)
    sd = np.where(sd > 0, sd, 1.0)
    z64 = (win - mu[:, None]) / sd[:, None]
    zq = (q - q.mean()) / q.std()
    d64 = _dtw_banded_batch_f64_np(z64, zq, rho)

    # device-side reproduction: f32 raw windows, f32 host stats, f32 znorm
    import jax.numpy as jnp
    w32 = jnp.asarray(win, jnp.float32)
    z32 = (w32 - jnp.asarray(mu, jnp.float32)[:, None]) / \
        jnp.asarray(sd, jnp.float32)[:, None]
    zq32 = jnp.broadcast_to(jnp.asarray(zq, jnp.float32), w32.shape)
    hi, lo = dtw_banded_batch_ds_multi(z32, zq32, rho)
    dds = ds_value(hi, lo)
    # z-space image of the raw data's f32 rounding (same formula the engine
    # stage returns): delta_z ~ eps32 * (|x| + |mu|) / sd
    amp_raw = ((np.abs(np.asarray(w32)).max(axis=1) + np.abs(mu) + sd) / sd)
    amp = amp_raw.astype(np.float64) + abs(float(np.abs(zq).max())) + 1.0
    g = vf.ds_guard(d64, L, amp)
    err = np.abs(dds - d64)
    assert np.all(err <= g / 4.0), (err / g).max()


def test_f32_dp_error_vs_ds():
    """The plain f32 DP's error is orders of magnitude above the DS kernel's —
    the reason the DS stage exists (ROADMAP round-2 item 1)."""
    rng = np.random.default_rng(99)
    L, rho = 2048, 102
    win, q = _windows("walk", 16, L, rng)
    d64 = _dtw_banded_batch_f64_np(win, q, rho)
    w32 = win.astype(np.float32)
    q32 = np.broadcast_to(q.astype(np.float32), w32.shape)
    d32 = np.asarray(dtw_banded_batch_multi(w32, q32, rho), np.float64)
    dds = ds_value(*dtw_banded_batch_ds_multi(w32, q32, rho))
    err32 = np.abs(d32 - d64).max()
    errds = np.abs(dds - d64).max()
    assert errds < err32
