"""Region (conv/MASS) phase-2 kernels vs direct float64 evaluation."""

import jax.numpy as jnp
import numpy as np
import pytest

from kvmatch_tpu.ops.regions import (pack_regions, region_ed_distances,
                                     region_znorm_distances)


@pytest.fixture(scope="module")
def problem():
    rng = np.random.default_rng(3)
    n, L = 50_000, 512
    # random-walk-ish data with a big DC offset to stress the raw-path numerics
    data = np.cumsum(rng.normal(0, 0.5, n)) + 100.0
    q = data[20_000:20_000 + L] + rng.normal(0, 0.05, L)
    return data, q, n, L


def test_pack_regions_covers_all_offsets(problem):
    data, q, n, L = problem
    left = np.array([0, 100, 5000, n - L - 3], np.int64)
    right = np.array([0, 940, 5010, n - L], np.int64)
    M = 256
    starts, vfrom, vto = pack_regions(left, right, n, L, M)
    covered = set()
    for s, a, b in zip(starts, vfrom, vto):
        assert 0 <= s and s + M + L - 1 <= n
        assert 0 <= a < b <= M
        covered.update(range(s + a, s + b))
    want = set()
    for l, r in zip(left, right):
        want.update(range(l, r + 1))
    assert covered == want


def test_region_ed_matches_direct(problem):
    data, q, n, L = problem
    M = 128
    left = np.array([900, 19_900], np.int64)
    right = np.array([1100, 20_100], np.int64)
    starts, vfrom, vto = pack_regions(left, right, n, L, M)
    c = float(data.mean())
    d32 = jnp.asarray(data, jnp.float32)
    q32 = jnp.asarray(q - c, jnp.float32)
    d2, err = region_ed_distances(d32, q32, jnp.asarray(starts, jnp.int32), L, M,
                                  np.float32(c))
    d2, err = np.asarray(d2), np.asarray(err)
    for b, (s, a, e) in enumerate(zip(starts, vfrom, vto)):
        for j in range(a, e):
            off = s + j
            exact = float(np.sum((data[off:off + L] - q) ** 2))
            assert abs(d2[b, j] - exact) <= err[b, j] + 1e-3 * (exact + 1), \
                (off, d2[b, j], exact, err[b, j])


def test_region_znorm_matches_direct(problem):
    data, q, n, L = problem
    M = 128
    left = np.array([19_900], np.int64)
    right = np.array([20_100], np.int64)
    starts, vfrom, vto = pack_regions(left, right, n, L, M)
    mu_q, sd_q = q.mean(), q.std()
    qh = (q - mu_q) / sd_q
    d2, mu, sd = region_znorm_distances(jnp.asarray(data, jnp.float32),
                                        jnp.asarray(qh, jnp.float32),
                                        jnp.asarray(starts, jnp.int32), L, M)
    d2, mu, sd = np.asarray(d2), np.asarray(mu), np.asarray(sd)
    for b, (s, a, e) in enumerate(zip(starts, vfrom, vto)):
        for j in range(a, e, 17):
            off = s + j
            x = data[off:off + L]
            m_h, s_h = x.mean(), x.std()
            exact = float(np.sum(((x - m_h) / s_h - qh) ** 2))
            assert abs(mu[b, j] - m_h) < 1e-2
            assert abs(sd[b, j] - s_h) < 1e-2
            assert abs(d2[b, j] - exact) <= 0.05 * (exact + 1.0), \
                (off, d2[b, j], exact)


def test_gather_table_kernels_match_f64():
    """The gather ED kernels (raw and z-normalized, single- and multi-query)
    vs float64 direct computation, with windows reaching the series end."""
    import numpy as np
    import jax.numpy as jnp
    from kvmatch_tpu.ops.ed import (ed_distances, ed_distances_multi,
                                    znorm_ed_distances,
                                    znorm_ed_distances_multi)

    rng = np.random.default_rng(17)
    n, L, B, Q = 8192, 300, 64, 3
    data = rng.normal(size=n)
    d32 = jnp.asarray(data, jnp.float32)
    offs = rng.integers(0, n - L, B).astype(np.int32)
    offs[:2] = (0, n - L)
    queries = rng.normal(size=(Q, L))
    qids = rng.integers(0, Q, B).astype(np.int32)

    wins = data[offs[:, None] + np.arange(L)[None, :]]

    # single-query raw ED
    d2 = np.asarray(ed_distances(d32, jnp.asarray(queries[0], jnp.float32),
                                 jnp.asarray(offs), L))
    ref = np.sum((wins - queries[0][None, :]) ** 2, axis=1)
    np.testing.assert_allclose(d2, ref, rtol=2e-4, atol=1e-3)

    # multi-query raw ED
    d2m = np.asarray(ed_distances_multi(
        d32, jnp.asarray(queries, jnp.float32), jnp.asarray(offs),
        jnp.asarray(qids), L))
    refm = np.sum((wins - queries[qids]) ** 2, axis=1)
    np.testing.assert_allclose(d2m, refm, rtol=2e-4, atol=1e-3)

    # z-normalized (single + multi)
    qhat = (queries - queries.mean(axis=1, keepdims=True)) \
        / queries.std(axis=1, keepdims=True)
    mu = wins.mean(axis=1)
    sd = wins.std(axis=1)
    zt = (wins - mu[:, None]) / sd[:, None]
    dz, m1, s1 = znorm_ed_distances(d32, jnp.asarray(qhat[0], jnp.float32),
                                    jnp.asarray(offs), L)
    refz = np.sum((zt - qhat[0][None, :]) ** 2, axis=1)
    np.testing.assert_allclose(np.asarray(dz), refz, rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(np.asarray(m1), mu, rtol=1e-4, atol=1e-4)
    dzm, m2, s2 = znorm_ed_distances_multi(
        d32, jnp.asarray(qhat, jnp.float32), jnp.asarray(offs),
        jnp.asarray(qids), L)
    refzm = np.sum((zt - qhat[qids]) ** 2, axis=1)
    np.testing.assert_allclose(np.asarray(dzm), refzm, rtol=2e-3, atol=2e-2)
    np.testing.assert_allclose(np.asarray(s2), sd, rtol=1e-3, atol=1e-4)
