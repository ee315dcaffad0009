"""The FFT-prefiltered ED oracles return exactly the brute-force answer sets
(they are what long-series checks compare the engines with)."""

import numpy as np
import pytest

from kvmatch_tpu import oracle
from kvmatch_tpu.data.generators import generate_series


@pytest.fixture(scope="module")
def series():
    return generate_series(120_000, seed=5)


@pytest.mark.parametrize("off,L,eps", [(1000, 512, 8.0), (50_000, 256, 3.0),
                                       (77, 1024, 20.0), (9000, 64, 0.5)])
def test_rsm_ed_fft_equals_brute_force(series, off, L, eps):
    q = series[off:off + L]
    want = oracle.rsm_ed(series, q, eps)
    got = oracle.rsm_ed_fft(series, q, eps)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert off in got[0].tolist()


@pytest.mark.parametrize("off,L,eps,alpha,beta", [
    (1000, 512, 4.0, 1.3, 8.0), (50_000, 256, 1.5, 1.1, 2.0),
    (77, 1024, 10.0, 2.0, 50.0)])
def test_nsm_ed_fft_equals_brute_force(series, off, L, eps, alpha, beta):
    q = series[off:off + L]
    want = oracle.nsm_ed(series, q, eps, alpha, beta)
    got = oracle.nsm_ed_fft(series, q, eps, alpha, beta)
    np.testing.assert_array_equal(got[0], want[0])
    np.testing.assert_array_equal(got[1], want[1])
    assert off in got[0].tolist()


def test_sliding_dot_blocks_match_direct():
    rng = np.random.default_rng(1)
    x = rng.standard_normal(5000)
    q = rng.standard_normal(300)
    got = oracle._sliding_dot(x, q, block=512)
    want = np.array([x[i:i + 300] @ q for i in range(5000 - 300 + 1)])
    np.testing.assert_allclose(got, want, rtol=1e-10, atol=1e-9)


def test_dtw_oracle_threads_match_serial():
    data = generate_series(6000, seed=3)
    q = data[1000:1128]
    offs, d = oracle.rsm_dtw(data, q, 6.0, 6)
    m = data.size - 128 + 1
    w = data[np.arange(m)[:, None] + np.arange(128)[None, :]]
    from kvmatch_tpu.ops.dtw import _dtw_banded_batch_f64_np
    d2 = _dtw_banded_batch_f64_np(w, q, 6)
    want = np.flatnonzero(d2 <= 36.0)
    np.testing.assert_array_equal(offs, want)
    np.testing.assert_allclose(d, np.sqrt(d2[want]), rtol=1e-12)
