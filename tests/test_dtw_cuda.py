"""Banded-DTW CUDA kernel: route choice, call shapes and the arithmetic it
implements.

The kernel has no interpret mode, so its arithmetic is checked here through
its NumPy twin (ops/dtw_cuda.wavefront_reference) and its wrapper through
abstract evaluation; the compiled kernel runs only on the card
(test_dtw_cuda_matches_f64, and chip_smoke.py)."""

import jax
import jax.numpy as jnp
import numpy as np
import pytest

from kvmatch_tpu.ops import dtw_cuda
from kvmatch_tpu.ops.dtw import (_dtw_banded_batch_f64_np, dtw_kernel_for,
                                 dtw_stage_multi, dtw_banded_batch_multi)


@pytest.mark.parametrize("L,r", [(2, 1), (5, 0), (7, 2), (40, 3), (64, 63),
                                 (100, 10), (33, 31), (90, 40), (120, 200)])
def test_wavefront_reference_matches_f64(L, r):
    rng = np.random.default_rng(L * 1000 + r)
    for _ in range(2):
        a = np.cumsum(rng.standard_normal(L)).astype(np.float32)
        q = np.cumsum(rng.standard_normal(L)).astype(np.float32)
        ref = _dtw_banded_batch_f64_np(a[None].astype(np.float64),
                                       q.astype(np.float64), min(r, L - 1))[0]
        got = dtw_cuda.wavefront_reference(a, q, r)
        assert abs(got - ref) <= 1e-5 * max(1.0, ref)


@pytest.mark.parametrize("platform,r,L,route", [
    ("gpu", 51, 1024, "cuda"), ("gpu", 409, 8192, "cuda"),
    ("gpu", 511, 8192, "cuda"), ("gpu", 512, 8192, "xla"),
    ("gpu", 5000, 300, "cuda"), ("cpu", 51, 1024, "xla")])
def test_dtw_kernel_for(platform, r, L, route):
    assert dtw_kernel_for(platform, r, L) == route


def test_dtw_kernel_for_unknown_platform():
    with pytest.raises(ValueError):
        dtw_kernel_for("metal", 4, 64)


def test_ffi_call_shapes_and_band_limit():
    """The custom call returns one f32 distance per window, clamps r to L-1
    and refuses bands wider than the kernel holds."""
    x = jax.ShapeDtypeStruct((37, 100), jnp.float32)
    qm = jax.ShapeDtypeStruct((3, 100), jnp.float32)
    qids = jax.ShapeDtypeStruct((37,), jnp.int32)
    out = jax.eval_shape(lambda a, b, c: dtw_cuda._ffi_call(a, b, c, 500),
                         x, qm, qids)
    assert out.shape == (37,) and out.dtype == jnp.float32
    x = jax.ShapeDtypeStruct((4, 4096), jnp.float32)
    qm = jax.ShapeDtypeStruct((1, 4096), jnp.float32)
    qids = jax.ShapeDtypeStruct((4,), jnp.int32)
    with pytest.raises(ValueError):
        jax.eval_shape(lambda a, b, c: dtw_cuda._ffi_call(a, b, c, 512),
                       x, qm, qids)


def test_dtw_stage_on_cpu_is_xla_form():
    """On the CPU the stage dispatcher runs the XLA scan form."""
    rng = np.random.default_rng(2)
    data = jnp.asarray(np.cumsum(rng.standard_normal(5000)), jnp.float32)
    qm = jnp.asarray(np.cumsum(rng.standard_normal((2, 128)), axis=1),
                     jnp.float32)
    offs = jnp.asarray(rng.integers(0, 5000 - 128, 16), jnp.int32)
    qids = jnp.asarray(rng.integers(0, 2, 16), jnp.int32)
    got = np.asarray(dtw_stage_multi(data, qm, offs, qids, 128, 6))
    x = jax.vmap(lambda o: jax.lax.dynamic_slice(data, (o,), (128,)))(offs)
    want = np.asarray(dtw_banded_batch_multi(x, qm[qids], 6))
    np.testing.assert_array_equal(got, want)


@pytest.mark.gpu
@pytest.mark.parametrize("L,r,B", [(1024, 51, 64), (8192, 409, 8),
                                   (300, 7, 33)])
def test_dtw_cuda_matches_f64(gpu_device, L, r, B):
    rng = np.random.default_rng(L)
    x = np.cumsum(rng.standard_normal((B, L)), axis=1).astype(np.float32)
    qm = np.cumsum(rng.standard_normal((2, L)), axis=1).astype(np.float32)
    qids = rng.integers(0, 2, B).astype(np.int32)
    with jax.default_device(gpu_device):
        got = np.asarray(dtw_cuda.dtw_banded_cuda(
            jnp.asarray(x), jnp.asarray(qm), jnp.asarray(qids), r))
    for b in range(B):
        ref = _dtw_banded_batch_f64_np(x[b:b + 1].astype(np.float64),
                                       qm[qids[b]].astype(np.float64), r)[0]
        assert abs(got[b] - ref) <= 1e-4 * (ref + 1.0) + 1e-4 * L
