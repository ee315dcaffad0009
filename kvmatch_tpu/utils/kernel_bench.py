"""Device peaks and timing helpers for kernel measurements on the card.

A roofline share is (least time the algorithm's bytes or operations allow at
the device's published peak) / (measured time).  The peaks are kept in one
table keyed by ``device_kind`` as JAX reports it; a device that is not in the
table is an error, not a default.
"""

from __future__ import annotations

import time
from typing import Callable, Dict

#: Published peaks per device kind.  H100 SXM: NVIDIA H100 Tensor Core GPU
#: data sheet (dense rates at the 700 W power limit): 80 GB HBM3 at
#: 3.35 TB/s, 67 TFLOP/s float32 outside the tensor cores.
PEAKS: Dict[str, Dict[str, float]] = {
    "NVIDIA H100 80GB HBM3": {"hbm_bytes_per_s": 3.35e12,
                              "f32_flops_per_s": 67e12},
}


def peaks_for(device_kind: str) -> Dict[str, float]:
    """Published peaks of ``device_kind``; raises for an unknown device."""
    try:
        return PEAKS[device_kind]
    except KeyError:
        raise ValueError(
            f"no published peaks for device kind {device_kind!r}; add it to "
            f"kvmatch_tpu/utils/kernel_bench.PEAKS with its source") from None


def roofline_share(device_kind: str, seconds: float, nbytes: float = 0.0,
                   flops: float = 0.0) -> float:
    """Least time at the published peaks over the measured ``seconds``."""
    pk = peaks_for(device_kind)
    floor = max(nbytes / pk["hbm_bytes_per_s"], flops / pk["f32_flops_per_s"])
    return floor / seconds


def time_call(fn: Callable, *args, reps: int = 5) -> float:
    """Median wall seconds of ``fn(*args)`` to completion, after one warm-up
    call (which compiles).  Every call ends in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn(*args))
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn(*args))
        times.append(time.perf_counter() - t0)
    times.sort()
    return times[len(times) // 2]
