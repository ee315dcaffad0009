"""In-RAM and in-HBM stores.

``MemoryStore`` mirrors TimeSeriesMemoryOperator (operator/memory/
TimeSeriesMemoryOperator.java:29-82).  ``HbmStore`` is the device-native backend that
replaces the reference's HBase/Kudu tables (SURVEY.md section 2.6): series and
index live as device arrays; range reads are device slices.
"""

from __future__ import annotations

import numpy as np


class MemoryStore:
    def __init__(self, data: np.ndarray):
        self._data = np.asarray(data, np.float64)

    def read(self, left: int, length: int) -> np.ndarray:
        if left < 0 or left + length > self._data.size:
            raise ValueError(f"read out of range: left={left} length={length}")
        return self._data[left:left + length]

    def read_all(self) -> np.ndarray:
        return self._data

    def length(self) -> int:
        return int(self._data.size)


class HbmStore:
    """Device-resident series (float32 in HBM) + host float64 shadow.

    The float32 copy feeds the verify kernels; the float64 shadow serves exact
    host confirmations.  For multi-chip, `shard` places the device copy on a mesh
    with offset-range sharding (parallel/mesh.py).
    """

    def __init__(self, data: np.ndarray, sharding=None):
        import jax
        import jax.numpy as jnp
        self.host = np.ascontiguousarray(np.asarray(data, np.float64))
        arr = jnp.asarray(self.host, jnp.float32)
        if sharding is not None:
            arr = jax.device_put(arr, sharding)
        self.device = arr

    def read(self, left: int, length: int) -> np.ndarray:
        return self.host[left:left + length]

    def read_all(self) -> np.ndarray:
        return self.host

    def length(self) -> int:
        return int(self.host.size)
