"""Device-mesh helpers for offset-range sharding.

The reference scales out by pre-splitting HBase regions on the time axis and
running Hadoop-MR jobs per region (TimeSeriesHBaseTableOperator.java:53-56,
BuildIndexMapReduce.java:113-184).  Here the same partitioning becomes a 1-D
``jax.sharding.Mesh`` with the series sharded by offset range; halos replace the
mappers' cross-region re-reads, and XLA collectives replace the Hadoop shuffle
(SURVEY.md section 2.6).  The cards of one host are joined all to all, so a
1-D mesh in device order is the whole layout.
"""

from __future__ import annotations

from typing import Optional, Sequence

import jax
import numpy as np
from jax.sharding import Mesh, PartitionSpec as P

AXIS = "shard"


def make_mesh(devices: Optional[Sequence] = None) -> Mesh:
    devices = list(devices if devices is not None else jax.devices())
    return Mesh(np.array(devices), (AXIS,))


def shard_spec() -> P:
    return P(AXIS)


def replicated() -> P:
    return P()


def pad_to_shards(x: np.ndarray, n_shards: int, pad_value=0.0) -> np.ndarray:
    """Right-pad so the length divides the mesh size."""
    pad = (-x.size) % n_shards
    if pad:
        x = np.concatenate([x, np.full(pad, pad_value, x.dtype)])
    return x
