"""Sharded index build: halo exchange + per-shard bucket pass under shard_map.

Device-native replacement for the distributed MR build (BuildIndexMapReduce.java:53-344):

  MR mapper re-reads w-1 points left of its region  ->  ppermute halo from the
                                                        right neighbor
  shuffle by mean key + reduce interval-union        ->  host-side grouping of the
                                                        gathered bucket arrays
                                                        (index/build.py)

Each shard owns an equal slice of window-start positions; the jitted part
(`sharded_buckets`) produces the per-scale bucket ids fully on-device, sharded the
same way, which also feeds the dense sharded query path (parallel/query.py).
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from ..config import IndexConfig
from ..index.build import build_index_from_buckets
from ..index.structure import Index
from ..ops.sliding import build_buckets
from .mesh import AXIS


def _halo_from_right(x: jnp.ndarray, halo: int) -> jnp.ndarray:
    """Append the first ``halo`` points of the right neighbor's block (the last
    shard receives shard 0's data, masked out by the caller's trim)."""
    n_sh = jax.lax.psum(1, AXIS)
    src_dst = [(i, (i - 1) % n_sh) for i in range(n_sh)]
    head = jax.lax.ppermute(x[:halo], AXIS, src_dst)
    return jnp.concatenate([x, head])


def make_sharded_buckets(mesh: Mesh, scales: Tuple[int, ...], pos_of_d: int):
    """Compile the sharded bucket pass: data sharded by offset -> per-scale bucket
    ids, identically sharded.  Output rows are aligned: out[s][i] is the bucket of
    the window starting at global position i for scale s."""
    w_max = max(scales)
    halo = w_max - 1

    def per_shard(x):
        per = x.shape[0]
        xh = _halo_from_right(x, halo)  # per + halo points
        out = build_buckets(xh, scales, pos_of_d)
        # out[w] has per + (w_max - w) entries; this shard owns the first `per`
        # window starts — exactly one owner per global start.
        return jnp.stack([out[w][:per] for w in scales])

    fn = jax.jit(jax.shard_map(per_shard, mesh=mesh,
                               in_specs=P(AXIS), out_specs=P(None, AXIS)))
    return fn


def build_index_sharded(data: np.ndarray, mesh: Mesh,
                        cfg: IndexConfig) -> Tuple[Index, jnp.ndarray]:
    """Full sharded build: device bucket pass over the mesh + host grouping.

    Returns (index, device bucket stack) — the latter stays sharded in HBM for the
    dense query path."""
    n = data.size
    n_sh = mesh.devices.size
    scales = tuple(cfg.scales)
    pad = (-n) % n_sh
    padded = np.concatenate([data, np.zeros(pad, data.dtype)]) if pad else data
    sharding = NamedSharding(mesh, P(AXIS))
    data_dev = jax.device_put(padded.astype(np.float32), sharding)
    fn = make_sharded_buckets(mesh, scales, cfg.pos_of_d)
    stack = fn(data_dev)  # (n_scales, n_padded)
    host = np.asarray(stack)
    buckets = {w: host[i][: n - w + 1] for i, w in enumerate(scales)}
    return build_index_from_buckets(buckets, n, cfg), stack
