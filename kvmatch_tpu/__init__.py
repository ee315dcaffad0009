"""kvmatch_tpu — accelerator-native exact subsequence matching (KV-match re-designed).

Public surface:

    from kvmatch_tpu import QueryEngine, QueryEngineDtw, NormQueryEngine, \\
        NormQueryEngineDtw, UcrScanner, IndexConfig, QueryConfig, oracle

Engines build (or accept) a multi-scale KV-index and answer exact subsequence
matches under ED / banded DTW, raw or z-normalized with mean/std constraints.
See README.md for the architecture and PARITY.md for the reference component map.
"""

from .config import IndexConfig, QueryConfig
from .utils.hostmem import tune_glibc_malloc as _tune_malloc

# Large NumPy temps otherwise mmap/munmap-cycle and re-fault on every use —
# tens of MB/s on slow hosts (see utils/hostmem.py).  Best-effort, opt-out
# via KVMATCH_NO_MALLOC_TUNE=1.
_tune_malloc()

__all__ = [
    "IndexConfig", "QueryConfig",
    "QueryEngine", "QueryEngineDtw", "NormQueryEngine", "NormQueryEngineDtw",
    "LongQueryEngine", "UcrScanner", "StreamingIndexBuilder",
]


def __getattr__(name):
    # Lazy imports keep `import kvmatch_tpu` free of jax initialization.
    if name == "QueryEngine":
        from .engine.rsm_ed import QueryEngine
        return QueryEngine
    if name == "QueryEngineDtw":
        from .engine.rsm_dtw import QueryEngineDtw
        return QueryEngineDtw
    if name == "NormQueryEngine":
        from .engine.norm_ed import NormQueryEngine
        return NormQueryEngine
    if name == "NormQueryEngineDtw":
        from .engine.norm_dtw import NormQueryEngineDtw
        return NormQueryEngineDtw
    if name == "LongQueryEngine":
        # The reference's separate long-position engine family
        # (mapreduce/LongQueryEngine.java:35) collapses here: positions are
        # int64 end-to-end already (PARITY.md section 2.4 #39).
        from .engine.rsm_ed import QueryEngine
        return QueryEngine
    if name == "UcrScanner":
        from .baselines import UcrScanner
        return UcrScanner
    if name == "StreamingIndexBuilder":
        from .index.streaming import StreamingIndexBuilder
        return StreamingIndexBuilder
    raise AttributeError(name)
