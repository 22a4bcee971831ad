"""picovdb_tpu — a vector database whose corpus lives on an accelerator.

Capability surface of wensheng/picovdb (reference: picovdb/__init__.py:1-7),
rebuilt in JAX: the L2-normalized corpus lives in device memory (optionally
row-sharded across a `jax.sharding.Mesh`), queries run as one masked-top-k
XLA program (exact scan / IVF probe / shard_map multi-device path), and the
optional FAISS HNSW tier is replaced by exact brute force plus a
device-resident IVF tier.
"""

from .constants import K_ID, K_METRICS, K_VECTOR, Float  # noqa: F401
from .engine import PicoVectorDB  # noqa: F401
from .locking import RWLock  # noqa: F401

# Back-compat flag: the reference exports whether the faiss-cpu wheel is
# importable (picovdb/pico_vdb.py:19-23). This framework does not use FAISS;
# its ANN acceleration is first-party (see picovdb_tpu/ops). `_HAS_FAISS`
# reports the literal fact (faiss importable), `HAS_ANN` reports that the
# built-in acceleration tier is available.
try:  # pragma: no cover - environment-dependent
    import faiss  # type: ignore  # noqa: F401

    _HAS_FAISS = True
except ImportError:  # pragma: no cover
    _HAS_FAISS = False

HAS_ANN = True

__version__ = "0.1.0"

__all__ = [
    "PicoVectorDB",
    "K_ID",
    "K_VECTOR",
    "K_METRICS",
    "Float",
    "RWLock",
    "_HAS_FAISS",
    "HAS_ANN",
    "__version__",
]
