"""Embedding models feeding the vector store.

The reference has no model layer — its bench scripts call
sentence-transformers on CPU (reference: bench/st_embedding.py:13-32,
bench/hf_upserts.py). Here embedders are a first-class, device-resident layer:
an embedder can run *on the same device* as the store, so query embeddings
stay device-resident end-to-end (see PicoVectorDB.query_columnar, which
accepts jax.Array inputs with zero host round trips).

Four tiers:
  * HashingEmbedder — deterministic, dependency-free text embedder
    (feature-hashed n-grams). Good for tests, demos and smoke benches.
  * BertMeanPoolEncoder — first-party jitted BERT encoder running real
    HuggingFace checkpoints (MiniLM et al.) on the device via
    `convert_hf_state_dict`; torch-forward parity is test-asserted.
  * FlaxMeanPoolEncoder — a small JAX/flax transformer encoder with mean
    pooling that jits onto the device; weights random by default or loadable.
  * TorchSentenceEmbedder — optional bridge to sentence-transformers /
    transformers (CPU torch), gated on availability like the reference's
    bench deps.
"""

from .hashing import HashingEmbedder  # noqa: F401
from .bert_encoder import (  # noqa: F401
    BertConfig,
    BertMeanPoolEncoder,
    WordVocabTokenizer,
    convert_hf_state_dict,
)

try:  # flax is in the base image; keep soft anyway
    from .flax_encoder import FlaxMeanPoolEncoder  # noqa: F401

    HAS_FLAX_ENCODER = True
except Exception:  # pragma: no cover
    HAS_FLAX_ENCODER = False

try:
    from .torch_st import TorchSentenceEmbedder, HAS_SENTENCE_TRANSFORMERS  # noqa: F401
except Exception:  # pragma: no cover
    HAS_SENTENCE_TRANSFORMERS = False
