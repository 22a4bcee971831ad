"""Small flax transformer encoder producing mean-pooled sentence embeddings.

On-device embedding tier: the encoder jits onto the same device as the vector
store, so `encoder.embed_device(...)` output feeds
`PicoVectorDB.query_columnar` with zero host round trips — the serving
pipeline the reference approximates with CPU sentence-transformers
(reference: bench/st_embedding.py, bench/local_embedding_query.py).

Weights are randomly initialized by default (useful as a realistic
compute-shape stand-in and for perf work); `load_params` accepts any
matching pytree (e.g. converted MiniLM weights) for real deployments.
Tokenization is byte-level (vocab 259) so no external tokenizer files are
needed.
"""

from __future__ import annotations

from typing import List

import jax
import jax.numpy as jnp
import numpy as np

try:
    import flax.linen as nn
except Exception as e:  # pragma: no cover
    raise ImportError("flax is required for FlaxMeanPoolEncoder") from e

PAD, BOS, EOS = 256, 257, 258
VOCAB = 259


class _Encoder(nn.Module):
    dim: int
    depth: int
    heads: int
    mlp_ratio: int = 4
    max_len: int = 256

    @nn.compact
    def __call__(self, tokens, mask):
        x = nn.Embed(VOCAB, self.dim, dtype=jnp.bfloat16)(tokens)
        pos = nn.Embed(self.max_len, self.dim, dtype=jnp.bfloat16)(
            jnp.arange(tokens.shape[1])[None, :]
        )
        x = x + pos
        attn_mask = mask[:, None, None, :].astype(bool)
        for _ in range(self.depth):
            h = nn.LayerNorm(dtype=jnp.bfloat16)(x)
            h = nn.MultiHeadDotProductAttention(
                num_heads=self.heads, dtype=jnp.bfloat16
            )(h, h, mask=attn_mask)
            x = x + h
            h = nn.LayerNorm(dtype=jnp.bfloat16)(x)
            h = nn.Dense(self.dim * self.mlp_ratio, dtype=jnp.bfloat16)(h)
            h = nn.gelu(h)
            h = nn.Dense(self.dim, dtype=jnp.bfloat16)(h)
            x = x + h
        x = nn.LayerNorm(dtype=jnp.bfloat16)(x)
        # masked mean pooling -> float32 unit vectors
        m = mask[:, :, None].astype(jnp.float32)
        pooled = (x.astype(jnp.float32) * m).sum(1) / jnp.maximum(m.sum(1), 1.0)
        norm = jnp.linalg.norm(pooled, axis=1, keepdims=True)
        return pooled / jnp.maximum(norm, 1e-9)


class FlaxMeanPoolEncoder:
    def __init__(
        self,
        dim: int = 384,
        depth: int = 4,
        heads: int = 6,
        max_len: int = 256,
        seed: int = 0,
    ) -> None:
        self.dim = dim
        self.max_len = max_len
        self.module = _Encoder(dim=dim, depth=depth, heads=heads, max_len=max_len)
        toks = jnp.zeros((1, max_len), jnp.int32)
        msk = jnp.ones((1, max_len), jnp.int32)
        self.params = self.module.init(jax.random.PRNGKey(seed), toks, msk)
        self._apply = jax.jit(self.module.apply)

    def load_params(self, params) -> None:
        self.params = params

    def tokenize(self, texts: List[str]) -> tuple[np.ndarray, np.ndarray]:
        toks = np.full((len(texts), self.max_len), PAD, dtype=np.int32)
        mask = np.zeros((len(texts), self.max_len), dtype=np.int32)
        for i, t in enumerate(texts):
            raw = t.encode("utf-8")[: self.max_len - 2]
            seq = [BOS] + list(raw) + [EOS]
            toks[i, : len(seq)] = seq
            mask[i, : len(seq)] = 1
        return toks, mask

    def embed_device(self, texts: List[str]) -> jax.Array:
        """Embeddings as a device-resident jax.Array (feed query_columnar)."""
        toks, mask = self.tokenize(texts)
        return self._apply(self.params, toks, mask)

    def embed(self, texts: List[str]) -> np.ndarray:
        return np.asarray(self.embed_device(texts))

    encode = embed
