"""On-device BERT-family sentence encoder + HuggingFace weight converter.

Real-model embedding tier: the reference's RAG benches embed with
sentence-transformers MiniLM on CPU (reference: bench/st_embedding.py:13-32,
bench/hf_query.py:22-37) and feed the vectors to the store. Here the same
architecture — BERT encoder, masked mean pooling, L2 normalization (the
all-MiniLM-* sentence-transformers recipe) — runs as one jitted JAX program
on the device, so corpus and query embeddings are born device-resident and
feed `PicoVectorDB.query_columnar` with zero host round trips.

`convert_hf_state_dict` maps a HuggingFace `BertModel` torch checkpoint
(e.g. sentence-transformers/all-MiniLM-L6-v2) onto this implementation's
parameter pytree; `BertMeanPoolEncoder.from_pretrained` wires a local
checkpoint directory end-to-end. Numerical parity with the torch forward
pass is asserted by tests/test_models.py (differential against a
randomly-initialized `transformers.BertModel` — bit-level behavior, not
downloaded weights, is what the converter must get right).

This module is pure jax/numpy; torch and transformers are imported only
inside the conversion helpers, so serving deployments need neither.
"""

from __future__ import annotations

import dataclasses
import functools
from typing import List, Optional

import jax
import jax.numpy as jnp
import numpy as np


@dataclasses.dataclass(frozen=True)
class BertConfig:
    vocab_size: int = 30522
    hidden_size: int = 384          # MiniLM-L6
    num_layers: int = 6
    num_heads: int = 12
    intermediate_size: int = 1536
    max_position: int = 512
    type_vocab_size: int = 2
    layer_norm_eps: float = 1e-12

    @classmethod
    def from_hf(cls, hf_config) -> "BertConfig":
        return cls(
            vocab_size=hf_config.vocab_size,
            hidden_size=hf_config.hidden_size,
            num_layers=hf_config.num_hidden_layers,
            num_heads=hf_config.num_attention_heads,
            intermediate_size=hf_config.intermediate_size,
            max_position=hf_config.max_position_embeddings,
            type_vocab_size=hf_config.type_vocab_size,
            layer_norm_eps=hf_config.layer_norm_eps,
        )


def _layer_norm(x, p, eps):
    x = x.astype(jnp.float32)  # LN in f32 even under bf16 compute
    mu = x.mean(-1, keepdims=True)
    var = jnp.mean((x - mu) ** 2, axis=-1, keepdims=True)
    return (x - mu) * jax.lax.rsqrt(var + eps) * p["scale"] + p["bias"]


def _dense(x, p):
    return x @ p["kernel"].astype(x.dtype) + p["bias"].astype(x.dtype)


def bert_encode(params, config: BertConfig, tokens, mask, compute_dtype=None):
    """BERT forward -> masked-mean-pooled, L2-normalized f32 embeddings.

    tokens/mask: (B, T) int32. Post-LN transformer identical to HF
    `BertModel` (token+position+type embeddings -> LN -> L layers of
    self-attention + GELU FFN with residual LayerNorms), followed by the
    sentence-transformers mean-pooling head.
    """
    B, T = tokens.shape
    h = config.num_heads
    emb = params["embeddings"]
    x = (
        jnp.take(emb["word"], tokens, axis=0)
        + emb["position"][None, :T, :]
        + emb["type"][None, None, 0, :]
    )
    x = _layer_norm(x, emb["ln"], config.layer_norm_eps)
    if compute_dtype is not None:
        x = x.astype(compute_dtype)
    # additive attention bias: padded keys get -inf-ish
    bias = (1.0 - mask.astype(jnp.float32))[:, None, None, :] * -1e9
    head_dim = config.hidden_size // h
    scale = 1.0 / np.sqrt(head_dim)
    for lp in params["layers"]:
        q = _dense(x, lp["q"]).reshape(B, T, h, head_dim)
        k = _dense(x, lp["k"]).reshape(B, T, h, head_dim)
        v = _dense(x, lp["v"]).reshape(B, T, h, head_dim)
        scores = jnp.einsum(
            "bthd,bshd->bhts", q, k, preferred_element_type=jnp.float32
        ) * scale + bias
        probs = jax.nn.softmax(scores, axis=-1).astype(x.dtype)
        ctx = jnp.einsum("bhts,bshd->bthd", probs, v).reshape(
            B, T, config.hidden_size
        )
        x = _layer_norm(
            x + _dense(ctx, lp["attn_out"]), lp["attn_ln"],
            config.layer_norm_eps,
        ).astype(x.dtype)
        ff = jax.nn.gelu(_dense(x, lp["ffn_in"]), approximate=False)
        x = _layer_norm(
            x + _dense(ff, lp["ffn_out"]), lp["ffn_ln"],
            config.layer_norm_eps,
        ).astype(x.dtype)
    # sentence-transformers mean pooling + normalization (MiniLM head)
    m = mask.astype(jnp.float32)[:, :, None]
    pooled = (x.astype(jnp.float32) * m).sum(1) / jnp.maximum(m.sum(1), 1e-9)
    norm = jnp.linalg.norm(pooled, axis=1, keepdims=True)
    return pooled / jnp.maximum(norm, 1e-12)


def convert_hf_state_dict(state_dict, config: BertConfig) -> dict:
    """HF `BertModel` torch state_dict -> this module's parameter pytree.

    Torch `nn.Linear` stores (out, in); JAX matmul wants (in, out), so all
    dense kernels are transposed. Accepts tensors or numpy arrays; strips
    an optional "bert." prefix (sentence-transformers checkpoints).
    """
    sd = {}
    for key, value in state_dict.items():
        name = key[5:] if key.startswith("bert.") else key
        arr = np.asarray(
            value.detach().cpu().numpy() if hasattr(value, "detach") else value,
            dtype=np.float32,
        )
        sd[name] = arr

    def dense(prefix):
        return {
            "kernel": jnp.asarray(sd[prefix + ".weight"].T),
            "bias": jnp.asarray(sd[prefix + ".bias"]),
        }

    def ln(prefix):
        return {
            "scale": jnp.asarray(sd[prefix + ".weight"]),
            "bias": jnp.asarray(sd[prefix + ".bias"]),
        }

    layers = []
    for i in range(config.num_layers):
        p = f"encoder.layer.{i}"
        layers.append(
            {
                "q": dense(f"{p}.attention.self.query"),
                "k": dense(f"{p}.attention.self.key"),
                "v": dense(f"{p}.attention.self.value"),
                "attn_out": dense(f"{p}.attention.output.dense"),
                "attn_ln": ln(f"{p}.attention.output.LayerNorm"),
                "ffn_in": dense(f"{p}.intermediate.dense"),
                "ffn_out": dense(f"{p}.output.dense"),
                "ffn_ln": ln(f"{p}.output.LayerNorm"),
            }
        )
    return {
        "embeddings": {
            "word": jnp.asarray(sd["embeddings.word_embeddings.weight"]),
            "position": jnp.asarray(
                sd["embeddings.position_embeddings.weight"]
            ),
            "type": jnp.asarray(sd["embeddings.token_type_embeddings.weight"]),
            "ln": ln("embeddings.LayerNorm"),
        },
        "layers": layers,
    }


class WordVocabTokenizer:
    """Offline word-level tokenizer with a corpus-built vocabulary.

    Call-compatible with a HuggingFace tokenizer invoked with
    `return_tensors="np"` (returns "input_ids"/"attention_mask"), so it
    plugs into `BertMeanPoolEncoder` unchanged. Exists for environments
    with no downloadable vocab files: `fit` builds the vocabulary from the
    corpus itself (most-frequent words first), with [PAD]/[UNK]/[CLS]/[SEP]
    specials at fixed ids.
    """

    PAD, UNK, CLS, SEP = 0, 1, 2, 3

    def __init__(self, vocab_size: int = 30522, lowercase: bool = True):
        self.vocab_size = int(vocab_size)
        self.lowercase = lowercase
        self.vocab: dict = {}

    @staticmethod
    def _words(text: str, lowercase: bool) -> List[str]:
        import re

        if lowercase:
            text = text.lower()
        return re.findall(r"[a-z0-9]+|[^\sa-z0-9]", text)

    def fit(self, texts: List[str]) -> "WordVocabTokenizer":
        from collections import Counter

        counts: Counter = Counter()
        for t in texts:
            counts.update(self._words(t, self.lowercase))
        self.vocab = {
            w: i + 4
            for i, (w, _) in enumerate(
                counts.most_common(self.vocab_size - 4)
            )
        }
        return self

    def __call__(
        self,
        texts: List[str],
        padding: str = "max_length",
        truncation: bool = True,
        max_length: int = 256,
        return_tensors: str = "np",
    ) -> dict:
        if not self.vocab:
            raise RuntimeError("call fit(corpus_texts) first")
        ids = np.full((len(texts), max_length), self.PAD, dtype=np.int32)
        mask = np.zeros((len(texts), max_length), dtype=np.int32)
        for r, t in enumerate(texts):
            toks = [self.CLS] + [
                self.vocab.get(w, self.UNK)
                for w in self._words(t, self.lowercase)
            ][: max_length - 2] + [self.SEP]
            ids[r, : len(toks)] = toks
            mask[r, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


def init_params(config: BertConfig, seed: int = 0) -> dict:
    """Deterministic BERT-style parameter init (N(0, 0.02), LN at identity).

    For environments without downloadable checkpoints: a fixed seed gives a
    reproducible encoder whose embeddings are stable across processes —
    enough for self-retrieval benchmarks and pipeline validation, not for
    semantic quality (use convert_hf_state_dict with real weights for that).
    """
    rng = np.random.default_rng(seed)
    std = 0.02

    def dense(n_in, n_out):
        return {
            "kernel": jnp.asarray(
                rng.normal(0, std, (n_in, n_out)).astype(np.float32)
            ),
            "bias": jnp.zeros((n_out,), dtype=jnp.float32),
        }

    def ln(n):
        return {
            "scale": jnp.ones((n,), dtype=jnp.float32),
            "bias": jnp.zeros((n,), dtype=jnp.float32),
        }

    h, ffn = config.hidden_size, config.intermediate_size
    layers = []
    for _ in range(config.num_layers):
        layers.append(
            {
                "q": dense(h, h),
                "k": dense(h, h),
                "v": dense(h, h),
                "attn_out": dense(h, h),
                "attn_ln": ln(h),
                "ffn_in": dense(h, ffn),
                "ffn_out": dense(ffn, h),
                "ffn_ln": ln(h),
            }
        )
    return {
        "embeddings": {
            "word": jnp.asarray(
                rng.normal(0, std, (config.vocab_size, h)).astype(np.float32)
            ),
            "position": jnp.asarray(
                rng.normal(0, std, (config.max_position, h)).astype(
                    np.float32
                )
            ),
            "type": jnp.asarray(
                rng.normal(0, std, (config.type_vocab_size, h)).astype(
                    np.float32
                )
            ),
            "ln": ln(h),
        },
        "layers": layers,
    }


class BertMeanPoolEncoder:
    """Jitted BERT sentence encoder over converted HF weights.

    `tokenizer` is any callable mapping a list of strings to a dict with
    "input_ids" and "attention_mask" numpy arrays (a HuggingFace tokenizer
    called with return_tensors="np" qualifies).
    """

    def __init__(
        self,
        params: dict,
        config: BertConfig,
        tokenizer=None,
        max_len: int = 256,
        compute_dtype: Optional[str] = "bfloat16",
    ) -> None:
        self.config = config
        self.params = params
        self.tokenizer = tokenizer
        self.max_len = max_len
        self.dim = config.hidden_size
        dt = jnp.dtype(compute_dtype) if compute_dtype else None
        self._apply = jax.jit(
            functools.partial(bert_encode, config=config, compute_dtype=dt)
        )

    # -- construction -----------------------------------------------------

    @classmethod
    def from_hf_torch(cls, torch_model, tokenizer=None, **kw):
        """Convert a live `transformers.BertModel` (weights stay local)."""
        config = BertConfig.from_hf(torch_model.config)
        params = convert_hf_state_dict(torch_model.state_dict(), config)
        return cls(params, config, tokenizer, **kw)

    @classmethod
    def random_init(
        cls,
        config: Optional[BertConfig] = None,
        seed: int = 0,
        corpus_texts: Optional[List[str]] = None,
        **kw,
    ):
        """Deterministic random-weight encoder with a corpus-built vocab.

        The checkpoint-free tier: same architecture and jitted device forward
        as the converted-weights path, reproducible across processes, with
        a `WordVocabTokenizer` fitted to `corpus_texts` when given. Useful
        for self-retrieval benchmarks and end-to-end pipeline validation
        where no pretrained checkpoint is available.
        """
        config = config or BertConfig()
        tok = None
        if corpus_texts is not None:
            tok = WordVocabTokenizer(vocab_size=config.vocab_size).fit(
                corpus_texts
            )
        return cls(init_params(config, seed), config, tokenizer=tok, **kw)

    @classmethod
    def from_pretrained(cls, path: str, **kw):
        """Load a local HF checkpoint directory (no network access).

        The on-device counterpart of the reference's
        SentenceTransformer("all-MiniLM-L6-v2") (bench/st_embedding.py:13):
        point at a downloaded copy of the same repo and the converted
        weights serve the same embeddings from the device.
        """
        from transformers import AutoModel, AutoTokenizer

        model = AutoModel.from_pretrained(path, local_files_only=True)
        tok = AutoTokenizer.from_pretrained(path, local_files_only=True)
        enc = cls.from_hf_torch(model, tokenizer=tok, **kw)
        del model
        return enc

    # -- encoding ----------------------------------------------------------

    def tokenize(self, texts: List[str]):
        if self.tokenizer is None:
            raise RuntimeError(
                "no tokenizer attached; construct via from_pretrained() or "
                "pass tokenizer= explicitly"
            )
        out = self.tokenizer(
            list(texts),
            padding="max_length",
            truncation=True,
            max_length=self.max_len,
            return_tensors="np",
        )
        return (
            out["input_ids"].astype(np.int32),
            out["attention_mask"].astype(np.int32),
        )

    def embed_tokens_device(self, tokens, mask) -> jax.Array:
        return self._apply(self.params, tokens=tokens, mask=mask)

    def embed_device(self, texts: List[str]) -> jax.Array:
        """Unit-norm embeddings as a device array (feed query_columnar)."""
        tokens, mask = self.tokenize(texts)
        return self.embed_tokens_device(tokens, mask)

    def embed(self, texts: List[str]) -> np.ndarray:
        return np.asarray(self.embed_device(texts))

    encode = embed
