"""Text-RAG demo: chunk -> embed -> index -> query (+ self-retrieval check).

Counterpart of the reference's text demos (bench/st_embedding.py,
bench/local_embedding_index.py, bench/local_embedding_query.py,
bench/hf_upserts.py, bench/hf_query.py) without their network/model
downloads: embeds with the dependency-free HashingEmbedder by default, the
on-device FlaxMeanPoolEncoder with --embedder flax, a real converted HF BERT
checkpoint (MiniLM etc.) run on-device with --embedder bert --model-path DIR,
or sentence-transformers with --embedder st when installed. The
self-retrieval pass mirrors the reference's recall-style mismatch counting
(bench/hf_query.py:38-52).

Usage:
  python bench/rag_demo.py [--text path/to/book.txt] [--chunk 256]
                           [--embedder hashing|flax|bert|st]
                           [--model-path DIR] [--query "..."]
"""

import argparse
import os
import time

import set_path  # noqa: F401
from picovdb_tpu import PicoVectorDB, K_ID, K_METRICS, K_VECTOR

SAMPLE = """
The archive keeps every observation the station has ever made: pressure
readings from the pass, snow depth at the tree line, the slow migration of
the glacier's terminus year over year. Researchers query it by similarity,
not by key. A question about avalanche conditions in late spring pulls up
field notes from three different decades. The index does not care when a
note was written; it cares what the note is about.

Down in the valley the weather is a different animal entirely. Rain shadows
carve dry channels through otherwise soaked terrain, and the vineyard crews
read humidity off the morning fog instead of any instrument. Their notes
talk about budbreak, frost fans, and the smell of the soil after the first
warm week. When the archive answers a valley question with a mountain note,
someone files a correction, and the embeddings drift a little closer to the
truth.

Shipping manifests are the archive's third voice. Crates of instruments
come up the switchback road twice a season: anemometers, radiosondes, spare
solar panels, and once, famously, a crate of lemons mislabeled as optical
filters. The manifest notes are terse and full of part numbers, nothing
like the field journals, and the index learned quickly to keep them apart.

The station cook keeps a log too. Bread rises slower at altitude; stews
want an extra hour; the espresso machine needs a different grind when the
front comes through. Nobody planned for the cook's log to enter the
archive, but the researchers kept asking it questions — what did we eat
during the storm of September? — and the answers kept being useful.
"""


def chunk_text(text: str, size: int):
    text = " ".join(text.split())
    return [text[i : i + size] for i in range(0, len(text), size) if text[i : i + size].strip()]


def main():
    p = argparse.ArgumentParser()
    p.add_argument("--text", help="path to a .txt corpus (default: built-in sample)")
    p.add_argument("--chunk", type=int, default=256)
    p.add_argument("--embedder",
                   choices=["hashing", "flax", "bert", "bert-random", "st"],
                   default="hashing")
    p.add_argument("--device-pipeline", action="store_true",
                   help="keep embeddings device-resident end to end: "
                        "encoder output feeds ingest_device (corpus) and "
                        "query_columnar (queries) with zero vector host "
                        "traffic — the fully on-device RAG path")
    p.add_argument("--batch", type=int, default=64,
                   help="encoder batch size (chunks per forward pass)")
    p.add_argument("--platform", choices=["auto", "cpu"], default="auto",
                   help="cpu: force the CPU backend (set in the live "
                        "jax config, which also works when jax was "
                        "imported before the env var could apply)")
    p.add_argument("--model-path",
                   help="local HF checkpoint dir for --embedder bert (e.g. a "
                        "downloaded copy of sentence-transformers/"
                        "all-MiniLM-L6-v2); weights are converted and run "
                        "on-device via models.bert_encoder")
    p.add_argument("--dim", type=int, default=384)
    p.add_argument("--query", default="what does the index do with questions")
    p.add_argument("--topk", type=int, default=3)
    args = p.parse_args()

    if args.platform == "cpu":
        import jax

        jax.config.update("jax_platforms", "cpu")

    text = open(args.text, encoding="utf-8").read() if args.text else SAMPLE
    chunks = chunk_text(text, args.chunk)
    print(f"{len(chunks)} chunks of ~{args.chunk} chars")

    if args.embedder == "hashing":
        from picovdb_tpu.models import HashingEmbedder

        emb = HashingEmbedder(dim=args.dim)
    elif args.embedder == "flax":
        from picovdb_tpu.models import FlaxMeanPoolEncoder

        emb = FlaxMeanPoolEncoder(dim=args.dim)
    elif args.embedder == "bert":
        if not args.model_path:
            raise SystemExit(
                "--embedder bert needs --model-path <local HF checkpoint "
                "dir> (this environment has no network access to download "
                "one; any BertModel-architecture sentence embedder works)"
            )
        from picovdb_tpu.models import BertMeanPoolEncoder

        emb = BertMeanPoolEncoder.from_pretrained(args.model_path)
        args.dim = emb.dim
    elif args.embedder == "bert-random":
        # Checkpoint-free on-device BERT: deterministic random weights +
        # corpus-built word vocab. Embeddings are reproducible and
        # discriminative enough for self-retrieval (each chunk must rank
        # itself first), which is what the reference's mismatch counter
        # measures (bench/hf_query.py:38-52) — semantic quality needs real
        # weights (--embedder bert).
        from picovdb_tpu.models import BertMeanPoolEncoder

        emb = BertMeanPoolEncoder.random_init(corpus_texts=chunks)
        args.dim = emb.dim
    else:
        from picovdb_tpu.models.torch_st import TorchSentenceEmbedder

        emb = TorchSentenceEmbedder()
        args.dim = emb.dim

    metadata = [{"text": c} for c in chunks]
    ids = [f"chunk{i}" for i in range(len(chunks))]

    if args.device_pipeline:
        # Fully on-device path: chunk embeddings never visit the host. The
        # encoder's jitted forward writes straight to HBM; ingest_device
        # adopts the matrix; query embeddings go device->device into
        # query_columnar.
        import jax.numpy as jnp

        if not hasattr(emb, "embed_device"):
            raise SystemExit(
                f"--device-pipeline needs an on-device embedder; "
                f"{args.embedder!r} embeds on host"
            )
        t0 = time.perf_counter()
        parts = [
            emb.embed_device(chunks[s : s + args.batch])
            for s in range(0, len(chunks), args.batch)
        ]
        vecs_dev = parts[0] if len(parts) == 1 else jnp.concatenate(parts)
        vecs_dev.block_until_ready()
        t_embed = time.perf_counter() - t0
        print(f"embedding (on-device): {t_embed:.2f} s "
              f"({len(chunks)/t_embed:.0f} chunks/s)")
        for suffix in (".ids.json", ".meta.json", ".vecs.npy"):
            if os.path.exists("rag_demo_db" + suffix):
                os.remove("rag_demo_db" + suffix)  # ingest needs a fresh store
        db = PicoVectorDB(embedding_dim=args.dim, storage_file="rag_demo_db")
        db.ingest_device(vecs_dev, ids=ids, metadata=metadata)
        vecs = None
    else:
        t0 = time.perf_counter()
        vecs = emb.embed(chunks)
        print(f"embedding: {time.perf_counter() - t0:.2f} s")
        db = PicoVectorDB(embedding_dim=args.dim, storage_file="rag_demo_db")
        db.upsert(
            [
                {K_ID: ids[i], K_VECTOR: vecs[i], "text": chunks[i]}
                for i in range(len(chunks))
            ]
        )
    db.save()

    qvec = (
        emb.embed_device([args.query])
        if args.device_pipeline
        else emb.embed([args.query])[0]
    )
    res = db.query(qvec, top_k=args.topk)
    if args.device_pipeline:
        res = res[0]
    print(f"\nquery: {args.query!r}")
    for r in res:
        print(f"  {r[K_METRICS]:.3f} {r[K_ID]}: {r['text'][:90]}…")

    # self-retrieval: each chunk's own embedding must rank itself first
    # (the reference's mismatch counter, bench/hf_query.py:38-52)
    t0 = time.perf_counter()
    if args.device_pipeline:
        sids, _scores = db.query_columnar(vecs_dev, top_k=1)
        hits_ids = [s[0] if len(s) else None for s in sids]
    else:
        results = db.query_batched(vecs, top_k=1)
        hits_ids = [h[0][K_ID] if h else None for h in results]
    mismatches = sum(
        1 for i, hid in enumerate(hits_ids) if hid != f"chunk{i}"
    )
    print(f"\nself-retrieval mismatches: {mismatches}/{len(chunks)} "
          f"({time.perf_counter()-t0:.2f} s)")


if __name__ == "__main__":
    main()
