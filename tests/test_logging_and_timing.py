"""Logging behavior: quiet by default, INFO opt-in, DEBUG op timings.

Mirrors tests/test_task4_logging.py and tests/test_timing_logs.py.
"""

import logging

import numpy as np

from picovdb_tpu import PicoVectorDB
from conftest import make_items


def test_quiet_at_default_level(db_path, rng, caplog):
    with caplog.at_level(logging.WARNING, logger="picovdb_tpu"):
        db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
        items, vecs = make_items(rng, 5, 8)
        db.upsert(items)
        db.query(vecs[0])
        db.save()
    assert caplog.records == []


def test_info_logs_on_load_and_save(db_path, rng, caplog):
    with caplog.at_level(logging.INFO, logger="picovdb_tpu"):
        db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
        items, _ = make_items(rng, 5, 8)
        db.upsert(items)
        db.save()
        PicoVectorDB(embedding_dim=8, storage_file=db_path)
    messages = [r.getMessage() for r in caplog.records]
    assert any("fresh DB" in m for m in messages)
    assert any("Saved 5 vectors" in m for m in messages)
    assert any("Loaded 5 active / 5 total" in m for m in messages)


def test_debug_timing_logs(db_path, rng, caplog):
    with caplog.at_level(logging.DEBUG, logger="picovdb_tpu"):
        db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
        items, vecs = make_items(rng, 5, 8)
        db.upsert(items)
        db.query(vecs[0])
        db.save()
    messages = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("load took") for m in messages)
    assert any(m.startswith("query took") for m in messages)
    assert any(m.startswith("save took") for m in messages)


def test_memmap_append_warns(db_path, rng, caplog):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path, use_memmap=True,
                      capacity=3)
    items, _ = make_items(rng, 3, 8)
    db.upsert(items)
    db.save()
    # reload without capacity: appending converts memmap to RAM with a warning
    db2 = PicoVectorDB(embedding_dim=8, storage_file=db_path, use_memmap=True)
    with caplog.at_level(logging.WARNING, logger="picovdb_tpu"):
        db2.upsert(
            [{"_id_": "x", "_vector_": rng.normal(size=8).astype(np.float32)}]
        )
    assert any("memmap" in r.getMessage() for r in caplog.records)
    assert db2.count() == 4
