"""Active-index bookkeeping and counters.

Mirrors tests/test_task1_active_indices.py, test_task2_numpy_query_active_indices.py
and test_task8_count_and_size.py of the reference.
"""

import numpy as np
import pytest

from picovdb_tpu import PicoVectorDB, K_ID, K_VECTOR
from conftest import make_items


def test_active_indices_track_mutations(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, _ = make_items(rng, 6, 8)
    db.upsert(items)
    assert sorted(db._active_indices.tolist()) == list(range(6))
    assert db._active_mask.sum() == 6

    db.delete(["id2", "id4"])
    assert sorted(db._active_indices.tolist()) == [0, 1, 3, 5]
    assert not db._active_mask[2] and not db._active_mask[4]

    v = rng.normal(size=8).astype(np.float32)
    db.upsert([{K_ID: "new", K_VECTOR: v}])
    # recycled one of the free slots
    assert sorted(db._active_indices.tolist()) in ([0, 1, 2, 3, 5], [0, 1, 3, 4, 5])


def test_active_indices_survive_reload(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, _ = make_items(rng, 6, 8)
    db.upsert(items)
    db.delete(["id0"])
    db.save()
    db2 = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    assert sorted(db2._active_indices.tolist()) == [1, 2, 3, 4, 5]
    assert db2._free == [0]
    assert db2._id2idx == {f"id{i}": i for i in range(1, 6)}


def test_deleted_rows_never_surface(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, vecs = make_items(rng, 10, 8)
    db.upsert(items)
    db.delete([f"id{i}" for i in range(5)])
    res = db.query(vecs[0], top_k=10)
    assert len(res) == 5
    assert all(int(r[K_ID][2:]) >= 5 for r in res)


def test_topk_bounded_by_actives(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, vecs = make_items(rng, 4, 8)
    db.upsert(items)
    res = db.query(vecs[0], top_k=50)
    assert len(res) == 4


def test_count_capacity_len_size(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, _ = make_items(rng, 5, 8)
    db.upsert(items)
    db.delete(["id1"])
    assert db.count() == 4
    assert len(db) == 4
    assert db.capacity() == 5
    with pytest.deprecated_call():
        assert db.size() == 5


def test_vacuum_compacts(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, vecs = make_items(rng, 10, 8)
    db.upsert(items)
    db.delete(["id0", "id5", "id9"])
    db.vacuum()
    assert db.count() == 7
    assert db.capacity() == 7
    assert db._free == []
    assert sorted(db._active_indices.tolist()) == list(range(7))
    res = db.query(vecs[3], top_k=1)
    assert res[0][K_ID] == "id3"
    # vacuum with nothing to do is a no-op
    db.vacuum()
    assert db.capacity() == 7


def test_stats_fields(db_path, rng):
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path)
    items, _ = make_items(rng, 5, 8)
    db.upsert(items)
    db.delete(["id0"])
    db.save()
    s = db.stats()
    assert s["active"] == 4
    assert s["deleted"] == 1
    assert s["total"] == 5
    assert s["dim"] == 8
    assert s["memmap"] is False
    assert f"{db_path.split('/')[-1]}.vecs.npy" in " ".join(s["file_sizes"].keys())
    assert s["index_kind"] in ("auto", "exact", "ivf")
    assert s["ann_postings"] in (
        None, "storage", "storage+int8", "int8-only"
    )
    assert s["storage_dtype"] == "float32"
    assert set(s["rescore"]) == {"mode", "guard", "max_q", "last"}
    assert s["rescore"]["mode"] == "auto"


def test_stats_rescore_reflects_int4_guard(db_path, rng):
    """int4 stores report the widened default guard and last-query
    rescore application through stats()."""
    db = PicoVectorDB(embedding_dim=8, storage_file=db_path + "_i4",
                      storage_dtype="int4")
    items, _ = make_items(rng, 5, 8)
    db.upsert(items)
    db.query(np.asarray(items[1][K_VECTOR], dtype=np.float32), top_k=2)
    s = db.stats()
    assert s["storage_dtype"] == "int4"
    assert s["rescore"]["guard"] == 512  # 4x the 128 default
    assert s["rescore"]["last"] == "host"
