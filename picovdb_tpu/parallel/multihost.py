"""Multi-host bootstrap helpers.

The reference has no distributed story at all (SURVEY.md §2: no NCCL/MPI/
Gloo). Here the single-controller JAX runtime does the heavy lifting; these
helpers wire the store into it:

  * `init_distributed()` — thin wrapper over `jax.distributed.initialize`
    (coordinator address, process count and id passed in or read from the
    environment), to be called once per host process before building
    meshes.
  * `pod_mesh()` — a (dp, shard) mesh over *all* devices of all processes.
  * `load_host_shard()` — each host reads only its own rows from a sharded
    checkpoint (persistence.save_vectors_sharded layout) and participates
    in a global `jax.make_array_from_process_local_data`.

Single-host meshes (the tested path) don't need any of this — see
parallel.mesh.make_mesh.
"""

from __future__ import annotations

from typing import Optional

import numpy as np

from .. import persistence
from ..utils import round_up


def init_distributed(coordinator_address: Optional[str] = None,
                     num_processes: Optional[int] = None,
                     process_id: Optional[int] = None) -> None:
    """Initialize the JAX distributed runtime (no-op if already up)."""
    import os

    import jax

    if coordinator_address is None and not os.getenv(
        "JAX_COORDINATOR_ADDRESS"
    ):
        # single-process (no coordinator anywhere): initialize() would
        # raise 'coordinator_address should be defined' — a no-op here
        # keeps the documented contract for non-distributed callers
        return
    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id,
        )
    except RuntimeError as e:
        # Swallow ONLY the already-initialized case. A connect failure
        # (wrong/unreachable coordinator) must surface here — masked, the
        # process would run with process_count()==1 and fail later with a
        # misleading shard-count error instead of the real cause.
        msg = str(e).lower()
        if ("only be called once" not in msg
                and "already initialized" not in msg):
            raise


def pod_mesh(dp: int = 1, shard_axis: str = "shard", dp_axis: str = "dp"):
    """(dp, shard) mesh over every device of every process.

    The mesh follows the algorithm alone: the cards of one host are joined
    all to all (NVLink), so no device order is closer than another. The
    shard axis is innermost, so a shard group stays within consecutive
    devices of `jax.devices()` (one host's cards before the next host's),
    and only the rare dp-axis traffic crosses hosts.
    """
    import jax
    from jax.sharding import Mesh

    devices = np.asarray(jax.devices())
    assert devices.size % dp == 0, (devices.size, dp)
    return Mesh(devices.reshape(dp, -1), (dp_axis, shard_axis))


def load_host_shard(base: str, dim: int, mesh, shard_axis: str = "shard"):
    """Assemble the global corpus array from per-host shard files.

    Expects the `save(shards=N)` layout with N == number of processes; each
    host memory-maps only its own file, then the pieces become one global
    row-sharded jax.Array without any host ever holding the full matrix.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    # one complete generation, numerically ordered (a mixed-generation
    # directory would silently hand this process the WRONG file — the
    # corruption persistence.validated_shards exists to catch)
    paths = persistence.validated_shards(base)
    if not paths:
        raise FileNotFoundError(f"no shard files for {base}")
    pid = jax.process_index()
    if len(paths) != jax.process_count():
        raise ValueError(
            f"{len(paths)} shard files but {jax.process_count()} processes"
        )
    # Row counts not divisible by the process/device count need care on
    # two fronts (r5 review): without an explicit global_shape,
    # make_array_from_process_local_data INFERS the global rows from
    # each process's local rows — inconsistent across processes when
    # the ceil split's last shard is smaller — and jax row-sharding
    # requires even divisibility by the shard-axis device count anyway.
    # So every process pads its local block to the same device-aligned
    # row count; the zero tail rows stay inactive (the engine's active
    # mask is padded False by adopt_global).
    shapes = [np.load(p, mmap_mode="r").shape for p in paths]  # header-only
    for p, s in zip(paths, shapes):
        if len(s) != 2 or s[1] != dim:
            raise ValueError(f"shard {p} has shape {s}")
    # The writer's split is FIXED-PER (persistence.shard_split_rows):
    # shard i holds rows [i*per, min(n, (i+1)*per)). Valid layouts are
    # therefore `per` rows for every shard up to a cut, at most one
    # short shard at the cut, and empty shards after it (small corpora
    # leave the remainder BEFORE trailing empties, e.g. n=100 over 8
    # shards at align 8 -> [16,16,16,16,16,16,4,0]). Because shard i's
    # rows always sit at global positions i*per + j, padding short or
    # empty blocks up to `per` never shifts the slot <-> row
    # correspondence.
    per = shapes[0][0]
    rows_seq = [s[0] for s in shapes]
    cut = next((i for i, r in enumerate(rows_seq) if r != per),
               len(rows_seq))
    ok = (per > 0
          and all(r == per for r in rows_seq[:cut])
          and (cut >= len(rows_seq) or rows_seq[cut] < per)
          and all(r == 0 for r in rows_seq[cut + 1:]))
    if not ok:
        raise ValueError(
            f"unexpected shard row layout {rows_seq} for {base!r}; "
            "expected the fixed-per split (persistence.shard_split_rows:"
            " equal rows, at most one short shard, empties after)"
        )
    nproc = jax.process_count()
    nsh = mesh.shape[shard_axis]
    if nsh % nproc:
        raise ValueError(
            f"shard axis has {nsh} devices over {nproc} processes; "
            "devices must distribute evenly"
        )
    ldc = nsh // nproc
    if nproc > 1 and per % ldc:
        raise ValueError(
            f"non-last shards hold {per} rows, not divisible by the "
            f"{ldc} local devices on the shard axis; re-save with the "
            "current writer (persistence.SHARD_ROW_ALIGN) or use a "
            "host/device topology whose local device count divides "
            f"{per}"
        )
    # pad every short/empty block up to per (safe under the fixed-per
    # split, see above); single-process may round the lone block up to
    # its device count
    per_eff = per if nproc > 1 else round_up(max(per, 1), ldc)
    local = np.asarray(np.load(paths[pid], mmap_mode="r"))
    if local.shape[0] != per_eff:
        padded = np.zeros((per_eff, dim), dtype=local.dtype)
        padded[: local.shape[0]] = local
        local = padded
    sharding = NamedSharding(mesh, P(shard_axis, None))
    return jax.make_array_from_process_local_data(
        sharding, local, global_shape=(per_eff * nproc, dim)
    )
