"""Multi-host orchestration: jax.distributed + global mesh + per-host IO.

The reference has no distributed transport (its only "transport" is XRT PCIe
buffer sync, `host/HavacHwClient.cpp:104,132`); scaling past one host is new
scope (SURVEY.md §2.5). The recipe — executed end-to-end by
tests/test_multihost.py with two real OS processes over a CPU mesh:

  1. every host calls :func:`initialize` (JAX's distributed runtime over
     the network; in tests, localhost TCP);
  2. :func:`global_sequence_mesh` builds one mesh over all devices of all
     hosts; the engine's wavefront path then runs unchanged — XLA routes the
     per-step seam `ppermute` over NVLink within a host and the network
     across hosts (one R-entry int32 vector per seam per step, negligible vs
     the sweep);
  3. each host packs and stages ONLY its local shard of the database
     (:func:`host_local_codes` for the slice, :func:`stage_sharded` /
     `jax.make_array_from_process_local_data` for assembly into the global
     sharded array) — no process ever materializes the full device array;
  4. hit decode runs on the host that owns the shard
     (`MeshSweep` decodes its addressable record shards only;
     coordinates are global, so concatenating per-host outputs gives the
     exact global hit list).

On a single host every helper degrades to plain device_put/mesh, so the
same code path is exercised by the single-process CPU-mesh suite.
"""

from __future__ import annotations

from typing import Optional, Tuple

import numpy as np


def initialize(coordinator_address: Optional[str] = None,
               num_processes: Optional[int] = None,
               process_id: Optional[int] = None) -> None:
    """Initialize JAX's distributed runtime (no-op if already initialized).
    Pass the coordinator address, process count and process id: nothing
    detects a cluster on its own."""
    import jax

    try:
        jax.distributed.initialize(
            coordinator_address=coordinator_address,
            num_processes=num_processes,
            process_id=process_id)
    except RuntimeError as exc:  # already initialized
        if "already" not in str(exc).lower():
            raise


def global_sequence_mesh(axis: str = "seq"):
    """1-D mesh over every device of every host."""
    import jax
    from jax.sharding import Mesh

    return Mesh(np.array(jax.devices()), (axis,))


def host_local_codes(codes: np.ndarray, mesh, axis: str = "seq"
                     ) -> Tuple[np.ndarray, int]:
    """This process's contiguous slice of the database + its global offset.

    With :func:`stage_sharded`, each host materializes only its slice of the
    sharded codes array instead of the full database."""
    import jax

    D = mesh.shape[axis]
    L = codes.shape[0]
    shard = -(-L // D)
    procs = jax.process_count()
    if procs and D % procs:
        # Silent degradation here (process 0 taking everything) would be
        # wrong sharding, not a fallback — refuse instead.
        raise ValueError(
            f"mesh axis {axis!r} of size {D} is not divisible by "
            f"process_count={procs}; lay the mesh out so each host owns an "
            f"equal contiguous span of the sequence axis")
    per_host = D // procs if procs else D
    lo = jax.process_index() * per_host * shard
    hi = min(L, lo + per_host * shard)
    return codes[lo:hi], lo


def local_row_range(total_rows: int, mesh, axis: str) -> Tuple[int, int]:
    """[lo, hi) of the leading-axis rows this process's shards cover under a
    1-D NamedSharding P(axis) over ``total_rows`` rows."""
    import jax

    D = mesh.shape[axis]
    procs = jax.process_count()
    if D % procs:
        raise ValueError(f"axis {axis!r} size {D} not divisible by "
                         f"{procs} processes")
    per = total_rows // D * (D // procs)
    lo = jax.process_index() * per
    return lo, lo + per


def stage_sharded(local_rows: np.ndarray, sharding, global_rows: int):
    """Assemble a global array sharded on its leading axis from this
    process's contiguous row slice (`jax.make_array_from_process_local_data`;
    plain device_put single-process). ``local_rows`` must be exactly the
    rows this process's devices own under ``sharding``."""
    import jax
    import jax.numpy as jnp

    global_shape = (global_rows,) + tuple(local_rows.shape[1:])
    if jax.process_count() == 1:
        assert local_rows.shape[0] == global_rows
        return jax.device_put(jnp.asarray(local_rows), sharding)
    return jax.make_array_from_process_local_data(
        sharding, np.ascontiguousarray(local_rows), global_shape)


def local_leading_slice(arr) -> Tuple[np.ndarray, int]:
    """This process's contiguous leading-axis rows of a P(axis)-sharded
    array, plus their global row offset — the host-resident form used by
    mesh-path checkpoints (each process persists only the shards it owns;
    :func:`stage_sharded` reassembles them on resume)."""
    shards = sorted(arr.addressable_shards,
                    key=lambda s: s.index[0].start or 0)
    lo = shards[0].index[0].start or 0
    return np.concatenate([np.asarray(s.data) for s in shards]), lo


_ZEROS_FNS = {}


def device_zeros(shape, dtype, sharding):
    """Sharded all-zeros array materialized directly on device (no host
    copy, multi-host safe). The jitted builder is cached per
    (shape, dtype, sharding) — a fresh jit per call would pay a
    compile on every distributed run."""
    import jax
    import jax.numpy as jnp

    key = (tuple(shape), jnp.dtype(dtype).name, sharding)
    if key not in _ZEROS_FNS:
        _ZEROS_FNS[key] = jax.jit(lambda: jnp.zeros(shape, dtype),
                                  out_shardings=sharding)
    return _ZEROS_FNS[key]()


_COUNT_MAX_FNS = {}


def global_count_max(counts_list, mesh):
    """Global max over per-step record counts ((D,) arrays sharded on the
    mesh axis), replicated to every process — multi-host capacity-retry
    decisions must be identical on all hosts (a host that only saw its own
    shards overflow would recompile with a bigger capacity while the others
    don't, and the next collective would deadlock). Returns None
    single-process, where the local decode already sees every shard."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    if jax.process_count() == 1 or not counts_list:
        return None
    if mesh not in _COUNT_MAX_FNS:
        rep = NamedSharding(mesh, PartitionSpec())
        _COUNT_MAX_FNS[mesh] = jax.jit(
            lambda c, m: jnp.maximum(m, jnp.max(c)), out_shardings=rep)
    m = device_zeros((), jnp.int32, NamedSharding(mesh, PartitionSpec()))
    for c in counts_list:
        m = _COUNT_MAX_FNS[mesh](c, m)
    return int(np.asarray(m))


def stage_replicated(value: np.ndarray, mesh):
    """Replicate a host-identical array across every device of the mesh
    (every process passes the same value)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec

    rep = NamedSharding(mesh, PartitionSpec())
    if jax.process_count() == 1:
        return jax.device_put(jnp.asarray(value), rep)
    value = np.ascontiguousarray(value)
    return jax.make_array_from_process_local_data(rep, value, value.shape)
