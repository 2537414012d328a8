"""Sequence-sharded sweep over a device mesh with the GPU kernel per shard.

The database is split into D equal shards along ``mesh[axis]``. The model
stream is cut into S row chunks of R rows and swept as a wavefront: at step
t, device k scans row chunk s = t − k over its whole shard with one
``ssv_gpu_scan`` call, then ships the kernel's right-edge carry
(``final_carry``, which already holds the row −1 entry) to device k+1 with
``lax.ppermute`` — the receiver's ``init_carry`` at step t+1 is exactly the
arriving seam. Row state chains on device between steps. Each step is one
jitted ``shard_map`` dispatch, so ``abort()`` takes effect between steps and
checkpoints cut at step boundaries; the kernel's compact hit records cross
to the host once per step.
"""

from __future__ import annotations

import time
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from havac.ops.common import cdiv, round_up, sort_hit_pairs


class _RecordCapacityExceeded(RuntimeError):
    def __init__(self, nrec: int):
        super().__init__(f"record capacity exceeded (n={nrec})")
        self.nrec = nrec


_STEP_FNS = {}


def make_step_fn(mesh: Mesh, axis: str, num_chunks: int, record_cap: int,
                 interpret: bool, isolate: bool = False):
    """One wavefront step as a jitted sharded call.

    fn(codes (D·Ls,) uint8 sharded, scores (S, R, card) int8 replicated,
    resets (S, R) bool replicated, istate (D·Ls,) int32 sharded,
    seam (D, R+1) int32 sharded, t (1,) int32 replicated)
      → (istate', seam', rows (D, cap), positions (D, cap), counts (D,)),
    records and counts sharded on their leading axis. Shard-local
    coordinates: row within the chunk, position within the shard. One
    jitted function per geometry and process, so a new sweep of the same
    shapes does not recompile."""
    from havac.ops.ssv_gpu import ssv_gpu_scan

    key = (mesh, axis, num_chunks, record_cap, interpret, isolate)
    if key in _STEP_FNS:
        return _STEP_FNS[key]

    S = num_chunks
    D = mesh.shape[axis]
    perm = [(k, k + 1) for k in range(D - 1)]

    def device_fn(codes, scores, resets, istate, seam_in, t):
        k = jax.lax.axis_index(axis)
        s = t[0] - k
        active = (s >= 0) & (s < S)
        sc = jax.lax.dynamic_index_in_dim(scores, jnp.clip(s, 0, S - 1), 0,
                                          keepdims=False)
        rr = jax.lax.dynamic_index_in_dim(resets, jnp.clip(s, 0, S - 1), 0,
                                          keepdims=False)
        rows, pos, n, ostate, ocarry = ssv_gpu_scan(
            codes, sc, istate, seam_in[0], rr if isolate else None,
            cap=record_cap, interpret=interpret)
        istate = jnp.where(active, ostate, istate)
        seam_next = jax.lax.ppermute(
            jnp.where(active, ocarry, jnp.zeros_like(ocarry)), axis, perm)
        n = jnp.where(active, n, 0)
        return istate, seam_next[None], rows[None], pos[None], n[None]

    fn = jax.shard_map(
        device_fn, mesh=mesh,
        in_specs=(P(axis), P(), P(), P(axis), P(axis), P()),
        out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)),
        check_vma=False)
    _STEP_FNS[key] = jax.jit(fn)
    return _STEP_FNS[key]


class MeshSweep:
    """Stateful sequence-sharded sweep (the engine's mesh path on GPUs).

    Shards the database over ``mesh[axis]``; ``run`` sweeps the whole model
    stream in R-row wavefront steps and returns exact global hits.
    """

    def __init__(self, codes: np.ndarray, mesh: Mesh, axis: str = "seq",
                 rows_per_step: int = 512, record_cap: int = 1 << 20,
                 align: int = 512, interpret: bool = False):
        from havac.parallel.multihost import local_row_range, stage_sharded

        self.mesh = mesh
        self.axis = axis
        self.R = rows_per_step
        self.D = mesh.shape[axis]
        self.record_cap = record_cap
        self.interpret = interpret
        self.overflow_retries = 0
        self.L = codes.shape[0]
        self.shard_width = round_up(cdiv(max(self.L, 1), self.D), align)

        # Multi-host staging: each process uploads ONLY the shards its own
        # devices hold (jax.make_array_from_process_local_data assembles the
        # global array). Single-process this is the whole database.
        self._shard = NamedSharding(mesh, P(axis))
        total = self.shard_width * self.D
        lo, hi = local_row_range(total, mesh, axis)
        local = np.zeros(hi - lo, dtype=np.uint8)
        if min(hi, self.L) > lo:
            local[:min(hi, self.L) - lo] = codes[lo:min(hi, self.L)]
        self.codes_dev = stage_sharded(local, self._shard, total)
        # Per-phase wall-clock attribution (seconds), filled by run():
        #   dispatch — enqueueing wavefront steps (async)
        #   pull     — waiting for and fetching step records
        #   sort     — final (row, position) sort
        self.prof = {"dispatch": 0.0, "pull": 0.0, "sort": 0.0}

    def run(self, scores: np.ndarray,
            reset_rows: Optional[np.ndarray] = None,
            abort_event=None, progress=None, checkpoint_cb=None, resume=None,
            ckpt_every: int = 8) -> Optional[Tuple[np.ndarray, np.ndarray]]:
        """Sweep the full (P, card) int8 score stream; exact global hits
        sorted by (row, position), or None when ``abort_event`` is set.

        ``reset_rows`` (optional bool (P,)) enables model isolation. A step
        with more hits than the record buffer holds restarts the sweep at a
        larger capacity (one extra compile). ``progress(step, total)`` is
        called per dispatched step.

        ``checkpoint_cb(t_next, istate_local, istate_lo, seam_local,
        seam_lo, rows, pos)`` is called every ``ckpt_every`` steps with this
        PROCESS's shards of the device-resident scan carry plus the hits
        decoded so far; ``resume`` is a prior payload ``(t_next,
        istate_local, seam_local, rows, pos)`` to continue from."""
        while True:
            try:
                return self._run_once(scores, reset_rows, abort_event,
                                      progress, checkpoint_cb, resume,
                                      ckpt_every)
            except _RecordCapacityExceeded as exc:
                self.overflow_retries += 1
                while self.record_cap < exc.nrec:
                    self.record_cap *= 2

    def _run_once(self, scores, reset_rows, abort_event, progress,
                  checkpoint_cb, resume, ckpt_every):
        from havac.parallel.multihost import (
            device_zeros, global_count_max, local_leading_slice,
            stage_replicated, stage_sharded)

        P_, card = scores.shape
        P2 = round_up(max(P_, 1), self.R)
        S = P2 // self.R
        T = S + self.D - 1
        sc = np.full((P2, card), -128, dtype=np.int8)
        sc[:P_] = scores
        sc_dev = stage_replicated(sc.reshape(S, self.R, card), self.mesh)
        isolate = reset_rows is not None
        rr = np.zeros(P2, dtype=bool)
        if isolate:
            rr[:P_] = np.asarray(reset_rows, dtype=bool)
        rr_dev = stage_replicated(rr.reshape(S, self.R), self.mesh)
        fn = make_step_fn(self.mesh, self.axis, S, self.record_cap,
                          self.interpret, isolate=isolate)
        total = self.shard_width * self.D

        all_rows, all_pos = [], []
        start_t = 0
        if resume is not None:
            start_t, istate_local, seam_local, rows0, pos0 = resume
            istate = stage_sharded(istate_local, self._shard, total)
            seam = stage_sharded(seam_local, self._shard, self.D)
            all_rows.append(np.asarray(rows0, dtype=np.int64))
            all_pos.append(np.asarray(pos0, dtype=np.int64))
        else:
            istate = device_zeros((total,), jnp.int32, self._shard)
            seam = device_zeros((self.D, self.R + 1), jnp.int32, self._shard)
        tarr = stage_replicated(
            np.arange(T, dtype=np.int32).reshape(T, 1), self.mesh)
        pend = []  # (t, rows, pos, counts) awaiting the host

        def drain():
            """Overflow check + decode of the pending steps. The check runs
            on a replicated global max, so every process takes the same
            retry decision."""
            t0 = time.perf_counter()
            gmax = global_count_max([c for _, _, _, c in pend], self.mesh)
            if gmax is not None and gmax > self.record_cap:
                raise _RecordCapacityExceeded(gmax)
            for t, rows, pos, counts in pend:
                shards = zip(rows.addressable_shards, pos.addressable_shards,
                             counts.addressable_shards)
                for rsh, psh, csh in shards:
                    d = csh.index[0].start or 0
                    n = int(np.asarray(csh.data)[0])
                    if n > self.record_cap:
                        raise _RecordCapacityExceeded(n)
                    if n == 0:
                        continue
                    s = t - d
                    all_rows.append(np.asarray(rsh.data)[0, :n]
                                    .astype(np.int64) + s * self.R)
                    all_pos.append(np.asarray(psh.data)[0, :n]
                                   .astype(np.int64) + d * self.shard_width)
            pend.clear()
            self.prof["pull"] += time.perf_counter() - t0

        for t in range(start_t, T):
            if abort_event is not None and abort_event.is_set():
                return None
            t0 = time.perf_counter()
            istate, seam, rows, pos, counts = fn(
                self.codes_dev, sc_dev, rr_dev, istate, seam, tarr[t])
            for a in (counts, rows, pos):
                a.copy_to_host_async()
            self.prof["dispatch"] += time.perf_counter() - t0
            pend.append((t, rows, pos, counts))
            if len(pend) > 2:
                drain()
            if progress is not None:
                progress(t + 1, T)
            if (checkpoint_cb is not None and t + 1 < T
                    and (t + 1 - start_t) % ckpt_every == 0):
                drain()
                il, ilo = local_leading_slice(istate)
                sl, slo = local_leading_slice(seam)
                rows_s = (np.concatenate(all_rows) if all_rows
                          else np.empty(0, dtype=np.int64))
                pos_s = (np.concatenate(all_pos) if all_pos
                         else np.empty(0, dtype=np.int64))
                all_rows[:] = [rows_s]
                all_pos[:] = [pos_s]
                checkpoint_cb(t + 1, il, ilo, sl, slo, rows_s, pos_s)
        drain()
        if not all_rows:
            return (np.empty(0, dtype=np.int64),) * 2
        rows = np.concatenate(all_rows)
        pos = np.concatenate(all_pos)
        keep = (rows < P_) & (pos < self.L)
        t0 = time.perf_counter()
        out = sort_hit_pairs(rows[keep], pos[keep])
        self.prof["sort"] += time.perf_counter() - t0
        return out
