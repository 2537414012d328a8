"""Pipelined single-device sweep: hit drain overlaps the DP sweep.

The reference overlaps its hit-filter tree with the PE sweep via HLS DATAFLOW
FIFOs (`device/HavacHls.cpp:49,190`; SURVEY.md §2.5 "pipeline parallelism").
Here JAX's async dispatch plays that role: the engine enqueues up to
``lookahead`` chunks before it touches the oldest chunk's outputs, so the
host-side sort and resolve of chunk i run while the device sweeps the later
chunks. All chain state — the boundary-carry column between column chunks and
the row state between row chunks — stays on device; the only transfers per
chunk are the hit count and the kernel's compact ``(row, position)`` records.

Every chunk has the same shape (the last row and column chunks are padded),
so one sweep compiles the kernel once per record capacity. The capacity
adapts: a chunk with more hits than the buffer holds is redispatched from its
retained inputs at a larger capacity, which then serves the rest of the run.
"""

from __future__ import annotations

import functools
import threading
import time
from concurrent.futures import ThreadPoolExecutor
from typing import Dict, List, Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np

from havac.ops.common import cdiv, round_up, sort_hit_pairs
from havac.ops.ssv_gpu import ssv_gpu_scan

LOOKAHEAD = 3  # chunks in flight; hides one dispatch + pull round trip


@functools.partial(jax.jit, static_argnames=("chunk", "cap", "interpret"))
def _step(codes, lo, scores, istate, icarry, reset, *, chunk: int, cap: int,
          interpret: bool):
    """One chunk scan: slice the staged codes on device, run the kernel."""
    sym = jax.lax.dynamic_slice_in_dim(codes, lo, chunk)
    return ssv_gpu_scan(sym, scores, istate, icarry, reset, cap=cap,
                        interpret=interpret)


_RESOLVED_FIELDS = ("sequence_index", "sequence_position", "phmm_index",
                    "phmm_position")


def _runs_order(rows, pos, run_sizes):
    """Permutation (row, pos)-sorting the concatenation of already-sorted
    runs (run r has run_sizes[r] entries); None means identity (single
    run). O(n·log k) native pairwise merge when built, full composite-key
    sort otherwise. Single-threaded natives: callers fan groups out over a
    pool already."""
    if len(run_sizes) <= 1:
        return None
    try:
        from havac import native
    except Exception:  # pragma: no cover
        native = None
    if native is not None:
        offs = np.cumsum([0] + list(run_sizes))
        order = native.merge_runs_native(rows, pos, offs, nthreads=1)
        if order is None:
            order = native.sort_order_native(rows, pos, nthreads=1)
        if order is not None:
            return order
    from havac.ops.common import hit_sort_order

    return hit_sort_order(rows, pos)


def _merge_results_sorted(results, n_row, pool):
    """Globally sorted (rows, positions) from per-chunk parts that are each
    already (row, pos)-sorted: per-row-group k-way merges fanned across the
    pool (groups cover disjoint row ranges, so group slices stacked in ri
    order are globally sorted)."""
    groups = [[] for _ in range(n_row)]
    for ri, r, p, _ in results:
        if r.size:
            groups[ri].append((r, p))
    sizes = [sum(r.size for r, _ in g) for g in groups]
    total = sum(sizes)
    if not total:
        e = np.empty(0, dtype=np.int64)
        return e, e.copy()
    out_r = np.empty(total, dtype=np.int64)
    out_p = np.empty(total, dtype=np.int64)
    offs = np.cumsum([0] + sizes)

    def job(g, lo, hi):
        rows = np.concatenate([r for r, _ in g])
        pos = np.concatenate([p for _, p in g])
        order = _runs_order(rows, pos, [r.size for r, _ in g])
        if order is None:
            out_r[lo:hi], out_p[lo:hi] = rows, pos
        else:
            out_r[lo:hi], out_p[lo:hi] = rows[order], pos[order]

    futs = [pool.submit(job, g, offs[i], offs[i + 1])
            for i, g in enumerate(groups) if g]
    for f in futs:
        f.result()
    return out_r, out_p


def _merge_group_into(parts, cols, lo: int, hi: int):
    """Merge one row-chunk group's (ResolvedHits, kept_rows, kept_pos) parts
    by raw (row, position) key, writing the permuted columns directly into
    rows [lo, hi) of the preallocated result columns. Each part arrives
    already (row, pos)-sorted, so this is a k-way merge of sorted runs."""
    krows = [r for _, r, _ in parts if r.size]
    if not krows:
        return
    rows = np.concatenate(krows)
    pos = np.concatenate([p for _, _, p in parts if p.size])
    order = _runs_order(rows, pos, [r.size for r in krows])
    for f, out_col in zip(_RESOLVED_FIELDS, cols):
        col = np.concatenate([np.ascontiguousarray(getattr(t, f))
                              for t, _, _ in parts if len(t)])
        out_col[lo:hi] = col if order is None else col[order]


def _concat_resolved(results, n_row, pool):
    """Merge per-chunk (ri, rows, pos, (ResolvedHits, kept_rows, kept_pos))
    entries into one globally (row, position)-sorted table. Row-chunk groups
    cover disjoint row ranges, so each group merges independently on the
    pool and writes its slice of the final columns in place."""
    from havac.hits.decode import ResolvedHits

    groups = [[] for _ in range(n_row)]
    for ri, _, _, res in results:
        if res is not None:
            groups[ri].append(res)
    sizes = [sum(r.size for _, r, _ in g) for g in groups]
    total = sum(sizes)
    if not total:
        return ResolvedHits(*(np.empty(0, dtype=np.int64),) * 4)
    dt = next(t.sequence_index.dtype for g in groups for t, _, _ in g
              if len(t))
    cols = [np.empty(total, dtype=dt) for _ in _RESOLVED_FIELDS]
    offs = np.cumsum([0] + sizes)
    futs = [pool.submit(_merge_group_into, g, cols, offs[i], offs[i + 1])
            for i, g in enumerate(groups) if g]
    for f in futs:
        f.result()
    return ResolvedHits(*cols)


class PipelinedSweep:
    """Chunked (column × row) sweep with ``lookahead`` chunks in flight."""

    def __init__(self, codes: np.ndarray, scores: np.ndarray,
                 chunk_symbols: int, chunk_rows: int,
                 reset_rows: Optional[np.ndarray] = None,
                 resolve_fn=None, record_cap: int = 1 << 20,
                 align: int = 512, interpret: bool = False) -> None:
        self.L = codes.shape[0]
        self.P = scores.shape[0]
        self.interpret = interpret
        self.record_cap = int(record_cap)
        self.overflow_retries = 0
        self.raw_parts = None
        # Per-chunk resolution in the collector pool: resolve_fn(rows, pos)
        # -> (ResolvedHits, kept_rows, kept_pos). None = caller resolves
        # after the run.
        self._resolve_fn = resolve_fn
        self._lookahead = LOOKAHEAD
        # Per-phase wall-clock attribution (seconds), filled by run():
        #   dispatch  — enqueueing chunk scans (async, host side)
        #   gate_wait — main thread waiting on the oldest chunk's records
        #               (the pipeline bubble when the device is behind)
        #   resolve   — collectors sorting + resolving chunk hits
        #   drain     — final drain after the last dispatch
        #   tail_sort — merging the per-chunk tables into one sorted table
        self.prof: Dict[str, float] = {
            "dispatch": 0.0, "gate_wait": 0.0, "resolve": 0.0,
            "drain": 0.0, "tail_sort": 0.0}
        self._prof_lock = threading.Lock()  # resolve accrues from workers

        # Uniform chunk shapes: one compile per record capacity.
        self.n_row = max(1, cdiv(self.P, max(1, chunk_rows)))
        self.rchunk = cdiv(self.P, self.n_row)
        self.n_col = max(1, cdiv(self.L, max(1, chunk_symbols)))
        self.chunk = round_up(cdiv(self.L, self.n_col), align)
        L2 = self.n_col * self.chunk
        padded = np.zeros(L2, dtype=np.uint8)
        padded[:self.L] = codes
        self._codes_dev = jnp.asarray(padded)

        # Per-row-chunk scores (padded rows score -128: they never hit) and
        # reset flags under model isolation, staged once.
        card = scores.shape[1]
        self._scores_dev: List = []
        self._reset_dev: List = []
        for ri in range(self.n_row):
            r0, r1 = ri * self.rchunk, min(self.P, (ri + 1) * self.rchunk)
            sc = np.full((self.rchunk, card), -128, dtype=np.int8)
            sc[:r1 - r0] = scores[r0:r1]
            self._scores_dev.append(jnp.asarray(sc))
            if reset_rows is None:
                self._reset_dev.append(None)
            else:
                rr = np.zeros(self.rchunk, dtype=bool)
                rr[:r1 - r0] = np.asarray(reset_rows[r0:r1], dtype=bool)
                self._reset_dev.append(jnp.asarray(rr))

    # ------------------------------------------------------------ dispatch

    def _dispatch(self, ci: int, ri: int, istate, icarry, cap: int):
        return _step(self._codes_dev, jnp.int32(ci * self.chunk),
                       self._scores_dev[ri], istate, icarry,
                       self._reset_dev[ri], chunk=self.chunk, cap=cap,
                       interpret=self.interpret)

    def warm(self) -> None:
        """Compile the chunk scan now: dispatch chunk 0's shapes with zero
        state and wait for it."""
        out = self._dispatch(0, 0, jnp.zeros(self.chunk, jnp.int32),
                             jnp.zeros(self.rchunk + 1, jnp.int32),
                             self.record_cap)
        jax.block_until_ready(out)

    # -------------------------------------------------------------- drain

    def _chunk_hits(self, rrow, rpos, n: int, ri: int, ci: int):
        """Collector-pool job: one chunk's records → sorted global (rows,
        positions) inside the real matrix, resolved when a resolver is
        installed. Workers never touch jax."""
        t0 = time.perf_counter()
        r0, lo = ri * self.rchunk, ci * self.chunk
        rows = rrow[:n].astype(np.int64) + r0
        pos = rpos[:n].astype(np.int64) + lo
        keep = (rows < self.P) & (pos < self.L)
        rows, pos = sort_hit_pairs(rows[keep], pos[keep])
        res = None if self._resolve_fn is None else self._resolve_fn(rows,
                                                                    pos)
        with self._prof_lock:
            self.prof["resolve"] += time.perf_counter() - t0
        return ri, rows, pos, res

    # ----------------------------------------------------------------- run

    def run(self, abort_event=None, progress=None, checkpoint_cb=None,
            resume=None):
        """Full pipelined sweep; returns (rows, positions, resolved,
        sweep_seconds) or None if aborted. ``resolved`` is the globally
        sorted ResolvedHits table when a ``resolve_fn`` is installed — rows
        and positions are then None, and the raw per-chunk parts are kept on
        ``self.raw_parts`` for lazy materialization. Without a resolver,
        ``resolved`` is None and (rows, positions) are globally sorted.

        ``checkpoint_cb(next_ci, carries (n_row, rchunk+1) int32, rows,
        pos)`` is called after every completed column chunk (the pipeline
        drains at that boundary). ``resume`` is a prior callback payload
        ``(next_ci, carries, rows, pos)`` to continue from."""
        t_start = time.perf_counter()
        futures: List = []
        pend: List = []  # (out, istate, icarry, cap, ri, ci) awaiting pull
        results: List[Tuple] = []
        done = 0
        start_ci = 0
        prev_col_carry: Dict[int, object] = {}
        if resume is not None:
            start_ci, carries, rows0, pos0 = resume
            for ri in range(self.n_row):
                prev_col_carry[ri] = jnp.asarray(carries[ri])
            # Checkpoint payloads span every row chunk; split them back into
            # per-ri (row, pos)-sorted parts for the group merge.
            gidx = np.minimum(rows0 // self.rchunk, self.n_row - 1)
            for ri in range(self.n_row):
                rs, ps = sort_hit_pairs(rows0[gidx == ri], pos0[gidx == ri])
                res0 = (self._resolve_fn(rs, ps)
                        if self._resolve_fn is not None else None)
                results.append((ri, rs, ps, res0))
            done = start_ci * self.n_row

        with ThreadPoolExecutor(max_workers=4) as pool:

            def drain_one():
                out, istate, icarry, cap, ri, ci = pend.pop(0)
                t0 = time.perf_counter()
                n = int(out[2])
                while n > cap:
                    # Rare: more hits than the buffer holds. Grow it from the
                    # observed count and re-run this chunk from its retained
                    # inputs; later chunks dispatch at the grown capacity.
                    self.record_cap = max(self.record_cap,
                                          round_up(n + n // 2, 4096))
                    self.overflow_retries += 1
                    cap = self.record_cap
                    out = self._dispatch(ci, ri, istate, icarry, cap)
                    n = int(out[2])
                rrow, rpos = np.asarray(out[0]), np.asarray(out[1])
                self.prof["gate_wait"] += time.perf_counter() - t0
                futures.append(pool.submit(self._chunk_hits, rrow, rpos, n,
                                           ri, ci))

            for ci in range(start_ci, self.n_col):
                istate = jnp.zeros(self.chunk, jnp.int32)
                col_carry: Dict[int, object] = {}
                for ri in range(self.n_row):
                    if abort_event is not None and abort_event.is_set():
                        for f in futures:
                            f.result()  # drain workers before bailing
                        return None
                    icarry = prev_col_carry.get(ri)
                    if icarry is None:
                        icarry = jnp.zeros(self.rchunk + 1, jnp.int32)
                    t0 = time.perf_counter()
                    cap = self.record_cap
                    out = self._dispatch(ci, ri, istate, icarry, cap)
                    for a in out[:3]:
                        a.copy_to_host_async()
                    self.prof["dispatch"] += time.perf_counter() - t0
                    pend.append((out, istate, icarry, cap, ri, ci))
                    while len(pend) >= self._lookahead:
                        drain_one()
                    istate = out[3]  # chain row state on device
                    col_carry[ri] = out[4]  # chain carry on device
                    done += 1
                    if progress is not None:
                        progress(done)
                prev_col_carry = col_carry
                if checkpoint_cb is not None and ci + 1 < self.n_col:
                    while pend:
                        drain_one()
                    results += [f.result() for f in futures]
                    futures.clear()
                    carries = np.stack([np.asarray(prev_col_carry[ri])
                                        for ri in range(self.n_row)])
                    rows_s, pos_s = _merge_results_sorted(results,
                                                          self.n_row, pool)
                    checkpoint_cb(ci + 1, carries, rows_s, pos_s)
            t_drain = time.perf_counter()
            while pend:
                drain_one()
            results += [f.result() for f in futures]
            self.prof["drain"] += time.perf_counter() - t_drain

            t_tail = time.perf_counter()
            resolved = None
            if self._resolve_fn is not None:
                resolved = _concat_resolved(results, self.n_row, pool)
                self.raw_parts = [(r, p) for _, r, p, _ in results]
                rows = pos = None
            else:
                rows, pos = _merge_results_sorted(results, self.n_row, pool)
            self.prof["tail_sort"] = time.perf_counter() - t_tail
        return rows, pos, resolved, time.perf_counter() - t_start
