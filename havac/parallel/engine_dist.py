"""Distributed engine sweep: chainable wavefront with on-device hit compaction.

`havac.parallel.wavefront` proves the exact wavefront pipeline; this
module is its chainable form for the engine's XLA backend (BASELINE config 3
— full model DB vs a chromosome, sequence-sharded across one host's
devices; `parallel/mesh_sweep.py` is the GPU-kernel form):

  * **Chainable across row chunks.** The engine sweeps tall model collections
    in row chunks; the sharded row state (one (L/D,) vector per device) and
    each device's cross-chunk boundary scalar stay on device between calls —
    no host round trip in the chain. The cross-chunk scalar is the left
    shard's last-row tail, captured while the pipeline drains (it is the
    value the *next* chunk's first row consumes as its diagonal-in).
  * **On-device hit compaction.** Dense (rows/32 × L/D) bitmaps never leave
    the device: each one compacts nonzero bitmap words to a fixed-capacity
    (index, word) list via the cumsum+searchsorted idiom; only `cap` words
    cross to the host. Overflow is detected via the returned count and
    retried with a larger capacity — the same discipline as the GPU
    kernel's hit records.
"""

from __future__ import annotations

from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from havac.ops.common import HitRecordOverflow, hit_sort_order, round_up
from havac.parallel.wavefront import _ssv_strip_sweep


def make_engine_wavefront_fn(mesh: Mesh, axis: str, rows_per_step: int,
                             num_strips: int, hit_capacity: int):
    """Jitted sharded sweep of S·R rows, chainable and hit-compacting.

    fn(codes (L,), scores (S·R, 4) int32, row_state (L,) int32,
       prev_tail (D,) int32)
      → (row_state' (L,), prev_tail' (D,), nz_idx (D·cap,) int32,
         nz_words (D·cap,) int32, counts (D,) int32)
    """
    R = rows_per_step
    S = num_strips
    D = mesh.shape[axis]
    T = S + D - 1
    cap = hit_capacity
    perm = [(k, k + 1) for k in range(D - 1)]

    def device_fn(codes, scores, row_state, prev_in):
        k = jax.lax.axis_index(axis)
        L = codes.shape[0]
        sym = codes.astype(jnp.int32)
        scores_strips = scores.reshape(S, R, 4).astype(jnp.int32)

        def wave_step(carry, t):
            row_state, seam_in, prev_tail, saved = carry
            s = t - k
            active = jnp.logical_and(s >= 0, s < S)
            strip_scores = jax.lax.dynamic_index_in_dim(
                scores_strips, jnp.clip(s, 0, S - 1), 0, keepdims=False)
            # Strip 0's first row chains from the previous *chunk* (prev_in);
            # later strips use the running value captured from the seam.
            first_carry = jnp.where(s == 0, prev_in[0], prev_tail)
            carries = jnp.concatenate([first_carry[None], seam_in[: R - 1]])
            bitmaps, new_row_state, tails = _ssv_strip_sweep(
                sym, strip_scores, carries, row_state)
            row_state = jnp.where(active, new_row_state, row_state)
            bitmaps = jnp.where(active, bitmaps, jnp.zeros_like(bitmaps))
            tails = jnp.where(active, tails, jnp.zeros_like(tails))
            # The value the next *chunk*'s first row will consume: the seam
            # received for this shard's last strip, final entry.
            saved = jnp.where(s == S - 1, seam_in[R - 1], saved)
            seam_next = jax.lax.ppermute(tails, axis, perm)
            return (row_state, seam_next, seam_in[R - 1], saved), bitmaps

        init = (row_state, jnp.zeros(R, jnp.int32), prev_in[0],
                jnp.zeros((), jnp.int32))
        (row_state, _, _, saved), all_bitmaps = jax.lax.scan(
            wave_step, init, jnp.arange(T))
        mine = jax.lax.dynamic_slice(all_bitmaps, (k, 0, 0), (S, R // 32, L))
        flat = mine.reshape(S * (R // 32) * L)
        # First-``cap`` nonzero indices via cumsum+searchsorted.
        n = flat.shape[0]
        running = jnp.cumsum((flat != 0).astype(jnp.int32))
        idx = jnp.searchsorted(running,
                               jnp.arange(1, cap + 1, dtype=jnp.int32),
                               side="left")
        idxc = jnp.clip(idx, 0, n - 1)
        ok = jnp.logical_and(idx < n, flat[idxc] != 0)
        nz_idx = jnp.where(ok, idxc, -1)
        nz_words = jnp.where(ok, flat[idxc], 0)
        count = running[n - 1][None]
        return (row_state, saved[None], nz_idx.astype(jnp.int32), nz_words,
                count)

    specs = dict(mesh=mesh, in_specs=(P(axis), P(), P(axis), P(axis)),
                 out_specs=(P(axis), P(axis), P(axis), P(axis), P(axis)))
    return jax.jit(jax.shard_map(device_fn, check_vma=False, **specs))


def decode_compact_hits(
    nz_idx: np.ndarray,
    nz_words: np.ndarray,
    counts: np.ndarray,
    shard_len: int,
    row_offset: int,
) -> Tuple[np.ndarray, np.ndarray]:
    """(per-device compact lists) → global (rows, positions)."""
    D = counts.shape[0]
    cap = nz_idx.shape[0] // D
    rows_out, pos_out = [], []
    for d in range(D):
        c = int(counts[d])
        idx = np.asarray(nz_idx[d * cap: d * cap + c], dtype=np.int64)
        words = np.asarray(nz_words[d * cap: d * cap + c]).view(np.uint32)
        word_row = idx // shard_len
        pos = d * shard_len + idx % shard_len
        for bit in range(32):
            sel = ((words >> np.uint32(31 - bit)) & np.uint32(1)).astype(bool)
            if sel.any():
                rows_out.append(word_row[sel] * 32 + bit + row_offset)
                pos_out.append(pos[sel])
    if not rows_out:
        return np.empty(0, dtype=np.int64), np.empty(0, dtype=np.int64)
    rows = np.concatenate(rows_out)
    positions = np.concatenate(pos_out)
    order = hit_sort_order(rows, positions)
    return rows[order], positions[order]


class DistributedSweep:
    """Stateful multi-device sweep used by the engine's mesh path with the
    XLA backend.

    Holds the sharded codes and on-device chain state; ``sweep_rows`` is
    called once per row chunk with that chunk's scores.
    """

    def __init__(self, codes: np.ndarray, mesh: Mesh, axis: str = "seq",
                 rows_per_step: int = 128, rows_per_call: int = 1024,
                 hit_capacity: int = 1 << 16):
        self.mesh = mesh
        self.axis = axis
        D = mesh.shape[axis]
        self.R = rows_per_step
        if self.R % 32:
            raise ValueError("rows_per_step must be a multiple of 32")
        self.rows_per_call = round_up(rows_per_call, self.R)
        self.S = self.rows_per_call // self.R
        self.hit_capacity = hit_capacity

        L = codes.shape[0]
        L2 = round_up(max(L, 1), D)
        sym = np.zeros(L2, dtype=np.int8)
        sym[:L] = codes
        self.L = L
        self.shard_len = L2 // D
        self.D = D
        self._shard = NamedSharding(mesh, P(axis))
        self._rep = NamedSharding(mesh, P())
        self.codes_dev = jax.device_put(jnp.asarray(sym), self._shard)
        self.reset()
        self._fn = None

    def reset(self) -> None:
        self.row_state = jax.device_put(
            jnp.zeros(self.shard_len * self.D, jnp.int32), self._shard)
        self.prev_tail = jax.device_put(
            jnp.zeros(self.D, jnp.int32), self._shard)

    def _get_fn(self):
        if self._fn is None:
            self._fn = make_engine_wavefront_fn(
                self.mesh, self.axis, self.R, self.S, self.hit_capacity)
        return self._fn

    def sweep_rows(self, scores: np.ndarray, row_offset: int
                   ) -> Tuple[np.ndarray, np.ndarray]:
        """Sweep one row chunk (≤ rows_per_call rows); returns global hits."""
        Pc = scores.shape[0]
        if Pc > self.rows_per_call:
            raise ValueError("row chunk exceeds rows_per_call")
        scores_p = np.full((self.rows_per_call, 4), -128, dtype=np.int32)
        scores_p[:Pc] = np.asarray(scores, dtype=np.int32)
        sc_dev = jax.device_put(jnp.asarray(scores_p), self._rep)

        row_state, prev_tail, nz_idx, nz_words, counts = self._get_fn()(
            self.codes_dev, sc_dev, self.row_state, self.prev_tail)
        counts_np = np.asarray(counts)
        if int(counts_np.max(initial=0)) > self.hit_capacity:
            raise HitRecordOverflow(
                f"{int(counts_np.max())} hit words exceed capacity "
                f"{self.hit_capacity} on a shard; raise hit_capacity")
        # Chain state stays on device; only hits cross to the host.
        self.row_state = row_state
        self.prev_tail = prev_tail
        rows, pos = decode_compact_hits(
            np.asarray(nz_idx), np.asarray(nz_words), counts_np,
            self.shard_len, row_offset)
        keep = (rows < row_offset + Pc) & (pos < self.L)
        return rows[keep], pos[keep]


def ssv_distributed(
    symbols: np.ndarray,
    scores: np.ndarray,
    mesh: Mesh,
    axis: str = "seq",
    rows_per_step: int = 128,
    rows_per_call: int = 1024,
    hit_capacity: int = 1 << 16,
) -> Tuple[np.ndarray, np.ndarray]:
    """Convenience one-shot: full sweep over row chunks; exact global hits."""
    sweep = DistributedSweep(symbols, mesh, axis, rows_per_step,
                             rows_per_call, hit_capacity)
    P_ = scores.shape[0]
    all_rows, all_pos = [], []
    for r0 in range(0, P_, sweep.rows_per_call):
        r1 = min(P_, r0 + sweep.rows_per_call)
        rows, pos = sweep.sweep_rows(scores[r0:r1], r0)
        all_rows.append(rows)
        all_pos.append(pos)
    rows = np.concatenate(all_rows) if all_rows else np.empty(0, np.int64)
    pos = np.concatenate(all_pos) if all_pos else np.empty(0, np.int64)
    order = hit_sort_order(rows, pos)
    return rows[order], pos[order]
