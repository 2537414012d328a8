"""Multi-device SSV: exact sequence-axis sharding via a wavefront pipeline.

The reference is single-device; its one long-sequence mechanism is the on-chip
score-queue FIFO that carries the DP boundary column between serially-swept
12,288-symbol segments (`device/HavacHls.cpp:451-465`, SURVEY.md §5). Across
devices the same dependency appears at shard seams: device k+1's first
column at model row j needs device k's last column at row j-1. A naive
sequence sharding therefore serializes the devices.

The answer is a **wavefront pipeline over row strips**. Each scan
iteration t, device k sweeps row strip s = t − k over its whole sequence
shard, then sends the strip's right-edge boundary column (R int32 values,
R = rows per step) to device k+1 with `lax.ppermute`. Device k+1
consumes it at iteration t+1 for the same strip. With S strips and D devices
the sweep takes S + D − 1 iterations — pipeline efficiency S/(S+D−1), ≥ 99%
for production model collections (S ≈ P/R in the thousands). The result is
**bit-exact** with the single-device sweep: no halo recompute, no windowing
approximation.

This module is the plain-XLA form used with the CPU backend;
`parallel/mesh_sweep.py` runs the same wavefront with the GPU kernel.

Devices are idle (masked) for the first k and last D−1−k iterations; masking
uses `jnp.where` on the carried state so inactive iterations are pure
discarded compute, keeping the scan shape static for XLA.

Seam bookkeeping: the seam a device receives at iteration t holds the left
shard's tail column S[s·R + j][left_edge − 1] for the strip's rows j = 0..R−1.
Strip-local row j consumes entry j−1; row 0 consumes the *previous* strip's
last entry, carried across iterations as a scalar (`prev_tail`). Device 0
receives ppermute's zero-fill — exactly the global left edge.
"""

from __future__ import annotations

from typing import Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.sharding import Mesh, NamedSharding, PartitionSpec as P

from havac.ops.common import round_up


def _ssv_strip_sweep(sym, strip_scores, carries, row_state):
    """Sweep R model rows over a full sequence shard (one wavefront step).

    Same math as `havac.ops.ssv_xla.ssv_scan_xla` (the softSsv recurrence,
    `test/softSsv/SoftSsv.cpp:31-63`), restructured as a single jittable step.

    Args:
      sym: (L,) int32 symbol codes.
      strip_scores: (R, 4) int32 projected scores for this strip's rows.
      carries: (R,) int32; carries[j] = S[strip_row j − 1][left_edge − 1].
      row_state: (L,) int32 = S[previous strip's last row][*].

    Returns:
      bitmaps (R/32, L) int32 — bit (31−k) of word w = hit at strip row
      w·32+k (layout shared with the XLA kernel / decode_dense_bitmaps);
      new row_state (L,); tails (R,) with tails[j] = S[strip row j][L−1].
    """
    L = sym.shape[0]
    R = strip_scores.shape[0]

    def row_step(carry, inputs):
        row, bits = carry
        score_row, carry_in = inputs
        m = jnp.take(score_row, sym, mode="clip")
        shifted = jnp.roll(row, 1).at[0].set(carry_in)
        s = shifted + m
        hit = s >= 256
        row = jnp.where(jnp.logical_or(s < 0, hit), 0, s)
        bits = bits * 2 + hit.astype(jnp.int32)
        return (row, bits), row[L - 1]

    def word_step(row, inputs):
        score_rows, carry_ins = inputs  # (32, 4), (32,)
        (row, bits), tails = jax.lax.scan(
            row_step, (row, jnp.zeros(L, jnp.int32)), (score_rows, carry_ins))
        return row, (bits, tails)

    words = R // 32
    row_state, (bitmaps, tails) = jax.lax.scan(
        word_step, row_state,
        (strip_scores.reshape(words, 32, 4), carries.reshape(words, 32)))
    return bitmaps, row_state, tails.reshape(R)


def make_wavefront_fn(mesh: Mesh, axis: str, rows_per_step: int,
                      num_strips: int):
    """Build the jitted shard_map wavefront sweep for a fixed geometry.

    Returned fn: (codes (D·Ls,) int8 sharded over ``axis``, scores (S·R, 4)
    int32 replicated) → bitmaps (S·R/32, D·Ls) int32, sharded along positions.
    """
    R = rows_per_step
    S = num_strips
    D = mesh.shape[axis]
    T = S + D - 1
    perm = [(k, k + 1) for k in range(D - 1)]

    def device_fn(codes, scores):
        k = jax.lax.axis_index(axis)
        L = codes.shape[0]
        sym = codes.astype(jnp.int32)
        scores_strips = scores.reshape(S, R, 4).astype(jnp.int32)

        def wave_step(carry, t):
            row_state, seam_in, prev_tail = carry
            s = t - k
            active = jnp.logical_and(s >= 0, s < S)
            strip_scores = jax.lax.dynamic_index_in_dim(
                scores_strips, jnp.clip(s, 0, S - 1), 0, keepdims=False)
            carries = jnp.concatenate([prev_tail[None], seam_in[: R - 1]])
            bitmaps, new_row_state, tails = _ssv_strip_sweep(
                sym, strip_scores, carries, row_state)
            row_state = jnp.where(active, new_row_state, row_state)
            bitmaps = jnp.where(active, bitmaps, jnp.zeros_like(bitmaps))
            tails = jnp.where(active, tails, jnp.zeros_like(tails))
            seam_next = jax.lax.ppermute(tails, axis, perm)
            return (row_state, seam_next, seam_in[R - 1]), bitmaps

        init = (jnp.zeros(L, jnp.int32), jnp.zeros(R, jnp.int32),
                jnp.zeros((), jnp.int32))
        _, all_bitmaps = jax.lax.scan(wave_step, init, jnp.arange(T))
        # Device k's strip s was computed at iteration t = s + k.
        mine = jax.lax.dynamic_slice(all_bitmaps, (k, 0, 0), (S, R // 32, L))
        return mine.reshape(S * (R // 32), L)

    fn = jax.shard_map(device_fn, mesh=mesh, in_specs=(P(axis), P()),
                       out_specs=P(None, axis), check_vma=False)
    return jax.jit(fn)


def ssv_wavefront(
    symbols: np.ndarray,
    scores: np.ndarray,
    mesh: Mesh,
    axis: str = "seq",
    rows_per_step: int = 512,
) -> Tuple[np.ndarray, np.ndarray]:
    """Run the exact sharded sweep; returns decoded (hit_rows, hit_positions).

    ``symbols`` (L,) uint8 is padded to D equal shards; ``scores`` (P, 4) int8
    is padded to a rows_per_step multiple (pad rows score −128, can't hit).
    """
    from havac.hits.decode import decode_dense_bitmaps

    D = mesh.shape[axis]
    R = rows_per_step
    if R % 32:
        raise ValueError("rows_per_step must be a multiple of 32")
    L = symbols.shape[0]
    P_ = scores.shape[0]
    L2 = round_up(max(L, 1), D)
    P2 = round_up(max(P_, 1), R)

    sym = np.zeros(L2, dtype=np.int8)
    sym[:L] = symbols
    sc = np.full((P2, 4), -128, dtype=np.int32)
    sc[:P_] = scores.astype(np.int32)

    fn = make_wavefront_fn(mesh, axis, R, P2 // R)
    sym_dev = jax.device_put(jnp.asarray(sym), NamedSharding(mesh, P(axis)))
    sc_dev = jax.device_put(jnp.asarray(sc), NamedSharding(mesh, P()))
    bitmaps = np.asarray(jax.block_until_ready(fn(sym_dev, sc_dev)))

    rows, positions = decode_dense_bitmaps(bitmaps, 32)
    keep = (rows < P_) & (positions < L)
    return rows[keep], positions[keep]
