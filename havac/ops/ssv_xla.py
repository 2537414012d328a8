"""Plain-XLA SSV scan: the jittable reference implementation.

The DP dependency is diagonal-only, so each model row updates as one
vectorized step over all L sequence positions (`lax.scan` over rows). This is
the jit-compiled oracle the GPU kernel (`ops/ssv_gpu.py`) is checked against,
and the engine's CPU path.

Match scores are a per-row table lookup (`jnp.take` of the row's scores by
symbol): exact integer arithmetic, one elementwise fusion, no contraction.

Outputs a dense per-strip hit bitmap: bit (K-1-k) of ``bitmaps[s, i]`` is set
iff row ``s*K + k`` hit at position ``i``. Dense bitmaps cost P·L/8 bytes of
device memory, so this path is for testing and modest workloads; the GPU
kernel emits compact hit records instead.
"""

from __future__ import annotations

from functools import partial
from typing import Optional, Tuple

import jax
import jax.numpy as jnp


@partial(jax.jit, static_argnames=("rows_per_strip",))
def ssv_scan_xla(
    symbols: jax.Array,
    scores: jax.Array,
    init_state: jax.Array,
    init_carry: jax.Array,
    reset_rows=None,
    rows_per_strip: int = 32,
) -> Tuple[jax.Array, jax.Array, jax.Array]:
    """Run the SSV recurrence over (P rows × L positions).

    Args:
      symbols: uint8/int8 (L,) 2-bit codes.
      scores: int8 (P, card); P must be a multiple of ``rows_per_strip``.
      init_state: int32 (L,) = S[-1][*] (zeros, or previous row-chunk state).
      init_carry: int32 (P + 1,) left-edge boundary column; entry j is
        S[j-1][-1] (zeros at the global left edge).

    Returns:
      (bitmaps int32 (P/K, L), final_row_state int32 (L,),
       final_carry int32 (P + 1,)).
    """
    K = rows_per_strip
    L = symbols.shape[0]
    P = scores.shape[0]
    if P % K:
        raise ValueError(f"P={P} must be a multiple of rows_per_strip={K}")

    card = scores.shape[1]  # 4 = nucleotide, 20 = amino
    sym = symbols.astype(jnp.int32)
    scores_i32 = scores.astype(jnp.int32).reshape(P // K, K, card)
    carries = init_carry[:P].astype(jnp.int32).reshape(P // K, K)
    if reset_rows is None:
        resets = jnp.zeros((P // K, K), jnp.int32)
    else:
        resets = reset_rows.astype(jnp.int32).reshape(P // K, K)

    def row_step(carry, inputs):
        row, bits = carry
        score_row, carry_in, reset = inputs  # (card,), scalar, scalar
        m = jnp.take(score_row, sym, mode="clip")  # (L,) match scores
        shifted = jnp.roll(row, 1).at[0].set(carry_in) * (1 - reset)
        s = shifted + m
        hit = s >= 256
        row = jnp.where((s < 0) | hit, 0, s)
        bits = bits * 2 + hit.astype(jnp.int32)
        return (row, bits), row[L - 1]

    def strip_step(row, inputs):
        strip_scores, strip_carries, strip_resets = inputs  # (K,card),(K,),(K,)
        (row, bits), tails = jax.lax.scan(
            row_step,
            (row, jnp.zeros_like(row)),
            (strip_scores, strip_carries, strip_resets),
        )
        return row, (bits, tails)

    row0 = init_state.astype(jnp.int32)
    final_row, (bitmaps, tails) = jax.lax.scan(
        strip_step, row0, (scores_i32, carries, resets)
    )
    final_carry = jnp.concatenate(
        [init_state[-1:].astype(jnp.int32), tails.reshape(P)]
    )
    return bitmaps, final_row, final_carry


def ssv_xla_full(
    symbols,
    scores,
    init_state: Optional[jax.Array] = None,
    init_carry: Optional[jax.Array] = None,
    rows_per_strip: int = 32,
):
    """Convenience wrapper: pads P up to a strip multiple with -128 score rows
    (which can never hit: state ≤ 255, 255 - 128 < 256) and defaults the
    boundary conditions to zero."""
    import numpy as np

    symbols = jnp.asarray(symbols, dtype=jnp.uint8)
    scores_np = np.asarray(scores, dtype=np.int8)
    P, card = scores_np.shape
    K = rows_per_strip
    P2 = -(-P // K) * K
    if P2 != P:
        scores_np = np.concatenate(
            [scores_np, np.full((P2 - P, card), -128, dtype=np.int8)]
        )
    L = symbols.shape[0]
    if init_state is None:
        init_state = jnp.zeros(L, dtype=jnp.int32)
    if init_carry is None:
        init_carry = jnp.zeros(P2 + 1, dtype=jnp.int32)
    elif init_carry.shape[0] < P2 + 1:
        init_carry = jnp.concatenate(
            [
                jnp.asarray(init_carry, dtype=jnp.int32),
                jnp.zeros(P2 + 1 - init_carry.shape[0], dtype=jnp.int32),
            ]
        )
    bitmaps, final_row, final_carry = ssv_scan_xla(
        symbols, jnp.asarray(scores_np), init_state, init_carry, rows_per_strip=K
    )
    return bitmaps, final_row, final_carry[: P + 1]
