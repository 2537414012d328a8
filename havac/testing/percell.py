"""Per-cell DP equivalence: the byCellComparator analog (SURVEY.md §4.2).

The reference's strongest correctness tool instruments both implementations
to record every DP cell and compares exhaustively
(`test/byCellComparator/byCellComparator.cpp:47-96`). Here, each backend can
produce the full (P × L) post-update state matrix for small inputs:

  * oracle — ssv_reference(return_matrix=True), the scalar golden model;
  * xla    — the XLA scan's row step, collecting every row state;
  * gpu    — the shipping GPU kernel (`ops/ssv_gpu.py`) driven one model row
             per dispatch, chaining its own ``final_row_state``: the exact
             state the kernel computes, cell for cell.

``compare_matrices`` reports the first mismatching cells like the
reference's comparator printout.
"""

from __future__ import annotations

from dataclasses import dataclass
from typing import List, Optional

import numpy as np

from havac.ops.reference import ssv_reference


def dp_matrix_oracle(symbols: np.ndarray, scores: np.ndarray) -> np.ndarray:
    _, matrix = ssv_reference(symbols, scores, return_matrix=True)
    return matrix


def dp_matrix_xla(symbols: np.ndarray, scores: np.ndarray) -> np.ndarray:
    """Full state matrix via a jitted scan (rows as scan steps)."""
    import jax
    import jax.numpy as jnp

    sym = jnp.asarray(np.asarray(symbols, dtype=np.uint8), jnp.int32)
    L = sym.shape[0]

    def row_step(row, score_row):
        m = jnp.take(score_row, sym, mode="clip")
        shifted = jnp.roll(row, 1).at[0].set(0)
        s = shifted + m
        hit = s >= 256
        row = jnp.where(jnp.logical_or(s < 0, hit), 0, s)
        return row, row

    _, states = jax.lax.scan(
        row_step, jnp.zeros(L, jnp.int32),
        jnp.asarray(np.asarray(scores, dtype=np.int8), jnp.int32))
    return np.asarray(states)


def dp_matrix_gpu(
    symbols: np.ndarray,
    scores: np.ndarray,
    init_carry: Optional[np.ndarray] = None,
    reset_rows: Optional[np.ndarray] = None,
    interpret: bool = True,
) -> np.ndarray:
    """Full state matrix from the GPU kernel, one row per dispatch: row j
    starts from row j-1's ``final_row_state`` and left-edge carry
    ``init_carry[j]`` (debug-only: O(P) dispatches of one compiled shape)."""
    import jax.numpy as jnp

    from havac.ops.ssv_gpu import ssv_gpu_scan

    symbols = jnp.asarray(np.asarray(symbols, dtype=np.uint8))
    scores = np.asarray(scores, dtype=np.int8)
    P = scores.shape[0]
    L = symbols.shape[0]
    icarry = np.zeros(P + 1, dtype=np.int32)
    if init_carry is not None:
        icarry[:] = np.asarray(init_carry, dtype=np.int32)
    matrix = np.zeros((P, L), dtype=np.int32)
    state = jnp.zeros(L, jnp.int32)
    for j in range(P):
        reset = (None if reset_rows is None
                 else jnp.asarray(np.asarray(reset_rows[j:j + 1], bool)))
        _, _, _, state, _ = ssv_gpu_scan(
            symbols, jnp.asarray(scores[j:j + 1]), state,
            jnp.asarray(icarry[j:j + 2]), reset, cap=L,
            interpret=interpret)
        matrix[j] = np.asarray(state)
    return matrix


@dataclass
class CellMismatch:
    row: int
    position: int
    expected: int
    actual: int


def compare_matrices(
    expected: np.ndarray, actual: np.ndarray, max_report: int = 16
) -> List[CellMismatch]:
    """Exhaustive cell comparison; returns up to ``max_report`` mismatches
    (empty = bit-exact equivalence)."""
    expected = np.asarray(expected)
    actual = np.asarray(actual)
    if expected.shape != actual.shape:
        raise ValueError(f"shape mismatch {expected.shape} vs {actual.shape}")
    rows, cols = np.nonzero(expected != actual)
    return [
        CellMismatch(int(r), int(c), int(expected[r, c]), int(actual[r, c]))
        for r, c in zip(rows[:max_report], cols[:max_report])
    ]
