"""Shared kernel configuration and shape bookkeeping for the SSV kernels."""

from __future__ import annotations

from dataclasses import dataclass


def hit_sort_order(rows, positions):
    """Ordering permutation for (row, position) hit pairs.

    One composite int64 key instead of np.lexsort's two passes: on this
    host lexsort over two 10M-element keys measured 4.5 s vs 0.35 s for a
    single-key stable argsort. Falls back to lexsort if the composite key
    would overflow int64 (rows ~> 2^37 with a 2^26 position span — never
    in practice)."""
    import numpy as np

    if rows.size == 0:
        return np.empty(0, dtype=np.int64)
    span = np.int64(positions.max()) + 1
    # rows.max()*span + (span-1) must fit int64, hence the -(span-1) slack
    # in the guard (a bare iinfo.max // span admits an off-by-one overflow).
    limit = (np.iinfo(np.int64).max - int(span) + 1) // max(int(span), 1)
    if int(rows.max()) > limit:
        return np.lexsort((positions, rows))  # pragma: no cover
    return np.argsort(rows * span + positions, kind="stable")


def sort_hit_pairs(rows, positions):
    """Sorted-by-(row, position) copies of a freshly-owned hit pair.

    numpy's composite-key argsort is the fast path here: the native
    multithreaded sorter (`native.sort_hits_native`) wins standalone but
    measured ~5x slower INSIDE a live engine process on this host (its
    std::threads and ~170 MB of key scratch contend with the device
    runtime), while the single-allocation argsort stays ~2 s for 10M
    pairs in-engine."""
    if rows.size == 0:
        return rows, positions
    order = hit_sort_order(rows, positions)
    return rows[order], positions[order]


def cdiv(a: int, b: int) -> int:
    return -(-a // b)


def round_up(x: int, m: int) -> int:
    return cdiv(x, m) * m


@dataclass(frozen=True)
class SsvKernelConfig:
    """Chunk geometry and hit-buffer sizing of the engine's scans.

    ``block_width``: sequence positions; database padding and column chunks
    cut on multiples of it.
    ``rows_per_strip``: model rows per hit-bitmap strip of the XLA scan
    (bitmap depth, ≤ 32 since strips pack into int32 words); row chunks cut
    on multiples of it.
    ``max_hits``: initial capacity of the GPU kernel's hit-record buffer per
    chunk. A chunk with more hits is re-run at a larger capacity, never
    truncated (the analog of the reference's 3.5 GiB hit-buffer bound,
    `host/HavacHwClient.hpp:94`).
    """

    block_width: int = 4096
    rows_per_strip: int = 32
    max_hits: int = 1 << 20

    def __post_init__(self) -> None:
        if self.block_width < 1:
            raise ValueError("block_width must be positive")
        if not (1 <= self.rows_per_strip <= 32):
            raise ValueError("rows_per_strip must be in [1, 32]")
        if self.max_hits < 1:
            raise ValueError("max_hits must be positive")


class HitRecordOverflow(RuntimeError):
    """More hits than the kernel's record buffer holds; retry with a larger
    buffer (the analog of exceeding the reference's 3.5 GiB hit buffer,
    `host/HavacHwClient.hpp:94`)."""
