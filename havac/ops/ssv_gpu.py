"""SSV scan kernel for NVIDIA GPUs (Pallas, Triton backend).

The recurrence depends only on the diagonal,

    S[j][i] = f(S[j-1][i-1] + M[j][sym[i]]),

so every diagonal ``d = i - j`` is independent of every other. One kernel
lane walks one diagonal down the model rows and keeps its cell state in a
register the whole way: there is no cross-lane shift and nothing is carried
between blocks, which may run in any order.

Per cell the lane needs the symbol at ``i = d + j``. Symbols are staged as
*windows*: ``win[k]`` packs the ``spw`` symbols ``sym[k .. k+spw)`` into one
int32 (2-bit fields for nucleotides, 5-bit for amino acids), so one coalesced
word load serves ``spw`` rows of a lane. Nucleotide scores for a row are four
signed bytes of one int32, and the field holds the complemented code
``3 - sym`` premultiplied by 8 at extraction, so the match score is
``(packed << f8) >> 24``. Amino scores are gathered from a (P, 32) table.

Add, floor at 0, hit test (``>= 256``) and reset on hit are plain int32
operations. Hits accumulate as a per-lane bitmask over a group of up to 32
rows; when any lane of the block has one, the block reserves space with ONE
``atomic_add`` on the record counter and writes ``(row, position)`` records.
When the counter exceeds the buffer's capacity the surplus records are
dropped and the caller sees ``count > cap`` and redispatches with a larger
buffer, so overflow is never silent.

Chaining contract (shared with ``ssv_xla.ssv_scan_xla`` and
``reference.ssv_reference``): a chunk is a rectangle of P rows by L
positions. A diagonal enters it from the top (``init_state[i-1]``) or from
the left edge (``init_carry[j]`` = S[j-1][-1]); it leaves at the bottom
(``final_row_state``) or at the right edge (``final_carry[j+1]`` =
S[j][L-1]). ``reset_rows`` zeroes the incoming diagonal state at the rows
where a new model starts (``Havac(isolate_models=True)``).

Blocks whose diagonals all start at the top and end at the bottom take the
interior path: no masks, aligned window loads. The few blocks that touch the
left or right edge of the chunk take the edge path, which injects left-edge
carries, masks cells outside the chunk and captures the right-edge carries.
"""

from __future__ import annotations

import functools
from typing import Optional, Tuple

import jax
import jax.numpy as jnp
import numpy as np
from jax.experimental import pallas as pl
from jax.experimental.pallas import triton as plgpu

from havac.ops.common import HitRecordOverflow, cdiv, round_up, sort_hit_pairs

# Diagonals (lanes) per program. A multiple of 16: interior window loads
# are declared 16-aligned to the compiler.
BLOCK = 128
NUM_WARPS = 1


def geometry(card: int) -> Tuple[int, int, int]:
    """(field bits, symbols per window word, rows per hit group)."""
    if not 2 <= card <= 32:
        raise ValueError(f"alphabet cardinality {card} unsupported (2..32)")
    nb = max(1, (card - 1).bit_length())
    spw = 32 // nb
    return nb, spw, (32 // spw) * spw


def _lead(P: int) -> int:
    """Diagonals left of d = 0 covered by the grid: at least P - 1, rounded
    so that every program's first diagonal, and with it every interior
    window load, is 16-aligned."""
    return round_up(max(P - 1, 0), 16)


def num_programs(L: int, P: int) -> int:
    return cdiv(L + _lead(P), BLOCK)


def _windows(symbols, card: int):
    """(L + 2G,) int32: word k packs padded symbols k .. k+spw-1 (field r at
    bits nb*r), where padded symbol k is sym[k - G] and 0 outside [0, L)."""
    nb, spw, G = geometry(card)
    L = symbols.shape[0]
    c = symbols.astype(jnp.int32)
    if card == 4:
        c = 3 - c  # complemented: the byte select shifts left by 8 * field
    c = jnp.pad(c, (G, G + spw))
    n = L + 2 * G
    w = jnp.zeros(n, jnp.int32)
    for r in range(spw):
        w = w | (c[r:r + n] << (nb * r))
    return w


def _score_table(scores):
    """Nucleotides: (P,) int32, byte s = score of symbol s. Others: (P·2^nb,)
    int32 row-major table, padded with -128 (never reached by real codes)."""
    P, card = scores.shape
    s = scores.astype(jnp.int32)
    if card == 4:
        b = s & 0xFF
        return b[:, 0] | (b[:, 1] << 8) | (b[:, 2] << 16) | (b[:, 3] << 24)
    nb, _, _ = geometry(card)
    return jnp.pad(s, ((0, 0), (0, (1 << nb) - card)),
                   constant_values=-128).reshape(-1)


def _kernel(*refs, L: int, P: int, card: int, isolate: bool, cap: int):
    if isolate:
        (win, sc, ist, icar, rmask, _cnt_in,
         rrow, rpos, ost, ocar, cnt) = refs
    else:
        (win, sc, ist, icar, _cnt_in, rrow, rpos, ost, ocar, cnt) = refs
        rmask = None
    nb, spw, G = geometry(card)
    fmask = (1 << nb) - 1
    wlen = L + 2 * G
    lead = _lead(P)
    d0 = pl.program_id(0) * BLOCK - lead
    dvec = d0 + jax.lax.broadcasted_iota(jnp.int32, (BLOCK,), 0)

    def match(w, rr: int, j):
        if card == 4:
            sh = 2 * rr - 3
            f8 = ((w >> sh) if sh > 0 else (w << -sh)) & 0x18
            return (sc[j] << f8) >> 24
        s = (w >> (nb * rr)) & fmask
        return sc[(j << nb) + s]

    def record(bits, j0, nrows: int):
        # Block-aggregated append: one atomic reserves every record of the
        # block; lanes then write their hits at exclusive-prefix offsets.
        n = jax.lax.population_count(bits)
        base = plgpu.atomic_add(cnt, 0, jnp.sum(n))
        k = base + jnp.cumsum(n) - n
        i0 = dvec + j0

        def put(r, k):
            b = (bits >> r) & 1
            ok = (b != 0) & (k < cap)
            slot = jnp.where(ok, k, cap)  # out of range where masked
            plgpu.store(rrow.at[slot], jnp.full((BLOCK,), j0 + r, jnp.int32),
                        mask=ok)
            plgpu.store(rpos.at[slot], i0 + r, mask=ok)
            return k + b

        jax.lax.fori_loop(0, nrows, put, k)

    def rows(ws, state, capv, j0, nrows: int, edge: bool):
        bits = jnp.zeros((BLOCK,), jnp.int32)
        for r in range(nrows):
            j = j0 + r
            m = match(ws[r // spw], r % spw, j)
            prev = state
            if edge:
                i = dvec + j
                prev = jnp.where(i == 0, icar[j], prev)
            if isolate:
                prev = prev & rmask[j]
            s = jnp.maximum(prev + m, 0)
            h = s >> 8  # s <= 255 + 127, so this is exactly the hit bit
            state = jnp.where(h != 0, 0, s)
            if edge:
                h = jnp.where((i >= 0) & (i < L), h, 0)
                capv = jnp.where(i == L - 1, state, capv)
            bits = bits + (h << r)
        return state, capv, bits

    def group(j0, state, capv, nrows: int, edge: bool):
        nw = cdiv(nrows, spw)
        if edge:
            ws = [win[jnp.clip(dvec + j0 + (G + q * spw), 0, wlen - 1)]
                  for q in range(nw)]
        else:
            base = d0 + j0 + G
            if card == 4:
                base = pl.multiple_of(base, 16)
            ws = [win[pl.ds(base + q * spw, BLOCK)] for q in range(nw)]
        state, capv, bits = rows(ws, state, capv, j0, nrows, edge)

        # bits is negative when row 31 hit: test for nonzero, not > 0.
        @pl.when(jnp.max((bits != 0).astype(jnp.int32)) > 0)
        def _():
            record(bits, j0, nrows)

        return state, capv

    def sweep(state, capv, edge: bool):
        def body(g, carry):
            return group(g * G, *carry, G, edge)

        state, capv = jax.lax.fori_loop(0, P // G, body, (state, capv))
        if P % G:
            state, capv = group((P // G) * G, state, capv, P % G, edge)
        return state, capv

    zeros = jnp.zeros((BLOCK,), jnp.int32)
    is_edge = (d0 < 1) | (d0 + BLOCK + P - 1 >= L)

    if L > BLOCK + P:  # otherwise every program touches an edge

        @pl.when(jnp.logical_not(is_edge))
        def _interior():
            state, _ = sweep(ist[pl.ds(d0 - 1, BLOCK)], zeros, edge=False)
            plgpu.store(ost.at[pl.ds(d0 + P - 1, BLOCK)], state)

    @pl.when(is_edge)
    def _edge():
        state0 = jnp.where(dvec >= 1, ist[jnp.clip(dvec - 1, 0, L - 1)], 0)
        state, capv = sweep(state0, zeros, edge=True)
        io = dvec + P - 1
        ok = (io >= 0) & (io < L)
        plgpu.store(ost.at[jnp.where(ok, io, L)], state, mask=ok)
        jc = L - 1 - dvec  # the row at which this diagonal leaves the chunk
        ok = (jc >= 0) & (jc < P)
        plgpu.store(ocar.at[jnp.where(ok, jc, P)], capv, mask=ok)


@functools.partial(jax.jit, static_argnames=("cap", "interpret"))
def ssv_gpu_scan(symbols, scores, init_state, init_carry, reset_rows=None, *,
                 cap: int, interpret: bool = False):
    """Device-level scan of one (P rows × L positions) chunk.

    Args:
      symbols: (L,) integer codes in [0, card).
      scores: (P, card) int8 match scores.
      init_state: (L,) int32, S[-1][*].
      init_carry: (P + 1,) int32, entry j is S[j-1][-1].
      reset_rows: optional (P,) bool/int, rows whose incoming state is 0.
      cap: capacity of the hit-record buffers.

    Returns:
      (hit_rows (cap,) int32, hit_positions (cap,) int32, count int32,
       final_row_state (L,) int32, final_carry (P + 1,) int32). Only the
      first ``min(count, cap)`` records are valid, in no particular order;
      ``count > cap`` means records were dropped.
    """
    L = symbols.shape[0]
    P, card = scores.shape
    isolate = reset_rows is not None
    inputs = [_windows(symbols, card), _score_table(scores),
              init_state.astype(jnp.int32), init_carry.astype(jnp.int32)]
    if isolate:
        inputs.append(jnp.where(reset_rows.astype(bool), 0, -1)
                      .astype(jnp.int32))
    inputs.append(jnp.zeros((1,), jnp.int32))  # record counter
    kernel = functools.partial(_kernel, L=L, P=P, card=card, isolate=isolate,
                               cap=cap)
    rrow, rpos, ost, ocar, cnt = pl.pallas_call(
        kernel,
        grid=(num_programs(L, P),),
        out_shape=[
            jax.ShapeDtypeStruct((cap,), jnp.int32),
            jax.ShapeDtypeStruct((cap,), jnp.int32),
            jax.ShapeDtypeStruct((L,), jnp.int32),
            jax.ShapeDtypeStruct((P,), jnp.int32),
            jax.ShapeDtypeStruct((1,), jnp.int32),
        ],
        input_output_aliases={len(inputs) - 1: 4},
        compiler_params=plgpu.CompilerParams(num_warps=NUM_WARPS,
                                             num_stages=1),
        backend="triton",
        interpret=interpret,
        name="ssv_gpu",
    )(*inputs)
    final_carry = jnp.concatenate([init_state[L - 1:].astype(jnp.int32),
                                   ocar])
    return rrow, rpos, cnt[0], ost, final_carry


def ssv_gpu(
    symbols: np.ndarray,
    scores: np.ndarray,
    init_state: Optional[np.ndarray] = None,
    init_carry: Optional[np.ndarray] = None,
    reset_rows: Optional[np.ndarray] = None,
    max_hits: int = 1 << 16,
    interpret: bool = False,
) -> Tuple[np.ndarray, np.ndarray, np.ndarray, np.ndarray]:
    """Host-facing wrapper: (hit rows, hit positions, final_row_state,
    final_carry), hits sorted by (row, position), same contract as
    ``reference.ssv_reference``. Raises :class:`HitRecordOverflow` when the
    chunk has more hits than ``max_hits``."""
    symbols = np.asarray(symbols, dtype=np.uint8)
    scores = np.asarray(scores, dtype=np.int8)
    L = symbols.shape[0]
    P = scores.shape[0]
    istate = np.zeros(L, dtype=np.int32)
    if init_state is not None:
        istate[:] = np.asarray(init_state, dtype=np.int32)
    icarry = np.zeros(P + 1, dtype=np.int32)
    if init_carry is not None:
        ic = np.asarray(init_carry, dtype=np.int32)
        icarry[:ic.shape[0]] = ic
    reset = None if reset_rows is None else jnp.asarray(
        np.asarray(reset_rows, dtype=bool))
    rrow, rpos, count, ostate, ocarry = ssv_gpu_scan(
        jnp.asarray(symbols), jnp.asarray(scores), jnp.asarray(istate),
        jnp.asarray(icarry), reset, cap=max_hits, interpret=interpret)
    n = int(count)
    if n > max_hits:
        raise HitRecordOverflow(f"{n} hits exceed max_hits={max_hits}")
    rows, pos = sort_hit_pairs(np.asarray(rrow)[:n].astype(np.int64),
                               np.asarray(rpos)[:n].astype(np.int64))
    return rows, pos, np.asarray(ostate), np.asarray(ocarry)
