"""GPU SSV kernel (Pallas interpret mode on the CPU) vs the numpy oracle.

The full chaining contract is checked exactly: hit set, ``final_row_state``
and ``final_carry``, across row and column chunks, left-edge carries,
model-isolation resets, both alphabets, and record overflow.
"""

import numpy as np
import pytest

from havac.ops.common import HitRecordOverflow
from havac.ops.reference import ssv_reference
from havac.ops.ssv_gpu import (
    BLOCK,
    _score_table,
    _windows,
    geometry,
    num_programs,
    ssv_gpu,
    ssv_gpu_scan,
)


def random_case(seed, L, P, lo=-40, hi=120, card=4):
    rng = np.random.default_rng(seed)
    symbols = rng.integers(0, card, size=L).astype(np.uint8)
    scores = rng.integers(lo, hi, size=(P, card)).astype(np.int8)
    return symbols, scores


def check(symbols, scores, init_state=None, init_carry=None, reset=None,
          expect_hits=True, **kw):
    want, _ = ssv_reference(symbols, scores, init_state, init_carry,
                            reset_rows=reset)
    rows, pos, state, carry = ssv_gpu(symbols, scores, init_state,
                                      init_carry, reset, interpret=True, **kw)
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)
    np.testing.assert_array_equal(state, want.final_row_state)
    np.testing.assert_array_equal(carry, want.final_carry)
    if expect_hits:
        assert rows.size > 0


@pytest.mark.parametrize("seed,L,P", [
    (0, 3000, 64),    # interior and edge programs, whole hit groups
    (1, 2500, 45),    # P not a multiple of the 32-row hit group
    (2, 300, 20),     # L < BLOCK: every program is an edge program
    (3, 60, 150),     # P > L: diagonals enter from the left and leave right
    (4, 1, 7),        # a single position
])
def test_matches_oracle(seed, L, P):
    check(*random_case(seed, L, P), expect_hits=L > 1)


def test_chaining_inputs_exact():
    """Nonzero init_state (top edge) and init_carry (left edge)."""
    symbols, scores = random_case(5, 2000, 70)
    rng = np.random.default_rng(50)
    check(symbols, scores,
          init_state=rng.integers(0, 256, size=2000).astype(np.int32),
          init_carry=rng.integers(0, 256, size=71).astype(np.int32))


def test_row_chunk_chaining():
    symbols, scores = random_case(6, 1500, 64)
    whole, _ = ssv_reference(symbols, scores)
    r1, p1, state1, _ = ssv_gpu(symbols, scores[:40], interpret=True)
    r2, p2, state2, _ = ssv_gpu(symbols, scores[40:], init_state=state1,
                                interpret=True)
    got = set(zip(r1.tolist(), p1.tolist())) | {
        (j + 40, i) for j, i in zip(r2.tolist(), p2.tolist())}
    assert got == set(zip(whole.hit_rows.tolist(),
                          whole.hit_positions.tolist()))
    np.testing.assert_array_equal(state2, whole.final_row_state)


def test_column_chunk_chaining_via_carry():
    symbols, scores = random_case(7, 2400, 50)
    whole, _ = ssv_reference(symbols, scores)
    cut = 1100
    rl, pl_, _, carry_l = ssv_gpu(symbols[:cut], scores, interpret=True)
    rr, pr, _, carry_r = ssv_gpu(symbols[cut:], scores, init_carry=carry_l,
                                 interpret=True)
    got = set(zip(rl.tolist(), pl_.tolist())) | {
        (j, i + cut) for j, i in zip(rr.tolist(), pr.tolist())}
    assert got == set(zip(whole.hit_rows.tolist(),
                          whole.hit_positions.tolist()))
    np.testing.assert_array_equal(carry_r, whole.final_carry)


def test_reset_rows_isolation():
    symbols, scores = random_case(8, 1800, 60)
    reset = np.zeros(60, dtype=bool)
    reset[[0, 17, 33, 59]] = True
    rng = np.random.default_rng(80)
    check(symbols, scores, reset=reset,
          init_carry=rng.integers(0, 256, size=61).astype(np.int32))


@pytest.mark.parametrize("L,P", [(1500, 45), (200, 31)])
def test_amino_card20(L, P):
    symbols, scores = random_case(9, L, P, lo=-60, hi=60, card=20)
    rng = np.random.default_rng(90)
    check(symbols, scores,
          init_state=rng.integers(0, 256, size=L).astype(np.int32),
          init_carry=rng.integers(0, 256, size=P + 1).astype(np.int32))


def test_every_lane_hits_on_the_last_row_of_a_group():
    """Every diagonal reaches 256 exactly at row 31, so each lane's hit mask
    is negative (bit 31 only): the any-hit test must not read it as empty."""
    symbols = np.zeros(700, dtype=np.uint8)
    scores = np.full((40, 4), 8, dtype=np.int8)
    check(symbols, scores)


def test_sparse_lone_hits():
    """One hit-prone row among cold ones: hits land alone in their block."""
    symbols, scores = random_case(10, 2200, 40, lo=-128, hi=-100)
    scores[23] = 127
    scores[22] = 127
    scores[21] = 127
    check(symbols, scores)


def test_cold_input_no_hits():
    symbols, scores = random_case(11, 1200, 16, lo=-128, hi=10)
    check(symbols, scores, expect_hits=False)


def test_record_overflow_is_reported():
    symbols = np.zeros(900, dtype=np.uint8)
    scores = np.full((32, 4), 127, dtype=np.int8)
    want, _ = ssv_reference(symbols, scores)
    with pytest.raises(HitRecordOverflow):
        ssv_gpu(symbols, scores, max_hits=64, interpret=True)
    # The device count is exact even when the buffer is short.
    import jax.numpy as jnp

    out = ssv_gpu_scan(jnp.asarray(symbols), jnp.asarray(scores),
                       jnp.zeros(900, jnp.int32), jnp.zeros(33, jnp.int32),
                       cap=64, interpret=True)
    assert int(out[2]) == want.hit_rows.size > 64
    # Retrying at a larger capacity recovers every hit.
    check(symbols, scores, max_hits=want.hit_rows.size)


@pytest.mark.parametrize("L", [BLOCK + 40, 2 * BLOCK - 1, 3 * BLOCK - 1,
                               3 * BLOCK, 3 * BLOCK + 1])
def test_chunk_lengths_around_block_multiples_are_exact(L):
    # With P = 40: no interior program, then one, then two, with the grid
    # ending before, on, or after a block boundary.
    import jax.numpy as jnp

    symbols, scores = random_case(12, L, 40)
    want, _ = ssv_reference(symbols, scores)
    rr, rp, n, state, carry = ssv_gpu_scan(
        jnp.asarray(symbols), jnp.asarray(scores),
        jnp.zeros(L, jnp.int32), jnp.zeros(41, jnp.int32),
        cap=1 << 14, interpret=True)
    n = int(n)
    got = set(zip(np.asarray(rr)[:n].tolist(), np.asarray(rp)[:n].tolist()))
    assert got == set(zip(want.hit_rows.tolist(), want.hit_positions.tolist()))
    np.testing.assert_array_equal(np.asarray(state), want.final_row_state)
    np.testing.assert_array_equal(np.asarray(carry), want.final_carry)


def test_scan_output_shapes():
    import jax.numpy as jnp

    rr, rp, n, state, carry = ssv_gpu_scan(
        jnp.zeros(333, jnp.uint8), jnp.zeros((9, 4), jnp.int8),
        jnp.zeros(333, jnp.int32), jnp.zeros(10, jnp.int32), cap=77,
        interpret=True)
    assert rr.shape == rp.shape == (77,)
    assert n.shape == () and state.shape == (333,) and carry.shape == (10,)
    assert all(a.dtype == jnp.int32 for a in (rr, rp, n, state, carry))


@pytest.mark.parametrize("card", [4, 20])
def test_window_words_pack_the_shifted_symbols(card):
    import jax.numpy as jnp

    nb, spw, G = geometry(card)
    rng = np.random.default_rng(card)
    sym = rng.integers(0, card, size=100).astype(np.uint8)
    w = np.asarray(_windows(jnp.asarray(sym), card)).view(np.uint32)
    assert w.shape == (100 + 2 * G,)
    padded = np.zeros(100 + 2 * G + spw, dtype=np.int64)
    padded[G:G + 100] = (3 - sym) if card == 4 else sym
    for r in range(spw):
        field = (w >> np.uint32(nb * r)) & np.uint32((1 << nb) - 1)
        np.testing.assert_array_equal(field, padded[r:r + w.shape[0]])


def test_score_tables():
    import jax.numpy as jnp

    rng = np.random.default_rng(3)
    sc4 = rng.integers(-128, 128, size=(6, 4)).astype(np.int8)
    packed = np.asarray(_score_table(jnp.asarray(sc4))).view(np.uint32)
    for s in range(4):
        got = ((packed >> np.uint32(8 * s)) & np.uint32(0xFF)).astype(np.uint8)
        np.testing.assert_array_equal(got.view(np.int8), sc4[:, s])
    sc20 = rng.integers(-128, 128, size=(5, 20)).astype(np.int8)
    table = np.asarray(_score_table(jnp.asarray(sc20))).reshape(5, 32)
    np.testing.assert_array_equal(table[:, :20], sc20)
    assert (table[:, 20:] == -128).all()


def test_geometry_and_grid():
    assert geometry(4) == (2, 16, 32)
    assert geometry(20) == (5, 6, 30)
    with pytest.raises(ValueError):
        geometry(40)
    # Every diagonal from -(P-1) to L-1 is covered by the grid.
    for L, P in [(1, 1), (1000, 1), (5000, 300), (10, 1000)]:
        assert num_programs(L, P) * BLOCK >= L + P - 1


def test_matches_oracle_on_planted_fixture():
    from havac.io.fasta import encode_database
    from havac.scoring.reprojection import project_models
    from havac.testing.generator import generate_planted_fixture

    models, seqs = generate_planted_fixture(
        seed=7, model_length=64, sequence_length=4000)
    db = encode_database([n for n, _ in seqs], [s.encode() for _, s in seqs],
                         pad_multiple=1024)
    scores = project_models(models, p_value=0.02)
    check(db.codes, scores)
