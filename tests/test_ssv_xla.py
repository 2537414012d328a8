"""XLA scan kernel vs the numpy oracle, including boundary-condition plumbing."""

import numpy as np
import pytest

from havac.hits.decode import decode_dense_bitmaps
from havac.ops.reference import ssv_reference
from havac.ops.ssv_xla import ssv_xla_full


def run_case(seed, L, P, K=32, lo=-40, hi=120):
    rng = np.random.default_rng(seed)
    symbols = rng.integers(0, 4, size=L).astype(np.uint8)
    scores = rng.integers(lo, hi, size=(P, 4)).astype(np.int8)
    return symbols, scores


def hits_from_xla(symbols, scores, K=32, **kw):
    bitmaps, final_row, final_carry = ssv_xla_full(
        symbols, scores, rows_per_strip=K, **kw
    )
    rows, pos = decode_dense_bitmaps(np.asarray(bitmaps), K)
    keep = rows < scores.shape[0]
    return set(zip(rows[keep].tolist(), pos[keep].tolist())), np.asarray(
        final_row
    ), np.asarray(final_carry)


def test_xla_matches_oracle_hits_state_and_carry():
    for seed, L, P in [(0, 257, 64), (1, 1000, 96), (2, 64, 32)]:
        symbols, scores = run_case(seed, L, P)
        expected, _ = ssv_reference(symbols, scores)
        exp_set = set(zip(expected.hit_rows.tolist(), expected.hit_positions.tolist()))
        got, final_row, final_carry = hits_from_xla(symbols, scores)
        assert got == exp_set
        assert len(exp_set) > 0
        np.testing.assert_array_equal(final_row, expected.final_row_state)
        np.testing.assert_array_equal(final_carry, expected.final_carry)


def test_xla_with_nonmultiple_row_count():
    symbols, scores = run_case(3, 128, 45)  # 45 not a multiple of 32
    expected, _ = ssv_reference(symbols, scores)
    exp_set = set(zip(expected.hit_rows.tolist(), expected.hit_positions.tolist()))
    got, _, final_carry = hits_from_xla(symbols, scores)
    assert got == exp_set
    np.testing.assert_array_equal(final_carry, expected.final_carry)


def test_xla_row_and_column_chunking():
    symbols, scores = run_case(4, 300, 64)
    whole, _ = ssv_reference(symbols, scores)
    whole_set = set(zip(whole.hit_rows.tolist(), whole.hit_positions.tolist()))

    # Row chunking: run rows [0, 32) then [32, 64) with state carry.
    h1, row1, _ = hits_from_xla(symbols, scores[:32])
    import jax.numpy as jnp

    h2, _, _ = hits_from_xla(symbols, scores[32:], init_state=jnp.asarray(row1))
    assert h1 | {(j + 32, i) for j, i in h2} == whole_set

    # Column chunking: positions [0, 128) then [128, 300) with carry.
    hl, _, carry_l = hits_from_xla(symbols[:128], scores)
    hr, _, _ = hits_from_xla(symbols[128:], scores, init_carry=jnp.asarray(carry_l))
    assert hl | {(j, i + 128) for j, i in hr} == whole_set


@pytest.mark.parametrize("card,reset", [(4, False), (4, True), (20, False),
                                        (20, True)])
def test_xla_score_lookup_matches_oracle(card, reset):
    """Match scores come from a per-row table lookup (no one-hot
    contraction): exact for both alphabets, with and without reset rows."""
    import jax.numpy as jnp

    from havac.ops.ssv_xla import ssv_scan_xla

    rng = np.random.default_rng(40 + card)
    L, P = 700, 64
    symbols = rng.integers(0, card, size=L).astype(np.uint8)
    scores = rng.integers(-60, 90, size=(P, card)).astype(np.int8)
    rr = (rng.random(P) < 0.1) if reset else None
    ist = rng.integers(0, 256, size=L).astype(np.int32)
    ic = rng.integers(0, 256, size=P + 1).astype(np.int32)
    want, _ = ssv_reference(symbols, scores, ist, ic, reset_rows=rr)
    bm, fs, fc = ssv_scan_xla(
        jnp.asarray(symbols), jnp.asarray(scores), jnp.asarray(ist),
        jnp.asarray(ic), None if rr is None else jnp.asarray(rr))
    rows, pos = decode_dense_bitmaps(np.asarray(bm), 32)
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)
    np.testing.assert_array_equal(np.asarray(fs), want.final_row_state)
    np.testing.assert_array_equal(np.asarray(fc), want.final_carry)


def test_xla_scan_has_no_dot():
    """The lowered scan contains no contraction: on a GPU an int32 dot is
    not a cuBLAS op, and a float one could run in TF32."""
    import jax
    import jax.numpy as jnp

    from havac.ops.ssv_xla import ssv_scan_xla

    hlo = ssv_scan_xla.lower(
        jax.ShapeDtypeStruct((256,), jnp.uint8),
        jax.ShapeDtypeStruct((32, 4), jnp.int8),
        jax.ShapeDtypeStruct((256,), jnp.int32),
        jax.ShapeDtypeStruct((33,), jnp.int32)).as_text()
    assert "dot_general" not in hlo and "stablehlo.dot" not in hlo
