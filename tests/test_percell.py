"""Per-cell DP matrix equivalence across backends (byCellComparator analog)."""

import numpy as np

from havac.ops.reference import ssv_reference
from havac.testing.percell import (
    compare_matrices,
    dp_matrix_gpu,
    dp_matrix_oracle,
    dp_matrix_xla,
)


def case(seed=0, L=700, P=24):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, size=L).astype(np.uint8),
            rng.integers(-40, 110, size=(P, 4)).astype(np.int8))


def test_xla_matches_oracle_per_cell():
    symbols, scores = case(1)
    assert compare_matrices(dp_matrix_oracle(symbols, scores),
                            dp_matrix_xla(symbols, scores)) == []


def test_pallas_matches_oracle_per_cell():
    """The shipping GPU kernel (a Pallas kernel, here interpreted), cell for
    cell vs the oracle — the byCellComparator instrumented the shipping
    implementation, not a stand-in (`byCellComparator.cpp:47-96`)."""
    symbols, scores = case(2, L=1500, P=12)
    assert compare_matrices(dp_matrix_oracle(symbols, scores),
                            dp_matrix_gpu(symbols, scores)) == []


def test_gpu_per_cell_many_blocks():
    symbols, scores = case(6, L=3000, P=47)  # P not a hit-group multiple
    assert compare_matrices(dp_matrix_oracle(symbols, scores),
                            dp_matrix_gpu(symbols, scores)) == []


def test_gpu_per_cell_with_carry_and_isolation():
    """Per-cell equality with a nonzero incoming carry column and
    model-isolation reset rows."""
    rng = np.random.default_rng(8)
    L, P = 4000, 35
    symbols = rng.integers(0, 4, size=L).astype(np.uint8)
    scores = rng.integers(-40, 110, size=(P, 4)).astype(np.int8)
    icarry = rng.integers(0, 256, size=P + 1).astype(np.int32)
    reset = np.zeros(P, dtype=bool)
    reset[[0, 13, 27]] = True
    _, want = ssv_reference(symbols, scores, init_carry=icarry,
                            reset_rows=reset, return_matrix=True)
    got = dp_matrix_gpu(symbols, scores, init_carry=icarry,
                        reset_rows=reset)
    assert compare_matrices(want, got) == []


def test_comparator_reports_mismatches():
    symbols, scores = case(3, L=300, P=8)
    m = dp_matrix_oracle(symbols, scores)
    bad = m.copy()
    bad[4, 100] += 1
    bad[7, 2] = 0 if m[7, 2] else 1
    report = compare_matrices(m, bad)
    assert {(c.row, c.position) for c in report} == {(4, 100), (7, 2)}


def test_explain_hit_walkback():
    """Every oracle hit must be explainable: the walkback chain reaches
    >= 256 exactly at the hit cell (multiInputTest walkback analog)."""
    from havac.hits.decode import explain_hit
    from havac.ops.reference import ssv_reference

    symbols, scores = case(4, L=900, P=40)
    res, _ = ssv_reference(symbols, scores)
    assert len(res.hit_rows) > 0
    for j, i in list(zip(res.hit_rows, res.hit_positions))[:50]:
        ex = explain_hit(j, i, symbols, scores)
        assert ex.reached >= 256
        assert ex.states[-1] == 0  # post-hit reset
        assert ex.chain_start_row <= j and ex.chain_start_position <= i
        # chain is a true diagonal
        assert (j - ex.chain_start_row) == (i - ex.chain_start_position)


def test_explain_non_hit_stays_below_threshold():
    from havac.hits.decode import explain_hit
    from havac.ops.reference import ssv_reference

    symbols, scores = case(5, L=400, P=16)
    res, _ = ssv_reference(symbols, scores)
    hitset = set(zip(res.hit_rows.tolist(), res.hit_positions.tolist()))
    import numpy as _np
    rng = _np.random.default_rng(0)
    checked = 0
    while checked < 25:
        j = int(rng.integers(0, 16)); i = int(rng.integers(0, 400))
        if (j, i) in hitset:
            continue
        assert explain_hit(j, i, symbols, scores).reached < 256
        checked += 1
