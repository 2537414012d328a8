"""Oracle self-tests: the numpy SSV reference vs a brute-force per-diagonal
scalar implementation, plus chunking/carry invariants (the invariants the
Pallas kernel and the sharded path rely on)."""

import numpy as np

from havac.ops.reference import ssv_reference, ssv_reference_hits_set


def brute_force_ssv(symbols, scores):
    """Direct per-cell scalar DP, the most literal transcription possible."""
    L, P = len(symbols), len(scores)
    S = np.zeros((P + 1, L + 1), dtype=np.int64)  # 1-based halo of zeros
    hits = set()
    for j in range(P):
        for i in range(L):
            s = S[j, i] + int(scores[j][symbols[i]])
            if s < 0:
                s = 0
            elif s >= 256:
                s = 0
                hits.add((j, i))
            S[j + 1, i + 1] = s
    return hits, S[1:, 1:]


def random_case(seed, L=97, P=23, hot=True):
    rng = np.random.default_rng(seed)
    symbols = rng.integers(0, 4, size=L).astype(np.uint8)
    # Bias scores positive enough that threshold crossings actually happen.
    lo, hi = (-40, 120) if hot else (-128, 40)
    scores = rng.integers(lo, hi, size=(P, 4)).astype(np.int8)
    return symbols, scores


def test_oracle_matches_brute_force_with_hits():
    for seed in range(5):
        symbols, scores = random_case(seed, hot=True)
        expected_hits, expected_matrix = brute_force_ssv(symbols, scores)
        result, matrix = ssv_reference(symbols, scores, return_matrix=True)
        got = set(zip(result.hit_rows.tolist(), result.hit_positions.tolist()))
        assert got == expected_hits
        assert len(expected_hits) > 0  # the case must actually exercise hits
        np.testing.assert_array_equal(matrix, expected_matrix)


def test_oracle_matches_brute_force_cold():
    symbols, scores = random_case(99, hot=False)
    expected_hits, _ = brute_force_ssv(symbols, scores)
    assert ssv_reference_hits_set(symbols, scores) == expected_hits


def test_state_values_stay_in_byte_range():
    symbols, scores = random_case(1, L=256, P=64, hot=True)
    _, matrix = ssv_reference(symbols, scores, return_matrix=True)
    assert matrix.min() >= 0
    assert matrix.max() <= 255


def test_row_chunking_with_state_carry_is_exact():
    """Splitting model rows into chunks and passing final_row_state must give
    identical hits — the invariant the engine's row-chunk loop relies on."""
    symbols, scores = random_case(2, L=128, P=40, hot=True)
    whole = ssv_reference_hits_set(symbols, scores)

    r1, _ = ssv_reference(symbols, scores[:17])
    r2, _ = ssv_reference(symbols, scores[17:], init_row_state=r1.final_row_state)
    chunked = set(zip(r1.hit_rows.tolist(), r1.hit_positions.tolist())) | set(
        zip((r2.hit_rows + 17).tolist(), r2.hit_positions.tolist())
    )
    assert chunked == whole


def test_column_chunking_with_carry_is_exact():
    """Splitting sequence positions into chunks and passing final_carry must
    give identical hits — the score-queue invariant (`device/HavacHls.cpp:
    451-465`) and the ppermute seam-exchange invariant (SURVEY.md §2.5)."""
    symbols, scores = random_case(3, L=150, P=31, hot=True)
    whole = ssv_reference_hits_set(symbols, scores)

    cut = 64
    left, _ = ssv_reference(symbols[:cut], scores)
    right, _ = ssv_reference(symbols[cut:], scores, init_carry=left.final_carry)
    chunked = set(zip(left.hit_rows.tolist(), left.hit_positions.tolist())) | set(
        zip(right.hit_rows.tolist(), (right.hit_positions + cut).tolist())
    )
    assert chunked == whole


def test_overlap_recompute_is_exact():
    """Processing a right shard with a zero carry but an overlap prefix of
    >= P positions reproduces exact hits in the shard interior — the
    overlap-and-dedupe sharding mode (SURVEY.md §7(e))."""
    symbols, scores = random_case(4, L=300, P=25, hot=True)
    whole = ssv_reference_hits_set(symbols, scores)

    cut, P = 160, 25
    left, _ = ssv_reference(symbols[:cut], scores)
    overlap_start = cut - P
    right, _ = ssv_reference(symbols[overlap_start:], scores)  # zero carry
    right_hits = {
        (j, i + overlap_start)
        for j, i in zip(right.hit_rows.tolist(), right.hit_positions.tolist())
        if i + overlap_start >= cut  # drop hits inside the overlap prefix
    }
    left_hits = set(zip(left.hit_rows.tolist(), left.hit_positions.tolist()))
    assert left_hits | right_hits == whole
