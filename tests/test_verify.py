"""Batch hit verification (HitVerifier analog, host/host/HitVerifier.cpp).

Every reported hit must be reproducible by a bounded re-SSV replay of its
diagonal; corrupted hits must be detected. The reference's live API claims
this verification happens (`host/Havac.hpp:74-77`) but never does it —
these tests pin down that we actually do.
"""

import numpy as np
import pytest

from havac.engine import Havac, HavacRunState
from havac.hits.verify import (
    HitVerificationError,
    verify_hits,
)
from havac.ops.common import SsvKernelConfig
from havac.ops.reference import ssv_reference
from havac.testing.generator import generate_planted_fixture

CFG = SsvKernelConfig(block_width=1024, rows_per_strip=8)


def case(seed=0, L=4000, P=64):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, 4, size=L).astype(np.uint8),
            rng.integers(-40, 110, size=(P, 4)).astype(np.int8))


def test_all_oracle_hits_verify():
    symbols, scores = case(1)
    res, _ = ssv_reference(symbols, scores)
    assert len(res.hit_rows) > 0
    report = verify_hits(res.hit_rows, res.hit_positions, symbols, scores)
    assert report.all_verified
    assert (report.reached >= 256).all()


def test_corrupted_hits_are_flagged():
    symbols, scores = case(2)
    res, _ = ssv_reference(symbols, scores)
    hitset = set(zip(res.hit_rows.tolist(), res.hit_positions.tolist()))
    rows = res.hit_rows.copy()
    pos = res.hit_positions.copy()
    # Corrupt one decoded hit to a neighboring non-hit cell.
    for delta in (1, 2, 3):
        cand = (int(rows[0]), int(pos[0]) + delta)
        if cand not in hitset and cand[1] < symbols.shape[0]:
            pos[0] = cand[1]
            break
    else:
        pytest.skip("no non-hit neighbor found")
    report = verify_hits(rows, pos, symbols, scores)
    assert not report.all_verified
    assert report.unverified_indices.tolist() == [0]
    assert report.reached[0] < 256
    assert report.num_verified == report.num_hits - 1


def test_long_chain_escalates_past_initial_bound():
    """A chain needing >initial_bound steps must still verify (escalation to
    the full diagonal removes bounded-window false negatives)."""
    L = P = 400
    symbols = np.zeros(L, dtype=np.uint8)
    scores = np.zeros((P, 4), dtype=np.int8)
    scores[:, 0] = 1  # every step adds 1 → hit exactly at chain step 256
    res, _ = ssv_reference(symbols, scores)
    assert len(res.hit_rows) > 0
    assert int(res.hit_rows.min()) == 255  # needs a 256-step chain
    report = verify_hits(res.hit_rows, res.hit_positions, symbols, scores,
                         initial_bound=8)
    assert report.all_verified


def test_verification_with_model_isolation():
    symbols, scores = case(3, L=3000, P=60)
    reset = np.zeros(60, dtype=bool)
    reset[[0, 20, 40]] = True
    res, _ = ssv_reference(symbols, scores, reset_rows=reset)
    report = verify_hits(res.hit_rows, res.hit_positions, symbols, scores,
                         reset_rows=reset)
    assert report.all_verified
    if len(res.hit_rows):
        # Without the reset rows the replay disagrees for chains that the
        # isolation actually cut (only assert when such hits exist).
        rep2 = verify_hits(res.hit_rows, res.hit_positions, symbols, scores)
        assert rep2.num_verified >= report.num_verified - len(res.hit_rows)


def test_engine_auto_verification_passes():
    models, records = generate_planted_fixture(
        seed=17, model_length=48, sequence_length=4000, num_models=2)
    engine = Havac(p_value=0.05, config=CFG, backend="xla", verify_hits=True)
    engine.load_phmm(models)
    engine.load_sequence(
        "".join(f">{n}\n{s}\n" for n, s in records), is_text=True)
    engine.run()
    assert engine.state == HavacRunState.COMPLETED
    assert engine.verification is not None
    assert engine.verification.all_verified
    assert engine.stats.num_unverified == 0
    assert len(engine.hits()) > 0


def test_engine_verify_detects_corruption():
    models, records = generate_planted_fixture(
        seed=19, model_length=48, sequence_length=4000, num_models=2)
    engine = Havac(p_value=0.05, config=CFG, backend="xla")
    engine.load_phmm(models)
    engine.load_sequence(
        "".join(f">{n}\n{s}\n" for n, s in records), is_text=True)
    engine.run()
    assert engine.verify().all_verified
    # Corrupt one decoded hit (simulating a kernel/decode regression) — the
    # public verify() must catch it.
    hitset = set(zip(engine._hit_rows.tolist(), engine._hit_positions.tolist()))
    assert hitset
    for delta in (1, 2, 3, 5):
        cand = (int(engine._hit_rows[0]),
                int(engine._hit_positions[0]) + delta)
        if cand not in hitset:
            engine._hit_positions[0] = cand[1]
            break
    report = engine.verify()
    assert not report.all_verified

    # And with verify_hits=True the corrupted run errors out:
    engine2 = Havac(p_value=0.05, config=CFG, backend="xla",
                    verify_hits=True)
    engine2.load_phmm(models)
    engine2.load_sequence(
        "".join(f">{n}\n{s}\n" for n, s in records), is_text=True)
    # Intercept the verification hook to corrupt a decoded hit first
    # (simulating a decode regression inside the run).
    orig = engine2._maybe_verify

    def corrupt_then_verify():
        rows2 = engine2._hit_rows
        pos2 = engine2._hit_positions
        hs = set(zip(rows2.tolist(), pos2.tolist()))
        for delta in (1, 2, 3, 5, 7):
            if (int(rows2[0]), int(pos2[0]) + delta) not in hs:
                pos2[0] += delta
                break
        orig()

    engine2._maybe_verify = corrupt_then_verify
    with pytest.raises(HitVerificationError):
        engine2.run()
    assert engine2.state == HavacRunState.ERROR


def test_mid_window_true_reset_cannot_fake_a_hit():
    """A bogus endpoint hit whose diagonal had a TRUE >=256 reset inside the
    replay window must be rejected: a one-sided replay-from-0 would reach
    >=256 at the endpoint (the true chain reset to 0 mid-window while the
    low replay kept climbing) and falsely accept it. The two-sided replay
    escalates through the ambiguity and decides exactly."""
    P, L = 1010, 2000
    symbols = np.zeros(L, dtype=np.uint8)
    scores = np.zeros((P, 4), dtype=np.int8)
    scores[:100, 0] = 2      # true incoming state builds to 200...
    scores[940, 0] = 60      # ...and truly resets at row 940 (260 >= 256)
    scores[941:1000, 0] = 3  # 59 x 3 = 177
    scores[1000, 0] = 23     # replay-from-0: 60+177+23 = 260 >= 256 (fake!)
    # true endpoint: 0 + 177 + 23 = 200 < 256 -> NOT a hit
    pos0 = 1500
    bogus = (1000, pos0)
    true_hit = (940, pos0 - 60)
    rows = np.array([bogus[0], true_hit[0]], dtype=np.int64)
    positions = np.array([bogus[1], true_hit[1]], dtype=np.int64)
    rep = verify_hits(rows, positions, symbols, scores, initial_bound=64)
    assert rep.num_verified == 1
    assert list(rep.unverified_indices) == [0]  # the bogus one
    assert rep.reached[1] >= 256  # the true reset cell verifies

    # cross-check both cells against the oracle
    res, _ = ssv_reference(symbols, scores)
    oracle = set(zip(res.hit_rows.tolist(), res.hit_positions.tolist()))
    assert true_hit in oracle and bogus not in oracle
