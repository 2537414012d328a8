"""Randomized cross-implementation parity: every kernel vs the oracle.

Seeded sweep over irregular shapes, score ranges, and boundary conditions —
the broad net behind the targeted tests (reference analog: the generated
softwareTestbench inputs, test/softwareTestbench.cpp:43-170).
"""

import numpy as np
import pytest

from havac.hits.decode import decode_dense_bitmaps
from havac.ops.reference import ssv_reference
from havac.ops.ssv_gpu import ssv_gpu


def random_case(rng, card=4):
    L = int(rng.integers(50, 5000))
    P = int(rng.integers(1, 120))
    lo = int(rng.integers(-128, -20))
    hi = int(rng.integers(lo + 10, 128))
    symbols = rng.integers(0, card, size=L).astype(np.uint8)
    scores = rng.integers(lo, hi, size=(P, card)).astype(np.int8)
    init_state = (rng.integers(0, 256, size=L).astype(np.int32)
                  if rng.random() < 0.3 else None)
    init_carry = (rng.integers(0, 256, size=P + 1).astype(np.int32)
                  if rng.random() < 0.3 else None)
    return symbols, scores, init_state, init_carry


@pytest.mark.parametrize("seed", range(12))
def test_fuzz_gpu_kernel_vs_oracle(seed):
    """Hits, final row state and final carry, exact; every fourth case is
    an amino (card 20) case and every third has reset rows."""
    rng = np.random.default_rng(1000 + seed)
    card = 20 if seed % 4 == 3 else 4
    symbols, scores, init_state, init_carry = random_case(rng, card)
    reset = None
    if seed % 3 == 2:
        reset = rng.random(scores.shape[0]) < 0.1
    want, _ = ssv_reference(symbols, scores, init_row_state=init_state,
                            init_carry=init_carry, reset_rows=reset)
    r, p, fs, fc = ssv_gpu(symbols, scores, init_state=init_state,
                           init_carry=init_carry, reset_rows=reset,
                           max_hits=1 << 20, interpret=True)
    np.testing.assert_array_equal(r, want.hit_rows)
    np.testing.assert_array_equal(p, want.hit_positions)
    np.testing.assert_array_equal(fs, want.final_row_state)
    np.testing.assert_array_equal(fc, want.final_carry)


@pytest.mark.parametrize("seed", range(6))
def test_fuzz_xla_isolation_vs_oracle(seed):
    import jax.numpy as jnp

    from havac.ops.ssv_xla import ssv_scan_xla

    rng = np.random.default_rng(2000 + seed)
    symbols, scores, _, _ = random_case(rng)
    P = scores.shape[0]
    reset = rng.random(P) < 0.1
    reset[0] = True
    want, _ = ssv_reference(symbols, scores, reset_rows=reset)

    K = 32
    P2 = -(-P // K) * K
    sp = np.full((P2, 4), -128, dtype=np.int8)
    sp[:P] = scores
    rr = np.zeros(P2, dtype=np.int32)
    rr[:P] = reset
    bm, _, _ = ssv_scan_xla(
        jnp.asarray(symbols), jnp.asarray(sp),
        jnp.zeros(symbols.shape[0], jnp.int32),
        jnp.zeros(P2 + 1, jnp.int32), jnp.asarray(rr), rows_per_strip=K)
    rows, pos = decode_dense_bitmaps(np.asarray(bm), K)
    keep = rows < P
    assert set(zip(rows[keep].tolist(), pos[keep].tolist())) == set(
        zip(want.hit_rows.tolist(), want.hit_positions.tolist()))
