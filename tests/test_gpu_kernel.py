"""The compiled GPU kernel (Triton, not the interpreter) vs the oracle.

These need a GPU and skip elsewhere; ``chip_smoke.py`` runs them on the card.
The interpreted kernel's arithmetic is covered on the CPU by
``tests/test_ssv_gpu.py``; these check what only the GPU compiler can show.
"""

import numpy as np
import pytest

from havac.ops.reference import ssv_reference

pytestmark = pytest.mark.gpu


@pytest.fixture
def gpu():
    import jax

    if jax.default_backend() != "gpu":
        pytest.skip("needs a GPU: the compiled Triton kernel has no CPU "
                    "backend (tests/test_ssv_gpu.py covers the interpreter)")


def case(seed, L, P, card=4, lo=-40, hi=110):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, card, size=L).astype(np.uint8),
            rng.integers(lo, hi, size=(P, card)).astype(np.int8),
            rng.integers(0, 256, size=L).astype(np.int32),
            rng.integers(0, 256, size=P + 1).astype(np.int32))


@pytest.mark.parametrize("seed,L,P,card", [
    (0, 30011, 77, 4),   # interior and edge programs, ragged P
    (1, 300, 20, 4),     # every program an edge program
    (2, 60, 150, 4),     # P > L
    (3, 9000, 45, 20),   # amino table gather
])
def test_compiled_kernel_matches_oracle(gpu, seed, L, P, card):
    from havac.ops.ssv_gpu import ssv_gpu

    lo = -60 if card == 20 else -40
    sym, sc, ist, ic = case(seed, L, P, card, lo=lo)
    reset = np.zeros(P, dtype=bool)
    reset[::17] = True
    want, _ = ssv_reference(sym, sc, ist, ic, reset_rows=reset)
    rows, pos, state, carry = ssv_gpu(sym, sc, ist, ic, reset,
                                      max_hits=1 << 22)
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)
    np.testing.assert_array_equal(state, want.final_row_state)
    np.testing.assert_array_equal(carry, want.final_carry)


def test_compiled_kernel_overflow_count_is_exact(gpu):
    import jax.numpy as jnp

    from havac.ops.ssv_gpu import ssv_gpu_scan

    sym = np.zeros(5000, dtype=np.uint8)
    sc = np.full((64, 4), 127, dtype=np.int8)
    want, _ = ssv_reference(sym, sc)
    out = ssv_gpu_scan(jnp.asarray(sym), jnp.asarray(sc),
                       jnp.zeros(5000, jnp.int32), jnp.zeros(65, jnp.int32),
                       cap=1000)
    assert int(out[2]) == want.hit_rows.size > 1000


def test_compiled_engine_matches_oracle(gpu):
    from havac.engine import Havac
    from havac.hits.decode import resolve_hits
    from havac.testing.generator import generate_planted_fixture

    models, records = generate_planted_fixture(
        seed=7, model_length=48, sequence_length=30000, num_models=3)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    e = Havac(p_value=0.05, backend="gpu", chunk_symbols=8192,
              chunk_rows=64)
    e.load_phmm(models).load_sequence(fasta, is_text=True).run()
    want, _ = ssv_reference(e.database.codes, e.scores)
    want = resolve_hits(want.hit_rows, want.hit_positions, e.database,
                        e.phmm_prefix)
    assert len(want) > 0 and e.stats.num_chunks > 1
    assert sorted(e.hits().as_tuples()) == sorted(want.as_tuples())
