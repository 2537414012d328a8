"""Sharded wavefront sweep vs the scalar oracle, on an 8-device CPU mesh.

The multi-chip analog of the reference's exact hit-for-hit integration rung
(`host/test/RefernceComparisonTest/ReferenceComparisonTest.cpp:66-80`): the
sequence-sharded pipeline must be bit-exact, including hits whose diagonal
chains cross shard seams.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from havac.ops.reference import ssv_reference
from havac.parallel.wavefront import ssv_wavefront
from havac.scoring.reprojection import project_models
from havac.testing.generator import generate_planted_fixture
from havac.io.fasta import load_fasta_database


def make_mesh(n):
    devices = np.array(jax.devices()[:n])
    return Mesh(devices, ("seq",))


def case(seed, L, P, num_models=2):
    models, records = generate_planted_fixture(
        seed=seed, model_length=P, sequence_length=L, num_models=num_models)
    db = load_fasta_database(
        "".join(f">{n}\n{s}\n" for n, s in records), is_text=True)
    scores = project_models(models, 0.05)
    return db.codes, scores


@pytest.mark.parametrize("n_devices", [2, 8])
def test_wavefront_matches_oracle(n_devices):
    codes, scores = case(seed=21, L=4096, P=64)
    mesh = make_mesh(n_devices)
    rows, pos = ssv_wavefront(codes, scores, mesh, rows_per_step=32)
    want, _ = ssv_reference(codes, scores)
    assert len(want.hit_rows) > 0
    assert np.array_equal(rows, want.hit_rows)
    assert np.array_equal(pos, want.hit_positions)


def test_wavefront_seam_crossing_chain():
    """Plant a hit whose diagonal chain straddles a shard seam: symbols that
    score +32 everywhere force chains through every seam."""
    L, P = 1024, 64
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=L).astype(np.uint8)
    scores = np.full((P, 4), 5, dtype=np.int8)  # monotone rising chains
    mesh = make_mesh(8)  # shards of 128 < chain length
    rows, pos = ssv_wavefront(codes, scores, mesh, rows_per_step=32)
    want, _ = ssv_reference(codes, scores)
    assert len(want.hit_rows) > 100
    assert np.array_equal(rows, want.hit_rows)
    assert np.array_equal(pos, want.hit_positions)


def test_wavefront_multistrip_pipeline():
    """More strips than devices: exercises the full pipeline fill/drain."""
    codes, scores = case(seed=5, L=2048, P=200, num_models=3)
    mesh = make_mesh(4)
    rows, pos = ssv_wavefront(codes, scores, mesh, rows_per_step=64)
    want, _ = ssv_reference(codes, scores)
    assert np.array_equal(rows, want.hit_rows)
    assert np.array_equal(pos, want.hit_positions)


def test_wavefront_ragged_padding():
    """L not divisible by D, P not divisible by R."""
    codes, scores = case(seed=13, L=3001, P=47, num_models=1)
    mesh = make_mesh(8)
    rows, pos = ssv_wavefront(codes, scores, mesh, rows_per_step=32)
    want, _ = ssv_reference(codes, scores)
    assert np.array_equal(rows, want.hit_rows)
    assert np.array_equal(pos, want.hit_positions)
