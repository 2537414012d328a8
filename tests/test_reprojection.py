"""Reprojection numerics tests (vs hand-computed values and the reference's
legacy per-score formula, mirroring the equivalence kept at
`PhmmReprojection/PhmmReprojection.cpp:88-107`)."""

import math

import numpy as np
import pytest

from havac.scoring.reprojection import (
    c_round,
    gumbel_inverse_survival,
    legacy_project_single_score,
    project_models,
    project_scores_for_threshold256,
    threshold256_scale_factor,
)
from havac.testing.generator import model_from_consensus


def test_gumbel_inverse_survival_matches_direct_formula():
    mu, lam = -9.8664, 0.71313
    for p in (0.5, 0.05, 0.02, 1e-4):
        expected = mu - math.log(-math.log(1 - p)) / lam
        assert gumbel_inverse_survival(p, mu, lam) == pytest.approx(expected, rel=1e-12)


def test_gumbel_inverse_survival_small_p_guard():
    mu, lam = -9.8664, 0.71313
    p = 1e-12  # below the 5e-9 epsilon: series approximation path
    approx = mu - ((math.pow(p, p) - 1) / p) / lam
    assert gumbel_inverse_survival(p, mu, lam) == pytest.approx(approx, rel=1e-12)
    # The series is close to the true value at small p.
    true = mu - math.log(-math.log1p(-p)) / lam
    assert gumbel_inverse_survival(p, mu, lam) == pytest.approx(true, rel=1e-3)


def test_c_round_half_away_from_zero():
    x = np.array([0.5, 1.5, 2.5, -0.5, -1.5, -2.5, 0.4999, -0.4999])
    assert np.array_equal(c_round(x), [1, 2, 3, -1, -2, -3, 0, -0.0])


def test_scale_factor_reasonable_and_monotonic_in_pvalue():
    # More stringent p-value → higher bits threshold → smaller scale factor.
    kwargs = dict(msv_mu=-9.8664, msv_lambda=0.71313, max_length=400, model_length=100)
    s_loose = threshold256_scale_factor(p_value=0.05, **kwargs)
    s_tight = threshold256_scale_factor(p_value=0.001, **kwargs)
    assert 0 < s_tight < s_loose
    # Threshold in bits for nucleotide SSV at p=0.02 is typically 10-30 bits,
    # so the scale lands in roughly [256/30, 256/10].
    s = threshold256_scale_factor(p_value=0.02, **kwargs)
    assert 256.0 / 40.0 < s < 256.0 / 5.0


def test_projection_matches_legacy_per_score_formula():
    rng = np.random.default_rng(7)
    emissions = rng.uniform(0.0, 9.0, size=(64, 4)).astype(np.float32)
    scale = 14.37
    vectorized = project_scores_for_threshold256(emissions, scale)
    for idx in np.ndindex(emissions.shape):
        assert vectorized[idx] == legacy_project_single_score(emissions[idx], scale)


def test_projection_saturates():
    scores = np.array([[0.0, 100.0, np.inf, 0.2]], dtype=np.float32)
    out = project_scores_for_threshold256(scores, 50.0)
    assert out.dtype == np.int8
    assert out[0, 0] == 100  # 2*50 = 100
    assert out[0, 1] == -128  # hugely negative → saturate
    assert out[0, 2] == -128  # impossible emission ('*')


def test_project_models_concatenates_with_per_model_scales():
    m1 = model_from_consensus(np.array([0, 1, 2, 3]), name="a")
    m2 = model_from_consensus(np.array([3, 2, 1]), name="b", max_length=999)
    flat = project_models([m1, m2], p_value=0.02)
    assert flat.shape == (7, 4)
    assert flat.dtype == np.int8
    # Per-model scale: each model projected independently.
    s1 = threshold256_scale_factor(m1.msv_mu, m1.msv_lambda, m1.max_length, m1.model_length, 0.02)
    expect1 = project_scores_for_threshold256(m1.match_scores, s1)
    assert np.array_equal(flat[:4], expect1)
    # Consensus symbol scores positive, off-consensus negative.
    assert flat[0, 0] > 0 > flat[0, 1]
