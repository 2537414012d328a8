"""havac — a GPU SSV (Single-segment ungapped Viterbi) homology-search engine.

A brand-new JAX/Pallas implementation of the capabilities of TravisWheelerLab/HAVAC
(an FPGA SSV accelerator): scan multi-FASTA nucleotide databases against HMMER3
profile-HMM collections with the int8 threshold-256 SSV recurrence, reporting exact
hit coordinates compatible with nhmmer's SSV filter stage.

Public API (mirrors the reference driver `host/Havac.hpp:42-107`):

    from havac import Havac
    hv = Havac(p_value=0.02)
    hv.load_phmm("models.hmm")
    hv.load_sequence("db.fasta")
    hv.run()                      # or hv.run_async(); hv.wait()
    for si, sp, mi, mp in hv.hits().as_tuples():
        print(si, sp, mi, mp)
"""

from havac.scoring.reprojection import (
    gumbel_inverse_survival,
    threshold256_scale_factor,
    project_scores_for_threshold256,
)


def __getattr__(name):
    # Engine imports jax; keep top-level import light so pure-numpy users
    # (parsers, reprojection) avoid jax initialization.
    if name in ("Havac", "HavacRunState"):
        from havac.engine import api

        return getattr(api, name)
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")

__version__ = "0.1.0"

__all__ = [
    "Havac",
    "HavacRunState",
    "gumbel_inverse_survival",
    "threshold256_scale_factor",
    "project_scores_for_threshold256",
]
