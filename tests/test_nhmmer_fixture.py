"""Real-format nhmmer tblout fixture (checked in under tests/data/).

The round-1 validation tests only ever parsed tblout text synthesized from
the engine's own hits; this suite grounds the hmmerValidation /
hmmerSsvRef analogs (`test/hmmerValidation/hmmerValidation.cpp:77-132`,
`test/hmmerSsvRef`) in a committed fixture with the row features real
nhmmer output has: header/footer comment blocks, reverse-strand rows with
reversed coordinates, multiple windows per (model, sequence) pair, '-'
accession placeholders, and free-text descriptions.

Artifacts are generated deterministically by tests/data/make_nhmmer_fixture.py
(windows surround actual oracle hits of the committed models on the
committed FASTA, including a planted reverse-strand instance).
"""

import json
import os

from havac.engine.cli import main
from havac.validation import load_tblout

DATA = os.path.join(os.path.dirname(__file__), "data")
HMM = os.path.join(DATA, "nhmmer_fixture.hmm")
FASTA = os.path.join(DATA, "nhmmer_fixture.fasta")
TBLOUT = os.path.join(DATA, "nhmmer_fixture.tblout")


def test_fixture_parses_with_real_format_features():
    windows = load_tblout(TBLOUT)
    assert len(windows) >= 10
    # reverse-strand rows with reversed coordinates
    rev = [w for w in windows if w.strand == "-"]
    assert rev and all(w.ali_from > w.ali_to for w in rev)
    assert all(w.seq_lo < w.seq_hi for w in rev)
    # '-' accession placeholder maps to empty accession
    orphan = [w for w in windows if w.query_name == "orphan-2"]
    assert orphan and all(w.query_accession == "" for w in orphan)
    accessioned = [w for w in windows if w.query_name == "RF-like-1"]
    assert accessioned and all(
        w.query_accession == "RF09001" for w in accessioned)
    # multi-domain: some (target, query) pair has >= 2 windows
    from collections import Counter
    pairs = Counter((w.target_name, w.query_name, w.strand) for w in windows)
    assert max(pairs.values()) >= 2
    # scores/evalues parsed from the fixed-width columns
    assert all(w.score > 0 and 0 < w.evalue < 1 for w in windows)


def test_validate_cli_against_fixture_forward(capsys):
    rc = main(["validate", "--hmm", HMM, "--fasta", FASTA,
               "--tblout", TBLOUT, "--backend", "xla", "--pvalue", "0.02",
               "--slack", "2", "--min-recall", "0.95"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0, out
    assert out["hit_recall"] >= 0.95
    assert out["window_recall"] >= 0.95
    assert out["num_nhmmer_windows"] > 0


def test_validate_cli_against_fixture_both_strands(capsys):
    """strand=both: '-' windows stay in the comparison and are matched by
    minus-strand engine hits in forward coordinates."""
    rc = main(["validate", "--hmm", HMM, "--fasta", FASTA,
               "--tblout", TBLOUT, "--backend", "xla", "--pvalue", "0.02",
               "--strand", "both", "--slack", "2", "--min-recall", "0.95"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0, out
    # The '-' windows are part of the denominator now.
    fwd_windows = len([w for w in load_tblout(TBLOUT) if w.strand == "+"])
    assert out["num_nhmmer_windows"] > fwd_windows


def test_quantize_cli_against_fixture(capsys):
    rc = main(["quantize", "--hmm", HMM, "--fasta", FASTA,
               "--tblout", TBLOUT, "--backend", "xla", "--pvalue", "0.02"])
    assert rc == 0
    out = json.loads(capsys.readouterr().out)
    # Both models' windows rescored; planted windows pass at 256.
    assert "RF09001" in out and "orphan-2" in out
    for label, rep in out.items():
        assert rep["num_windows"] > 0
        assert rep["int8_pass_250"] >= rep["int8_pass_256"]
    assert out["RF09001"]["int8_pass_256"] >= 1
