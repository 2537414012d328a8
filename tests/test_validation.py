"""Validation subsystem tests: tblout parsing, containment, quantization.

nhmmer itself is not available in CI, so tblout fixtures are synthesized —
windows derived from the oracle's own hits must give 100% bidirectional
recall, and perturbed windows must be reported (the comparison logic of
`test/hmmerValidation/hmmerValidation.cpp:77-132`).
"""

import numpy as np

from havac.engine import Havac
from havac.io.fasta import load_fasta_database
from havac.ops.common import SsvKernelConfig
from havac.testing.generator import generate_planted_fixture
from havac.validation import (
    compare_containment,
    engine_hits_for_comparison,
    parse_tblout,
    quantization_report,
)

CFG = SsvKernelConfig(block_width=1024, rows_per_strip=8)


def run_engine():
    models, records = generate_planted_fixture(
        seed=23, model_length=48, sequence_length=4000, num_models=2)
    engine = Havac(p_value=0.05, config=CFG, backend="xla")
    engine.load_phmm(models)
    engine.load_sequence(
        "".join(f">{n}\n{s}\n" for n, s in records), is_text=True)
    engine.run()
    return engine


def tblout_from_hits(hits, pad=20):
    """Synthesize a tblout table whose windows surround the given hits."""
    rows = []
    for seq, pos, model, *rest in hits:
        strand = rest[0] if rest else "+"
        lo, hi = max(1, pos + 1 - pad), pos + 1 + pad
        if strand == "-":
            lo, hi = hi, lo  # nhmmer reports minus-strand coords reversed
        rows.append(
            f"{seq} - {model} {model} 1 48 {lo} {hi} {lo} {hi} "
            f"4000 {strand} 1e-9 30.0 0.1 synthetic")
    return "\n".join(["# target name ..."] + rows)


def test_tblout_parse_fields():
    text = ("#comment\n"
            "chr22 - mod1 RF00001 3 40 100 60 95 65 4000 - 1e-5 20.5 0.0 d\n")
    (w,) = parse_tblout(text)
    assert w.target_name == "chr22"
    assert w.query_accession == "RF00001"
    assert w.seq_lo == 65 and w.seq_hi == 95  # env coords, reversed strand
    assert w.strand == "-"
    assert w.score == 20.5


def test_containment_roundtrip_is_perfect():
    engine = run_engine()
    hits = engine_hits_for_comparison(engine)
    assert hits
    windows = parse_tblout(tblout_from_hits(hits))
    report = compare_containment(hits, windows)
    assert report.hit_recall == 1.0
    assert report.window_recall == 1.0


def test_containment_detects_disagreements():
    engine = run_engine()
    hits = engine_hits_for_comparison(engine)
    windows = parse_tblout(tblout_from_hits(hits))
    # A window nowhere near any hit must be reported uncovered...
    stray = parse_tblout(
        "zzz - synth-0 synth-0 1 48 1 10 1 10 4000 + 1e-9 30.0 0.1 x")
    report = compare_containment(hits, windows + stray)
    assert report.window_recall < 1.0
    assert report.uncovered_windows == stray
    # ...and an extra engine hit with no window must be uncontained.
    report2 = compare_containment(
        hits + [("synth-seq-0", 999999, "synth-0")], windows)
    assert report2.hit_recall < 1.0
    assert report2.uncontained_hits == [("synth-seq-0", 999999, "synth-0")]
    # Reverse-strand windows are ignored under watson_only.
    rev = parse_tblout(
        "zzz - synth-0 synth-0 1 48 10 1 10 1 4000 - 1e-9 30.0 0.1 x")
    report3 = compare_containment(hits, windows + rev)
    assert report3.window_recall == 1.0


def test_stranded_hits_match_only_same_strand_windows():
    # A '-' hit (forward coordinates) must match a '-' window at the same
    # interval, and must NOT be claimed by a '+' window there (and vice
    # versa) — the ADVICE round-1 finding on validate --strand both.
    minus_hit = [("chrT", 100, "mod", "-")]
    plus_window = parse_tblout(
        "chrT - mod mod 1 48 90 110 90 110 4000 + 1e-9 30.0 0.1 x")
    minus_window = parse_tblout(
        "chrT - mod mod 1 48 110 90 110 90 4000 - 1e-9 30.0 0.1 x")
    rep = compare_containment(minus_hit, plus_window + minus_window,
                              watson_only=False)
    assert rep.hit_recall == 1.0
    assert rep.windows_covered == 1  # only the '-' window
    rep2 = compare_containment(minus_hit, plus_window, watson_only=False)
    assert rep2.hit_recall == 0.0
    # Legacy 3-tuple hits (no strand) still match either strand.
    rep3 = compare_containment([("chrT", 100, "mod")],
                               plus_window + minus_window, watson_only=False)
    assert rep3.hits_contained == 1
    assert rep3.windows_covered == 2


def test_quantization_report_planted_vs_background():
    models, records = generate_planted_fixture(
        seed=29, model_length=40, sequence_length=2000, num_models=1)
    model = models[0]
    db = load_fasta_database(
        "".join(f">{n}\n{s}\n" for n, s in records), is_text=True)
    rng = np.random.default_rng(0)
    # Windows containing planted material vs pure random background.
    planted = [db.codes[:500], db.codes[500:1200], db.codes[1200:2000]]
    background = [rng.integers(0, 4, size=500).astype(np.uint8)
                  for _ in range(3)]
    rep_hot = quantization_report(planted, model, p_value=0.05)
    # At p=0.05 random background may legitimately pass now and then; a
    # strict threshold separates plants from noise.
    rep_cold = quantization_report(background, model, p_value=1e-6)
    assert rep_hot.int8_pass_256 >= 1
    assert rep_cold.int8_pass_256 == 0
    # int8 and float projections agree away from the threshold boundary.
    assert rep_cold.agreements == rep_cold.num_windows
    # pass@250 is at least as permissive as pass@256.
    assert rep_hot.int8_pass_250 >= rep_hot.int8_pass_256


# ---------------------------------------------------------------------------
# Independent float-space SSV oracle (VERDICT r3 #7): the engine validated
# against a quantization-free reimplementation of nhmmer's SSV scoring that
# shares only the published spec, not code, with the engine/kernel paths.
# ---------------------------------------------------------------------------


def test_float_oracle_crossings_match_scalar_oracle_when_exact():
    """With integer-valued float scores the float oracle must agree with
    ops.reference exactly (no quantization boundary to disagree across)."""
    from havac.ops.reference import ssv_reference
    from havac.validation.ssv_filter import float_ssv_crossings

    rng = np.random.default_rng(3)
    codes = rng.integers(0, 4, size=5000).astype(np.uint8)
    scores = rng.integers(-40, 36, size=(60, 4)).astype(np.int8)
    res, _ = ssv_reference(codes, scores)
    rows, pos, sc = float_ssv_crossings(codes, scores.astype(np.float32))
    assert sorted(zip(rows.tolist(), pos.tolist())) == sorted(
        zip(res.hit_rows.tolist(), res.hit_positions.tolist()))
    assert (sc >= 256.0).all()


def test_engine_vs_independent_float_oracle_containment():
    """The containment rung against the NON-circular oracle: engine hits
    inside float-oracle windows and vice versa, with the residual
    disagreement bounded and explained by the quantization report
    (the hmmerValidation + hmmerSsvRef pairing,
    `test/hmmerValidation/hmmerValidation.cpp:77-132`)."""
    from havac.validation import float_ssv_windows

    engine = run_engine()
    hits = engine_hits_for_comparison(engine)
    assert hits
    windows = float_ssv_windows(engine.database, engine.models,
                                engine.p_value)
    assert windows, "planted fixture must cross the float threshold"
    report = compare_containment(hits, windows, slack=2)
    # int8 rounding can move borderline chains across the threshold in
    # either direction; the planted instances are far above it, so
    # bidirectional recall must stay high.
    assert report.hit_recall >= 0.9, report.uncontained_hits[:10]
    assert report.window_recall >= 0.9, report.uncovered_windows[:10]
    # Quantify the residue: windows re-scored int8-vs-float must agree on
    # nearly all windows (the quantization report is the explanation for
    # any non-1.0 recall above).
    db = engine.database
    for mi, model in enumerate(engine.models):
        wins = [w for w in windows
                if (w.query_accession or w.query_name)
                == (model.accession or model.name)]
        if not wins:
            continue
        segs = []
        for w in wins:
            si = db.names.index(w.target_name)
            s = int(db.starts[si])
            segs.append(db.codes[s + w.seq_lo - 1:s + w.seq_hi])
        rep = quantization_report(segs, model, p_value=engine.p_value)
        assert rep.disagreement_rate <= 0.1, rep
        # Float windows exist because float crossed 256; int8 should pass
        # at the relaxed 250 threshold on nearly all of them.
        assert rep.int8_pass_250 >= int(0.9 * rep.num_windows), rep


def test_validate_cli_with_float_oracle(tmp_path, capsys):
    """`validate` without --tblout runs against the independent oracle."""
    import json

    from havac.engine.cli import main
    from havac.io.hmm import write_hmm

    models, records = generate_planted_fixture(
        seed=31, model_length=48, sequence_length=4000, num_models=2)
    hmm = str(tmp_path / "m.hmm")
    fasta = str(tmp_path / "db.fasta")
    write_hmm(models, hmm)
    with open(fasta, "w") as f:
        f.write("".join(f">{n}\n{s}\n" for n, s in records))
    rc = main(["validate", "--hmm", hmm, "--fasta", fasta,
               "--backend", "xla", "--pvalue", "0.05",
               "--slack", "2", "--min-recall", "0.9"])
    out = json.loads(capsys.readouterr().out)
    assert rc == 0, out
    assert out["num_nhmmer_windows"] > 0
    assert out["hit_recall"] >= 0.9 and out["window_recall"] >= 0.9
