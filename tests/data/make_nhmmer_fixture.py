"""Generate the checked-in nhmmer tblout fixture (deterministic).

nhmmer itself is not available in this environment, so this script creates a
*faithful* `--tblout` file in HMMER 3.x's exact nhmmer column layout
(`target name / accession / query name / accession / hmmfrom / hmm to /
alifrom / ali to / envfrom / env to / sq len / strand / E-value / score /
bias / description`), with the row features the synthesized tests never had:

  * reverse-strand rows (alifrom > alito, strand '-');
  * multiple windows per (model, sequence) pair ("multi-domain");
  * '-' placeholders for missing accessions;
  * free-text descriptions with spaces;
  * the real comment/header block nhmmer prints.

Window contents are grounded in the oracle: each window surrounds an actual
SSV hit of the checked-in models against the checked-in FASTA (forward
strand, and reverse-complement hits mapped to reversed coordinates), so
`validate`/`quantize` runs against this fixture exercise realistic parsing
AND meaningful containment. Rerun this script only to regenerate the
artifacts; tests consume the committed files.
"""

import os
import sys

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), "..", ".."))

from havac.io.fasta import load_fasta_database  # noqa: E402
from havac.io.hmm import write_hmm  # noqa: E402
from havac.ops.reference import ssv_reference  # noqa: E402
from havac.scoring.reprojection import project_models  # noqa: E402
from havac.testing.generator import generate_planted_fixture  # noqa: E402

HERE = os.path.dirname(os.path.abspath(__file__))
P_VALUE = 0.02

HEADER = """\
#                                                                           --- full sequence ---- --- best 1 domain ---- --- domain number estimation ----
# target name            accession  query name           accession  hmmfrom hmm to alifrom  ali to envfrom  env to  sq len strand   E-value  score  bias  description of target
#    ------------------- ---------- -------------------- ---------- ------- ------- ------- ------- ------- ------- ------- ------ --------- ------ ----- ---------------------
"""

FOOTER = """\
#
# Program:         nhmmer
# Version:         3.4 (Aug 2023)
# Pipeline mode:   SEARCH
# Query file:      nhmmer_fixture.hmm
# Target file:     nhmmer_fixture.fasta
# Option settings: nhmmer --tblout nhmmer_fixture.tblout --dna nhmmer_fixture.hmm nhmmer_fixture.fasta
# Current dir:     /tmp
# [ok]
"""

_COMP = {0: 3, 1: 2, 2: 1, 3: 0}


def revcomp_codes(codes):
    return np.array([_COMP[int(c)] for c in codes[::-1]], dtype=np.uint8)


def windows_from_hits(rows, positions, starts, lengths, names, model,
                      model_idx, prefix, strand, rng, pad=25):
    """Cluster oracle hits into nhmmer-style envelope windows (merging hits
    within `pad` of each other, like nhmmer's window merging)."""
    out = []
    lo_r, hi_r = prefix[model_idx], prefix[model_idx + 1]
    sel = (rows >= lo_r) & (rows < hi_r)
    for si in range(len(names)):
        s, ln = int(starts[si]), int(lengths[si])
        psel = sel & (positions >= s) & (positions < s + ln)
        pts = np.unique(positions[psel] - s)
        if pts.size == 0:
            continue
        # merge nearby hit positions into windows
        gaps = np.nonzero(np.diff(pts) > 2 * pad)[0]
        bounds = np.split(pts, gaps + 1)
        for grp in bounds:
            lo = max(1, int(grp.min()) + 1 - pad)
            hi = min(ln, int(grp.max()) + 1 + pad)
            score = round(float(rng.uniform(12, 40)), 1)
            evalue = float(10 ** rng.uniform(-9, -3))
            if strand == "-":
                # nhmmer reports minus-strand coords reversed, on the
                # forward numbering of the target sequence
                out.append((names[si], si, hi, lo, score, evalue))
            else:
                out.append((names[si], si, lo, hi, score, evalue))
    return out


def main():
    rng = np.random.default_rng(0xF1C)
    models, records = generate_planted_fixture(
        seed=1234, model_length=64, sequence_length=6000, num_models=2)
    models[0].name = "RF-like-1"
    models[0].accession = "RF09001"
    models[0].description = "synthetic Rfam-like family one"
    models[1].name = "orphan-2"
    models[1].accession = ""  # '-' accession in tblout
    models[1].description = "orphan model, no accession"

    # The generator returns one concatenated sequence; cut it into two
    # records, then plant one model-0 instance on the REVERSE strand of the
    # second so the fixture has genuine '-' rows.
    (_, whole), = records
    seq0, seq1 = whole[:3000], whole[3000:]
    sym = "acgt"
    m0 = models[0]
    cons = "".join(sym[int(np.argmin(m0.match_scores[i]))]
                   for i in range(m0.model_length))
    comp = {"a": "t", "c": "g", "g": "c", "t": "a"}
    rc = "".join(comp[c] for c in reversed(cons))
    pos_rc = 1500
    seq1 = seq1[:pos_rc] + rc + seq1[pos_rc + len(rc):]
    records = [("chrA", seq0), ("chrB", seq1)]

    hmm_path = os.path.join(HERE, "nhmmer_fixture.hmm")
    fa_path = os.path.join(HERE, "nhmmer_fixture.fasta")
    tbl_path = os.path.join(HERE, "nhmmer_fixture.tblout")
    write_hmm(models, hmm_path)
    with open(fa_path, "w") as f:
        f.write("".join(f">{n} synthetic fixture sequence\n{s}\n"
                        for n, s in records))

    db = load_fasta_database(fa_path, pad_multiple=1024)
    scores = project_models(models, P_VALUE)
    prefix = np.concatenate(
        [[0], np.cumsum([m.model_length for m in models])])

    res_f, _ = ssv_reference(db.codes, scores)
    rows = []
    lengths = db.lengths
    for mi, model in enumerate(models):
        for (nm, si, alo, ahi, sc, ev) in windows_from_hits(
                res_f.hit_rows, res_f.hit_positions, db.starts, lengths,
                db.names, model, mi, prefix, "+", rng):
            rows.append((nm, si, model, alo, ahi, "+", sc, ev))

    # Reverse strand: sweep the reverse complement of each sequence; a hit at
    # rc-position q maps to forward coordinates len-1-q.
    for si in range(db.num_sequences):
        s, ln = int(db.starts[si]), int(db.lengths[si])
        rc_codes = revcomp_codes(db.codes[s:s + ln])
        res_r, _ = ssv_reference(rc_codes, scores)
        for mi, model in enumerate(models):
            lo_r, hi_r = prefix[mi], prefix[mi + 1]
            sel = (res_r.hit_rows >= lo_r) & (res_r.hit_rows < hi_r)
            pts = np.unique(ln - 1 - res_r.hit_positions[sel])
            if pts.size == 0:
                continue
            gaps = np.nonzero(np.diff(pts) > 50)[0]
            for grp in np.split(pts, gaps + 1):
                lo = max(1, int(grp.min()) + 1 - 25)
                hi = min(ln, int(grp.max()) + 1 + 25)
                rows.append((db.names[si], si, model, hi, lo, "-",
                             round(float(rng.uniform(12, 40)), 1),
                             float(10 ** rng.uniform(-9, -3))))

    def hmm_span(model):
        return 1, model.model_length

    with open(tbl_path, "w") as f:
        f.write(HEADER)
        for (nm, si, model, alo, ahi, strand, sc, ev) in rows:
            acc = model.accession or "-"
            hf, ht = hmm_span(model)
            ln = int(db.lengths[si])
            f.write(f"{nm:<22s} {'-':<10s} {model.name:<20s} {acc:<10s} "
                    f"{hf:7d} {ht:7d} {alo:7d} {ahi:7d} {alo:7d} {ahi:7d} "
                    f"{ln:7d} {strand:>6s} {ev:9.2g} {sc:6.1f} {0.0:5.1f}  "
                    f"synthetic fixture sequence\n")
        f.write(FOOTER)
    print(f"wrote {hmm_path}, {fa_path}, {tbl_path}: {len(rows)} windows "
          f"({sum(1 for r in rows if r[5] == '-')} reverse-strand)")


if __name__ == "__main__":
    main()
