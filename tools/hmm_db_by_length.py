"""Slice a .hmm collection into cumulative-length databases.

The analog of the reference's benchmark DB generator
(`benchmark/hmmDbByLength.py:7-54`), which cuts an Rfam-scale .hmm file into
databases of ~{1k, 5k, ..., 150k} total model positions for the runtime
scaling sweep. Ours reuses the io layer instead of splitting on raw
``HMMER3/f`` header lines.

Usage:
  python tools/hmm_db_by_length.py Rfam.hmm outdir --lengths 1000 5000 10000
"""

import argparse
import os
import sys

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))


def main() -> int:
    from havac.io.hmm import read_hmm, write_hmm

    ap = argparse.ArgumentParser()
    ap.add_argument("hmm", help="input .hmm collection")
    ap.add_argument("outdir")
    ap.add_argument("--lengths", type=int, nargs="+",
                    default=[1000, 5000, 10000, 20000, 30000, 40000, 50000,
                             60000, 70000, 80000, 90000, 100000, 150000])
    args = ap.parse_args()

    models = read_hmm(args.hmm)
    os.makedirs(args.outdir, exist_ok=True)
    cum = 0
    cut_points = sorted(args.lengths)
    selected = []
    ci = 0
    for m in models:
        cum += m.model_length
        selected.append(m)
        while ci < len(cut_points) and cum >= cut_points[ci]:
            out = os.path.join(args.outdir, f"db_{cut_points[ci]}.hmm")
            write_hmm(selected, out)
            print(f"{out}: {len(selected)} models, {cum} positions")
            ci += 1
    if ci < len(cut_points):
        print(f"collection exhausted at {cum} positions; "
              f"{len(cut_points) - ci} requested sizes unreachable")
    return 0


if __name__ == "__main__":
    sys.exit(main())
