"""End-to-end runtime scaling sweep — the reference's headline benchmark.

Reproduces the methodology of `benchmark/runtime_table.py` +
`benchmark/readme.txt`: scan one chromosome-scale FASTA against cumulative
model databases of growing total length, reporting end-to-end seconds per
size. The reference's published curve (Alveo U50): 6.06 s @ 1k model
positions → 14.16 s @ 150k; nhmmer SSV (32 threads): 2.36 s → 434.84 s.

With --synthetic the workload is generated (random 50.8 Mb "chromosome" +
synthetic models), so the sweep runs anywhere; pass real --hmm/--fasta to
benchmark actual data.

Usage:
  python tools/runtime_table.py --synthetic --lengths 1020 5010 10020
  python tools/runtime_table.py --hmm Rfam.hmm --fasta chr22.fa
"""

import argparse
import json
import os
import sys
import time

import numpy as np

sys.path.insert(0, os.path.join(os.path.dirname(__file__), ".."))

REFERENCE_SECONDS = {  # benchmark/runtime_table.py:5-9 (U50 / nhmmer 32T)
    1007: (6.06, 2.36), 5055: (6.31, 8.32), 10122: (6.766, 20.53),
    20039: (6.88, 49.75), 30007: (7.41, 70.72), 50120: (8.02, 101.33),
    100048: (11.61, 281.54), 150043: (14.16, 434.84),
}


def genomic_sequence(rng, seq_len: int, repeat_families) -> np.ndarray:
    """Synthetic chromosome with realistic composition (VERDICT r2 #7):
    GC-varying isochore blocks, interspersed repeat families copied with
    ~15% divergence (the Alu/L1 analog — repeats are what inflate SSV hit
    density on real genomes), and tandem microsatellites. Mirrors the
    compositional structure of the reference benchmark's chr22 workload
    (`benchmark/readme.txt:18-67`) without shipping genome data."""
    seq = np.empty(seq_len, dtype=np.uint8)
    pos = 0
    while pos < seq_len:  # isochores: 50-300 kb blocks, GC 32-58%
        blk = int(rng.integers(50_000, 300_000))
        gc = rng.uniform(0.32, 0.58)
        p = np.array([(1 - gc) / 2, gc / 2, gc / 2, (1 - gc) / 2])
        n = min(blk, seq_len - pos)
        seq[pos:pos + n] = rng.choice(4, size=n, p=p).astype(np.uint8)
        pos += n
    for fam, frac in repeat_families:  # interspersed repeats, diverged
        fam_len = fam.shape[0]
        ncopy = int(seq_len * frac) // fam_len
        starts = rng.integers(0, seq_len - fam_len, size=ncopy)
        for s in starts:
            copy = fam.copy()
            nmut = rng.binomial(fam_len, 0.15)
            idx = rng.integers(0, fam_len, size=nmut)
            copy[idx] = rng.integers(0, 4, size=nmut)
            seq[s:s + fam_len] = copy
    placed = 0
    while placed < int(seq_len * 0.03):  # tandem microsatellites, ~3%
        unit = rng.integers(0, 4, size=int(rng.integers(2, 7))).astype(np.uint8)
        arr = np.tile(unit, int(rng.integers(10, 60)))
        s = int(rng.integers(0, seq_len - arr.shape[0]))
        seq[s:s + arr.shape[0]] = arr
        placed += arr.shape[0]
    return seq


def synthetic_workload(total_positions: int, seq_len: int,
                       composition: str = "uniform"):
    """Models + chromosome. ``composition="genomic"`` builds the sequence
    with GC skew/repeats and derives ~20% of the model positions from the
    repeat families themselves (the nhmmer-vs-Rfam situation: some models
    DO match the genome's repeat content, driving the dense-hit regime)."""
    from havac.testing.generator import model_from_consensus

    rng = np.random.default_rng(7)
    families = [(rng.integers(0, 4, size=300).astype(np.uint8), 0.20),
                (rng.integers(0, 4, size=1500).astype(np.uint8), 0.10)]
    models = []
    cum = 0
    i = 0
    while cum < total_positions:
        length = int(rng.integers(60, 200))
        length = min(length, total_positions - cum) or 1
        if composition == "genomic" and i % 5 == 4:
            # Every fifth model: a window of a repeat family consensus.
            fam = families[i % len(families)][0]
            off = int(rng.integers(0, max(1, fam.shape[0] - length)))
            consensus = fam[off:off + max(length, 8)]
            if consensus.shape[0] < max(length, 8):
                consensus = np.tile(fam, 2)[:max(length, 8)]
        else:
            consensus = rng.integers(0, 4, size=max(length, 8)).astype(np.uint8)
        models.append(model_from_consensus(consensus, name=f"synth-{i}"))
        cum += models[-1].model_length
        i += 1
    if composition == "genomic":
        seq = genomic_sequence(rng, seq_len, families)
    else:
        seq = rng.integers(0, 4, size=seq_len).astype(np.uint8)
    return models, seq


def main() -> int:
    from havac.engine import Havac
    from havac.io.fasta import SequenceDatabase

    ap = argparse.ArgumentParser()
    ap.add_argument("--hmm")
    ap.add_argument("--fasta")
    ap.add_argument("--synthetic", action="store_true")
    ap.add_argument("--seq-len", type=int, default=50_818_468)  # chr22 size
    ap.add_argument("--lengths", type=int, nargs="+",
                    default=[1007, 10122, 50120, 150043])
    ap.add_argument("--pvalue", type=float, default=0.02)
    ap.add_argument("--composition", choices=["uniform", "genomic"],
                    default="uniform",
                    help="synthetic sequence composition: uniform random or "
                    "genomic (GC isochores + diverged repeats + tandems)")
    ap.add_argument("--json", default=None,
                    help="also write the result rows to this JSON file")
    ap.add_argument("--repeat", type=int, default=1,
                    help="runs per size in one process; iteration >0 rows "
                    "are warm (in-process jit cache, no recompilation)")
    ap.add_argument("--allow-fallback", action="store_true",
                    help="record the artifact even when the native host "
                    "core is unavailable (tagged native_active=false); "
                    "without it a numpy-fallback capture hard-fails "
                    "(the round-3 invalid-artifact incident)")
    args = ap.parse_args()

    from havac.utils.device import card_line, require_gpu
    from havac.utils.provenance import provenance

    require_gpu()  # times only ever come from the GPU
    stamp = provenance(require_native=not args.allow_fallback)
    stamp["card"] = card_line()
    print(json.dumps({"provenance": stamp}), flush=True)
    rows = []
    for total in args.lengths:
        for it in range(args.repeat):
            engine = Havac(p_value=args.pvalue, backend="gpu")
            if args.synthetic:
                models, seq = synthetic_workload(total, args.seq_len,
                                                 args.composition)
            t0 = time.perf_counter()
            if args.synthetic:
                engine.load_phmm(models)
                db = SequenceDatabase(
                    codes=seq, starts=np.array([0, len(seq) + 1]),
                    lengths=np.array([len(seq)]), names=["synth-chr"], seed=0)
                engine.load_sequence(db)
            else:
                engine.load_phmm(args.hmm)
                engine.load_sequence(args.fasta)
            t_load = time.perf_counter()
            engine.run()
            t_run = time.perf_counter()
            hits = engine.hits()
            elapsed = time.perf_counter() - t0
            load_s, run_s = t_load - t0, t_run - t_load
            resolve_s = elapsed - (t_run - t0)
            ref = REFERENCE_SECONDS.get(total, (None, None))
            rows.append({
                "model_positions": int(sum(m.model_length
                                           for m in engine.models)),
                "iter": it,
                "seconds": round(elapsed, 3),
                "sweep_seconds": round(engine.stats.sweep_seconds, 3),
                "gcups_e2e": round(engine.stats.cells / elapsed / 1e9, 1),
                "gcups_sweep": round(engine.stats.gcups, 1),
                "num_hits": len(hits),
                "load_s": round(load_s, 3),
                "run_s": round(run_s, 3),
                "resolve_s": round(resolve_s, 3),
                "reference_havac_s": ref[0],
                "reference_nhmmer32_s": ref[1],
            })
            if engine.stats.pipeline_prof:
                rows[-1]["phases"] = {
                    k: round(v, 3)
                    for k, v in engine.stats.pipeline_prof.items()}
            rows[-1]["composition"] = args.composition
            # Per-run provenance: the fields that poisoned the round-3
            # artifact when they silently flipped (VERDICT r3 weak #3).
            rows[-1]["native_active"] = engine.stats.native_active
            rows[-1]["overflow_retries"] = engine.stats.overflow_retries
            if engine.stats.chunk_geometry:
                rows[-1]["chunk_geometry"] = engine.stats.chunk_geometry
            print(json.dumps(rows[-1]), flush=True)
    # Repeat statistics: host-side times vary between runs; artifacts carry
    # min/median over the warm iterations so readers need not re-derive
    # them.
    summary = []
    for total in args.lengths:
        for kind, sel in (("warm", [r for r in rows
                                    if r["model_positions"] == total
                                    and r["iter"] > 0]),
                          ("cold", [r for r in rows
                                    if r["model_positions"] == total
                                    and r["iter"] == 0])):
            if not sel:
                continue
            secs = sorted(r["seconds"] for r in sel)
            summary.append({
                "model_positions": total, "kind": kind, "n": len(secs),
                "min_s": round(secs[0], 3),
                "median_s": round(secs[len(secs) // 2], 3),
                "reference_havac_s": REFERENCE_SECONDS.get(total,
                                                           (None,))[0],
            })
            print(json.dumps(summary[-1]), flush=True)
    if args.json:
        with open(args.json, "w") as f:
            json.dump({"provenance": stamp, "rows": rows,
                       "summary": summary}, f, indent=2)
    return 0


if __name__ == "__main__":
    sys.exit(main())
