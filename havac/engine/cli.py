"""Command-line interface: search and benchmark.

The replacement for the reference's CLI executables —
`benchmark/benchmark.cpp` (phase-timed end-to-end run) and the ad-hoc test
mains. One binary, two subcommands:

  python -m havac.engine.cli search --hmm models.hmm --fasta db.fasta \
      --pvalue 0.02 --out hits.tsv
  python -m havac.engine.cli benchmark --hmm models.hmm --fasta db.fasta

``search`` writes a TSV of resolved hits (sequence name, position, model
name/accession, model position), mirroring `HavacHit` fields
(`host/Havac.hpp:28-40`). ``benchmark`` prints the four reference phase
timings (construction / data load / sweep / hit retrieval,
`benchmark/benchmark.cpp:43-71`) plus GCUPS.
"""

from __future__ import annotations

import argparse
import json
import sys
import time


BACKEND_CHOICES = ["auto", "gpu", "gpu_interpret", "xla"]
BACKEND_HELP = ("scan backend (auto: the GPU kernel on a GPU, the XLA "
                "reference on the CPU; gpu fails without a GPU)")


def _add_common(p: argparse.ArgumentParser) -> None:
    p.add_argument("--hmm", required=True, help="HMMER3 .hmm model collection")
    p.add_argument("--fasta", required=True, help="multi-FASTA sequence database")
    p.add_argument("--pvalue", type=float, default=0.02,
                   help="hit p-value threshold (default 0.02, README.md:39)")
    p.add_argument("--backend", default="auto", choices=BACKEND_CHOICES,
                   help=BACKEND_HELP)
    p.add_argument("--chunk-symbols", type=int, default=1 << 24,
                   help="sequence positions per kernel dispatch")
    p.add_argument("--chunk-rows", type=int, default=8160,
                   help="model rows per kernel dispatch")
    p.add_argument("--isolate-models", action="store_true",
                   help="reset DP chains at model boundaries (the reference's "
                        "concatenated stream lets chains cross models)")
    p.add_argument("--strand", default="forward",
                   choices=["forward", "both"],
                   help="scan the forward strand only (reference/--watson "
                        "behavior) or both strands")
    p.add_argument("--verify", action="store_true",
                   help="re-derive every raw hit by bounded re-SSV after the "
                        "sweep and fail if any is not reproduced "
                        "(HitVerifier analog)")
    p.add_argument("--trace", metavar="DIR", default=None,
                   help="write a JAX profiler trace of the sweep to DIR "
                        "(view with xprof/tensorboard)")
    p.add_argument("--verbose", "-v", action="store_true",
                   help="log engine phases to stderr")


def _build_engine(args):
    from havac.engine.api import Havac

    if getattr(args, "verbose", False):
        import logging

        logging.basicConfig(level=logging.INFO,
                            format="%(asctime)s %(name)s %(message)s")
    return Havac(p_value=args.pvalue, backend=args.backend,
                 chunk_symbols=args.chunk_symbols, chunk_rows=args.chunk_rows,
                 strand=getattr(args, "strand", "forward"),
                 isolate_models=getattr(args, "isolate_models", False),
                 verify_hits=getattr(args, "verify", False))


class _MaybeTrace:
    """jax.profiler.trace(dir) when requested, else a no-op context."""

    def __init__(self, trace_dir):
        self.trace_dir = trace_dir

    def __enter__(self):
        if self.trace_dir:
            import jax

            self._ctx = jax.profiler.trace(self.trace_dir)
            self._ctx.__enter__()
        return self

    def __exit__(self, *exc):
        if self.trace_dir:
            self._ctx.__exit__(*exc)
        return False


def _write_hits_tsv(engine, hits, out) -> None:
    out.write("#sequence\tseq_position\tmodel\tmodel_position\tstrand\n")
    names = engine.database.names
    models = engine.models
    for si, sp, mi, mp, st in hits.as_tuples_stranded():
        label = models[mi].accession or models[mi].name
        out.write(f"{names[si]}\t{sp}\t{label}\t{mp}\t{st}\n")


def cmd_search(args) -> int:
    engine = _build_engine(args)
    engine.load_phmm(args.hmm)
    engine.load_sequence(args.fasta)
    with _MaybeTrace(args.trace):
        engine.run()
    hits = engine.hits()

    out = open(args.out, "w") if args.out != "-" else sys.stdout
    try:
        _write_hits_tsv(engine, hits, out)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"{len(hits)} hits "
          f"({engine.stats.num_raw_hits} raw, "
          f"{engine.stats.gcups:.1f} GCUPS sweep)", file=sys.stderr)
    return 0


def cmd_benchmark(args) -> int:
    t0 = time.perf_counter()
    engine = _build_engine(args)
    t_build = time.perf_counter() - t0

    t0 = time.perf_counter()
    engine.load_phmm(args.hmm)
    engine.load_sequence(args.fasta)
    t_load = time.perf_counter() - t0

    t0 = time.perf_counter()
    with _MaybeTrace(args.trace):
        engine.run()
    t_run = time.perf_counter() - t0

    t0 = time.perf_counter()
    hits = engine.hits()
    t_hits = time.perf_counter() - t0

    report = {
        "phase_seconds": {
            "construction": round(t_build, 4),
            "data_load": round(t_load, 4),
            "sweep": round(t_run, 4),
            "hit_retrieval": round(t_hits, 4),
            "total": round(t_build + t_load + t_run + t_hits, 4),
        },
        "cells": engine.stats.cells,
        "sweep_gcups": round(engine.stats.gcups, 2),
        "end_to_end_gcups": round(
            engine.stats.cells / max(t_build + t_load + t_run + t_hits, 1e-9)
            / 1e9, 2),
        "num_hits": len(hits),
        "num_raw_hits": engine.stats.num_raw_hits,
        "num_chunks": engine.stats.num_chunks,
        "backend": engine.backend,
    }
    if args.verify:
        report["verified_hits"] = engine.verification.num_verified
        report["unverified_hits"] = engine.stats.num_unverified
    print(json.dumps(report, indent=2))
    return 0


def cmd_validate(args) -> int:
    """Compare engine hits against nhmmer windows — the hmmerValidation
    executable analog (`test/hmmerValidation`). Windows come from a real
    nhmmer ``--tblout`` file when one is given, otherwise from the
    independent float-space SSV oracle (``validation/ssv_filter.py``, the
    quantization-free scoring the reference's forensics tool second-sources
    with, `test/hmmerSsvRef/hmmerSsvRef.cpp:166-325`) computed on the same
    inputs — a non-circular cross-check that needs no HMMER install."""
    from havac.validation import (compare_containment,
                                      engine_hits_for_comparison, load_tblout)

    if not args.tblout and args.oracle != "float-ssv":
        print("validate: provide --tblout or --oracle float-ssv",
              file=sys.stderr)
        return 2
    engine = _build_engine(args)
    engine.load_phmm(args.hmm)
    engine.load_sequence(args.fasta)
    with _MaybeTrace(args.trace):
        engine.run()
    hits = engine_hits_for_comparison(engine)
    if args.tblout:
        windows = load_tblout(args.tblout)
    else:
        from havac.validation.ssv_filter import float_ssv_windows

        windows = float_ssv_windows(engine.database, engine.models,
                                    engine.p_value)
    # Forward-only runs compare against '+' windows only (nhmmer --watson
    # behavior); strand="both" runs keep '-' windows, matched by strand.
    report = compare_containment(hits, windows, slack=args.slack,
                                 watson_only=(engine.strand == "forward"))
    out = {
        "num_engine_hits": report.num_hits,
        "num_nhmmer_windows": report.num_windows,
        "hit_recall": round(report.hit_recall, 6),
        "window_recall": round(report.window_recall, 6),
        "uncontained_hits": len(report.uncontained_hits),
        "uncovered_windows": len(report.uncovered_windows),
    }
    if args.show_disagreements:
        out["uncontained_hit_list"] = report.uncontained_hits[:100]
        out["uncovered_window_list"] = [
            (w.target_name, w.query_name, w.seq_lo, w.seq_hi)
            for w in report.uncovered_windows[:100]]
    print(json.dumps(out, indent=2))
    return 0 if (report.hit_recall >= args.min_recall
                 and report.window_recall >= args.min_recall) else 1


def cmd_scan(args) -> int:
    """Streaming multi-file scan with prefetch (`Havac.scan_files`)."""
    engine = _build_engine(args)
    engine.load_phmm(args.hmm)
    out = open(args.out, "w") if args.out != "-" else sys.stdout
    try:
        out.write("#file\tsequence\tseq_position\tmodel\tmodel_position"
                  "\tstrand\n")
        total = 0
        with _MaybeTrace(args.trace):
            for path, hits in engine.scan_files(args.fastas,
                                                prefetch=args.prefetch):
                names = engine.database.names
                models = engine.models
                for si, sp, mi, mp, st in hits.as_tuples_stranded():
                    label = models[mi].accession or models[mi].name
                    out.write(f"{path}\t{names[si]}\t{sp}\t{label}\t{mp}"
                              f"\t{st}\n")
                total += len(hits)
                print(f"{path}: {len(hits)} hits", file=sys.stderr)
    finally:
        if out is not sys.stdout:
            out.close()
    print(f"{total} hits across {len(args.fastas)} files", file=sys.stderr)
    return 0


def cmd_serve(args) -> int:
    """Warm-process server: scan FASTA databases on request.

    Reads one request per line from stdin — ``PATH`` or ``PATH<TAB>OUT.tsv``
    (default out: ``PATH.hits.tsv``) — and answers each with a JSON status
    line on stdout. The engine persists across requests, so every request
    after the first runs fully warm: the pipeline pads all chunks to one
    shape, so databases of ANY length share the same compiled executables
    and the compile cost of a cold process is paid once (the reference has
    no analog — its ~6 s xclbin load repeats per process,
    `benchmark/runtime_table.py:8`)."""
    import os

    engine = _build_engine(args)
    engine.load_phmm(args.hmm)
    print(json.dumps({"ready": True, "models": len(engine.models)}),
          flush=True)
    for line in sys.stdin:
        line = line.strip()
        if not line:
            continue  # stray blank lines must not kill a warm server
        if line == "quit":
            break
        path, _, out_path = line.partition("\t")
        out_path = out_path or (path + ".hits.tsv")
        t0 = time.perf_counter()
        try:
            engine.load_sequence(path)
            engine.run()
            hits = engine.hits()
            with open(out_path, "w") as out:
                _write_hits_tsv(engine, hits, out)
            print(json.dumps({
                "file": path, "out": out_path, "hits": len(hits),
                "raw_hits": engine.stats.num_raw_hits,
                "seconds": round(time.perf_counter() - t0, 3),
                "gcups_sweep": round(engine.stats.gcups, 1),
            }), flush=True)
        except Exception as exc:  # noqa: BLE001 — a bad request must not
            # take down the warm server (and its compiled state) with it.
            print(json.dumps({"file": path, "error": str(exc)[:500]}),
                  flush=True)
    return 0


def cmd_quantize(args) -> int:
    """Quantization forensics: rescore nhmmer windows with int8 vs float
    projections — the hmmerSsvRef executable analog (`test/hmmerSsvRef`)."""
    import numpy as np

    from havac.io.fasta import load_fasta_database
    from havac.io.hmm import read_hmm
    from havac.validation import load_tblout, quantization_report

    models = read_hmm(args.hmm)
    db = load_fasta_database(args.fasta)
    windows_by_model = {}
    name_to_seq = {n: i for i, n in enumerate(db.names)}
    for w in load_tblout(args.tblout):
        label = w.query_accession or w.query_name
        si = name_to_seq.get(w.target_name)
        if si is None:
            continue
        s = int(db.starts[si])
        lo = s + max(0, w.seq_lo - 1)
        hi = s + min(int(db.lengths[si]), w.seq_hi)
        windows_by_model.setdefault(label, []).append(db.codes[lo:hi])

    out = {}
    for m in models:
        label = m.accession or m.name
        windows = windows_by_model.get(label, [])
        if not windows:
            continue
        rep = quantization_report(windows, m, args.pvalue)
        out[label] = {
            "num_windows": rep.num_windows,
            "int8_pass_256": rep.int8_pass_256,
            "int8_pass_250": rep.int8_pass_250,
            "float_pass_256": rep.float_pass_256,
            "disagreement_rate": round(rep.disagreement_rate, 6),
        }
    print(json.dumps(out, indent=2))
    return 0


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(
        prog="havac", description="SSV homology search")
    sub = parser.add_subparsers(dest="command", required=True)

    p_search = sub.add_parser("search", help="scan a FASTA db against models")
    _add_common(p_search)
    p_search.add_argument("--out", default="-",
                          help="output TSV path (default stdout)")
    p_search.set_defaults(fn=cmd_search)

    p_bench = sub.add_parser("benchmark", help="phase-timed end-to-end run")
    _add_common(p_bench)
    p_bench.set_defaults(fn=cmd_benchmark)

    p_val = sub.add_parser(
        "validate", help="containment comparison vs nhmmer --tblout output "
        "or the independent float-SSV oracle")
    _add_common(p_val)
    p_val.add_argument("--tblout", default=None,
                       help="nhmmer --tblout file for the same hmm/fasta "
                       "(omit to validate against --oracle float-ssv)")
    p_val.add_argument("--oracle", default="float-ssv",
                       choices=["float-ssv"],
                       help="window source when no --tblout is given: the "
                       "independent quantization-free SSV oracle")
    p_val.add_argument("--slack", type=int, default=0,
                       help="window-edge tolerance in positions")
    p_val.add_argument("--min-recall", type=float, default=0.98,
                       help="exit nonzero if either recall falls below this")
    p_val.add_argument("--show-disagreements", action="store_true")
    p_val.set_defaults(fn=cmd_validate)

    p_q = sub.add_parser(
        "quantize",
        help="int8-vs-float rescoring of nhmmer windows (hmmerSsvRef analog)")
    _add_common(p_q)
    p_q.add_argument("--tblout", required=True,
                     help="nhmmer --tblout windows to rescore")
    p_q.set_defaults(fn=cmd_quantize)

    p_scan = sub.add_parser(
        "scan", help="streaming scan over many FASTA files with prefetch")
    p_scan.add_argument("--hmm", required=True)
    p_scan.add_argument("fastas", nargs="+", help="FASTA files to scan")
    p_scan.add_argument("--pvalue", type=float, default=0.02)
    p_scan.add_argument("--backend", default="auto", choices=BACKEND_CHOICES,
                        help=BACKEND_HELP)
    p_scan.add_argument("--chunk-symbols", type=int, default=1 << 24)
    p_scan.add_argument("--chunk-rows", type=int, default=8160)
    p_scan.add_argument("--strand", default="forward",
                        choices=["forward", "both"])
    p_scan.add_argument("--isolate-models", action="store_true")
    p_scan.add_argument("--verify", action="store_true")
    p_scan.add_argument("--prefetch", type=int, default=1)
    p_scan.add_argument("--trace", default=None)
    p_scan.add_argument("--verbose", "-v", action="store_true")
    p_scan.add_argument("--out", default="-")
    p_scan.set_defaults(fn=cmd_scan)

    p_serve = sub.add_parser(
        "serve",
        help="warm-process server: FASTA paths on stdin, JSON status per "
             "request (every request after the first runs fully warm)")
    p_serve.add_argument("--hmm", required=True)
    p_serve.add_argument("--pvalue", type=float, default=0.02)
    p_serve.add_argument("--backend", default="auto",
                         choices=BACKEND_CHOICES, help=BACKEND_HELP)
    p_serve.add_argument("--chunk-symbols", type=int, default=1 << 24)
    p_serve.add_argument("--chunk-rows", type=int, default=8160)
    p_serve.add_argument("--strand", default="forward",
                         choices=["forward", "both"])
    p_serve.add_argument("--isolate-models", action="store_true")
    p_serve.add_argument("--verify", action="store_true")
    p_serve.add_argument("--verbose", "-v", action="store_true")
    p_serve.set_defaults(fn=cmd_serve)

    args = parser.parse_args(argv)
    return args.fn(args)


if __name__ == "__main__":
    sys.exit(main())
