"""End-to-end check that the engine runs on one NVIDIA GPU.

    python chip_smoke.py             # phases 1 and 2 on one GPU
    python chip_smoke.py --mesh 4    # only phase 3, on four GPUs

Phase 1 — the kernel at real widths. Compiles the GPU kernel at the engine's
chunk shape (2^24 symbols × 8160 rows) and prints its memory analysis;
compares its hits, final row state and final carry exactly with the plain
XLA scan at 2^24 symbols (960 rows for nucleotides, with and without chained
inputs; 96 rows for amino acids) and with the numpy oracle at a small size;
times the kernel and the XLA scan at 2^24 × 960; runs the tests marked
``gpu``.

Phase 2 — the main path at full scale. The reference benchmark's workload
(150,043 model positions against a 50.8 Mb sequence, uniform composition,
p = 0.02, forward strand, from ``tools/runtime_table.synthetic_workload``)
through ``Havac``: load_phmm → load_sequence → warmup → run → hits, once cold
and once warm. Checks a seeded sample of 100,000 raw hits by bounded re-SSV
and that the engine's hits in the first 2^24 symbols × 960 rows equal
phase 1's XLA scan of that rectangle. Then ``python -m havac.engine.cli
search --backend gpu`` on a planted fixture must write exactly the hits of
the library run and of the numpy oracle.

Phase 3 (``--mesh 4``) — the sequence-sharded path. The same workload cut to
10,122 model positions, scanned on a 4-way sequence mesh and on one GPU in
the same process; the hits must be identical.

Runs in one process (a JAX process reserves most of a GPU's memory). Any
failed check raises, so the exit code is non-zero and no result is printed.
The last line of a passing run is one JSON object naming the device.
"""

from __future__ import annotations

import argparse
import json
import os
import sys
import time

import numpy as np

SEQ_LEN = 50_818_468  # the reference benchmark's chromosome (chr22)
MODEL_POSITIONS = 150_043  # its largest model collection
MESH_MODEL_POSITIONS = 10_122
CHUNK = 1 << 24  # the engine's default chunk_symbols
CHUNK_ROWS = 8160  # the engine's default chunk_rows
SLICE_ROWS = 960
SAMPLE_HITS = 100_000


# ---------------------------------------------------------------- helpers


def sorted_pairs(rows, pos):
    """(rows, positions) as int64, sorted by (row, position)."""
    rows = np.asarray(rows, dtype=np.int64)
    pos = np.asarray(pos, dtype=np.int64)
    order = np.lexsort((pos, rows))
    return rows[order], pos[order]


def kernel_pairs(rrow, rpos, count, cap):
    """The valid, sorted records of one ``ssv_gpu_scan`` call."""
    n = int(count)
    if n > cap:
        raise AssertionError(f"{n} hits overflow the {cap}-record buffer")
    return sorted_pairs(np.asarray(rrow)[:n], np.asarray(rpos)[:n])


def same_pairs(a, b) -> bool:
    return (a[0].shape == b[0].shape and np.array_equal(a[0], b[0])
            and np.array_equal(a[1], b[1]))


def rect_pairs(rows, pos, n_rows, n_pos):
    """Sorted hits inside the rectangle rows < n_rows, positions < n_pos."""
    rows = np.asarray(rows)
    pos = np.asarray(pos)
    keep = (rows < n_rows) & (pos < n_pos)
    return sorted_pairs(rows[keep], pos[keep])


def compare_scans(kernel_out, xla_out, cap, rows_per_strip=32):
    """Exact comparison of one kernel call with one XLA scan of the same
    chunk: {"hits", "state", "carry"} booleans and both hit counts."""
    from havac.hits.decode import decode_dense_bitmaps

    rrow, rpos, count, kstate, kcarry = kernel_out
    bitmaps, xstate, xcarry = xla_out
    got = kernel_pairs(rrow, rpos, count, cap)
    want = sorted_pairs(*decode_dense_bitmaps(np.asarray(bitmaps),
                                              rows_per_strip))
    return {
        "hits": same_pairs(got, want),
        "state": bool(np.array_equal(np.asarray(kstate),
                                     np.asarray(xstate))),
        "carry": bool(np.array_equal(np.asarray(kcarry),
                                     np.asarray(xcarry))),
        "n_kernel": int(got[0].size), "n_xla": int(want[0].size),
    }


def require(ok: bool, what: str) -> None:
    if not ok:
        raise AssertionError(f"check failed: {what}")


def emit(**kv) -> None:
    print(json.dumps(kv), flush=True)


def _timed(fn, reps=3):
    import jax

    jax.block_until_ready(fn())
    times = []
    for _ in range(reps):
        t0 = time.perf_counter()
        jax.block_until_ready(fn())
        times.append(time.perf_counter() - t0)
    return times


def _workload(model_positions):
    sys.path.insert(0, os.path.join(os.path.dirname(
        os.path.abspath(__file__)), "tools"))
    from runtime_table import synthetic_workload

    from havac.io.fasta import SequenceDatabase

    models, seq = synthetic_workload(model_positions, SEQ_LEN)
    db = SequenceDatabase(codes=seq, starts=np.array([0, len(seq) + 1]),
                          lengths=np.array([len(seq)]), names=["synth-chr"],
                          seed=0)
    return models, seq, db


# ------------------------------------------------------------------ phases


def phase_kernel(seq, scores, card):
    """Phase 1; returns the XLA scan's hits in the CHUNK × SLICE_ROWS
    rectangle at zero boundary state."""
    import jax
    import jax.numpy as jnp

    from havac.ops.reference import ssv_reference
    from havac.ops.ssv_gpu import ssv_gpu, ssv_gpu_scan
    from havac.ops.ssv_xla import ssv_scan_xla

    cap = 1 << 21
    spec = (jax.ShapeDtypeStruct((CHUNK,), jnp.uint8),
            jax.ShapeDtypeStruct((CHUNK_ROWS, 4), jnp.int8),
            jax.ShapeDtypeStruct((CHUNK,), jnp.int32),
            jax.ShapeDtypeStruct((CHUNK_ROWS + 1,), jnp.int32))
    t0 = time.perf_counter()
    compiled = ssv_gpu_scan.lower(*spec, cap=cap).compile()
    emit(phase=1, what="compile", shape=[CHUNK, CHUNK_ROWS],
         seconds=time.perf_counter() - t0,
         memory_analysis=str(compiled.memory_analysis()))
    del compiled

    rng = np.random.default_rng(20)
    sym = jnp.asarray(seq[:CHUNK])
    zeros = jnp.zeros(CHUNK, jnp.int32)
    rect = None
    with jax.default_matmul_precision("highest"):
        for label, P, chained in (("dna", SLICE_ROWS, False),
                                  ("dna-chained", 96, True),
                                  ("amino-chained", 96, True)):
            if label.startswith("amino"):
                s = jnp.asarray(rng.integers(0, 20, CHUNK).astype(np.uint8))
                sc = rng.integers(-60, 30, (P, 20)).astype(np.int8)
            else:
                s, sc = sym, np.asarray(scores[:P])
            ist = (jnp.asarray(rng.integers(0, 256, CHUNK).astype(np.int32))
                   if chained else zeros)
            ic = jnp.asarray(rng.integers(0, 256, P + 1).astype(np.int32)
                             if chained else np.zeros(P + 1, np.int32))
            args = (s, jnp.asarray(sc), ist, ic)
            kout = jax.block_until_ready(ssv_gpu_scan(*args, cap=cap))
            xout = jax.block_until_ready(ssv_scan_xla(*args))
            res = compare_scans(kout, xout, cap)
            emit(phase=1, what="kernel vs XLA", case=label, L=CHUNK, P=P,
                 **res)
            require(res["hits"] and res["state"] and res["carry"],
                    f"kernel == XLA scan ({label})")
            if label == "dna":
                from havac.hits.decode import decode_dense_bitmaps

                rect = sorted_pairs(*decode_dense_bitmaps(
                    np.asarray(xout[0]), 32))
                tk = _timed(lambda: ssv_gpu_scan(*args, cap=cap))
                tx = _timed(lambda: ssv_scan_xla(*args))
                emit(phase=1, what="time", L=CHUNK, P=P, kernel_s=tk,
                     xla_s=tx, kernel_gcups=CHUNK * P / min(tk) / 1e9,
                     xla_gcups=CHUNK * P / min(tx) / 1e9)
            del kout, xout

    for card, L, P in ((4, 20011, 64), (20, 5003, 45)):
        sym_s = rng.integers(0, card, L).astype(np.uint8)
        sc = rng.integers(-60 if card == 20 else -40, 100,
                          (P, card)).astype(np.int8)
        ist = rng.integers(0, 256, L).astype(np.int32)
        ic = rng.integers(0, 256, P + 1).astype(np.int32)
        reset = rng.random(P) < 0.1
        want, _ = ssv_reference(sym_s, sc, ist, ic, reset_rows=reset)
        r, p, fs, fc = ssv_gpu(sym_s, sc, ist, ic, reset, max_hits=1 << 22)
        ok = (same_pairs((r, p), (want.hit_rows, want.hit_positions))
              and np.array_equal(fs, want.final_row_state)
              and np.array_equal(fc, want.final_carry))
        emit(phase=1, what="kernel vs numpy oracle", card=card, L=L, P=P,
             hits=int(r.size), exact=bool(ok))
        require(ok, f"kernel == ssv_reference (card {card})")

    import pytest

    os.environ["HAVAC_TEST_GPU"] = "1"
    here = os.path.dirname(os.path.abspath(__file__))
    rc = pytest.main(["-q", "-m", "gpu", "-p", "no:cacheprovider",
                      os.path.join(here, "tests", "test_gpu_kernel.py")])
    emit(phase=1, what="pytest -m gpu", exit_code=int(rc))
    require(rc == 0, "gpu-marked tests pass")
    return rect


def phase_engine(models, seq, db, rect, card):
    """Phase 2: the reference benchmark through Havac, cold then warm."""
    from havac.engine import Havac
    from havac.hits.verify import verify_hits

    counts = []
    for kind in ("cold", "warm"):
        t0 = time.perf_counter()
        eng = Havac(p_value=0.02, backend="gpu")
        eng.load_phmm(models).load_sequence(db)
        t1 = time.perf_counter()
        eng.warmup()
        t2 = time.perf_counter()
        eng.run()
        t3 = time.perf_counter()
        hits = eng.hits()
        t4 = time.perf_counter()
        counts.append(eng.stats.num_raw_hits)
        emit(phase=2, what=kind, card=card,
             model_positions=int(eng.scores.shape[0]),
             sequence_length=int(seq.size), load_s=t1 - t0,
             warmup_s=t2 - t1, run_s=t3 - t2, hits_s=t4 - t3,
             wall_s=t4 - t0, raw_hits=eng.stats.num_raw_hits,
             resolved_hits=len(hits), gcups_run=eng.stats.cells / (t3 - t2)
             / 1e9, gcups_wall=eng.stats.cells / (t4 - t0) / 1e9,
             chunks=eng.stats.num_chunks,
             geometry=eng.stats.chunk_geometry,
             overflow_retries=eng.stats.overflow_retries,
             phases=eng.stats.pipeline_prof)
    require(counts[0] == counts[1], "cold and warm runs agree")

    rows, pos = eng.raw_hits()
    rng = np.random.default_rng(2)
    k = min(SAMPLE_HITS, rows.size)
    sample = rng.choice(rows.size, size=k, replace=False)
    t0 = time.perf_counter()
    report = verify_hits(rows[sample], pos[sample], eng.database.codes,
                         eng.scores)
    emit(phase=2, what="bounded re-SSV of sampled hits", sampled=k,
         verified=report.num_verified, seconds=time.perf_counter() - t0)
    require(k >= min(SAMPLE_HITS, rows.size) and report.all_verified,
            "every sampled hit re-derives")
    got = rect_pairs(rows, pos, SLICE_ROWS, CHUNK)
    emit(phase=2, what="slice vs phase-1 XLA scan", rows=SLICE_ROWS,
         positions=CHUNK, engine=int(got[0].size), xla=int(rect[0].size))
    require(same_pairs(got, rect), "engine slice == XLA scan")


def phase_cli(card):
    """Phase 2, last check: the CLI's search on the GPU kernel."""
    import io
    import tempfile

    from havac.engine import Havac
    from havac.engine.cli import _write_hits_tsv, main as cli_main
    from havac.hits.decode import resolve_hits
    from havac.io.hmm import write_hmm
    from havac.ops.reference import ssv_reference
    from havac.testing.generator import generate_planted_fixture

    models, records = generate_planted_fixture(
        seed=5, model_length=120, sequence_length=400_000, num_models=4)
    with tempfile.TemporaryDirectory() as d:
        hmm, fasta, out = (os.path.join(d, n) for n in
                           ("m.hmm", "db.fasta", "hits.tsv"))
        write_hmm(models, hmm)
        with open(fasta, "w") as f:
            f.write("".join(f">{n}\n{s}\n" for n, s in records))
        t0 = time.perf_counter()
        rc = cli_main(["search", "--hmm", hmm, "--fasta", fasta,
                       "--backend", "gpu", "--pvalue", "0.02", "--out", out])
        cli_s = time.perf_counter() - t0
        with open(out) as f:
            cli_tsv = f.read()
        eng = Havac(p_value=0.02, backend="gpu")
        eng.load_phmm(hmm).load_sequence(fasta).run()
        lib = io.StringIO()
        _write_hits_tsv(eng, eng.hits(), lib)
        want, _ = ssv_reference(eng.database.codes, eng.scores)
        oracle = io.StringIO()
        _write_hits_tsv(eng, resolve_hits(want.hit_rows, want.hit_positions,
                                          eng.database, eng.phmm_prefix),
                        oracle)
    n_hits = cli_tsv.count("\n") - 1
    emit(phase=2, what="cli search --backend gpu", card=card, exit_code=rc,
         hits=n_hits, seconds=cli_s)
    require(rc == 0 and n_hits > 0, "the CLI search finds hits")
    require(cli_tsv == lib.getvalue() == oracle.getvalue(),
            "CLI hits == library hits == oracle hits")


def phase_mesh(n, card):
    """Phase 3: n-way sequence mesh vs one GPU, same process."""
    import jax
    from jax.sharding import Mesh

    from havac.engine import Havac

    devs = jax.devices()
    require(len(devs) >= n, f"{n} GPUs visible (found {len(devs)})")
    models, seq, db = _workload(MESH_MODEL_POSITIONS)
    results = {}
    for label, kw in (("mesh", {"mesh": Mesh(np.array(devs[:n]), ("seq",))}),
                      ("single", {})):
        for kind in ("cold", "warm"):
            eng = Havac(p_value=0.02, backend="gpu", **kw)
            eng.load_phmm(models).load_sequence(db)
            t0 = time.perf_counter()
            eng.run()
            t1 = time.perf_counter()
            rows, pos = eng.raw_hits()
            emit(phase=3, what=f"{label} {kind}", card=card, devices=(
                n if label == "mesh" else 1), run_s=t1 - t0,
                raw_hits=int(rows.size),
                gcups=eng.stats.cells / (t1 - t0) / 1e9,
                phases=eng.stats.pipeline_prof)
        results[label] = sorted_pairs(rows, pos)
    require(results["mesh"][0].size > 0, "the mesh run finds hits")
    require(same_pairs(results["mesh"], results["single"]),
            "mesh hits == single-GPU hits")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--mesh", type=int, default=0, metavar="N",
                    help="run only the N-GPU sequence-mesh phase")
    args = ap.parse_args(argv)

    from havac.utils.compile_cache import enable_compile_cache

    cache = enable_compile_cache()
    cache_files = (len(os.listdir(cache)) if os.path.isdir(cache) else 0)
    from havac.utils.device import card_line, require_gpu

    device = require_gpu()
    import jax

    card = card_line()
    print(card, flush=True)
    print(f"jax {jax.__version__}; compile cache {cache} "
          f"({cache_files} entries at start)", flush=True)
    t_start = time.perf_counter()
    if args.mesh:
        require(args.mesh > 1, "--mesh needs at least 2 GPUs")
        phase_mesh(args.mesh, card)
    else:
        from havac.scoring.reprojection import project_models

        t0 = time.perf_counter()
        models, seq, db = _workload(MODEL_POSITIONS)
        scores = project_models(models, 0.02)
        emit(phase=0, what="workload", model_positions=int(scores.shape[0]),
             sequence_length=int(seq.size),
             seconds=time.perf_counter() - t0)
        rect = phase_kernel(seq, scores, card)
        phase_engine(models, seq, db, rect, card)
        phase_cli(card)
    cache_end = (len(os.listdir(cache)) if os.path.isdir(cache) else 0)
    print(f"compile cache {cache}: {cache_end} entries at end; "
          f"{time.perf_counter() - t_start:.1f} s", flush=True)
    print(card, flush=True)
    print(json.dumps({"ok": True, "device": device}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
