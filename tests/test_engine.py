"""End-to-end engine tests: the public API against the golden oracle.

The analog of the reference's on-hardware integration rung
(`host/test/RefernceComparisonTest/ReferenceComparisonTest.cpp:52-176`):
exact hit-for-hit comparison of the full driver path (FASTA → encode →
reproject → sweep → resolve) against the multi-model scalar reference,
plus the abort-path exercise (`:81-86`).
"""

import time

import numpy as np
import pytest

from havac.engine import Havac, HavacRunState, HavacUsageError
from havac.io.fasta import load_fasta_database
from havac.io.hmm import model_length_prefix_sums
from havac.hits.decode import resolve_hits
from havac.ops.common import SsvKernelConfig
from havac.ops.reference import ssv_reference
from havac.scoring.reprojection import project_models
from havac.testing.generator import generate_planted_fixture

P_VALUE = 0.05
CFG = SsvKernelConfig(block_width=1024, rows_per_strip=8)


def fasta_text(records):
    return "".join(f">{name}\n{seq}\n" for name, seq in records)


def oracle_resolved(engine):
    """Run the scalar oracle over the engine's own packed inputs."""
    result, _ = ssv_reference(engine.database.codes, engine.scores)
    return resolve_hits(result.hit_rows, result.hit_positions,
                        engine.database, engine.phmm_prefix)


def assert_hits_equal(a, b):
    assert sorted(a.as_tuples()) == sorted(b.as_tuples())


@pytest.mark.parametrize("backend", ["xla", "gpu_interpret"])
def test_end_to_end_matches_oracle(backend):
    models, records = generate_planted_fixture(
        seed=7, model_length=48, sequence_length=3000, num_models=3)
    engine = Havac(p_value=P_VALUE, config=CFG, backend=backend)
    engine.load_phmm(models)
    engine.load_sequence(load_fasta_database(
        fasta_text(records), pad_multiple=CFG.block_width, is_text=True))
    engine.run()
    got = engine.hits()
    want = oracle_resolved(engine)
    assert len(want) > 0, "fixture must plant hits"
    assert_hits_equal(got, want)
    assert engine.stats.cells > 0 and engine.stats.sweep_seconds > 0


def test_public_verify_after_pipelined_run():
    """engine.verify() must work right after a pipelined run, where raw
    hits are still held as per-chunk parts (regression: it read the
    unmaterialized None arrays and crashed)."""
    models, records = generate_planted_fixture(
        seed=7, model_length=48, sequence_length=3000, num_models=3)
    engine = Havac(p_value=P_VALUE, config=CFG, backend="gpu_interpret")
    engine.load_phmm(models)
    engine.load_sequence(load_fasta_database(
        fasta_text(records), pad_multiple=CFG.block_width, is_text=True))
    engine.run()
    report = engine.verify()  # no raw_hits() call first
    assert report.all_verified and report.num_hits > 0


def test_raw_hits_sorted_on_chunked_serial_path():
    """raw_hits() promises (row, position) order; the serial path's
    chunk-major concatenation must be lazily sorted (regression: the
    _raw_sorted flag stayed True over unsorted data)."""
    models, records = generate_planted_fixture(
        seed=21, model_length=32, sequence_length=8000, num_models=2)
    engine = Havac(p_value=P_VALUE, config=CFG, backend="xla",
                   chunk_symbols=1024, chunk_rows=40)
    engine.load_phmm(models)
    engine.load_sequence(load_fasta_database(
        fasta_text(records), pad_multiple=CFG.block_width, is_text=True))
    engine.run()
    assert engine.stats.num_chunks > 2
    rows, pos = engine.raw_hits()
    key = rows * (int(pos.max(initial=0)) + 1) + pos
    assert np.all(np.diff(key) >= 0)


def test_chunked_run_is_exact():
    """Multiple sequence chunks chained by the boundary carry give the same
    hits as one chunk (score-queue semantics across dispatches)."""
    models, records = generate_planted_fixture(
        seed=11, model_length=40, sequence_length=9000, num_models=2)
    db = load_fasta_database(fasta_text(records), pad_multiple=CFG.block_width,
                             is_text=True)
    small = Havac(p_value=P_VALUE, config=CFG, backend="xla",
                  chunk_symbols=2048)
    small.load_phmm(models).load_sequence(db).run()
    big = Havac(p_value=P_VALUE, config=CFG, backend="xla")
    big.load_phmm(models).load_sequence(db).run()
    assert small.stats.num_chunks > 1
    assert big.stats.num_chunks == 1
    assert_hits_equal(small.hits(), big.hits())
    assert_hits_equal(small.hits(), oracle_resolved(big))


def test_multi_sequence_resolution():
    """Hits resolve to per-sequence local coordinates; separator hits drop."""
    models, records = generate_planted_fixture(
        seed=3, model_length=32, sequence_length=1500, num_models=1)
    seq = records[0][1]
    # split into 3 FASTA records
    recs = [("s0", seq[:500]), ("s1", seq[500:1000]), ("s2", seq[1000:])]
    engine = Havac(p_value=P_VALUE, config=CFG, backend="xla")
    engine.load_phmm(models)
    engine.load_sequence(fasta_text(recs), is_text=True)
    engine.run()
    got = engine.hits()
    want = oracle_resolved(engine)
    assert_hits_equal(got, want)
    for si, sp in zip(got.sequence_index, got.sequence_position):
        assert 0 <= sp < len(recs[si][1])


def test_usage_errors_and_state():
    engine = Havac(config=CFG, backend="xla")
    assert engine.state == HavacRunState.IDLE
    with pytest.raises(HavacUsageError):
        engine.run()
    with pytest.raises(HavacUsageError):
        engine.hits()


def test_alphabet_cardinality_at_load():
    """Amino models (cardinality 20) load (the GPU kernel and the XLA scan
    take any cardinality up to 32; tests/test_amino.py covers exactness); an
    unknown cardinality still fails at load_phmm with a clear usage error,
    not an opaque downstream shape error."""
    from havac.io.hmm import ProfileHmm

    amino = ProfileHmm(
        name="amino-1", model_length=8, max_length=100, alphabet="amino",
        msv_mu=-5.0, msv_lambda=0.7,
        match_scores=np.full((8, 20), 2.0, dtype=np.float32))
    engine = Havac(config=CFG, backend="xla")
    engine.load_phmm(amino)
    assert engine.alphabet == "amino"

    class Stub:  # a cardinality the engine does not support
        name = "weird-1"
        alphabet = "weird"
        alphabet_cardinality = 6
        model_length = 8

    with pytest.raises(HavacUsageError, match="cardinality 6"):
        Havac(config=CFG, backend="xla").load_phmm([Stub()])


def test_async_run_and_abort():
    models, records = generate_planted_fixture(
        seed=5, model_length=32, sequence_length=30000, num_models=1)
    engine = Havac(p_value=P_VALUE, config=CFG, backend="xla",
                   chunk_symbols=1024)
    engine.load_phmm(models)
    engine.load_sequence(fasta_text(records), is_text=True)

    # Async completion path.
    engine.run_async()
    assert engine.wait(timeout=300) == HavacRunState.COMPLETED
    n_full = len(engine.hits())

    # Abort path: request cancellation immediately; with many chunks the
    # abort lands before the run drains (or the run completes, which is the
    # same race the reference tolerates).
    engine.run_async()
    engine.abort()
    state = engine.wait(timeout=300)
    assert state in (HavacRunState.ABORTED, HavacRunState.COMPLETED)
    if state == HavacRunState.ABORTED:
        with pytest.raises(HavacUsageError):
            engine.hits()

    # A fresh run after abort recovers fully.
    engine.run()
    assert len(engine.hits()) == n_full


def test_hit_tile_overflow_retry(tmp_path):
    """Saturating scores make every cell hit; the engine must retry with a
    bigger record buffer instead of failing (reference analog: the 3.5 GiB
    hit buffer bound, host/HavacHwClient.hpp:94), with checkpointing on."""
    models, records = generate_planted_fixture(
        seed=9, model_length=16, sequence_length=2000, num_models=1)
    cfg = SsvKernelConfig(block_width=1024, rows_per_strip=8, max_hits=1)
    engine = Havac(p_value=P_VALUE, config=cfg, backend="gpu_interpret",
                   chunk_symbols=1024, checkpoint_path=str(tmp_path / "ck.npz"))
    engine.load_phmm(models)
    # Saturate: replace projected scores with +127 everywhere → hits all over.
    engine.load_sequence(fasta_text(records), is_text=True)
    engine.scores = np.full_like(engine.scores, 127)
    engine.run()
    assert engine.stats.overflow_retries > 0
    rows, pos = engine.raw_hits()
    result, _ = ssv_reference(engine.database.codes, engine.scores)
    assert np.array_equal(rows, result.hit_rows)
    assert np.array_equal(pos, result.hit_positions)


def test_row_chunked_run_is_exact():
    """Model collections taller than chunk_rows are swept in row chunks
    chained by final_row_state; hits must match the single-dispatch run."""
    models, records = generate_planted_fixture(
        seed=17, model_length=30, sequence_length=3000, num_models=4)
    db = load_fasta_database(fasta_text(records), pad_multiple=CFG.block_width,
                             is_text=True)
    chunked = Havac(p_value=P_VALUE, config=CFG, backend="xla",
                    chunk_rows=40)  # 120 total rows -> 3 row chunks
    chunked.load_phmm(models).load_sequence(db).run()
    whole = Havac(p_value=P_VALUE, config=CFG, backend="xla")
    whole.load_phmm(models).load_sequence(db).run()
    assert chunked.stats.num_chunks > whole.stats.num_chunks
    assert_hits_equal(chunked.hits(), whole.hits())
    assert_hits_equal(chunked.hits(), oracle_resolved(whole))


def test_row_and_column_chunked_run_is_exact():
    """Both axes chunked at once: the 2D carry/row-state bookkeeping."""
    models, records = generate_planted_fixture(
        seed=19, model_length=25, sequence_length=6000, num_models=5)
    db = load_fasta_database(fasta_text(records), pad_multiple=CFG.block_width,
                             is_text=True)
    grid = Havac(p_value=P_VALUE, config=CFG, backend="gpu_interpret",
                 chunk_symbols=2048, chunk_rows=48)
    grid.load_phmm(models).load_sequence(db).run()
    whole = Havac(p_value=P_VALUE, config=CFG, backend="xla")
    whole.load_phmm(models).load_sequence(db).run()
    assert grid.stats.num_chunks >= 6
    assert_hits_equal(grid.hits(), whole.hits())


def test_checkpoint_resume_after_abort(tmp_path):
    """An aborted run restarted with the same inputs resumes from the last
    completed column chunk and produces identical hits."""
    ckpt = str(tmp_path / "run.ckpt.npz")
    models, records = generate_planted_fixture(
        seed=31, model_length=32, sequence_length=16000, num_models=2)
    db = load_fasta_database(fasta_text(records), pad_multiple=CFG.block_width,
                             is_text=True)

    def make():
        e = Havac(p_value=P_VALUE, config=CFG, backend="xla",
                  chunk_symbols=1024, checkpoint_path=ckpt)
        return e.load_phmm(models).load_sequence(db)

    import os as _os
    import time as _time

    # Interrupt a run mid-flight (poll until a checkpoint appears).
    first = make()
    first.run_async()
    for _ in range(3000):
        if _os.path.exists(ckpt):
            break
        _time.sleep(0.005)
    first.abort()
    first.wait()

    if _os.path.exists(ckpt):  # abort landed mid-run: resume path
        second = make()
        second.run()
        assert second.resumed_chunks > 0
        assert not _os.path.exists(ckpt)  # cleaned up on completion
    else:  # run drained before abort: still verify a fresh run
        second = make()
        second.run()

    whole = Havac(p_value=P_VALUE, config=CFG, backend="xla")
    whole.load_phmm(models).load_sequence(db).run()
    assert_hits_equal(second.hits(), whole.hits())


def test_checkpoint_rejected_on_input_change(tmp_path):
    """A checkpoint from different inputs must be ignored (fingerprint)."""
    ckpt = str(tmp_path / "run.ckpt.npz")
    models, records = generate_planted_fixture(
        seed=33, model_length=24, sequence_length=6000, num_models=1)
    db = load_fasta_database(fasta_text(records), pad_multiple=CFG.block_width,
                             is_text=True)
    e1 = Havac(p_value=P_VALUE, config=CFG, backend="xla",
               chunk_symbols=1024, checkpoint_path=ckpt)
    e1.load_phmm(models).load_sequence(db)
    # Fake a stale checkpoint with a wrong fingerprint.
    np.savez(ckpt[:-4], fingerprint=np.int64(12345), next_ci=np.int64(3),
             carry=np.zeros(25, np.int32),
             hit_rows=np.zeros(5, np.int64), hit_positions=np.zeros(5, np.int64))
    e1.run()
    assert e1.resumed_chunks == 0
    whole = Havac(p_value=P_VALUE, config=CFG, backend="xla")
    whole.load_phmm(models).load_sequence(db).run()
    assert_hits_equal(e1.hits(), whole.hits())


def test_scan_files_streaming(tmp_path):
    """Multi-file streaming scan: per-file hits equal independent runs."""
    paths = []
    fixtures = []
    for i in range(3):
        models, records = generate_planted_fixture(
            seed=50 + i, model_length=24, sequence_length=2000, num_models=1)
        if i == 0:
            shared_models = models  # one model collection scans all files
        p = tmp_path / f"db{i}.fasta"
        p.write_text(fasta_text(records))
        paths.append(str(p))
        fixtures.append(records)

    engine = Havac(p_value=P_VALUE, config=CFG, backend="xla")
    engine.load_phmm(shared_models)
    streamed = dict()
    for path, hits in engine.scan_files(paths, prefetch=2):
        streamed[path] = sorted(hits.as_tuples())

    assert set(streamed) == set(paths)
    for p in paths:
        solo = Havac(p_value=P_VALUE, config=CFG, backend="xla")
        solo.load_phmm(shared_models).load_sequence(p).run()
        assert streamed[p] == sorted(solo.hits().as_tuples())


def test_scan_files_abandoned_generator_stops_producer(tmp_path):
    """Breaking out of scan_files must not leave the prefetch thread blocked."""
    import threading

    paths = []
    models, records = generate_planted_fixture(
        seed=61, model_length=16, sequence_length=500, num_models=1)
    for i in range(4):
        p = tmp_path / f"f{i}.fasta"
        p.write_text(fasta_text(records))
        paths.append(str(p))
    engine = Havac(p_value=P_VALUE, config=CFG, backend="xla")
    engine.load_phmm(models)
    before = threading.active_count()
    gen = engine.scan_files(paths, prefetch=1)
    next(gen)
    gen.close()  # abandon mid-stream
    import time as _time
    for _ in range(100):
        if threading.active_count() <= before:
            break
        _time.sleep(0.05)
    assert threading.active_count() <= before, "producer thread leaked"


def test_both_strands_scanning():
    """strand='both' finds plants on the reverse strand at forward coords."""
    from havac.io.fasta import reverse_complement

    models, records = generate_planted_fixture(
        seed=71, model_length=40, sequence_length=1200, num_models=1)
    # Build a sequence whose PLANT exists only on the minus strand: take the
    # planted sequence and reverse-complement the whole record.
    name, seq = records[0]
    rc_seq = reverse_complement(seq.encode()).decode()
    fasta = f">{name}\n{rc_seq}\n"

    fwd = Havac(p_value=P_VALUE, config=CFG, backend="xla")
    fwd.load_phmm(models).load_sequence(fasta, is_text=True).run()
    both = Havac(p_value=P_VALUE, config=CFG, backend="xla", strand="both")
    both.load_phmm(models).load_sequence(fasta, is_text=True).run()

    plus_hits = len(fwd.hits())
    hits = both.hits()
    minus = hits.strand == "-"
    assert minus.sum() > plus_hits  # plants only visible on minus strand
    # Plus-strand subset must equal the forward-only run.
    plus = [t for t, s in zip(hits.as_tuples(), hits.strand) if s == "+"]
    assert sorted(plus) == sorted(fwd.hits().as_tuples())
    # Minus-strand positions reported in forward coordinates.
    assert np.all(hits.sequence_position[minus] < len(rc_seq))
    # Minus-strand hit set equals a forward scan of the original record.
    orig = Havac(p_value=P_VALUE, config=CFG, backend="xla")
    orig.load_phmm(models).load_sequence(f">{name}\n{seq}\n", is_text=True)
    orig.run()
    # The minus hits at forward coords, re-mapped to the rc record's own
    # coordinates, must match the original-orientation scan's hits.
    remapped = sorted(
        (0, len(seq) - 1 - p, mi, mp)
        for (si, p, mi, mp), s in zip(hits.as_tuples(), hits.strand)
        if s == "-")
    assert remapped == sorted(orig.hits().as_tuples())


def test_isolate_models_matches_independent_runs():
    """isolate_models: hits equal running each model independently (chains
    never cross model boundaries) — on both the XLA and GPU backends."""
    models, records = generate_planted_fixture(
        seed=91, model_length=36, sequence_length=4000, num_models=3)
    fasta = fasta_text(records)

    def run(backend, config, **kw):
        e = Havac(p_value=P_VALUE, config=config, backend=backend, **kw)
        e.load_phmm(models).load_sequence(fasta, is_text=True).run()
        return e

    iso_xla = run("xla", CFG, isolate_models=True)
    iso_gpu = run("gpu_interpret", CFG, isolate_models=True)
    assert_hits_equal(iso_xla.hits(), iso_gpu.hits())

    # Equivalent to scanning each model alone.
    expected = []
    for m in models:
        solo = run("xla", CFG)
        solo.load_phmm([m]).load_sequence(fasta, is_text=True)
        solo.run()
        mi = models.index(m)
        expected += [(si, sp, mi, mp)
                     for si, sp, _, mp in solo.hits().as_tuples()]
    assert sorted(iso_xla.hits().as_tuples()) == sorted(expected)

    # And differs from the concatenated-stream default when chains cross.
    joined = run("xla", CFG)
    assert len(joined.hits()) >= len(iso_xla.hits())


def test_pipelined_checkpoint_resume(tmp_path):
    """The fast (pipelined) path checkpoints per column chunk and resumes."""
    ckpt = str(tmp_path / "pipe.ckpt.npz")
    models, records = generate_planted_fixture(
        seed=37, model_length=24, sequence_length=16000, num_models=2)
    db = load_fasta_database(fasta_text(records), pad_multiple=1024,
                             is_text=True)
    cfg = SsvKernelConfig(block_width=1024, rows_per_strip=8)

    def make():
        e = Havac(p_value=P_VALUE, config=cfg, backend="gpu_interpret",
                  chunk_symbols=2048, checkpoint_path=ckpt)
        return e.load_phmm(models).load_sequence(db)

    import os as _os
    import time as _time

    first = make()
    first.run_async()
    for _ in range(4000):
        if _os.path.exists(ckpt):
            break
        _time.sleep(0.005)
    first.abort()
    first.wait()

    second = make()
    second.run()
    if _os.path.exists(ckpt) or second.resumed_chunks:
        pass  # resume exercised when the abort landed mid-run
    whole = Havac(p_value=P_VALUE, config=cfg, backend="gpu_interpret")
    whole.load_phmm(models).load_sequence(db).run()
    assert_hits_equal(second.hits(), whole.hits())
    assert not _os.path.exists(ckpt)  # cleaned up on completion


def test_warmup_then_run_is_exact():
    """warmup() pre-stages + pre-compiles the pipelined sweep; the following
    run reuses it and produces identical hits (and a second run after the
    warm sweep is consumed rebuilds cleanly)."""
    models, records = generate_planted_fixture(
        seed=23, model_length=40, sequence_length=6000, num_models=2)
    db = load_fasta_database(fasta_text(records), pad_multiple=CFG.block_width,
                             is_text=True)
    cold = Havac(p_value=P_VALUE, config=CFG, backend="gpu_interpret")
    cold.load_phmm(models).load_sequence(db).run()

    warm = Havac(p_value=P_VALUE, config=CFG, backend="gpu_interpret")
    warm.load_phmm(models).load_sequence(db)
    warm.warmup()
    assert warm._warm_sweep is not None
    warm.run()
    assert warm._warm_sweep is None  # consumed by the run
    assert_hits_equal(warm.hits(), cold.hits())
    assert_hits_equal(warm.hits(), oracle_resolved(cold))
    assert warm.stats.pipeline_prof is not None

    warm.run()  # second run rebuilds the sweep without warmup
    assert_hits_equal(warm.hits(), cold.hits())


def test_warmup_invalidated_by_reload():
    """Reloading models or sequences drops the warmed sweep (stale geometry
    must never be reused)."""
    models, records = generate_planted_fixture(
        seed=29, model_length=32, sequence_length=4000, num_models=2)
    db = load_fasta_database(fasta_text(records), pad_multiple=CFG.block_width,
                             is_text=True)
    eng = Havac(p_value=P_VALUE, config=CFG, backend="gpu_interpret")
    with pytest.raises(HavacUsageError):
        eng.warmup()
    eng.load_phmm(models).load_sequence(db)
    eng.warmup()
    assert eng._warm_sweep is not None
    eng.load_sequence(db)
    assert eng._warm_sweep is None
    eng.warmup()
    eng.load_phmm(models)
    assert eng._warm_sweep is None
    eng.run()
    assert_hits_equal(eng.hits(), oracle_resolved(eng))


def test_record_cap_overflow_retry_pipelined():
    """A chunk whose hit records exceed the adaptive record cap must be
    re-dispatched from its retained inputs at a grown cap (drain_one's retry
    loop) and still produce oracle-exact hits."""
    models, records = generate_planted_fixture(
        seed=23, model_length=40, sequence_length=6000, num_models=2)
    db = load_fasta_database(fasta_text(records), pad_multiple=CFG.block_width,
                             is_text=True)
    engine = Havac(p_value=P_VALUE, config=CFG, backend="gpu_interpret",
                   chunk_symbols=2048)
    engine.load_phmm(models).load_sequence(db)
    sweep = engine._build_pipelined_sweep()
    sweep.record_cap = 8  # force the overflow retry on real chunks
    engine._warm_sweep = sweep
    engine.run()
    assert sweep.overflow_retries > 0
    assert sweep.record_cap > 8
    assert engine.stats.overflow_retries == sweep.overflow_retries
    assert_hits_equal(engine.hits(), oracle_resolved(engine))


def test_gpu_pipelined_end_to_end_matches_oracle():
    """The production configuration — pipelined engine, GPU kernel (here in
    the Pallas interpreter) — chunked in both axes, vs the scalar oracle."""
    models, records = generate_planted_fixture(
        seed=41, model_length=40, sequence_length=15000, num_models=3)
    db = load_fasta_database(fasta_text(records), pad_multiple=1024,
                             is_text=True)
    engine = Havac(p_value=P_VALUE, config=CFG, backend="gpu_interpret",
                   chunk_symbols=6144, chunk_rows=48)
    engine.load_phmm(models).load_sequence(db).run()
    assert engine.stats.num_chunks > 1
    want = oracle_resolved(engine)
    assert len(want) > 0, "fixture must plant hits"
    assert_hits_equal(engine.hits(), want)
    geo = engine.stats.chunk_geometry
    assert geo["n_col"] * geo["n_row"] == engine.stats.num_chunks


@pytest.mark.parametrize("lookahead", [1, 2, 5])
def test_pipelined_lookahead_depth_is_exact(monkeypatch, lookahead):
    """Any number of chunks in flight gives the same hits."""
    from havac.engine import pipeline as pl_mod

    monkeypatch.setattr(pl_mod, "LOOKAHEAD", lookahead)
    models, records = generate_planted_fixture(
        seed=43, model_length=30, sequence_length=7000, num_models=2)
    engine = Havac(p_value=P_VALUE, config=CFG, backend="gpu_interpret",
                   chunk_symbols=2048, chunk_rows=32)
    engine.load_phmm(models).load_sequence(fasta_text(records), is_text=True)
    engine.run()
    assert engine.stats.chunk_geometry["lookahead"] == lookahead
    assert_hits_equal(engine.hits(), oracle_resolved(engine))


def test_pipelined_geometry_pads_to_uniform_chunks():
    """Every chunk has one shape: the last row and column chunks are padded
    (pad rows score -128, pad positions are dropped at resolution)."""
    from havac.engine.pipeline import PipelinedSweep

    codes = np.zeros(10_000, dtype=np.uint8)
    scores = np.zeros((70, 4), dtype=np.int8)
    sweep = PipelinedSweep(codes, scores, chunk_symbols=4096, chunk_rows=32,
                           align=512, interpret=True)
    assert (sweep.n_col, sweep.n_row) == (3, 3)
    assert sweep.chunk % 512 == 0 and sweep.n_col * sweep.chunk >= 10_000
    assert sweep.rchunk == 24  # 70 rows in three uniform chunks
    assert all(s.shape == (24, 4) for s in sweep._scores_dev)
    assert (np.asarray(sweep._scores_dev[-1])[70 - 48:] == -128).all()
    assert sweep._codes_dev.shape == (sweep.n_col * sweep.chunk,)


def test_amino_collection_on_xla_path():
    """A card-20 collection through the serial XLA loop, chunked in rows
    (the scores padding follows the alphabet's width)."""
    from havac.testing.generator import model_from_consensus

    rng = np.random.default_rng(5)
    models = [model_from_consensus(rng.integers(0, 20, size=n).astype(np.uint8),
                                   name=f"p{i}", alphabet="amino")
              for i, n in enumerate((30, 21))]
    seq = "".join("ACDEFGHIKLMNPQRSTVWY"[c]
                  for c in rng.integers(0, 20, size=1500))
    fasta = ">prot\n" + seq + "\n"
    xla = Havac(p_value=0.5, config=CFG, backend="xla", chunk_rows=24)
    xla.load_phmm(models).load_sequence(fasta, is_text=True).run()
    assert xla.alphabet == "amino" and xla.stats.num_chunks > 1
    gpu = Havac(p_value=0.5, config=CFG, backend="gpu_interpret",
                chunk_rows=24)
    gpu.load_phmm(models).load_sequence(fasta, is_text=True).run()
    want = oracle_resolved(xla)
    assert len(want) > 0
    assert_hits_equal(xla.hits(), want)
    assert_hits_equal(gpu.hits(), want)


@pytest.mark.parametrize("requested,platform,want", [
    ("auto", "cpu", "xla"),
    ("auto", "gpu", "gpu"),
    ("gpu", "gpu", "gpu"),
    ("xla", "gpu", "xla"),
    ("gpu_interpret", "cpu", "gpu_interpret"),
    ("gpu", "cpu", HavacUsageError),
    ("auto", "rocm", HavacUsageError),
    ("pallas", "cpu", HavacUsageError),
])
def test_pick_backend(monkeypatch, requested, platform, want):
    """auto → the GPU kernel on a GPU and the XLA reference on the CPU; an
    explicit gpu request never falls back; anything else is an error."""
    import jax

    from havac.engine.api import _pick_backend

    monkeypatch.setattr(jax, "default_backend", lambda: platform)
    if want is HavacUsageError:
        with pytest.raises(HavacUsageError):
            _pick_backend(requested)
    else:
        assert _pick_backend(requested) == want


def test_sequence_by_model_mesh_is_rejected():
    import jax
    from jax.sharding import Mesh

    devs = np.array(jax.devices()[:4]).reshape(2, 2)
    models, records = generate_planted_fixture(
        seed=3, model_length=20, sequence_length=2000, num_models=2)
    e = Havac(p_value=P_VALUE, config=CFG, backend="gpu_interpret",
              mesh=Mesh(devs, ("seq", "model")))
    e.load_phmm(models).load_sequence(fasta_text(records), is_text=True)
    with pytest.raises(HavacUsageError, match="sequence × model"):
        e.run()


def test_pipelined_abort_mid_run_then_recover():
    """abort() on the pipelined GPU path stops at a chunk boundary; a fresh
    run afterwards is complete and exact."""
    models, records = generate_planted_fixture(
        seed=47, model_length=24, sequence_length=12000, num_models=2)
    engine = Havac(p_value=P_VALUE, config=CFG, backend="gpu_interpret",
                   chunk_symbols=1024)
    engine.load_phmm(models).load_sequence(fasta_text(records), is_text=True)
    seen = []

    class AbortAfterTwo:
        def is_set(self):
            seen.append(1)
            return len(seen) > 2

        def set(self):
            pass

        def clear(self):
            pass

    engine._abort_event = AbortAfterTwo()
    engine.run_async()
    assert engine.wait() == HavacRunState.ABORTED
    engine._abort_event = __import__("threading").Event()
    engine.run()
    assert engine.progress == 1.0
    assert_hits_equal(engine.hits(), oracle_resolved(engine))
