"""Distributed engine path on an 8-device CPU mesh vs the scalar oracle.

BASELINE config 3's shape at test scale: a multi-model collection swept over
a sequence-sharded mesh in several row chunks, exercising the cross-chunk
chain state (sharded row state + per-device boundary scalars) and the
on-device hit compaction. Exactness includes chains that cross shard seams
AND row-chunk boundaries simultaneously.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from havac.engine import Havac, HavacUsageError
from havac.io.fasta import load_fasta_database
from havac.ops.common import SsvKernelConfig
from havac.ops.reference import ssv_reference
from havac.parallel.engine_dist import ssv_distributed
from havac.scoring.reprojection import project_models
from havac.testing.generator import generate_planted_fixture


CFG = SsvKernelConfig(block_width=1024, rows_per_strip=8)


def mesh8():
    return Mesh(np.array(jax.devices()[:8]), ("seq",))


def test_distributed_sweep_matches_oracle_multi_chunk():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=4096).astype(np.uint8)
    scores = rng.integers(-40, 110, size=(300, 4)).astype(np.int8)
    rows, pos = ssv_distributed(codes, scores, mesh8(), rows_per_step=32,
                                rows_per_call=96)
    want, _ = ssv_reference(codes, scores)
    assert len(want.hit_rows) > 0
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)


def test_distributed_chains_cross_seams_and_chunks():
    """Monotone chains longer than both a shard and a row chunk."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=1024).astype(np.uint8)
    scores = np.full((128, 4), 5, dtype=np.int8)  # rising chains everywhere
    rows, pos = ssv_distributed(codes, scores, mesh8(), rows_per_step=32,
                                rows_per_call=32)  # 4 chained calls
    want, _ = ssv_reference(codes, scores)
    assert len(want.hit_rows) > 100
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)


def test_distributed_hit_capacity_overflow():
    from havac.ops.common import HitRecordOverflow
    from havac.parallel.engine_dist import DistributedSweep

    codes = np.zeros(1024, dtype=np.uint8)
    scores = np.full((32, 4), 127, dtype=np.int8)  # hits everywhere
    sweep = DistributedSweep(codes, mesh8(), rows_per_step=32,
                             rows_per_call=32, hit_capacity=4)
    with pytest.raises(HitRecordOverflow):
        sweep.sweep_rows(scores, 0)


def test_engine_mesh_end_to_end():
    models, records = generate_planted_fixture(
        seed=43, model_length=64, sequence_length=6000, num_models=3)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    dist = Havac(p_value=0.05, backend="xla", mesh=mesh8(), chunk_rows=64,
                 dist_rows_per_step=32)
    dist.load_phmm(models).load_sequence(fasta, is_text=True).run()
    assert dist.stats.num_chunks == 3  # 192 rows / 64
    single = Havac(p_value=0.05, backend="xla",
                   config=SsvKernelConfig(block_width=1024, rows_per_strip=8))
    single.load_phmm(models).load_sequence(fasta, is_text=True).run()
    assert len(dist.hits()) > 0
    assert sorted(dist.hits().as_tuples()) == sorted(single.hits().as_tuples())


def test_engine_mesh_gpu_backend():
    """Mesh + GPU backend routes through the kernel wavefront path."""
    models, records = generate_planted_fixture(
        seed=47, model_length=40, sequence_length=30000, num_models=2)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    dist = Havac(p_value=0.05, backend="gpu_interpret", config=CFG,
                 mesh=mesh8())
    dist.load_phmm(models).load_sequence(fasta, is_text=True).run()
    single = Havac(p_value=0.05, backend="xla", config=CFG)
    single.load_phmm(models).load_sequence(fasta, is_text=True).run()
    assert len(dist.hits()) > 0
    assert sorted(dist.hits().as_tuples()) == sorted(single.hits().as_tuples())
    assert dist.stats.pipeline_prof is not None


def test_engine_mesh_gpu_isolation():
    """isolate_models on the GPU mesh path matches the isolated
    single-device run."""
    models, records = generate_planted_fixture(
        seed=53, model_length=30, sequence_length=20000, num_models=4)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    dist = Havac(p_value=0.05, backend="gpu_interpret", config=CFG,
                 mesh=mesh8(), isolate_models=True)
    dist.load_phmm(models).load_sequence(fasta, is_text=True).run()
    single = Havac(p_value=0.05, backend="xla", config=CFG,
                   isolate_models=True)
    single.load_phmm(models).load_sequence(fasta, is_text=True).run()
    assert len(dist.hits()) > 0
    assert sorted(dist.hits().as_tuples()) == sorted(single.hits().as_tuples())


def test_engine_mesh_xla_refuses_isolation_and_amino():
    """The XLA wavefront has neither model isolation nor amino support: it
    raises instead of silently changing the result."""
    from havac.testing.generator import model_from_consensus

    models, records = generate_planted_fixture(
        seed=59, model_length=24, sequence_length=4000, num_models=2)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    iso = Havac(p_value=0.05, backend="xla", config=CFG, mesh=mesh8(),
                isolate_models=True)
    iso.load_phmm(models).load_sequence(fasta, is_text=True)
    with pytest.raises(NotImplementedError):
        iso.run()
    amino = model_from_consensus(np.arange(20, dtype=np.uint8), name="p",
                                 alphabet="amino")
    with pytest.raises(HavacUsageError, match="amino"):
        Havac(backend="xla", config=CFG, mesh=mesh8()).load_phmm([amino])


def test_engine_mesh_checkpoint_resume(tmp_path):
    """Engine-level mesh checkpoint/resume (VERDICT r2 #5): an aborted mesh
    run restarted with the same inputs resumes from the per-step checkpoint
    file and produces identical hits."""
    import os as _os

    from havac.engine import HavacRunState

    ckpt = str(tmp_path / "mesh.ckpt.npz")
    models, records = generate_planted_fixture(
        seed=61, model_length=40, sequence_length=30000, num_models=2)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    def make():
        e = Havac(p_value=0.05, backend="gpu_interpret", config=CFG,
                  mesh=mesh8(), checkpoint_path=ckpt)
        return e.load_phmm(models).load_sequence(fasta, is_text=True)

    # Deterministic mid-run abort: wrap the checkpoint callback so the run
    # aborts right after its FIRST checkpoint write. The mesh has D=8, so
    # T = S + 7 >= 8 wavefront steps and the engine's ckpt_every=4 always
    # fires before the run can complete — no timing race.
    first = make()
    orig_hooks = first._mesh_checkpoint_hooks

    def hooks(sweep, P):
        cb, resume, path = orig_hooks(sweep, P)
        assert cb is not None

        def cb_then_abort(*args):
            cb(*args)
            first._abort_event.set()

        return cb_then_abort, resume, path

    first._mesh_checkpoint_hooks = hooks
    first.run_async()
    first.wait()
    assert first.state == HavacRunState.ABORTED
    assert _os.path.exists(ckpt)

    second = make()
    second.run()
    if _os.path.exists(ckpt + ".tmp.npz"):
        _os.remove(ckpt + ".tmp.npz")
    assert second.resumed_chunks > 0  # the resume machinery actually ran
    assert not _os.path.exists(ckpt)  # cleaned up on completion

    single = Havac(p_value=0.05, backend="xla", config=CFG)
    single.load_phmm(models).load_sequence(fasta, is_text=True).run()
    assert sorted(second.hits().as_tuples()) == sorted(
        single.hits().as_tuples())
