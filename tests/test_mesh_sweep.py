"""Sequence-sharded mesh sweep (GPU kernel in the Pallas interpreter, on a
mesh of virtual CPU devices) vs the oracle.

The GPU mesh path: the kernel per shard inside a shard_map wavefront, seams
exchanged as the kernel's carry vector via ppermute, compact hit records
pulled per step.
"""

import numpy as np
import pytest

import jax
from jax.sharding import Mesh

from havac.ops.reference import ssv_reference
from havac.parallel.mesh_sweep import MeshSweep


def mesh(n):
    return Mesh(np.array(jax.devices()[:n]), ("seq",))


def sweep_for(codes, n_dev, **kw):
    kw.setdefault("rows_per_step", 32)
    kw.setdefault("align", 256)
    kw.setdefault("interpret", True)
    return MeshSweep(codes, mesh(n_dev), **kw)


def random_case(seed, L, P, card=4):
    rng = np.random.default_rng(seed)
    return (rng.integers(0, card, size=L).astype(np.uint8),
            rng.integers(-40, 110, size=(P, card)).astype(np.int8))


def assert_exact(got, want):
    rows, pos = got
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)


@pytest.mark.parametrize("n_dev", [2, 4, 8])
def test_mesh_matches_oracle(n_dev):
    codes, scores = random_case(0, 1024 * n_dev, 75)
    want, _ = ssv_reference(codes, scores)
    assert len(want.hit_rows) > 0
    assert_exact(sweep_for(codes, n_dev).run(scores), want)


def test_mesh_seam_and_chunk_crossing():
    """Monotone chains cross shard seams and row-chunk boundaries."""
    rng = np.random.default_rng(1)
    codes = rng.integers(0, 4, size=4 * 1024).astype(np.uint8)
    scores = np.full((96, 4), 5, dtype=np.int8)  # 3 row chunks of 32
    want, _ = ssv_reference(codes, scores)
    assert len(want.hit_rows) > 100
    assert_exact(sweep_for(codes, 4).run(scores), want)


def test_mesh_ragged_padding():
    codes, scores = random_case(2, 5011, 44)  # ragged L and P
    want, _ = ssv_reference(codes, scores)
    assert_exact(sweep_for(codes, 4).run(scores), want)


@pytest.mark.parametrize("rows_per_step", [16, 64])
def test_mesh_rows_per_step_is_exact(rows_per_step):
    codes, scores = random_case(3, 3000, 70)
    want, _ = ssv_reference(codes, scores)
    assert_exact(sweep_for(codes, 4, rows_per_step=rows_per_step)
                 .run(scores), want)


def test_mesh_record_cap_retry():
    """Hit-dense runs must grow the record capacity, not hard-fail."""
    codes = np.zeros(2048, dtype=np.uint8)
    scores = np.full((32, 4), 127, dtype=np.int8)  # hits everywhere
    sweep = sweep_for(codes, 2, record_cap=16)
    want, _ = ssv_reference(codes, scores)
    assert_exact(sweep.run(scores), want)
    assert sweep.record_cap > 16 and sweep.overflow_retries > 0


def test_mesh_isolation():
    codes, scores = random_case(9, 2048, 60)
    reset = np.zeros(60, dtype=bool)
    reset[0] = reset[23] = True
    want, _ = ssv_reference(codes, scores, reset_rows=reset)
    assert len(want.hit_rows) > 0
    assert_exact(sweep_for(codes, 2).run(scores, reset), want)


def test_mesh_amino():
    codes, scores = random_case(10, 2500, 40, card=20)
    scores = (scores.astype(np.int16) - 30).clip(-128, 127).astype(np.int8)
    want, _ = ssv_reference(codes, scores)
    assert len(want.hit_rows) > 0
    assert_exact(sweep_for(codes, 4).run(scores), want)


class _AbortAfter:
    """threading.Event stand-in that trips after n is_set() polls."""

    def __init__(self, n):
        self.n = n
        self.calls = 0

    def is_set(self):
        self.calls += 1
        return self.calls > self.n


def test_mesh_abort_per_step():
    """abort takes effect between wavefront steps (run returns None), and
    the sweep object remains usable afterwards."""
    codes, scores = random_case(13, 4096, 96)  # T = 3 + 4 - 1 = 6
    sweep = sweep_for(codes, 4)
    ev = _AbortAfter(2)
    assert sweep.run(scores, abort_event=ev) is None
    assert ev.calls == 3  # polled per step; tripped mid-sweep
    want, _ = ssv_reference(codes, scores)
    assert_exact(sweep.run(scores), want)


def test_mesh_progress_reports_steps():
    codes, scores = random_case(14, 2048, 64)
    seen = []
    sweep_for(codes, 2).run(
        scores, progress=lambda step, total: seen.append((step, total)))
    T = 64 // 32 + 2 - 1
    assert seen == [(t, T) for t in range(1, T + 1)]


def test_mesh_checkpoint_resume():
    """Wavefront-step checkpoint/resume: a sweep stopped mid-stream resumes
    from the last payload and produces the exact hits."""
    codes, scores = random_case(21, 4096, 160)  # T = 5 + 4 - 1 = 8
    sweep = sweep_for(codes, 4)
    payloads = []

    def cb(t_next, il, ilo, sl, slo, rows, pos):
        assert ilo == 0 and slo == 0  # single-process: local = global
        payloads.append((t_next, il.copy(), sl.copy(), rows.copy(),
                         pos.copy()))

    ev = _AbortAfter(5)
    assert sweep.run(scores, abort_event=ev, checkpoint_cb=cb,
                     ckpt_every=2) is None
    assert [p[0] for p in payloads] == [2, 4]
    want, _ = ssv_reference(codes, scores)
    assert len(want.hit_rows) > 0
    assert_exact(sweep.run(scores, resume=payloads[-1]), want)


def test_mesh_resume_from_every_checkpoint():
    codes, scores = random_case(23, 4096, 160)
    sweep = sweep_for(codes, 4)
    payloads = []

    def cb(t_next, il, ilo, sl, slo, rows, pos):
        payloads.append((t_next, il.copy(), sl.copy(), rows.copy(),
                         pos.copy()))

    want, _ = ssv_reference(codes, scores)
    assert_exact(sweep.run(scores, checkpoint_cb=cb, ckpt_every=3), want)
    assert [p[0] for p in payloads] == [3, 6]
    for p in payloads:
        assert_exact(sweep.run(scores, resume=p), want)


def test_mesh_phase_attribution():
    codes, scores = random_case(22, 2048, 60)
    sweep = sweep_for(codes, 2)
    sweep.run(scores)
    assert set(sweep.prof) == {"dispatch", "pull", "sort"}
    assert sweep.prof["dispatch"] > 0 and sweep.prof["sort"] > 0
