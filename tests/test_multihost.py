"""Two-process jax.distributed execution of the sequence-sharded mesh sweep.

The reference never scales past one card; multi-host is new scope
(SURVEY.md §2.5, BASELINE "scaling to >=2 hosts"). These tests spawn two
real OS processes, each owning 4 virtual CPU devices, joined into one
8-device cluster via jax.distributed over localhost TCP — the same recipe
several GPU hosts use over their network. Each process stages only its local database
shard and decodes only its addressable record shards; the parent asserts the
concatenated per-host hit lists are bit-exact vs the single-process oracle.
"""

import os
import socket
import subprocess
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(__file__))
from multihost_worker import make_inputs  # noqa: E402

from havac.ops.reference import ssv_reference  # noqa: E402

WORKER = os.path.join(os.path.dirname(__file__), "multihost_worker.py")


def _free_port():
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def _run_cluster(tmp_path, case, nproc=2, timeout=600):
    env = dict(os.environ)
    env["JAX_PLATFORMS"] = "cpu"
    env["XLA_FLAGS"] = "--xla_force_host_platform_device_count=4"
    env["PYTHONPATH"] = os.pathsep.join(
        [os.path.dirname(os.path.dirname(os.path.abspath(__file__)))]
        + env.get("PYTHONPATH", "").split(os.pathsep))
    coord = f"127.0.0.1:{_free_port()}"
    procs = [
        subprocess.Popen(
            [sys.executable, WORKER, coord, str(nproc), str(i),
             str(tmp_path), "--case", case],
            env=env, stdout=subprocess.PIPE, stderr=subprocess.STDOUT,
            text=True)
        for i in range(nproc)
    ]
    outs = []
    try:
        for p in procs:
            out, _ = p.communicate(timeout=timeout)
            outs.append(out)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
    for i, (p, out) in enumerate(zip(procs, outs)):
        assert p.returncode == 0, f"proc {i} failed:\n{out}"
    merged_rows, merged_pos, caps = [], [], []
    for i in range(nproc):
        z = np.load(tmp_path / f"proc{i}.npz")
        merged_rows.append(z["rows"])
        merged_pos.append(z["pos"])
        caps.append(int(z["record_cap"]))
    rows = np.concatenate(merged_rows)
    pos = np.concatenate(merged_pos)
    order = np.lexsort((pos, rows))
    return rows[order], pos[order], caps


@pytest.mark.slow
def test_two_process_parity(tmp_path):
    rows, pos, _ = _run_cluster(tmp_path, "plain")
    codes, scores = make_inputs("plain", 8)
    want, _ = ssv_reference(codes, scores)
    assert len(want.hit_rows) > 0
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)


@pytest.mark.slow
def test_two_process_asymmetric_overflow_retry(tmp_path):
    """Hits dense only in host 0's shards + tiny caps: host 0 overflows,
    host 1 doesn't. Without the replicated global_count_max sync the hosts
    would diverge (one recompiles with bigger caps, the other returns) and
    the cluster deadlocks; with it, both retry identically and the merged
    hits stay exact."""
    rows, pos, caps = _run_cluster(tmp_path, "overflow")
    codes, scores = make_inputs("overflow", 8)
    want, _ = ssv_reference(codes, scores)
    assert len(want.hit_rows) > 1000  # genuinely hit-dense
    np.testing.assert_array_equal(rows, want.hit_rows)
    np.testing.assert_array_equal(pos, want.hit_positions)
    assert caps[0] == caps[1]  # hosts agreed on the final cap
    assert caps[0] > 16  # and it actually grew


@pytest.mark.slow
def test_two_process_divergent_checkpoints_restart(tmp_path):
    """A kill can land between two hosts' checkpoint writes (or eat one
    host's file). Resuming from DIVERGENT per-host next_t would dispatch
    mismatched collective step programs and deadlock the cluster; the
    process_allgather agreement in Havac._mesh_checkpoint_hooks must make
    every host restart from step 0 instead, keeping the merged hits exact."""
    _run_cluster(tmp_path, "ckpt_diverge")
    got = []
    for i in range(2):
        z = np.load(tmp_path / f"proc{i}.npz")
        assert int(z["resumed"]) == 0  # divergence detected: fresh start
        got += list(zip(z["si"].tolist(), z["sp"].tolist(),
                        z["pi"].tolist(), z["pp"].tolist()))

    from havac.engine import Havac
    from havac.ops.common import SsvKernelConfig
    from havac.testing.generator import generate_planted_fixture

    models, records = generate_planted_fixture(
        seed=61, model_length=40, sequence_length=30000, num_models=2)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    single = Havac(p_value=0.05, backend="xla",
                   config=SsvKernelConfig(block_width=1024, rows_per_strip=8))
    single.load_phmm(models).load_sequence(fasta, is_text=True).run()
    want = single.hits().as_tuples()
    assert len(want) > 0
    assert sorted(got) == sorted(want)
