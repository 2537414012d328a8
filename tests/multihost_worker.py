"""One process of a multi-process JAX CPU cluster (spawned by
tests/test_multihost.py).

Executes the per-host recipe from havac/parallel/multihost.py for real:
jax.distributed over localhost TCP, a global mesh spanning both processes'
virtual CPU devices, host-local database staging, and addressable-shard-only
hit decode. Writes this host's partial hit list to <outdir>/proc<i>.npz; the
parent concatenates the per-host outputs and asserts exact parity with the
single-process oracle.

Usage: multihost_worker.py <coordinator> <num_processes> <process_id> <outdir>
       [--case plain|overflow|ckpt_diverge]
"""

import os
import sys

import numpy as np


def make_inputs(case: str, n_global_dev: int):
    rng = np.random.default_rng(0)
    if case == "plain":
        codes = rng.integers(0, 4, size=4 * 1024 * n_global_dev)
        scores = rng.integers(-40, 110, size=(75, 4))
    elif case == "overflow":
        # Hits dense ONLY in process 0's half of the database: symbol 0
        # scores high, and only the first half contains symbol 0. With tiny
        # initial caps, host 0 overflows while host 1 does not — the exact
        # divergence the global_count_max sync exists for.
        L = 2 * 1024 * n_global_dev
        codes = rng.integers(1, 4, size=L)
        codes[: L // 2] = 0
        scores = np.full((32, 4), -40)
        scores[:, 0] = 110
    else:
        raise ValueError(case)
    return codes.astype(np.uint8), scores.astype(np.int8)


def main():
    coord, nproc, pid, outdir = (sys.argv[1], int(sys.argv[2]),
                                 int(sys.argv[3]), sys.argv[4])
    case = sys.argv[sys.argv.index("--case") + 1] \
        if "--case" in sys.argv else "plain"

    import jax

    jax.config.update("jax_platforms", "cpu")
    jax.distributed.initialize(coordinator_address=coord,
                               num_processes=nproc, process_id=pid)
    assert jax.process_count() == nproc
    n_dev = len(jax.devices())
    from jax.sharding import Mesh

    if case == "ckpt_diverge":
        run_ckpt_diverge(pid, outdir)
        return

    codes, scores = make_inputs(case, n_dev)

    from havac.parallel.mesh_sweep import MeshSweep

    mesh = Mesh(np.array(jax.devices()), ("seq",))
    kw = {}
    if case == "overflow":
        kw = dict(record_cap=16)
    sweep = MeshSweep(codes, mesh, rows_per_step=32, align=256,
                      interpret=True, **kw)
    rows, pos = sweep.run(scores)

    np.savez(os.path.join(outdir, f"proc{pid}.npz"), rows=rows, pos=pos,
             record_cap=sweep.record_cap)
    print(f"proc {pid}: {rows.size} local hits", flush=True)


def run_ckpt_diverge(pid: int, outdir: str):
    """Divergent per-host mesh checkpoints must NOT be resumed.

    Phase 1: both processes run the engine-level mesh sweep and abort right
    after their first wavefront-step checkpoint write (deterministic — the
    callback wrapper sets the abort event), so both hold a next_t=4 file.
    Process 1 then deletes ITS file, simulating a kill that ate one host's
    checkpoint. Phase 2: on resume, host 0 sees next_t=4 and host 1 sees
    nothing; without the process_allgather agreement in
    Havac._mesh_checkpoint_hooks the hosts would dispatch different numbers
    of collective wavefront steps and deadlock — with it, both restart from
    step 0 and the merged hits stay exact (asserted by the parent)."""
    import jax

    from havac.engine import Havac, HavacRunState
    from havac.ops.common import SsvKernelConfig
    from havac.testing.generator import generate_planted_fixture
    from jax.sharding import Mesh

    models, records = generate_planted_fixture(
        seed=61, model_length=40, sequence_length=30000, num_models=2)
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    cfg = SsvKernelConfig(block_width=1024, rows_per_strip=8)
    mesh = Mesh(np.array(jax.devices()), ("seq",))
    ckpt = os.path.join(outdir, "mesh.ckpt.npz")

    def make():
        e = Havac(p_value=0.05, backend="gpu_interpret", config=cfg,
                  mesh=mesh, checkpoint_path=ckpt)
        return e.load_phmm(models).load_sequence(fasta, is_text=True)

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
    assert first.state == HavacRunState.ABORTED, first.state
    my_path = ckpt + f".p{pid}"
    assert os.path.exists(my_path)
    if pid == 1:
        os.remove(my_path)  # this host's checkpoint "lost" by the kill

    second = make()
    second.run()
    # Resolved coordinates are pad-geometry-independent (raw ones are not);
    # this host resolves only its addressable-shard hits.
    res = second.hits()
    np.savez(os.path.join(outdir, f"proc{pid}.npz"),
             rows=np.empty(0, np.int64), pos=np.empty(0, np.int64),
             record_cap=0, resumed=second.resumed_chunks,
             si=res.sequence_index, sp=res.sequence_position,
             pi=res.phmm_index, pp=res.phmm_position)
    print(f"proc {pid}: {len(res)} local hits, "
          f"resumed={second.resumed_chunks}", flush=True)


if __name__ == "__main__":
    main()
