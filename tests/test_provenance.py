"""Provenance stamping of measurement artifacts (VERDICT r3 #2).

The round-3 runtime table was captured while the native host core had
silently fallen back to numpy; these tests pin the guards that make that
incident impossible to repeat: a degraded capture either hard-fails
(require_native) or is tagged native_active=false in the artifact itself,
and every engine run records whether the native core was live.
"""

import numpy as np
import pytest

from havac.utils.provenance import provenance


def test_stamp_fields_present():
    stamp = provenance()
    assert set(stamp) >= {"native_active", "knobs", "git_rev", "device"}
    assert isinstance(stamp["native_active"], bool)
    assert isinstance(stamp["knobs"], dict)


def test_require_native_hard_fails_on_fallback(monkeypatch):
    from havac import native

    monkeypatch.setattr(native, "available", lambda: False)
    with pytest.raises(RuntimeError, match="native library unavailable"):
        provenance(require_native=True)
    # Without the requirement the degraded state is TAGGED, not hidden.
    assert provenance()["native_active"] is False


def test_knob_env_values_recorded(monkeypatch):
    monkeypatch.setenv("HAVAC_NATIVE_BUILD", "0")
    monkeypatch.setenv("JAX_COMPILATION_CACHE_DIR", "/cache")
    knobs = provenance()["knobs"]
    assert knobs["HAVAC_NATIVE_BUILD"] == "0"
    assert knobs["JAX_COMPILATION_CACHE_DIR"] == "/cache"


@pytest.mark.parametrize("backend", ["xla", "gpu_interpret"])
def test_run_stats_record_native_state_and_geometry(backend):
    from havac import native
    from havac.engine import Havac
    from havac.io.fasta import SequenceDatabase
    from havac.ops.common import SsvKernelConfig
    from havac.testing.generator import model_from_consensus

    cfg = SsvKernelConfig(block_width=1024, rows_per_strip=8)
    rng = np.random.default_rng(0)
    model = model_from_consensus(
        rng.integers(0, 4, size=40).astype(np.uint8), name="prov")
    seq = rng.integers(0, 4, size=4096).astype(np.uint8)
    db = SequenceDatabase(codes=seq, starts=np.array([0, len(seq) + 1]),
                          lengths=np.array([len(seq)]), names=["s"], seed=0)
    engine = Havac(p_value=0.02, config=cfg, backend=backend)
    engine.load_phmm([model]).load_sequence(db).run()
    assert engine.stats.native_active == native.available()
    geo = engine.stats.chunk_geometry
    if engine.stats.pipeline_prof is not None:  # pipelined backend only
        assert geo is not None
        assert geo["n_col"] * geo["n_row"] == engine.stats.num_chunks
        assert geo["record_cap"] >= 1 and geo["lookahead"] >= 1


def test_native_build_failure_is_loud(monkeypatch):
    """A failed build/load must emit a warning, not degrade silently
    (ADVICE r3 low)."""
    import importlib
    import logging

    import havac.native as native

    monkeypatch.setattr(native, "_lib", None)
    monkeypatch.setattr(native, "_load_failed", False)
    monkeypatch.setattr(native, "_SO", "/nonexistent/libhavac_native.so")
    monkeypatch.setattr(native, "build", lambda quiet=True: False)
    records = []
    handler = logging.Handler()
    handler.emit = lambda rec: records.append(rec)
    logger = logging.getLogger("havac.native")
    logger.addHandler(handler)
    try:
        assert native._load() is None
        assert native._load_failed
        assert any("falling back" in rec.getMessage() for rec in records)
    finally:
        logger.removeHandler(handler)
        importlib.reload(native)  # restore the real module state
