"""Native (C++) vs pure-Python ingestion parity.

The native library must produce byte-identical databases and models — same
encode table, same SplitMix64 ambiguity/separator randomization, same float
narrowing — so the two paths are interchangeable (SURVEY.md §2.4).
"""

import os
import subprocess

import numpy as np
import pytest

from havac import native
from havac.io.fasta import load_fasta_database
from havac.io.hmm import read_hmm, write_hmm
from havac.testing.generator import generate_planted_fixture


@pytest.fixture(scope="session", autouse=True)
def built_native():
    if not native.available():
        assert native.build(), "failed to build libhavac_native.so"
        # reset the failed-load latch
        native._load_failed = False
    assert native.available()


def test_fasta_parity_with_ambiguity_codes(tmp_path):
    fa = tmp_path / "db.fasta"
    fa.write_text(
        ">seq1 first description\n"
        "ACGTacgtUuNnRYSWKMryswkm\n"
        "GGGCCC\n"
        ">seq2\n"
        "TTTTXXXBDHV\n"
        ">empty\n"
        ">seq3\n"
        "acgt\n")
    for pad in (1, 1024):
        dn = load_fasta_database(str(fa), pad_multiple=pad, native="always")
        dp = load_fasta_database(str(fa), pad_multiple=pad, native="never")
        assert dn.names == dp.names
        np.testing.assert_array_equal(dn.lengths, dp.lengths)
        np.testing.assert_array_equal(dn.starts, dp.starts)
        np.testing.assert_array_equal(dn.codes, dp.codes)


def test_fasta_parity_large_random(tmp_path):
    rng = np.random.default_rng(0)
    alpha = np.frombuffer(b"ACGTNRYSWKMacgtn", dtype=np.uint8)
    recs = []
    for i in range(20):
        n = int(rng.integers(1, 5000))
        recs.append((f"s{i}", bytes(rng.choice(alpha, size=n)).decode()))
    fa = tmp_path / "big.fasta"
    fa.write_text("".join(f">{n}\n{s}\n" for n, s in recs))
    dn = load_fasta_database(str(fa), pad_multiple=3072, native="always")
    dp = load_fasta_database(str(fa), pad_multiple=3072, native="never")
    np.testing.assert_array_equal(dn.codes, dp.codes)
    np.testing.assert_array_equal(dn.starts, dp.starts)


def test_hmm_parity(tmp_path):
    models, _ = generate_planted_fixture(seed=3, model_length=85,
                                         sequence_length=100, num_models=4)
    # exercise '*' tokens too
    models[1].match_scores[7, 2] = np.inf
    path = tmp_path / "m.hmm"
    write_hmm(models, str(path))
    mn = read_hmm(str(path), native="always")
    mp = read_hmm(str(path), native="never")
    assert len(mn) == len(mp) == 4
    for a, b in zip(mn, mp):
        assert a.name == b.name
        assert a.accession == b.accession
        assert a.model_length == b.model_length
        assert a.max_length == b.max_length
        assert a.alphabet == b.alphabet
        assert a.msv_mu == b.msv_mu
        assert a.msv_lambda == b.msv_lambda
        np.testing.assert_array_equal(a.match_scores, b.match_scores)


def test_native_error_reporting(tmp_path):
    bad = tmp_path / "bad.hmm"
    bad.write_text("HMMER3/f\nNAME x\n")  # no HMM section
    with pytest.raises(native.NativeParseError):
        native.read_hmm_native(str(bad))
    badfa = tmp_path / "bad.fasta"
    badfa.write_text("ACGT\n>late\nACGT\n")
    with pytest.raises(native.NativeParseError):
        native.read_fasta_encoded(str(badfa))


def test_native_malformed_inputs_error_cleanly(tmp_path):
    """Binary garbage, truncated models, and missing files must surface as
    parse errors through the ctypes path — never crashes."""
    rng = np.random.default_rng(7)
    garbage = tmp_path / "garbage.bin"
    garbage.write_bytes(rng.integers(0, 256, size=4096).astype(np.uint8)
                        .tobytes())
    trunc = tmp_path / "trunc.hmm"
    trunc.write_text(
        "HMMER3/f [3.1b2]\nNAME t\nLENG 50\nALPH DNA\n"
        "STATS LOCAL MSV -9.0 0.7\nHMM A C G T\n   m->m\n"
        "  1 0.1 0.2 0.3 0.4\n")  # 1 of 50 rows, no //
    for path in (garbage, trunc):
        with pytest.raises(native.NativeParseError):
            native.read_hmm_native(str(path))
    with pytest.raises(native.NativeParseError):
        native.read_fasta_encoded(str(garbage))
    with pytest.raises(native.NativeParseError):
        native.read_fasta_encoded(str(tmp_path / "missing.fasta"))


def test_asan_selftest_on_malformed_inputs(tmp_path):
    """Build the ASan debug target (`make debug`, the reference's per-tool
    sanitizer build, test/hmmerValidation/makefile:19-20) and drive the
    self-test binary over malformed inputs: any heap error aborts nonzero."""
    native_dir = os.path.dirname(os.path.abspath(native.__file__))
    build = subprocess.run(["make", "-C", native_dir, "debug"],
                           capture_output=True, timeout=300)
    if build.returncode != 0:
        pytest.skip(f"ASan build unavailable: {build.stderr.decode()[:200]}")
    exe = os.path.join(native_dir, "havac_native_selftest")
    rng = np.random.default_rng(11)
    garbage = tmp_path / "g.bin"
    garbage.write_bytes(rng.integers(0, 256, size=2048).astype(np.uint8)
                        .tobytes())
    okfa = tmp_path / "ok.fasta"
    okfa.write_text(">a\nACGTRYN\n>b\nTTTT\n")
    trunc = tmp_path / "t.hmm"
    trunc.write_text("HMMER3/f\nNAME t\nLENG 9\nALPH DNA\n"
                     "STATS LOCAL MSV -9.0 0.7\nHMM A C G T\nx\n"
                     "  1 0.1 0.2 0.3 0.4\n")
    res = subprocess.run(
        [exe, str(garbage), str(okfa), str(trunc), "/nonexistent"],
        capture_output=True, timeout=120)
    assert res.returncode == 0, res.stderr.decode()[:500]
    out = res.stdout.decode()
    assert "undersized->-1" in out  # oversize-write guard engaged
    assert "ERROR" in out  # malformed inputs reported, not crashed


def test_native_sort_hits_parity():
    from havac.ops.common import hit_sort_order

    rng = np.random.default_rng(6)
    rows = rng.integers(0, 200_000, size=300_001).astype(np.int64)
    pos = rng.integers(0, 50_000_000, size=300_001).astype(np.int64)
    order = hit_sort_order(rows, pos)
    want = (rows[order].copy(), pos[order].copy())
    r2, p2 = rows.copy(), pos.copy()
    assert native.sort_hits_native(r2, p2)
    np.testing.assert_array_equal(r2, want[0])
    np.testing.assert_array_equal(p2, want[1])


def test_native_resolve_hits_parity():
    from havac.hits.decode import _resolve_block
    from havac.io.fasta import SequenceDatabase

    rng = np.random.default_rng(7)
    lengths = np.array([1000, 1, 2500, 700], dtype=np.int64)
    starts = np.concatenate([[0], np.cumsum(lengths + 1)])
    L = int(starts[-1]) + 64  # trailing pad region
    db = SequenceDatabase(codes=np.zeros(L, dtype=np.uint8), starts=starts,
                          lengths=lengths, names=list("abcd"), seed=0)
    prefix = np.array([0, 40, 41, 200, 377], dtype=np.int64)
    n = 100_000
    rows = rng.integers(-2, 400, size=n).astype(np.int64)  # incl. out-of-range
    pos = rng.integers(-2, L + 10, size=n).astype(np.int64)
    got = native.resolve_hits_native(rows, pos, starts, lengths, prefix)
    assert got is not None
    want = _resolve_block(rows, pos, db, prefix)
    np.testing.assert_array_equal(got[0], want.sequence_index)
    np.testing.assert_array_equal(got[1], want.sequence_position)
    np.testing.assert_array_equal(got[2], want.phmm_index)
    np.testing.assert_array_equal(got[3], want.phmm_position)


def test_native_merge_runs_parity():
    from havac.ops.common import hit_sort_order

    rng = np.random.default_rng(8)
    for k in (2, 3, 7, 16):
        parts = []
        for _ in range(k):
            n = int(rng.integers(0, 20_000))
            r = rng.integers(0, 100_000, size=n).astype(np.int64)
            p = rng.integers(0, 1 << 22, size=n).astype(np.int64)
            o = hit_sort_order(r, p)
            parts.append((r[o], p[o]))
        rows = np.concatenate([r for r, _ in parts])
        pos = np.concatenate([p for _, p in parts])
        offs = np.cumsum([0] + [r.size for r, _ in parts])
        order = native.merge_runs_native(rows, pos, offs)
        assert order is not None
        want = hit_sort_order(rows, pos)
        np.testing.assert_array_equal(rows[order], rows[want])
        np.testing.assert_array_equal(pos[order], pos[want])
    # Out-of-key-range coordinates must refuse (caller falls back to sort).
    big = np.array([1 << 40], dtype=np.int64)
    assert native.merge_runs_native(big, big, np.array([0, 1])) is None
