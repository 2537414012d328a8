"""Amino-acid (20-symbol) path: kernel, engine, and encoding exactness.

The reference is nucleotide-only (`README.md:2`); the GPU kernel gathers
amino match scores from a per-row table (`ops/ssv_gpu.py`), the FASTA
encoder takes the 20-residue alphabet, and the engine takes amino model
collections — capability beyond reference parity."""

import io

import numpy as np
import pytest

from havac.engine.api import Havac, HavacUsageError
from havac.io.fasta import AMINO_ORDER, encode_database, load_fasta_database
from havac.io.hmm import read_hmm_text, write_hmm
from havac.ops.common import SsvKernelConfig
from havac.ops.reference import ssv_reference
from havac.scoring.reprojection import project_models
from havac.testing.generator import generate_planted_fixture

CFG = SsvKernelConfig(block_width=1024, rows_per_strip=30)


def hits_set(rows, pos):
    return set(zip(np.asarray(rows).tolist(), np.asarray(pos).tolist()))


def test_gpu_kernel_card20_matches_oracle():
    """Hit-dense cardinality-20 sweep is bit-exact vs the oracle, including
    final row state and carry (the chunk-chaining contracts)."""
    from havac.ops.ssv_gpu import ssv_gpu

    rng = np.random.default_rng(7)
    L, P = 3072 * 2, 90
    sym = rng.integers(0, 20, L).astype(np.uint8)
    sc = rng.integers(-40, 70, (P, 20)).astype(np.int8)
    r, p, fs, fc = ssv_gpu(sym, sc, interpret=True)
    ref, _ = ssv_reference(sym, sc)
    assert r.size > 100
    assert hits_set(r, p) == hits_set(ref.hit_rows, ref.hit_positions)
    np.testing.assert_array_equal(fs, ref.final_row_state)
    np.testing.assert_array_equal(fc, ref.final_carry)


def test_gpu_kernel_card20_column_chaining():
    rng = np.random.default_rng(11)
    from havac.ops.ssv_gpu import ssv_gpu

    sym = rng.integers(0, 20, 3072 * 3).astype(np.uint8)
    sc = rng.integers(-40, 70, (60, 20)).astype(np.int8)
    full, _ = ssv_reference(sym, sc)
    r1, p1, _, fc1 = ssv_gpu(sym[:3072], sc, interpret=True)
    r2, p2, _, fc2 = ssv_gpu(sym[3072:], sc, init_carry=fc1, interpret=True)
    got = hits_set(r1, p1) | hits_set(r2, p2 + 3072)
    assert got == hits_set(full.hit_rows, full.hit_positions)
    np.testing.assert_array_equal(fc2, full.final_carry)


def test_xla_kernel_card20_matches_oracle():
    import jax.numpy as jnp

    from havac.ops.ssv_xla import ssv_scan_xla
    from havac.hits.decode import decode_dense_bitmaps

    rng = np.random.default_rng(13)
    L, P = 2048, 64
    sym = rng.integers(0, 20, L).astype(np.uint8)
    sc = rng.integers(-40, 70, (P, 20)).astype(np.int8)
    bitmaps, fs, fc = ssv_scan_xla(jnp.asarray(sym), jnp.asarray(sc),
                                   jnp.zeros(L, jnp.int32),
                                   jnp.zeros(P + 1, jnp.int32),
                                   rows_per_strip=32)
    rows, pos = decode_dense_bitmaps(np.asarray(bitmaps), 32)
    ref, _ = ssv_reference(sym, sc)
    assert hits_set(rows, pos) == hits_set(ref.hit_rows, ref.hit_positions)
    np.testing.assert_array_equal(np.asarray(fs), ref.final_row_state)
    np.testing.assert_array_equal(np.asarray(fc), ref.final_carry)


def test_amino_engine_end_to_end_matches_oracle():
    """Planted amino fixture through the full engine (HMM text roundtrip,
    amino FASTA encode, pipelined GPU-kernel sweep, resolution) == oracle."""
    models, records = generate_planted_fixture(
        seed=5, model_length=40, sequence_length=9000, num_models=2,
        alphabet="amino")
    buf = io.StringIO()
    write_hmm(models, buf)
    models2 = read_hmm_text(buf.getvalue())
    assert models2[0].alphabet == "amino"
    assert models2[0].match_scores.shape[1] == 20
    np.testing.assert_allclose(models2[0].match_scores,
                               models[0].match_scores, rtol=1e-5)

    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    e = Havac(p_value=0.02, config=CFG, backend="gpu_interpret",
              chunk_symbols=6144, chunk_rows=60)
    e.load_phmm(models2).load_sequence(fasta, is_text=True)
    assert e.alphabet == "amino"
    assert e.database.alphabet == "amino"
    e.run()
    rr, rp = e.raw_hits()
    assert len(e.hits()) > 0
    scores = project_models(models2, 0.02)
    ref, _ = ssv_reference(e.database.codes, scores)
    assert hits_set(rr, rp) == hits_set(ref.hit_rows, ref.hit_positions)


def test_amino_fasta_encoding_ambiguity():
    """Direct residues map in HMMER column order; U→C, O→K; B/Z/J resolve
    to their two options deterministically; X/* resolve uniformly over 20;
    separators/padding get in-range codes."""
    seq = (AMINO_ORDER + "uoUO" + "BZJbzj" + "X*-?").encode()
    db = encode_database(["s"], [seq], pad_multiple=64, alphabet="amino")
    codes = db.codes
    n = len(AMINO_ORDER)
    np.testing.assert_array_equal(codes[:n], np.arange(20, dtype=np.uint8))
    c, k = AMINO_ORDER.index("C"), AMINO_ORDER.index("K")
    np.testing.assert_array_equal(codes[n:n + 4], [c, k, c, k])
    two = {"b": ("D", "N"), "z": ("E", "Q"), "j": ("I", "L")}
    for i, ch in enumerate("bzjbzj"):
        opts = {AMINO_ORDER.index(two[ch][0]), AMINO_ORDER.index(two[ch][1])}
        assert int(codes[n + 4 + i]) in opts
    assert codes.max() < 20  # everything, incl. uniform/separator/pad
    # Deterministic: same seed → identical codes; different seed may differ.
    db2 = encode_database(["s"], [seq], pad_multiple=64, alphabet="amino")
    np.testing.assert_array_equal(codes, db2.codes)


def test_amino_guards():
    dna_models, _ = generate_planted_fixture(seed=1, model_length=16,
                                             sequence_length=512)
    am_models, am_records = generate_planted_fixture(
        seed=2, model_length=16, sequence_length=512, alphabet="amino")
    with pytest.raises(HavacUsageError, match="mixed alphabets"):
        Havac(config=CFG, backend="gpu_interpret").load_phmm(
            dna_models + am_models)
    with pytest.raises(HavacUsageError, match="meaningless for"):
        Havac(config=CFG, backend="gpu_interpret",
              strand="both").load_phmm(am_models)
    # A dna database behind amino models is caught at load.
    e = Havac(config=CFG, backend="gpu_interpret").load_phmm(am_models)
    dna_db = load_fasta_database(("".join(
        f">{n}\n{'ACGT' * 64}\n" for n, _ in am_records)),
        pad_multiple=1024, is_text=True)
    with pytest.raises(HavacUsageError, match="alphabet"):
        e.load_sequence(dna_db)


def test_amino_runs_with_the_default_config():
    """The default geometry serves both alphabets: no amino-specific block
    width, and the GPU kernel and the XLA scan agree on a planted fixture."""
    am_models, records = generate_planted_fixture(
        seed=3, model_length=16, sequence_length=3000, alphabet="amino")
    fasta = "".join(f">{n}\n{s}\n" for n, s in records)
    gpu = Havac(backend="gpu_interpret", chunk_rows=32)
    assert gpu.config == SsvKernelConfig()
    gpu.load_phmm(am_models).load_sequence(fasta, is_text=True).run()
    assert gpu.config == SsvKernelConfig()
    xla = Havac(backend="xla").load_phmm(am_models)
    xla.load_sequence(fasta, is_text=True).run()
    assert len(xla.hits()) > 0
    assert sorted(gpu.hits().as_tuples()) == sorted(xla.hits().as_tuples())


def test_scan_files_encodes_with_the_models_alphabet(tmp_path):
    """scan_files must encode each FASTA with the loaded models' alphabet
    (amino here), exactly like load_sequence does."""
    am_models, records = generate_planted_fixture(
        seed=4, model_length=20, sequence_length=2500, alphabet="amino")
    path = tmp_path / "prot.fasta"
    path.write_text("".join(f">{n}\n{s}\n" for n, s in records))
    e = Havac(p_value=0.05, config=CFG, backend="xla").load_phmm(am_models)
    [(got_path, hits)] = list(e.scan_files([str(path)]))
    assert got_path == str(path) and e.database.alphabet == "amino"
    solo = Havac(p_value=0.05, config=CFG, backend="xla").load_phmm(am_models)
    solo.load_sequence(str(path)).run()
    assert len(hits) > 0
    assert sorted(hits.as_tuples()) == sorted(solo.hits().as_tuples())
