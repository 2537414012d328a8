"""IO tests: HMMER3 parser/writer round-trip, FASTA encoding, coordinate maps."""

import numpy as np
import pytest

from havac.io.fasta import (
    encode_database,
    load_fasta_database,
    pack_2bit,
    parse_fasta_text,
    unpack_2bit,
)
from havac.io.hmm import (
    HmmFormatError,
    model_length_prefix_sums,
    read_hmm_text,
    write_hmm,
)
from havac.testing.generator import model_from_consensus

import io as _io


SAMPLE_HMM = """HMMER3/f [3.3.2 | Nov 2020]
NAME  toy-1
ACC   RF99999.1
LENG  3
MAXL  12
ALPH  DNA
STATS LOCAL MSV       -9.8664  0.71313
STATS LOCAL VITERBI  -10.7223  0.71313
STATS LOCAL FORWARD   -4.1215  0.71313
HMM          A        C        G        T
            m->m     m->i     m->d     i->m     i->i     d->m     d->d
  COMPO   1.38629  1.38629  1.38629  1.38629
          1.38629  1.38629  1.38629  1.38629
          0.03156  3.85855  4.58100  0.61958  0.77255  0.00000        *
      1   0.01467  5.21781  5.30731  5.52016      1 a - - -
          1.38629  1.38629  1.38629  1.38629
          0.03156  3.85855  4.58100  0.61958  0.77255  0.34958  1.22291
      2   5.01467  0.21781  5.30731  5.52016      2 c - - -
          1.38629  1.38629  1.38629  1.38629
          0.03156  3.85855  4.58100  0.61958  0.77255  0.34958  1.22291
      3   5.01467  5.21781  5.30731        *      3 g - - -
          1.38629  1.38629  1.38629  1.38629
          0.03156  3.85855  4.58100  0.61958  0.77255  0.34958  1.22291
//
"""


def test_parse_single_model():
    models = read_hmm_text(SAMPLE_HMM)
    assert len(models) == 1
    m = models[0]
    assert m.name == "toy-1"
    assert m.accession == "RF99999.1"
    assert m.model_length == 3
    assert m.max_length == 12
    assert m.alphabet == "dna"
    assert m.msv_mu == pytest.approx(-9.8664)
    assert m.msv_lambda == pytest.approx(0.71313)
    assert m.match_scores.shape == (3, 4)
    assert m.match_scores[0, 0] == pytest.approx(0.01467)
    assert np.isinf(m.match_scores[2, 3])  # '*' token


def test_parse_multiple_models_and_prefix_sums():
    models = read_hmm_text(SAMPLE_HMM + "\n" + SAMPLE_HMM.replace("toy-1", "toy-2"))
    assert [m.name for m in models] == ["toy-1", "toy-2"]
    prefix = model_length_prefix_sums(models)
    assert prefix.tolist() == [0, 3, 6]


def test_writer_roundtrip():
    rng = np.random.default_rng(3)
    consensus = rng.integers(0, 4, size=17)
    original = model_from_consensus(consensus, name="rt-model")
    buf = _io.StringIO()
    write_hmm([original, original], buf)
    models = read_hmm_text(buf.getvalue())
    assert len(models) == 2
    m = models[0]
    assert m.name == "rt-model"
    assert m.model_length == original.model_length
    assert m.max_length == original.max_length
    assert m.msv_mu == pytest.approx(original.msv_mu, abs=1e-4)
    np.testing.assert_allclose(m.match_scores, original.match_scores, atol=1e-5)


def test_parser_rejects_garbage():
    with pytest.raises(HmmFormatError):
        read_hmm_text("not an hmm file\n")
    with pytest.raises(HmmFormatError):
        read_hmm_text(SAMPLE_HMM.replace("STATS LOCAL MSV", "STATS LOCAL XXX"))


def test_fasta_parse_and_encode_layout():
    names, seqs = parse_fasta_text(">s1 desc here\nACGT\nACG\n>s2\nTTTT\n")
    assert names == ["s1", "s2"]
    assert seqs == [b"ACGTACG", b"TTTT"]
    db = encode_database(names, seqs, pad_multiple=16)
    # layout: 7 symbols, SEP, 4 symbols, SEP = 13 concat, padded to 16
    assert db.concatenated_length == 13
    assert db.padded_length == 16
    np.testing.assert_array_equal(db.codes[:7], [0, 1, 2, 3, 0, 1, 2])
    np.testing.assert_array_equal(db.codes[8:12], [3, 3, 3, 3])
    assert db.codes.max() <= 3


def test_global_to_local_mapping_drops_separators_and_padding():
    db = encode_database(["a", "b"], [b"ACGT", b"GG"], pad_multiple=12)
    gp = np.array([0, 3, 4, 5, 6, 7, 8, 11, 100])
    idx, local, valid = db.global_to_local(gp)
    # positions: 0-3 seq0, 4 SEP, 5-6 seq1, 7 SEP, 8+ padding
    assert valid.tolist() == [True, True, False, True, True, False, False, False, False]
    assert idx[0] == 0 and local[0] == 0
    assert idx[1] == 0 and local[1] == 3
    assert idx[3] == 1 and local[3] == 0
    assert idx[4] == 1 and local[4] == 1


def test_ambiguity_codes_deterministic_and_constrained():
    seq = b"RYSWKMNRYSWKMN" * 4
    db1 = encode_database(["x"], [seq], seed=123)
    db2 = encode_database(["x"], [seq], seed=123)
    np.testing.assert_array_equal(db1.codes, db2.codes)
    db3 = encode_database(["x"], [seq], seed=124)
    assert not np.array_equal(db1.codes, db3.codes)
    # Two-way codes stay within their pair (R = A/G etc.)
    L = len(seq)
    for offset, allowed in [(0, {0, 2}), (1, {1, 3}), (2, {1, 2}), (3, {0, 3}), (4, {2, 3}), (5, {0, 1})]:
        vals = set(db1.codes[np.arange(offset, L, 14)].tolist())
        assert vals <= allowed


def test_pack_unpack_roundtrip():
    rng = np.random.default_rng(0)
    codes = rng.integers(0, 4, size=1001).astype(np.uint8)
    packed = pack_2bit(codes)
    assert packed.shape[0] == (1001 + 3) // 4
    np.testing.assert_array_equal(unpack_2bit(packed, 1001), codes)
    # bit layout matches the reference: symbol 0 in the low 2 bits
    assert pack_2bit(np.array([1, 2, 3, 0], dtype=np.uint8))[0] == 1 | (2 << 2) | (3 << 4)
