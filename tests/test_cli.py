"""CLI subcommand coverage (in-process main(), CPU/XLA backend)."""

import json

import numpy as np
import pytest

from havac.engine.cli import main
from havac.io.hmm import write_hmm
from havac.testing.generator import generate_planted_fixture


@pytest.fixture(scope="module")
def workdir(tmp_path_factory):
    d = tmp_path_factory.mktemp("cli")
    models, recs = generate_planted_fixture(
        seed=81, model_length=36, sequence_length=2500, num_models=2)
    write_hmm(models, str(d / "m.hmm"))
    (d / "db.fasta").write_text(
        "".join(f">{n}\n{s}\n" for n, s in recs))
    (d / "db2.fasta").write_text(
        "".join(f">{n}2\n{s}\n" for n, s in recs))
    return d


BASE = ["--backend", "xla", "--pvalue", "0.05"]


def test_cli_search(workdir, capsys):
    out = workdir / "hits.tsv"
    rc = main(["search", "--hmm", str(workdir / "m.hmm"),
               "--fasta", str(workdir / "db.fasta"), *BASE,
               "--strand", "both", "--out", str(out)])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert lines[0].startswith("#sequence")
    assert len(lines) > 1
    assert lines[1].count("\t") == 4  # incl strand column


def test_cli_benchmark(workdir, capsys):
    rc = main(["benchmark", "--hmm", str(workdir / "m.hmm"),
               "--fasta", str(workdir / "db.fasta"), *BASE])
    assert rc == 0
    report = json.loads(capsys.readouterr().out)
    assert report["num_hits"] > 0
    assert set(report["phase_seconds"]) >= {"construction", "data_load",
                                            "sweep", "hit_retrieval"}


def test_cli_validate_and_quantize(workdir, capsys, tmp_path):
    # Build a tblout from a search run's own hits.
    out = workdir / "v.tsv"
    main(["search", "--hmm", str(workdir / "m.hmm"),
          "--fasta", str(workdir / "db.fasta"), *BASE, "--out", str(out)])
    capsys.readouterr()
    rows = []
    for line in out.read_text().splitlines()[1:]:
        seq, pos, model, mp, strand = line.split("\t")
        p = int(pos)
        rows.append(f"{seq} - {model} {model} 1 36 {max(1, p - 9)} {p + 11} "
                    f"{max(1, p - 9)} {p + 11} 2500 + 1e-9 30 0 x")
    tbl = tmp_path / "ref.tbl"
    tbl.write_text("\n".join(rows) + "\n")

    rc = main(["validate", "--hmm", str(workdir / "m.hmm"),
               "--fasta", str(workdir / "db.fasta"), *BASE,
               "--tblout", str(tbl)])
    report = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert report["hit_recall"] == 1.0 and report["window_recall"] == 1.0

    rc = main(["quantize", "--hmm", str(workdir / "m.hmm"),
               "--fasta", str(workdir / "db.fasta"), *BASE,
               "--tblout", str(tbl)])
    q = json.loads(capsys.readouterr().out)
    assert rc == 0
    assert q and all("int8_pass_256" in v for v in q.values())


def test_cli_scan(workdir, capsys, tmp_path):
    out = tmp_path / "scan.tsv"
    rc = main(["scan", "--hmm", str(workdir / "m.hmm"),
               str(workdir / "db.fasta"), str(workdir / "db2.fasta"),
               "--backend", "xla", "--pvalue", "0.05", "--out", str(out)])
    assert rc == 0
    lines = out.read_text().splitlines()
    assert lines[0].startswith("#file")
    files = {line.split("\t")[0] for line in lines[1:]}
    assert len(files) == 2


def test_cli_serve(workdir, capsys, monkeypatch, tmp_path):
    """Warm-server loop: requests on stdin, JSON status per request, one
    hits TSV per database; results identical to one-shot search."""
    import io as _io

    out1 = tmp_path / "a.tsv"
    req = (f"{workdir / 'db.fasta'}\t{out1}\n"
           f"{workdir / 'db2.fasta'}\n"
           "quit\n")
    monkeypatch.setattr("sys.stdin", _io.StringIO(req))
    rc = main(["serve", "--hmm", str(workdir / "m.hmm"), *BASE])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert lines[0]["ready"] and lines[0]["models"] == 2
    assert lines[1]["out"] == str(out1) and lines[1]["hits"] > 0
    default_out = str(workdir / "db2.fasta") + ".hits.tsv"
    assert lines[2]["out"] == default_out and lines[2]["hits"] > 0

    # parity with one-shot search on the first database
    ref = tmp_path / "ref.tsv"
    main(["search", "--hmm", str(workdir / "m.hmm"),
          "--fasta", str(workdir / "db.fasta"), *BASE, "--out", str(ref)])
    capsys.readouterr()
    assert out1.read_text() == ref.read_text()

    # a bad request reports an error and does not kill the server
    monkeypatch.setattr("sys.stdin",
                        _io.StringIO("/nonexistent.fasta\nquit\n"))
    rc = main(["serve", "--hmm", str(workdir / "m.hmm"), *BASE])
    assert rc == 0
    lines = [json.loads(ln) for ln in capsys.readouterr().out.splitlines()]
    assert "error" in lines[1]


def test_cli_search_on_the_gpu_kernel_matches_xla(workdir, capsys, tmp_path):
    """The same search through the GPU kernel (interpreted on the CPU) and
    through the XLA scan writes the same hits."""
    outs = {}
    for backend in ("gpu_interpret", "xla"):
        outs[backend] = tmp_path / f"{backend}.tsv"
        rc = main(["search", "--hmm", str(workdir / "m.hmm"),
                   "--fasta", str(workdir / "db.fasta"), "--backend",
                   backend, "--pvalue", "0.05", "--chunk-symbols", "1024",
                   "--out", str(outs[backend])])
        assert rc == 0
    assert len(outs["xla"].read_text().splitlines()) > 1
    assert outs["gpu_interpret"].read_text() == outs["xla"].read_text()


def test_cli_refuses_gpu_backend_without_a_gpu(workdir):
    from havac.engine.api import HavacUsageError

    with pytest.raises(HavacUsageError, match="needs a GPU"):
        main(["search", "--hmm", str(workdir / "m.hmm"),
              "--fasta", str(workdir / "db.fasta"), "--backend", "gpu"])
