"""FASTQ / gzip ingestion (beyond reference: mazu reads FASTA only)."""

import gzip
import os

import numpy as np
import pytest

from mazu_tpu.err import InvalidData
from mazu_tpu.io.fasta import read_fasta
from mazu_tpu.io.fastq import read_fastq, read_seqs

from conftest import TEST_DATA

TINY = os.path.join(TEST_DATA, "cf", "tiny", "tiny")


def test_fastq_basic(tmp_path):
    p = tmp_path / "r.fastq"
    p.write_text(
        "@r1 comment\nACGTACGT\n+\nIIIIIIII\n"
        "@r2\nACGT\nACGT\n+r2\nIIII\nIIII\n"  # multi-line seq + quality
        "@r3\nTTTT\n+\n@@@@\n"  # quality line starting with '@'
    )
    recs = list(read_fastq(str(p)))
    assert recs == [("r1 comment", "ACGTACGT"), ("r2", "ACGTACGT"), ("r3", "TTTT")]


def test_fastq_gz_and_sniffing(tmp_path):
    fq = "@a\nACGTAC\n+\n!!!!!!\n"
    p = tmp_path / "r.fastq.gz"
    with gzip.open(p, "wt") as f:
        f.write(fq)
    assert list(read_fastq(str(p))) == [("a", "ACGTAC")]
    assert list(read_seqs(str(p))) == [("a", "ACGTAC")]
    fa = tmp_path / "r.fa.gz"
    with gzip.open(fa, "wt") as f:
        f.write(">x\nACGT\nAC\n")
    assert list(read_fasta(str(fa))) == [("x", "ACGTAC")]
    assert list(read_seqs(str(fa))) == [("x", "ACGTAC")]


def test_fastq_malformed(tmp_path):
    p = tmp_path / "bad.fastq"
    p.write_text(">r1\nACGT\n+\nIIII\n")  # FASTA header in a .fastq
    with pytest.raises(InvalidData):
        list(read_fastq(str(p)))
    p.write_text("@r1\nACGTACGT\n+\nII\n")  # truncated quality
    with pytest.raises(InvalidData):
        list(read_fastq(str(p)))
    p.write_text("@r1\nACGTACGT\n+\nIIIIIIIIII\n")  # overlong quality
    with pytest.raises(InvalidData):
        list(read_fastq(str(p)))


def test_map_file_fastq_equals_fasta(tmp_path, monkeypatch):
    if not os.path.exists(TINY + ".cf_seg"):
        pytest.skip("fixture missing")
    from mazu_tpu.index.mapping import ReadMapper
    from mazu_tpu.index.piscem_index import piscem_index_from_cf_prefix

    monkeypatch.setenv("MAZU_HBM_BUDGET", "8e9")  # the CPU reports no limit
    idx = piscem_index_from_cf_prefix(TINY, w=3, skew_param=2)
    reads = [seq for _, seq in read_fasta(TINY + ".fa")]
    fq = tmp_path / "reads.fastq.gz"
    with gzip.open(fq, "wt") as f:
        for i, r in enumerate(reads):
            f.write(f"@r{i}\n{r}\n+\n{'I' * len(r)}\n")
    m = ReadMapper(idx)
    a = m.map_reads(reads)
    b = m.map_file(str(fq))
    assert len(a) == len(b)
    for x, y in zip(a, b):
        np.testing.assert_array_equal(x.read_pos, y.read_pos)
        assert x.hits == y.hits
