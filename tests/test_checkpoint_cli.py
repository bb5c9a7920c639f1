"""Checkpoint save/load roundtrips and CLI end-to-end flows
(reference parity: src/bin/index/main.rs, src/bin/kphf/main.rs)."""

import os
import tempfile

import numpy as np
import pytest

from mazu_tpu.index.piscem_index import (
    piscem_index_from_cf_prefix,
    pufferfish_dense_index_from_cf_prefix,
)
from mazu_tpu.index.validate import validate_fasta, validate_k2u_self
from mazu_tpu.io.checkpoint import load_index, load_k2u, save_index, save_k2u

from conftest import TEST_DATA

TINY = os.path.join(TEST_DATA, "cf", "tiny", "tiny")
TINY_FA = TINY + ".fa"


def _tmp(suffix=".npz"):
    f = tempfile.NamedTemporaryFile(suffix=suffix, delete=False)
    f.close()
    return f.name


@pytest.mark.parametrize("flavor", ["piscem", "pufferfish"])
def test_index_roundtrip(flavor):
    if not os.path.exists(TINY + ".cf_seg"):
        pytest.skip("fixture missing")
    if flavor == "piscem":
        idx = piscem_index_from_cf_prefix(TINY, w=3, skew_param=2)
    else:
        idx = pufferfish_dense_index_from_cf_prefix(TINY)
    p = _tmp()
    save_index(idx, p)
    idx2 = load_index(p)
    assert idx2.index_type == idx.index_type
    assert idx2.k == idx.k
    assert idx2.u2pos.ref_names == idx.u2pos.ref_names
    validate_fasta(idx2, TINY_FA)
    os.unlink(p)


def test_sparse_k2u_roundtrip():
    sparse_dir = os.path.join(TEST_DATA, "pf1", "small_txome_index_sparse")
    if not os.path.isdir(sparse_dir):
        pytest.skip("fixture missing")
    from mazu_tpu.io.pf1_index import load_sparse_index

    k2u = load_sparse_index(sparse_dir).k2u
    p = _tmp()
    save_k2u(k2u, p)
    k2u2 = load_k2u(p)
    assert k2u2.sample_size == k2u.sample_size
    validate_k2u_self(k2u2)
    os.unlink(p)


def test_cli_flows(capsys):
    if not os.path.exists(TINY + ".cf_seg"):
        pytest.skip("fixture missing")
    from mazu_tpu.cli import main

    out = _tmp()
    assert main(["index", "build", "piscem", "-p", TINY, "-o", out, "-m", "3", "-s", "2"]) == 0
    assert main(["index", "validate-fasta", "-i", out, "-f", TINY_FA]) == 0
    assert main(["index", "validate-fasta", "-i", out, "-f", TINY_FA, "--streaming"]) == 0

    ko = _tmp()
    assert main(["kphf", "build", "sshash", "-p", TINY, "-o", ko, "-m", "3", "--validate"]) == 0
    assert main(["kphf", "validate", "-i", ko]) == 0
    assert main(["kphf", "stats", "-i", ko]) == 0
    assert main(["kphf", "bench", "-i", ko, "-f", TINY_FA]) == 0
    txt = capsys.readouterr().out
    assert "16 queries, 16 hits, 0 misses" in txt
    os.unlink(out)
    os.unlink(ko)


def test_cli_direct_engine():
    if not os.path.exists(TINY + ".cf_seg"):
        pytest.skip("fixture missing")
    from mazu_tpu.cli import main

    out = _tmp()
    assert (
        main(
            ["index", "build", "piscem", "-p", TINY, "-o", out, "-m", "3", "-s", "2",
             "--engine", "direct"]
        )
        == 0
    )
    assert main(["index", "validate-fasta", "-i", out, "-f", TINY_FA]) == 0
    os.unlink(out)


def test_read_mapper_and_cli_map(monkeypatch):
    if not os.path.exists(TINY + ".cf_seg"):
        pytest.skip("fixture missing")
    from mazu_tpu.cli import main
    from mazu_tpu.index.mapping import ReadMapper

    monkeypatch.setenv("MAZU_HBM_BUDGET", "8e9")  # the CPU reports no limit
    idx = piscem_index_from_cf_prefix(TINY, w=3, skew_param=2, engine="direct")
    mapper = ReadMapper(idx)
    results = mapper.map_fasta(TINY_FA)
    assert len(results) == 2
    for r in results:
        assert r.n_kmers == r.n_hit  # every indexed k-mer maps
        for h in r.hits:
            assert h is not None and len(h) >= 1
    # a read with a foreign k-mer
    res = mapper.map_reads(["AAAAAAA", "CACACAC"])
    assert res[0].hits[0] is None
    assert res[1].hits[0] is not None

    out = _tmp()
    assert main(["index", "build", "piscem", "-p", TINY, "-o", out, "-m", "3",
                 "-s", "2", "--engine", "direct"]) == 0
    assert main(["index", "map", "-i", out, "-f", TINY_FA]) == 0
    os.unlink(out)


def _seeded_index(engine):
    """32 seeded unitigs with planted minimizer buckets and
    three-occurrence unitigs (mazu_tpu.synth.toy_spt), w=5."""
    from mazu_tpu.index.piscem_index import piscem_index_from_spt
    from mazu_tpu.synth import toy_spt

    return piscem_index_from_spt(toy_spt(w=5, seed=1)[0], 5, 64, engine=engine)


@pytest.mark.parametrize("engine", ["direct", "mono2"])
def test_cli_map_seeded(tmp_path, monkeypatch, capsys, engine):
    """`index map` on a saved seeded index (the SSHash speed tier serves
    through TwoPhaseIndexQuery, mono2 through CompactQuery): every k-mer of
    reads cut from the unitigs hits. The CPU
    reports no memory limit, so the SSHash budget comes from
    MAZU_HBM_BUDGET, and without it the tuner refuses."""
    from mazu_tpu.cli import main
    from mazu_tpu.kmer import codes_to_seq

    idx = _seeded_index(engine)
    p = str(tmp_path / "idx.npz")
    save_index(idx, p)
    us = idx.k2u.unitigs
    fa = tmp_path / "reads.fa"
    lens = np.diff(us.accum)[:4]
    with open(fa, "w") as f:
        for u in range(4):
            bases = us.useq.get_base(np.arange(int(us.accum[u]), int(us.accum[u + 1])))
            f.write(f">r{u}\n{codes_to_seq(bases)}\n")
    n = int((lens - idx.k + 1).sum())
    monkeypatch.delenv("MAZU_HBM_BUDGET", raising=False)
    if engine == "direct":  # a KCDict has one layout and needs no budget
        with pytest.raises(ValueError, match="no memory limit"):
            main(["index", "map", "-i", p, "-f", str(fa)])
    monkeypatch.setenv("MAZU_HBM_BUDGET", "8e9")
    assert main(["index", "map", "-i", p, "-f", str(fa)]) == 0
    assert f"4 reads, {n} k-mers, {n} hits" in capsys.readouterr().out


def test_provenance_metadata_roundtrip(tmp_path):
    """BaseIndex-style provenance (version/type/metadata incl. name hashes)
    survives save/load (parity: reference src/index.rs:221-300)."""
    from mazu_tpu import get_mazu_tpu_version
    from mazu_tpu.index.modindex import index_metadata
    idx = _seeded_index("direct")
    idx.metadata = index_metadata(idx.refs)
    assert idx.version == get_mazu_tpu_version()
    p = str(tmp_path / "idx.npz")
    save_index(idx, p)
    back = load_index(p)
    assert back.version == idx.version
    assert back.index_type == idx.index_type
    assert back.metadata["sha256_names"] == idx.metadata["sha256_names"]
    assert back.metadata["num_decoys"] == 0
    # full reference field parity (src/index.rs:266-278) roundtrips
    for f in (
        "have_edge_vec", "name_hash_512", "seq_hash_512", "decoy_name_hash",
        "decoy_seq_hash", "first_decoy_index", "keep_duplicates",
    ):
        assert back.metadata[f] == idx.metadata[f], f
    assert len(idx.metadata["name_hash_512"]) == 128
    assert idx.metadata["first_decoy_index"] == idx.refs.n_refs
    assert idx.metadata["keep_duplicates"] is False
    # decoy hashes: trailing refs counted as decoys hash deterministically
    md = index_metadata(idx.refs, decoys=1, keep_duplicates=True)
    assert md["num_decoys"] == 1
    assert md["first_decoy_index"] == idx.refs.n_refs - 1
    assert len(md["decoy_name_hash"]) == 64
    if idx.refs.has_seq:
        assert len(md["decoy_seq_hash"]) == 64
    assert md["keep_duplicates"] is True


def test_reverse_match_type():
    import numpy as np

    from mazu_tpu.kmer import reverse_match_type

    mt = np.array([0, 1, 2, 1], dtype=np.uint8)
    assert (reverse_match_type(mt) == np.array([0, 2, 1, 2])).all()


def test_kcdict_checkpoint_roundtrip():
    from mazu_tpu.index.modindex import get_ref_pos_padded

    idx = _seeded_index("cuckoo")
    p = _tmp()
    save_index(idx, p)
    back = load_index(p)
    assert back.k2u.__class__.__name__ == "KCDict"
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    a = get_ref_pos_padded(idx.device_arrays(fused=True), kms, np, max(1, idx.max_occs()))
    b = get_ref_pos_padded(back.device_arrays(fused=True), kms, np, max(1, back.max_occs()))
    np.testing.assert_array_equal(a["mt"], b["mt"])
    np.testing.assert_array_equal(a["ref_pos"], b["ref_pos"])
    os.unlink(p)


def test_cli_validate_pf1_directory(capsys, test_data_dir):
    """validate-fasta accepts a pufferfish C++ index DIRECTORY directly
    (byte parity with the C++ serialization: needs the reference's files)."""
    from mazu_tpu.cli import main as cli_main

    rc = cli_main(
        [
            "index",
            "validate-fasta",
            "-i",
            os.path.join(test_data_dir, "pf1", "small_txome_index"),
            "-f",
            os.path.join(test_data_dir, "pf1", "small_txome.fa"),
        ]
    )
    assert not rc
    assert "valid" in capsys.readouterr().out


def test_cli_missing_index_clean_error(capsys):
    from mazu_tpu.cli import main as cli_main

    rc = cli_main(["index", "validate-fasta", "-i", "/tmp/nope.npz", "-f", "x.fa"])
    assert rc == 1
    assert "no such file" in capsys.readouterr().err


def test_cli_sampled_build(tmp_path):
    """kphf build sampled: BUILD of the sparse dictionary (reference
    todo!(), src/kphf/pfhash.rs:160-162) through the CLI, checkpoint
    roundtrip, re-validate."""
    if not os.path.exists(TINY + ".cf_seg"):
        pytest.skip("fixture missing")
    from mazu_tpu.cli import main

    ko = str(tmp_path / "sampled.npz")
    assert (
        main(
            [
                "kphf", "build", "sampled", "-p", TINY, "-o", ko,
                "--sample-size", "3", "--extension-size", "2", "--validate",
            ]
        )
        == 0
    )
    assert main(["kphf", "validate", "-i", ko]) == 0
    assert main(["kphf", "stats", "-i", ko]) == 0


def test_index_roundtrip_uncompressed():
    """compress=False (STORE-only npz) — the Gbp capacity-tier checkpoint
    path (host_gbp_build.py) — must roundtrip identically."""
    if not os.path.exists(TINY + ".cf_seg"):
        pytest.skip("fixture missing")
    idx = piscem_index_from_cf_prefix(TINY, w=3, skew_param=8, engine="fast32")
    p = _tmp()
    save_index(idx, p, compress=False)
    idx2 = load_index(p)
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    assert idx2.get_ref_pos_eager(kms) == idx.get_ref_pos_eager(kms)
    validate_fasta(idx2, TINY_FA)
    os.unlink(p)
