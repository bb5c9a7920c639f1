"""Array-native serving decode: BatchHits CSR
results must equal the legacy per-k-mer list decode exactly on both
serving drivers, and ReadMapper must stay on the array path."""

import numpy as np
import pytest


@pytest.fixture(scope="module")
def chr7_idx():
    """Seeded index: 256 unitigs of 500 bases with planted heavy and
    mid-depth minimizer buckets (mazu_tpu.synth.toy_spt)."""
    from mazu_tpu.synth import toy_index

    return toy_index(n_seqs=256, seq_len=500, skew_param=4)


def _work(idx, n=3000, seed=3):
    from mazu_tpu.kmer import revcomp

    us = idx.k2u.unitigs
    kms = np.asarray(us.get_kmer_u64(us.kmer_start_positions()[:n]))
    rng = np.random.default_rng(seed)
    kms[::7] = rng.integers(0, 1 << 62, len(kms[::7]), dtype=np.uint64)
    flip = rng.random(len(kms)) < 0.5
    kms[flip] = revcomp(kms[flip], idx.k)
    return kms


def test_twophase_batch_equals_eager(chr7_idx):
    from mazu_tpu.index.twophase import TwoPhaseIndexQuery

    tp = TwoPhaseIndexQuery(chr7_idx)
    kms = _work(chr7_idx)
    bh = tp.get_ref_pos_batch(kms)
    assert int(bh.offsets[-1]) == len(bh.ref_id)
    assert bh.to_lists() == tp.get_ref_pos_eager(kms)


def test_compact_batch_equals_eager(chr7_idx):
    from mazu_tpu.index.mapping import CompactQuery
    from mazu_tpu.index.tuning import tuned_query_config

    cfg = tuned_query_config(chr7_idx.k2u, hbm_budget=1 << 20)
    cq = CompactQuery(chr7_idx, cfg)
    kms = _work(chr7_idx, seed=5)
    bh = cq.get_ref_pos_batch(kms)
    # eager is the shim over the same batch — cross-check vs the padded oracle
    lists = bh.to_lists()
    want = chr7_idx.get_ref_pos_eager(kms[:512])
    for x, y in zip(lists[:512], want):
        assert (x is None) == (y is None)
        if x is not None:
            assert sorted(x) == sorted(y)


def test_readmapper_array_path_and_lazy_hits(chr7_idx, monkeypatch):
    from mazu_tpu.index.mapping import ReadMapper
    from mazu_tpu.kmer import codes_to_seq

    monkeypatch.setenv("MAZU_HBM_BUDGET", "8e9")  # the CPU reports no limit
    idx = chr7_idx
    rng = np.random.default_rng(11)
    us = idx.k2u.unitigs  # piscem refs are lengths-only; read from useq
    u = int(np.argmax(np.diff(us.accum)))
    seq = codes_to_seq(
        us.useq.get_base(np.arange(int(us.accum[u]), int(us.accum[u + 1])))
    )
    reads = []
    for _ in range(64):
        s = int(rng.integers(0, len(seq) - 150))
        reads.append(seq[s : s + 150])
    reads[3] = reads[3][:50] + "N" + reads[3][51:]  # window restart
    reads.append("N" * 40)  # zero valid k-mers
    m = ReadMapper(idx)
    assert m.config.tier == "speed" and type(m.tp).__name__ == "TwoPhaseIndexQuery"
    out = m.map_reads(reads)
    # the mapper must be on the array path: hits decode lazily
    assert out[0]._hits is None and out[0]._batch is not None
    assert out[0].n_hit > 0  # counted from arrays, no list decode
    assert out[0]._hits is None
    # legacy list API agrees with a direct eager query of the same windows
    from mazu_tpu.index.validate import valid_kmer_windows

    for i in (0, 3, 64):
        _, w = valid_kmer_windows(reads[i], idx.k)
        want = m.tp.get_ref_pos_eager(w) if len(w) else []
        assert out[i].hits == want
    # CSR accessor consistency
    offs, rid, rpo, orn = out[0].csr()
    assert offs[0] == 0 and int(offs[-1]) == len(rid)
    h = out[0].hits
    j = 0
    for i, hh in enumerate(h):
        if hh is None:
            assert offs[i] == offs[i + 1]
            continue
        assert [tuple(t) for t in hh] == list(
            zip(
                rid[offs[i] : offs[i + 1]].tolist(),
                rpo[offs[i] : offs[i + 1]].tolist(),
                orn[offs[i] : offs[i + 1]].tolist(),
            )
        )
        j += 1
    assert j == out[0].n_hit
