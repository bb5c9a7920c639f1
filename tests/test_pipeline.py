"""PipelinedIndexQuery must return exactly ModIndex's answers."""

import numpy as np

from mazu_tpu.index.pipeline import PipelinedIndexQuery
from mazu_tpu.synth import toy_index


def test_pipelined_eager_matches_modindex():
    from mazu_tpu.kmer import revcomp

    idx = toy_index(n_seqs=256, seq_len=500, skew_param=64)
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(9)
    n = 2048
    work = np.tile(kms, -(-n // len(kms)))[:n]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], idx.k)
    miss = rng.random(n) < 0.05
    work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)

    pq = PipelinedIndexQuery(idx, batch=n, n_chunks=2)
    got = pq.get_ref_pos_eager(work)
    want = idx.get_ref_pos_eager(work)
    assert got == want


def test_pipelined_multi_batch():
    idx = toy_index(n_seqs=256, seq_len=500, skew_param=64)
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    n = 1024
    b1 = kms[:n].copy()
    b2 = kms[n : 2 * n].copy()
    pq = PipelinedIndexQuery(idx, batch=n, n_chunks=2)
    mains, overflows = pq.query_batches([b1, b2])
    assert len(mains) == 2 and len(overflows) == 2
    for i, b in enumerate((b1, b2)):
        lanes, rows = overflows[i]
        # every lane is either exact in main (non-overflow) or covered
        covered = np.zeros(n, dtype=bool)
        covered[lanes] = True
        m = mains[i]
        assert ((m["mt"] > 0) | covered | (m["mt"] == 0)).all()
        if len(lanes):
            assert (rows["mt"] >= 0).all()
