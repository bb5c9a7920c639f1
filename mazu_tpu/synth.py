"""Seeded synthetic indexes: the fixtures of the tests, the chip smoke run
and the benchmark, built from a seed with no files.

- ``toy_index``: a small index whose build plants the hard query branches
  (a heavy skew bucket, a mid-depth phase-2B bucket, unitigs with three
  reference occurrences) and asserts that they are present.
- ``genome_parts`` / ``genome_index``: a uniform random genome cut into
  10 kbp unitigs, each its own reference, at any size. Every k-mer occurs
  once (w.h.p.), so a read cut from the genome maps back to where it was
  cut.
- ``kmer_workload``: a query batch of indexed k-mers, forward and
  reverse-complement mixed, with a share of random misses.
"""

from __future__ import annotations

import numpy as np

GENOME_PIECE = 10_000  # bases per unitig (and reference) of genome_parts


def toy_spt(n_seqs=32, seq_len=200, k=31, w=15, seed=0):
    """(SPT, seqs): random sequences with planted minimizer buckets.

    - a low-hash w-mer planted at ~24 sites makes one HEAVY minimizer
      bucket (a skew bucket under a small ``skew_param``, a deep probe
      otherwise),
    - a second low-hash w-mer at 5 sites makes a MID-depth bucket
      (deeper than the shallow probe limits -> phase-2B re-probe lanes),
    - six unitigs carry 3 reference occurrences (mixed orientation), so
      max_occs > 2 -> the type-A occurrence-wide phase runs.

    Each sequence is one unitig and its own reference; the two extra
    occurrences of the six multi-occurrence unitigs point at others.
    """
    from .containers.unitig_set import UnitigSet
    from .index.spt import SPT
    from .kphf.boophf32 import mix32

    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, (n_seqs, seq_len))
    # plant shared w-mers chosen to score LOW under the hash32 minimizer
    # ordering (mix32 of the w-mer's low 32 bits), so windows containing
    # them overwhelmingly bucket under them
    cand = rng.integers(0, 1 << (2 * w), 8192, dtype=np.uint64)
    order = np.argsort(np.asarray(mix32(cand.astype(np.uint32))))
    heavy_w, mid_w = int(cand[order[0]]), int(cand[order[1]])

    def put(row, off, wmer):
        for j in range(w):  # LSB-first 2-bit convention
            codes[row, off + j] = (wmer >> (2 * j)) & 3

    span = seq_len - w - 40  # planting window (clear of the mid site)
    for i in range(24):  # heavy bucket: ~24 distinct super-k-mer sites
        put(i % n_seqs, 20 + (29 * i) % span, heavy_w)
    for i in range(5):  # mid bucket: deeper than plim=2, below skew_param
        put((7 * i + 3) % n_seqs, seq_len - w - 5, mid_w)
    alpha = np.array(list("ACGT"))
    seqs = ["".join(alpha[codes[i]]) for i in range(n_seqs)]
    unitigs = UnitigSet.from_seqs(seqs, k)
    n = unitigs.n_unitigs
    extra = 6
    # spread over the set, so a batch of the first few thousand k-mers
    # holds one of them (unitig 8), not a majority of multi-occ lanes
    multi = (8 + np.arange(extra) * (n // extra)) % n
    occ_uid = np.concatenate(
        [np.arange(n), np.repeat(multi, 2)]
    ).astype(np.int64)
    occ_ref = np.concatenate(
        [np.arange(n), (np.arange(2 * extra) + 1) % n]
    ).astype(np.int64)
    occ_pos = np.concatenate(
        [np.zeros(n, dtype=np.int64), 3 + np.arange(2 * extra, dtype=np.int64)]
    )
    occ_o = np.concatenate(
        [np.ones(n, dtype=np.int64), np.arange(2 * extra, dtype=np.int64) % 2]
    )
    spt = SPT(
        unitigs,
        [f"ref{i}" for i in range(n)],
        occ_uid,
        occ_ref,
        occ_pos,
        occ_o,
        unitigs.unitig_len(np.arange(n)),
    )
    return spt, seqs


def toy_index(
    n_seqs=32, seq_len=200, k=31, w=15, seed=0, skew_param=8, engine="direct"
):
    """ModIndex over ``toy_spt`` with sequence-carrying references.

    ``engine`` is an SSHash engine (parity/fast32/direct) or a KCDict
    scheme (cuckoo/mono/mono2, the latter two at load 0.25). For SSHash
    engines the build asserts that the planted branches are real: the
    heavy bucket lands in the skew index when ``skew_param`` is below its
    depth, and a mid-depth (phase-2B) bucket exists."""
    from .bits.seqvector import SeqVector
    from .containers.refseq import RefSeqCollection
    from .index.modindex import ModIndex

    spt, seqs = toy_spt(n_seqs, seq_len, k, w, seed)
    unitigs, table = spt.unitigs, spt.piscem_table()
    if engine in ("cuckoo", "mono", "mono2"):
        from .kphf.kcdict import KCDict

        kw = {} if engine == "cuckoo" else {"scheme": engine, "load": 0.25}
        k2u = KCDict.from_unitig_set(unitigs, occ_table=table, **kw)
    else:
        from .kphf.sshash import SSHash

        k2u = SSHash.from_unitig_set(
            unitigs, w, skew_param=skew_param, engine=engine
        )
        if skew_param is not None and skew_param < 16:
            assert k2u.n_kmers_in_skew_index > 0, "toy index lost its skew bucket"
        if engine == "direct":
            depths = np.diff(k2u.occs_prefix_sum)
            assert ((depths > 2) & (depths <= 8)).any(), (
                "toy index lost its mid-depth (phase-2B) bucket"
            )
    refs = RefSeqCollection(
        SeqVector.from_str("".join(seqs)),
        np.concatenate([[0], np.cumsum([len(s) for s in seqs])]),
        [f"ref{i}" for i in range(unitigs.n_unitigs)],
    )
    return ModIndex(k2u, table, refs, index_type="Piscem")


def genome_parts(n_bases: int, seed: int = 0, k: int = 31):
    """(unitigs, refs, u2pos) of a uniform random genome of ``n_bases``
    cut into ``GENOME_PIECE``-base unitigs; unitig i is reference i,
    forward, at position 0. Random-access bound once the index outgrows
    every cache."""
    from .bits.seqvector import SeqVector
    from .containers.refseq import RefSeqCollection
    from .containers.unitig_set import UnitigSet
    from .index.spt import SPT

    n = n_bases // GENOME_PIECE
    assert n > 0, f"genome of {n_bases} bases is below one {GENOME_PIECE}-base piece"
    rng = np.random.default_rng(seed)
    codes = rng.integers(0, 4, n * GENOME_PIECE, dtype=np.uint8)
    sv = SeqVector.from_codes(codes)
    accum = np.arange(n + 1, dtype=np.int64) * GENOME_PIECE
    unitigs = UnitigSet(k, sv, accum)
    names = [f"r{i}" for i in range(n)]
    spt = SPT(
        unitigs,
        names,
        np.arange(n, dtype=np.int64),
        np.arange(n, dtype=np.int64),
        np.zeros(n, dtype=np.int64),
        np.ones(n, dtype=np.int64),
        np.full(n, GENOME_PIECE, dtype=np.int64),
    )
    refs = RefSeqCollection(sv, accum, names)
    return unitigs, refs, spt.piscem_table()


def genome_index(parts, engine: str = "direct", w: int = 15, skew_param=4,
                 load: float = 0.25):
    """ModIndex over ``genome_parts`` output: an SSHash engine
    (parity/fast32/direct, bucket load ``load``) or KCDict mono2 at
    ``load``."""
    from .index.modindex import ModIndex

    unitigs, refs, u2pos = parts
    if engine in ("mono", "mono2"):
        from .kphf.kcdict import KCDict

        k2u = KCDict.from_unitig_set(
            unitigs, occ_table=u2pos, scheme=engine, load=load
        )
    else:
        from .kphf.sshash import SSHash

        k2u = SSHash.from_unitig_set(
            unitigs, w=w, skew_param=skew_param, engine=engine, bucket_load=load
        )
    return ModIndex(k2u, u2pos, refs, index_type="Piscem")


def kmer_workload(unitigs, n: int, seed: int = 0, miss_frac: float = 0.1):
    """``n`` query words: k-mers of ``unitigs`` drawn uniformly (tiled
    when there are fewer than ``n``), half reverse-complemented, and a
    ``miss_frac`` share replaced by random 62-bit words (misses w.h.p.)."""
    from .kmer import revcomp

    rng = np.random.default_rng(seed)
    starts = unitigs.kmer_start_positions()
    if len(starts) >= n:
        pos = starts[rng.integers(0, len(starts), n)]
    else:
        pos = np.tile(starts, -(-n // len(starts)))[:n]
        rng.shuffle(pos)
    work = np.asarray(unitigs.get_kmer_u64(pos), dtype=np.uint64)
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], unitigs.k)
    miss = rng.random(n) < miss_frac
    work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
    return work
