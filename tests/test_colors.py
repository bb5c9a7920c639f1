"""Color classes (unitig -> deduped ref-id set): exactness vs the full
occurrence projection, dedup behavior on a transcriptome, device parity.

The reference reserves this capability (src/lib.rs:26 commented cc_index +
test_data/color_classes fixtures) without implementing it; the oracle here
is our own projection path, which is itself parity-tested against the
reference's bundled pf1 indexes."""

import os

import numpy as np
import pytest

from mazu_tpu.index.colors import ColorClasses, colors_batch
from mazu_tpu.index.piscem_index import piscem_index_from_cf_prefix
from mazu_tpu.io.pf1_index import load_dense_index

from conftest import TEST_DATA

MULTI = os.path.join(TEST_DATA, "pf1", "tiny-multi-refs", "tiny-multi-refs_index")
TXOME = os.path.join(TEST_DATA, "pf1", "small_txome_index")
CC_TXOME = os.path.join(TEST_DATA, "color_classes", "small_txome", "small_txome")


def _oracle_sets(index):
    """Distinct ref-id set per unitig straight from the decoded table."""
    from mazu_tpu.index.unitig_table import decode_occs

    t = index.u2pos
    d = t.device_arrays(paired=False)
    total = int(t.offsets[-1])
    ref_id, _, _ = decode_occs(d, np.arange(total, dtype=np.int64), np)
    return [
        sorted(set(ref_id[int(t.offsets[u]) : int(t.offsets[u + 1])].tolist()))
        for u in range(t.n_unitigs)
    ]


def _check_exact(index):
    cc = index.color_classes()
    want = _oracle_sets(index)
    assert cc.n_unitigs == len(want)
    for u, w in enumerate(want):
        got = cc.refs_of_class(int(cc.class_of(u))).tolist()
        assert got == w, u
    # dedup is exact: same set <=> same class id
    by_set = {}
    for u, w in enumerate(want):
        by_set.setdefault(tuple(w), set()).add(int(cc.class_of(u)))
    assert all(len(v) == 1 for v in by_set.values())
    assert cc.n_classes == len(by_set)
    return cc


def test_multi_refs_colors():
    if not os.path.isdir(MULTI):
        pytest.skip("fixture missing")
    _check_exact(load_dense_index(MULTI))


def test_txome_colors_dedup_and_roundtrip(tmp_path):
    if not os.path.isdir(TXOME):
        pytest.skip("fixture missing")
    index = load_dense_index(TXOME)
    cc = _check_exact(index)
    # a transcriptome shares unitigs across isoforms: dedup must bite
    assert cc.n_classes < cc.n_unitigs
    p = str(tmp_path / "cc.npz")
    cc.save(p)
    cc2 = ColorClasses.load(p)
    np.testing.assert_array_equal(cc.u2c, cc2.u2c)
    np.testing.assert_array_equal(cc.offsets, cc2.offsets)
    np.testing.assert_array_equal(cc.refs, cc2.refs)
    assert cc2.n_refs == cc.n_refs


def test_colors_batch_device_parity():
    """Jitted colors_batch == host numpy, and every reference k-mer's
    color contains its own ref id (on the reserved cc fixture)."""
    import jax
    import jax.numpy as jnp

    if not os.path.exists(CC_TXOME + ".cf_seg"):
        pytest.skip("fixture missing")
    index = piscem_index_from_cf_prefix(CC_TXOME, w=11, skew_param=4)
    cc = index.color_classes()
    ccd = cc.device_arrays()
    arrays = index.device_arrays()
    rng = np.random.default_rng(0)
    from mazu_tpu.index.validate import valid_kmer_windows
    from mazu_tpu.io.fasta import read_fasta

    kms_parts = [
        valid_kmer_windows(seq, index.k)[1]
        for _name, seq in read_fasta(CC_TXOME + ".fa")
    ]
    owner = np.concatenate(
        [np.full(len(p), ri) for ri, p in enumerate(kms_parts)]
    )
    kms = np.concatenate(kms_parts)
    sel = rng.permutation(len(kms))[:2048]
    kms, owner = kms[sel], owner[sel]
    from mazu_tpu.kmer import revcomp

    flip = rng.random(len(kms)) < 0.5
    kms[flip] = revcomp(kms[flip], index.k)
    M = cc.max_class_size()
    host = colors_batch(arrays, ccd, kms, np, M)
    dev = jax.jit(
        lambda a, c, w: colors_batch(a, c, w, jnp, M)
    )(jax.device_put(arrays), jax.device_put(ccd), jnp.asarray(kms))
    for key in host:
        np.testing.assert_array_equal(
            np.asarray(dev[key]), np.asarray(host[key]), err_msg=key
        )
    assert (host["mt"] > 0).all()
    contained = (host["refs"] == owner[:, None]) & host["valid"]
    assert contained.any(axis=1).all()
    # foreign k-mers: class_id -1, no refs
    foreign = colors_batch(arrays, ccd, np.full(64, 0x5A5A5A5A5A, np.uint64), np, M)
    miss = foreign["mt"] == 0
    assert (foreign["class_id"][miss] == -1).all()
    assert (foreign["n_refs"][miss] == 0).all()


@pytest.mark.parametrize("trial", range(4))
def test_colors_fuzz_random_tilings(trial):
    """Random unitig sets + random multi-occurrence tilings (orientations,
    repeats): colors and pseudo-alignment must match scalar oracles."""
    import sys

    sys.path.insert(0, os.path.dirname(__file__))
    from test_fuzz import random_unitigs

    from mazu_tpu.containers.refseq import RefSeqCollection
    from mazu_tpu.containers.unitig_set import UnitigSet
    from mazu_tpu.index.modindex import ModIndex
    from mazu_tpu.index.pseudoalign import PseudoAligner
    from mazu_tpu.index.spt import SPT
    from mazu_tpu.kphf.sshash import SSHash

    rng = np.random.default_rng(500 + trial)
    k = int(rng.choice([7, 15, 31]))
    seqs = random_unitigs(rng, int(rng.integers(4, 10)), k, max_len=90)
    if len(seqs) < 2:
        pytest.skip("degenerate draw")
    us = UnitigSet.from_seqs(seqs, k)
    n_refs = int(rng.integers(2, 7))
    uids, refs_, poss, os_ = [], [], [], []
    ref_lens = np.zeros(n_refs, dtype=np.int64)
    for u, s in enumerate(seqs):
        for ri in rng.choice(n_refs, size=int(rng.integers(1, 4)), replace=False):
            uids.append(u)
            refs_.append(int(ri))
            poss.append(int(ref_lens[ri]))
            os_.append(int(rng.integers(0, 2)))
            ref_lens[ri] += len(s) + int(rng.integers(0, 9))  # gap
    spt = SPT(
        us,
        [f"r{i}" for i in range(n_refs)],
        np.array(uids, dtype=np.int64),
        np.array(refs_, dtype=np.int64),
        np.array(poss, dtype=np.int64),
        np.array(os_, dtype=np.int64),
        ref_lens + 1,
    )
    w = int(rng.integers(3, min(k, 15) + 1))
    k2u = SSHash.from_unitig_set(us, w=w, skew_param=2, engine="direct")
    refs = RefSeqCollection(
        None,
        np.concatenate([[0], np.cumsum(ref_lens + 1)]).astype(np.int64),
        spt.ref_names,
    )
    idx = ModIndex(k2u, spt.piscem_table(), refs)
    # colors == per-unitig distinct tiling refs
    cc = _check_exact(idx)
    want = {u: sorted({refs_[i] for i in range(len(uids)) if uids[i] == u})
            for u in range(len(seqs))}
    for u in range(len(seqs)):
        assert cc.refs_of_class(int(cc.class_of(u))).tolist() == want[u]
    # pseudoalign reads = unitig seqs fw/rc -> exactly that unitig's set
    reads = []
    for u, s in enumerate(seqs):
        reads.append(s if u % 2 else s.translate(str.maketrans("ACGT", "TGCA"))[::-1])
    pa = PseudoAligner(idx, cc=cc)
    for (g_refs, g_hit, g_k), (u, _s) in zip(pa.map_reads(reads), enumerate(seqs)):
        assert g_hit == g_k
        assert g_refs.tolist() == want[u], u


def test_colors_over_sharded_query():
    """SHARDED deployments: cc arrays replicate;
    colors_from_k2u over the merged mono-sharded full-query output must
    equal the single-device colors_batch exactly."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.containers.refseq import RefSeqCollection
    from mazu_tpu.containers.unitig_set import UnitigSet
    from mazu_tpu.index.colors import colors_from_k2u
    from mazu_tpu.index.modindex import ModIndex
    from mazu_tpu.index.spt import SPT
    from mazu_tpu.index.validate import merge_sharded_out
    from mazu_tpu.kmer import revcomp
    from mazu_tpu.kphf.kcdict import KCDict
    from mazu_tpu.parallel.sharding import make_mono_sharded_query

    rng = np.random.default_rng(17)
    k = 21
    seqs = ["".join(rng.choice(list("ACGT"), 90)) for _ in range(24)]
    us = UnitigSet.from_seqs(seqs, k)
    n = us.n_unitigs
    # each unitig occurs on refs u and u+n: classes of size 2
    names = [f"r{i}" for i in range(2 * n)]
    spt = SPT(
        us,
        names,
        np.concatenate([np.arange(n), np.arange(n)]).astype(np.int64),
        np.arange(2 * n, dtype=np.int64),
        np.zeros(2 * n, dtype=np.int64),
        np.ones(2 * n, dtype=np.int64),
        np.concatenate([us.unitig_len(np.arange(n))] * 2).astype(np.int64),
    )
    u2 = spt.piscem_table()
    refs = RefSeqCollection(
        None, np.concatenate([[0], np.cumsum(spt.ref_lens)]).astype(np.int64), names
    )
    kc = KCDict.from_unitig_set(us, occ_table=u2, scheme="mono2", load=0.25)
    idx = ModIndex(kc, u2, refs, index_type="t")
    cc = idx.color_classes()
    assert cc.n_refs == 2 * n and cc.max_class_size() == 2
    ccd = cc.device_arrays()

    kms = us.get_kmer_u64(us.kmer_start_positions())
    B = 1024
    work = np.tile(kms, -(-B // len(kms)))[:B]
    flip = rng.random(B) < 0.5
    work[flip] = revcomp(work[flip], k)
    miss = rng.random(B) < 0.05
    work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
    rng.shuffle(work)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "bucket"))
    qf = make_mono_sharded_query(idx, mesh, m2=512)
    out = jax.tree_util.tree_map(np.asarray, qf(jnp.asarray(work)))
    merged = merge_sharded_out(out)
    mr = max(1, cc.max_class_size())
    got = colors_from_k2u(ccd, merged, np, mr)
    want = colors_batch(idx.device_arrays(), ccd, work, np, mr)
    for kk in ("mt", "class_id", "n_refs"):
        np.testing.assert_array_equal(got[kk], want[kk], err_msg=kk)
    np.testing.assert_array_equal(got["valid"], want["valid"])
    np.testing.assert_array_equal(
        np.where(want["valid"], got["refs"], 0),
        np.where(want["valid"], want["refs"], 0),
    )
