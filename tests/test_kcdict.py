"""KCDict (cuckoo k-mer dictionary) must agree exactly with SSHash."""

import numpy as np
import pytest

from mazu_tpu.index.modindex import get_ref_pos_padded
from mazu_tpu.index.piscem_index import piscem_index_from_spt
from mazu_tpu.synth import toy_spt

TINY, CHR = "tiny", "chr"


def _index(fixture, w, engine):
    """Seeded stand-ins for the cuttlefish fixtures (mazu_tpu.synth.toy_spt):
    ``tiny`` 32 unitigs of 200 bases, ``chr`` 256 of 500, both with planted
    heavy and mid-depth minimizer buckets and three-occurrence unitigs."""
    size = dict(seed=1) if fixture == TINY else dict(n_seqs=256, seq_len=500)
    return piscem_index_from_spt(toy_spt(w=w, **size)[0], w, 64, engine=engine)


def _work(index, n, seed=0):
    from mazu_tpu.kmer import revcomp

    us = index.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(seed)
    work = np.tile(kms, -(-n // len(kms)))[:n]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], index.k)
    # misses must be VALID 2k-bit words (the K2U input contract); bits above
    # 2k make revcomp/canonical disagree between engines by design
    miss = rng.random(n) < 0.1
    work[miss] = rng.integers(0, 1 << (2 * index.k), int(miss.sum()), dtype=np.uint64)
    return work


@pytest.mark.parametrize("fixture,w", [(TINY, 5), (CHR, 15)])
def test_kcdict_equals_sshash(fixture, w):
    a = _index(fixture, w, engine="direct")
    b = _index(fixture, w, engine="cuckoo")
    work = _work(a, 8192)
    mo = max(1, a.max_occs())
    ra = get_ref_pos_padded(a.device_arrays(fused=True), work, np, mo)
    rb = get_ref_pos_padded(b.device_arrays(fused=True), work, np, mo)
    for kk in ("mt", "unitig_id", "unitig_len", "pos", "n_occs"):
        np.testing.assert_array_equal(ra[kk], rb[kk], err_msg=kk)
    v = ra["valid"]
    for kk in ("ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(
            np.where(v, ra[kk], 0), np.where(v, rb[kk], 0), err_msg=kk
        )


def test_kcdict_jit_and_main_phase():
    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.twophase import TwoPhaseIndexQuery

    idx = _index(TINY, 5, engine="cuckoo")
    work = _work(idx, 512)
    mo = max(1, idx.max_occs())
    arrays = jax.device_put(idx.device_arrays(fused=True))
    want = get_ref_pos_padded(idx.device_arrays(fused=True), work, np, mo)
    got = jax.jit(lambda w: get_ref_pos_padded(arrays, w, jnp, mo))(jnp.asarray(work))
    np.testing.assert_array_equal(want["mt"], np.asarray(got["mt"]))
    # two-phase driver path (kcdict has no skew; overflow = multi-occ only)
    tp = TwoPhaseIndexQuery(idx, fused=True)
    chk, n_ovf = tp.checksum_query(jnp.asarray(work), work)
    v = want["valid"]
    # the two-phase checksum counts overflow lanes' unitig_id in BOTH the
    # main and the full pass; kcdict overflow = multi-occurrence lanes only
    ovf = (want["n_occs"] > 1) & (want["mt"] > 0)
    want_chk = (
        np.where(v, want["ref_pos"], 0).sum()
        + np.where(v, want["ref_id"], 0).sum()
        + want["unitig_id"].sum()
        + np.where(ovf, want["unitig_id"], 0).sum()
    )
    assert int(chk) == int(want_chk)
    assert n_ovf == int(ovf.sum())


def test_kcdict_validate_self():
    from mazu_tpu.index.validate import validate_k2u_self

    idx = _index(TINY, 5, engine="cuckoo")
    validate_k2u_self(idx.k2u)
