"""Mono engine (single-hash KCDict + two-choice side table).

The main-phase query is ONE random row gather; displaced keys live in the
side table consulted by the full query (and therefore by phase 2 of the
compact driver). Exactness contract: full results equal the sshash direct
engine's on the same index (reference behavior: src/kphf/mod.rs:58-66).
"""

import numpy as np
import pytest

from mazu_tpu.containers.unitig_set import UnitigSet
from mazu_tpu.index.modindex import ModIndex, get_ref_pos_compact
from mazu_tpu.index.pipeline import OneGraphIndexQuery
from mazu_tpu.index.validate import validate_k2u_self
from mazu_tpu.kmer import revcomp
from mazu_tpu.kphf.kcdict import KCDict, kcdict_k2u
from mazu_tpu.synth import toy_spt

W = 5  # minimizer width of the SSHash cross-checks on the small-k fixture


def _tiny_spt():
    """32 seeded unitigs of 100 bases at k=15, with planted minimizer
    buckets and three-occurrence unitigs (mazu_tpu.synth.toy_spt)."""
    return toy_spt(n_seqs=32, seq_len=100, k=15, w=W, seed=3)[0]


@pytest.fixture(scope="module")
def tiny_us():
    return _tiny_spt().unitigs


def test_mono_validate_self(tiny_us):
    kc = KCDict.from_unitig_set(tiny_us, scheme="mono", load=0.0625)
    assert kc.scheme == "mono"
    validate_k2u_self(kc)


def _synthetic_us(n_bases=3000, seed=7, k=15):
    rng = np.random.default_rng(seed)
    seq = "".join("ACGT"[c] for c in rng.integers(0, 4, n_bases))
    return UnitigSet.from_seqs([seq], k)


def test_mono_forced_side_table():
    # a high load forces displacements: the side table must carry them
    us = _synthetic_us()
    kc = KCDict.from_unitig_set(us, scheme="mono", load=8.0)
    assert kc.side is not None and kc.side_T > 0
    validate_k2u_self(kc)


def test_mono_misses(tiny_us):
    kc = KCDict.from_unitig_set(tiny_us, scheme="mono", load=0.0625)
    d = kc.device_arrays()
    known_arr = tiny_us.all_canonical_kmers()
    known = set(known_arr.tolist())
    rng = np.random.default_rng(0)
    q = rng.integers(0, 1 << (2 * tiny_us.k), 500, dtype=np.uint64)
    q[::2] = known_arr[rng.integers(0, len(known_arr), 250)]  # half hits
    canon = np.minimum(q, revcomp(q, tiny_us.k))
    r = kcdict_k2u(d, canon, np)
    miss = np.array([c not in known for c in canon.tolist()])
    assert ((r["mt"] == 0) == miss).all()


def test_mono_main_phase_unresolved_semantics():
    us = _synthetic_us(seed=8)
    kc = KCDict.from_unitig_set(us, scheme="mono", load=8.0)
    d = kc.device_arrays()
    kms = us.all_canonical_kmers()
    rm = kcdict_k2u(d, kms, np, mode="main")
    rf = kcdict_k2u(d, kms, np)
    # every unresolved lane resolves in the full query; resolved main lanes
    # agree with the full query
    assert (rf["mt"] > 0).all()
    done = ~rm["unresolved"]
    for key in ("unitig_id", "pos", "mt"):
        assert np.array_equal(rm[key][done], rf[key][done]), key


def test_mono_compact_matches_sshash(yeast_chr7_index=None):
    from mazu_tpu.kphf.sshash import SSHash

    spt = _tiny_spt()
    us = spt.unitigs
    u2 = spt.piscem_table()
    refs = spt.ref_seq_collection()
    kms_all = us.all_canonical_kmers()
    rng = np.random.default_rng(1)
    kms = np.concatenate([kms_all] * 8)
    flip = rng.random(len(kms)) < 0.5
    kms[flip] = revcomp(kms[flip], us.k)

    ss = SSHash.from_unitig_set(us, w=W, skew_param=4, engine="direct", bucket_load=0.25)
    idx_ss = ModIndex(ss, u2, refs, index_type="t")
    a_ss = idx_ss.device_arrays(fused=True, pos_kind="inline2")
    mo = max(1, idx_ss.max_occs())
    o_ss = get_ref_pos_compact(a_ss, kms, np, mo, merge=False, probe_limit=2, m2=len(kms))

    kc = KCDict.from_unitig_set(us, occ_table=u2, scheme="mono", load=0.25)
    idx_kc = ModIndex(kc, u2, refs, index_type="t")
    a_kc = idx_kc.device_arrays(fused=True)
    o_kc = get_ref_pos_compact(a_kc, kms, np, mo, merge=False, m2=len(kms))

    assert int(OneGraphIndexQuery.checksum(o_ss, np)) == int(
        OneGraphIndexQuery.checksum(o_kc, np)
    )


def test_mono2_validate_and_compact():
    # mono2: slot rows with the second occurrence inline; displaced keys in
    # the side table; exactness vs the sshash direct engine
    from mazu_tpu.kphf.sshash import SSHash

    spt = _tiny_spt()
    us, u2, refs = spt.unitigs, spt.piscem_table(), spt.ref_seq_collection()
    kc = KCDict.from_unitig_set(us, occ_table=u2, scheme="mono2", load=0.25)
    validate_k2u_self(kc)
    kms = np.concatenate([us.all_canonical_kmers()] * 8)
    rng = np.random.default_rng(2)
    flip = rng.random(len(kms)) < 0.5
    kms[flip] = revcomp(kms[flip], us.k)
    ss = SSHash.from_unitig_set(us, w=W, skew_param=4, engine="direct", bucket_load=0.25)
    mo = max(1, u2.max_occs())
    a_ss = ModIndex(ss, u2, refs, index_type="t").device_arrays(fused=True, pos_kind="inline2")
    a_kc = ModIndex(kc, u2, refs, index_type="t").device_arrays(fused=True)
    o_ss = get_ref_pos_compact(a_ss, kms, np, mo, merge=False, probe_limit=2, m2=len(kms))
    o_kc = get_ref_pos_compact(a_kc, kms, np, mo, merge=False, m2=len(kms))
    assert not bool(o_ss["over_budget"]) and not bool(o_kc["over_budget"])
    assert int(OneGraphIndexQuery.checksum(o_ss, np)) == int(
        OneGraphIndexQuery.checksum(o_kc, np)
    )


def test_mono2_forced_side():
    us = _synthetic_us(seed=11)
    kc = KCDict.from_unitig_set(us, scheme="mono2", load=8.0)
    assert kc.side is not None
    validate_k2u_self(kc)


def test_mono_checkpoint_roundtrip(tmp_path):
    from mazu_tpu.io.checkpoint import _k2u_state, _k2u_from

    kc = KCDict.from_unitig_set(_synthetic_us(seed=9), scheme="mono", load=8.0)
    state = _k2u_state(kc)
    path = tmp_path / "mono.npz"
    np.savez(path, **{k: v for k, v in state.items() if k not in ("us",)},
             **{f"us_{k}": v for k, v in state["us"].items()})
    kc2 = _k2u_from(state)
    assert kc2.scheme == "mono"
    assert kc2.side_T == kc.side_T
    assert np.array_equal(kc2.table, kc.table)
    if kc.side is not None:
        assert np.array_equal(kc2.side, kc.side)
    validate_k2u_self(kc2)
