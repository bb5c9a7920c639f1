"""get_ref_pos_compact (on-device compacted heavy phase) must equal
get_ref_pos_padded exactly."""

import functools

import numpy as np
import pytest

from mazu_tpu.index.modindex import get_ref_pos_compact, get_ref_pos_padded
from mazu_tpu.synth import toy_index

TINY, CHR = "tiny", "chr"


@functools.lru_cache(maxsize=None)
def _index(fixture=CHR, w=15, engine="direct", skew_param=64):
    """Seeded indexes (mazu_tpu.synth.toy_spt): random unitigs with a
    planted heavy minimizer bucket, a mid-depth bucket and
    three-occurrence unitigs. ``tiny``: 32 unitigs of 200 bases;
    ``chr``: 256 unitigs of 500 bases."""
    size = dict(seed=1) if fixture == TINY else dict(n_seqs=256, seq_len=500)
    return toy_index(w=w, engine=engine, skew_param=skew_param, **size)


def _workload(index, n=4096, seed=0):
    from mazu_tpu.kmer import revcomp

    k = index.k
    us = index.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(seed)
    reps = -(-n // len(kms))
    work = np.tile(kms, reps)[:n]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], k)
    # sprinkle misses
    miss = rng.random(n) < 0.1
    work[miss] = rng.integers(0, 1 << 62, size=int(miss.sum()), dtype=np.uint64)
    rng.shuffle(work)
    return work


@pytest.mark.parametrize("fixture,w,bdiv", [(TINY, 5, 1), (CHR, 15, 4)])
def test_compact_equals_padded(fixture, w, bdiv):
    import jax
    import jax.numpy as jnp

    index = _index(fixture, w)
    arrays = jax.device_put(index.device_arrays(fused=True))
    mo = max(1, index.max_occs())
    work = _workload(index, 4096)

    want = get_ref_pos_padded(arrays, jnp.asarray(work), jnp, mo)
    got = get_ref_pos_compact(arrays, jnp.asarray(work), jnp, mo, budget_div=bdiv)
    assert not bool(got["over_budget"])
    for kk in ("unitig_id", "unitig_len", "pos", "mt", "n_occs"):
        np.testing.assert_array_equal(np.asarray(want[kk]), np.asarray(got[kk]), err_msg=kk)
    v = np.asarray(want["valid"])
    for kk in ("ref_id", "ref_pos", "orient"):
        a, b = np.asarray(want[kk]), np.asarray(got[kk])
        np.testing.assert_array_equal(np.where(v, a, 0), np.where(v, b, 0), err_msg=kk)
    np.testing.assert_array_equal(v, np.asarray(got["valid"]))


def test_compact_over_budget_flag():
    import jax.numpy as jnp

    index = _index(TINY, 5)
    arrays = index.device_arrays(fused=True)
    mo = max(1, index.max_occs())
    work = _workload(index, 256)
    # budget_div huge -> M=64 still; force overflow via tiny M: use budget_div
    # so that M < n_overflow. With 256 lanes M=max(64, 256//256)=64; overflow
    # lanes in tiny multi-occ fixture may be < 64, so just check the flag is
    # a bool and results equal padded when not over budget.
    got = get_ref_pos_compact(arrays, work, np, mo, budget_div=256)
    want = get_ref_pos_padded(arrays, work, np, mo)
    if not bool(got["over_budget"]):
        np.testing.assert_array_equal(want["mt"], got["mt"])


def test_merge_compact_k2u_matches_padded():
    """Device scalar-column merge of the split phases == the padded k2u
    fields, and the jnp scatter path == the np indexing path."""
    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.modindex import merge_compact_k2u

    index = _index()
    arrays = index.device_arrays(fused=True)
    mo = max(1, index.max_occs())
    work = _workload(index, 2048)
    want = get_ref_pos_padded(arrays, work, np, mo)
    out_np = get_ref_pos_compact(arrays, work, np, mo, merge=False, m2=512)
    assert not bool(out_np["over_budget"])
    got_np = merge_compact_k2u(out_np, np)
    d = jax.device_put(arrays)
    out_j = get_ref_pos_compact(d, jnp.asarray(work), jnp, mo, merge=False, m2=512)
    got_j = merge_compact_k2u(out_j, jnp)
    for kk in ("unitig_id", "pos", "mt"):
        np.testing.assert_array_equal(got_np[kk], want[kk], err_msg=kk)
        np.testing.assert_array_equal(np.asarray(got_j[kk]), want[kk], err_msg=kk)


def test_compact_merge_false_checksum():
    """Split (zero-scatter) form must reproduce the padded checksum."""
    index = _index()
    arrays = index.device_arrays(fused=True)
    mo = max(1, index.max_occs())
    work = _workload(index, 2048)
    a = get_ref_pos_padded(arrays, work, np, mo)
    c = get_ref_pos_compact(arrays, work, np, mo, 4, merge=False)
    assert not bool(c["over_budget"])
    v = a["valid"]
    want = (
        np.where(v, a["ref_pos"], 0).sum()
        + np.where(v, a["ref_id"], 0).sum()
        + a["unitig_id"].sum()
    )
    m_, ov, p2, sr = c["main"], c["overflow"], c["phase2"], c["slot_real"]
    got = (
        np.where(m_["valid"], m_["ref_pos"], 0).sum()
        + np.where(m_["valid"], m_["ref_id"], 0).sum()
        + np.where(~ov, m_["unitig_id"], 0).sum()
    )
    v2 = p2["valid"] & sr[:, None]
    got += (
        np.where(v2, p2["ref_pos"], 0).sum()
        + np.where(v2, p2["ref_id"], 0).sum()
        + np.where(sr, p2["unitig_id"], 0).sum()
    )
    assert int(got) == int(want)


@pytest.mark.parametrize("plim", [1, 2])
def test_compact_probe_limit(plim):
    """Shallow main probe + overflow pass must stay exact."""
    index = _index()
    arrays = index.device_arrays(fused=True)
    mo = max(1, index.max_occs())
    work = _workload(index, 2048, seed=3)
    want = get_ref_pos_padded(arrays, work, np, mo)
    got = get_ref_pos_compact(arrays, work, np, mo, 2, probe_limit=plim)
    assert not bool(got["over_budget"])
    for kk in ("unitig_id", "pos", "mt", "n_occs"):
        np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)
    v = want["valid"]
    for kk in ("ref_id", "ref_pos"):
        np.testing.assert_array_equal(
            np.where(v, want[kk], 0), np.where(v, got[kk], 0), err_msg=kk
        )


def test_inline2_layout_equals_inline():
    """Pre-aligned inline2 rows (fused first TWO occurrences) must agree
    exactly with the inline layout, padded and two-phase."""
    import jax.numpy as jnp

    from mazu_tpu.index.twophase import TwoPhaseIndexQuery

    index = _index()
    work = _workload(index, 4096, seed=11)
    mo = max(1, index.max_occs())
    a = get_ref_pos_padded(index.device_arrays(fused=True), work, np, mo)
    b = get_ref_pos_padded(
        index.device_arrays(fused=True, pos_kind="inline2"), work, np, mo
    )
    for kk in ("mt", "unitig_id", "unitig_len", "pos", "n_occs"):
        np.testing.assert_array_equal(a[kk], b[kk], err_msg=kk)
    v = a["valid"]
    for kk in ("ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(
            np.where(v, a[kk], 0), np.where(v, b[kk], 0), err_msg=kk
        )
    t1 = TwoPhaseIndexQuery(index)
    t2 = TwoPhaseIndexQuery(index, pos_kind="inline2")
    assert t1.get_ref_pos_eager(work[:512]) == t2.get_ref_pos_eager(work[:512])


def test_inline2_multi_occ_projection():
    """A reference with DUPLICATED sequences exercises cnt==2 fused
    projection from the embedded second occurrence."""
    from mazu_tpu.index.piscem_index import piscem_index_from_spt
    from mazu_tpu.index.spt import SPT
    from mazu_tpu.containers.unitig_set import UnitigSet

    rng = np.random.default_rng(5)
    seqs = ["".join(rng.choice(list("ACGT"), 120)) for _ in range(6)]
    us = UnitigSet.from_seqs(seqs, 21)
    n = us.n_unitigs
    # each unitig occurs TWICE: on ref i and on ref i+n (duplicated refs)
    names = [f"r{i}" for i in range(2 * n)]
    spt = SPT(
        us,
        names,
        np.concatenate([np.arange(n), np.arange(n)]).astype(np.int64),
        np.concatenate([np.arange(2 * n)]).astype(np.int64),
        np.zeros(2 * n, dtype=np.int64),
        np.ones(2 * n, dtype=np.int64),
        np.concatenate([us.unitig_len(np.arange(n))] * 2).astype(np.int64),
    )
    idx = piscem_index_from_spt(spt, 11, 8, engine="direct")
    kms = us.get_kmer_u64(us.kmer_start_positions())
    mo = max(1, idx.max_occs())
    assert mo >= 2
    a = get_ref_pos_padded(idx.device_arrays(fused=True), kms, np, mo)
    b = get_ref_pos_padded(idx.device_arrays(fused=True, pos_kind="inline2"), kms, np, mo)
    v = a["valid"]
    assert v[:, 1].any()  # cnt==2 lanes exist
    for kk in ("mt", "n_occs"):
        np.testing.assert_array_equal(a[kk], b[kk], err_msg=kk)
    for kk in ("ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(
            np.where(v, a[kk], 0), np.where(v, b[kk], 0), err_msg=kk
        )
    # the fused main phase must NOT overflow cnt==2 lanes under inline2
    from mazu_tpu.kphf.sshash import sshash_k2u
    from mazu_tpu.index.twophase import _project_fused

    arr2 = idx.device_arrays(fused=True, pos_kind="inline2")
    r = sshash_k2u(arr2["k2u"], kms, np, mode="main")
    p = _project_fused(arr2, r, np)
    two = (a["n_occs"] == 2) & (a["mt"] > 0)
    assert two.any()
    assert not (p["overflow"] & two & ~r["use_skew"]).any()


class TestFlaggedLanes:
    def test_host_and_device(self):
        import jax.numpy as jnp

        from mazu_tpu.ops.compact import flagged_lanes

        rng = np.random.default_rng(3)
        for n, frac in ((1024, 0.1), (4096, 0.0), (4096, 1.0), (2048, 0.03)):
            flags = rng.random(n) < frac
            m = 256
            want_lanes = np.flatnonzero(flags)[:m]
            lanes, n_set = flagged_lanes(flags, m, np)
            assert int(n_set) == int(flags.sum())
            np.testing.assert_array_equal(lanes[: len(want_lanes)], want_lanes)
            dl, dn = flagged_lanes(jnp.asarray(flags), m, jnp)
            assert int(dn) == int(n_set)
            np.testing.assert_array_equal(np.asarray(dl), lanes)

    def test_over_budget_counts(self):
        from mazu_tpu.ops.compact import flagged_lanes

        flags = np.ones(512, dtype=bool)
        lanes, n_set = flagged_lanes(flags, 64, np)
        assert int(n_set) == 512  # caller sees the true count and can resize
        np.testing.assert_array_equal(lanes, np.arange(64))


class TestOneGraphDriver:
    def test_checksum_device_equals_host(self):
        import jax
        import jax.numpy as jnp

        from mazu_tpu.index.pipeline import OneGraphIndexQuery
        from mazu_tpu.kmer import revcomp

        idx = _index(skew_param=4)
        us = idx.k2u.unitigs
        kms = us.get_kmer_u64(us.kmer_start_positions())
        rng = np.random.default_rng(11)
        n, CH = 4096, 3
        stack = np.zeros((CH, n), dtype=np.uint64)
        for c in range(CH):
            w = np.tile(kms, -(-n // len(kms)))[:n]
            flip = rng.random(n) < 0.5
            w[flip] = revcomp(w[flip], idx.k)
            miss = rng.random(n) < 0.03
            w[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
            rng.shuffle(w)
            stack[c] = w
        og = OneGraphIndexQuery(idx, batch=n, n_chunks=CH, m2=1024, probe_limit=2)
        got, worst = og.checksum_pass(jax.device_put(jnp.asarray(stack)))
        assert worst <= og.M2
        want = og.checksum_host(stack)
        assert got == want

    def test_checksum_pass_rolled_equals_stack(self):
        """Device-derived roll chunks == the explicit [CH, batch] stack
        (bench's host-stack-free path)."""
        import jax
        import jax.numpy as jnp

        from mazu_tpu.index.pipeline import OneGraphIndexQuery
        from mazu_tpu.kmer import revcomp

        idx = _index(skew_param=4)
        us = idx.k2u.unitigs
        kms = us.get_kmer_u64(us.kmer_start_positions())
        rng = np.random.default_rng(41)
        n, CH = 4096, 3
        work = np.tile(kms, -(-n // len(kms)))[:n]
        flip = rng.random(n) < 0.5
        work[flip] = revcomp(work[flip], idx.k)
        rng.shuffle(work)
        og = OneGraphIndexQuery(idx, batch=n, n_chunks=CH, m2=1024, probe_limit=2)
        got, worst = og.checksum_pass_rolled(jax.device_put(jnp.asarray(work)))
        assert worst <= og.M2
        stack = np.stack([np.roll(work, i * 40009) for i in range(CH)])
        want, _ = og.checksum_pass(jax.device_put(jnp.asarray(stack)))
        assert got == want
        assert got == CH * og.checksum_host(work[None, :])

    def test_compact_inline2_equals_padded(self):
        from mazu_tpu.kmer import revcomp

        idx = _index(skew_param=4)
        us = idx.k2u.unitigs
        kms = us.get_kmer_u64(us.kmer_start_positions())
        rng = np.random.default_rng(12)
        n = 4096
        work = np.tile(kms, -(-n // len(kms)))[:n]
        flip = rng.random(n) < 0.5
        work[flip] = revcomp(work[flip], idx.k)
        rng.shuffle(work)
        arrays = idx.device_arrays(fused=True, pos_kind="inline2")
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(arrays, work, np, mo)
        got = get_ref_pos_compact(arrays, work, np, mo, probe_limit=2, m2=1024)
        assert not bool(got["over_budget"])
        for key in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(got[key], want[key], err_msg=key)
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"], v)
        for key in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v, got[key], 0), np.where(v, want[key], 0), err_msg=key
            )


def test_fixedcap2_matches_inline2():
    """fixedcap2 (direct-addressed pre-aligned fused rows, no prefix
    gather) must reproduce the inline2 compact-path output EXACTLY,
    including overflow flags (slot-0 cnt bits give exact n_occs)."""
    from mazu_tpu.index.modindex import get_ref_pos_compact
    from mazu_tpu.kmer import revcomp

    idx = _index(skew_param=4)
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(5)
    n = 4096
    work = np.tile(kms, -(-n // len(kms)))[:n]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], idx.k)
    miss = rng.random(n) < 0.05
    work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
    rng.shuffle(work)

    mo = max(1, idx.max_occs())
    oa = get_ref_pos_compact(
        idx.device_arrays(fused=True, pos_kind="inline2"),
        work, np, mo, merge=False, probe_limit=2, m2=1024,
    )
    ob = get_ref_pos_compact(
        idx.device_arrays(fused=True, pos_kind="fixedcap2"),
        work, np, mo, merge=False, probe_limit=2, m2=1024,
    )
    for kk in ("unitig_id", "unitig_len", "pos", "mt", "n_occs"):
        np.testing.assert_array_equal(oa["main"][kk], ob["main"][kk], err_msg=kk)
    np.testing.assert_array_equal(oa["overflow"], ob["overflow"])
    assert int(oa["n_ovf"]) == int(ob["n_ovf"])
    mv = oa["main"]["valid"]
    np.testing.assert_array_equal(ob["main"]["valid"], mv)
    for kk in ("ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(
            np.where(mv, oa["main"][kk], 0), np.where(mv, ob["main"][kk], 0), err_msg=kk
        )
    sr = oa["slot_real"]
    v2 = oa["phase2"]["valid"] & sr[:, None]
    for kk in ("ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(
            np.where(v2, oa["phase2"][kk], 0), np.where(v2, ob["phase2"][kk], 0),
            err_msg="p2:" + kk,
        )


def test_fixedcap2_onegraph_device():
    """The one-graph driver on fixedcap2 arrays matches its host oracle."""
    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.pipeline import OneGraphIndexQuery
    from mazu_tpu.kmer import revcomp

    idx = _index(skew_param=4)
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(12)
    n, CH = 4096, 2
    stack = np.zeros((CH, n), dtype=np.uint64)
    for c in range(CH):
        w = np.tile(kms, -(-n // len(kms)))[:n]
        flip = rng.random(n) < 0.5
        w[flip] = revcomp(w[flip], idx.k)
        rng.shuffle(w)
        stack[c] = w
    og = OneGraphIndexQuery(
        idx, batch=n, n_chunks=CH, m2=1024, probe_limit=2, pos_kind="fixedcap2"
    )
    got, worst = og.checksum_pass(jax.device_put(jnp.asarray(stack)))
    assert worst <= og.M2
    assert got == og.checksum_host(stack)


class TestFlaggedLanes2:
    def test_matches_two_single_scans(self):
        import jax.numpy as jnp

        from mazu_tpu.ops.compact import flagged_lanes, flagged_lanes2

        rng = np.random.default_rng(7)
        for n, fa, fb in ((1024, 0.1, 0.02), (2048, 0.0, 0.3), (512, 1.0, 0.0)):
            a = rng.random(n) < fa
            b = (rng.random(n) < fb) & ~a
            la, na = flagged_lanes(a, 128, np)
            lb, nb = flagged_lanes(b, 64, np)
            ga, gna, gb, gnb = flagged_lanes2(a, b, 128, 64, np)
            assert (int(gna), int(gnb)) == (int(na), int(nb))
            np.testing.assert_array_equal(ga, la)
            np.testing.assert_array_equal(gb, lb)
            dga, dna, dgb, dnb = flagged_lanes2(
                jnp.asarray(a), jnp.asarray(b), 128, 64, jnp
            )
            assert (int(dna), int(dnb)) == (int(na), int(nb))
            np.testing.assert_array_equal(np.asarray(dga), la)
            np.testing.assert_array_equal(np.asarray(dgb), lb)


class TestCompactSplit:
    """m2b type-split heavy phase must stay exact (merged and split)."""

    def _setup(self, pos_kind="inline2"):
        from mazu_tpu.kmer import revcomp

        idx = _index(skew_param=4)
        us = idx.k2u.unitigs
        kms = us.get_kmer_u64(us.kmer_start_positions())
        rng = np.random.default_rng(21)
        n = 4096
        work = np.tile(kms, -(-n // len(kms)))[:n]
        flip = rng.random(n) < 0.5
        work[flip] = revcomp(work[flip], idx.k)
        miss = rng.random(n) < 0.05
        work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
        rng.shuffle(work)
        arrays = idx.device_arrays(fused=True, pos_kind=pos_kind)
        return idx, arrays, work

    def test_split_merged_equals_padded(self):
        idx, arrays, work = self._setup()
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(arrays, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=2, m2=1024, m2b=512
        )
        assert not bool(got["over_budget"])
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"], v)
        for kk in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v, want[kk], 0), np.where(v, got[kk], 0), err_msg=kk
            )

    def test_split_checksum_device_equals_plain(self):
        import jax
        import jax.numpy as jnp

        from mazu_tpu.index.pipeline import OneGraphIndexQuery
        from mazu_tpu.kmer import revcomp

        idx, _, _ = self._setup()
        us = idx.k2u.unitigs
        kms = us.get_kmer_u64(us.kmer_start_positions())
        rng = np.random.default_rng(23)
        n, CH = 4096, 2
        stack = np.zeros((CH, n), dtype=np.uint64)
        for c in range(CH):
            w = np.tile(kms, -(-n // len(kms)))[:n]
            flip = rng.random(n) < 0.5
            w[flip] = revcomp(w[flip], idx.k)
            rng.shuffle(w)
            stack[c] = w
        og_plain = OneGraphIndexQuery(idx, batch=n, n_chunks=CH, m2=1024, probe_limit=2)
        og_split = OneGraphIndexQuery(
            idx, batch=n, n_chunks=CH, m2=1024, m2b=512, probe_limit=2
        )
        d = jax.device_put(jnp.asarray(stack))
        want, worst = og_plain.checksum_pass(d)
        assert worst <= og_plain.M2
        got, (wa, wb) = og_split.checksum_pass(d)
        assert wa <= og_split.M2 and wb <= og_split.M2B
        assert got == want
        assert og_split.checksum_host(stack) == want


class TestCompactTierNonFused:
    """get_ref_pos_compact on NON-fused layouts (packed IntVector
    positions, EF/flat prefix — the Gbp capacity tier) must equal the
    padded oracle exactly, including the probe_start phase-2B re-probe."""

    def _setup(
        self, engine, prefix_kind, skew, seed=31, uproj=False, useqrec=False,
        bucket_inline=False,
    ):
        from mazu_tpu.kmer import revcomp

        idx = _index(engine=engine, skew_param=skew)
        us = idx.k2u.unitigs
        kms = us.get_kmer_u64(us.kmer_start_positions())
        rng = np.random.default_rng(seed)
        n = 4096
        work = np.tile(kms, -(-n // len(kms)))[:n]
        flip = rng.random(n) < 0.5
        work[flip] = revcomp(work[flip], idx.k)
        miss = rng.random(n) < 0.05
        work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
        rng.shuffle(work)
        arrays = idx.device_arrays(
            pos_kind="packed", prefix_kind=prefix_kind, uproj=uproj,
            useqrec=useqrec, bucket_inline=bucket_inline,
        )
        return idx, arrays, work

    @pytest.mark.parametrize(
        "engine,prefix_kind,skew,plim,m2b",
        [
            ("fast32", "flat32", 64, 2, None),
            ("fast32", "ef", 64, 2, 512),
            ("fast32", "grouped16", 64, 2, 512),  # the 3Gbp capacity config
            ("fast32", "grouped32", 64, 2, 512),  # r4 paired-bounds variant
            ("direct", "grouped32", 64, 3, 512),
            ("fast32", "flat32", 4, 1, 512),  # heavy skew traffic
            ("parity", "ef", 8, 2, 512),
            ("parity", "grouped16", 8, 2, 512),
        ],
    )
    def test_equals_padded(self, engine, prefix_kind, skew, plim, m2b):
        idx, arrays, work = self._setup(engine, prefix_kind, skew)
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(arrays, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=plim, m2=2048, m2b=m2b
        )
        assert not bool(got["over_budget"])
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"], v)
        for kk in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v, want[kk], 0), np.where(v, got[kk], 0), err_msg=kk
            )

    @pytest.mark.parametrize(
        "engine,prefix_kind,skew,plim",
        [
            ("fast32", "grouped16", 64, 2),  # the 3Gbp capacity config
            ("fast32", "flat32", 4, 1),  # heavy skew traffic
            ("parity", "ef", 8, 2),
        ],
    )
    def test_defer_valid_equals_padded(self, engine, prefix_kind, skew, plim):
        """Deferred winner validation (defer_valid=True): the probe loop
        skips per-candidate boundary checks; lanes whose winner fails are
        re-probed from row 0 by phase 2B. Must equal the padded oracle."""
        idx, arrays, work = self._setup(engine, prefix_kind, skew, seed=37)
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(arrays, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=plim, m2=2048, m2b=2048,
            defer_valid=True,
        )
        assert not bool(got["over_budget"])
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"], v)
        for kk in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v, want[kk], 0), np.where(v, got[kk], 0), err_msg=kk
            )

    @pytest.mark.parametrize(
        "engine,prefix_kind,skew,plim,plim2,kw",
        [
            ("fast32", "grouped16", 64, 2, 8,
             dict(defer_valid=True, mphf_level_limit=4)),  # 3Gbp config + levers
            ("fast32", "flat32", 4, 1, 6, dict()),  # heavy skew traffic
            ("direct", "flat32", 64, 2, 8, dict(defer_valid=True)),
            ("direct", "grouped16", 64, 3, 6, dict(defer_valid=True)),
            ("parity", "ef", 8, 2, 4, dict()),
        ],
    )
    def test_middle_phase_equals_padded(self, engine, prefix_kind, skew, plim, plim2, kw):
        """probe_limit2 middle phase: compacted type-B lanes re-probe
        shallowly; only skew/deeper-than-plim2 residue pays the padded
        pipeline. Must equal the padded oracle under every lever combo."""
        idx, arrays, work = self._setup(engine, prefix_kind, skew, seed=43)
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(arrays, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=plim, m2=2048, m2b=2048,
            probe_limit2=plim2, m2c=512, **kw,
        )
        assert not bool(got["over_budget"])
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"], v)
        for kk in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v, want[kk], 0), np.where(v, got[kk], 0), err_msg=kk
            )

    @pytest.mark.parametrize(
        "engine,prefix_kind,skew,plim,kw",
        [
            # round-4 capacity configs: uproj record + fused validate+rank
            ("fast32", "grouped16", 64, 2, dict(defer_valid=True, mphf_level_limit=4)),
            ("direct", "flat32", 64, 3, dict(defer_valid=True)),
            ("direct", "grouped16", 64, 2, dict(defer_valid=True)),
            ("fast32", "flat32", 4, 1, dict()),  # heavy skew traffic, no defer
            ("parity", "ef", 8, 2, dict(defer_valid=True)),
        ],
    )
    def test_uproj_equals_padded(self, engine, prefix_kind, skew, plim, kw):
        """uproj per-unitig projection records (ModIndex.device_arrays
        uproj=True): the capacity-tier main phase projects through
        _project_fused from ONE 40B row gather. Must equal the padded
        oracle computed on the NON-uproj arrays (cross-layout check)."""
        idx, arrays, work = self._setup(engine, prefix_kind, skew, seed=53, uproj=True)
        assert "uproj" in arrays["k2u"]["us"]
        plain = idx.device_arrays(pos_kind="packed", prefix_kind=prefix_kind)
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(plain, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=plim, m2=2048, m2b=2048, **kw
        )
        assert not bool(got["over_budget"])
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"], v)
        for kk in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v, want[kk], 0), np.where(v, got[kk], 0), err_msg=kk
            )
        # the padded (full-mode) pipeline must also be exact WITH uproj
        # arrays (its projection switches to the inline occ bounds)
        got_full = get_ref_pos_padded(arrays, work, np, mo)
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got_full[kk], err_msg=kk)
        for kk in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v, want[kk], 0),
                np.where(v, got_full[kk], 0),
                err_msg=kk,
            )

    @pytest.mark.parametrize(
        "engine,prefix_kind,skew,plim,kw",
        [
            # round-4 window-record probe (build_useqrec): validation +
            # rank + projection ride the candidate fetch
            ("direct", "grouped16", 64, 2, dict()),
            ("direct", "flat32", 64, 3, dict()),
            ("direct", "grouped16", 64, 2, dict(probe_limit2=6, m2c=512)),
            ("fast32", "grouped16", 64, 2, dict(mphf_level_limit=4)),
            ("fast32", "grouped32", 64, 2, dict(mphf_level_limit=4)),
            ("fast32", "flat32", 4, 1, dict()),  # heavy skew traffic
            ("fast32", "grouped16", 64, 1, dict(probe_limit2=4, m2c=512)),
            ("parity", "ef", 8, 2, dict()),
        ],
    )
    def test_useqrec_equals_padded(self, engine, prefix_kind, skew, plim, kw):
        """useqrec window-record probe: the main phase validates, ranks,
        and projects from the candidate-fetch rows (zero tail gathers);
        kw-matched-but-unvalidated lanes (boundary windows) must surface
        as unresolved and resolve in phase 2 — exact vs the padded oracle
        computed on the NON-useqrec arrays (cross-layout check)."""
        idx, arrays, work = self._setup(
            engine, prefix_kind, skew, seed=59, useqrec=True
        )
        assert "useqrec" in arrays["k2u"]["us"]
        plain = idx.device_arrays(pos_kind="packed", prefix_kind=prefix_kind)
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(plain, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=plim, m2=2048, m2b=2048, **kw
        )
        assert not bool(got["over_budget"])
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"], v)
        for kk in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v, want[kk], 0), np.where(v, got[kk], 0), err_msg=kk
            )

    @pytest.mark.parametrize(
        "engine,prefix_kind,skew,plim,useqrec,kw",
        [
            # round-4 bucket-inline bpos table: bounds + first-3 positions
            # + count in ONE row gather (main phase only)
            ("direct", "grouped16", 64, 2, True, dict()),
            ("direct", "grouped32", 64, 2, True, dict()),
            ("direct", "grouped16", 64, 3, True, dict(probe_limit2=6, m2c=512)),
            ("direct", "flat32", 64, 1, True, dict()),
            ("direct", "grouped16", 64, 2, False, dict(defer_valid=True)),
            ("fast32", "grouped16", 64, 2, True, dict(mphf_level_limit=4)),
            ("fast32", "flat32", 4, 2, True, dict()),  # heavy skew traffic
            ("parity", "ef", 8, 2, True, dict()),
        ],
    )
    def test_bucket_inline_equals_padded(
        self, engine, prefix_kind, skew, plim, useqrec, kw
    ):
        """bpos bucket-inline table: the main phase reads bounds AND its
        candidate positions from one direct-addressed row; phases 2/2B
        keep the prefix/packed arrays. Exact vs the padded oracle on the
        plain arrays, with and without the useqrec probe on top."""
        idx, arrays, work = self._setup(
            engine, prefix_kind, skew, seed=61, useqrec=useqrec,
            bucket_inline=True,
        )
        assert "bpos" in arrays["k2u"]
        plain = idx.device_arrays(pos_kind="packed", prefix_kind=prefix_kind)
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(plain, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=plim, m2=2048, m2b=2048, **kw
        )
        assert not bool(got["over_budget"])
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"], v)
        for kk in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v, want[kk], 0), np.where(v, got[kk], 0), err_msg=kk
            )

    def test_useqrec_boundary_kmers_exact(self):
        """Every k-mer start within (k + w) bases of a unitig boundary —
        the windows where the record row's unitig can mismatch the
        candidate's — must still resolve exactly (via the unresolved ->
        phase-2 route when the inline extent check fails)."""
        from mazu_tpu.kmer import revcomp

        idx, arrays, _ = self._setup("direct", "grouped16", 64, useqrec=True)
        us = idx.k2u.unitigs
        k = idx.k
        accum = np.asarray(us.accum, dtype=np.int64)
        starts = us.kmer_start_positions()
        uid = np.searchsorted(accum, starts, side="right") - 1
        near_end = (accum[uid + 1] - starts) <= (k + 15 + 32)
        near_start = (starts - accum[uid]) <= 32
        pos = starts[near_end | near_start]
        assert len(pos) > 100, "fixture lost its boundary coverage"
        work = us.get_kmer_u64(pos)
        half = len(work) // 2
        work[:half] = revcomp(work[:half], k)
        mo = max(1, idx.max_occs())
        plain = idx.device_arrays(pos_kind="packed", prefix_kind="grouped16")
        want = get_ref_pos_padded(plain, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=2, m2=len(work), m2b=len(work)
        )
        assert not bool(got["over_budget"])
        assert (got["mt"] > 0).all(), "boundary k-mer missed"
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)

    def test_validate_rank_fused_equals_separate(self):
        """us_validate_rank == (us_is_valid_pos, us_rank) on every k-mer
        start position, boundary-straddling positions, and random fuzz."""
        from mazu_tpu.containers.unitig_set import (
            us_is_valid_pos,
            us_rank,
            us_validate_rank,
        )

        idx, arrays, _ = self._setup("fast32", "grouped16", 64)
        us = arrays["k2u"]["us"]
        total = us["meta"].total_len
        rng = np.random.default_rng(11)
        pos = np.concatenate(
            [
                idx.k2u.unitigs.kmer_start_positions(),
                np.asarray(idx.k2u.unitigs.accum[1:]) - 1,  # boundary bits
                rng.integers(0, total, 4096),
                np.array([0, total - 1]),
            ]
        ).astype(np.int64)
        valid, uid = us_validate_rank(us, pos, np)
        np.testing.assert_array_equal(valid, us_is_valid_pos(us, pos, np))
        np.testing.assert_array_equal(uid, us_rank(us, pos, np))

    def test_middle_phase_over_budget(self):
        """m2c must bound the residue: a 1-lane capacity with real skew
        traffic sets over_budget instead of silently dropping lanes."""
        idx, arrays, work = self._setup("fast32", "flat32", 4, seed=43)
        mo = max(1, idx.max_occs())
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=1, m2=2048, m2b=2048,
            probe_limit2=4, m2c=1,
        )
        assert bool(got["over_budget"])

    def test_middle_phase_device_checksum(self):
        """Jitted middle-phase pass on the CPU backend: checksum equal to
        the host composition (the OneGraph consumer contract)."""
        import jax
        import jax.numpy as jnp

        from mazu_tpu.index.pipeline import OneGraphIndexQuery

        idx, arrays, work = self._setup("direct", "grouped16", 64, seed=47)
        mo = max(1, idx.max_occs())

        host = get_ref_pos_compact(
            arrays, work, np, mo, merge=False, probe_limit=2, m2=2048,
            m2b=2048, probe_limit2=8, m2c=512, defer_valid=True,
        )
        assert not bool(host["over_budget"])
        want = int(OneGraphIndexQuery.checksum(host, np))

        darr = jax.device_put(arrays)

        @jax.jit
        def q(a, fw):
            out = get_ref_pos_compact(
                a, fw, jnp, mo, merge=False, probe_limit=2, m2=2048,
                m2b=2048, probe_limit2=8, m2c=512, defer_valid=True,
            )
            return OneGraphIndexQuery.checksum(out, jnp), out["over_budget"]

        chk, ob = jax.device_get(q(darr, jnp.asarray(work)))
        assert not bool(ob)
        assert int(chk) == want

    def test_defer_valid_fail_lanes_recovered(self):
        """Force deferred-winner failures (boundary-crossing windows that
        spell a real k-mer) and check they surface as unresolved in the
        main phase and resolve exactly through the split driver."""
        from mazu_tpu.kphf.sshash import sshash_k2u

        idx, arrays, work = self._setup("fast32", "flat32", 64, seed=41)
        r0 = sshash_k2u(arrays["k2u"], work, np, mode="main", probe_limit=2)
        rd = sshash_k2u(
            arrays["k2u"], work, np, mode="main", probe_limit=2, defer_valid=True
        )
        # deferred mode may only ADD unresolved lanes (the failed winners);
        # every resolved lane must agree with the validating probe
        extra = rd["unresolved"] & ~r0["unresolved"]
        agree = ~rd["unresolved"] & ~r0["unresolved"] & ~rd["use_skew"]
        for kk in ("unitig_id", "pos", "mt"):
            np.testing.assert_array_equal(rd[kk][agree], r0[kk][agree], err_msg=kk)
        assert not (r0["unresolved"] & ~rd["unresolved"]).any()
        # and the full split query stays exact regardless of `extra`
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(arrays, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=2, m2=2048, m2b=2048,
            defer_valid=True,
        )
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)

    @pytest.mark.parametrize(
        "engine,prefix_kind,skew,plim,mlim,defer",
        [
            ("fast32", "grouped16", 64, 2, 2, False),  # 3Gbp capacity config
            ("fast32", "grouped16", 64, 2, 4, True),  # + deferred validation
            ("fast32", "flat32", 4, 1, 1, False),  # heavy truncation + skew
            ("parity", "ef", 8, 2, 2, False),  # u64 BooPHF: no-op passthrough
        ],
    )
    def test_mphf_level_limit_equals_padded(
        self, engine, prefix_kind, skew, plim, mlim, defer
    ):
        """Truncated minimizer-MPHF main phase (mphf_level_limit): lanes
        the shortened BBHash chain cannot place (deeper levels / final
        hash) go unresolved to phase 2B, which re-runs the full lookup.
        Must equal the padded oracle."""
        idx, arrays, work = self._setup(engine, prefix_kind, skew, seed=43)
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(arrays, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=plim, m2=2048, m2b=3072,
            defer_valid=defer, mphf_level_limit=mlim,
        )
        assert not bool(got["over_budget"])
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)
        v = want["valid"]
        np.testing.assert_array_equal(got["valid"], v)
        for kk in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v, want[kk], 0), np.where(v, got[kk], 0), err_msg=kk
            )

    def test_mphf_level_limit_truncation_exercised(self):
        """The truncated BooPHF32 lookup must (a) flag genuinely
        unresolved lanes at small level limits, (b) agree with the full
        lookup on every resolved lane, and (c) never resolve a lane the
        full chain resolves differently."""
        from mazu_tpu.kphf.boophf32 import BooPHF32, boophf32_lookup

        rng = np.random.default_rng(7)
        keys = rng.integers(0, 1 << 63, 20000, dtype=np.uint64)
        keys = np.unique(keys)
        mph = BooPHF32.build(keys)
        d = mph.device_arrays()
        full = boophf32_lookup(d, keys, np)
        assert (np.sort(full) == np.arange(len(keys))).all()
        prev_unres = None
        for ll in (1, 2, 4, 8):
            res, unres = boophf32_lookup(d, keys, np, level_limit=ll)
            assert unres.any() or ll >= 8  # shallow limits must truncate
            np.testing.assert_array_equal(res[~unres], full[~unres])
            assert (res[unres] == -1).all()
            if prev_unres is not None:  # monotone: deeper chain resolves more
                assert not (unres & ~prev_unres).any()
            prev_unres = unres
        # foreign keys: resolved lanes are false-positive level hits that
        # downstream candidate verification rejects; none may crash
        foreign = rng.integers(0, 1 << 63, 4096, dtype=np.uint64)
        res_f, unres_f = boophf32_lookup(d, foreign, np, level_limit=2)
        assert res_f.shape == foreign.shape and unres_f.dtype == bool

    def test_probe_start_exercised(self):
        """The type-split phase-2B must actually skip the shallow rows:
        deep lanes exist, and results stay exact (vs a probe_start=0
        oracle through the same split path)."""
        from mazu_tpu.kphf.sshash import sshash_k2u

        idx, arrays, work = self._setup("fast32", "flat32", 64, seed=33)
        r = sshash_k2u(arrays["k2u"], work, np, mode="main", probe_limit=1)
        assert bool(r["unresolved"].any()), "workload has no deep lanes"
        mo = max(1, idx.max_occs())
        want = get_ref_pos_padded(arrays, work, np, mo)
        got = get_ref_pos_compact(
            arrays, work, np, mo, probe_limit=1, m2=2048, m2b=2048
        )
        assert not bool(got["over_budget"])
        for kk in ("unitig_id", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(want[kk], got[kk], err_msg=kk)

    def test_onegraph_device_equals_host(self):
        import jax
        import jax.numpy as jnp

        from mazu_tpu.index.pipeline import OneGraphIndexQuery
        from mazu_tpu.kmer import revcomp

        idx, arrays, _ = self._setup("fast32", "ef", 64)
        us = idx.k2u.unitigs
        kms = us.get_kmer_u64(us.kmer_start_positions())
        rng = np.random.default_rng(35)
        n, CH = 4096, 2
        stack = np.zeros((CH, n), dtype=np.uint64)
        for c in range(CH):
            w = np.tile(kms, -(-n // len(kms)))[:n]
            flip = rng.random(n) < 0.5
            w[flip] = revcomp(w[flip], idx.k)
            rng.shuffle(w)
            stack[c] = w
        og = OneGraphIndexQuery(
            idx, batch=n, n_chunks=CH, m2=2048, m2b=2048, probe_limit=2,
            host_arrays=arrays,
        )
        got, (wa, wb) = og.checksum_pass(jax.device_put(jnp.asarray(stack)))
        assert wa <= og.M2 and wb <= og.M2B
        assert got == og.checksum_host(stack)

    def test_twophase_probe_limit_nonfused(self):
        """TwoPhaseIndexQuery with probe_limit on non-fused arrays: the
        unresolved lanes must overflow to phase 2 (regression: they used
        to silently report misses)."""
        from mazu_tpu.index.twophase import TwoPhaseIndexQuery

        idx, arrays, work = self._setup("fast32", "flat32", 64, seed=37)
        tp = TwoPhaseIndexQuery(idx, fused=False, probe_limit=1)
        got = tp.get_ref_pos_eager(work[:1024])
        want = idx.get_ref_pos_eager(work[:1024])
        assert got == want


class TestFlaggedLanesHier:
    """The hierarchical rank-select algorithm (round 2): edge shapes and
    exactness vs the flat oracle and the round-1 searchsorted algorithm."""

    def test_fuzz_shapes_and_densities(self):
        import jax.numpy as jnp

        from mazu_tpu.ops.compact import flagged_lanes, flagged_lanes_ss

        rng = np.random.default_rng(11)
        shapes = (1, 3, 255, 256, 257, 4095, 4096, 16384, 16385, 100000)
        # every (n, frac) pair is a fresh jit compile on the device path —
        # the full 40-combo grid there cost 250s+ of suite time, so device
        # checks run only on the block-boundary shapes (host numpy covers
        # the full grid; the algorithms are backend-agnostic array code)
        device_shapes = {1, 255, 256, 257, 4096, 16385}
        device_fracs = {0.01, 1.0}
        for n in shapes:
            for frac in (0.0, 0.01, 0.31, 1.0):
                flags = rng.random(n) < frac
                m = max(1, min(n, 1 + int(n * max(frac, 0.02) * 1.5)))
                want = np.flatnonzero(flags)[:m]
                lanes, n_set = flagged_lanes(flags, m, np)
                assert int(n_set) == int(flags.sum()), (n, frac)
                np.testing.assert_array_equal(lanes[: len(want)], want)
                assert (np.asarray(lanes) >= 0).all() and (
                    np.asarray(lanes) < n
                ).all()
                if n in device_shapes and frac in device_fracs:
                    dl, dn = flagged_lanes(jnp.asarray(flags), m, jnp)
                    assert int(dn) == int(n_set)
                    np.testing.assert_array_equal(np.asarray(dl), lanes)
                # searchsorted algorithm agrees on the REAL slots
                sl, sn = flagged_lanes_ss(flags, m, np)
                assert int(sn) == int(n_set)
                np.testing.assert_array_equal(
                    sl[: len(want)], lanes[: len(want)]
                )

    def test_two_channel(self):
        import jax.numpy as jnp

        from mazu_tpu.ops.compact import flagged_lanes2

        rng = np.random.default_rng(5)
        n = 50000
        a = rng.random(n) < 0.05
        b = (rng.random(n) < 0.02) & ~a
        la, na, lb, nb = flagged_lanes2(a, b, 4096, 2048, np)
        np.testing.assert_array_equal(la[: int(na)], np.flatnonzero(a)[:4096])
        np.testing.assert_array_equal(lb[: int(nb)], np.flatnonzero(b)[:2048])
        dla, dna, dlb, dnb = flagged_lanes2(
            jnp.asarray(a), jnp.asarray(b), 4096, 2048, jnp
        )
        assert (int(dna), int(dnb)) == (int(na), int(nb))
        np.testing.assert_array_equal(np.asarray(dla), la)
        np.testing.assert_array_equal(np.asarray(dlb), lb)


def test_mphf_rows_layout_parity():
    """mphf_rows=True (paired word|rank mrows, round-5 opt-in) must answer
    identically to the legacy block-rank layout through the full sshash
    pipeline, truncated and full."""
    from mazu_tpu.kphf.sshash import SSHash, sshash_k2u

    us = _index().k2u.unitigs
    k2u = SSHash.from_unitig_set(us, 15, skew_param=4, engine="fast32")
    d1 = k2u.device_arrays(
        prefix_kind="grouped16", pos_kind="packed", mphf_rows=True
    )
    d0 = k2u.device_arrays(prefix_kind="grouped16", pos_kind="packed")
    assert "mrows" in d1["mphf"] and "words" not in d1["mphf"]
    kms = us.get_kmer_u64(us.kmer_start_positions()[:4096])
    rng = np.random.default_rng(9)
    kms[::9] = rng.integers(0, 1 << 62, len(kms[::9]), dtype=np.uint64)
    r1 = sshash_k2u(
        d1, kms, np, mode="main", probe_limit=2, defer_valid=True,
        mphf_level_limit=4,
    )
    r0 = sshash_k2u(
        d0, kms, np, mode="main", probe_limit=2, defer_valid=True,
        mphf_level_limit=4,
    )
    for kk in ("unitig_id", "pos", "mt", "unresolved"):
        np.testing.assert_array_equal(
            np.asarray(r1[kk]), np.asarray(r0[kk]), err_msg=kk
        )
    r1f = sshash_k2u(d1, kms, np, mode="full")
    r0f = sshash_k2u(d0, kms, np, mode="full")
    for kk in ("unitig_id", "pos", "mt"):
        np.testing.assert_array_equal(
            np.asarray(r1f[kk]), np.asarray(r0f[kk]), err_msg=kk
        )
