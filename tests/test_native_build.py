"""Parity tests for the round-4 native Gbp-build kernels (mazu_host.cpp):
radix pair sort, run-length bounds, BooPHF32 native level/lookup, fused
ranges minimizer scan, position scatter. Each native kernel must reproduce
the NumPy builder stage bit-for-bit — the Gbp builds depend on it
(reference parallel analog: boomphf::Mphf::new_parallel,
/root/reference/src/kphf/sshash.rs:177)."""

import numpy as np
import pytest

from mazu_tpu.io.native import (
    boophf32_level,
    boophf32_lookup_batch,
    compact_kept,
    have_native,
    minimizer_scan32_ranges,
    radix_sort_pairs,
    run_bounds,
    scatter_ranges_gather,
)



@pytest.fixture(autouse=True)
def _native_lib():
    if not have_native():
        pytest.skip("native host library unavailable (no g++ toolchain)")


class TestRadixSortPairs:
    @pytest.mark.parametrize("n,bits", [(0, 30), (1, 30), (1000, 30), (1 << 17, 38)])
    def test_matches_stable_argsort(self, n, bits):
        rng = np.random.default_rng(n)
        # heavy duplication so stability is actually exercised
        keys = rng.integers(0, max(n // 4, 2), n, dtype=np.uint64)
        vals = rng.integers(0, 1 << 62, n).astype(np.int64)
        k2, v2 = keys.copy(), vals.copy()
        assert radix_sort_pairs(k2, v2, key_bits=bits)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(k2, keys[order])
        np.testing.assert_array_equal(v2, vals[order])

    def test_full_64bit_keys(self):
        rng = np.random.default_rng(7)
        keys = rng.integers(0, 1 << 63, 40000, dtype=np.uint64) << np.uint64(1)
        vals = np.arange(40000, dtype=np.int64)
        k2, v2 = keys.copy(), vals.copy()
        assert radix_sort_pairs(k2, v2, key_bits=64)
        order = np.argsort(keys, kind="stable")
        np.testing.assert_array_equal(k2, keys[order])
        np.testing.assert_array_equal(v2, vals[order])


class TestRunBounds:
    @pytest.mark.parametrize("n", [1, 5, 1000, 1 << 16])
    def test_matches_flatnonzero(self, n):
        rng = np.random.default_rng(n)
        mms = np.sort(rng.integers(0, max(n // 3, 2), n, dtype=np.uint64))
        got = run_bounds(mms)
        first = np.empty(n, dtype=bool)
        first[0] = True
        np.not_equal(mms[1:], mms[:-1], out=first[1:])
        np.testing.assert_array_equal(got, np.flatnonzero(first))

    def test_empty(self):
        assert len(run_bounds(np.zeros(0, dtype=np.uint64))) == 0


class TestBooPHF32Native:
    def _np_level(self, rem, s0, s1, n_bits):
        from mazu_tpu.kphf.boophf32 import U32, chain_next

        h, s0n, s1n = chain_next(s0, s1)
        pos = (h & U32(n_bits - 1)).astype(np.int64)
        counts = np.bincount(pos, minlength=n_bits)
        singleton = counts[pos] == 1
        words = np.zeros(n_bits // 32, dtype=np.uint32)
        spos = pos[singleton]
        np.bitwise_or.at(words, spos >> 5, U32(1) << (spos.astype(np.uint32) & U32(31)))
        return words, singleton, s0n, s1n

    def test_level_parity(self):
        from mazu_tpu.kphf.boophf32 import key_fold32

        rng = np.random.default_rng(3)
        keys = np.unique(rng.integers(0, 1 << 62, 50000, dtype=np.uint64))
        s0, s1 = key_fold32(keys)
        n_bits = 1 << 17
        # copies: chain_next returns the s1 OBJECT as the new s0, and the
        # native call mutates its inputs in place
        w_np, singleton, s0n, s1n = self._np_level(keys, s0.copy(), s1.copy(), n_bits)
        s0c, s1c = s0.copy(), s1.copy()
        w_nat, drop = boophf32_level(keys, s0c, s1c, n_bits)
        np.testing.assert_array_equal(w_nat, w_np)
        np.testing.assert_array_equal(drop.astype(bool), singleton)
        np.testing.assert_array_equal(s0c, s0n)
        np.testing.assert_array_equal(s1c, s1n)
        rk, r0, r1 = compact_kept(keys, s0c, s1c, drop)
        np.testing.assert_array_equal(rk, keys[~singleton])
        np.testing.assert_array_equal(r0, s0n[~singleton])
        np.testing.assert_array_equal(r1, s1n[~singleton])

    def test_build_native_equals_numpy(self, monkeypatch):
        """The whole built structure (levels, bitmaps, final hash) must be
        identical with and without the native kernels."""
        from mazu_tpu.kphf.boophf32 import BooPHF32

        rng = np.random.default_rng(11)
        keys = np.unique(rng.integers(0, 1 << 60, 30000, dtype=np.uint64))
        a = BooPHF32.build(keys)
        import mazu_tpu.io.native as nat

        monkeypatch.setattr(nat, "_lib", None)
        monkeypatch.setattr(nat, "_tried", True)
        b = BooPHF32.build(keys)
        assert len(a.levels) == len(b.levels)
        for (na_, wa, ra), (nb_, wb, rb) in zip(a.levels, b.levels):
            assert na_ == nb_
            np.testing.assert_array_equal(wa, wb)
            np.testing.assert_array_equal(ra, rb)
        np.testing.assert_array_equal(a.fh_keys, b.fh_keys)
        np.testing.assert_array_equal(a.fh_vals, b.fh_vals)

    def test_lookup_parity_and_mpf(self):
        from mazu_tpu.kphf.boophf32 import BooPHF32, boophf32_lookup

        rng = np.random.default_rng(5)
        keys = np.unique(rng.integers(0, 1 << 61, 20000, dtype=np.uint64))
        mphf = BooPHF32.build(keys)
        d = mphf.device_arrays()
        got = boophf32_lookup_batch(d, keys)
        want = np.asarray(boophf32_lookup(d, keys, np))
        np.testing.assert_array_equal(got, want)
        # minimal perfect: a permutation of [0, n)
        assert sorted(got.tolist()) == list(range(len(keys)))
        # misses agree too (may be -1 or an arbitrary in-range collision)
        miss = rng.integers(0, 1 << 61, 4096, dtype=np.uint64) | np.uint64(1 << 62)
        np.testing.assert_array_equal(
            boophf32_lookup_batch(d, miss), np.asarray(boophf32_lookup(d, miss, np))
        )


class TestScanRanges:
    def test_matches_kpos_scan(self):
        from mazu_tpu.containers.unitig_set import UnitigSet
        from mazu_tpu.io.native import minimizer_scan32

        rng = np.random.default_rng(2)
        k, w = 31, 15
        seqs = [
            "".join(rng.choice(list("ACGT"), rng.integers(k, 400)))
            for _ in range(50)
        ]
        us = UnitigSet.from_seqs(seqs, k)
        kpos = us.kmer_start_positions()
        mm0, off0, isfw0 = minimizer_scan32(us.useq.words, kpos, k, w, 0)
        accum = np.asarray(us.accum, dtype=np.int64)
        counts = np.maximum((accum[1:] - accum[:-1]) - k + 1, 0)
        mm1, op1, isfw1 = minimizer_scan32_ranges(
            us.useq.words, accum[:-1], counts, k, w, 0
        )
        np.testing.assert_array_equal(mm1, mm0)
        np.testing.assert_array_equal(op1, kpos + off0)
        np.testing.assert_array_equal(isfw1, isfw0)


class TestScatterRanges:
    def test_matches_repeat_scatter(self):
        rng = np.random.default_rng(9)
        nr, tot = 300, 0
        counts = rng.integers(1, 9, nr).astype(np.int64)
        tot = int(counts.sum())
        starts = np.concatenate([[0], np.cumsum(counts)[:-1]])
        mps = rng.integers(0, 1 << 40, tot).astype(np.int64)
        # disjoint destination regions (the kernel contract; the builder
        # guarantees it via the MPHF bijection): lay rows out in a permuted
        # ORDER, each region sized by its own count
        perm = rng.permutation(nr)
        dest = np.zeros(nr, dtype=np.int64)
        dest[perm] = np.concatenate([[0], np.cumsum(counts[perm])[:-1]])
        got = scatter_ranges_gather(mps, starts, counts, dest)
        want = np.zeros(tot, dtype=np.uint64)
        ds = np.repeat(dest, counts)
        within = np.arange(tot) - np.repeat(starts, counts)
        want[ds + within] = mps.astype(np.uint64)
        np.testing.assert_array_equal(got, want)


def test_sshash_build_native_equals_fallback(monkeypatch, tmp_path):
    """End-to-end: a fast32 SSHash built with the native kernels must be
    structurally usable and answer identically to one built with the
    NumPy fallbacks (same minimizer stream contract)."""
    from mazu_tpu.containers.unitig_set import UnitigSet
    from mazu_tpu.kphf.sshash import SSHash, sshash_k2u

    rng = np.random.default_rng(21)
    seqs = ["".join(rng.choice(list("ACGT"), 500)) for _ in range(20)]
    us = UnitigSet.from_seqs(seqs, 31)
    a = SSHash.from_unitig_set(us, w=15, skew_param=8, engine="fast32")

    import mazu_tpu.io.native as nat

    monkeypatch.setattr(nat, "_lib", None)
    monkeypatch.setattr(nat, "_tried", True)
    b = SSHash.from_unitig_set(us, w=15, skew_param=8, engine="fast32")
    monkeypatch.undo()

    kpos = us.kmer_start_positions()
    fw = us.get_kmer_u64(kpos)
    da, db = a.device_arrays(), b.device_arrays()
    ra = sshash_k2u(da, fw, np)
    rb = sshash_k2u(db, fw, np)
    for kk in ("unitig_id", "pos", "mt"):
        np.testing.assert_array_equal(ra[kk], rb[kk], err_msg=kk)
    assert (ra["mt"] > 0).all()


class TestKmerizeBatch:
    def test_matches_per_read_windows(self):
        """One-call batched k-merization (round 5 serving path) must equal
        the per-read valid_kmer_windows loop — incl. non-ACGT restarts,
        sub-k reads, and empty strings."""
        from mazu_tpu.index.validate import valid_kmer_windows
        from mazu_tpu.io.native import kmerize_batch

        if kmerize_batch([], 31) is None:
            import pytest

            pytest.skip("native lib unavailable")
        rng = np.random.default_rng(4)
        alpha = np.array(list("ACGTN"))
        reads = [
            "".join(alpha[rng.integers(0, 5, int(rng.integers(0, 120)))])
            for _ in range(300)
        ]
        reads += ["", "ACG", "N" * 50]
        k = 31
        b, pos, words = kmerize_batch(reads, k)
        assert len(b) == len(reads) + 1 and int(b[-1]) == len(words)
        for i, r in enumerate(reads):
            p, w = valid_kmer_windows(r, k)
            np.testing.assert_array_equal(p, pos[b[i] : b[i + 1]], err_msg=str(i))
            np.testing.assert_array_equal(w, words[b[i] : b[i + 1]], err_msg=str(i))
