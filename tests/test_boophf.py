"""BooPHF parity tests against C++-produced artifacts.

Golden values are the C++-verified constants recorded by the reference's
test suite (src/pf1/boophf/hash.rs:138-254, src/pf1/boophf/mod.rs:310-425)
plus the bundled binary fixture test_data/pf1/bbhash_n=10.bin.
"""

import os

import numpy as np
import pytest

from mazu_tpu.hashes import (
    BOOPHF_SEED0,
    fast_range_64,
    multihash_h0,
    multihash_h1,
    multihash_next,
    simplehash64,
)
from mazu_tpu.kphf.boophf import BooPHF, boophf_lookup

from conftest import TEST_DATA

BBHASH10 = os.path.join(TEST_DATA, "pf1", "bbhash_n=10.bin")


class TestSimpleHash:
    def test_zero(self):
        assert int(simplehash64(np.uint64(0), BOOPHF_SEED0)) == 0x6E1BCCDB7AA2BC25

    def test_first10(self):
        true_hashes = [
            0x6E1BCCDB7AA2BC25,
            0x54676A7B01425B7,
            0x5C9BE323E5AD1BE1,
            0x9567829F5E948F83,
            0xCF71E329165C79B5,
            0x9F1219F1BCD9D206,
            0x6BD828B35DBA940E,
            0xF55B08C3340017C3,
            0xD178AE94742FA575,
            0x5DC299D49318DC6B,
        ]
        keys = np.arange(10, dtype=np.uint64)
        got = simplehash64(keys, BOOPHF_SEED0)
        np.testing.assert_array_equal(got, np.array(true_hashes, dtype=np.uint64))


class TestMultiHash:
    def test_zero_five(self):
        key = np.uint64(0)
        true_hashes = [
            7934160411570650149,
            4031181471818755726,
            7802733314557663513,
            5772550616205298107,
            3882642898705877381,
        ]
        h, s0, s1 = multihash_h0(key)
        got = [int(h)]
        h, s0, s1 = multihash_h1(s0, s1, key)
        got.append(int(h))
        for _ in range(3):
            h, s0, s1 = multihash_next(s0, s1)
            got.append(int(h))
        assert got == true_hashes


class TestFastRange:
    def test_basic(self):
        # (word * p) >> 64 checked vs python 128-bit arithmetic
        rng = np.random.default_rng(3)
        words = rng.integers(0, 1 << 63, 50, dtype=np.uint64)
        for p in (1, 7, 64, 1000, 1 << 40):
            got = fast_range_64(words, np.uint64(p))
            want = np.array([(int(w) * p) >> 64 for w in words], dtype=np.uint64)
            np.testing.assert_array_equal(got, want)


@pytest.fixture(scope="module")
def bbhash10():
    if not os.path.exists(BBHASH10):
        pytest.skip("fixture missing")
    return BooPHF.from_pf1(BBHASH10)


class TestLoadedBooPHF:
    def test_structure(self, bbhash10):
        assert bbhash10.n_elem == 10
        assert len(bbhash10.fh_keys) == 2
        assert len(bbhash10.levels) == 2

    def test_level0_word0(self, bbhash10):
        assert int(bbhash10.levels[0][1][0]) == 2312599096050843650

    def test_lookups(self, bbhash10):
        hashes = [2, 0, 8, 3, 5, 4, 1, 7, 6, 9, 7]
        got = bbhash10.lookup(np.arange(11, dtype=np.uint64))
        np.testing.assert_array_equal(got, hashes)

    def test_misses(self, bbhash10):
        got = bbhash10.lookup(np.arange(11, 20, dtype=np.uint64))
        # 11, 12 are false positives (hash to set bits); 13.. are hard misses
        assert got[0] == 0 and got[1] == 0
        np.testing.assert_array_equal(got[2:], -1)

    def test_final_hash(self, bbhash10):
        # keys 2 and 9 live in the final hash with values 8, 9
        assert 2 in bbhash10.fh_keys and 9 in bbhash10.fh_keys
        got = bbhash10.lookup(np.array([2, 9], dtype=np.uint64))
        np.testing.assert_array_equal(got, [8, 9])

    def test_device_lookup_matches(self, bbhash10):
        import jax.numpy as jnp

        keys = np.arange(20, dtype=np.uint64)
        d = bbhash10.device_arrays()
        np.testing.assert_array_equal(
            np.asarray(boophf_lookup(d, jnp.asarray(keys), jnp)),
            boophf_lookup(d, keys, np),
        )


class TestBuiltBooPHF:
    @pytest.mark.parametrize("n", [1, 10, 1000, 50000])
    def test_is_minimal_perfect(self, n):
        rng = np.random.default_rng(n)
        keys = np.unique(rng.integers(0, 1 << 62, 2 * n, dtype=np.uint64))[:n]
        mphf = BooPHF.build(keys)
        vals = mphf.lookup(keys)
        assert vals.min() == 0 and vals.max() == len(keys) - 1
        assert len(np.unique(vals)) == len(keys)

    def test_device_matches_host(self):
        import jax.numpy as jnp

        rng = np.random.default_rng(7)
        keys = np.unique(rng.integers(0, 1 << 62, 5000, dtype=np.uint64))
        mphf = BooPHF.build(keys)
        d = mphf.device_arrays()
        np.testing.assert_array_equal(
            np.asarray(boophf_lookup(d, jnp.asarray(keys), jnp)),
            boophf_lookup(d, keys, np),
        )


@pytest.mark.parametrize(
    "name",
    ["example_100_10", "example_10_100", "example_1e6_1e3"],
)
def test_cpp_example_fixtures(name):
    """BooPHF binaries + golden lookups produced by the C++ implementation."""
    import json

    bin_fp = os.path.join(TEST_DATA, "pf1", f"{name}.bin")
    json_fp = os.path.join(TEST_DATA, "pf1", f"{name}.json")
    if not os.path.exists(bin_fp):
        pytest.skip("fixture missing")
    with open(json_fp) as f:
        info = json.load(f)
    mphf = BooPHF.from_pf1(bin_fp)
    assert mphf.n_elem == info["nelems"]
    for section in ("random_hashed_elems", "random_elems"):
        keys = np.array([int(k) for k in info[section]], dtype=np.uint64)
        # C++ encodes a definite miss as ULLONG_MAX; we use -1
        want = np.array(
            [-1 if int(v) == 0xFFFFFFFFFFFFFFFF else int(v) for v in info[section].values()],
            dtype=np.int64,
        )
        got = mphf.lookup(keys)
        np.testing.assert_array_equal(got, want, err_msg=f"{name}/{section}")


class TestBooPHF32MrowsParity:
    def test_mrows_equals_block_rank_path(self):
        """The paired word|rank mrows path (round 4, one gather op per
        level, no rank tail) must equal the legacy block-rank path
        bit-for-bit, full and truncated."""
        from mazu_tpu.kphf.boophf32 import BooPHF32, boophf32_lookup

        rng = np.random.default_rng(5)
        keys = np.unique(rng.integers(0, 1 << 62, 60000, dtype=np.uint64))
        ph = BooPHF32.build(keys)
        d = ph.device_arrays(mrows=True)  # opt-in layout
        assert "mrows" in d and "words" not in d  # lean: words/ranks dropped
        legacy = ph.device_arrays()
        assert "mrows" not in legacy and "words" in legacy
        probes = np.concatenate(
            [keys, rng.integers(0, 1 << 62, 8192, dtype=np.uint64)]
        )
        np.testing.assert_array_equal(
            boophf32_lookup(d, probes, np),
            boophf32_lookup(legacy, probes, np),
        )
        for ll in (1, 2, 4):
            r1, u1 = boophf32_lookup(d, probes, np, level_limit=ll)
            r2, u2 = boophf32_lookup(legacy, probes, np, level_limit=ll)
            np.testing.assert_array_equal(u1, u2)
            np.testing.assert_array_equal(r1[~u1], r2[~u2])
        # host native lookup stays the independent oracle
        np.testing.assert_array_equal(
            boophf32_lookup(d, keys, np), ph.lookup(keys)
        )
