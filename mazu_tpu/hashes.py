"""Hash functions.

Two families:

1. BooPHF chain hashes with bit-exact parity to pufferfish's BooPHF.hpp
   (re-derived from the behavior specified by reference
   src/pf1/boophf/hash.rs and its C++-produced golden constants). These are
   required to query pufferfish-built ``mphf.bin`` files correctly.

2. ``mix64`` (in mazu_tpu.kmer) — the default minimizer-ordering hash for
   self-built SSHash indexes.

All functions are elementwise uint64 and run under NumPy or jax.numpy.
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64

# Default seed pair of the BooPHF single/multi hashers
# (reference src/pf1/boophf/hash.rs:9)
BOOPHF_SEED0 = U64(0xAAAAAAAA55555555)
BOOPHF_SEED1 = U64(0x33333333CCCCCCCC)

_M32 = U64(0xFFFFFFFF)


def simplehash64(key, seed):
    """SingleHashFunctor<uint64_t> mix (reference src/pf1/boophf/hash.rs:33-49).

    All arithmetic wraps mod 2^64 (native uint64 overflow).
    """
    h = U64(seed) if np.isscalar(seed) else seed
    key = key.astype(np.uint64) if hasattr(key, "astype") else U64(key)
    init = (h << U64(7)) ^ (key * (h >> U64(3))) ^ (~((h << U64(11)) + (key ^ (h >> U64(5)))))
    h = h ^ init
    h = (~h) + (h << U64(21))
    h = h ^ (h >> U64(24))
    h = (h + (h << U64(3))) + (h << U64(8))
    h = h ^ (h >> U64(14))
    h = (h + (h << U64(2))) + (h << U64(4))
    h = h ^ (h >> U64(28))
    h = h + (h << U64(31))
    return h


def multihash_h0(key):
    """Level-0 hash; returns (hash, state0, state1)."""
    h = simplehash64(key, BOOPHF_SEED0)
    ones = h * U64(0) + BOOPHF_SEED1  # broadcast seed1 to key's shape/backend
    return h, h, ones


def multihash_h1(state0, state1, key):
    h = simplehash64(key, BOOPHF_SEED1)
    return h, state0, h


def multihash_next(state0, state1):
    """xorshift128+ chain step (reference src/pf1/boophf/hash.rs:124-135)."""
    s1 = state0
    s0 = state1
    s1 = s1 ^ (s1 << U64(23))
    s1 = s1 ^ s0 ^ (s1 >> U64(17)) ^ (s0 >> U64(26))
    h = s1 + s0
    return h, s0, s1


def mulhi64(a, b):
    """High 64 bits of the 128-bit product a*b, via 32-bit limb decomposition.

    Used by BooPHF's Lemire fast_range_64 (reference src/pf1/boophf/mod.rs:136-144).
    """
    a_lo = a & _M32
    a_hi = a >> U64(32)
    if np.isscalar(b) or isinstance(b, (int, np.integer)):
        b = U64(b)
    b_lo = b & _M32
    b_hi = b >> U64(32)
    lo_lo = a_lo * b_lo
    hi_lo = a_hi * b_lo
    lo_hi = a_lo * b_hi
    hi_hi = a_hi * b_hi
    cross = (lo_lo >> U64(32)) + (hi_lo & _M32) + (lo_hi & _M32)
    return hi_hi + (hi_lo >> U64(32)) + (lo_hi >> U64(32)) + (cross >> U64(32))


def fast_range_64(word, p):
    """Map ``word`` into [0, p) multiplicatively (Lemire fastrange)."""
    return mulhi64(word, p)


# ----------------------------------------------------------------------------
# wyhash v1 minimizer-ordering parity option
# ----------------------------------------------------------------------------
#
# The reference orders minimizers with the Rust ``wyhash`` crate 0.5
# (Cargo.toml:20) through a std BuildHasher (reference src/kphf/mod.rs:32-52,
# used at src/kphf/sshash.rs:105,476): the w-mer's u64 word is fed to the
# hasher as its 8 little-endian bytes, and the digest is
# ``wyhash(bytes, seed)`` of Wang Yi's wyhash *version 1* algorithm.
#
# PROVENANCE NOTE: this environment has no network and no Rust toolchain, so
# the implementation below is a reconstruction of the published v1 algorithm
# (32-byte wymum rounds; P0-xor'd seed; byte-granular tail; length-xor
# finalization with P4). The frozen vectors in tests/test_wyhash.py are
# produced by THIS implementation (regression pinning), not by the upstream
# crate; cross-check against `wyhash = "0.5"` before relying on bit-parity
# with a reference-built SSHash. Minimizer *choice* does not affect query
# results for any ordering hash, so indexes built with this option remain
# exactly as correct as the default mix64 ordering either way.

_WYP0 = U64(0xA0761D6478BD642F)
_WYP1 = U64(0xE7037ED1A0B428DB)
_WYP2 = U64(0x8EBC6AF09C88C6E3)
_WYP3 = U64(0x589965CC75374CC3)
_WYP4 = U64(0x1D8E4E27C47D124F)


def _wymum(a, b):
    """Fold the 128-bit product to 64 bits: (a*b) low64 ^ high64."""
    return (a * b) ^ mulhi64(a, b)


def wyhash_u64(x, seed=U64(0)):
    """wyhash-v1 digest of the 8 little-endian bytes of ``x``.

    This is the exact call shape the reference uses per w-mer window
    (``BuildHasher::hash_one(u64)`` -> ``write(&le_bytes)`` + ``finish()``).
    Elementwise uint64; runs under NumPy or jax.numpy. The 8-byte tail of
    v1 reads the word as two 4-byte halves ``(lo32 << 32) | hi32`` — a
    32-bit rotation of the word.
    """
    if np.isscalar(seed) or isinstance(seed, (int, np.integer)):
        seed = U64(seed)
    if isinstance(x, (int, np.integer)):
        x = np.asarray(x, dtype=np.uint64)  # 0-d: silent u64 wraparound
    s = seed ^ _WYP0
    v = (x << U64(32)) | (x >> U64(32))  # (wyr4(p) << 32) | wyr4(p + 4)
    t = _wymum(v ^ s, s ^ _WYP1)
    return _wymum(t ^ U64(8), _WYP4)


def wyhash_bytes(data: bytes, seed: int = 0) -> int:
    """Scalar reference wyhash-v1 over an arbitrary byte buffer.

    Host-only oracle for tests (the vectorized path above covers the only
    shape the index uses: len == 8).
    """
    M = (1 << 64) - 1
    P0, P1, P2, P3, P4 = (int(_WYP0), int(_WYP1), int(_WYP2), int(_WYP3), int(_WYP4))

    def mum(a, b):
        r = (a & M) * (b & M)
        return ((r >> 64) ^ r) & M

    def r4(b):
        return int.from_bytes(b[:4], "little")

    def r8(b):
        return int.from_bytes(b[:8], "little")

    n = len(data)
    s = seed & M
    i = 0
    while i + 32 <= n:
        c = data[i : i + 32]
        s = mum(
            s ^ P0,
            mum(r8(c) ^ P1, r8(c[8:]) ^ P2) ^ mum(r8(c[16:]) ^ P3, r8(c[24:]) ^ P4),
        )
        i += 32
    s ^= P0
    rest = n & 31
    if rest:
        t = data[n - rest :]
        if rest < 4:
            v = (t[0] << 16) | (t[rest >> 1] << 8) | t[rest - 1]
            s = mum(v ^ s, s ^ P1)
        elif rest <= 8:
            v = (r4(t) << 32) | r4(t[rest - 4 :])
            s = mum(v ^ s, s ^ P1)
        else:
            raise NotImplementedError(
                "wyhash-v1 tails over 8 bytes are not reconstructed here; "
                "the index only hashes 8-byte words"
            )
    return mum(s ^ n, P4)
