"""Vectorized k-mer word math.

K-mer representation ("LSB-first", matching the 2-bit packed sequence layout
used by sdsl / pufferfish seq.bin and the reference's external ``kmers`` crate
(see reference src/unitig_set.rs:226-229: ``get_kmer_u64`` is a raw 2k-bit
window read of the packed sequence)):

- base codes: A=0, C=1, G=2, T=3
- base ``i`` of a k-mer occupies bits ``[2*i, 2*i+2)`` of a uint64 word,
  i.e. the FIRST base sits in the LOWEST bits.
- k <= 31 so a k-mer always fits 62 bits.

All functions are elementwise over arrays of words and work with either
NumPy (host) or jax.numpy (device, under jit). Constants are np.uint64 so
dtype promotion stays in uint64 in both.

Reference parity notes:
- revcomp/canonical semantics match ``kmers::naive_impl::CanonicalKmer``
  as used by reference src/kphf/sshash.rs:471-554 (empirically verified
  against the pufferfish C++ fixtures in test_data/pf1).
- match types (reference ``MatchType``): 0=NoMatch, 1=IdentityMatch,
  2=TwinMatch (see mazu_tpu.__init__).
"""

from __future__ import annotations

import numpy as np

U64 = np.uint64

# 2-bit group masks
_M2 = U64(0x3333333333333333)
_M4 = U64(0x0F0F0F0F0F0F0F0F)
_M8 = U64(0x00FF00FF00FF00FF)
_M16 = U64(0x0000FFFF0000FFFF)
_M32 = U64(0x00000000FFFFFFFF)

_FULL = U64(0xFFFFFFFFFFFFFFFF)

# base encode/decode (host only)
_BASE_TO_CODE = np.full(256, 255, dtype=np.uint8)
for _b, _c in zip(b"ACGT", range(4)):
    _BASE_TO_CODE[_b] = _c
for _b, _c in zip(b"acgt", range(4)):
    _BASE_TO_CODE[_b] = _c
_CODE_TO_BASE = np.frombuffer(b"ACGT", dtype=np.uint8)


def mask2k(k):
    """uint64 mask of the low 2k bits."""
    k = int(k)
    if k >= 32:
        return _FULL
    return U64((1 << (2 * k)) - 1)


def seq_to_codes(seq: bytes | str) -> np.ndarray:
    """ASCII DNA -> uint8 base codes (255 for non-ACGT). Host-side."""
    if isinstance(seq, str):
        seq = seq.encode()
    return _BASE_TO_CODE[np.frombuffer(seq, dtype=np.uint8)]


def codes_to_seq(codes: np.ndarray) -> str:
    return _CODE_TO_BASE[np.asarray(codes, dtype=np.uint8)].tobytes().decode()


def kmer_from_str(s: str) -> int:
    """Pack an ASCII k-mer into a uint64 word (first base in low bits)."""
    codes = seq_to_codes(s)
    assert (codes < 4).all(), f"invalid base in {s!r}"
    w = U64(0)
    for i, c in enumerate(codes):
        w |= U64(int(c)) << U64(2 * i)
    return w


def kmer_to_str(w, k: int) -> str:
    w = int(w)
    return "".join("ACGT"[(w >> (2 * i)) & 3] for i in range(int(k)))


def reverse_groups(x):
    """Reverse the order of all 32 2-bit groups in uint64 word(s)."""
    x = ((x >> U64(2)) & _M2) | ((x & _M2) << U64(2))
    x = ((x >> U64(4)) & _M4) | ((x & _M4) << U64(4))
    x = ((x >> U64(8)) & _M8) | ((x & _M8) << U64(8))
    x = ((x >> U64(16)) & _M16) | ((x & _M16) << U64(16))
    x = (x >> U64(32)) | (x << U64(32))
    return x


def revcomp(x, k: int):
    """Reverse complement of k-mer word(s) ``x``.

    Complement is XOR with all-ones per base (A<->T, C<->G); reversal moves
    base i to base k-1-i. High garbage bits are shifted out.
    """
    return reverse_groups(~x) >> U64(64 - 2 * int(k))


def canonicalize(x, k: int):
    """Return (canonical_word, is_fw, rc_word).

    canonical = numerically smaller of (fw, rc) in LSB-first encoding;
    is_fw is True (1) when the forward word is canonical (ties -> fw).
    """
    rc = revcomp(x, k)
    is_fw = x <= rc
    canon = _where(is_fw, x, rc)
    return canon, is_fw, rc


def _where(cond, a, b):
    # numpy and jnp both expose .where via the module of the operands;
    # use duck typing through numpy's __array_function__ / jnp arrays.
    try:
        import jax.numpy as jnp
        import jax.core

        if isinstance(cond, jnp.ndarray) or isinstance(a, jnp.ndarray) or isinstance(b, jnp.ndarray):
            return jnp.where(cond, a, b)
    except Exception:
        pass
    return np.where(cond, a, b)


def word_equivalency(fw, rc, target, k: int):
    """MatchType of a canonical k-mer query (fw, rc) vs target word(s).

    Parity: kmers crate ``get_word_equivalency`` as used in reference
    src/kphf/sshash.rs:503. Returns 1 (identity: fw == target),
    2 (twin: rc == target), else 0.
    """
    m = mask2k(k)
    t = target & m
    one = np.uint8(1)
    two = np.uint8(2)
    zero = np.uint8(0)
    return _where(fw == t, one, _where(rc == t, two, zero))


def reverse_match_type(mt):
    """Swap Identity <-> Twin, keep NoMatch — the match type of the same hit
    as seen from the reverse-complement query (parity: K2UPos
    ``reverse_match_type``, reference src/kphf/mod.rs:22-29)."""
    return _where(mt == 0, mt, mt ^ np.uint8(3))  # 1 <-> 2 via xor 3


# ----------------------------------------------------------------------------
# Hashing for minimizer ordering
# ----------------------------------------------------------------------------

_SPLIT_C0 = U64(0x9E3779B97F4A7C15)
_SPLIT_C1 = U64(0xBF58476D1CE4E5B9)
_SPLIT_C2 = U64(0x94D049BB133111EB)


def mix64(x, seed=U64(0)):
    """Seeded splitmix64-style finalizer.

    Default minimizer ordering hash. This replaces the reference's seeded
    wyhash (reference src/kphf/mod.rs:32-52) — the choice of ordering hash
    only affects which w-mer is the minimizer, never query results, and this
    mix uses only mul-lo/xor/shift, which maps cleanly onto vector integer
    lanes. A wyhash-v1 ordering (mazu_tpu.hashes.wyhash_u64, reconstructed —
    see its provenance note) is selectable via ``ordering="wyhash"`` /
    ``SSHash.from_unitig_set(minimizer_hash="wyhash")`` for parity
    experiments.
    """
    z = x ^ (U64(seed) * _SPLIT_C0)
    z = (z ^ (z >> U64(30))) * _SPLIT_C1
    z = (z ^ (z >> U64(27))) * _SPLIT_C2
    return z ^ (z >> U64(31))


# ----------------------------------------------------------------------------
# Canonical minimizers
# ----------------------------------------------------------------------------


def canonical_minimizer_batch(
    xp, words, k: int, w: int, seed=0, hash32: bool = False, ordering: str | None = None
):
    """Canonical minimizer of each k-mer word in ``words``.

    Contract (matches the reference's deviation notes, src/kphf/sshash.rs:32-37:
    ``mini(g*) = mini(min(g, g'))``):

    - c = canonical(g); consider the k-w+1 w-mer windows of c
    - the minimizer is the window minimizing (hash, value) with leftmost
      tie-break; let j be its offset in c
    - returned ``offset`` is the position in g (the queried orientation) of
      the occurrence of the minimizer (or its revcomp): j if c == g else
      k - w - j.

    Returns (mm_value u64[N], offset i32[N], is_fw bool[N], canon u64[N]).

    ``xp`` is numpy or jax.numpy; shapes are static: the window scan is an
    unrolled (N, k-w+1) computation that XLA fuses into vector ops.
    """
    k = int(k)
    w = int(w)
    n_win = k - w + 1
    mw = mask2k(w)
    seed = U64(seed)
    if ordering is None:
        ordering = "mix32" if hash32 else "mix64"
    hash32 = ordering == "mix32"
    if hash32:
        # mix32 scores the LOW 32 BITS of the w-mer value (mv.astype(u32)
        # truncates, matching native minimizer_scan32's (uint32_t)mv cast
        # bit-for-bit — parity fuzz in tests/test_kmer.py). For w > 16 the
        # ordering therefore ignores the high bases of each window; ties
        # are vanishingly rare over k-w+1 windows and break leftmost the
        # same way in every implementation, so build/query stay exact.
        # Downstream consumers (fold_hash32 bucket map, BooPHF chains)
        # hash the full u64 mm value.
        assert w <= 32, "minimizer value must fit u64 (w <= 32)"
        from .kphf.boophf32 import mix32

        seed32 = np.uint32(int(seed) & 0xFFFFFFFF)
    elif ordering == "wyhash":
        from .hashes import wyhash_u64

    canon, is_fw, _rc = canonicalize(words, k)

    best_val = None
    best_score = None
    best_j = None
    for j in range(n_win):
        mv = (canon >> U64(2 * j)) & mw
        if hash32:
            sc = mix32(mv.astype(xp.uint32) ^ seed32)
        elif ordering == "wyhash":
            sc = wyhash_u64(mv, seed)
        else:
            sc = mix64(mv, seed)
        if best_val is None:
            best_val, best_score = mv, sc
            best_j = xp.zeros(xp.shape(sc), dtype=xp.int32)
        else:
            better = sc < best_score  # strict: leftmost wins ties
            best_val = xp.where(better, mv, best_val)
            best_j = xp.where(better, xp.int32(j), best_j)
            best_score = xp.where(better, sc, best_score)

    offset = xp.where(is_fw, best_j, xp.int32(k - w) - best_j)
    return best_val, offset.astype(xp.int32), is_fw, canon
