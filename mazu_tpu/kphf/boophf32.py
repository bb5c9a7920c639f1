"""BooPHF32: a BBHash variant with 32-bit arithmetic.

Same minimal-perfect-hash scheme as BooPHF (levels of singleton bitmaps +
final hash), re-designed for 32-bit vector integer lanes:

- level sizes are powers of two -> position = hash & mask (no 64-bit
  Lemire mulhi)
- the per-level hash chain is a 32-bit xorshift128 over a state derived
  from the (up to 64-bit) key by one murmur-style fold — all u32 ops
- level bitmaps are u32 words with 256-bit rank blocks (u32 prefix counts,
  rank-once on the hit level)

Keys remain uint64 (k-mers / minimizer values); only the arithmetic is
32-bit. Used for self-built indexes (the pf1 load path keeps the
bit-exact 64-bit BooPHF).
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

U32 = np.uint32
U64 = np.uint64

_BLOCK_BITS = 256  # rank sample every 8 u32 words
_C1 = U32(0x85EBCA6B)
_C2 = U32(0xC2B2AE35)
_GOLD = U32(0x9E3779B9)


def mix32(x):
    """murmur3 fmix32."""
    x = x ^ (x >> U32(16))
    x = x * _C1
    x = x ^ (x >> U32(13))
    x = x * _C2
    return x ^ (x >> U32(16))


def fold_hash32(keys):
    """uint64 key -> u32 hash (two mults); the direct bucket-table hash."""
    lo = (keys & U64(0xFFFFFFFF)).astype(U32)
    hi = (keys >> U64(32)).astype(U32)
    return mix32(lo ^ _GOLD) ^ mix32(hi + _C2)


def fold_hash32b(keys, salt=0):
    """Independent second fold for two-choice (cuckoo) tables."""
    lo = (keys & U64(0xFFFFFFFF)).astype(U32)
    hi = (keys >> U64(32)).astype(U32)
    s = U32(salt & 0xFFFFFFFF)
    return mix32(lo + (_C1 ^ s)) ^ mix32(hi ^ (_GOLD + s))


def key_fold32(keys):
    """uint64 key -> (s0, s1) u32 chain state (one mult each)."""
    lo = (keys & U64(0xFFFFFFFF)).astype(U32)
    hi = (keys >> U64(32)).astype(U32)
    s0 = mix32(lo ^ _GOLD)
    s1 = mix32(hi ^ _C1) ^ lo
    return s0, s1


def chain_next(s0, s1):
    """xorshift128-ish step; returns (hash, s0', s1')."""
    t = s1 ^ (s1 << U32(13))
    t = t ^ (t >> U32(17))
    t = t ^ s0 ^ (s0 >> U32(5))
    return t + s0, s1, t


def _popcount(xp, x):
    if xp is np:
        return np.bitwise_count(np.asarray(x, dtype=np.uint32)).astype(np.int32)
    import jax.lax as lax

    return lax.population_count(x).astype(xp.int32)


@dataclass(frozen=True)
class BooPHF32Meta:
    n_bits: tuple  # per level, power of two
    word_offsets: tuple
    rank_offsets: tuple
    kind: str = "boophf32"


try:
    import jax

    jax.tree_util.register_static(BooPHF32Meta)
except Exception:  # pragma: no cover
    pass


@dataclass
class BooPHF32:
    n_elem: int
    last_bitset_rank: int
    levels: list  # [(n_bits, words u32[], ranks u32[] global-offset)]
    fh_keys: np.ndarray  # sorted u64
    fh_vals: np.ndarray  # u32 (already offset)
    gamma: float = 1.7

    @classmethod
    def build(cls, keys: np.ndarray, gamma: float = 1.7, max_levels: int = 12) -> "BooPHF32":
        keys = np.asarray(keys, dtype=np.uint64)
        n = len(keys)
        rem = keys
        s0, s1 = key_fold32(rem)
        levels = []
        from ..io.native import boophf32_level, compact_kept, have_native

        native = have_native()
        if native:
            rem = np.ascontiguousarray(rem)
            s0 = np.ascontiguousarray(s0)
            s1 = np.ascontiguousarray(s1)
        for _li in range(max_levels):
            if len(rem) == 0:
                break
            n_bits = 1 << max(5, int(np.ceil(np.log2(max(gamma * len(rem), 32)))))
            if native:
                # native level: same structure bit-for-bit (tested) — the
                # NumPy path's bincount allocs cost ~2,777s at 3Gbp
                words, drop = boophf32_level(rem, s0, s1, n_bits)
                levels.append((n_bits, words))
                rem, s0, s1 = compact_kept(rem, s0, s1, drop)
                continue
            h, s0, s1 = chain_next(s0, s1)
            pos = (h & U32(n_bits - 1)).astype(np.int64)
            counts = np.bincount(pos, minlength=n_bits)
            singleton = counts[pos] == 1
            words = np.zeros(n_bits // 32, dtype=np.uint32)
            spos = pos[singleton]
            np.bitwise_or.at(words, spos >> 5, U32(1) << (spos.astype(np.uint32) & U32(31)))
            levels.append((n_bits, words))
            keep = ~singleton
            rem, s0, s1 = rem[keep], s0[keep], s1[keep]

        out_levels = []
        offset = 0
        wpb = _BLOCK_BITS // 32
        for n_bits, words in levels:
            pc = np.bitwise_count(words).astype(np.int64)
            blk = np.add.reduceat(pc, np.arange(0, len(pc), wpb))
            ranks = (offset + np.concatenate([[0], np.cumsum(blk[:-1])])).astype(np.uint32)
            out_levels.append((n_bits, words, ranks))
            offset += int(pc.sum())

        fh_keys = np.sort(rem)
        fh_vals = (np.arange(len(rem)) + offset).astype(np.uint32)
        assert offset + len(rem) == n, "duplicate keys?"
        return cls(n, offset, out_levels, fh_keys, fh_vals, gamma)

    def lookup(self, keys) -> np.ndarray:
        d = self.device_arrays()
        keys = np.asarray(keys, dtype=np.uint64)
        from ..io.native import boophf32_lookup_batch

        res = boophf32_lookup_batch(d, keys)
        if res is not None:  # bit-parity with the NumPy path (tested)
            return res
        return np.asarray(boophf32_lookup(d, keys, np))

    def num_bits(self) -> int:
        nb = sum(32 * len(w) + 32 * len(r) for (_, w, r) in self.levels)
        return nb + 96 * len(self.fh_keys)

    def device_arrays(self, mrows: bool = False) -> dict:
        def padded(n_bits, w):
            n_blocks = -(-n_bits // _BLOCK_BITS)
            out = np.zeros(n_blocks * 8, dtype=np.uint32)
            out[: len(w)] = w
            return out

        words = (
            np.concatenate([padded(n, w) for (n, w, _) in self.levels])
            if self.levels
            else np.zeros(0, dtype=np.uint32)
        )
        ranks = (
            np.concatenate([r for (_, _, r) in self.levels])
            if self.levels
            else np.zeros(0, dtype=np.uint32)
        )
        fh_keys = self.fh_keys
        if len(fh_keys) == 0:
            fh_keys = np.array([0xFFFFFFFFFFFFFFFF], dtype=np.uint64)
            fh_vals = np.array([0], dtype=np.uint32)
        else:
            fh_vals = self.fh_vals
        nb = tuple(int(n) for (n, _, _) in self.levels)
        d = {
            "words": words,
            "ranks": ranks,
            "fh_keys": fh_keys,
            "fh_vals": fh_vals,
        }
        if mrows:
            # paired word|rank rows (one gather per level test):
            # mrows[i] = level word i | (GLOBAL cumulative popcount
            # below word i) << 32 — the stored values are rank-offset
            # across levels (level padding words are zero, so the straight
            # cumsum over the concatenated padded words IS the global
            # offset). The level bit-test gather then carries the whole
            # rank, collapsing the 9-op block-rank tail (1 ranks + 7 loop
            # words + 1 masked word) to ZERO post-loop gathers. OPT-IN
            #: the u64 rows are 2x the words array — HBM-tight
            # placements and native-host consumers keep the lean layout.
            # words+ranks are dropped: the mrows lookup never reads them.
            pc = np.bitwise_count(words.astype(np.uint32)).astype(np.uint64)
            csum = np.concatenate([[0], np.cumsum(pc)[:-1]]).astype(np.uint64)
            d = {
                "mrows": words.astype(np.uint64) | (csum << np.uint64(32)),
                "fh_keys": fh_keys,
                "fh_vals": fh_vals,
            }
        d["meta"] = BooPHF32Meta(
            n_bits=nb,
            word_offsets=tuple(
                int(x)
                for x in np.cumsum([0] + [8 * (-(-n // _BLOCK_BITS)) for n in nb])[:-1]
            ),
            rank_offsets=tuple(
                int(x)
                for x in np.cumsum([0] + [-(-n // _BLOCK_BITS) for n in nb])[:-1]
            ),
        )
        return d


def boophf32_lookup(d: dict, keys, xp, level_limit: int | None = None):
    """Batched lookup; int32 values, -1 for definite misses. All-u32 hot path.

    ``level_limit``: truncated SPEED mode for two-phase drivers. Only the
    first ``level_limit`` level bit-tests run (each is one random word
    gather — with gamma=1.7 level hit rates decay ~0.45x/level, so 4
    levels settle ~96% of keys) and the final-hash ``searchsorted``
    binary search (log2(n_fh) dependent gathers paid by EVERY lane) is
    skipped entirely. Lanes that hit no tested level are UNRESOLVED (they
    may live in a deeper level, in the final hash, or be misses) and the
    return becomes ``(res, unresolved)`` — the caller MUST re-run those
    lanes through the full lookup (see get_ref_pos_compact's type-B
    phase). Lanes that do hit a level get their exact value: rank only
    reads the hit level, identical to the full path.
    """
    meta: BooPHF32Meta = d["meta"]
    keys = xp.asarray(keys)
    n_levels = len(meta.n_bits)
    n_test = n_levels if level_limit is None else min(max(int(level_limit), 1), n_levels)
    s0, s1 = key_fold32(keys)
    use_mrows = "mrows" in d
    hit_level = None
    hit_pos = None
    hit_rank = None
    for li in range(n_test):
        h, s0, s1 = chain_next(s0, s1)
        pos = (h & U32(meta.n_bits[li] - 1)).astype(xp.int32)
        woff = meta.word_offsets[li]
        if use_mrows:
            # paired word|rank row: the level bit-test gather ALSO
            # carries the per-level rank below this word — the whole
            # lookup is n_test gather ops, no rank tail (round 4)
            row = d["mrows"][woff + (pos >> 5)]
            wrd = (row & np.uint64(0xFFFFFFFF)).astype(xp.uint32)
            bit = ((wrd >> (pos.astype(xp.uint32) & U32(31))) & U32(1)) != 0
            off = (pos & 31).astype(xp.uint32)
            mask = xp.where(
                off == 0, U32(0), (~U32(0)).astype(xp.uint32) >> (U32(32) - off)
            )
            r_li = (row >> np.uint64(32)).astype(xp.int32) + _popcount(
                xp, wrd & mask
            )
        else:
            bit = (
                (d["words"][woff + (pos >> 5)] >> (pos.astype(xp.uint32) & U32(31)))
                & U32(1)
            ) != 0
            r_li = None
        if hit_level is None:
            hit_level = xp.where(bit, xp.int32(0), xp.int32(-1))
            hit_pos = xp.where(bit, pos, xp.zeros_like(pos))
            if use_mrows:
                hit_rank = xp.where(bit, r_li, xp.zeros_like(r_li))
        else:
            newly = bit & (hit_level < 0)
            hit_level = xp.where(newly, xp.int32(li), hit_level)
            hit_pos = xp.where(newly, pos, hit_pos)
            if use_mrows:
                hit_rank = xp.where(newly, r_li, hit_rank)
    if hit_level is None:
        hit_level = xp.full(xp.shape(keys), -1, dtype=xp.int32)
        hit_pos = xp.zeros(xp.shape(keys), dtype=xp.int32)
        hit_rank = xp.zeros(xp.shape(keys), dtype=xp.int32)

    if use_mrows:
        r = hit_rank
    else:
        lvl = xp.clip(hit_level, 0, max(n_levels - 1, 0))
        woff_t = xp.asarray(np.array(meta.word_offsets or (0,), dtype=np.int32))
        roff_t = xp.asarray(np.array(meta.rank_offsets or (0,), dtype=np.int32))
        wo = woff_t[lvl]
        ro = roff_t[lvl]
        word_idx = hit_pos >> 5
        block = hit_pos >> 8
        block_start = block << 3
        r = d["ranks"][ro + block].astype(xp.int32)
        for i in range(7):
            wid = block_start + i
            w = d["words"][wo + wid]
            use = wid < word_idx
            r = r + xp.where(use, _popcount(xp, w), xp.zeros_like(r))
        off = (hit_pos & 31).astype(xp.uint32)
        mask = xp.where(off == 0, U32(0), (~U32(0)).astype(xp.uint32) >> (U32(32) - off))
        r = r + _popcount(xp, d["words"][wo + word_idx] & mask)

    res = xp.where(hit_level >= 0, r, xp.full(xp.shape(keys), -1, dtype=xp.int32))

    if level_limit is not None:
        return res, hit_level < 0

    fhk = d["fh_keys"]
    idx = xp.searchsorted(fhk, keys)
    idx = xp.clip(idx, 0, len(fhk) - 1)
    fh_hit = (fhk[idx] == keys) & (hit_level < 0)
    res = xp.where(fh_hit, d["fh_vals"][idx].astype(xp.int32), res)
    return res
