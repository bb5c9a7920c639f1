"""Scatter-free lane compaction.

Compacting flagged lanes by cumsum+scatter pays N scatter updates, and a
prefix-sum rank + searchsorted select (``flagged_lanes_ss``) pays a
binary search over the [N] rank array — ~20 dependent element gathers —
PER EXTRACTED LANE.

This module computes the first-M flagged lane indices as an on-the-fly
HIERARCHICAL RANK-SELECT structure — the same select_1 design as
bits/bitvector.py, built per batch in registers:

    lanes -> 16-bit words -> blocks (16 words = 256 lanes, one 32-byte
    bit row) -> superblocks (64 blocks); cumulative counts per level.

    select(t):  superblock  by vectorized compare against sb_cum   [M, 64]
                block       by compare against the superblock's 64-entry
                            cum row (u16 rows from an ~8 KB table: cached)
                word + bit  by popcount over ONE 32-byte bit-row gather

Per extracted lane that is ~1 random gather into a large table (the bit
row) instead of log2(N); every other step is vector compares, tiny-table
gathers, and 16-wide cumsums. No full-batch prefix scan at all — level
counts are plain reductions. True set counts stay exact at any scale, so
the caller's over-budget check is unchanged.
"""

from __future__ import annotations

import numpy as np

_LPW = 16  # lanes per packed word (u16 bit-plane)
_WPB = 16  # words per block  -> 256 lanes, 32-byte bit rows
_BPS = 64  # blocks per superblock -> 16384 lanes


def _pop16(v, xp):
    # popcount of 16-bit values held in int32 (portable np/jnp bit-twiddle)
    v = v - ((v >> 1) & 0x5555)
    v = (v & 0x3333) + ((v >> 2) & 0x3333)
    v = (v + (v >> 4)) & 0x0F0F
    return (v + (v >> 8)) & 0x1F


def _rank_levels(flags, xp):
    """Pack flags into the 3-level structure. Returns
    (words u16 [n_blocks, _WPB], blk_cum i32 [n_sb, _BPS] inclusive,
    sb_cum i32 [n_sb] inclusive, n_blocks)."""
    n = flags.shape[0]
    blk = _LPW * _WPB
    n_blocks = max(1, -(-n // blk))
    n_sb = -(-n_blocks // _BPS)
    f = flags.astype(xp.int32)
    pad_lanes = n_blocks * blk - n
    if pad_lanes:
        f = xp.concatenate([f, xp.zeros(pad_lanes, dtype=xp.int32)])
    bits = f.reshape(n_blocks, _WPB, _LPW)
    shifts = xp.arange(_LPW, dtype=xp.int32)
    words = (bits << shifts[None, None, :]).sum(axis=2).astype(xp.uint16)
    blk_tot = bits.sum(axis=(1, 2))
    pad_blocks = n_sb * _BPS - n_blocks
    if pad_blocks:
        blk_tot = xp.concatenate(
            [blk_tot, xp.zeros(pad_blocks, dtype=blk_tot.dtype)]
        )
    blk_cum = xp.cumsum(blk_tot.reshape(n_sb, _BPS), axis=1).astype(xp.int32)
    sb_cum = xp.cumsum(blk_cum[:, -1]).astype(xp.int32)
    return words, blk_cum, sb_cum, n_blocks


def _select_first(words, blk_cum, sb_cum, n_blocks, n, m, xp):
    """lanes[t] = index of the (t+1)-th set flag, t in [0, m); in-bounds
    garbage past the true count (callers mask by slot < n_set)."""
    n_sb = sb_cum.shape[0]
    t = xp.arange(1, m + 1, dtype=xp.int32)  # 1-based targets [M]

    # superblock: count of superblocks whose running total is < t
    sb_id = (sb_cum[None, :] < t[:, None]).astype(xp.int32).sum(axis=1)
    sb_id = xp.minimum(sb_id, n_sb - 1)
    base_sb = xp.where(sb_id > 0, sb_cum[xp.maximum(sb_id - 1, 0)], 0)
    t_sb = t - base_sb

    # block within superblock: compare against the 64-entry cum row
    brow = blk_cum[sb_id]  # [M, _BPS] rows of a small (~KBs) table
    blk_in = (brow < t_sb[:, None]).astype(xp.int32).sum(axis=1)
    blk_in = xp.minimum(blk_in, _BPS - 1)
    iota_b = xp.arange(_BPS, dtype=xp.int32)
    base_blk = xp.where(
        iota_b[None, :] == (blk_in[:, None] - 1), brow, 0
    ).sum(axis=1)
    t_blk = t_sb - base_blk
    blk_id = xp.minimum(sb_id * _BPS + blk_in, n_blocks - 1)

    # word within block: ONE 32-byte bit-row gather + popcount cumsum
    wrow = words[blk_id].astype(xp.int32) & 0xFFFF  # [M, _WPB]
    wcum = xp.cumsum(_pop16(wrow, xp), axis=1)
    w_in = (wcum < t_blk[:, None]).astype(xp.int32).sum(axis=1)
    w_in = xp.minimum(w_in, _WPB - 1)
    iota_w = xp.arange(_WPB, dtype=xp.int32)
    base_w = xp.where(iota_w[None, :] == (w_in[:, None] - 1), wcum, 0).sum(axis=1)
    t_w = t_blk - base_w
    word = xp.where(iota_w[None, :] == w_in[:, None], wrow, 0).sum(axis=1)

    # bit within word
    bcum = xp.cumsum((word[:, None] >> iota_w[None, :]) & 1, axis=1)
    bit_in = (bcum < t_w[:, None]).astype(xp.int32).sum(axis=1)
    bit_in = xp.minimum(bit_in, _LPW - 1)

    lane = (blk_id * _WPB + w_in) * _LPW + bit_in
    return xp.clip(lane, 0, max(n - 1, 0)).astype(xp.int64)


def flagged_lanes(flags, m: int, xp):
    """Indices of the first ``m`` set flags.

    Returns (lanes int[m], n_set scalar). ``lanes[s]`` for ``s >= n_set``
    is in-bounds garbage — callers mask by ``s < n_set``.
    """
    n = flags.shape[0]
    if n == 0:
        return xp.zeros(m, dtype=xp.int64), xp.zeros((), dtype=xp.int64)
    words, blk_cum, sb_cum, n_blocks = _rank_levels(flags, xp)
    n_set = sb_cum[-1].astype(xp.int64)
    lanes = _select_first(words, blk_cum, sb_cum, n_blocks, n, m, xp)
    return lanes, n_set


def flagged_lanes2(flags_a, flags_b, m_a: int, m_b: int, xp):
    """Indices of the first ``m_a`` set flags_a and first ``m_b`` set
    flags_b (two independent hierarchical selects — each is gather-light,
    so no shared scan is needed). Returns (lanes_a, n_a, lanes_b, n_b);
    n_* are the TRUE counts even over budget."""
    la, na = flagged_lanes(flags_a, m_a, xp)
    lb, nb = flagged_lanes(flags_b, m_b, xp)
    return la, na, lb, nb


def flagged_lanes_ss(flags, m: int, xp):
    """Prefix-sum rank + searchsorted select: the plain form of
    ``flagged_lanes``, kept as its cross-check (a binary search over the
    [N] rank array per extracted lane)."""
    n = flags.shape[0]
    fi = flags.astype(xp.int32)
    rank = xp.cumsum(fi, dtype=xp.int32)  # inclusive; rank[-1] = n_set
    n_set = rank[-1].astype(xp.int64) if n else xp.int64(0)
    targets = xp.arange(1, m + 1, dtype=rank.dtype)
    lanes = xp.searchsorted(rank, targets, side="left")
    lanes = xp.clip(lanes, 0, max(n - 1, 0)).astype(xp.int64)
    return lanes, n_set
