"""KCDict: cuckoo-addressed canonical k-mer dictionary (speed-king K2U).

An alternative to SSHash/PFHash (same K2U contract as reference
src/kphf/mod.rs:58-66) built for a gather cost model: a random row fetch
costs, the consecutive bytes of that row are nearly free, and
multi-structure probes multiply the fetches.

Design: two-choice cuckoo table of buckets with S=2 slots. Each slot
stores the canonical k-mer itself plus everything the full query needs.
Slim layout (unitig lengths < 2^24; the norm):

    slot u32[7]: klo, khi|flag, uid, upos24|ulen_lo8, ulen_hi16|cnt16,
                 occ_lo, occ_hi            -> 56B buckets (fast-gather)

Wide fallback (giant unitigs): slot u32[8] with separate upos/ulen/cnt
(64B buckets). The query is:

    canon -> h1, h2 (two u32 hashes)  [no minimizer scan at all]
    row1 = table[h1]; row2 = table[h2]          (2 random gathers)
    compare canon against the S*2 stored k-mers  (elementwise)

Misses simply match nothing — there is no skew index, no MPHF, no
verification fetch into useq, and no overflow path: the cuckoo build
guarantees every key is in one of its two buckets. Single-occurrence
unitigs (occ_word/occ_cnt ride the slot) project with zero extra gathers.

Space: ~(64/S loaded) bytes per k-mer — a deliberate speed-for-space trade
(the parity engines keep ~9 bits/k-mer).
"""

from __future__ import annotations

import numpy as np

from ..containers.unitig_set import UnitigSet
from ..kmer import revcomp, word_equivalency
from ..pytree import meta
from .boophf32 import fold_hash32, fold_hash32b, mix32

U64 = np.uint64
U32 = np.uint32
SLOTS = 2  # slots per bucket


class KCDict:
    def __init__(self, unitigs: UnitigSet, table: np.ndarray, T: int, salt: int):
        self.unitigs = unitigs
        self.table = table  # u32 [T, SLOTS*sw]
        self.T = int(T)
        self.salt = int(salt)
        self.scheme = "cuckoo"  # "cuckoo" (2-choice) | "mono"/"mono2" (1 hash + side)
        self.side = None  # mono: cuckoo side table holding displaced keys
        self.side_T = 0
        self.side_salt = 0
        self.occ32 = False  # mono2: occ words stored as single u32 cols

    @property
    def slot_words(self) -> int:
        return self.table.shape[1] // SLOTS

    # ----------------------------------------------------------------- build
    @classmethod
    def from_unitig_set(
        cls,
        unitigs: UnitigSet,
        load: float = 0.65,
        occ_table=None,
        scheme: str = "cuckoo",
    ) -> "KCDict":
        """Host build: enumerate every canonical k-mer with its unitig
        mapping, then bucket placement.

        ``scheme="cuckoo"``: two-choice placement (round-randomized parallel
        cuckoo, same scheme as SSHash._place_skew_cuckoo) — every key is in
        one of its two buckets, query = 2 random row gathers.

        ``scheme="mono"``: SINGLE-hash placement — the common-case query is
        ONE random row gather. Keys displaced from a full bucket live in a
        small two-choice side table consulted only by the full (phase-2)
        query; the main-phase kernel flags not-found lanes as unresolved.
        Use a low ``load`` (e.g. 0.0625): displaced fraction ~ Poisson
        E[max(X-2,0)]/lambda (~0.2% at lambda=0.125).

        ``scheme="mono2"``: like "mono" but each 36B slot also carries the
        unitig's SECOND encoded occurrence, and the two slots of a bucket
        are stored as CONSECUTIVE table rows — the probe is one random row
        gather plus one adjacent-row gather (nearly free), and cnt <= 2
        lanes project inline (the overflow class drops to cnt > 2 plus the
        ~0.2% displaced keys).

        ``occ_table``: optional U2Pos table; when given, each slot carries
        the unitig's first encoded occurrence + count (fused projection).
        """
        k = unitigs.k
        assert unitigs.total_len < (1 << 31)
        kpos = unitigs.kmer_start_positions()
        words = unitigs.get_kmer_u64(kpos)
        canon = np.minimum(words, revcomp(words, k))
        canon_is_useq = canon == words  # stored orientation flag (bit 31 of khi)
        uid = unitigs.pos_to_id(kpos)
        start = unitigs.accum[uid]
        ulen = unitigs.accum[uid + 1] - start
        upos = kpos - start

        n = len(canon)
        n_buckets = 1 << max(6, int(np.ceil(np.log2(max(n / (SLOTS * load), 64)))))
        if scheme in ("mono", "mono2"):
            h1 = (fold_hash32(canon) & U32(n_buckets - 1)).astype(np.int64)
            order = np.argsort(h1, kind="stable")
            bs = h1[order]
            run_start = np.ones(n, dtype=bool)
            if n:
                run_start[1:] = bs[1:] != bs[:-1]
            run_id = np.cumsum(run_start) - 1
            starts = np.flatnonzero(run_start)
            within = np.arange(n) - starts[run_id]
            win_sorted = within < SLOTS
            win = np.zeros(n, dtype=bool)
            win[order] = win_sorted
            slot = np.zeros(n, dtype=np.int64)
            slot[order] = np.where(win_sorted, within, 0)
            bucket = h1
            salt = 0
            side_idx = np.flatnonzero(~win)
        else:
            placed = _place_two_choice(canon, n_buckets)
            while placed is None:
                n_buckets <<= 1
                placed = _place_two_choice(canon, n_buckets)
            bucket, slot, salt = placed
            side_idx = None

        if occ_table is not None:
            if hasattr(occ_table.ctable, "to_array"):
                cwords = occ_table.ctable.to_array()
            else:
                cwords = np.asarray(occ_table.ctable)
            off = occ_table.offsets
            first = cwords[np.clip(off[uid], 0, max(len(cwords) - 1, 0))]
            cnt = (off[uid + 1] - off[uid]).astype(np.uint64)
            second = cwords[np.clip(off[uid] + 1, 0, max(len(cwords) - 1, 0))]
        else:
            first = np.zeros(n, dtype=np.uint64)
            cnt = np.zeros(n, dtype=np.uint64)
            second = np.zeros(n, dtype=np.uint64)
        khi = (canon >> U64(32)).astype(U32) | (canon_is_useq.astype(U32) << U32(31))
        klo = (canon & U64(0xFFFFFFFF)).astype(U32)
        slim = bool((ulen < (1 << 24)).all())
        if slim:
            cnt16 = np.minimum(cnt, 0xFFFF).astype(U32)  # clamp: >width always
            A = (upos.astype(U32) & U32(0xFFFFFF)) | (
                (ulen.astype(U32) & U32(0xFF)) << U32(24)
            )
            B = ((ulen.astype(U32) >> U32(8)) & U32(0xFFFF)) | (cnt16 << U32(16))
            cols = [
                klo,
                khi,
                uid.astype(U32),
                A,
                B,
                (first & U64(0xFFFFFFFF)).astype(U32),
                (first >> U64(32)).astype(U32),
            ]
        else:
            cols = [
                klo,
                khi,
                uid.astype(U32),
                upos.astype(U32),
                ulen.astype(U32),
                (first & U64(0xFFFFFFFF)).astype(U32),
                (first >> U64(32)).astype(U32),
                np.minimum(cnt, 0xFFFFFFFF).astype(U32),
            ]
        occ32 = False
        if scheme == "mono2":
            occ32 = slim and occ_table is not None and bool(
                (first < (1 << 32)).all() and (second < (1 << 32)).all()
            )
            if occ32:
                # u32-occ specialization (chromosome-scale indexes): BOTH
                # occurrences ride the slot in ONE u32 each -> 28B slots,
                # 56B bucket rows, single-gather probe with mono2 overflow
                cols = cols[:5] + [
                    first.astype(U32),
                    second.astype(U32),
                ]
            else:  # 36B slots with the SECOND occurrence in two u32 cols
                cols.append((second & U64(0xFFFFFFFF)).astype(U32))
                cols.append((second >> U64(32)).astype(U32))
        sw = len(cols)
        table = np.zeros((n_buckets, SLOTS * sw), dtype=np.uint32)
        # empty slots: klo=0xFFFFFFFF with khi&0x7FFFFFFF=0x7FFFFFFF can never
        # match a canonical k-mer for k <= 31 (high word < 2^30; and an
        # all-ones low word implies the canonical form would be all-A)
        table[:, 0::sw] = U32(0xFFFFFFFF)
        table[:, 1::sw] = U32(0xFFFFFFFF)
        if side_idx is None:
            col = slot * sw
            for j, c in enumerate(cols):
                table[bucket, col + j] = c
            return cls(unitigs, table, n_buckets, salt)

        # mono: winners into the main table, displaced keys into a small
        # two-choice side table with the same slot encoding
        win = np.ones(n, dtype=bool)
        win[side_idx] = False
        colw = (slot * sw)[win]
        bw = bucket[win]
        for j, c in enumerate(cols):
            table[bw, colw + j] = c[win]
        self = cls(unitigs, table, n_buckets, salt)
        self.scheme = scheme
        self.occ32 = occ32
        ns = len(side_idx)
        if ns:
            side_T = 1 << max(6, int(np.ceil(np.log2(max(ns / SLOTS / 0.3, 64)))))
            placed = _place_two_choice(canon[side_idx], side_T)
            while placed is None:
                side_T <<= 1
                placed = _place_two_choice(canon[side_idx], side_T)
            sbucket, sslot, ssalt = placed
            side = np.zeros((side_T, SLOTS * sw), dtype=np.uint32)
            side[:, 0::sw] = U32(0xFFFFFFFF)
            side[:, 1::sw] = U32(0xFFFFFFFF)
            scol = sslot * sw
            for j, c in enumerate(cols):
                side[sbucket, scol + j] = c[side_idx]
            self.side = side
            self.side_T = side_T
            self.side_salt = ssalt
        return self

    @property
    def k(self) -> int:
        return self.unitigs.k

    @property
    def n_kmers(self) -> int:
        return self.unitigs.n_kmers

    def num_bits(self) -> int:
        side = 0 if self.side is None else self.side.nbytes
        return 64 + self.unitigs.num_bits() + 8 * (self.table.nbytes + side)

    def print_stats(self, log=print):
        log(f"kmers: {self.n_kmers}")
        log(f"buckets: {self.T} x {SLOTS} slots")
        log(f"bits / kmer: {self.num_bits() / self.n_kmers:.3f}")

    def device_arrays(self) -> dict:
        sw = self.slot_words
        # mono2 without the u32-occ specialization: ship SLOT-rows (36B) —
        # probe j=0 is the only random gather, slot 1 is the adjacent row.
        # With occ32 the bucket row is 56B and probes in ONE gather.
        split = self.scheme == "mono2" and not self.occ32
        d = {
            "table": self.table.reshape(-1, sw) if split else self.table,
            "us": self.unitigs.device_arrays(),
            "meta": meta(
                kind="kcdict",
                k=self.k,
                t=self.T,
                salt=self.salt,
                fused=True,
                sw=sw,
                scheme=self.scheme,
                side_t=self.side_T,
                side_salt=self.side_salt,
                occ32=self.occ32,
                split=split,
            ),
        }
        if self.side is not None:
            d["side"] = self.side.reshape(-1, sw) if split else self.side
        return d


def _place_two_choice(keys: np.ndarray, n_buckets: int):
    """Round-randomized parallel two-choice placement with SLOTS slots per
    bucket. Returns (bucket i64[n], slot i64[n], salt) or None."""
    n = len(keys)
    klo = (keys & U64(0xFFFFFFFF)).astype(U32)
    for salt in range(4):
        h1 = (fold_hash32(keys) & U32(n_buckets - 1)).astype(np.int64)
        h2 = (fold_hash32b(keys, salt) & U32(n_buckets - 1)).astype(np.int64)
        side = np.zeros(n, dtype=bool)
        for rnd in range(512):
            b = np.where(side, h2, h1)
            prio = mix32(klo ^ U32((rnd * 2654435761) % (1 << 32)))
            packed = (b.astype(U64) << U64(32)) | prio.astype(U64)
            order = np.argsort(packed)
            bs = b[order]
            # winners: the first SLOTS entries of each bucket run (sorted)
            run_start = np.ones(n, dtype=bool)
            run_start[1:] = bs[1:] != bs[:-1]
            run_id = np.cumsum(run_start) - 1
            starts = np.flatnonzero(run_start)
            within = np.arange(n) - starts[run_id]
            winner_sorted = within < SLOTS
            winner = np.zeros(n, dtype=bool)
            winner[order] = winner_sorted
            slot = np.zeros(n, dtype=np.int64)
            slot[order] = np.where(winner_sorted, within, 0)
            losers = ~winner
            if not losers.any():
                return np.where(side, h2, h1), slot, salt
            flip = losers & ((prio & U32(1)) == 1)
            if not flip.any():
                flip = losers
            side = side ^ flip
    return None


# ---------------------------------------------------------------------------
# Batched device query
# ---------------------------------------------------------------------------


def kcdict_k2u(d: dict, fw_words, xp, mode: str = "full", bucket_range=None):
    """Batched K2U: random row gather(s), elementwise compare, fused
    occurrence projection data. Returns the sshash_k2u-compatible dict
    (unitig_id, unitig_len, pos, mt, occ_word, occ_cnt).

    scheme="cuckoo": two gathers of the main table; every key is in one of
    its two buckets (use_skew/unresolved always False).

    scheme="mono": ONE gather of the main table; in mode="main" lanes not
    found there are flagged unresolved (displaced key or true miss — the
    compacted phase 2 sorts it out). mode="full" additionally probes the
    two-choice side table, so full results are exact for every key.

    ``bucket_range=(blo, bhi)`` (mono/mono2 only): ``d["table"]`` holds
    only buckets [blo, bhi) and this shard answers only lanes whose main
    hash falls in that range — every output field is exact-zero for other
    lanes, so a one-hot psum over bucket shards reassembles the full
    result (parallel/sharding.make_mono_sharded_query). The side table is
    replicated but the h1 owner alone reports side hits."""
    m = d["meta"]
    k = m.k
    if xp is not np:
        import jax

        d = jax.tree_util.tree_map(xp.asarray, d)
    fw = xp.asarray(fw_words)
    rc = revcomp(fw, k)
    canon = xp.minimum(fw, rc)

    scheme = getattr(m, "scheme", "cuckoo")
    mono = scheme in ("mono", "mono2")
    mono2 = scheme == "mono2"
    occ32 = bool(getattr(m, "occ32", False))
    # split: mono2 slot-rows (36B, two gathers); occ32 mono2 keeps 56B
    # bucket rows probed in ONE gather
    split = bool(getattr(m, "split", mono2 and not occ32))

    zero = xp.zeros(xp.shape(canon), dtype=xp.int64)
    found = xp.zeros(xp.shape(canon), dtype=bool)
    out_uid, out_ulen, out_pos, out_oc = zero, zero, zero, zero
    out_mt = xp.zeros(xp.shape(canon), dtype=xp.uint8)
    out_ow = xp.zeros(xp.shape(canon), dtype=xp.uint64)
    out_ow2 = xp.zeros(xp.shape(canon), dtype=xp.uint64) if mono2 else None

    clo = (canon & U64(0xFFFFFFFF)).astype(xp.uint32)
    chi = (canon >> U64(32)).astype(xp.uint32)
    is_fw_canon = fw == canon

    sw = getattr(m, "sw", 8)

    def probe(table, h):
        nonlocal found, out_uid, out_ulen, out_pos, out_oc, out_mt, out_ow, out_ow2
        row = table[h]  # [N, SLOTS*sw] u32 (split mono2: [N, sw] slot rows)
        for s in range(1 if split else SLOTS):
            c = s * sw
            khi = row[..., c + 1]
            hit = (
                (~found)
                & (row[..., c + 0] == clo)
                & ((khi & np.uint32(0x7FFFFFFF)) == chi)
            )
            # IDENTITY when the query's fw orientation matches the k-mer as
            # written in useq (parity: word_equivalency vs the useq word);
            # bit 31 of khi records whether canonical == useq orientation
            canon_is_useq = (khi >> np.uint32(31)) != 0
            mt = xp.where(
                is_fw_canon == canon_is_useq, xp.uint8(1), xp.uint8(2)
            )
            out_uid = xp.where(hit, row[..., c + 2].astype(xp.int64), out_uid)
            ow2 = None
            if sw in (7, 9) and not occ32:  # slim: upos24|ulen_lo8, ulen_hi16|cnt16
                A = row[..., c + 3]
                B = row[..., c + 4]
                upos = (A & np.uint32(0xFFFFFF)).astype(xp.int64)
                ulen = ((A >> np.uint32(24)).astype(xp.int64)) | (
                    (B & np.uint32(0xFFFF)).astype(xp.int64) << 8
                )
                cnt = (B >> np.uint32(16)).astype(xp.int64)
                ow = row[..., c + 5].astype(xp.uint64) | (
                    row[..., c + 6].astype(xp.uint64) << U64(32)
                )
                if mono2:
                    ow2 = row[..., c + 7].astype(xp.uint64) | (
                        row[..., c + 8].astype(xp.uint64) << U64(32)
                    )
            elif occ32:  # slim + u32 occ words: both occs in single cols
                A = row[..., c + 3]
                B = row[..., c + 4]
                upos = (A & np.uint32(0xFFFFFF)).astype(xp.int64)
                ulen = ((A >> np.uint32(24)).astype(xp.int64)) | (
                    (B & np.uint32(0xFFFF)).astype(xp.int64) << 8
                )
                cnt = (B >> np.uint32(16)).astype(xp.int64)
                ow = row[..., c + 5].astype(xp.uint64)
                ow2 = row[..., c + 6].astype(xp.uint64)
            else:
                upos = row[..., c + 3].astype(xp.int64)
                ulen = row[..., c + 4].astype(xp.int64)
                cnt = row[..., c + 7].astype(xp.int64)
                ow = row[..., c + 5].astype(xp.uint64) | (
                    row[..., c + 6].astype(xp.uint64) << U64(32)
                )
                if mono2:
                    ow2 = row[..., c + 8].astype(xp.uint64) | (
                        row[..., c + 9].astype(xp.uint64) << U64(32)
                    )
            out_pos = xp.where(hit, upos, out_pos)
            out_ulen = xp.where(hit, ulen, out_ulen)
            out_ow = xp.where(hit, ow, out_ow)
            out_oc = xp.where(hit, cnt, out_oc)
            out_mt = xp.where(hit, mt, out_mt)
            if mono2 and ow2 is not None:
                out_ow2 = xp.where(hit, ow2, out_ow2)
            found = found | hit

    tm = np.uint32(m.t - 1)
    h1 = (fold_hash32(canon) & tm).astype(xp.int64)
    mine = None
    if bucket_range is not None:
        assert mono, "bucket_range shards the mono/mono2 single-hash table"
        blo, bhi = bucket_range
        mine = (h1 >= blo) & (h1 < bhi)
        n_local = d["table"].shape[0] // (2 if split else 1)
        h1 = xp.clip(h1 - blo, 0, n_local - 1)
    if not mono:
        probe(d["table"], h1)
        h2 = (fold_hash32b(canon, m.salt) & tm).astype(xp.int64)
        probe(d["table"], h2)
    else:
        if split:  # slot rows: 1 random gather + 1 adjacent-row gather
            probe(d["table"], h1 * 2)
            probe(d["table"], h1 * 2 + 1)
        else:
            probe(d["table"], h1)
        if mode != "main" and "side" in d:
            sm = np.uint32(m.side_t - 1)
            hs1 = (fold_hash32(canon) & sm).astype(xp.int64)
            hs2 = (fold_hash32b(canon, m.side_salt) & sm).astype(xp.int64)
            if split:
                probe(d["side"], hs1 * 2)
                probe(d["side"], hs1 * 2 + 1)
                probe(d["side"], hs2 * 2)
                probe(d["side"], hs2 * 2 + 1)
            else:
                probe(d["side"], hs1)
                probe(d["side"], hs2)

    out = {
        "unitig_id": out_uid,
        "unitig_len": out_ulen,
        "pos": out_pos,
        "mt": out_mt,
        "occ_word": out_ow,
        "occ_cnt": out_oc,
    }
    if mono2:
        out["occ_word2"] = out_ow2
    if mode == "main":
        out["use_skew"] = xp.zeros(xp.shape(canon), dtype=bool)
        # mono: a lane not found in the main table is either a displaced
        # key (side table) or a true miss — phase 2 decides
        out["unresolved"] = (
            ~found if mono else xp.zeros(xp.shape(canon), dtype=bool)
        )
    if mine is not None:
        # non-owner lanes report exact zeros (incl. unresolved=False): the
        # one-hot psum across bucket shards is then the owner's verdict
        out = {kk: xp.where(mine, v, xp.zeros_like(v)) for kk, v in out.items()}
    return out
