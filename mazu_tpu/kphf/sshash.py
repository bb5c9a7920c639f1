"""SSHash: minimizer-bucketed k-mer dictionary (the flagship K2U).

Re-design of reference src/kphf/sshash.rs for batched device querying. Same
scheme, carried over deviations included (reference src/kphf/sshash.rs:32-37):

- minimizer of the canonical k-mer: ``mini(g*) = mini(min(g, g'))``
- offset-based candidate positioning (probe ``mm_pos - offset`` and
  ``mm_pos - (k - offset - w)`` directly, no super-k-mer scans)
- flat single-level skew index mapping heavy-bucket k-mers directly to
  positions via a second MPHF.

Build is host-side vectorized NumPy (replacing rayon sort/scatter with
argsort + permutation scatter); the query is one fused batched pipeline:
minimizer -> MPHF -> bucket bounds (Elias-Fano select or flat gather) ->
bounded candidate probe loop (predicated, unrolled) -> unitig mapping,
with heavy buckets diverted to the skew MPHF. All O(1) gathers per probe.
"""

from __future__ import annotations

import numpy as np

from ..bits.elias_fano import EFVector, ef_get
from ..bits.intvector import IntVector, iv_get
from ..containers.unitig_set import (
    UnitigSet,
    us_get_kmer,
    us_is_valid_pos,
    us_validate_rank,
)
from ..kmer import canonical_minimizer_batch, revcomp, word_equivalency
from ..pytree import meta
from .boophf import BooPHF, boophf_lookup
from .boophf32 import BooPHF32, BooPHF32Meta, boophf32_lookup

U64 = np.uint64


def mphf_lookup(d: dict, keys, xp, level_limit: int | None = None):
    """Dispatch on the MPHF implementation (64-bit C++-parity BooPHF or the
    32-bit BooPHF32).

    ``level_limit`` (BooPHF32 only): truncated lookup — returns
    ``(res, unresolved)``; see boophf32_lookup. On the 64-bit parity
    BooPHF the chain always runs full and ``unresolved`` is all-False
    (its level count is data-defined and small; the searchsorted-free
    speed path only matters on the 32-bit engines)."""
    if isinstance(d["meta"], BooPHF32Meta):
        return boophf32_lookup(d, keys, xp, level_limit=level_limit)
    res = boophf_lookup(d, keys, xp)
    if level_limit is not None:
        return res, xp.zeros(xp.shape(xp.asarray(keys)), dtype=bool)
    return res


def _dedup_stream(mm, pos, mask):
    """Keep stream elements (selected by mask, in order) that differ from
    their predecessor in (mm, pos) — consecutive-duplicate dedup (parity:
    reference src/kphf/sshash.rs:109-117)."""
    idx = np.flatnonzero(mask)
    if len(idx) == 0:
        return idx
    m, p = mm[idx], pos[idx]
    keep = np.ones(len(idx), dtype=bool)
    keep[1:] = (m[1:] != m[:-1]) | (p[1:] != p[:-1])
    return idx[keep]


class SSHash:
    def __init__(
        self,
        unitigs: UnitigSet,
        w: int,
        mphf: BooPHF,
        occs_prefix_sum: np.ndarray,
        pos: IntVector,
        skew_param: int | None,
        skew_mphf: BooPHF | None,
        skew_pos: IntVector | None,
        seed: int = 0,
        hash32: bool = False,
        ordering: str | None = None,
    ):
        self.unitigs = unitigs
        self.w = int(w)
        self.mphf = mphf
        # None => lazy: materialized from _sparse_prefix on first access
        # (the direct-engine default query path only needs the flat2 pairs,
        # so the dense T+1 int64 array — 4.3 GB at 50Mbp — is never built)
        self._occs_prefix_dense = (
            None if occs_prefix_sum is None else np.asarray(occs_prefix_sum, dtype=np.int64)
        )
        self.pos = pos
        self.skew_param = skew_param  # None == no skew index (usize::MAX)
        self.skew_mphf = skew_mphf
        self.skew_pos = skew_pos
        self.seed = int(seed)
        self.hash32 = bool(hash32)  # mix32 minimizer ordering (32-bit fast path)
        # minimizer-ordering hash: "mix64" (default), "mix32" (fast32/direct
        # engines), or "wyhash" (reference-parity option, see hashes.wyhash_u64)
        self.ordering = ordering or ("mix32" if hash32 else "mix64")
        self.direct_T = None  # set when the minimizer map is a direct bucket table
        self.skew_direct = None  # direct-mapped skew table (engine="direct")

    # ----------------------------------------------------------------- build
    @staticmethod
    def _collect_minimizer_occs(
        unitigs: UnitigSet,
        w: int,
        seed: int,
        hash32: bool,
        chunk: int,
        ordering: str | None = None,
    ):
        """Steps 1-3 of the build (reference src/kphf/sshash.rs:94-172):
        canonical minimizer occurrence per k-mer, per-stream consecutive
        dedup, value-sort. Returns (mm_set, mm_occs, ranges_start, mps_sorted)."""
        import os as _os
        import time as _time

        _timing = bool(_os.environ.get("MAZU_BUILD_TIMING"))
        _t = [_time.time()]

        def _stage(tag):
            if _timing:
                now = _time.time()
                print(f"[collect {tag:22s}] {now - _t[0]:6.1f}s", flush=True)
                _t[0] = now

        k = unitigs.k
        if ordering is None:
            ordering = "mix32" if hash32 else "mix64"
        native = None
        if ordering == "mix32":
            # fused ranges scan: k-mer positions generated on the fly from
            # the per-unitig extents — no 8B/kmer kpos array (24 GB of pure
            # page-fault cost at 3Gbp, .ckpts/build_3g.log "collect kpos")
            from ..io.native import minimizer_scan32_ranges

            accum = np.asarray(unitigs.accum, dtype=np.int64)
            counts = np.maximum((accum[1:] - accum[:-1]) - k + 1, 0)
            native = minimizer_scan32_ranges(
                unitigs.useq.words, accum[:-1], counts, k, w, seed
            )
            _stage("native scan")
        if native is not None:  # native C++ scan (11x the NumPy path)
            # Gbp-scale host-memory discipline: every live array here is
            # 8-24 GB at 3e9 k-mers (the 3Gbp build OOM-killed at 120 GB
            # RSS before these frees existed); each input is dropped at
            # its last use.
            mm_all, occ_pos_all, isfw_all = native
            del native
        else:
            kpos = unitigs.kmer_start_positions()
            _stage("kpos")
            mm_all = np.empty(len(kpos), dtype=np.uint64)
            occ_pos_all = np.empty(len(kpos), dtype=np.int64)
            isfw_all = np.empty(len(kpos), dtype=bool)
            for s in range(0, len(kpos), chunk):
                sl = slice(s, s + chunk)
                words = unitigs.get_kmer_u64(kpos[sl])
                mm, off, is_fw, _ = canonical_minimizer_batch(
                    np, words, k, w, seed, ordering=ordering
                )
                mm_all[sl] = mm
                occ_pos_all[sl] = kpos[sl] + off.astype(np.int64)
                isfw_all[sl] = is_fw

        from ..io.native import dedup_flags

        keep = dedup_flags(mm_all, occ_pos_all, isfw_all)
        _stage("dedup flags")
        if keep is not None:  # one parallel pass over the interleaved stream
            np.logical_and(keep, isfw_all, out=isfw_all)  # keep & fw, in place
            sel_fw = np.flatnonzero(isfw_all)
            np.logical_xor(keep, isfw_all, out=keep)  # keep & ~fw
            sel = np.concatenate([sel_fw, np.flatnonzero(keep)])
            del sel_fw
            _stage("sel extract")
        else:
            keep_fw = _dedup_stream(mm_all, occ_pos_all, isfw_all)
            keep_rc = _dedup_stream(mm_all, occ_pos_all, ~isfw_all)
            sel = np.concatenate([keep_fw, keep_rc])
        del keep, isfw_all
        mms = mm_all[sel]
        del mm_all
        mps = occ_pos_all[sel]
        del occ_pos_all, sel
        _stage("sel gather")

        from ..io.native import radix_sort_pairs, run_bounds

        mms = np.ascontiguousarray(mms)
        mps = np.ascontiguousarray(mps, dtype=np.int64)
        # native parallel LSD radix carries positions along — the NumPy
        # argsort + two order gathers cost 1,035s at 3Gbp
        if radix_sort_pairs(mms, mps, key_bits=2 * w):
            _stage("mm radix sort")
        else:
            order = np.argsort(mms, kind="stable")
            _stage("mm argsort")
            mms = mms[order]
            mps = mps[order]
            del order
            _stage("order gather")
        # run-length grouping of the sorted stream (np.unique re-sorts: 12s
        # at 50Mbp for data that is already sorted)
        if len(mms):
            ranges_start = run_bounds(mms)
            if ranges_start is None:
                first = np.empty(len(mms), dtype=bool)
                first[0] = True
                np.not_equal(mms[1:], mms[:-1], out=first[1:])
                ranges_start = np.flatnonzero(first)
            mm_set = mms[ranges_start]
            mm_occs = np.diff(np.concatenate([ranges_start, [len(mms)]]))
        else:
            mm_set = mms
            ranges_start = np.zeros(0, dtype=np.int64)
            mm_occs = np.zeros(0, dtype=np.int64)
        _stage("run-length")
        return mm_set, mm_occs, ranges_start, mps

    @classmethod
    def from_unitig_set(
        cls,
        unitigs: UnitigSet,
        w: int,
        skew_param: int | None = 64,
        seed: int = 0,
        gamma: float = 1.7,
        chunk: int = 1 << 20,
        engine: str = "parity",  # "parity" | "fast32" | "direct" (32-bit engines)
        bucket_load: float = 0.5,  # direct engine: minimizers per bucket-table slot
        skew_bound_target: int = 4,  # direct engine: max skew-bucket probe count
        minimizer_hash: str | None = None,  # parity engine: "mix64" | "wyhash"
    ) -> "SSHash":
        """Host-side build (reference src/kphf/sshash.rs:86-330, vectorized).

        ``engine="fast32"`` selects the 32-bit arithmetic: BooPHF32
        MPHFs (u32 chain hashes, power-of-two levels) and mix32 minimizer
        ordering — same structure and guarantees, ~all-32-bit query math.

        ``minimizer_hash="wyhash"`` (parity engine only) orders minimizers
        with the reconstructed wyhash-v1 of the reference's BuildHasher
        (src/kphf/mod.rs:32-52); query results are identical under any
        ordering, this only changes which w-mer each super-k-mer keys on.
        """
        k = unitigs.k
        assert w <= k
        if minimizer_hash is not None and engine != "parity":
            raise ValueError(
                "minimizer_hash is a parity-engine option (fast32/direct use "
                "the 32-bit native ordering)"
            )
        if engine == "direct":
            return cls._from_unitig_set_direct(
                unitigs,
                w,
                skew_param,
                seed,
                chunk,
                bucket_load=bucket_load,
                skew_bound_target=skew_bound_target,
            )
        hash32 = engine == "fast32"
        mphf_cls = BooPHF32 if hash32 else BooPHF

        ordering = minimizer_hash or ("mix32" if hash32 else "mix64")

        import os as _os
        import time as _time

        _timing = bool(_os.environ.get("MAZU_BUILD_TIMING"))
        _t = [_time.time()]

        def _stage(tag):
            if _timing:
                now = _time.time()
                print(f"[build   {tag:22s}] {now - _t[0]:6.1f}s", flush=True)
                _t[0] = now

        # 1-3. minimizer occurrences, deduped and value-sorted
        mm_set, mm_occs, ranges_start, mps = cls._collect_minimizer_occs(
            unitigs, w, seed, hash32, chunk, ordering=ordering
        )
        _t[0] = _time.time()

        # 4. MPHF over the minimizer set
        mphf = mphf_cls.build(mm_set, gamma=gamma)
        _stage("mphf build")

        # 5. occs prefix sum in hash order + position scatter.
        # The lookup is CHUNKED inside a heap-reuse scope: a whole-set call
        # allocates ~6 temps per MPHF level over every key (~470 GB of
        # fresh mmap'd pages at 3Gbp — over an hour at this VM's throttled
        # page-supply rate); 32M-key chunks keep the temp churn in a ~1 GB
        # warm brk heap. Output allocated OUTSIDE the scope (one-shot GB
        # arrays must not first-touch through 4K brk pages).
        from ..io.native import have_native, heap_reuse_scope

        if have_native():
            # one native parallel pass (the chunked NumPy loop paid 7,526s
            # of per-level gather temps at 3Gbp even heap-scoped)
            h = mphf.lookup(mm_set).astype(np.int64)
        else:
            h = np.empty(len(mm_set), dtype=np.int64)
            with heap_reuse_scope():
                _CHK = 1 << 25
                for s in range(0, len(mm_set), _CHK):
                    h[s : s + _CHK] = mphf.lookup(mm_set[s : s + _CHK])
        assert (h >= 0).all()
        _stage("mphf lookup")
        n_occs_by_h = np.zeros(len(mm_set), dtype=np.int64)
        n_occs_by_h[h] = mm_occs
        from ..io.native import cumsum_i64, scatter_ranges_gather

        prefix = np.zeros(len(mm_set) + 1, dtype=np.int64)
        prefix[1:] = cumsum_i64(n_occs_by_h)
        n_total = int(mm_occs.sum())
        posv = scatter_ranges_gather(mps, ranges_start, mm_occs, prefix[h])
        if posv is None:
            dest_start = np.repeat(prefix[h], mm_occs)
            within = np.arange(n_total) - np.repeat(ranges_start, mm_occs)
            posv = np.zeros(n_total, dtype=np.uint64)
            posv[dest_start + within] = mps.astype(np.uint64)
        _stage("pos scatter")
        pos_iv = IntVector.from_array(posv)
        _stage("pos pack")

        # 6. skew index over heavy buckets
        skew_mphf = skew_pos_iv = None
        if skew_param is not None:
            heavy = np.flatnonzero(mm_occs > skew_param)
            if len(heavy):
                # all valid k-mer positions overlapping each heavy occurrence
                occ_sel = np.concatenate(
                    [np.arange(ranges_start[i], ranges_start[i] + mm_occs[i]) for i in heavy]
                )
                mm_positions = mps[occ_sel]
                span = k - w + 1
                starts = np.maximum(mm_positions - (k - w), 0)
                cand = (starts[:, None] + np.arange(span)[None, :]).reshape(-1)
                cand = cand[unitigs.is_valid_useq_pos(cand)]
                words = unitigs.get_kmer_u64(cand)
                cwords = np.minimum(words, revcomp(words, k))
                # dedup by canonical word, keep one (any) position per word
                cw_sorted, first_idx = np.unique(cwords, return_index=True)
                kept_pos = cand[first_idx]
                skew_mphf = mphf_cls.build(cw_sorted, gamma=gamma)
                h2 = skew_mphf.lookup(cw_sorted)
                sp = np.zeros(len(cw_sorted), dtype=np.uint64)
                sp[h2] = kept_pos.astype(np.uint64)
                skew_pos_iv = IntVector.from_array(sp)
            else:
                skew_mphf = mphf_cls.build(np.array([0], dtype=np.uint64), gamma=gamma)
                skew_pos_iv = IntVector.from_array(np.array([0], dtype=np.uint64))

        self = cls(
            unitigs,
            w,
            mphf,
            prefix,
            pos_iv,
            skew_param,
            skew_mphf,
            skew_pos_iv,
            seed,
            hash32=hash32,
            ordering=ordering,
        )
        self._max_bucket = int(mm_occs.max()) if len(mm_occs) else 0
        return self

    @classmethod
    def _from_unitig_set_direct(
        cls, unitigs, w, skew_param, seed, chunk, bucket_load=0.5, skew_bound_target=4
    ):
        """engine="direct": a hashed bucket table instead of an MPHF.

        The minimizer -> bucket map is ``fold_hash32(mm) & (T-1)`` with T a
        power of two (~n_minimizers / bucket_load entries). Colliding
        minimizers share a bucket: their occurrence lists concatenate and
        the candidate verification rejects foreign positions — exactness is
        unchanged, the whole MPHF probe (bit tests + block ranks + final
        hash) collapses to one hash + two int32 gathers. Space trades up
        (~4 bytes/bucket); HBM is cheap, gathers are not. Skew stays a
        BooPHF32 (its cost is paid once per batch lane either way).
        """
        from .boophf32 import fold_hash32

        import os as _os
        import time as _time

        _timing = bool(_os.environ.get("MAZU_BUILD_TIMING"))
        _t = [_time.time()]

        def _stage(tag):
            if _timing:
                now = _time.time()
                print(f"[build {tag:24s}] {now - _t[0]:6.1f}s", flush=True)
                _t[0] = now

        k = unitigs.k
        skew_param = 8 if skew_param is None else skew_param
        mm_set, mm_occs, ranges_start, mps = cls._collect_minimizer_occs(
            unitigs, w, seed, True, chunk
        )
        _stage("collect")
        n_min = len(mm_set)
        T = 1 << max(6, int(np.ceil(np.log2(max(n_min / bucket_load, 64)))))
        b = (fold_hash32(mm_set) & np.uint32(T - 1)).astype(np.int64)
        _stage("bucket hash")

        # group occurrences by bucket (stable in minimizer-value order)
        from ..io.native import cumsum_i64, expand_ranges

        order2 = np.argsort(b, kind="stable")
        _stage("bucket argsort")
        occ_counts = mm_occs[order2]
        src = expand_ranges(ranges_start[order2], occ_counts)
        pos_direct = mps[src]
        _stage("occ scatter")
        # per-bucket occurrence totals: segment sums over the sorted stream
        # (np.add.at is a ~100 ns/elem scalar loop). The T+1 prefix is a
        # step function over the occupied buckets — built in ONE native
        # write pass (the zeros(T)+scatter+cumsum chain paid ~46s of page
        # faults at 50Mbp with T=2^29).
        from ..io.native import fill_prefix_i64

        b_sorted = b[order2]
        if len(b_sorted):
            bfirst = np.empty(len(b_sorted), dtype=bool)
            bfirst[0] = True
            np.not_equal(b_sorted[1:], b_sorted[:-1], out=bfirst[1:])
            run_start = np.flatnonzero(bfirst)
            occ_cum = np.concatenate([[0], cumsum_i64(occ_counts)])
            run_end = np.concatenate([run_start[1:], [len(b_sorted)]])
            ub = b_sorted[run_start]
            seg = occ_cum[run_end] - occ_cum[run_start]
        else:
            ub = np.zeros(0, dtype=np.int64)
            seg = np.zeros(0, dtype=np.int64)
        # the dense T+1 prefix is NOT materialized here: the query path
        # needs only the flat2 pairs (built natively from this sparse form
        # in device_arrays) and everything else reads the lazy property
        cum = cumsum_i64(seg)
        cum_excl = cum - seg
        _stage("bucket prefix")

        # skew: kmers overlapping occurrences of heavy (merged) buckets, in a
        # SECOND direct bucket table keyed by canonical k-mer (no MPHF — the
        # skew query is a tiny bounded probe loop with the same 2-gather
        # record probes as the main path)
        from .boophf32 import fold_hash32 as _fold

        heavy_sel = seg > skew_param  # occupied-bucket view (no dense T array)
        heavy = ub[heavy_sel]
        skew_direct = None
        if len(heavy):
            occ_sel = expand_ranges(cum_excl[heavy_sel], seg[heavy_sel])
            mm_positions = pos_direct[occ_sel]
            _stage("skew select")
            span = k - w + 1
            starts = np.maximum(mm_positions - (k - w), 0)
            cand = np.unique((starts[:, None] + np.arange(span)[None, :]).reshape(-1))
            _stage("skew cand-unique")
            cand = cand[unitigs.is_valid_useq_pos(cand)]
            _stage("skew cand")
            words = unitigs.get_kmer_u64(cand)
            cwords = np.minimum(words, revcomp(words, k))
            cw_sorted, first_idx = np.unique(cwords, return_index=True)
            kept_pos = cand[first_idx]
            _stage("skew kmer-unique")
            skew_direct = cls._place_skew_cuckoo(cw_sorted, kept_pos)
            _stage("skew cuckoo")
            if skew_direct is None:  # fall back to bounded buckets
                n2 = len(cw_sorted)
                T2 = 1 << max(6, int(np.ceil(np.log2(max(n2 * 2, 64)))))
                for _ in range(8):
                    b2 = (_fold(cw_sorted) & np.uint32(T2 - 1)).astype(np.int64)
                    sizes = np.bincount(b2, minlength=T2)
                    if sizes.max() <= skew_bound_target or T2 >= (1 << 28):
                        break
                    T2 <<= 1
                order3 = np.argsort(b2, kind="stable")
                skew_direct = {
                    "kind": "bucket",
                    "T": T2,
                    "bound": int(sizes.max()),
                    "prefix": np.concatenate([[0], cumsum_i64(sizes)]).astype(np.int64),
                    "pos": kept_pos[order3].astype(np.int64),
                }

        _stage("skew done")
        self = cls(
            unitigs,
            w,
            None,  # no MPHF: direct bucket table
            None,  # dense prefix is lazy (see occs_prefix_sum property)
            IntVector.from_array(pos_direct.astype(np.uint64)),
            skew_param,
            None,
            None,
            seed,
            hash32=True,
        )
        self.direct_T = T
        self.skew_direct = skew_direct
        self._max_bucket = int(seg.max()) if len(seg) else 0
        # sparse prefix (occupied bucket ids + inclusive occ totals): the
        # device flat2 pairs and the lazy dense prefix both derive from it
        self._sparse_prefix = (ub, cum)
        _stage("pack+init")
        return self

    @staticmethod
    def _place_skew_cuckoo(keys: np.ndarray, vals: np.ndarray, load: float = 0.4):
        """Two-choice (cuckoo) placement of skew k-mers: each key lands in
        one of two hashed slots, one key per slot — the skew query becomes
        TWO fixed row gathers (no bucket bounds, no loop). Vectorized
        random-walk insertion; returns None if placement fails (caller
        falls back to bounded buckets).

        Returns {"kind": "cuckoo", "T", "salt", "slot_pos": int64[T]
        (-1 = empty), "slot_key": uint64[T]}.
        """
        from .boophf32 import fold_hash32, fold_hash32b, mix32

        n = len(keys)
        if n == 0:
            return None
        if n > (1 << 22):
            # the round-randomized walk argsorts the whole key set per round
            # (up to 512 rounds x 4 salts): past ~4M keys the sort-based
            # bounded-bucket fallback builds in one pass and queries nearly
            # as fast — at 500Mbp/load 0.5 the skew set hits tens of
            # millions of keys and the walk effectively never terminates
            return None
        T2 = 1 << max(6, int(np.ceil(np.log2(max(n / load, 64)))))
        for salt in range(4):
            h1 = (fold_hash32(keys) & np.uint32(T2 - 1)).astype(np.int64)
            h2 = (fold_hash32b(keys, salt) & np.uint32(T2 - 1)).astype(np.int64)
            side = np.zeros(n, dtype=bool)
            klo = (keys & np.uint64(0xFFFFFFFF)).astype(np.uint32)
            ok = False
            for rnd in range(512):
                slot = np.where(side, h2, h1)
                # ROUND-RANDOM priorities: every contender eventually wins
                # somewhere, so stable-winner deadlocks cannot form
                prio = mix32(klo ^ np.uint32((rnd * 2654435761) % (1 << 32)))
                # single-key sort on packed (slot << 32 | prio) — same order
                # as lexsort((prio, slot)) but ~4x faster
                packed = (slot.astype(np.uint64) << np.uint64(32)) | prio.astype(
                    np.uint64
                )
                order = np.argsort(packed)
                ss_ = slot[order]
                first = np.ones(n, dtype=bool)
                first[1:] = ss_[1:] != ss_[:-1]
                winner = np.zeros(n, dtype=bool)
                winner[order] = first
                losers = ~winner
                if not losers.any():
                    ok = True
                    break
                # losers flip to their alternate slot (random half, to damp
                # oscillation)
                flip = losers & ((prio & np.uint32(1)) == 1)
                if not flip.any():
                    flip = losers
                side = side ^ flip
            if ok:
                slot_pos = np.full(T2, -1, dtype=np.int64)
                slot_key = np.zeros(T2, dtype=np.uint64)
                slot_pos[slot] = vals
                slot_key[slot] = keys
                return {
                    "kind": "cuckoo",
                    "T": T2,
                    "salt": salt,
                    "slot_pos": slot_pos,
                    "slot_key": slot_key,
                    "pos": slot_pos,  # row-ordered positions (fusion uses this)
                }
            T2 <<= 1  # more room on retry
        return None

    @classmethod
    def from_unitig_set_no_skew_index(
        cls, unitigs, w, seed=0, gamma=1.7, engine="parity"
    ) -> "SSHash":
        return cls.from_unitig_set(
            unitigs, w, skew_param=None, seed=seed, gamma=gamma, engine=engine
        )

    # ------------------------------------------------------------- accessors
    @property
    def occs_prefix_sum(self) -> np.ndarray:
        if self._occs_prefix_dense is None:
            from ..io.native import fill_prefix_i64

            ub, cum = self._sparse_prefix
            dense = fill_prefix_i64(ub, cum, self.direct_T)
            if dense is None:  # no native lib
                dense = np.zeros(self.direct_T + 1, dtype=np.int64)
                np.add.at(dense[1:], ub, np.diff(np.concatenate([[0], cum])))
                np.cumsum(dense, out=dense)
            self._occs_prefix_dense = dense
        return self._occs_prefix_dense

    @occs_prefix_sum.setter
    def occs_prefix_sum(self, v):
        self._occs_prefix_dense = None if v is None else np.asarray(v, dtype=np.int64)

    @property
    def k(self) -> int:
        return self.unitigs.k

    @property
    def n_kmers(self) -> int:
        return self.unitigs.n_kmers

    @property
    def n_minimizers(self) -> int:
        if self.direct_T:
            return self.direct_T
        return len(self.occs_prefix_sum) - 1

    @property
    def n_minimizer_occs(self) -> int:
        return len(self.pos)

    @property
    def n_kmers_in_skew_index(self) -> int:
        if self.skew_direct is not None:
            return int((self.skew_direct["pos"] >= 0).sum())
        return len(self.skew_pos) if self.skew_pos is not None else 0

    def max_bucket(self) -> int:
        if getattr(self, "_max_bucket", None) is None:
            d = self.occs_prefix_sum
            self._max_bucket = int((d[1:] - d[:-1]).max()) if len(d) > 1 else 0
        return self._max_bucket

    def probe_bound(self) -> int:
        """Static bound of the candidate probe loop."""
        if self.skew_param is None:
            return self.max_bucket()
        return min(self.skew_param, self.max_bucket())

    def ef_occs_prefix_sum(self) -> EFVector:
        return EFVector.from_array(self.occs_prefix_sum.astype(np.uint64))

    def num_bits(self) -> int:
        if self.direct_T:  # direct table: flat int32 prefix, no MPHF
            mm_bits = 32 * (self.direct_T + 1)
        else:
            mm_bits = self.ef_occs_prefix_sum().num_bits() + self.mphf.num_bits()
        nb = 64 + self.unitigs.num_bits() + self.pos.num_bits() + mm_bits
        if self.skew_mphf is not None:
            nb += self.skew_mphf.num_bits() + self.skew_pos.num_bits()
        if self.skew_direct is not None:
            sd = self.skew_direct
            nb += 128 * len(sd["pos"])  # inline rows dominate
            if "prefix" in sd:
                nb += 32 * len(sd["prefix"])
        return nb

    def print_stats(self, log=print):
        nk = self.n_kmers
        log(f"kmers: {nk}")
        log(f"n minimizers: {self.n_minimizers}")
        log(f"n minimizer occs: {self.n_minimizer_occs}")
        log(f"positions encoded in {self.pos.width} bit words")
        log(f"unitigs: {self.unitigs.n_unitigs}")
        log(f"bits / kmer: {self.num_bits() / nk:.3f}")

    # --------------------------------------------------------------- device
    def device_arrays(
        self,
        prefix_kind: str | None = None,
        pos_kind: str | None = None,
        bucket_inline: bool = False,
        mphf_rows: bool = False,
    ) -> dict:
        """Array layout knobs:

        - ``prefix_kind``: "ef" = Elias-Fano bucket bounds (reference
          parity, select-based get); "flat" = int64 array; "flat32" =
          int32 array (fast path). Default: "ef" for parity engines,
          "flat32" for fast32.
        - ``pos_kind``: "packed" = minimal-width IntVector (parity);
          "flat32" = int32 array (1-gather fast path). Same defaults.
        - ``bucket_inline``: add a direct-addressed ``bpos`` u32[T, 4]
          table = (pos0, pos1, pos2, count) per bucket — the MAIN-phase
          shallow probe (probe_limit <= 3) then reads bucket bounds AND
          its candidate positions in ONE gather instead of the 4-6
          prefix/pos-window gathers. 16 B/bucket on top of the packed arrays (which phases 2/2B still
          use) — the <=1 Gbp speed-at-capacity knob. Requires
          total_len < 2^31.
        """
        if pos_kind is None:
            # inline+prefix measured faster than fixedcap (dense rows beat
            # the sparse direct-addressed table: 13.3M vs 8.1M q/s on chip)
            pos_kind = "inline" if self.hash32 else "packed"
        if prefix_kind is None:
            if pos_kind in ("fixedcap", "fixedcap2"):
                prefix_kind = "none"
            else:
                prefix_kind = "flat32" if self.hash32 else "ef"
        d = {
            "us": self.unitigs.device_arrays(
                # "packed" (the compact/capacity tier) pairs too: the
                # probe's fused 3-word window read then costs one random
                # + one adjacent 2-wide gather (+~50% useq bytes, ~15% of
                # the tier's footprint — measured worth it)
                paired=pos_kind
                in ("flat32", "records", "inline", "inline2", "fixedcap",
                    "fixedcap2", "packed")
            ),
            "meta": meta(
                kind="sshash",
                k=self.k,
                w=self.w,
                seed=self.seed,
                hash32=self.hash32,
                ordering=self.ordering,
                direct_t=self.direct_T or 0,
                skew_param=-1 if self.skew_param is None else self.skew_param,
                probe_bound=max(1, self.probe_bound()),
                prefix_kind=prefix_kind,
                pos_kind=pos_kind,
            ),
        }
        if self.mphf is not None:
            # mphf_rows: opt-in paired word|rank mrows layout (BooPHF32
            # only) — truncated lookups become level_limit gather OPS with
            # no rank tail, at 2x the bit-array bytes (opt-in)
            if mphf_rows and isinstance(self.mphf, BooPHF32):
                d["mphf"] = self.mphf.device_arrays(mrows=True)
            else:
                d["mphf"] = self.mphf.device_arrays()
        if pos_kind == "fixedcap":
            # fixed-capacity buckets: bucket b's occurrence rows live at
            # [b*B, (b+1)*B) — direct addressing, NO bucket-bounds gather.
            # Slot validity rides in the uid field: 0xFFFFFFFF = empty,
            # 0xFFFFFFFE in slot 0 = heavy bucket (resolve via skew).
            assert self.direct_T, "fixedcap requires engine='direct'"
            assert self.unitigs.total_len < (1 << 31)
            B = max(1, self.probe_bound())
            T = self.direct_T
            cnt_b = self.occs_prefix_sum[1:] - self.occs_prefix_sum[:-1]
            heavy_b = cnt_b > (self.skew_param or B)
            pos_arr = self.pos.to_array().astype(np.int64)
            occ_b = np.repeat(np.arange(T, dtype=np.int64), cnt_b)
            within = np.arange(len(pos_arr)) - np.repeat(
                self.occs_prefix_sum[:-1], cnt_b
            )
            keep = (within < B) & (~heavy_b[occ_b])
            uid = self.unitigs.pos_to_id(pos_arr)
            start = self.unitigs.accum[uid]
            end = self.unitigs.accum[uid + 1]
            base = np.maximum(pos_arr - (self.k - self.w), 0)
            wi = (base * 2) >> 6
            wp = np.concatenate([self.unitigs.useq.words, np.zeros(2, dtype=np.uint64)])
            table = np.zeros((T * B, 5), dtype=np.uint64)
            table[:, 0] = np.uint64(0xFFFFFFFF) << np.uint64(32)  # empty sentinel
            dst = occ_b[keep] * B + within[keep]
            table[dst, 0] = pos_arr[keep].astype(np.uint64) | (
                uid[keep].astype(np.uint64) << np.uint64(32)
            )
            table[dst, 1] = start[keep].astype(np.uint64) | (
                end[keep].astype(np.uint64) << np.uint64(32)
            )
            table[dst, 2] = wp[wi[keep]]
            table[dst, 3] = wp[wi[keep] + 1]
            table[dst, 4] = wp[wi[keep] + 2]
            # heavy buckets: slot 0 carries the skew marker
            hb = np.flatnonzero(heavy_b)
            table[hb * B, 0] = np.uint64(0xFFFFFFFE) << np.uint64(32)
            rows32 = np.ascontiguousarray(table).view(np.uint32).reshape(T * B, 10)
            d["pos"] = {"inline": rows32, "meta": meta(length=T * B)}
            d["meta"] = d["meta"].replace(cap=B)
        elif pos_kind == "fixedcap2":
            # fixed-capacity DIRECT-ADDRESSED buckets with PRE-ALIGNED
            # (inline2-style) rows: bucket b's rows at [b*B, (b+1)*B) — the
            # common-case query is ONE random row gather (no bucket-bounds
            # prefix gather at all; probes j>=1 hit consecutive rows).
            # Slot-0's uid field carries the bucket's occurrence count in
            # its top 3 bits (exact n_occs -> misses on small/empty buckets
            # resolve without the overflow phase); sentinels in the uid
            # field mark empty slots (0xFFFFFFFF) and heavy buckets
            # (0xFFFFFFFE in slot 0 -> skew table). u32 cols as inline2:
            # 0=mm_pos 1=uid(+cnt<<29 in slot 0) 2=start 3=end 4..7=W0,W1.
            assert self.direct_T, "fixedcap2 requires engine='direct'"
            assert self.unitigs.total_len < (1 << 31)
            assert self.unitigs.n_unitigs < (1 << 29), "uid field carries cnt bits"
            B = max(1, self.probe_bound())
            assert B <= 7, "cnt rides in 3 uid bits"
            T = self.direct_T
            cnt_b = self.occs_prefix_sum[1:] - self.occs_prefix_sum[:-1]
            heavy_b = cnt_b > (self.skew_param or B)
            pos_arr = self.pos.to_array().astype(np.int64)
            occ_b = np.repeat(np.arange(T, dtype=np.int64), cnt_b)
            within = np.arange(len(pos_arr)) - np.repeat(
                self.occs_prefix_sum[:-1], cnt_b
            )
            keep = (within < B) & (~heavy_b[occ_b])
            uid = self.unitigs.pos_to_id(pos_arr)
            start = self.unitigs.accum[uid]
            end = self.unitigs.accum[uid + 1]
            base = np.maximum(pos_arr - (self.k - self.w), 0)
            wi = (base * 2) >> 6
            r = ((base * 2) & 63).astype(np.uint64)
            wp = np.concatenate([self.unitigs.useq.words, np.zeros(2, dtype=np.uint64)])
            q0, q1, q2 = wp[wi], wp[wi + 1], wp[wi + 2]
            hs = (np.uint64(64) - r) & np.uint64(63)
            nz = r != 0
            W0 = (q0 >> r) | np.where(nz, q1 << hs, 0)
            W1 = (q1 >> r) | np.where(nz, q2 << hs, 0)
            uid_field = uid.astype(np.uint64)
            slot0 = within == 0
            cnt0 = np.minimum(cnt_b[occ_b[slot0]], B).astype(np.uint64)
            uid_field[slot0] |= cnt0 << np.uint64(29)
            table = np.zeros((T * B, 4), dtype=np.uint64)
            table[:, 0] = np.uint64(0xFFFFFFFF) << np.uint64(32)  # empty sentinel
            dst = occ_b[keep] * B + within[keep]
            table[dst, 0] = pos_arr[keep].astype(np.uint64) | (
                uid_field[keep] << np.uint64(32)
            )
            table[dst, 1] = start[keep].astype(np.uint64) | (
                end[keep].astype(np.uint64) << np.uint64(32)
            )
            table[dst, 2] = W0[keep]
            table[dst, 3] = W1[keep]
            hb = np.flatnonzero(heavy_b)
            table[hb * B, 0] = np.uint64(0xFFFFFFFE) << np.uint64(32)
            rows32 = np.ascontiguousarray(table).view(np.uint32).reshape(T * B, 8)
            d["pos"] = {"inline": rows32, "meta": meta(length=T * B)}
            d["meta"] = d["meta"].replace(cap=B)
        elif pos_kind == "inline":
            # one u64[5] row per occurrence: (mm_pos|uid<<32, start|end<<32,
            # w0, w1, w2) where w0..w2 are the useq words covering the whole
            # candidate window — a probe is ONE row gather. ~40B/occurrence:
            # the speed king for chromosome/transcriptome-scale indexes.
            assert self.unitigs.total_len < (1 << 31)
            pos_arr = self.pos.to_array().astype(np.int64)
            uid = self.unitigs.pos_to_id(pos_arr)
            start = self.unitigs.accum[uid]
            end = self.unitigs.accum[uid + 1]
            base = np.maximum(pos_arr - (self.k - self.w), 0)
            wi = (base * 2) >> 6
            wp = np.concatenate([self.unitigs.useq.words, np.zeros(2, dtype=np.uint64)])
            rows = np.stack(
                [
                    pos_arr.astype(np.uint64) | (uid.astype(np.uint64) << np.uint64(32)),
                    start.astype(np.uint64) | (end.astype(np.uint64) << np.uint64(32)),
                    wp[wi],
                    wp[wi + 1],
                    wp[wi + 2],
                ],
                axis=1,
            )
            # u32 row layout: measured 2x cheaper row gathers than u64 rows
            # (cols: 0=mm_pos 1=uid 2=start 3=end 4..9=w0lo..w2hi)
            rows32 = np.ascontiguousarray(rows).view(np.uint32).reshape(len(rows), -1)
            d["pos"] = {"inline": rows32, "meta": meta(length=len(self.pos))}
        elif pos_kind == "inline2":
            # PRE-ALIGNED inline rows: the candidate window (2k-w bases,
            # <= 64 for k<=31) is re-packed to start at bit 0 of TWO u64
            # words — 2 columns fewer than "inline", leaving room for the
            # fusion pass to embed the unitig's SECOND occurrence as well
            # (cnt<=2 lanes then project with zero extra gathers).
            # u32 cols: 0=mm_pos 1=uid 2=start 3=end 4..7=W0lo..W1hi
            assert self.unitigs.total_len < (1 << 31)
            pos_arr = self.pos.to_array().astype(np.int64)
            uid = self.unitigs.pos_to_id(pos_arr)
            start = self.unitigs.accum[uid]
            end = self.unitigs.accum[uid + 1]
            base = np.maximum(pos_arr - (self.k - self.w), 0)
            wi = (base * 2) >> 6
            r = ((base * 2) & 63).astype(np.uint64)
            wp = np.concatenate([self.unitigs.useq.words, np.zeros(2, dtype=np.uint64)])
            q0, q1, q2 = wp[wi], wp[wi + 1], wp[wi + 2]
            hs = (np.uint64(64) - r) & np.uint64(63)
            nz = r != 0
            W0 = (q0 >> r) | np.where(nz, q1 << hs, 0)
            W1 = (q1 >> r) | np.where(nz, q2 << hs, 0)
            rows = np.stack(
                [
                    pos_arr.astype(np.uint64) | (uid.astype(np.uint64) << np.uint64(32)),
                    start.astype(np.uint64) | (end.astype(np.uint64) << np.uint64(32)),
                    W0,
                    W1,
                ],
                axis=1,
            )
            rows32 = np.ascontiguousarray(rows).view(np.uint32).reshape(len(rows), -1)
            d["pos"] = {"inline": rows32, "meta": meta(length=len(self.pos))}
        elif pos_kind == "records":
            # one row per occurrence: (mm_pos, uid, ustart, uend) int32 —
            # the whole probe needs just this row + one useq quad row
            # (no boundary-rank or extent gathers at query time; a valid
            # candidate k-mer provably lies in the minimizer's unitig)
            assert self.unitigs.total_len < (1 << 31)
            pos_arr = self.pos.to_array().astype(np.int64)
            uid = self.unitigs.pos_to_id(pos_arr)
            start = self.unitigs.accum[uid]
            end = self.unitigs.accum[uid + 1]
            d["pos"] = {
                "records": np.stack([pos_arr, uid, start, end], axis=1).astype(np.int32),
                "meta": meta(length=len(self.pos)),
            }
            # overlapping useq word-quads: row i = words[i..i+4): a single
            # row gather covers the 2k-w+? base window of both candidates
            w_ = self.unitigs.useq.words
            pad = np.zeros(3, dtype=np.uint64)
            wp = np.concatenate([w_, pad])
            d["useq_quad"] = np.stack(
                [wp[:-3], wp[1:-2], wp[2:-1], wp[3:]], axis=1
            )
        elif pos_kind == "flat32":
            assert self.unitigs.total_len < (1 << 31)
            d["pos"] = {
                "flat": self.pos.to_array().astype(np.int32),
                "meta": meta(length=len(self.pos)),
            }
        else:
            d["pos"] = self.pos.device_arrays()
        if prefix_kind == "ef":
            d["prefix"] = self.ef_occs_prefix_sum().device_arrays()
        elif prefix_kind == "grouped16":
            # two-level prefix for the Gbp capacity tier: int64 base per
            # 1024-bucket group + u16 in-group delta. ~2.06 B/bucket (vs
            # 12 B flat32, vs EF's ~0.4 B but ~46-gather select chains):
            # bounds resolve in 2 small gathers + 1 u16 gather per side.
            p = self.occs_prefix_sum
            base = np.ascontiguousarray(p[::1024]).astype(np.int64)
            delta = p - base[np.arange(len(p), dtype=np.int64) >> 10]
            if int(delta.max(initial=0)) >= (1 << 16):
                raise ValueError(
                    "grouped16 prefix overflow: a 1024-bucket group holds "
                    ">= 2^16 occurrences — use prefix_kind='ef' for this "
                    "(pathologically skewed) minimizer distribution"
                )
            d["prefix"] = {
                "gbase": base,
                "gdelta": delta.astype(np.uint16),
            }
        elif prefix_kind == "grouped32":
            # grouped16's two-level prefix with PAIRED access arrays
            # (round 4: the wall is per gather OP): gd2[i] packs the
            # in-group deltas of buckets i and i+1 in one u32, gb2[g]
            # pairs the group bases of g and g+1 in one 16B row — BOTH
            # bucket bounds in 2 gather ops (grouped16 pays 4).
            # ~4.03 B/bucket (vs 2.06 grouped16, 8 flat2).
            p = self.occs_prefix_sum
            base = np.ascontiguousarray(p[::1024]).astype(np.int64)
            delta = p - base[np.arange(len(p), dtype=np.int64) >> 10]
            if int(delta.max(initial=0)) >= (1 << 16):
                raise ValueError(
                    "grouped32 prefix overflow: a 1024-bucket group holds "
                    ">= 2^16 occurrences — use prefix_kind='ef' for this "
                    "(pathologically skewed) minimizer distribution"
                )
            d16 = delta.astype(np.uint32)
            gd2 = d16[:-1] | (d16[1:] << np.uint32(16))
            bp = np.concatenate([base, base[-1:]])
            d["prefix"] = {
                "gd2": gd2,
                "gb2": np.stack([bp[:-1], bp[1:]], axis=1),
            }
        elif prefix_kind == "flat32":
            sp = getattr(self, "_sparse_prefix", None)
            pairs = None
            if sp is not None:
                from ..io.native import fill_pairs_i32

                pairs = fill_pairs_i32(sp[0], sp[1], self.direct_T)
            if pairs is not None:
                # pair-packed (start, end) bucket bounds in one native pass;
                # the query kernel reads only flat2 when it is present, so
                # the redundant T+1 "flat" copy is dropped entirely
                d["prefix"] = {"flat2": pairs}
            else:
                p32 = self.occs_prefix_sum.astype(np.int32)
                # pair-packed (start, end) rows: one gather for both bounds
                d["prefix"] = {
                    "flat": p32,
                    "flat2": np.stack([p32[:-1], p32[1:]], axis=1),
                }
        else:
            d["prefix"] = {"flat": self.occs_prefix_sum}
        if bucket_inline:
            assert self.unitigs.total_len < (1 << 31), (
                "bucket_inline positions ride in u32"
            )
            # the bpos main probe reads candidate positions from the bpos
            # row; fixedcap layouts address occurrence rows directly and
            # would NameError in sshash_k2u — only the packed
            # pos layout composes with bucket_inline
            assert pos_kind == "packed", (
                f"bucket_inline requires pos_kind='packed', got {pos_kind!r}"
            )
            p = self.occs_prefix_sum.astype(np.int64)
            posv = self.pos.to_array()
            cnt = p[1:] - p[:-1]
            hi = max(len(posv) - 1, 0)
            bp = np.zeros((len(cnt), 4), dtype=np.uint32)
            for j in range(3):
                bp[:, j] = posv[np.clip(p[:-1] + j, 0, hi)].astype(
                    np.uint32
                ) * (cnt > j)
            bp[:, 3] = np.minimum(cnt, 0xFFFFFFFF).astype(np.uint32)
            d["bpos"] = bp
        if self.skew_mphf is not None:
            d["skew_mphf"] = self.skew_mphf.device_arrays()
            d["skew_pos"] = self.skew_pos.device_arrays()
        if self.skew_direct is not None:
            sd = self.skew_direct
            kind = sd.get("kind", "bucket")
            spos_raw = sd["pos"]
            valid = spos_raw >= 0
            spos = np.where(valid, spos_raw, 0).astype(np.int64)
            uid = self.unitigs.pos_to_id(spos)
            uid_field = np.where(valid, uid, 0xFFFFFFFF).astype(np.uint64)
            # inline skew rows: (pos|uid, start|end, w0, w1) — one gather
            # per skew probe (the k-mer sits at pos exactly, spans <= 2
            # words). uid field 0xffffffff marks an empty (cuckoo) slot.
            wi = (spos * 2) >> 6
            wp = np.concatenate([self.unitigs.useq.words, np.zeros(1, dtype=np.uint64)])
            srows = np.stack(
                [
                    spos.astype(np.uint64) | (uid_field << np.uint64(32)),
                    self.unitigs.accum[uid].astype(np.uint64)
                    | (self.unitigs.accum[uid + 1].astype(np.uint64) << np.uint64(32)),
                    np.where(valid, wp[wi], 0),
                    np.where(valid, wp[wi + 1], 0),
                ],
                axis=1,
            )
            # u32 rows (cols: 0=pos 1=uid 2=start 3=end 4..7=w0lo..w1hi)
            d["skew_inline"] = (
                np.ascontiguousarray(srows).view(np.uint32).reshape(len(srows), -1)
            )
            if kind == "cuckoo":
                d["meta"] = d["meta"].replace(
                    skew_t=sd["T"], skew_bound=2, skew_kind="cuckoo", skew_salt=sd["salt"]
                )
            else:
                p32 = sd["prefix"].astype(np.int32)
                d["skew_prefix2"] = np.stack([p32[:-1], p32[1:]], axis=1)
                d["meta"] = d["meta"].replace(
                    skew_t=sd["T"], skew_bound=sd["bound"], skew_kind="bucket"
                )
        return d


# ---------------------------------------------------------------------------
# Batched device query
# ---------------------------------------------------------------------------


def _prefix_get(d: dict, i, xp):
    pk = d["meta"].prefix_kind
    if pk == "ef":
        return ef_get(d["prefix"], i, xp).astype(xp.int64)
    if pk == "grouped16":
        return (
            d["prefix"]["gbase"][i >> 10].astype(xp.int64)
            + d["prefix"]["gdelta"][i].astype(xp.int64)
        )
    if pk == "grouped32":
        gd2 = d["prefix"]["gd2"]
        lo = xp.clip(i, 0, gd2.shape[0] - 1)
        dpair = gd2[lo]
        dlt = xp.where(
            i == lo,
            dpair & np.uint32(0xFFFF),
            dpair >> np.uint32(16),  # i == T reads the high half of T-1
        ).astype(xp.int64)
        return d["prefix"]["gb2"][i >> 10, 0].astype(xp.int64) + dlt
    return d["prefix"]["flat"][i].astype(xp.int64)


def _prefix_pair(d: dict, i, xp):
    """Both bucket bounds ``(p[i], p[i+1])``. grouped32 resolves them in
    TWO gather ops (one u32 delta pair + one 16B base-pair row — round
    4: the wall is per gather op); other kinds fall back to two
    ``_prefix_get`` calls."""
    if d["meta"].prefix_kind == "grouped32":
        dpair = d["prefix"]["gd2"][i]
        g = i >> 10
        gb = d["prefix"]["gb2"][g]
        ps = gb[..., 0].astype(xp.int64) + (dpair & np.uint32(0xFFFF)).astype(
            xp.int64
        )
        crosses = ((i + 1) >> 10) != g
        pe_base = xp.where(crosses, gb[..., 1], gb[..., 0]).astype(xp.int64)
        pe = pe_base + (dpair >> np.uint32(16)).astype(xp.int64)
        return ps, pe
    return _prefix_get(d, i, xp), _prefix_get(d, i + 1, xp)


def _pos_get(d: dict, i, xp):
    if d["meta"].pos_kind == "flat32":
        return d["pos"]["flat"][i].astype(xp.int64)
    return iv_get(d["pos"], i, xp).astype(xp.int64)


def _pos_window(d: dict, ps, n: int, xp):
    """``[pos[ps+j] for j in range(n)]`` via ONE multi-word window read.

    The n packed entries of a shallow probe are CONSECUTIVE in the
    IntVector, so one random gather + (nwords-1) ADJACENT gathers replace
    n independent 2-gather window reads — at plim=3 that is 1 random
    instead of 3. Entries past the vector's end return garbage exactly
    like ``_pos_get`` with a clipped index does; callers mask with
    ``j < n_occs``."""
    iv = d["pos"]
    width = int(iv["meta"].width)
    words = iv["words"]
    nw_words = words.shape[0]
    bit0 = xp.asarray(ps) * width
    wi = bit0 >> 6
    woff = (bit0 & 63).astype(xp.uint64)
    nw = (63 + n * width - 1) // 64 + 1
    qs = [words[xp.clip(wi + t, 0, nw_words - 1)] for t in range(nw)]
    mask = U64((1 << width) - 1) if width < 64 else ~U64(0)
    out = []
    for j in range(n):
        dbit = woff + U64(j * width)
        sel = dbit >> U64(6)
        r = (dbit & U64(63)).astype(xp.uint64)
        lo, hi = qs[0], (qs[1] if nw > 1 else qs[0])
        for t in range(1, nw):
            tt = U64(t)
            lo = xp.where(sel == tt, qs[t], lo)
            hi = xp.where(sel == tt, qs[min(t + 1, nw - 1)], hi)
        hi_shift = (U64(64) - r) & U64(63)
        hi_bits = xp.where(r == 0, xp.zeros_like(hi), hi << hi_shift)
        out.append((((lo >> r) | hi_bits) & mask).astype(xp.int64))
    return out


def _map_hit(d: dict, km_pos, xp):
    """useq position -> (unitig_id, unitig_len, upos, end_ok)."""
    from ..containers.unitig_set import us_extent, us_rank

    us = d["us"]
    uid = us_rank(us, km_pos, xp)
    start, end = us_extent(us, uid, xp)
    upos = km_pos - start
    end_ok = km_pos + d["meta"].k <= end
    return uid, end - start, upos, end_ok


def sshash_k2u(
    d: dict,
    fw_words,
    xp,
    mode: str = "full",
    probe_limit: int | None = None,
    bucket_range=None,
    probe_start: int = 0,
    defer_valid: bool = False,
    mphf_level_limit: int | None = None,
):
    """Batched SSHash k2u (parity: reference src/kphf/sshash.rs:471-554).

    Returns dict(unitig_id, unitig_len, pos, mt) with mt==0 for misses.

    ``mode``: "full" resolves everything in one kernel; "main" skips the
    skew structures and returns a ``use_skew`` flag instead (the caller
    re-queries flagged lanes via mode="full" on a compacted sub-batch —
    see TwoPhaseSSHash); heavy-bucket lanes cost the whole batch nothing.

    ``probe_start``: skip candidate rows [0, probe_start) batch-wide.
    EXACTNESS CONTRACT: the caller guarantees every lane in the batch
    either never probes (use_skew) or already probed those rows and
    missed — i.e. the lanes are a mode="main" pass's ``use_skew`` /
    ``unresolved`` set with probe_limit == probe_start. This is the
    phase-2B re-probe optimization of the compact-tier driver
    (get_ref_pos_compact with non-fused arrays): deep buckets pay only
    the depth beyond the shallow main probe.

    ``defer_valid`` (mode="main", generic probe body only): drop the two
    per-candidate ``us_is_valid_pos`` boundary-bv reads from the probe
    loop and validate the WINNING candidate once per lane after it. A
    lane whose winner fails (a boundary-crossing window that spelled the
    query k-mer — it may have suppressed the true hit later in the loop)
    is reported ``unresolved`` with all hit fields cleared; the caller's
    phase 2 MUST then re-probe it from row 0 with in-loop validation
    (``probe_start`` stays 0 — the [0, probe_start) miss-proof above does
    not hold for deferred lanes). Saves ~2 random gathers per probe
    iteration on the packed/EF compact tiers.

    ``mphf_level_limit`` (mode="main", MPHF engines only): truncated
    minimizer-MPHF lookup — only the first N level bit-tests run and the
    final-hash searchsorted (log2(n_fh) dependent gathers batch-wide) is
    skipped; lanes the truncated chain cannot settle are reported
    ``unresolved`` with zero occurrences (they never probe). The caller's
    phase 2 re-runs them with the full lookup, and as with defer_valid
    its re-probe MUST keep ``probe_start=0`` (these lanes never probed).
    See boophf32_lookup.

    ``bucket_range``: (lo, hi) traced scalars for SHARDED execution (see
    parallel/sharding.py): ``d`` holds only the minimizer buckets in hash
    range [lo, hi) — ``prefix.flat2`` rebased to the shard, ``pos.inline``
    the shard's row slice. Lanes whose bucket falls outside the range get
    n_occs=0 (and therefore never probe, never use skew): outputs stay
    zero so a one-hot psum over shards reconstructs the global answer.
    Requires the direct engine with flat2 prefix rows.
    """
    m = d["meta"]
    k, w = m.k, m.w
    if xp is not np:
        # the probe fori_loop gathers with traced indices: all index arrays
        # must be device arrays (no-op if already transferred)
        import jax

        d = jax.tree_util.tree_map(xp.asarray, d)
    fw = xp.asarray(fw_words)
    rc = revcomp(fw, k)

    mm, offset, _is_fw, _canon = canonical_minimizer_batch(
        xp, fw, k, w, m.seed, ordering=getattr(m, "ordering", None), hash32=m.hash32
    )
    canon = xp.minimum(fw, rc)
    offset = offset.astype(xp.int64)

    mphf_unres = None  # truncated-MPHF lanes needing a full phase-2 lookup
    # bucket-inline MAIN probe (round 4): ONE bpos row gather replaces
    # the bucket-bounds gathers AND the packed pos window — bounds +
    # first-3 positions + count in 16B. Main-mode shallow probes only
    # (phases 2/2B keep the prefix/packed arrays).
    use_bpos = (
        "bpos" in d
        and mode == "main"
        and m.pos_kind == "packed"  # fixedcap rows have no bpos probe path
        and probe_start == 0
        and probe_limit is not None
        and 0 < probe_limit <= d["bpos"].shape[1] - 1
    )
    brow = None
    if m.direct_t:
        from .boophf32 import fold_hash32

        hc = (fold_hash32(mm) & np.uint32(m.direct_t - 1)).astype(xp.int64)
        if bucket_range is not None:
            # bucket-sharded deployment: this shard owns buckets
            # [lo_b, hi_b); its bpos/flat2 tables are the local slices
            # (round 5: bpos composes — non-owner lanes zero their
            # n_occs so they never probe and emit exact zeros)
            assert m.pos_kind != "fixedcap" and (
                use_bpos or "flat2" in d.get("prefix", {})
            ), "bucket_range requires the direct engine with flat2/bpos rows"
            lo_b, hi_b = bucket_range
            mine = (hc >= lo_b) & (hc < hi_b)
            local_T = (
                d["bpos"].shape[0] if use_bpos else d["prefix"]["flat2"].shape[0]
            )
            hc = xp.clip(hc - lo_b, 0, local_T - 1)
        if use_bpos:
            brow = d["bpos"][hc]
            n_occs = brow[..., 3].astype(xp.int64)
            if bucket_range is not None:
                n_occs = xp.where(mine, n_occs, xp.zeros_like(n_occs))
            ps = xp.zeros_like(n_occs)
        elif m.pos_kind in ("fixedcap", "fixedcap2"):
            # direct row addressing: bucket b's rows at [b*B, (b+1)*B) —
            # no bucket-bounds gather. Slot 0's uid field flags heavy
            # (skew) buckets; invalid slots self-reject in verification
            # (their extents are start=end=0). The slot-0 gather CSEs with
            # the j=0 probe gather. fixedcap2 additionally carries the
            # bucket's occurrence count in slot-0's uid top bits: exact
            # n_occs, so misses on small/empty buckets resolve in the main
            # phase instead of flooding the overflow pass.
            B = m.cap
            ps = hc * B
            row0 = d["pos"]["inline"][ps]
            if m.pos_kind == "fixedcap2":
                f0 = row0[..., 1]
                sent = f0 >= np.uint32(0xFFFFFFFE)
                n_occs = xp.where(
                    sent,
                    xp.zeros(xp.shape(hc), dtype=xp.int64),
                    (f0 >> np.uint32(29)).astype(xp.int64),
                )
            else:
                n_occs = xp.full(xp.shape(hc), B, dtype=xp.int64)
        elif "flat2" in d.get("prefix", {}):
            pair = d["prefix"]["flat2"][hc]
            ps = pair[..., 0].astype(xp.int64)
            pe = pair[..., 1].astype(xp.int64)
            n_occs = pe - ps
            if bucket_range is not None:
                n_occs = xp.where(mine, n_occs, xp.zeros_like(n_occs))
        else:
            ps, pe = _prefix_pair(d, hc, xp)
            n_occs = pe - ps
    else:
        assert bucket_range is None, "bucket_range requires engine='direct'"
        if mode == "main" and mphf_level_limit is not None:
            h, mphf_unres = mphf_lookup(
                d["mphf"], mm, xp, level_limit=mphf_level_limit
            )
            h = h.astype(xp.int64)
        else:
            h = mphf_lookup(d["mphf"], mm, xp).astype(xp.int64)
        hc = xp.clip(h, 0, None)
        if use_bpos:
            brow = d["bpos"][hc]
            n_occs = brow[..., 3].astype(xp.int64)
            ps = xp.zeros_like(n_occs)
        elif "flat2" in d.get("prefix", {}):
            pair = d["prefix"]["flat2"][hc]
            ps = pair[..., 0].astype(xp.int64)
            pe = pair[..., 1].astype(xp.int64)
        else:
            ps, pe = _prefix_pair(d, hc, xp)
        if not use_bpos:
            n_occs = xp.where(h < 0, xp.zeros_like(pe), pe - ps)
        else:
            n_occs = xp.where(h < 0, xp.zeros_like(n_occs), n_occs)

    if m.pos_kind in ("fixedcap", "fixedcap2"):
        use_skew = row0[..., 1] == np.uint32(0xFFFFFFFE)
    else:
        use_skew = (
            (n_occs > m.skew_param)
            if m.skew_param >= 0
            else xp.zeros_like(n_occs, dtype=bool)
        )

    last_km_start = d["us"]["meta"].total_len - k
    rc_offset = k - offset - w

    # fused layout: inline u32 rows also carry (occ_lo, occ_hi, occ_cnt)
    # and (width >= 14) the unitig's ctable start — occ_cnt and occ_start
    # ride PACKED in one int64 state slot (cnt | start << 32)
    fused = (
        m.pos_kind in ("inline", "fixedcap") and d["pos"]["inline"].shape[1] >= 13
    ) or (
        m.pos_kind in ("inline2", "fixedcap2") and d["pos"]["inline"].shape[1] >= 14
    )
    fused14 = fused and (
        d["pos"]["inline"].shape[1]
        >= (14 if m.pos_kind not in ("inline2", "fixedcap2") else 12)
    )
    # every carry slot derives from ``ps`` (zeros_like) so the whole
    # state shares ps's varying-manual-axes under shard_map — fresh
    # xp.zeros(...) slots are UNVARYING and the deep-probe fori_loop
    # rejects the carry inside a sharded query (vma mismatch, found on
    # the 1Gbp sharded proof; fixture meshes unroll bound<=8 and never
    # hit the loop)
    zero = xp.zeros_like(ps)
    state = (
        xp.zeros_like(ps, dtype=bool),  # found
        zero,  # uid
        zero,  # ulen
        zero,  # pos
        xp.zeros_like(ps, dtype=xp.uint8),  # mt
        xp.zeros_like(ps, dtype=xp.uint64),  # occ_word (fused)
        zero,  # occ_cnt (fused; inline2 packs cnt | occ_start << 32)
        xp.zeros_like(ps, dtype=xp.uint64),  # occ_word2 (inline2 fused)
    )

    n_pos = d["pos"]["meta"].length

    def probe_body_records(j, state):
        """Two-row-gather probe: one occurrence record (mm_pos, uid, start,
        end) + one overlapping useq word-quad covering BOTH candidate
        k-mers. A valid candidate provably lies in the record's unitig
        (mm_pos in [km_pos, km_pos+k) and km_pos+k <= unitig end), so no
        rank/extent lookups are needed."""
        found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2 = state
        active = (~found) & (j < n_occs) & (~use_skew)
        rec = d["pos"]["records"][xp.clip(ps + j, 0, n_pos - 1)]
        mm_pos = rec[..., 0].astype(xp.int64)
        uid = rec[..., 1].astype(xp.int64)
        start = rec[..., 2].astype(xp.int64)
        end = rec[..., 3].astype(xp.int64)

        base = xp.clip(mm_pos - (k - w), 0, None)
        bit = base * 2
        wi = bit >> 6
        woff = (bit & 63).astype(xp.int64)
        quad = d["useq_quad"][wi]
        q0, q1, q2 = quad[..., 0], quad[..., 1], quad[..., 2]
        m2k = U64((1 << (2 * k)) - 1)

        for cand_off in (offset, rc_offset):
            km_pos = mm_pos - cand_off
            delta = xp.clip(km_pos - base, 0, None)
            dbit = woff + 2 * delta
            s1 = dbit >= 64
            r = (dbit & 63).astype(xp.uint64)
            lo_w = xp.where(s1, q1, q0)
            hi_w = xp.where(s1, q2, q1)
            hi_shift = (U64(64) - r) & U64(63)
            hi = xp.where(r == 0, xp.zeros_like(hi_w), hi_w << hi_shift)
            kw = ((lo_w >> r) | hi) & m2k
            mt = word_equivalency(fw, rc, kw, k)
            valid = active & (km_pos >= start) & (km_pos + k <= end)
            hit = valid & (mt > 0)
            out_uid = xp.where(hit, uid, out_uid)
            out_ulen = xp.where(hit, end - start, out_ulen)
            out_pos = xp.where(hit, km_pos - start, out_pos)
            out_mt = xp.where(hit, mt, out_mt)
            found = found | hit
            active = active & (~hit)
        return found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2

    def probe_body_generic(j, state):
        """DEFERRED-MAP probe for the packed/EF compact tiers: candidates
        are validated with ``us_is_valid_pos`` (one 2-word boundary-bv
        window read — provably equivalent to the unitig-extent check: the
        boundary bit of the containing unitig sits at end-1, so it falls
        inside [km_pos, km_pos+k-1) exactly when km_pos+k > end; this is
        the same predicate the reference uses at src/kphf/pfhash.rs:253).
        The winning useq position is stored in the ``pos`` slot and mapped
        to (unitig_id, len, upos) by ONE _map_hit after the loop — the
        rank+extent gathers are paid per LANE, not per candidate.

        Both candidate k-mers lie inside [mm_pos-(k-w), mm_pos+k), a
        span of 2k-w bases <= 157 bits from an arbitrary word offset, so
        ONE 3-word useq window serves both extractions (the same quad
        trick as the records layout): with paired words that is one
        random 2-wide gather + one ADJACENT 2-wide gather instead of two
        random window reads — the probe iteration drops from 2 random
        useq gathers to 1."""
        found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2 = state
        active = (~found) & (j < n_occs) & (~use_skew)
        if pos_win is not None and isinstance(j, int):
            mm_pos = pos_win[j]
        else:
            mm_pos = _pos_get(d, xp.clip(ps + j, 0, n_pos - 1), xp)
        base = xp.clip(mm_pos - (k - w), 0, None)
        bit = base * 2
        wi = bit >> 6
        woff = (bit & 63).astype(xp.uint64)
        useq = d["us"]["useq"]
        if "words2" in useq:
            nw2 = useq["words2"].shape[0]
            p0 = useq["words2"][xp.clip(wi, 0, nw2 - 1)]
            p1 = useq["words2"][xp.clip(wi + 1, 0, nw2 - 1)]
            q0, q1, q2 = p0[..., 0], p0[..., 1], p1[..., 1]
        else:
            words = useq["words"]
            nw = words.shape[0]
            q0 = words[xp.clip(wi, 0, nw - 1)]
            q1 = words[xp.clip(wi + 1, 0, nw - 1)]
            q2 = words[xp.clip(wi + 2, 0, nw - 1)]
        m2k = U64((1 << (2 * k)) - 1)
        for cand_off in (offset, rc_offset):
            km_pos = mm_pos - cand_off
            in_range = (mm_pos >= cand_off) & (km_pos <= last_km_start)
            km_pos_c = xp.clip(km_pos, 0, max(last_km_start, 0))
            dbit = woff + (2 * xp.clip(km_pos_c - base, 0, None)).astype(xp.uint64)
            s1 = dbit >= 64
            r = (dbit & U64(63)).astype(xp.uint64)
            lo_w = xp.where(s1, q1, q0)
            hi_w = xp.where(s1, q2, q1)
            hi_shift = (U64(64) - r) & U64(63)
            hi = xp.where(r == 0, xp.zeros_like(hi_w), hi_w << hi_shift)
            kw = ((lo_w >> r) | hi) & m2k
            mt = word_equivalency(fw, rc, kw, k)
            hit = active & in_range & (mt > 0)
            if not defer_valid:
                hit = hit & us_is_valid_pos(d["us"], km_pos_c, xp)
            out_pos = xp.where(hit, km_pos_c, out_pos)  # useq pos, mapped later
            out_mt = xp.where(hit, mt, out_mt)
            found = found | hit
            active = active & (~hit)
        return found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2

    def probe_body_usrec(j, state):
        """Per-32-base WINDOW-RECORD probe (round 4, build_useqrec): ONE
        56B row gather per iteration carries the whole 96-base candidate
        window plus the containing unitig's extent, id, and projection
        record — the extent check (== the boundary-bv validity
        predicate), the rank, and the whole projection tail ride the
        probe gather; zero post-loop gathers for in-unitig hits: one row
        per iteration is the design point.

        A candidate whose k-mer word matches but whose position fails
        the row's extent check (its window spans a unitig boundary, or
        the candidate lies in the unitig after the row's) is marked with
        the mt==3 sentinel WITHOUT stopping the probe; post-loop such
        lanes (if still unfound) are reported unresolved and the
        caller's phase 2 re-probes them from row 0 with full boundary-bv
        validation — a window that spells the query across a boundary is
        not a hit, and a true boundary-adjacent hit is recovered there."""
        found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2 = state
        active = (~found) & (j < n_occs) & (~use_skew)
        if pos_win is not None and isinstance(j, int):
            mm_pos = pos_win[j]
        else:
            mm_pos = _pos_get(d, xp.clip(ps + j, 0, n_pos - 1), xp)
        base = xp.clip(mm_pos - (k - w), 0, None)
        wi = (base * 2) >> 6
        rec = d["us"]["useqrec"]
        nrec = rec.shape[0]
        r0 = rec[xp.clip(wi, 0, nrec - 1)]
        q0, q1, q2 = r0[..., 0], r0[..., 1], r0[..., 2]
        f2 = r0[..., 3]
        ustart = (f2 & U64((1 << 40) - 1)).astype(xp.int64)
        ulen = (f2 >> U64(40)).astype(xp.int64)
        f3 = r0[..., 4]
        uid = (f3 & U64(0xFFFFFFFF)).astype(xp.int64)
        cnt = (f3 >> U64(32)).astype(xp.int64)
        woff = ((base * 2) & 63).astype(xp.uint64)
        m2k = U64((1 << (2 * k)) - 1)
        for cand_off in (offset, rc_offset):
            km_pos = mm_pos - cand_off
            in_range = (mm_pos >= cand_off) & (km_pos <= last_km_start)
            km_pos_c = xp.clip(km_pos, 0, max(last_km_start, 0))
            dbit = woff + (2 * xp.clip(km_pos_c - base, 0, None)).astype(xp.uint64)
            s1 = dbit >= 64
            r = (dbit & U64(63)).astype(xp.uint64)
            lo_w = xp.where(s1, q1, q0)
            hi_w = xp.where(s1, q2, q1)
            hi_shift = (U64(64) - r) & U64(63)
            hi = xp.where(r == 0, xp.zeros_like(hi_w), hi_w << hi_shift)
            kw = ((lo_w >> r) | hi) & m2k
            mt = word_equivalency(fw, rc, kw, k)
            ok = (km_pos_c >= ustart) & (km_pos_c + k <= ustart + ulen)
            kwm = active & in_range & (mt > 0)
            hit = kwm & ok
            out_uid = xp.where(hit, uid, out_uid)
            out_ulen = xp.where(hit, ulen, out_ulen)
            out_pos = xp.where(hit, km_pos_c - ustart, out_pos)
            out_mt = xp.where(
                hit, mt, xp.where(kwm & (~ok), xp.uint8(3), out_mt)
            )
            out_ow = xp.where(hit, r0[..., 5], out_ow)
            out_ow2 = xp.where(hit, r0[..., 6], out_ow2)
            out_oc = xp.where(hit, cnt, out_oc)
            found = found | hit
            active = active & (~hit)
        return found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2

    def probe_body_inline(j, state):
        """ONE-row-gather probe: the occurrence row carries ids, extents,
        and the useq words of the whole candidate window."""
        found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2 = state
        active = (~found) & (j < n_occs) & (~use_skew)
        row = d["pos"]["inline"][xp.clip(ps + j, 0, n_pos - 1)]  # u32 cols
        mm_pos = row[..., 0].astype(xp.int64)
        uid = row[..., 1].astype(xp.int64)
        start = row[..., 2].astype(xp.int64)
        end = row[..., 3].astype(xp.int64)

        def _w64(lo, hi):
            return lo.astype(xp.uint64) | (hi.astype(xp.uint64) << U64(32))

        q0 = _w64(row[..., 4], row[..., 5])
        q1 = _w64(row[..., 6], row[..., 7])
        q2 = _w64(row[..., 8], row[..., 9])

        base = xp.clip(mm_pos - (k - w), 0, None)
        woff = ((base * 2) & 63).astype(xp.int64)
        m2k = U64((1 << (2 * k)) - 1)
        for cand_off in (offset, rc_offset):
            km_pos = mm_pos - cand_off
            delta = xp.clip(km_pos - base, 0, None)
            dbit = woff + 2 * delta
            s1 = dbit >= 64
            r = (dbit & 63).astype(xp.uint64)
            lo_w = xp.where(s1, q1, q0)
            hi_w = xp.where(s1, q2, q1)
            hi_shift = (U64(64) - r) & U64(63)
            hi = xp.where(r == 0, xp.zeros_like(hi_w), hi_w << hi_shift)
            kw = ((lo_w >> r) | hi) & m2k
            mt = word_equivalency(fw, rc, kw, k)
            valid = active & (km_pos >= start) & (km_pos + k <= end)
            hit = valid & (mt > 0)
            out_uid = xp.where(hit, uid, out_uid)
            out_ulen = xp.where(hit, end - start, out_ulen)
            out_pos = xp.where(hit, km_pos - start, out_pos)
            out_mt = xp.where(hit, mt, out_mt)
            if fused:
                out_ow = xp.where(hit, _w64(row[..., 10], row[..., 11]), out_ow)
                oc = row[..., 12].astype(xp.int64)
                if fused14:
                    oc = oc | (row[..., 13].astype(xp.int64) << 32)
                out_oc = xp.where(hit, oc, out_oc)
            found = found | hit
            active = active & (~hit)
        return found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2

    def probe_body_inline2(j, state):
        """Pre-aligned ONE-row-gather probe; fused rows also carry the
        unitig's first TWO encoded occurrences (cols 8..13: occ1_lo,
        occ1_hi, cnt, occ_start, occ2_lo, occ2_hi)."""
        found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2 = state
        active = (~found) & (j < n_occs) & (~use_skew)
        row = d["pos"]["inline"][xp.clip(ps + j, 0, n_pos - 1)]  # u32 cols
        mm_pos = row[..., 0].astype(xp.int64)
        uid = row[..., 1].astype(xp.int64)
        if m.pos_kind == "fixedcap2":
            # slot-0 uid field carries the bucket occ count in its top bits
            uid = uid & ((1 << 29) - 1)
        start = row[..., 2].astype(xp.int64)
        end = row[..., 3].astype(xp.int64)

        def _w64(lo, hi):
            return lo.astype(xp.uint64) | (hi.astype(xp.uint64) << U64(32))

        W0 = _w64(row[..., 4], row[..., 5])
        W1 = _w64(row[..., 6], row[..., 7])
        base = xp.clip(mm_pos - (k - w), 0, None)
        m2k = U64((1 << (2 * k)) - 1)
        for cand_off in (offset, rc_offset):
            km_pos = mm_pos - cand_off
            delta = xp.clip(km_pos - base, 0, None)
            r = (2 * delta).astype(xp.uint64)
            hi_shift = (U64(64) - r) & U64(63)
            hi = xp.where(r == 0, xp.zeros_like(W1), W1 << hi_shift)
            kw = ((W0 >> r) | hi) & m2k
            mt = word_equivalency(fw, rc, kw, k)
            valid = active & (km_pos >= start) & (km_pos + k <= end)
            hit = valid & (mt > 0)
            out_uid = xp.where(hit, uid, out_uid)
            out_ulen = xp.where(hit, end - start, out_ulen)
            out_pos = xp.where(hit, km_pos - start, out_pos)
            out_mt = xp.where(hit, mt, out_mt)
            if fused:
                out_ow = xp.where(hit, _w64(row[..., 8], row[..., 9]), out_ow)
                oc = row[..., 10].astype(xp.int64) | (
                    row[..., 11].astype(xp.int64) << 32
                )
                out_oc = xp.where(hit, oc, out_oc)
                out_ow2 = xp.where(hit, _w64(row[..., 12], row[..., 13]), out_ow2)
            found = found | hit
            active = active & (~hit)
        return found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2

    probe_body = {
        "records": probe_body_records,
        "inline": probe_body_inline,
        "inline2": probe_body_inline2,
        "fixedcap": probe_body_inline,  # same u32 row layout, direct-addressed
        "fixedcap2": probe_body_inline2,  # pre-aligned rows, direct-addressed
    }.get(m.pos_kind, probe_body_generic)
    if (
        mode == "main"
        and probe_start == 0
        and m.pos_kind == "packed"
        and "useqrec" in d.get("us", {})
    ):
        # window-record probe: validation + rank + projection ride the
        # candidate fetch (see build_useqrec). Main-mode only — its
        # kw-matched-but-unvalidated lanes surface as unresolved, which
        # full mode has no channel for; and probe_start must be 0 (those
        # lanes' shallow rows were not proven misses).
        probe_body = probe_body_usrec

    bound = m.probe_bound
    if mode == "main" and probe_limit is not None:
        # shallow main probe: only the first ``probe_limit`` candidate rows
        # are checked batch-wide; lanes left unresolved with more
        # occurrences are reported via ``unresolved`` for the caller's
        # compacted overflow pass (see get_ref_pos_compact)
        bound = min(bound, probe_limit)
    pos_win = None
    if use_bpos and probe_body in (probe_body_generic, probe_body_usrec):
        # candidate positions came inline with the bpos row — the whole
        # shallow loop runs with ZERO position gathers
        pos_win = [brow[..., j].astype(xp.int64) for j in range(bound)]
    elif (
        probe_body in (probe_body_generic, probe_body_usrec)
        and m.pos_kind == "packed"
        and probe_start == 0
        and bound - probe_start <= 8
        and bound > 1
    ):
        # shallow unrolled probe over CONSECUTIVE packed entries: fetch
        # them all in one window read (1 random gather for the whole loop)
        pos_win = _pos_window(d, ps, bound, xp)
    if xp is np or bound <= 8:
        # small static bound: unroll (avoids while_loop lowering entirely)
        for j in range(probe_start, bound):
            state = probe_body(j, state)
    else:
        import jax.lax as lax

        # dynamic bound: the largest non-skew bucket in this batch (traced),
        # capped by the static probe bound — lowers to a while_loop with a
        # single trace of the body instead of a probe_bound-times-unrolled HLO
        dyn_bound = xp.minimum(
            xp.max(xp.where(use_skew, xp.zeros_like(n_occs), n_occs)),
            bound,
        ).astype(xp.int32)
        state = lax.fori_loop(
            xp.int32(probe_start), dyn_bound, probe_body, state
        )

    found, out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc, out_ow2 = state
    deferred_fail = None
    maybe = None
    uproj = d["us"].get("uproj")
    uproj_fused = False
    usrec_fused = False
    if probe_body is probe_body_usrec:
        # mt==3 sentinel: kw-matched candidates the inline extent check
        # could not validate (window spans a unitig boundary) — cleared
        # here and routed to the caller's validating phase 2
        maybe = out_mt == xp.uint8(3)
        out_mt = xp.where(maybe, xp.zeros_like(out_mt), out_mt)
        uproj_fused = True  # occ projection fields ride the record rows
        usrec_fused = True  # ... but occ_start does NOT (56B row budget)
    if probe_body is probe_body_generic:
        posw = xp.where(found, out_pos, xp.zeros_like(out_pos))
        uid_r = None
        if defer_valid:
            assert mode == "main", "defer_valid needs a phase-2 to recover fails"
            if "wb2" in d["us"]["bv"]:
                # fused validate+rank: one wb2 pair window serves both
                # (the separate calls re-fetch the same boundary word)
                vok, uid_r = us_validate_rank(d["us"], posw, xp)
            else:
                vok = us_is_valid_pos(d["us"], posw, xp)
            deferred_fail = found & (~vok)
            found = found & vok
            out_mt = xp.where(found, out_mt, xp.zeros_like(out_mt))
        if uproj is not None:
            # one per-unitig record gather resolves extent AND occurrence
            # bounds AND the first two encoded occurrences (build_uproj)
            from ..containers.unitig_set import us_rank

            if uid_r is None:
                uid_r = us_rank(
                    d["us"], xp.where(found, out_pos, xp.zeros_like(out_pos)), xp
                )
            uid = xp.clip(uid_r, 0, uproj.shape[0] - 1)
            row = uproj[uid]
            ustart = row[..., 0].astype(xp.int64)
            out_uid = xp.where(found, uid, out_uid)
            out_ulen = xp.where(found, row[..., 1].astype(xp.int64), out_ulen)
            out_pos = xp.where(found, out_pos - ustart, out_pos)
            if mode == "main":
                uoc = row[..., 2]
                zl = xp.zeros_like(out_pos)
                zw = xp.zeros_like(row[..., 3])
                out_ow = xp.where(found, row[..., 3], zw)
                out_ow2 = xp.where(found, row[..., 4], zw)
                out_oc = xp.where(
                    found,
                    (uoc & U64(0xFFFFFFFF)).astype(xp.int64)
                    | ((uoc >> U64(32)).astype(xp.int64) << 32),
                    zl,
                )
                uproj_fused = True
        else:
            # deferred mapping of the winning useq positions (see probe
            # body): rank + extent per LANE instead of per candidate
            # (rank already fused into the validation window above)
            if uid_r is not None:
                from ..containers.unitig_set import us_extent

                uid = xp.clip(uid_r, 0, max(d["us"]["meta"].n_unitigs - 1, 0))
                start, end = us_extent(d["us"], uid, xp)
                ulen = end - start
                upos = xp.where(found, out_pos, xp.zeros_like(out_pos)) - start
            else:
                uid, ulen, upos, _end_ok = _map_hit(
                    d, xp.where(found, out_pos, xp.zeros_like(out_pos)), xp
                )
            out_uid = xp.where(found, uid, out_uid)
            out_ulen = xp.where(found, ulen, out_ulen)
            out_pos = xp.where(found, upos, out_pos)

    # skew path (reference src/kphf/sshash.rs:415-433)
    if mode == "main":
        out = {
            "unitig_id": out_uid,
            "unitig_len": out_ulen,
            "pos": out_pos,
            "mt": out_mt,
            "use_skew": use_skew,
            # lanes the shallow probe could not settle: no hit found but
            # candidate rows beyond the probed depth exist — plus lanes
            # whose deferred-validation winner failed (must re-probe from
            # row 0 WITH validation; see defer_valid) — plus lanes the
            # truncated MPHF chain could not place (never probed at all;
            # see mphf_level_limit)
            "unresolved": ((~found) & (~use_skew) & (n_occs > bound))
            | (
                deferred_fail
                if deferred_fail is not None
                else xp.zeros_like(found)
            )
            | (maybe if maybe is not None else xp.zeros_like(found))
            | (
                mphf_unres
                if mphf_unres is not None
                else xp.zeros_like(found)
            ),
        }
        if bucket_range is not None:
            out["mine"] = mine
        if fused:
            out["occ_word"] = out_ow
            if fused14:
                out["occ_cnt"] = out_oc & 0xFFFFFFFF
                out["occ_start"] = out_oc >> 32
            else:
                out["occ_cnt"] = out_oc
            if m.pos_kind in ("inline2", "fixedcap2"):
                out["occ_word2"] = out_ow2
        elif uproj_fused:
            # capacity-tier fused projection data from the uproj/useqrec
            # record (width 2: occ_word2 present) — use_skew/unresolved
            # lanes carry zeros and resolve in the caller's phase 2
            out["occ_word"] = out_ow
            out["occ_word2"] = out_ow2
            out["occ_cnt"] = out_oc & 0xFFFFFFFF
            if not usrec_fused:
                # useqrec rows do not carry occ_start (56B budget): the
                # key must be ABSENT so cnt>2 (type-A) lanes re-gather
                # their occurrence bounds in the compacted phase
                out["occ_start"] = out_oc >> 32
        return out
    out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc = skew_resolve(
        d,
        fw,
        rc,
        canon,
        use_skew,
        (out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc),
        xp,
        fused=fused,
        fused14=fused14,
    )

    out = {
        "unitig_id": out_uid,
        "unitig_len": out_ulen,
        "pos": out_pos,
        "mt": out_mt,
    }
    if bucket_range is not None:
        out["mine"] = mine
    if fused:
        out["occ_word"] = out_ow
        if fused14:
            out["occ_cnt"] = out_oc & 0xFFFFFFFF
            out["occ_start"] = out_oc >> 32
        else:
            out["occ_cnt"] = out_oc
        if m.pos_kind in ("inline2", "fixedcap2"):
            out["occ_word2"] = out_ow2
    elif uproj is not None:
        # full mode: one end-of-pipeline uproj fetch over the FINAL uid
        # (generic and skew lanes alike) hands the projection its occ
        # bounds + first two occurrences without the offsets gathers
        hitm = out_mt > 0
        rowf = uproj[xp.clip(out_uid, 0, uproj.shape[0] - 1)]
        uoc = rowf[..., 2]
        zl = xp.zeros_like(out_pos)
        zw = xp.zeros_like(rowf[..., 3])
        out["occ_word"] = xp.where(hitm, rowf[..., 3], zw)
        out["occ_word2"] = xp.where(hitm, rowf[..., 4], zw)
        out["occ_cnt"] = xp.where(hitm, (uoc & U64(0xFFFFFFFF)).astype(xp.int64), zl)
        out["occ_start"] = xp.where(hitm, (uoc >> U64(32)).astype(xp.int64), zl)
    return out


def skew_resolve(d, fw, rc, canon, use_skew, state, xp, fused=False, fused14=False):
    """Resolve heavy-bucket (skew) lanes for ALL skew layouts — the single
    source of truth shared by ``sshash_k2u`` and the sharded query builders
    (parallel/sharding.py), so engine="direct" skew works everywhere.

    Layouts (reference skew index: src/kphf/sshash.rs:415-433):
    - ``skew_inline`` + skew_kind="cuckoo": two-choice table, 2 row gathers
    - ``skew_prefix2`` + ``skew_inline``: direct-mapped bounded buckets
    - ``skew_mphf`` + ``skew_pos``: MPHF over skew k-mers (parity/fast32)

    ``state`` = (uid, ulen, pos, mt, occ_word, occ_cnt); lanes where
    ``use_skew`` is False pass through unchanged. Returns updated state."""
    m = d["meta"]
    k = m.k
    out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc = state
    if "skew_inline" in d and getattr(m, "skew_kind", "bucket") == "cuckoo":
        # two-choice (cuckoo) skew: exactly TWO row gathers, no bounds
        from .boophf32 import fold_hash32, fold_hash32b

        t2m = np.uint32(m.skew_t - 1)
        h1 = (fold_hash32(canon) & t2m).astype(xp.int64)
        h2 = (fold_hash32b(canon, m.skew_salt) & t2m).astype(xp.int64)
        m2k = U64((1 << (2 * k)) - 1)
        sfound = xp.zeros(xp.shape(fw), dtype=bool)

        def _sw64(lo, hi):
            return lo.astype(xp.uint64) | (hi.astype(xp.uint64) << U64(32))

        for slot in (h1, h2):
            row = d["skew_inline"][slot]  # u32 cols
            uidf = row[..., 1]
            svalid = uidf != np.uint32(0xFFFFFFFF)
            kpos = row[..., 0].astype(xp.int64)
            w0 = _sw64(row[..., 4], row[..., 5])
            w1 = _sw64(row[..., 6], row[..., 7])
            r = ((kpos * 2) & 63).astype(xp.uint64)
            hi_shift = (U64(64) - r) & U64(63)
            hi = xp.where(r == 0, xp.zeros_like(w1), w1 << hi_shift)
            kw = ((w0 >> r) | hi) & m2k
            mt = word_equivalency(fw, rc, kw, k)
            hit = use_skew & (~sfound) & svalid & (mt > 0)
            start = row[..., 2].astype(xp.int64)
            end = row[..., 3].astype(xp.int64)
            out_uid = xp.where(hit, uidf.astype(xp.int64), out_uid)
            out_ulen = xp.where(hit, end - start, out_ulen)
            out_pos = xp.where(hit, kpos - start, out_pos)
            out_mt = xp.where(hit, mt, out_mt)
            if fused and d["skew_inline"].shape[1] >= 11:
                out_ow = xp.where(hit, _sw64(row[..., 8], row[..., 9]), out_ow)
                oc = row[..., 10].astype(xp.int64)
                if fused14 and d["skew_inline"].shape[1] >= 12:
                    oc = oc | (row[..., 11].astype(xp.int64) << 32)
                out_oc = xp.where(hit, oc, out_oc)
            sfound = sfound | hit
    elif "skew_prefix2" in d:
        # direct-mapped skew: bounded ONE-row-gather probes
        from .boophf32 import fold_hash32

        b2 = (fold_hash32(canon) & np.uint32(m.skew_t - 1)).astype(xp.int64)
        spair = d["skew_prefix2"][b2]
        s2 = spair[..., 0].astype(xp.int64)
        c2 = spair[..., 1].astype(xp.int64) - s2
        n_srec = d["skew_inline"].shape[0]
        m2k = U64((1 << (2 * k)) - 1)
        sfound = xp.zeros(xp.shape(fw), dtype=bool)

        def _bw64(lo, hi):
            return lo.astype(xp.uint64) | (hi.astype(xp.uint64) << U64(32))

        for j in range(m.skew_bound):
            row = d["skew_inline"][xp.clip(s2 + j, 0, max(n_srec - 1, 0))]  # u32
            kpos = row[..., 0].astype(xp.int64)
            w0 = _bw64(row[..., 4], row[..., 5])
            w1 = _bw64(row[..., 6], row[..., 7])
            r = ((kpos * 2) & 63).astype(xp.uint64)
            hi_shift = (U64(64) - r) & U64(63)
            hi = xp.where(r == 0, xp.zeros_like(w1), w1 << hi_shift)
            kw = ((w0 >> r) | hi) & m2k
            mt = word_equivalency(fw, rc, kw, k)
            hit = use_skew & (~sfound) & (j < c2) & (mt > 0)
            start = row[..., 2].astype(xp.int64)
            end = row[..., 3].astype(xp.int64)
            out_uid = xp.where(hit, row[..., 1].astype(xp.int64), out_uid)
            out_ulen = xp.where(hit, end - start, out_ulen)
            out_pos = xp.where(hit, kpos - start, out_pos)
            out_mt = xp.where(hit, mt, out_mt)
            if fused and d["skew_inline"].shape[1] >= 11:
                out_ow = xp.where(hit, _bw64(row[..., 8], row[..., 9]), out_ow)
                oc = row[..., 10].astype(xp.int64)
                if fused14 and d["skew_inline"].shape[1] >= 12:
                    oc = oc | (row[..., 11].astype(xp.int64) << 32)
                out_oc = xp.where(hit, oc, out_oc)
            sfound = sfound | hit
    elif "skew_mphf" in d:
        last_km_start = d["us"]["meta"].total_len - k
        h2 = mphf_lookup(d["skew_mphf"], canon, xp).astype(xp.int64)
        n_skew = d["skew_pos"]["meta"].length
        sp = iv_get(d["skew_pos"], xp.clip(h2, 0, n_skew - 1), xp).astype(xp.int64)
        sp = xp.clip(sp, 0, max(last_km_start, 0))
        kw = us_get_kmer(d["us"], sp, xp)
        mt = word_equivalency(fw, rc, kw, k)
        uid, ulen, upos, end_ok = _map_hit(d, sp, xp)
        hit = use_skew & (h2 >= 0) & (mt > 0) & end_ok
        out_uid = xp.where(hit, uid, out_uid)
        out_ulen = xp.where(hit, ulen, out_ulen)
        out_pos = xp.where(hit, upos, out_pos)
        out_mt = xp.where(hit, mt, out_mt)
    return out_uid, out_ulen, out_pos, out_mt, out_ow, out_oc


class TwoPhaseSSHash:
    """Host-driven two-phase query: a slim main kernel (no skew gathers)
    for the whole batch, then a compacted mode="full" pass for the rare
    heavy-bucket lanes. Results identical to one-kernel mode="full"."""

    def __init__(self, ss: "SSHash", device=None):
        import jax
        import jax.numpy as jnp

        self._jnp = jnp
        self.d = jax.device_put(ss.device_arrays(), device)
        self.main = jax.jit(lambda fw: sshash_k2u(self.d, fw, jnp, mode="main"))
        self.full = jax.jit(lambda fw: sshash_k2u(self.d, fw, jnp))

    def k2u(self, fw_words: np.ndarray) -> dict:
        import jax

        jnp = self._jnp
        r = {
            k: np.array(v)  # writable host copies (device_get views are read-only)
            for k, v in jax.device_get(self.main(jnp.asarray(fw_words))).items()
        }
        lanes = np.flatnonzero(r.pop("use_skew"))
        if len(lanes):
            b = 1 << max(6, int(np.ceil(np.log2(len(lanes)))))
            padded = np.zeros(b, dtype=np.uint64)
            padded[: len(lanes)] = fw_words[lanes]
            s = {k: np.asarray(v) for k, v in jax.device_get(self.full(jnp.asarray(padded))).items()}
            for key in ("unitig_id", "unitig_len", "pos", "mt"):
                r[key][lanes] = s[key][: len(lanes)]
        return r
