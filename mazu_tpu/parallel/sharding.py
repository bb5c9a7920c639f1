"""Multi-chip sharding of index queries.

The reference is a single-process rayon library (SURVEY.md §2 note); this
build's distribution model:

1. **Replicated index, data-parallel queries** (small references): the
   index pytree is replicated on every chip; the query batch is sharded on
   the leading axis over the ``data`` mesh axis. No collectives in the hot
   path.

2. **Minimizer-bucket-sharded index** (large references): the MPHF hash
   space of minimizers is split into contiguous ranges; each ``bucket``
   shard owns its slice of the bucket-bounds prefix and position arrays.
   Queries are visible to all bucket shards (broadcast along ``bucket``);
   each shard resolves only the queries whose minimizer hash it owns and
   the per-query one-hot results combine with a single ``psum`` over the
   ``bucket`` axis. The unitig set and MPHF are replicated (they are the
   query-verification path); the heavy per-occurrence arrays are sharded.

Both are expressed with ``jax.sharding`` + ``shard_map`` so XLA inserts
the collectives and they ride ICI on a real pod slice.
"""

from __future__ import annotations

import numpy as np


def make_data_parallel_query(index_arrays, query_pipeline, mesh, axis: str = "data"):
    """Replicated-index DP: returns jitted fn kms[N] -> padded results.

    ``query_pipeline(arrays, kms, jnp)`` is any batched query function
    (e.g. get_ref_pos_padded via functools.partial).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    repl = NamedSharding(mesh, P())
    shard = NamedSharding(mesh, P(axis))
    arrays = jax.device_put(index_arrays, repl)

    @jax.jit
    def query_impl(arr, kms):
        kms = jax.lax.with_sharding_constraint(kms, shard)
        return query_pipeline(arr, kms, jnp)

    def query(kms):
        return query_impl(arrays, kms)

    return arrays, query


def shard_sshash_buckets(ss, n_shards: int):
    """Host-side partition of an SSHash into ``n_shards`` bucket shards.

    Returns (shared, stacked) where ``shared`` is the replicated part
    (unitigs, mphf, skew) and ``stacked`` has leading axis ``n_shards``:
    per-shard flat prefix slices and position slices (padded).
    """
    prefix = ss.occs_prefix_sum
    n_min = len(prefix) - 1
    bounds = np.linspace(0, n_min, n_shards + 1).astype(np.int64)
    loc_prefix, loc_pos = [], []
    pos_all = ss.pos.to_array()
    max_prefix_len = 0
    max_pos_len = 0
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        p = prefix[lo : hi + 1] - prefix[lo]
        loc_prefix.append(p)
        loc_pos.append(pos_all[prefix[lo] : prefix[hi]])
        max_prefix_len = max(max_prefix_len, len(p))
        max_pos_len = max(max_pos_len, len(loc_pos[-1]))

    def pad(a, n):
        out = np.zeros(n, dtype=a.dtype)
        out[: len(a)] = a
        return out

    stacked = {
        "prefix": np.stack([pad(p, max_prefix_len) for p in loc_prefix]),
        "pos": np.stack([pad(p, max_pos_len) for p in loc_pos]).astype(np.int64),
        "lo": bounds[:-1][:, None],
        "hi": bounds[1:][:, None],
    }
    base = ss.device_arrays(prefix_kind="flat")
    shared = {k: v for k, v in base.items() if k not in ("prefix", "pos")}
    shared["meta"] = base["meta"]
    return shared, stacked


def make_bucket_sharded_query(ss, mesh, data_axis: str = "data", bucket_axis: str = "bucket"):
    """Minimizer-bucket-sharded SSHash k2u over a 2D (data, bucket) mesh.

    Queries are sharded over ``data`` and broadcast along ``bucket``; each
    bucket shard probes only its owned hash range; results merge with one
    psum over ``bucket``. Returns a jitted fn kms[N] -> k2u dict.
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    shard_map = jax.shard_map

    from ..containers.unitig_set import us_get_kmer
    from ..kmer import canonical_minimizer_batch, revcomp, word_equivalency
    from ..kphf.boophf32 import fold_hash32
    from ..kphf.sshash import _map_hit, mphf_lookup

    n_shards = mesh.shape[bucket_axis]
    shared, stacked = shard_sshash_buckets(ss, n_shards)
    m = shared["meta"]
    k, w = m.k, m.w
    probe_bound = m.probe_bound

    shared = jax.device_put(shared, NamedSharding(mesh, P()))
    stacked = jax.device_put(
        stacked, NamedSharding(mesh, P(bucket_axis))
    )  # leading axis = shard

    def shard_fn(shared, stk, kms):
        # stk leaves have leading dim 1 (this shard's slice)
        prefix = stk["prefix"][0]
        posarr = stk["pos"][0]
        lo = stk["lo"][0, 0]
        hi = stk["hi"][0, 0]

        fw = kms
        rc = revcomp(fw, k)
        mm, offset, _isfw, _canon = canonical_minimizer_batch(
            jnp, fw, k, w, m.seed, hash32=m.hash32
        )
        offset = offset.astype(jnp.int64)
        if m.direct_t:
            h = (fold_hash32(mm) & np.uint32(m.direct_t - 1)).astype(jnp.int64)
        else:
            h = mphf_lookup(shared["mphf"], mm, jnp).astype(jnp.int64)
        mine = (h >= lo) & (h < hi)
        hl = jnp.clip(h - lo, 0, prefix.shape[0] - 2)
        ps = prefix[hl]
        pe = prefix[hl + 1]
        n_occs = jnp.where(mine, pe - ps, 0)
        skew_param = m.skew_param
        use_skew = (n_occs > skew_param) if skew_param >= 0 else jnp.zeros_like(mine)

        last_km_start = shared["us"]["meta"].total_len - k
        rc_offset = k - offset - w
        # carry init must vary over the manual mesh axes like the outputs do
        zero = ps * 0
        state = (mine != mine, zero, zero, zero, zero.astype(jnp.uint8))

        def probe_body(j, state):
            found, o_uid, o_ulen, o_pos, o_mt = state
            active = (~found) & (j < n_occs) & (~use_skew)
            mm_pos = posarr[jnp.clip(ps + j, 0, posarr.shape[0] - 1)]
            for cand_off in (offset, rc_offset):
                km_pos = mm_pos - cand_off
                in_range = (mm_pos >= cand_off) & (km_pos <= last_km_start)
                km_pos_c = jnp.clip(km_pos, 0, max(last_km_start, 0))
                kw = us_get_kmer(shared["us"], km_pos_c, jnp)
                mt = word_equivalency(fw, rc, kw, k)
                uid, ulen, upos, end_ok = _map_hit(
                    {"us": shared["us"], "meta": m}, km_pos_c, jnp
                )
                hit = active & in_range & (mt > 0) & end_ok
                o_uid = jnp.where(hit, uid, o_uid)
                o_ulen = jnp.where(hit, ulen, o_ulen)
                o_pos = jnp.where(hit, upos, o_pos)
                o_mt = jnp.where(hit, mt, o_mt)
                found = found | hit
                active = active & (~hit)
            return found, o_uid, o_ulen, o_pos, o_mt

        dyn_bound = jnp.minimum(
            jnp.max(jnp.where(use_skew, jnp.zeros_like(n_occs), n_occs)), probe_bound
        ).astype(jnp.int32)
        state = jax.lax.fori_loop(0, dyn_bound, probe_body, state)
        _found, o_uid, o_ulen, o_pos, o_mt = state
        out = dict(unitig_id=o_uid, unitig_len=o_ulen, pos=o_pos, mt=o_mt)

        # skew path: resolved by the OWNER shard only (skew arrays are
        # replicated, but the psum merge adds — non-owners must emit
        # zeros). skew_resolve handles every skew layout (cuckoo inline,
        # direct-mapped bounded, MPHF) — the single source of truth
        # shared with sshash_k2u.
        if any(kk in shared for kk in ("skew_inline", "skew_prefix2", "skew_mphf")):
            from ..kphf.sshash import skew_resolve

            canon = jnp.minimum(fw, rc)
            st = (
                out["unitig_id"],
                out["unitig_len"],
                out["pos"],
                out["mt"],
                zero.astype(jnp.uint64),
                zero,
            )
            uid, ulen, upos, mt, _, _ = skew_resolve(
                shared, fw, rc, canon, mine & use_skew, st, jnp
            )
            out = dict(unitig_id=uid, unitig_len=ulen, pos=upos, mt=mt)

        # exactly one shard owns each query's bucket -> one-hot psum merge
        merged = {
            kk: jax.lax.psum(v.astype(jnp.int64) if v.dtype == jnp.uint8 else v, bucket_axis)
            for kk, v in out.items()
        }
        merged["mt"] = merged["mt"].astype(jnp.uint8)
        return merged

    smapped = shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(bucket_axis), P(data_axis)),
        out_specs=P(data_axis),
    )

    # pass the device pytrees as jit ARGUMENTS: closing over them lowers
    # the whole sharded index as captured constants (7.6GB graphs at 50Mbp)
    query_impl = jax.jit(lambda sh, stk, kms: smapped(sh, stk, kms))

    def query(kms):
        return query_impl(shared, stacked, kms)

    return query


def make_alltoall_sharded_query(ss, mesh, bucket_axis: str = "bucket", cap_factor: float = 2.0):
    """Minimizer-bucket-sharded SSHash k2u with ALL_TO_ALL query routing.

    The broadcast+psum variant above makes every shard scan every query
    (compute = N x S). Here each query is ROUTED to the single shard that
    owns its bucket (MoE-style dispatch): per-shard send buffers of
    capacity ``cap = cap_factor * N / S**2`` per destination, one
    all_to_all out, local resolution (~N/S queries per shard), one
    all_to_all back. Total compute stays N; the collectives ride ICI.

    Queries are sharded over ``bucket_axis`` (1-D mesh). Returns a jitted
    fn kms[N] -> k2u dict + ``routed_ok`` (False where a destination's
    capacity overflowed — caller re-queries those lanes via the replicated
    path; with cap_factor 2 this needs adversarial skew to happen).
    """
    import jax
    import jax.numpy as jnp
    from jax.sharding import NamedSharding, PartitionSpec as P

    from ..containers.unitig_set import us_get_kmer
    from ..kmer import canonical_minimizer_batch, revcomp, word_equivalency
    from ..kphf.boophf32 import fold_hash32
    from ..kphf.sshash import _map_hit, mphf_lookup

    S = mesh.shape[bucket_axis]
    shared, stacked = shard_sshash_buckets(ss, S)
    m = shared["meta"]
    k, w = m.k, m.w
    probe_bound = m.probe_bound
    n_min = len(ss.occs_prefix_sum) - 1
    bounds = np.linspace(0, n_min, S + 1).astype(np.int64)
    bounds_d = bounds

    shared = jax.device_put(shared, NamedSharding(mesh, P()))
    stacked = jax.device_put(stacked, NamedSharding(mesh, P(bucket_axis)))

    SENTINEL = np.uint64(0xFFFFFFFFFFFFFFFF)

    def _resolve_local(stk, kms, slot_real):
        """Full local k2u for queries whose bucket this shard owns."""
        prefix = stk["prefix"][0]
        posarr = stk["pos"][0]
        lo = stk["lo"][0, 0]
        hi = stk["hi"][0, 0]
        fw = kms
        rc = revcomp(fw, k)
        mm, offset, _isfw, _canon = canonical_minimizer_batch(
            jnp, fw, k, w, m.seed, hash32=m.hash32
        )
        offset = offset.astype(jnp.int64)
        if m.direct_t:
            h = (fold_hash32(mm) & np.uint32(m.direct_t - 1)).astype(jnp.int64)
        else:
            h = mphf_lookup(shared["mphf"], mm, jnp).astype(jnp.int64)
        mine = slot_real & (h >= lo) & (h < hi)
        hl = jnp.clip(h - lo, 0, prefix.shape[0] - 2)
        ps = prefix[hl]
        pe = prefix[hl + 1]
        n_occs = jnp.where(mine, pe - ps, 0)
        use_skew = (n_occs > m.skew_param) if m.skew_param >= 0 else jnp.zeros_like(mine)
        last_km_start = shared["us"]["meta"].total_len - k
        rc_offset = k - offset - w
        zero = ps * 0
        state = (mine != mine, zero, zero, zero, zero.astype(jnp.uint8))

        def probe_body(j, state):
            found, o_uid, o_ulen, o_pos, o_mt = state
            active = (~found) & (j < n_occs) & (~use_skew)
            mm_pos = posarr[jnp.clip(ps + j, 0, posarr.shape[0] - 1)]
            for cand_off in (offset, rc_offset):
                km_pos = mm_pos - cand_off
                in_range = (mm_pos >= cand_off) & (km_pos <= last_km_start)
                km_pos_c = jnp.clip(km_pos, 0, max(last_km_start, 0))
                kw = us_get_kmer(shared["us"], km_pos_c, jnp)
                mt = word_equivalency(fw, rc, kw, k)
                uid, ulen, upos, end_ok = _map_hit(
                    {"us": shared["us"], "meta": m}, km_pos_c, jnp
                )
                hit = active & in_range & (mt > 0) & end_ok
                o_uid = jnp.where(hit, uid, o_uid)
                o_ulen = jnp.where(hit, ulen, o_ulen)
                o_pos = jnp.where(hit, upos, o_pos)
                o_mt = jnp.where(hit, mt, o_mt)
                found = found | hit
                active = active & (~hit)
            return found, o_uid, o_ulen, o_pos, o_mt

        dyn_bound = jnp.minimum(
            jnp.max(jnp.where(use_skew, jnp.zeros_like(n_occs), n_occs)), probe_bound
        ).astype(jnp.int32)
        state = jax.lax.fori_loop(0, dyn_bound, probe_body, state)
        _found, o_uid, o_ulen, o_pos, o_mt = state
        out = dict(unitig_id=o_uid, unitig_len=o_ulen, pos=o_pos, mt=o_mt)

        # skew lanes: same shared resolver as sshash_k2u (all skew layouts)
        if any(kk in shared for kk in ("skew_inline", "skew_prefix2", "skew_mphf")):
            from ..kphf.sshash import skew_resolve

            canon = jnp.minimum(fw, rc)
            st = (
                out["unitig_id"],
                out["unitig_len"],
                out["pos"],
                out["mt"],
                out["pos"].astype(jnp.uint64),
                out["pos"],
            )
            uid, ulen, upos, mt, _, _ = skew_resolve(
                shared, fw, rc, canon, mine & use_skew, st, jnp
            )
            out = dict(unitig_id=uid, unitig_len=ulen, pos=upos, mt=mt)
        return out

    def shard_fn(shared_, stk, kms_local):
        n_local = kms_local.shape[0]
        cap = min(n_local, max(32, int(cap_factor * n_local / S)))
        fw = kms_local
        rc = revcomp(fw, k)
        mm, _off, _isfw, _canon = canonical_minimizer_batch(
            jnp, fw, k, w, m.seed, hash32=m.hash32
        )
        if m.direct_t:
            h = (fold_hash32(mm) & np.uint32(m.direct_t - 1)).astype(jnp.int64)
        else:
            h = mphf_lookup(shared["mphf"], mm, jnp).astype(jnp.int64)
        dest = jnp.clip(
            jnp.searchsorted(jnp.asarray(bounds_d[1:-1]), h, side="right"), 0, S - 1
        )
        # slot within my send-buffer row for dest d: rank among my queries
        # with the same destination
        onehot = (dest[:, None] == jnp.arange(S)[None, :]).astype(jnp.int32)
        pos_in_dest = jnp.cumsum(onehot, axis=0) - 1  # [n, S]
        slot = jnp.take_along_axis(pos_in_dest, dest[:, None], axis=1)[:, 0]
        ok = slot < cap
        send = jnp.full((S, cap), SENTINEL, dtype=jnp.uint64)
        send = send.at[dest, slot].set(kms_local, mode="drop")
        # all_to_all: recv[s] = what shard s sent me
        recv = jax.lax.all_to_all(
            send[None], bucket_axis, split_axis=1, concat_axis=1, tiled=False
        )[0]
        kms_in = recv.reshape(S * cap)
        real = kms_in != SENTINEL
        r = _resolve_local(stk, jnp.where(real, kms_in, jnp.uint64(0)), real)
        # pack results and route back
        packed = jnp.stack(
            [
                r["unitig_id"],
                r["unitig_len"],
                r["pos"],
                r["mt"].astype(jnp.int64),
            ],
            axis=-1,
        ).reshape(S, cap, 4)
        back = jax.lax.all_to_all(
            packed[None], bucket_axis, split_axis=1, concat_axis=1, tiled=False
        )[0]
        # my query i's result: back[dest_i, slot_i]
        sl = jnp.clip(slot, 0, cap - 1)
        mine_back = back[dest, sl]  # [n, 4]
        ok_i = ok
        return {
            "unitig_id": jnp.where(ok_i, mine_back[:, 0], 0),
            "unitig_len": jnp.where(ok_i, mine_back[:, 1], 0),
            "pos": jnp.where(ok_i, mine_back[:, 2], 0),
            "mt": jnp.where(ok_i, mine_back[:, 3], 0).astype(jnp.uint8),
            "routed_ok": ok_i,
        }

    smapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(bucket_axis), P(bucket_axis)),
        out_specs=P(bucket_axis),
    )

    # pass the device pytrees as jit ARGUMENTS: closing over them lowers
    # the whole sharded index as captured constants (7.6GB graphs at 50Mbp)
    query_impl = jax.jit(lambda sh, stk, kms: smapped(sh, stk, kms))

    def query(kms):
        return query_impl(shared, stacked, kms)

    return query


# ---------------------------------------------------------------------------
# FUSED sharded full query (round 2): the same inline fused-row kernel the
# single-chip bench runs, sharded by minimizer-hash bucket range, with a
# sharded occurrence table so the FULL get_ref_pos (projection incl. the
# compacted heavy phase) exists multi-chip. This is the >HBM design: the two
# big arrays (fused inline rows, ctable pair rows) are placed per-device;
# only the small structures (unitig seq, skew table, metadata) replicate.
# ---------------------------------------------------------------------------


def shard_fused_arrays(index, n_shards: int, pos_kind: str = "inline2"):
    """Host-side partition of the FUSED device layout into bucket shards.

    Returns (shared, stacked):
      shared  — replicated pytree: k2u side arrays (us, skew_inline, meta)
                + u2pos meta/offsets + top-level meta
      stacked — leading axis ``n_shards``: per-shard flat2 prefix slices
                (rebased), inline fused-row slices, ctable pair-row slices,
                and the (bucket, ctable) range bounds.

    Each shard owns minimizer-hash range [blo, bhi) of the direct bucket
    table and pair-row range [clo, chi) of the occurrence ctable.
    """
    from ..pytree import meta as make_meta

    base = index.device_arrays(fused=True, pos_kind=pos_kind)
    k2u = base["k2u"]
    assert k2u["meta"].direct_t and "flat2" in k2u.get("prefix", {}), (
        "fused sharding requires engine='direct' with flat2 prefix rows"
    )
    T = k2u["meta"].direct_t
    prefix = index.k2u.occs_prefix_sum.astype(np.int64)
    bounds = np.linspace(0, T, n_shards + 1).astype(np.int64)
    flat2 = k2u["prefix"]["flat2"]
    inline = k2u["pos"]["inline"]
    row_lo = prefix[bounds[:-1]]
    row_hi = prefix[bounds[1:]]
    max_T = int((bounds[1:] - bounds[:-1]).max())
    max_rows = max(1, int((row_hi - row_lo).max()))
    f2 = np.zeros((n_shards, max_T, 2), dtype=flat2.dtype)
    rows = np.zeros((n_shards, max_rows, inline.shape[1]), dtype=inline.dtype)
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        f2[s, : hi - lo] = flat2[lo:hi] - flat2.dtype.type(row_lo[s])
        rows[s, : row_hi[s] - row_lo[s]] = inline[row_lo[s] : row_hi[s]]

    ct2 = base["u2pos"]["ctable2"]
    n_ct = ct2.shape[0]
    cbounds = np.linspace(0, n_ct, n_shards + 1).astype(np.int64)
    max_ct = max(1, int((cbounds[1:] - cbounds[:-1]).max()))
    ct = np.zeros((n_shards, max_ct, ct2.shape[1]), dtype=ct2.dtype)
    for s in range(n_shards):
        ct[s, : cbounds[s + 1] - cbounds[s]] = ct2[cbounds[s] : cbounds[s + 1]]

    stacked = {
        "flat2": f2,
        "inline": rows,
        "ctable2": ct,
        "blo": bounds[:-1][:, None],
        "bhi": bounds[1:][:, None],
        "clo": cbounds[:-1][:, None],
        "chi": cbounds[1:][:, None],
    }
    shared = {
        "k2u": {
            k: v for k, v in k2u.items() if k not in ("prefix", "pos")
        },
        "u2pos": {
            k: v
            for k, v in base["u2pos"].items()
            if k not in ("ctable", "ctable2")
        },
        "meta": base["meta"],
        # static: the LOCAL padded row-count rides in a fresh pos meta
        "pos_meta": make_meta(length=max_rows),
    }
    return shared, stacked


def _psum_i(v, axis, xp):
    """Exact one-hot psum for any dtype (bitcast u64 through i64)."""
    import jax

    if v.dtype == xp.uint64:
        s = jax.lax.psum(jax.lax.bitcast_convert_type(v, xp.int64), axis)
        return jax.lax.bitcast_convert_type(s, xp.uint64)
    if v.dtype == xp.bool_:
        return jax.lax.psum(v.astype(xp.int32), axis) > 0
    if v.dtype == xp.uint8:
        return jax.lax.psum(v.astype(xp.int32), axis).astype(xp.uint8)
    return jax.lax.psum(v, axis)


_K2U_SHARD_FIELDS = (
    "unitig_id",
    "unitig_len",
    "pos",
    "mt",
    "occ_word",
    "occ_cnt",
    "occ_start",
    "occ_word2",
    "use_skew",
    "unresolved",
)


def _merge_k2u(r, bucket_axis, xp):
    """One-hot psum merge of per-shard k2u outputs (exactly one bucket
    shard reports nonzero fields per lane)."""
    return {
        kk: _psum_i(r[kk], bucket_axis, xp)
        for kk in _K2U_SHARD_FIELDS
        if kk in r
    }


def _proj_padded_sharded_occ(ct_local, clo, chi, r, xp, *, u2meta_only, k, mo, bucket_axis):
    """Sharded analog of get_ref_pos_padded's projection: each shard
    decodes the (overlapping pair-row) ctable words IT owns; a one-hot
    psum reassembles the padded occurrence block."""
    import jax  # noqa: F401  (psum via _psum_i)

    from .. import MATCH_IDENTITY
    from ..index.unitig_table import decode_words

    hit = r["mt"] > 0
    start = r["occ_start"]
    cnt = xp.where(hit, r["occ_cnt"], xp.zeros_like(r["occ_cnt"]))
    n_pairs = (mo + 1) // 2
    jj = xp.arange(n_pairs, dtype=start.dtype) * 2
    g = start[:, None] + jj[None, :]
    own = (g >= clo) & (g < chi) & hit[:, None]
    li = xp.clip(g - clo, 0, ct_local.shape[0] - 1)
    r32 = ct_local[li]  # [M, n_pairs, 4] u32
    lo32 = r32[..., 0::2].astype(xp.uint64)
    hi32 = r32[..., 1::2].astype(xp.uint64)
    words = (lo32 | (hi32 << np.uint64(32))).reshape(r32.shape[0], 2 * n_pairs)[
        :, :mo
    ]
    own_w = xp.repeat(own, 2, axis=1)[:, :mo]
    ref_id, occ_pos, occ_o = decode_words(u2meta_only, words, xp)
    kpos = r["pos"][:, None]
    ulen = r["unitig_len"][:, None]
    ref_pos = xp.where(occ_o == 1, kpos + occ_pos, occ_pos + (ulen - kpos) - k)
    o_match = (r["mt"] == MATCH_IDENTITY).astype(xp.int32)[:, None]
    orient = xp.where(occ_o == 1, o_match, 1 - o_match)
    zero = xp.zeros_like(ref_id)
    return {
        "ref_id": _psum_i(xp.where(own_w, ref_id, zero), bucket_axis, xp),
        "ref_pos": _psum_i(xp.where(own_w, ref_pos, zero), bucket_axis, xp),
        "orient": _psum_i(
            xp.where(own_w, orient, xp.zeros_like(orient)), bucket_axis, xp
        ),
        "valid": xp.arange(mo, dtype=cnt.dtype)[None, :] < cnt[:, None],
        "n_occs": cnt,
    }


def make_fused_sharded_query(
    index,
    mesh,
    m2: int,
    max_occs: int | None = None,
    probe_limit: int | None = 2,
    pos_kind: str = "inline2",
    data_axis: str = "data",
    bucket_axis: str = "bucket",
):
    """Bucket-sharded FULL get_ref_pos over the fused inline layout.

    The per-shard kernel is the SAME code path the single-chip bench runs
    (sshash_k2u fused rows + _project_fused + scatter-free compaction +
    padded heavy phase): sharding adds only the n_occs ownership mask and
    three one-hot psums (main k2u fields, phase-2 k2u fields, phase-2
    occurrence projections). Returns a jitted fn kms[N] -> the same
    merge=False dict as modindex.get_ref_pos_compact (main results exact
    for non-overflow lanes; phase2 block + lane map for the rest), with
    lane indices LOCAL to each data shard.

    This convenience wrapper partitions a host-resident index; the >HBM
    path loads shards per-device from a sharded checkpoint instead
    (io/sharded_ckpt.make_fused_sharded_query_from_ckpt) and shares
    build_fused_sharded_query below.
    """
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_shards = mesh.shape[bucket_axis]
    shared, stacked = shard_fused_arrays(index, n_shards, pos_kind=pos_kind)
    if max_occs is None:
        max_occs = max(1, index.max_occs())
    shared_dev = jax.device_put(
        {kk: v for kk, v in shared.items() if kk != "pos_meta"},
        NamedSharding(mesh, P()),
    )
    stacked_dev = jax.device_put(stacked, NamedSharding(mesh, P(bucket_axis)))
    return build_fused_sharded_query(
        shared,
        shared_dev,
        stacked_dev,
        mesh,
        m2=m2,
        max_occs=int(max_occs),
        probe_limit=probe_limit,
        data_axis=data_axis,
        bucket_axis=bucket_axis,
    )


def build_fused_sharded_query(
    shared_host,
    shared_dev,
    stacked_dev,
    mesh,
    m2: int,
    max_occs: int,
    probe_limit: int | None = 2,
    data_axis: str = "data",
    bucket_axis: str = "bucket",
):
    """Kernel builder behind make_fused_sharded_query: takes already-placed
    device pytrees (``shared_dev`` replicated, ``stacked_dev`` sharded on
    ``bucket_axis``) plus the host pytree for its static Meta nodes."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..kphf.sshash import sshash_k2u
    from ..index.twophase import _project_fused
    from ..ops.compact import flagged_lanes

    mo, plim, M2 = int(max_occs), probe_limit, int(m2)
    k = shared_host["meta"].k
    pos_meta = shared_host["pos_meta"]
    u2meta_only = {"meta": shared_host["u2pos"]["meta"]}
    proj_arrays_meta = {"u2pos": u2meta_only, "meta": shared_host["meta"]}
    shared, stacked = shared_dev, stacked_dev

    def _merge(r):
        return _merge_k2u(r, bucket_axis, jnp)

    def _proj_padded_sharded(ct_local, clo, chi, r, xp):
        return _proj_padded_sharded_occ(
            ct_local, clo, chi, r, xp,
            u2meta_only=u2meta_only, k=k, mo=mo, bucket_axis=bucket_axis,
        )

    def shard_fn(sh, stk, kms):
        d_local = dict(sh["k2u"])
        d_local["prefix"] = {"flat2": stk["flat2"][0]}
        d_local["pos"] = {"inline": stk["inline"][0], "meta": pos_meta}
        blo, bhi = stk["blo"][0, 0], stk["bhi"][0, 0]
        clo, chi = stk["clo"][0, 0], stk["chi"][0, 0]
        ct_local = stk["ctable2"][0]

        # ---- main phase (shallow probes, fused projection)
        r = sshash_k2u(
            d_local, kms, jnp, mode="main", probe_limit=plim, bucket_range=(blo, bhi)
        )
        rm = _merge(r)
        p = _project_fused(proj_arrays_meta, rm, jnp)
        overflow = p["overflow"] | rm["unresolved"]

        # ---- scatter-free lane compaction (replicated compute: overflow is
        # identical on every bucket shard after the psum)
        lanes, n_ovf = flagged_lanes(overflow, M2, jnp)
        fw2 = kms[lanes]

        # ---- compacted heavy phase: full-depth probes + skew + sharded
        # occurrence projection
        r2 = sshash_k2u(d_local, fw2, jnp, mode="full", bucket_range=(blo, bhi))
        r2m = _merge(r2)
        p2 = _proj_padded_sharded(ct_local, clo, chi, r2m, jnp)
        out2 = {
            **{kk: r2m[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
            **p2,
        }
        slot_real = jnp.arange(M2) < jnp.minimum(n_ovf, M2)
        return {
            "main": {
                **{kk: rm[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
                **p,
            },
            "overflow": overflow,
            # per-DATA-shard pieces: lane indices are local to the shard's
            # query slice; the leading axis concatenates one M2-block per
            # data shard
            "lanes": lanes,
            "slot_real": slot_real,
            "phase2": out2,
            "n_ovf": n_ovf[None],
            "over_budget": (n_ovf > M2)[None],
        }

    smapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(bucket_axis), P(data_axis)),
        out_specs=P(data_axis),
    )

    # pass the device pytrees as jit ARGUMENTS: closing over them lowers
    # the whole sharded index as captured constants (7.6GB graphs at 50Mbp)
    query_impl = jax.jit(lambda sh, stk, kms: smapped(sh, stk, kms))

    def query(kms):
        return query_impl(shared, stacked, kms)

    return query


def shard_mono_arrays(index, n_shards: int):
    """Host-side partition of a mono/mono2 KCDict index into bucket shards.

    The single-hash table splits into ``n_shards`` contiguous bucket
    ranges (T is a power of two, so the splits are equal); the side table
    (displaced keys, ~0.2-3% of keys) and the offsets prefix replicate;
    the occurrence ctable splits into contiguous pair-row ranges exactly
    like shard_fused_arrays. Returns (shared, stacked).
    """
    base = index.device_arrays(fused=True)
    k2u = base["k2u"]
    m = k2u["meta"]
    assert m.kind == "kcdict" and getattr(m, "scheme", "") in ("mono", "mono2"), (
        "mono sharding requires a mono/mono2 KCDict k2u"
    )
    T = m.t
    nrows = k2u["table"].shape[0]
    row_factor = nrows // T  # 2 for the split slot-row layout, else 1
    assert T % n_shards == 0, "bucket count must divide the shard count"
    bt = T // n_shards
    table = np.ascontiguousarray(
        np.asarray(k2u["table"]).reshape(
            n_shards, bt * row_factor, k2u["table"].shape[1]
        )
    )
    bounds = (np.arange(n_shards + 1) * bt).astype(np.int64)

    ct2 = base["u2pos"]["ctable2"]
    n_ct = ct2.shape[0]
    cbounds = np.linspace(0, n_ct, n_shards + 1).astype(np.int64)
    max_ct = max(1, int((cbounds[1:] - cbounds[:-1]).max()))
    ct = np.zeros((n_shards, max_ct, ct2.shape[1]), dtype=ct2.dtype)
    for s in range(n_shards):
        ct[s, : cbounds[s + 1] - cbounds[s]] = ct2[cbounds[s] : cbounds[s + 1]]

    stacked = {
        "table": table,
        "ctable2": ct,
        "blo": bounds[:-1][:, None],
        "bhi": bounds[1:][:, None],
        "clo": cbounds[:-1][:, None],
        "chi": cbounds[1:][:, None],
    }
    shared = {
        "k2u": {kk: v for kk, v in k2u.items() if kk != "table"},
        "u2pos": {
            kk: v
            for kk, v in base["u2pos"].items()
            if kk not in ("ctable", "ctable2")
        },
        "meta": base["meta"],
    }
    return shared, stacked


def make_mono_sharded_query(
    index,
    mesh,
    m2: int,
    max_occs: int | None = None,
    data_axis: str = "data",
    bucket_axis: str = "bucket",
):
    """Bucket-sharded FULL get_ref_pos over the mono/mono2 single-hash
    engine — the same kernel the single-chip bench default runs
    (kcdict_k2u one-gather probe + fused inline-occurrence projection +
    scatter-free compaction + padded heavy phase), plus the ownership
    mask and one-hot psums. Returns a jitted fn kms[N] -> the
    merge=False dict of modindex.get_ref_pos_compact (lane indices local
    to each data shard)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_shards = mesh.shape[bucket_axis]
    shared, stacked = shard_mono_arrays(index, n_shards)
    if max_occs is None:
        max_occs = max(1, index.max_occs())
    shared_dev = jax.device_put(shared, NamedSharding(mesh, P()))
    stacked_dev = jax.device_put(stacked, NamedSharding(mesh, P(bucket_axis)))
    return build_mono_sharded_query(
        shared,
        shared_dev,
        stacked_dev,
        mesh,
        m2=m2,
        max_occs=int(max_occs),
        data_axis=data_axis,
        bucket_axis=bucket_axis,
    )


def build_mono_sharded_query(
    shared_host,
    shared_dev,
    stacked_dev,
    mesh,
    m2: int,
    max_occs: int,
    data_axis: str = "data",
    bucket_axis: str = "bucket",
):
    """Kernel builder behind make_mono_sharded_query (split out so a
    sharded-checkpoint loader can feed per-device-placed pytrees)."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..kphf.kcdict import kcdict_k2u
    from ..index.twophase import _project_fused
    from ..ops.compact import flagged_lanes

    mo, M2 = int(max_occs), int(m2)
    k = shared_host["meta"].k
    u2meta_only = {"meta": shared_host["u2pos"]["meta"]}
    proj_arrays_meta = {"u2pos": u2meta_only, "meta": shared_host["meta"]}
    shared, stacked = shared_dev, stacked_dev

    def shard_fn(sh, stk, kms):
        d_local = dict(sh["k2u"])
        d_local["table"] = stk["table"][0]
        blo, bhi = stk["blo"][0, 0], stk["bhi"][0, 0]
        clo, chi = stk["clo"][0, 0], stk["chi"][0, 0]
        ct_local = stk["ctable2"][0]

        # ---- main phase: ONE owned-range gather per lane, fused projection
        r = kcdict_k2u(d_local, kms, jnp, mode="main", bucket_range=(blo, bhi))
        rm = _merge_k2u(r, bucket_axis, jnp)
        p = _project_fused(proj_arrays_meta, rm, jnp)
        overflow = p["overflow"] | rm["unresolved"]

        # ---- scatter-free lane compaction (identical on every bucket shard)
        lanes, n_ovf = flagged_lanes(overflow, M2, jnp)
        fw2 = kms[lanes]

        # ---- compacted heavy phase: full probe (side table gated to the
        # h1 owner) + sharded padded occurrence projection
        r2 = kcdict_k2u(d_local, fw2, jnp, mode="full", bucket_range=(blo, bhi))
        r2m = _merge_k2u(r2, bucket_axis, jnp)
        hit2 = r2m["mt"] > 0
        uid2 = jnp.where(hit2, r2m["unitig_id"], jnp.zeros_like(r2m["unitig_id"]))
        start2 = sh["u2pos"]["offsets"][uid2]
        p2 = _proj_padded_sharded_occ(
            ct_local, clo, chi, {**r2m, "occ_start": start2}, jnp,
            u2meta_only=u2meta_only, k=k, mo=mo, bucket_axis=bucket_axis,
        )
        out2 = {
            **{kk: r2m[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
            **p2,
        }
        slot_real = jnp.arange(M2) < jnp.minimum(n_ovf, M2)
        return {
            "main": {
                **{kk: rm[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
                **p,
            },
            "overflow": overflow,
            "lanes": lanes,
            "slot_real": slot_real,
            "phase2": out2,
            "n_ovf": n_ovf[None],
            "over_budget": (n_ovf > M2)[None],
        }

    smapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(bucket_axis), P(data_axis)),
        out_specs=P(data_axis),
    )

    # pass the device pytrees as jit ARGUMENTS: closing over them lowers
    # the whole sharded index as captured constants (7.6GB graphs at 50Mbp)
    query_impl = jax.jit(lambda sh, stk, kms: smapped(sh, stk, kms))

    def query(kms):
        return query_impl(shared, stacked, kms)

    return query


def shard_compact_arrays(
    index, n_shards: int, bucket_inline: bool = False, useqrec: bool = False
):
    """Host-side partition of the CAPACITY layout (direct engine, packed
    IntVector positions, flat2 bucket bounds — the multi-Gbp-per-chip
    tier) into bucket shards.

    Replicated: the unitig set (paired words — it is the verification
    path), the skew structures, and the u2pos offsets prefix. Sharded
    over contiguous ranges: the flat2 bucket-bounds pairs (rebased to the
    shard's first position entry), the packed positions (re-packed per
    shard so bit offsets start at 0), and the u2pos ctable2 pair rows.
    Returns (shared, stacked) like shard_fused_arrays.

    Capacity-layout options (the single-device bpos + useqrec config,
    made deployable past one device):

    - ``bucket_inline``: also shard the direct-addressed ``bpos``
      u32[T, 4] table by the same bucket ranges — the sharded MAIN
      probe then reads bounds + first-3 candidate positions in ONE
      gather (positions are global useq coords; no rebasing — the
      unitig set is replicated). Requires ``total_len < 2^31``.
    - ``useqrec``: REPLICATE the 56B per-32-base window records
      (build_useqrec) — they are keyed by useq word index, i.e. they
      are part of the verification path, which this layout replicates
      by design (like the paired useq words). The sharded main probe
      then resolves validation + rank + projection in the same row
      gather; only cnt>2 / skew / unresolved lanes enter phase 2.
    """
    from ..bits.intvector import IntVector
    from ..pytree import meta as make_meta

    ss = index.k2u
    k2u = ss.device_arrays(
        prefix_kind="flat32", pos_kind="packed", bucket_inline=bucket_inline
    )
    assert k2u["meta"].direct_t and "flat2" in k2u.get("prefix", {}), (
        "compact sharding requires engine='direct' (flat2 bucket bounds)"
    )
    T = k2u["meta"].direct_t
    prefix = ss.occs_prefix_sum.astype(np.int64)
    bounds = np.linspace(0, T, n_shards + 1).astype(np.int64)
    flat2 = k2u["prefix"]["flat2"]
    row_lo, row_hi = prefix[bounds[:-1]], prefix[bounds[1:]]
    max_T = int((bounds[1:] - bounds[:-1]).max())
    max_rows = max(1, int((row_hi - row_lo).max()))
    f2 = np.zeros((n_shards, max_T, 2), dtype=flat2.dtype)
    pos_vals = ss.pos.to_array()
    width = ss.pos.width
    pw = None
    for s in range(n_shards):
        lo, hi = bounds[s], bounds[s + 1]
        f2[s, : hi - lo] = flat2[lo:hi] - flat2.dtype.type(row_lo[s])
        iv = IntVector.from_array(
            pos_vals[row_lo[s] : row_hi[s]], width=width
        )
        if pw is None:
            pw = np.zeros(
                (n_shards, max(2, (max_rows * width + 63) // 64 + 1)),
                dtype=np.uint64,
            )
        pw[s, : len(iv.words)] = iv.words

    u2 = index.u2pos.device_arrays()
    ct2 = u2["ctable2"]
    n_ct = ct2.shape[0]
    cbounds = np.linspace(0, n_ct, n_shards + 1).astype(np.int64)
    max_ct = max(1, int((cbounds[1:] - cbounds[:-1]).max()))
    ct = np.zeros((n_shards, max_ct, ct2.shape[1]), dtype=ct2.dtype)
    for s in range(n_shards):
        ct[s, : cbounds[s + 1] - cbounds[s]] = ct2[cbounds[s] : cbounds[s + 1]]

    stacked = {
        "flat2": f2,
        "pos_words": pw,
        "ctable2": ct,
        "blo": bounds[:-1][:, None],
        "bhi": bounds[1:][:, None],
        "clo": cbounds[:-1][:, None],
        "chi": cbounds[1:][:, None],
    }
    shared = {
        "k2u": {
            kk: v
            for kk, v in k2u.items()
            if kk not in ("prefix", "pos", "bpos")
        },
        "u2pos": {"offsets": u2["offsets"], "meta": u2["meta"]},
        "meta": make_meta(k=index.k, index_type=index.index_type),
        "pos_meta": make_meta(width=width, length=max_rows),
    }
    if bucket_inline:
        bp = np.zeros((n_shards, max_T, 4), dtype=np.uint32)
        for s in range(n_shards):
            lo, hi = bounds[s], bounds[s + 1]
            bp[s, : hi - lo] = k2u["bpos"][lo:hi]
        stacked["bpos"] = bp
    if useqrec:
        from ..index.modindex import build_useqrec

        shared["k2u"]["us"] = dict(shared["k2u"]["us"])
        shared["k2u"]["us"]["useqrec"] = build_useqrec(
            index.u2pos, ss.unitigs
        )
    return shared, stacked


def make_compact_sharded_query(
    index,
    mesh,
    m2: int,
    probe_limit: int | None = 3,
    defer_valid: bool = True,
    max_occs: int | None = None,
    bucket_inline: bool = False,
    useqrec: bool = False,
    data_axis: str = "data",
    bucket_axis: str = "bucket",
):
    """Bucket-sharded CAPACITY-tier full query: the direct-engine packed
    layout (grouped16/flat32 compact tier — multi-Gbp genomes) sharded
    over the ``bucket`` mesh axis, so references past one chip's HBM
    deploy across chips. The per-shard kernel is the same
    sshash_k2u(main, probe_limit, defer_valid) + offsets projection +
    scatter-free compaction + full-depth phase 2 that the single-chip
    capacity bench runs; sharding adds the bucket ownership mask and
    one-hot psums (k2u fields) plus per-pair-row ownership on the
    occurrence decode. Returns a jitted fn kms[N] -> the merge=False
    dict of modindex.get_ref_pos_compact (lane indices local to each
    data shard)."""
    import jax
    from jax.sharding import NamedSharding, PartitionSpec as P

    n_shards = mesh.shape[bucket_axis]
    shared, stacked = shard_compact_arrays(
        index, n_shards, bucket_inline=bucket_inline, useqrec=useqrec
    )
    if max_occs is None:
        max_occs = max(1, index.max_occs())
    shared_dev = jax.device_put(
        {kk: v for kk, v in shared.items() if kk != "pos_meta"},
        NamedSharding(mesh, P()),
    )
    stacked_dev = jax.device_put(stacked, NamedSharding(mesh, P(bucket_axis)))
    return build_compact_sharded_query(
        shared,
        shared_dev,
        stacked_dev,
        mesh,
        m2=m2,
        max_occs=int(max_occs),
        probe_limit=probe_limit,
        defer_valid=defer_valid,
        data_axis=data_axis,
        bucket_axis=bucket_axis,
    )


def build_compact_sharded_query(
    shared_host,
    shared_dev,
    stacked_dev,
    mesh,
    m2: int,
    max_occs: int,
    probe_limit: int | None = 3,
    defer_valid: bool = True,
    data_axis: str = "data",
    bucket_axis: str = "bucket",
):
    """Kernel builder behind make_compact_sharded_query: takes
    already-placed device pytrees (``shared_dev`` replicated,
    ``stacked_dev`` sharded on ``bucket_axis``) plus the host pytree for
    its static Meta nodes — the checkpoint loader enters here."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import PartitionSpec as P

    from ..kphf.sshash import sshash_k2u
    from ..ops.compact import flagged_lanes

    mo, plim, M2, dv = int(max_occs), probe_limit, int(m2), bool(defer_valid)
    k = shared_host["meta"].k
    pos_meta = shared_host["pos_meta"]
    u2meta_only = {"meta": shared_host["u2pos"]["meta"]}

    def _occ_fields(offsets, rm):
        hit = rm["mt"] > 0
        uid = jnp.where(hit, rm["unitig_id"], jnp.zeros_like(rm["unitig_id"]))
        start = offsets[uid]
        cnt = jnp.where(hit, offsets[uid + 1] - start, jnp.zeros_like(start))
        return {**rm, "occ_start": start, "occ_cnt": cnt}

    def shard_fn(sh, stk, kms):
        d_local = dict(sh["k2u"])
        d_local["prefix"] = {"flat2": stk["flat2"][0]}
        d_local["pos"] = {"words": stk["pos_words"][0], "meta": pos_meta}
        if "bpos" in stk:
            # round 5: sharded bucket-inline table — the main probe reads
            # the shard's local bpos rows (ONE gather: bounds + first-3
            # positions); phases below keep the flat2/packed arrays
            d_local["bpos"] = stk["bpos"][0]
        blo, bhi = stk["blo"][0, 0], stk["bhi"][0, 0]
        clo, chi = stk["clo"][0, 0], stk["chi"][0, 0]
        ct_local = stk["ctable2"][0]
        offsets = sh["u2pos"]["offsets"]

        # ---- main phase: shallow probe + small-width sharded projection
        r = sshash_k2u(
            d_local, kms, jnp, mode="main", probe_limit=plim,
            defer_valid=dv, bucket_range=(blo, bhi),
        )
        rm = _merge_k2u(r, bucket_axis, jnp)
        if "occ_cnt" in rm:
            # useqrec rows carried the projection inline (zero extra
            # gathers, no ctable involvement for cnt<=2 lanes) — same
            # fused path as the single-chip 8.1M config
            from ..index.twophase import _project_fused

            pf = _project_fused(
                {"u2pos": u2meta_only, "meta": shared_host["meta"]}, rm, jnp
            )
            overflow = pf["overflow"] | rm["unresolved"]
            p = {
                kk: pf[kk]
                for kk in ("ref_id", "ref_pos", "orient", "valid", "n_occs")
            }
        else:
            rm = _occ_fields(offsets, rm)
            overflow = rm["use_skew"] | rm["unresolved"] | (rm["occ_cnt"] > 2)
            p = _proj_padded_sharded_occ(
                ct_local, clo, chi, rm, jnp,
                u2meta_only=u2meta_only, k=k, mo=2, bucket_axis=bucket_axis,
            )
        p["valid"] = p["valid"] & (~overflow)[:, None]
        p["overflow"] = overflow

        # ---- compacted full-depth phase 2 (replicated lane choice)
        lanes, n_ovf = flagged_lanes(overflow, M2, jnp)
        r2 = sshash_k2u(
            d_local, kms[lanes], jnp, mode="full", bucket_range=(blo, bhi)
        )
        r2m = _occ_fields(offsets, _merge_k2u(r2, bucket_axis, jnp))
        p2 = _proj_padded_sharded_occ(
            ct_local, clo, chi, r2m, jnp,
            u2meta_only=u2meta_only, k=k, mo=mo, bucket_axis=bucket_axis,
        )
        out2 = {
            **{kk: r2m[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
            **p2,
        }
        slot_real = jnp.arange(M2) < jnp.minimum(n_ovf, M2)
        return {
            "main": {
                **{kk: rm[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
                **p,
            },
            "overflow": overflow,
            "lanes": lanes,
            "slot_real": slot_real,
            "phase2": out2,
            "n_ovf": n_ovf[None],
            "over_budget": (n_ovf > M2)[None],
        }

    smapped = jax.shard_map(
        shard_fn,
        mesh=mesh,
        in_specs=(P(), P(bucket_axis), P(data_axis)),
        out_specs=P(data_axis),
    )
    query_impl = jax.jit(lambda sh, stk, kms: smapped(sh, stk, kms))

    def query(kms):
        return query_impl(shared_dev, stacked_dev, kms)

    return query
