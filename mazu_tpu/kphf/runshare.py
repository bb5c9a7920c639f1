"""Run-sharing read query: the batched, on-device realization of the
reference's streaming k-mer cache (src/index/caching.rs), re-derived for
SIMD hardware.

Consecutive k-mers of a read usually share a minimizer bucket (window
density ~2/(w+1)); instead of per-k-mer bucket-row gathers, the batch is
segmented into runs of equal bucket id, rows are fetched once per run into
a compacted buffer (M row gathers, M ~= N/8 on reads), scattered to the
run-start lanes and FORWARD-FILLED with a log-depth associative scan
(elementwise — no gathers). Per-k-mer candidate verification then runs
fully elementwise on the filled rows. Exact: results equal sshash_k2u.

Requires the direct engine with the fixedcap layout. Heavy-bucket (skew)
lanes are flagged for the caller's overflow pass (two-phase driving), so
the main kernel issues only ~(B+1) * N/run_len row operations.
"""

from __future__ import annotations

import numpy as np

from ..kmer import canonical_minimizer_batch, revcomp, word_equivalency

U64 = np.uint64
U32 = np.uint32


def _forward_fill(xp, valid, data):
    """Forward-fill rows of ``data`` [N, C] from the last lane with
    valid=True at or before each position (log-depth associative scan)."""
    import jax
    import jax.numpy as jnp

    def combine(a, b):
        av, ad = a
        bv, bd = b
        v = av | bv
        d = jnp.where(bv[:, None], bd, ad)
        return v, d

    _, filled = jax.lax.associative_scan(combine, (valid, data), axis=0)
    return filled


def sshash_k2u_reads_runshare(d: dict, fw_words, new_read, xp, budget_div: int = 2):
    """Batched k2u over CONSECUTIVE read k-mers (direct engine, fixedcap).

    ``new_read``: bool[N], True where a new read begins (runs never span
    reads). Returns the sshash_k2u dict + ``use_skew`` (caller resolves
    flagged lanes via a full-path overflow pass) + ``run_overflow`` (True
    if the run budget was exceeded — caller falls back to the plain path;
    with budget_div=2 this can only happen on non-read-like inputs).
    """
    import jax.numpy as jnp

    from .boophf32 import fold_hash32

    m = d["meta"]
    assert m.direct_t and m.pos_kind in ("fixedcap", "inline")
    fixedcap = m.pos_kind == "fixedcap"
    k, w = m.k, m.w
    B = m.cap if fixedcap else m.probe_bound
    fw = xp.asarray(fw_words)
    N = fw.shape[0]
    M = max(64, N // budget_div)

    rc = revcomp(fw, k)
    mm, offset, _isfw, _canon = canonical_minimizer_batch(
        xp, fw, k, w, m.seed, hash32=m.hash32
    )
    offset = offset.astype(xp.int64)
    rc_offset = k - offset - w
    hc = (fold_hash32(mm) & np.uint32(m.direct_t - 1)).astype(xp.int64)

    # ---- run segmentation (bucket-level sharing)
    prev_hc = xp.concatenate([hc[:1] - 1, hc[:-1]])
    run_start = xp.asarray(new_read) | (hc != prev_hc)
    run_id = xp.cumsum(run_start.astype(xp.int32), dtype=xp.int32) - 1  # int32[N]
    n_runs = run_id[-1] + 1
    run_overflow = n_runs > M
    rid = xp.clip(run_id, 0, M - 1)

    # ---- compacted fetch: bucket id and lane index per run
    neg = xp.full((N,), -1, dtype=xp.int64)
    starts_h = xp.zeros((M,), dtype=xp.int64).at[rid].max(xp.where(run_start, hc, neg))
    rows_tbl = d["pos"]["inline"]
    K = rows_tbl.shape[1]
    n_rows = rows_tbl.shape[0]
    if fixedcap:
        base_addr = xp.clip(starts_h, 0, None) * B
        n_occs_m = xp.full((M,), B, dtype=xp.int32)
    else:
        pair = d["prefix"]["flat2"][xp.clip(starts_h, 0, None)]  # [M, 2]
        base_addr = pair[..., 0].astype(xp.int64)
        n_occs_m = (pair[..., 1] - pair[..., 0]).astype(xp.int32)
    fetched = []
    for j in range(B):
        fetched.append(rows_tbl[xp.clip(base_addr + j, 0, n_rows - 1)])
    fetched.append(n_occs_m[:, None].astype(rows_tbl.dtype))
    rows_m = xp.concatenate(fetched, axis=1)  # [M, B*K + 1]

    # ---- scatter rows to run-start lanes + forward fill
    starts_i = xp.zeros((M,), dtype=xp.int64).at[rid].max(
        xp.where(run_start, xp.arange(N, dtype=xp.int64), neg)
    )
    # unused run slots (beyond n_runs) must not scatter: route them to a
    # sacrificial row N that gets sliced off
    slot_active = xp.arange(M, dtype=xp.int32) < n_runs.astype(xp.int32)
    dest = xp.where(slot_active, xp.clip(starts_i, 0, N - 1), N)
    buf = (
        xp.zeros((N + 1, B * K + 1), dtype=rows_tbl.dtype).at[dest].set(rows_m)[:N]
    )
    filled = _forward_fill(xp, run_start, buf)

    # ---- per-k-mer verification (fully elementwise)
    n_occs_f = filled[:, B * K].astype(xp.int32)
    if fixedcap:
        use_skew = filled[:, 1] == np.uint32(0xFFFFFFFE)
    else:
        use_skew = n_occs_f > m.skew_param
    m2k = U64((1 << (2 * k)) - 1)
    found = xp.zeros((N,), dtype=bool)
    zero = xp.zeros((N,), dtype=xp.int64)
    out_uid, out_ulen, out_pos = zero, zero, zero
    out_mt = xp.zeros((N,), dtype=xp.uint8)
    fused = K >= 13
    out_ow = xp.zeros((N,), dtype=xp.uint64)
    out_oc = zero

    def w64(lo, hi):
        return lo.astype(xp.uint64) | (hi.astype(xp.uint64) << U64(32))

    for j in range(B):
        row = filled[:, j * K : (j + 1) * K]
        mm_pos = row[:, 0].astype(xp.int64)
        uid = row[:, 1].astype(xp.int64)
        start = row[:, 2].astype(xp.int64)
        end = row[:, 3].astype(xp.int64)
        q0 = w64(row[:, 4], row[:, 5])
        q1 = w64(row[:, 6], row[:, 7])
        q2 = w64(row[:, 8], row[:, 9])
        base = xp.clip(mm_pos - (k - w), 0, None)
        woff = ((base * 2) & 63).astype(xp.int64)
        active = (~found) & (~use_skew) & (j < n_occs_f)
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
                out_ow = xp.where(hit, w64(row[:, 10], row[:, 11]), out_ow)
                out_oc = xp.where(hit, row[:, 12].astype(xp.int64), out_oc)
            found = found | hit
            active = active & (~hit)

    out = {
        "unitig_id": out_uid,
        "unitig_len": out_ulen,
        "pos": out_pos,
        "mt": out_mt,
        "use_skew": use_skew,
        "run_overflow": run_overflow,
    }
    if fused:
        out["occ_word"] = out_ow
        out["occ_cnt"] = out_oc
    return out
