"""ModIndex: the modular K2U x U2Pos index and its batched query engine.

Re-design of reference src/index.rs (ModIndex, GetRefPos, projection math
at src/index.rs:193-216) arrays-first: one device pytree, one fused batched
query pipeline:

    k-mer words [N] -> k2u (dictionary probe) -> occurrence ranges
    -> padded occurrence decode -> projection -> MappedRefPos [N, max_occs]

Everything is static-shape and jit-compatible; ``max_occs`` pads the ragged
per-unitig occurrence lists (CSR-style streaming over huge occurrence lists
is provided by project_hits_csr for skewed references).
"""

from __future__ import annotations

import numpy as np

from .. import MATCH_IDENTITY
from ..pytree import meta
from .unitig_table import decode_occs


def build_uproj(u2pos, unitigs) -> np.ndarray:
    """Per-UNITIG projection record for the capacity tier: u64 rows
    ``[ustart, ulen, cnt | occ_start<<32, occ_word1, occ_word2]``
    (40 B — under the 56 B fast-gather threshold).

    One random row gather per resolved lane replaces the whole query
    tail: the unitig extent fetch (accum2), the offsets bounds pair, and
    the width-2 ctable fetch — and because the row carries the first TWO
    encoded occurrences, the main-phase projection becomes the
    zero-gather ``_project_fused`` path (cnt<=2 lanes, ~95+%, complete
    in the main phase; cnt>2 lanes reuse the inline occ_start in the
    type-A compacted phase). Ledger: ~4 random gathers/query removed on
    the packed/grouped16 tiers (docs/ROOFLINE.md round-4).

    Parity: carries exactly offsets/ctable content (reference projection
    src/index.rs:193-216) — results are bit-identical, tested."""
    if hasattr(u2pos.ctable, "to_array"):  # packed IntVector
        cwords = u2pos.ctable.to_array()
    else:
        cwords = np.asarray(u2pos.ctable)
    off = np.asarray(u2pos.offsets, dtype=np.int64)
    accum = np.asarray(unitigs.accum, dtype=np.int64)
    n = len(accum) - 1
    assert len(off) == n + 1, "offsets/unitig count mismatch"
    assert off[-1] < (1 << 32), "occ_start rides in 32 bits"
    cnt = off[1:] - off[:-1]
    hi = max(len(cwords) - 1, 0)
    first = np.asarray(cwords[np.clip(off[:-1], 0, hi)], dtype=np.uint64)
    second = np.asarray(
        cwords[np.clip(off[:-1] + 1, 0, hi)], dtype=np.uint64
    ) * (cnt >= 2)
    rows = np.empty((n, 5), dtype=np.uint64)
    rows[:, 0] = accum[:-1].astype(np.uint64)
    rows[:, 1] = (accum[1:] - accum[:-1]).astype(np.uint64)
    rows[:, 2] = cnt.astype(np.uint64) | (off[:-1].astype(np.uint64) << np.uint64(32))
    rows[:, 3] = first * (cnt >= 1)
    rows[:, 4] = second
    return rows


def build_useqrec(u2pos, unitigs) -> np.ndarray:
    """Per-32-BASE useq window record for the capacity tier (round 4):
    u64 rows ``[w_i, w_{i+1}, w_{i+2}, ustart | ulen<<40, uid | cnt<<32,
    occ_word1, occ_word2]`` (56 B — at the fast-gather row threshold),
    keyed by useq WORD index i (32 bases).

    ONE row gather per probe iteration then carries the whole 96-base
    candidate window AND everything the query tail needs for the unitig
    containing base 32i: the extent check (== the boundary-bv validity
    predicate, see probe_body_generic), the unitig id (no rank), and the
    projection record (no offsets/ctable gathers): the second window word
    and the record ride one row gather. A candidate whose k-mer sits
    past a unitig boundary relative to the row's unitig (or whose window
    spans one) fails the inline extent check, is flagged unresolved, and
    resolves in the caller's validating phase 2 — exactness unchanged.
    occ_start is NOT carried (56 B budget): cnt>2 (type-A) lanes
    re-gather their occurrence bounds in the compacted phase.

    Cost: 1.75 B/base of device memory — the ≤1 Gbp speed-at-capacity
    layout; the 3 Gbp tier keeps the lean words2+wb2 arrays.

    Parity: same projection content as the reference's occ table walk
    (src/index.rs:193-216); same validity predicate as
    src/kphf/pfhash.rs:253. Exactness-tested vs the padded oracle."""
    up = build_uproj(u2pos, unitigs)
    words = np.asarray(unitigs.useq.words, dtype=np.uint64)
    accum = np.asarray(unitigs.accum, dtype=np.int64)
    nw = len(words)
    base = np.arange(nw, dtype=np.int64) * 32
    uid = np.clip(
        np.searchsorted(accum, base, side="right") - 1, 0, len(accum) - 2
    ).astype(np.int64)
    ustart, ulen = up[uid, 0], up[uid, 1]
    assert int(ustart.max(initial=0)) < 1 << 40, "ustart rides in 40 bits"
    assert int(ulen.max(initial=0)) < 1 << 24, "ulen rides in 24 bits"
    assert len(accum) - 1 < 1 << 32, "uid rides in 32 bits"
    coc = up[uid, 2]  # cnt | occ_start<<32
    wp = np.concatenate([words, np.zeros(2, dtype=np.uint64)])
    rec = np.empty((nw, 7), dtype=np.uint64)
    rec[:, 0] = wp[:nw]
    rec[:, 1] = wp[1 : nw + 1]
    rec[:, 2] = wp[2 : nw + 2]
    rec[:, 3] = ustart | (ulen << np.uint64(40))
    rec[:, 4] = uid.astype(np.uint64) | ((coc & np.uint64(0xFFFFFFFF)) << np.uint64(32))
    rec[:, 5] = up[uid, 3]
    rec[:, 6] = up[uid, 4]
    return rec


def k2u_batch(d: dict, fw_words, xp, probe_start: int = 0):
    """Dispatch on the (static) k2u kind. ``probe_start`` (sshash only)
    skips candidate rows [0, probe_start) — see sshash_k2u's exactness
    contract; every other kind requires probe_start == 0."""
    kind = d["k2u"]["meta"].kind
    if kind != "sshash":
        assert probe_start == 0, "probe_start is an sshash-only contract"
    if kind == "pfhash":
        from ..kphf.pfhash import pfhash_k2u

        return pfhash_k2u(d["k2u"], fw_words, xp)
    if kind == "sshash":
        from ..kphf.sshash import sshash_k2u

        return sshash_k2u(d["k2u"], fw_words, xp, probe_start=probe_start)
    if kind == "sampled":
        from ..kphf.sampled import sampled_k2u

        return sampled_k2u(d["k2u"], fw_words, xp)
    if kind == "kcdict":
        from ..kphf.kcdict import kcdict_k2u

        return kcdict_k2u(d["k2u"], fw_words, xp)
    raise ValueError(kind)


def _occ_projection_wide(d: dict, r: dict, xp, max_occs: int):
    """Padded occurrence projection from k2u outputs ``r`` (parity:
    reference src/index.rs:193-216). Uses the fused occ_start/occ_cnt when
    present (no offsets gathers), else the offsets table."""
    u2 = d["u2pos"]
    hit = r["mt"] > 0
    if "occ_start" in r:
        # fused rows carry the unitig's ctable start + count: the padded
        # projection needs NO offsets gathers at all
        start = r["occ_start"]
        cnt = xp.where(hit, r["occ_cnt"], xp.zeros_like(r["occ_cnt"]))
    else:
        uid = xp.where(hit, r["unitig_id"], xp.zeros_like(r["unitig_id"]))
        start = u2["offsets"][uid]
        cnt = u2["offsets"][uid + 1] - start
        cnt = xp.where(hit, cnt, xp.zeros_like(cnt))

    from .unitig_table import fetch_occ_block

    j = xp.arange(max_occs, dtype=start.dtype)
    valid = j[None, :] < cnt[:, None]
    ref_id, occ_pos, occ_o = fetch_occ_block(u2, start, max_occs, xp)

    k = d["meta"].k
    kpos = r["pos"][:, None]
    ulen = r["unitig_len"][:, None]
    fw_proj = kpos + occ_pos
    bw_proj = occ_pos + (ulen - kpos) - k
    ref_pos = xp.where(occ_o == 1, fw_proj, bw_proj)

    o_of_match = (r["mt"] == MATCH_IDENTITY).astype(xp.int32)[:, None]
    orient = xp.where(occ_o == 1, o_of_match, 1 - o_of_match)

    return {
        "n_occs": cnt,
        "ref_id": ref_id,
        "ref_pos": ref_pos,
        "orient": orient,
        "valid": valid,
    }


def get_ref_pos_padded(d: dict, fw_words, xp, max_occs: int, probe_start: int = 0):
    """Batched get_ref_pos with padded occurrence lists.

    Returns dict with
      k2u fields: unitig_id, unitig_len, pos, mt       [N]
      ref_id, ref_pos [N, max_occs] int64; orient [N, max_occs] int32
      (1=fw, 0=rc); valid [N, max_occs] bool; n_occs [N]

    Projection parity: reference src/index.rs:193-216.
    """
    r = k2u_batch(d, fw_words, xp, probe_start=probe_start)
    return {**r, **_occ_projection_wide(d, r, xp, max_occs)}


def _scatter_set(base, idx, upd, xp):
    if xp is np:
        b = base.copy()
        b[idx] = upd
        return b
    return base.at[idx].set(upd)


def _merge_compact(d, p, r, pieces, N, max_occs, xp):
    """Merge main-phase fused results with one or more compacted phase-2
    blocks into full-width padded tensors (test/oracle path; serving
    consumers use merge=False and skip the wide row scatters)."""
    main_w = p["ref_id"].shape[1]
    target_w = max(max_occs, main_w)
    pad2 = [(0, 0), (0, target_w - main_w)]
    padp2 = [(0, 0), (0, target_w - max_occs)]
    full = {kk: r[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")}
    full["n_occs"] = p["n_occs"]
    for kk in ("ref_id", "ref_pos", "orient", "valid"):
        full[kk] = xp.pad(p[kk], pad2)
    fields = (
        "unitig_id", "unitig_len", "pos", "mt", "n_occs",
        "ref_id", "ref_pos", "orient", "valid",
    )
    for out2, lanes, slot_real in pieces:
        o2 = {
            kk: (xp.pad(v, padp2) if getattr(v, "ndim", 1) == 2 else v)
            for kk, v in out2.items()
        }
        dest = xp.where(slot_real, lanes, N)
        for kk in fields:
            base = xp.concatenate(
                [full[kk], xp.zeros_like(full[kk][:1])], axis=0
            )
            full[kk] = _scatter_set(base, dest, o2[kk], xp)[:N]
    return full


def _compact_split(
    d, fw, r, p, overflow, m_a, m_b, max_occs, merge, xp, probe_start=0,
    probe_limit2=None, m_c=None,
):
    """TYPE-SPLIT heavy phase (see get_ref_pos_compact ``m2b``): type-A
    lanes (k2u resolved, unitig occurrences exceed the main width) reuse
    the main probe's occ bounds — fused rows carry them inline, non-fused
    layouts re-gather them from the offsets table on the compacted lanes —
    and pay ONLY the wide occurrence fetch; type-B lanes (skew bucket or
    probe depth exceeded) re-run the full padded pipeline, starting at
    ``probe_start`` (exact: type-B non-skew lanes already probed and
    missed rows [0, probe_start) in the shallow main phase). Two
    rank-selects (ops/compact.py) extract both lane sets.

    ``probe_limit2`` (sshash only) inserts a MIDDLE phase: the compacted
    type-B lanes first re-probe shallowly to depth ``probe_limit2`` with
    full in-loop validation (rows [0/probe_start, probe_limit2)); only
    the residue — skew lanes and genuinely deeper-than-probe_limit2
    buckets, ``m_c`` compacted lanes — pays the full-depth padded
    pipeline. The padded phase is the dominant phase-2 cost (probe_bound
    is 64 at Gbp scale while bucket depth P99.9 is ~4-8), so this trades
    m_b×(probe_bound-plim2) probe iterations for m_c×probe_bound."""
    from ..ops.compact import flagged_lanes, flagged_lanes2

    N = fw.shape[0]
    type_b = r["use_skew"] | r["unresolved"]
    type_a = overflow & ~type_b
    lanes_a, n_a, lanes_b, n_b = flagged_lanes2(type_a, type_b, m_a, m_b, xp)
    over_budget = (n_a > m_a) | (n_b > m_b)

    rA = {
        kk: r[kk][lanes_a]
        for kk in ("unitig_id", "unitig_len", "pos", "mt")
    }
    if "occ_start" in r:
        rA["occ_start"] = r["occ_start"][lanes_a]
        rA["occ_cnt"] = r["occ_cnt"][lanes_a]
    # else: _occ_projection_wide re-gathers the bounds from the offsets
    # table for the M compacted lanes (2 tiny gathers, not N-sized)
    outA = {
        **{kk: rA[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
        **_occ_projection_wide(d, rA, xp, max_occs),
    }
    sa = xp.arange(m_a) < xp.minimum(n_a, m_a)
    sb = xp.arange(m_b) < xp.minimum(n_b, m_b)

    if probe_limit2 is None:
        outB = get_ref_pos_padded(
            d, fw[lanes_b], xp, max_occs, probe_start=probe_start
        )
    else:
        from ..kphf.sshash import sshash_k2u

        fwB = fw[lanes_b]
        # middle phase: shallow re-probe with in-loop validation and the
        # FULL MPHF (truncation-stranded lanes need the whole chain)
        rM = sshash_k2u(
            d["k2u"], fwB, xp, mode="main",
            probe_limit=int(probe_limit2), probe_start=probe_start,
        )
        outB = {
            **{kk: rM[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
            **_occ_projection_wide(d, rM, xp, max_occs),
        }
        # residue: skew lanes + buckets deeper than probe_limit2. Fake
        # type-B slots must not eat m_c capacity.
        type_c = (rM["use_skew"] | rM["unresolved"]) & sb
        m_c = int(m_c) if m_c else max(64, m_b // 8)
        lanes_c, n_c = flagged_lanes(type_c, m_c, xp)
        over_budget = over_budget | (n_c > m_c)
        # with the useqrec probe the middle phase's unresolved lanes
        # include kw-matched-but-unvalidated rows < probe_limit2 — the
        # residue must re-probe them from 0 (see sshash_k2u)
        ps2 = (
            0
            if "useqrec" in d["k2u"].get("us", {})
            else min(int(probe_limit2), int(d["k2u"]["meta"].probe_bound))
        )
        outC = get_ref_pos_padded(
            d, fwB[lanes_c], xp, max_occs, probe_start=ps2
        )
        sc = xp.arange(m_c) < xp.minimum(n_c, m_c)
        # scatter the residue rows back over the middle-phase block
        # (fake slots route to a dummy row)
        if xp is np:
            idx = np.asarray(lanes_c)[np.asarray(sc)]
            for kk in outB:
                v = outB[kk].copy()
                v[idx] = np.asarray(outC[kk])[np.asarray(sc)]
                outB[kk] = v
        else:
            safe = xp.where(sc, lanes_c, m_b)
            for kk in outB:
                v = outB[kk]
                mask = sc[:, None] if v.ndim == 2 else sc
                ext = xp.concatenate([v, xp.zeros_like(v[:1])], axis=0)
                outB[kk] = ext.at[safe].set(
                    xp.where(mask, outC[kk], xp.zeros_like(outC[kk]))
                )[:m_b]

    if not merge:
        out = {
            "main": {
                **{kk: r[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
                **p,
            },
            "overflow": overflow,
            "lanes": lanes_a,
            "slot_real": sa,
            "phase2": outA,
            "n_ovf": n_a,
            "lanes_b": lanes_b,
            "slot_real_b": sb,
            "phase2b": outB,
            "n_ovf_b": n_b,
            "over_budget": over_budget,
        }
        if probe_limit2 is not None:
            # surfaced separately so scan drivers that only monitor the
            # (n_ovf, n_ovf_b) pair can still detect residue truncation —
            # a silently clipped m_c leaves middle-phase-unresolved lanes
            # with unvalidated results (OneGraphIndexQuery raises on it)
            out["over_budget_c"] = n_c > m_c
        return out

    full = _merge_compact(
        d, p, r, [(outA, lanes_a, sa), (outB, lanes_b, sb)], N, max_occs, xp
    )
    full["over_budget"] = over_budget
    return full


def merge_compact_k2u(out: dict, xp, n: int | None = None) -> dict:
    """Per-lane K2U fields (unitig_id, pos, mt) from a ``merge=False``
    compact-query output: main-phase values with the compacted phase-2
    (and type-split phase-2b) lanes scattered back over their slots.

    Unlike the merge=True path this scatters only SCALAR columns for the
    M overflow lanes (~tens of ns total), so serving graphs can chain
    lane-wise consumers (colors, pseudoalign) after the exact two-phase
    query without leaving the device. Fake compaction slots are routed to
    a dummy lane so they can never clobber a real one."""
    m_ = out["main"]
    cols = {kk: m_[kk] for kk in ("unitig_id", "pos", "mt")}
    n = cols["mt"].shape[0] if n is None else n
    blocks = [("phase2", "lanes", "slot_real")]
    if "phase2b" in out:
        blocks.append(("phase2b", "lanes_b", "slot_real_b"))
    for pk, lk, sk in blocks:
        p2, lanes, real = out[pk], out[lk], out[sk]
        if xp is np:
            idx = np.asarray(lanes)[np.asarray(real)]
            for kk in cols:
                cols[kk] = cols[kk].copy()
                cols[kk][idx] = np.asarray(p2[kk])[np.asarray(real)]
        else:
            safe = xp.where(real, lanes, n)  # fakes -> dummy row n
            for kk in cols:
                ext = xp.concatenate([cols[kk], cols[kk][:1]])
                ext = ext.at[safe].set(
                    xp.where(real, p2[kk], xp.zeros_like(p2[kk]))
                )
                cols[kk] = ext[:n]
    return cols


def get_ref_pos_compact(
    d: dict,
    fw_words,
    xp,
    max_occs: int,
    budget_div: int = 4,
    merge: bool = True,
    probe_limit: int | None = None,
    m2: int | None = None,
    m2b: int | None = None,
    defer_valid: bool = False,
    mphf_level_limit: int | None = None,
    probe_limit2: int | None = None,
    m2c: int | None = None,
):
    """One-kernel full query with an ON-DEVICE compacted heavy phase.

    ``probe_limit2``/``m2c`` (with ``m2b``, sshash only): middle phase —
    compacted type-B lanes re-probe shallowly to depth probe_limit2
    before the full-depth padded residue (see _compact_split).

    Main phase: fused-row k2u main path (no skew-structure gathers) +
    zero-gather projection for single-occurrence unitigs — the common case
    costs 3 row gathers total. Heavy lanes (skew bucket or multi-occurrence
    unitig) are compacted on device — scatter-free: a hierarchical
    rank-select extracts the lane indices (ops/compact.py) — into an M-lane
    sub-batch resolved
    by the full padded pipeline, then merged back. Results are exactly
    get_ref_pos_padded's unless ``over_budget`` is set (caller falls back;
    cannot happen when M covers the workload's overflow rate).

    ``m2`` sets M directly (defaults to N // budget_div).

    ``m2b`` enables the TYPE-SPLIT heavy phase: lanes whose k2u already
    resolved in the main probe but whose unitig has more occurrences than
    the fused width (type A, capacity ``m2``) skip re-probing — they only
    need the wide occurrence fetch via the fused occ_start. Only
    skew-bucket / probe-depth-unresolved lanes (type B, capacity ``m2b``)
    re-run the full padded pipeline. Results identical; ~2x cheaper type-A
    lanes.

    Works with BOTH array layouts:
    - fused inline rows (``ModIndex.device_arrays(fused=True)``): the
      speed tier — zero-gather main projection from the fused occ word(s).
    - non-fused compact layouts (packed IntVector positions, EF/flat
      prefix): the capacity tier — main projection via the offsets table
      at width 2, and (with ``m2b``) the type-B re-probe starts at
      ``probe_limit`` so deep buckets pay only the remaining depth.

    ``defer_valid``: main-phase probe skips the per-candidate boundary
    validation and validates winners once per lane (see sshash_k2u);
    failed lanes join type-B, which then re-probes from row 0 with full
    validation. Results identical; ~2 fewer gathers per probe iteration
    on the non-fused tiers.

    ``mphf_level_limit``: truncated minimizer-MPHF main phase (MPHF
    engines: parity/fast32). Only the first N BBHash level bit-tests run
    and the final-hash searchsorted is skipped batch-wide; lanes the
    truncated chain cannot place join type-B (full lookup + full-depth
    validated re-probe from row 0 — they never probed). Results
    identical. At gamma=1.7 four levels place ~96% of minimizers, so the
    main phase drops ~(n_levels-4) + log2(n_fh) dependent random gathers
    per lane on the compact capacity tier.
    """
    from ..kphf.sshash import sshash_k2u
    from ..ops.compact import flagged_lanes
    from .twophase import _project_fused

    fw = xp.asarray(fw_words)
    N = fw.shape[0]
    M = int(m2) if m2 else max(64, N // budget_div)
    probe_start = 0
    if d["k2u"]["meta"].kind == "kcdict":
        from ..kphf.kcdict import kcdict_k2u
        from ..ops.mono2_probe import mono2_probe_k2u, use_mono2_probe

        import jax

        if use_mono2_probe(d["k2u"]["meta"], xp, jax.default_backend()):
            r = mono2_probe_k2u(d["k2u"], fw)
        else:
            r = kcdict_k2u(d["k2u"], fw, xp, mode="main")
    else:
        r = sshash_k2u(
            d["k2u"], fw, xp, mode="main", probe_limit=probe_limit,
            defer_valid=defer_valid, mphf_level_limit=mphf_level_limit,
        )
        if (
            probe_limit is not None
            and not defer_valid
            and mphf_level_limit is None
            and "useqrec" not in d["k2u"].get("us", {})
        ):
            # phase-2B lanes either never probe (use_skew) or already
            # probed and missed rows [0, probe_limit): the type-split
            # re-probe may start past them (sshash_k2u exactness contract).
            # With defer_valid that miss-proof does NOT hold (a failed
            # deferred winner suppressed later candidates), and with the
            # useqrec probe a kw-matched-but-unvalidated row is not a
            # proven miss either — both keep probe_start=0 with full
            # in-loop validation in the re-probe.
            probe_start = min(int(probe_limit), int(d["k2u"]["meta"].probe_bound))
    if "occ_cnt" in r:
        p = _project_fused(d, r, xp)
    else:
        # non-fused (packed/EF compact tiers): occ bounds come from the
        # offsets table (2 extra gathers); main projection width 2
        from .twophase import _project_offsets

        p = _project_offsets(d, r, xp, small_occs=2)
    overflow = p["overflow"] | r["unresolved"]

    if m2b is not None:
        if probe_limit2 is not None:
            assert d["k2u"]["meta"].kind != "kcdict", (
                "probe_limit2 is an sshash-only middle phase"
            )
        return _compact_split(
            d, fw, r, p, overflow, M, int(m2b), max_occs, merge, xp,
            probe_start=probe_start, probe_limit2=probe_limit2, m_c=m2c,
        )

    lanes, n_ovf = flagged_lanes(overflow, M, xp)
    over_budget = n_ovf > M
    out2 = get_ref_pos_padded(d, fw[lanes], xp, max_occs)
    slot_real = xp.arange(M) < xp.minimum(n_ovf, M)

    if not merge:
        # zero-scatter form: main (exact for non-overflow lanes) + the
        # compacted phase-2 block with its lane map — the serving/bench
        # path reduces or consumes both pieces without materializing
        # [N, max_occs] merged tensors (no wide row scatters)
        return {
            "main": {**{kk: r[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")}, **p},
            "overflow": overflow,
            "lanes": lanes,
            "slot_real": slot_real,
            "phase2": out2,
            "n_ovf": n_ovf,
            "over_budget": over_budget,
        }

    # merge: main-phase fused results (width 1 or 2) padded to max_occs
    # width, then phase-2 rows scattered over their lanes (unused slots ->
    # row N)
    full = _merge_compact(d, p, r, [(out2, lanes, slot_real)], N, max_occs, xp)
    full["over_budget"] = over_budget
    return full


def get_ref_pos_csr(d: dict, fw_words, xp, budget: int):
    """Batched get_ref_pos with EXACT (CSR) occurrence materialization.

    Returns (k2u fields + occ_start/occ_count per query) plus flat arrays
    qid/ref_id/ref_pos/orient of length ``budget`` (static) holding the
    concatenated occurrences of all queries; ``total`` gives the true
    count (caller re-runs with a bigger budget if total > budget; the
    count pass is nearly free).

    This is the streaming-scale alternative to get_ref_pos_padded when
    per-unitig occurrence counts are heavily skewed.
    """
    r = k2u_batch(d, fw_words, xp)
    u2 = d["u2pos"]
    hit = r["mt"] > 0
    uid = xp.where(hit, r["unitig_id"], xp.zeros_like(r["unitig_id"]))
    start = u2["offsets"][uid]
    cnt = xp.where(hit, u2["offsets"][uid + 1] - start, xp.zeros_like(start))
    occ_start = xp.cumsum(cnt) - cnt  # exclusive
    total = occ_start[-1] + cnt[-1] if cnt.shape[0] else xp.int64(0)

    # flat slot j belongs to query qid[j] = searchsorted(occ_start, j, 'right')-1
    j = xp.arange(budget, dtype=start.dtype)
    qid = xp.clip(
        xp.searchsorted(occ_start, j, side="right") - 1, 0, max(cnt.shape[0] - 1, 0)
    )
    within = j - occ_start[qid]
    valid = (j < total) & (within < cnt[qid])
    occ_idx = xp.clip(start[qid] + within, 0, max(u2["meta"].n_occs - 1, 0))
    ref_id, occ_pos, occ_o = decode_occs(u2, occ_idx, xp)

    k = d["meta"].k
    kpos = r["pos"][qid]
    ulen = r["unitig_len"][qid]
    ref_pos = xp.where(occ_o == 1, kpos + occ_pos, occ_pos + (ulen - kpos) - k)
    o_match = (r["mt"][qid] == MATCH_IDENTITY).astype(xp.int32)
    orient = xp.where(occ_o == 1, o_match, 1 - o_match)
    return {
        **r,
        "occ_start": occ_start,
        "occ_count": cnt,
        "total": total,
        "qid": qid,
        "ref_id": xp.where(valid, ref_id, xp.full_like(ref_id, -1)),
        "ref_pos": xp.where(valid, ref_pos, xp.zeros_like(ref_pos)),
        "orient": xp.where(valid, orient, xp.zeros_like(orient)),
        "valid": valid,
    }


def index_metadata(
    refs,
    decoys: int = 0,
    have_edge_vec: bool = False,
    keep_duplicates: bool = False,
) -> dict:
    """Provenance record (parity: IndexMetadata, reference
    src/index.rs:266-278): SHA-256 and SHA-512 over reference names and over
    the decoded sequences (when present), the same two hashes over the
    trailing ``decoys`` references, decoy counts/offset, and the
    have_edge_vec / keep_duplicates build flags. Hash *values* are this
    implementation's own (byte layout of the 2-bit words), not pufferfish's
    — pf1 loads keep the foreign info.json hashes verbatim instead."""
    import hashlib

    def hash_names(names, algo):
        h = hashlib.new(algo)
        for n in names:
            h.update(n.encode())
            h.update(b"\0")
        return h.hexdigest()

    def hash_seq_bytes(data, algo):
        h = hashlib.new(algo)
        h.update(data)
        return h.hexdigest()

    n_refs = len(refs.names)
    first_decoy = n_refs - int(decoys)
    seq_bytes = (
        np.ascontiguousarray(refs.seq.words).tobytes() if refs.has_seq else None
    )
    md = {
        "have_edge_vec": bool(have_edge_vec),
        "sha256_names": hash_names(refs.names, "sha256"),
        "sha256_seqs": hash_seq_bytes(seq_bytes, "sha256") if seq_bytes else None,
        "name_hash_512": hash_names(refs.names, "sha512"),
        "seq_hash_512": hash_seq_bytes(seq_bytes, "sha512") if seq_bytes else None,
        "decoy_name_hash": hash_names(refs.names[first_decoy:], "sha256")
        if decoys
        else "",
        "decoy_seq_hash": "",
        "num_decoys": int(decoys),
        "first_decoy_index": int(first_decoy),
        "keep_duplicates": bool(keep_duplicates),
    }
    if decoys and refs.has_seq:
        # decoy sequences are the trailing refs: hash their decoded window
        lo = int(refs.prefix_sum[first_decoy])
        hi = int(refs.prefix_sum[n_refs])
        md["decoy_seq_hash"] = hashlib.sha256(
            refs.seq.to_str(lo, hi).encode()
        ).hexdigest()
    return md


class ModIndex:
    """Host-side modular index: K2U + U2Pos + refs + provenance
    (BaseIndex-equivalent: version + type + metadata, reference
    src/index.rs:221-300)."""

    def __init__(self, k2u, u2pos, refs, index_type: str = "Custom", metadata: dict | None = None):
        from .. import __version__

        self.k2u = k2u
        self.u2pos = u2pos
        self.refs = refs
        self.index_type = index_type
        self.version = __version__
        self.metadata = metadata or {}

    @property
    def k(self) -> int:
        return self.k2u.k

    @property
    def n_kmers(self) -> int:
        return self.k2u.n_kmers

    @property
    def n_unitigs(self) -> int:
        return self.k2u.unitigs.n_unitigs

    @property
    def n_refs(self) -> int:
        return self.refs.n_refs

    @property
    def ref_names(self) -> list:
        """Reference names (the reference logs 'FIX ME' and returns empty,
        src/index.rs:71-74; we return the real names from the table)."""
        return self.u2pos.ref_names or self.refs.names

    def max_occs(self) -> int:
        return self.u2pos.max_occs()

    def device_arrays(
        self,
        fused: bool = False,
        pos_kind: str | None = None,
        prefix_kind: str | None = None,
        uproj: bool = False,
        useqrec: bool = False,
        bucket_inline: bool = False,
        mphf_rows: bool = False,
    ) -> dict:
        # pos_kind/prefix_kind are SSHash layout knobs; other K2Us take no
        # arguments
        k2u_takes_kinds = (
            pos_kind is not None
            or prefix_kind is not None
            or bucket_inline
            or mphf_rows
        ) and hasattr(self.k2u, "pos")
        d = {
            "k2u": (
                self.k2u.device_arrays(
                    prefix_kind=prefix_kind, pos_kind=pos_kind,
                    bucket_inline=bucket_inline, mphf_rows=mphf_rows,
                )
                if k2u_takes_kinds
                else self.k2u.device_arrays()
            ),
            "u2pos": self.u2pos.device_arrays(),
            "refs": self.refs.device_arrays(),
            "meta": meta(k=self.k, index_type=self.index_type),
        }
        if uproj:
            # capacity-tier fusion: per-unitig projection records (see
            # build_uproj) injected into the k2u's unitig-set arrays —
            # sshash_k2u's deferred-map tail then resolves extent + occ
            # bounds + first two occurrences in ONE row gather
            assert "us" in d["k2u"], "uproj requires a unitig-set K2U (sshash)"
            d["k2u"]["us"]["uproj"] = build_uproj(self.u2pos, self.k2u.unitigs)
        if useqrec:
            # round-4 window-record probe: validation + rank + projection
            # ride the candidate fetch (see build_useqrec; packed pos only)
            assert "us" in d["k2u"], "useqrec requires a unitig-set K2U"
            d["k2u"]["us"]["useqrec"] = build_useqrec(
                self.u2pos, self.k2u.unitigs
            )
        if fused and d["k2u"]["meta"].kind == "kcdict":
            return d  # kcdict rows already carry the fused occurrence data
        if fused:
            # Fusion pass: append each occurrence-row's unitig's FIRST
            # encoded reference occurrence + occurrence count to the inline
            # k2u rows. Single-occurrence unitigs (the common case) then
            # project with ZERO additional gathers; multi-occurrence lanes
            # take the overflow phase. K2U and U2Pos stay modular — this is
            # a device-layout optimization computed at array-build time.
            pos_d = d["k2u"].get("pos", {})
            assert "inline" in pos_d, "fused layout requires an inline row layout"
            ss = self.k2u
            # uid per ROW comes from the row's own uid column (col 1 of the
            # u32 layout) so this works for both occurrence-ordered inline
            # rows and fixed-capacity bucket tables (sentinel rows clip to
            # uid 0 and are never read — their verification self-rejects)
            uid_field = pos_d["inline"][:, 1].astype(np.int64)
            if d["k2u"]["meta"].pos_kind == "fixedcap2":
                # slot-0 uid field carries the bucket occ count in its top
                # 3 bits (sentinel rows mask to garbage but are never read)
                uid_field = uid_field & ((1 << 29) - 1)
            uid = np.minimum(uid_field, ss.unitigs.n_unitigs - 1)
            if hasattr(self.u2pos.ctable, "to_array"):  # packed IntVector
                cwords = self.u2pos.ctable.to_array()
            else:
                cwords = self.u2pos.ctable
            off = self.u2pos.offsets
            first = cwords[np.clip(off[uid], 0, max(len(cwords) - 1, 0))]
            cnt = (off[uid + 1] - off[uid]).astype(np.uint64)
            rows = pos_d["inline"]  # u32 layout
            extra = [
                rows,
                (first & np.uint64(0xFFFFFFFF)).astype(np.uint32)[:, None],
                (first >> np.uint64(32)).astype(np.uint32)[:, None],
                cnt.astype(np.uint32)[:, None],
                off[uid].astype(np.uint32)[:, None],
            ]
            if rows.shape[1] == 8:  # inline2: embed the SECOND occurrence too
                second = cwords[
                    np.clip(off[uid] + 1, 0, max(len(cwords) - 1, 0))
                ] * (cnt >= 2)
                extra.append((second & np.uint64(0xFFFFFFFF)).astype(np.uint32)[:, None])
                extra.append((second >> np.uint64(32)).astype(np.uint32)[:, None])
            pos_d["inline"] = np.concatenate(extra, axis=1)
            # same for the skew rows
            if "skew_inline" in d["k2u"]:
                spos_raw = ss.skew_direct["pos"]
                spos = np.where(spos_raw >= 0, spos_raw, 0)  # cuckoo empties
                suid = ss.unitigs.pos_to_id(spos)
                sfirst = cwords[np.clip(off[suid], 0, max(len(cwords) - 1, 0))]
                scnt = (off[suid + 1] - off[suid]).astype(np.uint64)
                srows = d["k2u"]["skew_inline"]  # u32 layout
                d["k2u"]["skew_inline"] = np.concatenate(
                    [
                        srows,
                        (sfirst & np.uint64(0xFFFFFFFF)).astype(np.uint32)[:, None],
                        (sfirst >> np.uint64(32)).astype(np.uint32)[:, None],
                        scnt.astype(np.uint32)[:, None],
                        off[suid].astype(np.uint32)[:, None],
                    ],
                    axis=1,
                )
        return d

    def make_query_fn(self, max_occs: int | None = None, device=None):
        """Return (arrays, jitted fn kms[N] -> padded MappedRefPos dict)."""
        import jax
        import jax.numpy as jnp

        if max_occs is None:
            max_occs = max(1, self.max_occs())
        arrays = jax.device_put(self.device_arrays(), device)

        @jax.jit
        def query(kms):
            return get_ref_pos_padded(arrays, kms, jnp, max_occs)

        return arrays, query

    def color_classes(self):
        """Build the color-class layer (unitig -> deduped ref-id set) from
        this index's occurrence table (see index/colors.py)."""
        from .colors import ColorClasses

        return ColorClasses.from_u2pos(self.u2pos)

    def unitigs_on_ref(self, ref_id: int) -> dict:
        """Batched unitig tiling of reference ``ref_id``: inverts the
        occurrence table (every ctable row naming this ref, sorted by
        position) instead of walking the sequence with one query per tile.
        Returns dict of arrays (unitig_id, unitig_len, pos, o) — equal,
        entry for entry, to ``iter_unitigs_on_ref``'s walk (tested), at
        decode cost O(n_occs) with no k-mer queries at all."""
        from .unitig_table import decode_occs

        u2 = self.u2pos.device_arrays()
        n_occs = int(u2["meta"].n_occs)
        idx = np.arange(n_occs, dtype=np.int64)
        rid, pos, o = decode_occs(u2, idx, np)
        m = np.asarray(rid) == ref_id
        occ_i = idx[m]
        uid = np.searchsorted(self.u2pos.offsets, occ_i, side="right") - 1
        order = np.argsort(np.asarray(pos)[m], kind="stable")
        uid = uid[order]
        return {
            "unitig_id": uid,
            "unitig_len": np.asarray(self.k2u.unitigs.unitig_len(uid)),
            "pos": np.asarray(pos)[m][order],
            "o": np.asarray(o)[m][order].astype(np.int64),
        }

    def iter_unitigs_on_ref(self, ref_id: int):
        """Walk reference ``ref_id``'s unitig tiling by querying the k-mer at
        each tile start and jumping unitig_len - k + 1 (parity: reference
        src/index.rs:363-424 RefSeqContigIterator). Yields dicts with
        unitig_id, unitig_len, pos, o (1=fw).

        HOST/TEST-ONLY ORACLE: one scalar query per tile. Use
        ``unitigs_on_ref`` (occurrence-table inversion, batched) at scale."""
        assert self.refs.has_seq
        arrays = self.device_arrays()
        k = self.k
        s, e = int(self.refs.prefix_sum[ref_id]), int(self.refs.prefix_sum[ref_id + 1])
        pos = 0
        end_pos = (e - s) - k + 1
        while pos < end_pos:
            km = self.refs.seq.get_kmer_u64(np.array([s + pos]), k)
            r = k2u_batch(arrays, km, np)
            mt = int(r["mt"][0])
            assert mt > 0, f"reference walk failed at pos {pos}"
            ulen = int(r["unitig_len"][0])
            yield {
                "unitig_id": int(r["unitig_id"][0]),
                "unitig_len": ulen,
                "pos": pos,
                "o": 1 if mt == MATCH_IDENTITY else 0,
            }
            pos += ulen - k + 1

    # ------------------------------------------------------ host-side query
    def get_ref_pos_eager(self, kms) -> list:
        """NumPy reference path: list (one per query) of lists of
        (ref_id, pos, orient) — mirrors reference get_ref_pos_eager output
        for tests and debugging."""
        kms = np.asarray(kms, dtype=np.uint64)
        out = get_ref_pos_padded(self.device_arrays(), kms, np, max(1, self.max_occs()))
        res = []
        for i in range(len(kms)):
            if out["mt"][i] == 0:
                res.append(None)
                continue
            hits = []
            for j in range(int(out["n_occs"][i])):
                hits.append(
                    (int(out["ref_id"][i, j]), int(out["ref_pos"][i, j]), int(out["orient"][i, j]))
                )
            res.append(hits)
        return res
