"""Multi-chip sharding tests on the 8-device virtual CPU mesh."""

import numpy as np
import pytest

jax = pytest.importorskip("jax")


def _chr_spt():
    """Seeded stand-in for a chromosome's cuttlefish tiling: 256 random
    unitigs of 500 bases with planted heavy and mid-depth minimizer
    buckets and three-occurrence unitigs (mazu_tpu.synth.toy_spt)."""
    from mazu_tpu.synth import toy_spt

    return toy_spt(n_seqs=256, seq_len=500)[0]


def _chr_index():
    from mazu_tpu.index.piscem_index import piscem_index_from_spt

    return piscem_index_from_spt(_chr_spt(), 15, 4, engine="direct")


def test_graft_entry_compiles():
    import __graft_entry__ as g

    fn, args = g.entry()
    out = jax.jit(fn)(*args)
    assert (np.asarray(out["mt"]) > 0).all()


def test_dryrun_multichip():
    import __graft_entry__ as g

    g.dryrun_multichip(8)


def test_bucket_sharded_matches_unsharded():
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.kphf.sshash import sshash_k2u
    from mazu_tpu.parallel.sharding import make_bucket_sharded_query
    from mazu_tpu.synth import toy_index

    idx = toy_index(n_seqs=16, seq_len=150)
    kms = np.concatenate(
        [idx.refs.ref_kmers(i, idx.k) for i in range(4)]
    ).astype(np.uint64)[:256]

    devices = np.array(jax.devices()[:8]).reshape(2, 4)
    mesh = Mesh(devices, ("data", "bucket"))
    qf = make_bucket_sharded_query(idx.k2u, mesh)
    sharded = {k: np.asarray(v) for k, v in qf(jnp.asarray(kms)).items()}
    plain = sshash_k2u(idx.k2u.device_arrays(prefix_kind="flat"), kms, np)
    for key in ("unitig_id", "unitig_len", "pos", "mt"):
        np.testing.assert_array_equal(sharded[key], np.asarray(plain[key]), err_msg=key)


def test_alltoall_routed_query_matches():
    """MoE-style all_to_all routing: each query resolved only on the shard
    owning its minimizer bucket; results equal the single-device kernel."""
    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.kphf.sshash import sshash_k2u
    from mazu_tpu.parallel.sharding import make_alltoall_sharded_query
    from mazu_tpu.synth import toy_index

    idx = toy_index(n_seqs=48, seq_len=300)
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(3)
    n = 512
    work = np.tile(kms, -(-n // len(kms)))[:n]
    from mazu_tpu.kmer import revcomp

    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], idx.k)
    miss = rng.random(n) < 0.1
    work[miss] = rng.integers(0, 1 << (2 * idx.k), int(miss.sum()), dtype=np.uint64)

    mesh = Mesh(np.array(jax.devices()[:8]), ("bucket",))
    qf = make_alltoall_sharded_query(idx.k2u, mesh)
    out = {k: np.asarray(v) for k, v in qf(jnp.asarray(work)).items()}
    assert out["routed_ok"].all()
    want = sshash_k2u(idx.k2u.device_arrays(), work, np)
    for kk in ("mt", "unitig_id", "unitig_len", "pos"):
        np.testing.assert_array_equal(out[kk], np.asarray(want[kk]), err_msg=kk)


def test_fused_sharded_full_query_matches_single_chip():
    """The fused-row sharded path (bucket-sharded inline rows + prefix +
    ctable) must reproduce the single-device get_ref_pos_compact output
    piece by piece: main phase, overflow lanes, compacted heavy phase."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.index.modindex import get_ref_pos_compact
    from mazu_tpu.kmer import revcomp
    from mazu_tpu.parallel.sharding import make_fused_sharded_query

    idx = _chr_index()
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(5)
    n = 2048
    work = np.tile(kms, -(-n // len(kms)))[:n]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], idx.k)
    miss = rng.random(n) < 0.05
    work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
    rng.shuffle(work)

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(1, 8), ("data", "bucket"))
    M2 = 512
    qf = make_fused_sharded_query(idx, mesh, m2=M2, probe_limit=2)
    got = jax.tree_util.tree_map(np.asarray, qf(jnp.asarray(work)))

    mo = max(1, idx.max_occs())
    want = get_ref_pos_compact(
        idx.device_arrays(fused=True, pos_kind="inline2"),
        work,
        np,
        mo,
        merge=False,
        probe_limit=2,
        m2=M2,
    )
    assert not bool(want["over_budget"]) and not bool(got["over_budget"].any())
    assert int(got["n_ovf"][0]) == int(want["n_ovf"])
    np.testing.assert_array_equal(got["overflow"], want["overflow"])
    np.testing.assert_array_equal(got["lanes"], want["lanes"])
    np.testing.assert_array_equal(got["slot_real"], want["slot_real"])
    for kk in ("unitig_id", "unitig_len", "pos", "mt", "n_occs"):
        np.testing.assert_array_equal(got["main"][kk], want["main"][kk], err_msg=kk)
    # main projections: exact on non-overflow lanes (valid-masked)
    mv = want["main"]["valid"]
    np.testing.assert_array_equal(got["main"]["valid"], mv)
    for kk in ("ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(
            np.where(mv, got["main"][kk], 0), np.where(mv, want["main"][kk], 0), err_msg=kk
        )
    # phase 2: k2u fields everywhere real; projections where valid
    sr = want["slot_real"]
    for kk in ("unitig_id", "unitig_len", "pos", "mt", "n_occs"):
        np.testing.assert_array_equal(
            np.where(sr, got["phase2"][kk], 0), np.where(sr, want["phase2"][kk], 0), err_msg=kk
        )
    v2 = want["phase2"]["valid"] & sr[:, None]
    np.testing.assert_array_equal(got["phase2"]["valid"] & sr[:, None], v2)
    for kk in ("ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(
            np.where(v2, got["phase2"][kk], 0), np.where(v2, want["phase2"][kk], 0), err_msg=kk
        )

    # 2x4 mesh: data-sharded queries, lane indices local per data shard
    mesh2 = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "bucket"))
    qf2 = make_fused_sharded_query(idx, mesh2, m2=M2, probe_limit=2)
    got2 = jax.tree_util.tree_map(np.asarray, qf2(jnp.asarray(work)))
    half = n // 2
    for s in range(2):
        w_s = get_ref_pos_compact(
            idx.device_arrays(fused=True, pos_kind="inline2"),
            work[s * half : (s + 1) * half],
            np,
            mo,
            merge=False,
            probe_limit=2,
            m2=M2,
        )
        np.testing.assert_array_equal(
            got2["overflow"][s * half : (s + 1) * half], w_s["overflow"]
        )
        np.testing.assert_array_equal(
            got2["lanes"][s * M2 : (s + 1) * M2], w_s["lanes"]
        )
        sr_s = w_s["slot_real"]
        for kk in ("unitig_id", "mt"):
            np.testing.assert_array_equal(
                np.where(sr_s, got2["phase2"][kk][s * M2 : (s + 1) * M2], 0),
                np.where(sr_s, w_s["phase2"][kk], 0),
                err_msg=f"shard{s}:{kk}",
            )


def test_sharded_checkpoint_roundtrip_and_validate(tmp_path):
    """>HBM deployment path: save a bucket-sharded fused checkpoint, load
    it back with per-device placement (make_array_from_single_device_arrays
    — the full index never materializes on one device), and run
    validate_self THROUGH the sharded query."""
    import os

    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.index.modindex import get_ref_pos_compact
    from mazu_tpu.index.validate import merge_sharded_out, validate_k2u_self_sharded
    from mazu_tpu.io.sharded_ckpt import (
        load_shard,
        make_fused_sharded_query_from_ckpt,
        save_fused_sharded,
    )
    from mazu_tpu.kmer import revcomp

    idx = _chr_index()
    ck = str(tmp_path / "shards")
    save_fused_sharded(ck, idx, n_shards=4, pos_kind="inline2")
    # per-shard files are genuinely partial: each holds ~1/4 of the rows
    total_rows = idx.k2u.pos.length
    s0 = load_shard(ck, 0)
    assert s0["inline"].shape[0] < total_rows

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "bucket"))
    # sequential validation k-mers cluster in heavy regions (measured worst
    # 976 overflow lanes per 1024): capacity = the full per-shard lane count
    M2 = 1024
    qf = make_fused_sharded_query_from_ckpt(ck, mesh, m2=M2, probe_limit=2)

    # exactness vs the single-device compact path, data-sharded halves
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(17)
    n = 2048
    work = np.tile(kms, -(-n // len(kms)))[:n]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], idx.k)
    miss = rng.random(n) < 0.05
    work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
    rng.shuffle(work)
    got = jax.tree_util.tree_map(np.asarray, qf(jnp.asarray(work)))
    merged = merge_sharded_out(got)
    mo = max(1, idx.max_occs())
    arrays = idx.device_arrays(fused=True, pos_kind="inline2")
    half = n // 2
    for s in range(2):
        w_s = get_ref_pos_compact(
            arrays, work[s * half : (s + 1) * half], np, mo,
            probe_limit=2, m2=M2,
        )
        for kk in ("unitig_id", "unitig_len", "pos", "mt"):
            np.testing.assert_array_equal(
                merged[kk][s * half : (s + 1) * half], w_s[kk],
                err_msg=f"shard{s}:{kk}",
            )

    # validate_self driven through the sharded query (fw + rc, all k-mers)
    validate_k2u_self_sharded(qf, idx.k2u, batch=2048)


def _mono_sharded_case(us, u2, refs, scheme, load, mesh_shape, n=2048, seed=9):
    """Build a mono/mono2 index, query a mixed batch through the sharded
    kernel, compare piece-by-piece vs single-device get_ref_pos_compact."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.index.modindex import ModIndex, get_ref_pos_compact
    from mazu_tpu.kmer import revcomp
    from mazu_tpu.kphf.kcdict import KCDict
    from mazu_tpu.parallel.sharding import make_mono_sharded_query

    kc = KCDict.from_unitig_set(us, occ_table=u2, scheme=scheme, load=load)
    idx = ModIndex(kc, u2, refs, index_type="t")

    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(seed)
    work = np.tile(kms, -(-n // len(kms)))[:n]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], idx.k)
    miss = rng.random(n) < 0.05
    work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
    rng.shuffle(work)

    mo = max(1, idx.max_occs())
    arrays = idx.device_arrays(fused=True)
    want = get_ref_pos_compact(arrays, work, np, mo, merge=False, m2=n)
    M2 = max(64, -(-(int(want["n_ovf"]) + 32) // 64) * 64)
    want = get_ref_pos_compact(arrays, work, np, mo, merge=False, m2=M2)

    mesh = Mesh(
        np.array(jax.devices()[:8]).reshape(*mesh_shape), ("data", "bucket")
    )
    qf = make_mono_sharded_query(idx, mesh, m2=M2, max_occs=mo)
    got = jax.tree_util.tree_map(np.asarray, qf(jnp.asarray(work)))

    n_data = mesh_shape[0]
    assert not bool(want["over_budget"]) and not bool(got["over_budget"].any())
    np.testing.assert_array_equal(got["overflow"], want["overflow"])
    for kk in ("unitig_id", "unitig_len", "pos", "mt", "n_occs"):
        np.testing.assert_array_equal(got["main"][kk], want["main"][kk], err_msg=kk)
    mv = want["main"]["valid"]
    np.testing.assert_array_equal(got["main"]["valid"], mv)
    for kk in ("ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(
            np.where(mv, got["main"][kk], 0),
            np.where(mv, want["main"][kk], 0),
            err_msg=kk,
        )
    # phase 2 lane blocks are per data shard; check each against its slice
    half = n // n_data
    for s in range(n_data):
        w_s = get_ref_pos_compact(
            arrays, work[s * half : (s + 1) * half], np, mo, merge=False, m2=M2
        )
        np.testing.assert_array_equal(
            got["lanes"][s * M2 : (s + 1) * M2], w_s["lanes"]
        )
        sr = w_s["slot_real"]
        np.testing.assert_array_equal(got["slot_real"][s * M2 : (s + 1) * M2], sr)
        for kk in ("unitig_id", "unitig_len", "pos", "mt", "n_occs"):
            np.testing.assert_array_equal(
                np.where(sr, got["phase2"][kk][s * M2 : (s + 1) * M2], 0),
                np.where(sr, w_s["phase2"][kk], 0),
                err_msg=f"shard{s}:{kk}",
            )
        v2 = w_s["phase2"]["valid"] & sr[:, None]
        np.testing.assert_array_equal(
            got["phase2"]["valid"][s * M2 : (s + 1) * M2] & sr[:, None], v2
        )
        for kk in ("ref_id", "ref_pos", "orient"):
            np.testing.assert_array_equal(
                np.where(v2, got["phase2"][kk][s * M2 : (s + 1) * M2], 0),
                np.where(v2, w_s["phase2"][kk], 0),
                err_msg=f"shard{s}:{kk}",
            )
    return kc


def test_mono_sharded_full_query_matches_single_chip():
    """Bucket-sharded mono2 (the single-chip bench default engine): exact
    agreement with get_ref_pos_compact on 1x8 and 2x4 meshes."""

    spt = _chr_spt()
    us, u2, refs = spt.unitigs, spt.piscem_table(), spt.ref_seq_collection()
    kc = _mono_sharded_case(us, u2, refs, "mono2", 0.25, (1, 8))
    assert kc.occ32, "piscem packing should enable the occ32 slot layout"
    _mono_sharded_case(us, u2, refs, "mono2", 0.25, (2, 4))


def test_mono_sharded_side_table_gating():
    """A high-load mono build displaces many keys into the replicated side
    table: phase 2 must stay one-hot (only the h1 owner reports side
    hits) or the psum merge would double-count."""

    spt = _chr_spt()
    us, u2, refs = spt.unitigs, spt.piscem_table(), spt.ref_seq_collection()
    kc = _mono_sharded_case(us, u2, refs, "mono", 4.0, (1, 8), n=512)
    assert kc.side is not None and kc.side_T > 0


def test_mono_sharded_checkpoint_roundtrip_and_validate(tmp_path):
    """>HBM deployment for the mono2 flagship engine: save bucket-sharded
    mono checkpoint, load with per-device placement, validate_self through
    the sharded query."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.index.modindex import ModIndex, get_ref_pos_compact
    from mazu_tpu.index.validate import merge_sharded_out, validate_k2u_self_sharded
    from mazu_tpu.io.sharded_ckpt import (
        load_shard,
        make_mono_sharded_query_from_ckpt,
        save_mono_sharded,
    )
    from mazu_tpu.kmer import revcomp
    from mazu_tpu.kphf.kcdict import KCDict

    spt = _chr_spt()
    us, u2, refs = spt.unitigs, spt.piscem_table(), spt.ref_seq_collection()
    kc = KCDict.from_unitig_set(us, occ_table=u2, scheme="mono2", load=0.25)
    idx = ModIndex(kc, u2, refs, index_type="t")
    ck = str(tmp_path / "mono_shards")
    save_mono_sharded(ck, idx, n_shards=4)
    s0 = load_shard(ck, 0)
    assert s0["table"].shape[0] * 4 == kc.T  # genuinely partial shard files

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "bucket"))
    M2 = 1024
    qf = make_mono_sharded_query_from_ckpt(ck, mesh, m2=M2)

    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(23)
    n = 2048
    work = np.tile(kms, -(-n // len(kms)))[:n]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], idx.k)
    miss = rng.random(n) < 0.05
    work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
    rng.shuffle(work)
    got = jax.tree_util.tree_map(np.asarray, qf(jnp.asarray(work)))
    merged = merge_sharded_out(got)
    mo = max(1, idx.max_occs())
    arrays = idx.device_arrays(fused=True)
    half = n // 2
    for s in range(2):
        w_s = get_ref_pos_compact(
            arrays, work[s * half : (s + 1) * half], np, mo, m2=M2
        )
        for kk in ("unitig_id", "unitig_len", "pos", "mt"):
            np.testing.assert_array_equal(
                merged[kk][s * half : (s + 1) * half], w_s[kk],
                err_msg=f"shard{s}:{kk}",
            )

    # validate_self through the sharded query (the >HBM invariant)
    validate_k2u_self_sharded(qf, kc, batch=1024)


def _compact_sharded_case(
    us, u2, refs, mesh_shape, n=4096, seed=13, plim=3,
    bucket_inline=False, useqrec=False,
):
    """Capacity-tier (direct engine + packed pos) sharded query vs the
    single-device padded oracle: k2u fields and the full projected
    occurrence block must match lane-for-lane."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.index.modindex import (
        ModIndex,
        get_ref_pos_padded,
        merge_compact_k2u,
    )
    from mazu_tpu.kmer import revcomp
    from mazu_tpu.kphf.sshash import SSHash
    from mazu_tpu.parallel.sharding import make_compact_sharded_query

    ss = SSHash.from_unitig_set(
        us, w=15, skew_param=8, engine="direct", bucket_load=0.5
    )
    idx = ModIndex(ss, u2, refs, index_type="t")
    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(seed)
    work = np.tile(kms, -(-n // len(kms)))[:n]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], idx.k)
    miss = rng.random(n) < 0.05
    work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
    rng.shuffle(work)

    mo = max(1, idx.max_occs())
    host = {
        "k2u": ss.device_arrays(prefix_kind="flat32", pos_kind="packed"),
        "u2pos": u2.device_arrays(),
        "refs": refs.device_arrays(),
        "meta": idx.device_arrays(pos_kind="packed", prefix_kind="flat32")["meta"],
    }
    want = get_ref_pos_padded(host, work, np, mo)

    mesh = Mesh(
        np.array(jax.devices()[:8]).reshape(*mesh_shape), ("data", "bucket")
    )
    M2 = max(256, n // 4)
    qf = make_compact_sharded_query(
        idx, mesh, m2=M2, probe_limit=plim, defer_valid=True, max_occs=mo,
        bucket_inline=bucket_inline, useqrec=useqrec,
    )
    got = jax.tree_util.tree_map(np.asarray, qf(jnp.asarray(work)))
    assert not bool(got["over_budget"].any())

    # ---- per-lane k2u fields (phases merged)
    n_data = mesh_shape[0]
    if n_data == 1:
        merged = merge_compact_k2u(got, np)
        for kk in ("unitig_id", "pos", "mt"):
            np.testing.assert_array_equal(merged[kk], want[kk], err_msg=kk)
        # ---- full occurrence block: main width-2 + phase-2 width-mo
        gid = np.zeros((n, mo), dtype=want["ref_id"].dtype)
        gpos = np.zeros((n, mo), dtype=want["ref_pos"].dtype)
        gval = np.zeros((n, mo), dtype=bool)
        m_ = got["main"]
        gid[:, :2], gpos[:, :2] = m_["ref_id"], m_["ref_pos"]
        gval[:, :2] = m_["valid"]
        real = got["slot_real"]
        lanes = got["lanes"][real]
        p2 = got["phase2"]
        gid[lanes] = p2["ref_id"][real]
        gpos[lanes] = p2["ref_pos"][real]
        gval[lanes] = p2["valid"][real]
        wv = want["valid"]
        np.testing.assert_array_equal(gval, wv)
        np.testing.assert_array_equal(
            np.where(wv, gid, 0), np.where(wv, want["ref_id"], 0)
        )
        np.testing.assert_array_equal(
            np.where(wv, gpos, 0), np.where(wv, want["ref_pos"], 0)
        )
    else:
        # data-sharded: phase-2 lane blocks are local to each data shard;
        # rebase them to global lanes, then merge and compare
        M2g = got["slot_real"].shape[0] // n_data
        half = n // n_data
        merged = {kk: got["main"][kk].copy() for kk in ("unitig_id", "pos", "mt")}
        for s in range(n_data):
            sl = slice(s * M2g, (s + 1) * M2g)
            real = got["slot_real"][sl]
            lanes = got["lanes"][sl][real] + s * half
            for kk in merged:
                merged[kk][lanes] = got["phase2"][kk][sl][real]
        for kk in ("unitig_id", "pos", "mt"):
            np.testing.assert_array_equal(merged[kk], want[kk], err_msg=kk)
    return idx


def test_compact_sharded_query_matches_single_chip():
    """Bucket-sharded CAPACITY tier (direct + packed pos — the multi-Gbp
    layout): exact vs the padded oracle on 1x8 and 2x4 meshes."""

    spt = _chr_spt()
    us, u2, refs = spt.unitigs, spt.piscem_table(), spt.ref_seq_collection()
    _compact_sharded_case(us, u2, refs, (1, 8))
    _compact_sharded_case(us, u2, refs, (2, 4), plim=2)


def test_compact_sharded_bpos_useqrec_matches():
    """Round 5: the committed fastest capacity layout —
    sharded bpos bucket-inline rows + replicated useqrec window records
    (the 8.1M single-chip config) — deployed across bucket shards, exact
    vs the padded oracle on 1x8 and 2x4 meshes. Also covers bpos WITHOUT
    useqrec (generic probe + bpos pos window)."""

    spt = _chr_spt()
    us, u2, refs = spt.unitigs, spt.piscem_table(), spt.ref_seq_collection()
    _compact_sharded_case(
        us, u2, refs, (1, 8), plim=2, bucket_inline=True, useqrec=True
    )
    _compact_sharded_case(
        us, u2, refs, (2, 4), plim=3, bucket_inline=True, useqrec=True
    )
    _compact_sharded_case(
        us, u2, refs, (1, 8), plim=3, bucket_inline=True, useqrec=False
    )


def test_compact_sharded_checkpoint_roundtrip(tmp_path):
    """>HBM deployment for the CAPACITY tier: save a bucket-sharded
    compact checkpoint (direct engine + packed pos), load with per-device
    placement, and answer identically to the padded oracle."""
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.index.modindex import (
        ModIndex,
        get_ref_pos_padded,
        merge_compact_k2u,
    )
    from mazu_tpu.io.sharded_ckpt import (
        load_shard,
        make_compact_sharded_query_from_ckpt,
        save_compact_sharded,
    )
    from mazu_tpu.kmer import revcomp
    from mazu_tpu.kphf.sshash import SSHash

    spt = _chr_spt()
    us, u2, refs = spt.unitigs, spt.piscem_table(), spt.ref_seq_collection()
    ss = SSHash.from_unitig_set(
        us, w=15, skew_param=8, engine="direct", bucket_load=0.5
    )
    idx = ModIndex(ss, u2, refs, index_type="t")
    ck = str(tmp_path / "compact_shards")
    save_compact_sharded(ck, idx, n_shards=8)
    s0 = load_shard(ck, 0)
    assert s0["flat2"].shape[0] * 8 >= ss.direct_T  # partial shard files

    mesh = Mesh(np.array(jax.devices()[:8]).reshape(1, 8), ("data", "bucket"))
    qf = make_compact_sharded_query_from_ckpt(ck, mesh, m2=1024, probe_limit=3)

    kms = us.get_kmer_u64(us.kmer_start_positions())
    rng = np.random.default_rng(31)
    n = 2048
    work = np.tile(kms, -(-n // len(kms)))[:n]
    flip = rng.random(n) < 0.5
    work[flip] = revcomp(work[flip], idx.k)
    miss = rng.random(n) < 0.05
    work[miss] = rng.integers(0, 1 << 62, int(miss.sum()), dtype=np.uint64)
    got = jax.tree_util.tree_map(np.asarray, qf(jnp.asarray(work)))
    assert not got["over_budget"].any()
    merged = merge_compact_k2u(got, np)
    host = {
        "k2u": ss.device_arrays(prefix_kind="flat32", pos_kind="packed"),
        "u2pos": u2.device_arrays(),
        "refs": refs.device_arrays(),
        "meta": idx.device_arrays(pos_kind="packed", prefix_kind="flat32")["meta"],
    }
    want = get_ref_pos_padded(host, work, np, max(1, idx.max_occs()))
    for kk in ("unitig_id", "pos", "mt"):
        np.testing.assert_array_equal(merged[kk], want[kk], err_msg=kk)

    # round 5: the gather-op-diet layout (sharded bpos + replicated
    # useqrec — the committed 8.1M single-chip config) persists and
    # loads through the same ckpt path, wired from file presence alone
    ck2 = str(tmp_path / "compact_shards_bpos")
    save_compact_sharded(ck2, idx, n_shards=8, bucket_inline=True, useqrec=True)
    s0b = load_shard(ck2, 0)
    assert "bpos" in s0b and s0b["bpos"].shape[1] == 4
    qf2 = make_compact_sharded_query_from_ckpt(ck2, mesh, m2=1024, probe_limit=2)
    got2 = jax.tree_util.tree_map(np.asarray, qf2(jnp.asarray(work)))
    assert not got2["over_budget"].any()
    merged2 = merge_compact_k2u(got2, np)
    for kk in ("unitig_id", "pos", "mt"):
        np.testing.assert_array_equal(merged2[kk], want[kk], err_msg=kk)


@pytest.mark.slow
def test_g3_sharded_real_ckpt():
    """Round-4 task 7: the REAL 3Gbp direct-engine checkpoint sharded
    across the 8-device CPU mesh, end-to-end from files (the >HBM
    human-genome deployment). Skips when the 21.7GB ckpt is not on disk
    (labs/host_gbp_build.py builds it; labs/host_g3_sharded_proof.py is
    the proof run)."""
    import os
    import subprocess
    import sys

    ck = os.path.join(os.path.dirname(__file__), "..", ".ckpts", "g3_direct_w19.npz")
    if not os.path.exists(ck):
        pytest.skip("3Gbp direct ckpt not built on this machine")
    lab = os.path.join(
        os.path.dirname(__file__), "..", "labs", "host_g3_sharded_proof.py"
    )
    env = dict(os.environ, MAZU_G3S_SAMP="15")  # 32K samples: ~CI-sized
    r = subprocess.run(
        [sys.executable, lab], env=env, capture_output=True, text=True,
        timeout=7200,
    )
    assert r.returncode == 0, r.stdout[-2000:] + r.stderr[-2000:]
    assert "EXACT" in r.stdout and "foreign misses clean" in r.stdout
