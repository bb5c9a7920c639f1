"""Human-scale (3Gbp) sharded deployment proof, END-TO-END FROM FILES.

The 3Gbp DIRECT-engine index (21.7GB ckpt, 34.5 bits/kmer) does not fit
one device's memory — it is the >HBM tier. This script proves the whole
sharded deployment flow on the REAL artifact, not a toy:

  .ckpts/g3_direct_w19.npz
    -> save_compact_sharded (8 bucket shards on disk)
    -> make_compact_sharded_query_from_ckpt over a (1, 8) CPU mesh
       (per-device placement straight from the shard files)
    -> 2^SAMP uniform fw+rc samples EXACT vs ground truth + foreign
       misses clean, through the full sharded two-phase query.

Usage:  timeout 7200 python host_g3_sharded_proof.py [ckpt] [shard_dir]
Env:    MAZU_G3S_SAMP (default 17 -> 131072 samples), MAZU_G3S_SHARDS (8),
        MAZU_G3S_BPOS/MAZU_G3S_USREC=1 (round 5: persist + query the
        bpos+useqrec gather-op-diet layout — legal only for total_len <
        2^31, i.e. the 1Gbp tier; 3Gbp shards keep the lean layout),
        MAZU_G3S_PLIM (3)

The same flow at fixture scale is tests/test_parallel.py
test_compact_sharded_ckpt_*; the slow-marked test_g3_sharded_real_ckpt
re-runs THIS proof when the ckpt is on disk.
"""

import _bootstrap  # noqa: F401

import os
import sys
import time

import numpy as np


def main():
    os.environ["JAX_PLATFORMS"] = "cpu"
    os.environ.setdefault(
        "XLA_FLAGS", "--xla_force_host_platform_device_count=8"
    )
    import jax

    jax.config.update("jax_platforms", "cpu")
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.index.modindex import merge_compact_k2u
    from mazu_tpu.io.checkpoint import load_index
    from mazu_tpu.io.sharded_ckpt import (
        load_manifest,
        load_shard,
        make_compact_sharded_query_from_ckpt,
        save_compact_sharded,
    )
    from mazu_tpu.kmer import revcomp

    ck = sys.argv[1] if len(sys.argv) > 1 else "/root/repo/.ckpts/g3_direct_w19.npz"
    sd = sys.argv[2] if len(sys.argv) > 2 else "/root/repo/.ckpts/g3_shards"
    n_shards = int(os.environ.get("MAZU_G3S_SHARDS", 8))

    bpos = os.environ.get("MAZU_G3S_BPOS") == "1"
    usrec = os.environ.get("MAZU_G3S_USREC") == "1"
    if not os.path.isdir(sd):
        t0 = time.time()
        index = load_index(ck)
        print(f"loaded {ck} in {time.time()-t0:.0f}s", flush=True)
        t0 = time.time()
        save_compact_sharded(
            sd, index, n_shards=n_shards, bucket_inline=bpos, useqrec=usrec
        )
        sz = sum(
            os.path.getsize(os.path.join(sd, f)) for f in os.listdir(sd)
        )
        print(
            f"sharded ckpt {sd}: {n_shards} shards, {sz/1e9:.2f} GB on disk "
            f"in {time.time()-t0:.0f}s",
            flush=True,
        )
        unitigs, k = index.k2u.unitigs, index.k
        del index
    else:
        print(f"reusing shard dir {sd}")
        t0 = time.time()
        index = load_index(ck)
        unitigs, k = index.k2u.unitigs, index.k
        del index
        print(f"(ground-truth source {ck} loaded in {time.time()-t0:.0f}s)")

    per_shard = {}
    for s in range(n_shards):
        sh = load_shard(sd, s)
        per_shard[s] = sum(v.nbytes for v in sh.values()) / 1e9
    print(
        "per-shard bytes (GB): "
        + ", ".join(f"s{s}={b:.2f}" for s, b in per_shard.items()),
        flush=True,
    )

    mesh = Mesh(np.array(jax.devices()[:n_shards]).reshape(1, n_shards), ("data", "bucket"))
    B = 1 << int(os.environ.get("MAZU_G3S_SAMP", 17))
    t0 = time.time()
    qf = make_compact_sharded_query_from_ckpt(
        sd, mesh, m2=max(4096, B // 4),
        probe_limit=int(os.environ.get("MAZU_G3S_PLIM", 3)),
    )
    print(f"mesh placement + query build {time.time()-t0:.0f}s", flush=True)

    PIECE = 10_000
    rng = np.random.default_rng(0)
    upos = rng.integers(0, PIECE - k + 1, B)
    uid = rng.integers(0, unitigs.n_unitigs, B)
    kms = unitigs.useq.get_kmer_u64(uid * PIECE + upos, k)
    flip = rng.random(B) < 0.5
    kms[flip] = revcomp(kms[flip], k)

    t0 = time.time()
    got = jax.tree_util.tree_map(np.asarray, qf(jnp.asarray(kms)))
    assert not got["over_budget"].any(), "sharded phase-2 capacity exceeded"
    merged = merge_compact_k2u(got, np)
    assert (merged["mt"] > 0).all(), f"missed {(merged['mt']==0).sum()}"
    np.testing.assert_array_equal(merged["unitig_id"], uid)
    np.testing.assert_array_equal(merged["pos"], upos)
    print(
        f"EXACT: {B} uniform fw+rc samples through the 8-shard query "
        f"in {time.time()-t0:.0f}s (compile+first included)",
        flush=True,
    )
    fo = jax.tree_util.tree_map(
        np.asarray, qf(jnp.full(B, np.uint64(0x3FF3FF3FF3FF3FF), jnp.uint64))
    )
    fm = merge_compact_k2u(fo, np)
    assert (fm["mt"] == 0).all(), "foreign k-mers must miss"
    print("foreign misses clean", flush=True)
    man = load_manifest(sd)
    print(
        f'{{"metric": "g3_sharded_cpu_mesh_exact", "value": {B}, '
        f'"unit": "samples", "shards": {man["n_shards"]}}}'
    )


if __name__ == "__main__":
    main()
