""">HBM sharded deployment proof at 50Mbp.

Builds the 50Mbp synthetic mono2 L=0.25 index (7.67GB of device arrays —
OOMs a single bench chip), writes a 4-shard mono checkpoint, loads it onto
a 2x4 CPU mesh with per-device placement (no full-index materialization on
any one device), and validates a 128K-position random sample fw+rc against
ground truth THROUGH the sharded full query, plus foreign-k-mer misses.

Run: timeout 3000 python host_sharded50m_proof.py
"""

import _bootstrap  # noqa: F401  (repo root on sys.path)
import os
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ["XLA_FLAGS"] = "--xla_force_host_platform_device_count=8"
import jax  # noqa: E402

jax.config.update("jax_platforms", "cpu")
jax.config.update("jax_enable_x64", True)

import numpy as np  # noqa: E402


def log(*a):
    import sys

    print(f"[{time.strftime('%H:%M:%S')}]", *a, file=sys.stderr, flush=True)


def main():
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.synth import genome_parts
    from mazu_tpu.index.modindex import ModIndex
    from mazu_tpu.index.validate import merge_sharded_out
    from mazu_tpu.io.sharded_ckpt import (
        make_mono_sharded_query_from_ckpt,
        save_mono_sharded,
    )
    from mazu_tpu.kmer import revcomp
    from mazu_tpu.kphf.kcdict import KCDict
    from mazu_tpu import MATCH_IDENTITY, MATCH_TWIN

    t0 = time.time()
    unitigs, refs, u2pos = genome_parts(50_000_000)
    log(f"synthetic 50Mbp: {unitigs.n_kmers} kmers ({time.time()-t0:.0f}s)")

    t0 = time.time()
    k2u = KCDict.from_unitig_set(unitigs, occ_table=u2pos, scheme="mono2", load=0.25)
    idx = ModIndex(k2u, u2pos, refs, index_type="Piscem-sharded-proof")
    log(
        f"mono2 L=0.25 built: buckets={k2u.T} occ32={k2u.occ32} "
        f"({time.time()-t0:.0f}s)"
    )

    ckpt = "/tmp/sharded50m_ckpt"
    t0 = time.time()
    save_mono_sharded(ckpt, idx, n_shards=4)
    sz = sum(
        os.path.getsize(os.path.join(ckpt, f)) for f in os.listdir(ckpt)
    )
    log(f"4-shard checkpoint written: {sz/2**30:.2f} GiB ({time.time()-t0:.0f}s)")

    # drop the monolithic table before mesh placement (deployment never
    # holds the full index on one device/host)
    del k2u.table, idx
    import gc

    gc.collect()

    B = 8192
    mesh = Mesh(np.array(jax.devices()[:8]).reshape(2, 4), ("data", "bucket"))
    t0 = time.time()
    qf = make_mono_sharded_query_from_ckpt(ckpt, mesh, m2=2048)
    log(f"checkpoint placed on 2x4 mesh ({time.time()-t0:.0f}s)")

    # ground truth from the unitig tiling (independent of the dictionary)
    rng = np.random.default_rng(9)
    pos_all = unitigs.kmer_start_positions()
    sample = rng.permutation(len(pos_all))[: 128 * 1024]
    pos = pos_all[sample]
    uid_true = unitigs.pos_to_id(pos)
    upos_true = pos - unitigs.accum[uid_true]
    ulen_true = unitigs.unitig_len(uid_true)
    fw = unitigs.get_kmer_u64(pos)
    k = unitigs.k

    t0 = time.time()
    n_checked = 0
    for s in range(0, len(pos), B):
        sl = slice(s, min(s + B, len(pos)))
        n_real = sl.stop - sl.start
        for words, want_mt in (
            (fw[sl], MATCH_IDENTITY),
            (revcomp(fw[sl], k), MATCH_TWIN),
        ):
            padded = np.zeros(B, dtype=np.uint64)
            padded[:n_real] = words
            padded[n_real:] = words[0]
            out = qf(jnp.asarray(padded))
            assert not bool(np.asarray(out["over_budget"]).any())
            r = merge_sharded_out(out)
            ok = (
                (r["mt"][:n_real] == want_mt)
                & (r["unitig_id"][:n_real] == uid_true[sl])
                & (r["pos"][:n_real] == upos_true[sl])
                & (r["unitig_len"][:n_real] == ulen_true[sl])
            )
            assert ok.all(), f"batch {s}: {int((~ok).sum())} mismatches"
            n_checked += n_real
        if s % (16 * B) == 0:
            log(f"  validated {n_checked} queries...")
    log(f"sampled validate: {n_checked} queries exact ({time.time()-t0:.0f}s)")

    # foreign k-mers must miss through the sharded path
    foreign = rng.integers(0, 1 << 62, B, dtype=np.uint64)
    out = qf(jnp.asarray(foreign))
    r = merge_sharded_out(out)
    canon_all = None  # 50M-key membership set is overkill; mt>0 would need
    # the exact k-mer verified in-slot, so ANY hit on random words at this
    # density (~50M/2^61) is a bug
    n_hits = int((r["mt"] > 0).sum())
    assert n_hits == 0, f"foreign k-mers hit: {n_hits}"
    log("foreign-miss probe OK")
    print("SHARDED 50Mbp PROOF OK:", n_checked, "sampled queries exact on 2x4 mesh")


if __name__ == "__main__":
    main()
