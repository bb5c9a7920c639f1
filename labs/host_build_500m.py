"""500Mbp end-to-end host build proof.

Run: timeout 1800 python host_build_500m.py > /tmp/build500m.out 2>&1
"""

import _bootstrap  # noqa: F401  (repo root on sys.path)
import os
import time

os.environ["JAX_PLATFORMS"] = "cpu"
os.environ.setdefault("MAZU_BUILD_TIMING", "1")
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402

from mazu_tpu.synth import genome_parts  # noqa: E402
from mazu_tpu.kmer import revcomp  # noqa: E402
from mazu_tpu.kphf.sshash import SSHash, sshash_k2u  # noqa: E402


def main():
    bases = int(os.environ.get("MAZU_PROOF_BASES", 500_000_000))
    load = float(os.environ.get("MAZU_PROOF_LOAD", 0.5))
    skew = int(os.environ.get("MAZU_PROOF_SKEW", 8))
    T0 = time.time()
    t0 = time.time()
    unitigs, refs, u2pos = genome_parts(bases)
    print(f"[synth {bases/1e6:.0f}Mbp] {time.time()-t0:.1f}s", flush=True)
    t1 = time.time()
    k2u = SSHash.from_unitig_set(
        unitigs, w=15, skew_param=skew, engine="direct", bucket_load=load
    )
    print(
        f"[sshash direct load={load}] {time.time()-t1:.1f}s T={k2u.direct_T} "
        f"occs={k2u.pos.length} bits/kmer={k2u.num_bits()/k2u.n_kmers:.1f}",
        flush=True,
    )
    t2 = time.time()
    rng = np.random.default_rng(0)
    d = k2u.device_arrays()
    print(f"[device_arrays] {time.time()-t2:.1f}s", flush=True)
    t3 = time.time()
    ok = 0
    tot = 0
    for ri in rng.choice(unitigs.n_unitigs, 20, replace=False):
        kms = refs.ref_kmers(int(ri), 31)[:100000]
        flip = rng.random(len(kms)) < 0.5
        kms = kms.copy()
        kms[flip] = revcomp(kms[flip], 31)
        r = sshash_k2u(d, kms, np)
        ok += int((r["mt"] > 0).sum())
        tot += len(kms)
    print(f"[sampled validate] {ok}/{tot} hits in {time.time()-t3:.1f}s", flush=True)
    assert ok == tot
    print(f"[END-TO-END {bases/1e6:.0f}Mbp] {time.time()-T0:.1f}s", flush=True)


if __name__ == "__main__":
    main()
