"""Profile the fast32 (compact-tier) SSHash build stages at synthetic scale.

Host-only (no jax): python host_fast32_profile.py [n_bases]
Used to find what dominates Gbp-scale builds (the MPHF stage, at 1 Gbp)
before a 3 Gbp human-scale run.
"""

import _bootstrap  # noqa: F401  (repo root on sys.path)

import os
import sys
import time

import numpy as np

os.environ.setdefault("MAZU_BUILD_TIMING", "1")


def main():
    nb = int(sys.argv[1]) if len(sys.argv) > 1 else 200_000_000
    from mazu_tpu.synth import genome_parts

    t0 = time.time()
    unitigs, refs, u2pos = genome_parts(nb)
    print(f"synth {nb/1e6:.0f}Mbp: {time.time()-t0:.1f}s", flush=True)
    from mazu_tpu.kphf.sshash import SSHash

    t0 = time.time()
    k2u = SSHash.from_unitig_set(
        unitigs, w=15, skew_param=int(os.environ.get("MAZU_GBP_SKEW", 64)),
        engine="fast32",
    )
    print(
        f"fast32 build: {time.time()-t0:.1f}s bits/kmer="
        f"{k2u.num_bits()/k2u.n_kmers:.2f}",
        flush=True,
    )
    t0 = time.time()
    d = k2u.device_arrays(prefix_kind="ef", pos_kind="packed")
    from mazu_tpu.pytree import tree_bytes

    print(
        f"device_arrays(ef,packed): {time.time()-t0:.1f}s "
        f"{tree_bytes(d)/1e9:.3f} GB",
        flush=True,
    )
    t0 = time.time()
    d2 = k2u.device_arrays(prefix_kind="flat32", pos_kind="packed")
    print(
        f"device_arrays(flat32,packed): {time.time()-t0:.1f}s "
        f"{tree_bytes(d2)/1e9:.3f} GB",
        flush=True,
    )
    # per-component accounting
    for name, sub in d.items():
        if isinstance(sub, dict):
            b = tree_bytes(sub)
            print(f"  {name}: {b/1e6:.1f} MB")


if __name__ == "__main__":
    main()
