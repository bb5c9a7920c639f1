"""Host-side Gbp-scale index build + checkpoint (run once, query many).

Builds the synthetic genome + fast32 compact-tier SSHash and saves an
uncompressed .npz checkpoint that ``mazu_tpu.io.checkpoint.load_index``
reads back — a Gbp build takes tens of minutes, so it is built once and
queried many times.

Usage: MALLOC_MMAP_MAX_=0 MALLOC_TRIM_THRESHOLD_=-1 \
       python host_gbp_build.py <n_bases> <out.npz> [skew]
"""

import _bootstrap  # noqa: F401  (repo root on sys.path)

import os
import sys
import time

import numpy as np


def main():
    os.environ.setdefault("MAZU_BUILD_TIMING", "1")
    nb = int(sys.argv[1])
    out = sys.argv[2]
    skew = int(sys.argv[3]) if len(sys.argv) > 3 else 64

    from mazu_tpu.synth import genome_parts
    from mazu_tpu.index.modindex import ModIndex
    from mazu_tpu.io.checkpoint import save_index
    from mazu_tpu.kphf.sshash import SSHash

    t0 = time.time()
    unitigs, refs, u2pos = genome_parts(nb)
    print(f"synth {nb/1e9:.2f}Gbp in {time.time()-t0:.0f}s", flush=True)
    t0 = time.time()
    engine = os.environ.get("MAZU_GBP_ENGINE", "fast32")
    load = float(os.environ.get("MAZU_GBP_LOAD", 0.5))
    # minimizer width must scale with the genome: at 3Gbp w=15's value
    # space (4^15 = 1.07e9) is comparable to the occurrence count, so
    # buckets deepen ~10x and shallow probes stop covering. w≈log4(N)+5
    # (21 at 3Gbp) keeps the bucket-depth distribution at its small-genome
    # shape, at the cost of ~1.5x more (shorter) super-k-mers.
    w = int(os.environ.get("MAZU_GBP_W", 15))
    kw = {"bucket_load": load} if engine == "direct" else {}
    k2u = SSHash.from_unitig_set(
        unitigs, w=w, skew_param=skew, engine=engine, **kw
    )
    print(
        f"{engine} build {time.time()-t0:.0f}s: bits/kmer="
        f"{k2u.num_bits()/k2u.n_kmers:.2f}",
        flush=True,
    )
    index = ModIndex(k2u, u2pos, refs, index_type="Piscem-synth")
    t0 = time.time()
    save_index(index, out, compress=False)
    print(f"checkpoint {out} ({os.path.getsize(out)/1e9:.2f} GB) in {time.time()-t0:.0f}s")


if __name__ == "__main__":
    main()
