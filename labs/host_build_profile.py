"""Profile the host-side index build at scale (CPU only).

Times the synthetic build stages at a given scale (default 50 Mbp) to find
what must be parallelized for the 500 Mbp target.

Run: MAZU_PROFILE_BASES=50000000 python host_build_profile.py
"""

import _bootstrap  # noqa: F401  (repo root on sys.path)
import os
import time

os.environ["JAX_PLATFORMS"] = "cpu"
import jax

jax.config.update("jax_platforms", "cpu")

import numpy as np  # noqa: E402


def main():
    bases = int(os.environ.get("MAZU_PROFILE_BASES", 50_000_000))
    import cProfile
    import pstats

    from mazu_tpu.synth import genome_parts

    t0 = time.time()
    unitigs, refs, u2pos = genome_parts(bases)
    t1 = time.time()
    print(f"[synth gen + pack + spt] {t1-t0:.1f}s")

    from mazu_tpu.kphf.sshash import SSHash

    prof = cProfile.Profile()
    prof.enable()
    k2u = SSHash.from_unitig_set(
        unitigs, w=15, skew_param=4, engine="direct", bucket_load=0.0625
    )
    prof.disable()
    t2 = time.time()
    print(f"[sshash build] {t2-t1:.1f}s total={t2-t0:.1f}s")
    stats = pstats.Stats(prof)
    stats.sort_stats("cumulative").print_stats(25)


if __name__ == "__main__":
    main()
