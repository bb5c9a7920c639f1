"""tuned_query_config: the per-tier knobs must (a) pick the
right tier by engine/scale and (b) produce kwargs that run EXACTLY through
the real drivers."""

import numpy as np
import pytest

from mazu_tpu.index.tuning import tuned_query_config


@pytest.fixture(scope="module")
def chr7_direct():
    """Seeded index: 256 unitigs of 500 bases with planted heavy and
    mid-depth minimizer buckets (mazu_tpu.synth.toy_spt)."""
    from mazu_tpu.synth import toy_index

    return toy_index(n_seqs=256, seq_len=500, skew_param=4)


def test_speed_tier_default(chr7_direct):
    cfg = tuned_query_config(chr7_direct.k2u, hbm_budget=int(8e9))
    assert cfg.tier == "speed"
    assert cfg.arrays_kwargs() == {"fused": True, "pos_kind": "inline2"}
    assert cfg.fused and cfg.probe_limit == 2


def test_budget_needs_a_device_limit(chr7_direct, monkeypatch):
    """No memory stats (the CPU backend) and no explicit budget: the tuner
    refuses instead of assuming some device's memory size."""
    monkeypatch.delenv("MAZU_HBM_BUDGET", raising=False)
    with pytest.raises(ValueError, match="no memory limit"):
        tuned_query_config(chr7_direct.k2u)
    monkeypatch.setenv("MAZU_HBM_BUDGET", "8e9")
    assert tuned_query_config(chr7_direct.k2u).tier == "speed"


def test_mono_tier():
    class FakeKC:
        slot_words = 7

    assert tuned_query_config(FakeKC()).tier == "mono"


def test_capacity_tier_exact(chr7_direct):
    """Force the capacity tier with a tiny budget; the returned kwargs must
    run get_ref_pos_compact EXACTLY equal to the padded oracle."""
    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.modindex import get_ref_pos_compact, get_ref_pos_padded

    idx = chr7_direct
    cfg = tuned_query_config(idx.k2u, hbm_budget=1 << 20)
    assert cfg.tier == "capacity"
    assert cfg.pos_kind == "packed"
    assert cfg.prefix_kind in ("flat32", "grouped16")
    assert cfg.defer_valid
    assert cfg.probe_limit == 3  # w=15: deep merged buckets

    arrays = jax.device_put(idx.device_arrays(**cfg.arrays_kwargs()))
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions()[:4096])
    rng = np.random.default_rng(0)
    kms[::7] = rng.integers(0, 1 << 62, len(kms[::7]), dtype=np.uint64)  # misses
    mo = max(1, idx.max_occs())
    out = get_ref_pos_compact(
        arrays, jnp.asarray(kms), jnp, mo, m2=2048, **cfg.query_kwargs()
    )
    want = get_ref_pos_padded(arrays, jnp.asarray(kms), jnp, mo)
    assert not bool(out["over_budget"])
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(v, np.asarray(out["valid"]))
    for key in ("n_occs",):
        np.testing.assert_array_equal(
            np.asarray(out[key]), np.asarray(want[key]), err_msg=key
        )
    for key in ("ref_id", "ref_pos", "orient"):
        a, b = np.asarray(want[key]), np.asarray(out[key])
        np.testing.assert_array_equal(
            np.where(v, a, 0), np.where(v, b, 0), err_msg=key
        )


def test_compact_query_driver_equals_twophase(chr7_direct):
    """ReadMapper's capacity-tier driver (CompactQuery with the tuned
    knobs) must answer identically to the speed-tier fused two-phase."""
    from mazu_tpu.index.mapping import CompactQuery
    from mazu_tpu.index.twophase import TwoPhaseIndexQuery

    idx = chr7_direct
    cfg = tuned_query_config(idx.k2u, hbm_budget=1 << 20)
    cq = CompactQuery(idx, cfg)
    tp = TwoPhaseIndexQuery(idx)
    us = idx.k2u.unitigs
    kms = np.asarray(us.get_kmer_u64(us.kmer_start_positions()[:1500]))
    rng = np.random.default_rng(2)
    kms[::5] = rng.integers(0, 1 << 62, len(kms[::5]), dtype=np.uint64)
    a = cq.get_ref_pos_eager(kms)
    b = tp.get_ref_pos_eager(kms)
    assert len(a) == len(b)
    for x, y in zip(a, b):
        assert (x is None) == (y is None)
        if x is not None:
            assert sorted(x) == sorted(y)


def test_mphf_engine_gets_level_limit(chr7_direct):
    from mazu_tpu.kphf.sshash import SSHash

    us = chr7_direct.k2u.unitigs
    k2u = SSHash.from_unitig_set(us, 15, skew_param=4, engine="fast32")
    cfg = tuned_query_config(k2u, hbm_budget=1 << 20)
    assert cfg.tier == "capacity"
    assert cfg.mphf_level_limit == 4 and cfg.defer_valid


def test_capacity_tier_bpos_useqrec_exact(chr7_direct):
    """Round-4: with room for the bpos + useqrec layouts (but not the
    speed tier) the config picks the gather-op-diet knobs; the returned
    kwargs must run get_ref_pos_compact EXACTLY equal to the padded
    oracle."""
    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.modindex import get_ref_pos_compact, get_ref_pos_padded

    idx = chr7_direct
    budget = 2_800_000  # fits lean+bpos+useqrec (1.76MB), NOT the 2.5MB speed rows
    cfg = tuned_query_config(idx.k2u, hbm_budget=budget)
    assert cfg.tier == "capacity", cfg.why
    assert cfg.useqrec and cfg.bucket_inline, cfg.why
    assert cfg.probe_limit2 == cfg.probe_limit + 2

    arrays = jax.device_put(idx.device_arrays(**cfg.arrays_kwargs()))
    assert "bpos" in arrays["k2u"] and "useqrec" in arrays["k2u"]["us"]
    us = idx.k2u.unitigs
    kms = us.get_kmer_u64(us.kmer_start_positions()[:4096])
    rng = np.random.default_rng(1)
    kms[::7] = rng.integers(0, 1 << 62, len(kms[::7]), dtype=np.uint64)
    mo = max(1, idx.max_occs())
    out = get_ref_pos_compact(
        arrays, jnp.asarray(kms), jnp, mo, m2=2048, m2b=2048, m2c=1024,
        **cfg.query_kwargs(),
    )
    want = get_ref_pos_padded(arrays, jnp.asarray(kms), jnp, mo)
    assert not bool(out["over_budget"])
    v = np.asarray(want["valid"])
    np.testing.assert_array_equal(v, np.asarray(out["valid"]))
    np.testing.assert_array_equal(
        np.asarray(out["n_occs"]), np.asarray(want["n_occs"])
    )
    for key in ("ref_id", "ref_pos", "orient"):
        a, b = np.asarray(want[key]), np.asarray(out[key])
        np.testing.assert_array_equal(
            np.where(v, a, 0), np.where(v, b, 0), err_msg=key
        )


@pytest.mark.slow
def test_tuned_config_real_ckpts():
    """On the prebuilt checkpoints that bench.py's capacity tiers read from
    ``.ckpts/`` (not in the repo; skips without them) the tier rules hold under
    a stated 8.9 GB device budget: the 1 Gbp w=17 index takes the capacity
    tier with bpos+useqrec at plim=3/p2=5; the 300 Mbp index fits the speed
    tier's inline2 rows."""
    import os as _os

    from mazu_tpu.io.checkpoint import load_index

    budget = int(8.9e9)  # too small for 1 Gbp of 21 B/k-mer rows
    ck1 = ".ckpts/g1_direct_w17_L2.npz"
    ck3 = ".ckpts/bench_capacity_300m.npz"
    if not (_os.path.exists(ck1) and _os.path.exists(ck3)):
        pytest.skip("real ckpts not on disk")
    cfg1 = tuned_query_config(load_index(ck1).k2u, hbm_budget=budget)
    assert cfg1.tier == "capacity" and cfg1.bucket_inline and cfg1.useqrec
    assert cfg1.probe_limit == 3 and cfg1.probe_limit2 == 5, cfg1.why
    cfg3 = tuned_query_config(load_index(ck3).k2u, hbm_budget=budget)
    assert cfg3.tier == "speed", cfg3.why
