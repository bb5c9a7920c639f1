"""The mono2 probe kernel (ops/mono2_probe.py, Pallas through Triton) must
answer exactly as the XLA main phase of kcdict_k2u: in interpret mode
here, compiled on the card under the ``gpu`` marker."""

import functools

import numpy as np
import pytest

from mazu_tpu.kphf.kcdict import kcdict_k2u
from mazu_tpu.ops.mono2_probe import BLK, mono2_probe_k2u, use_mono2_probe
from mazu_tpu.synth import kmer_workload, toy_index


@functools.lru_cache(maxsize=None)
def _index(load=None):
    """The seeded toy index's mono2 KCDict at load 0.25 or ``load``."""
    from mazu_tpu.index.modindex import ModIndex
    from mazu_tpu.kphf.kcdict import KCDict

    idx = toy_index(engine="mono2")
    if load is None:
        return idx
    kc = KCDict.from_unitig_set(idx.k2u.unitigs, occ_table=idx.u2pos, scheme="mono2", load=load)
    return ModIndex(kc, idx.u2pos, idx.refs, index_type="Piscem")


def _check(d, work, interpret):
    import jax
    import jax.numpy as jnp

    got = mono2_probe_k2u(jax.device_put(d), jnp.asarray(work), interpret=interpret)
    want = kcdict_k2u(d, work, np, mode="main")
    assert set(got) == set(want)
    for k in want:
        np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=k)
    return want


@pytest.mark.parametrize("n", [1, BLK - 3, BLK, 2 * BLK + 17])
def test_interpret_matches_xla(n):
    """Padding to the block size: lane counts below, at and past BLK."""
    idx = _index()
    work = kmer_workload(idx.k2u.unitigs, n, seed=n, miss_frac=0.2)
    _check(idx.k2u.device_arrays(), work, interpret=True)


def test_interpret_slot1_and_side_table_lanes():
    """At load 8 most buckets are full: hits in slot 1 and keys displaced
    to the side table (unresolved in the main phase) both occur."""
    idx = _index(load=8.0)
    assert idx.k2u.side is not None and idx.k2u.occ32
    work = kmer_workload(idx.k2u.unitigs, 3 * BLK, seed=4, miss_frac=0.0)
    want = _check(idx.k2u.device_arrays(), work, interpret=True)
    assert want["unresolved"].any() and not want["unresolved"].all()


def test_routing_follows_the_platform():
    import jax.numpy as jnp

    m = _index().k2u.device_arrays()["meta"]
    assert use_mono2_probe(m, jnp, "gpu")
    assert not use_mono2_probe(m, jnp, "cpu")
    assert not use_mono2_probe(m, np, "gpu")  # the NumPy oracle path
    cuckoo = toy_index(engine="cuckoo").k2u.device_arrays()["meta"]
    assert not use_mono2_probe(cuckoo, jnp, "gpu")


@pytest.mark.gpu
def test_compiled_matches_xla(gpu_device):
    idx = _index()
    work = kmer_workload(idx.k2u.unitigs, 4 * BLK + 5, seed=1, miss_frac=0.2)
    _check(idx.k2u.device_arrays(), work, interpret=False)
