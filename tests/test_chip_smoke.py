"""chip_smoke.py's phases at a tiny size on the CPU (the script's main()
refuses any platform but a GPU; its phases are plain functions)."""

import os
import sys

import numpy as np
import pytest

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

import chip_smoke as cs  # noqa: E402


def test_branches_phase():
    cs.phase_branches(seed=0)


def test_scale_phase_tiny(capsys, monkeypatch):
    monkeypatch.setenv("MAZU_HBM_BUDGET", "8e9")  # the CPU reports no limit
    cs.phase_scale(seed=1, bases=200_000, batch=4096, chunks=2, iters=1, interpret=True)
    out = capsys.readouterr().out
    for tag in ("[scale/speed] hits: exact", "[scale/speed] reads:",
                "[scale/mono2] misses10: exact", "[scale/onegraph] checksum exact",
                "[kernels] mono2 probe"):
        assert tag in out, tag


def test_compact_kernel_contest_tiny(capsys, monkeypatch):
    """The CompactQuery contest with the platform taken for a GPU and the
    kernel in interpret mode: the mapper's kernel graph equals the XLA one."""
    from functools import partial

    import jax

    from mazu_tpu.index.mapping import ReadMapper
    from mazu_tpu.ops import mono2_probe
    from mazu_tpu.synth import kmer_workload, toy_index

    monkeypatch.setattr(jax, "default_backend", lambda: "gpu")
    monkeypatch.setattr(mono2_probe, "mono2_probe_k2u",
                        partial(mono2_probe.mono2_probe_k2u, interpret=True))
    idx = toy_index(engine="mono2", seed=4)
    mapper = ReadMapper(idx, batch=2048)
    work = kmer_workload(idx.k2u.unitigs, 2048, seed=4, miss_frac=0.1)
    cs.compact_kernel_contest(mapper, idx, work, iters=1)
    assert "[kernels] CompactQuery, 2048 lanes" in capsys.readouterr().out


def test_cards_phase_tiny():
    cs.phase_cards(4, seed=2, bases=200_000, batch=4096)


def test_cut_reads_positions():
    """Reads cut from the genome: forward reads' k-mers sit at off + j,
    reverse-complemented reads' at off + (n_windows - 1) - j."""
    from mazu_tpu.kmer import revcomp, seq_to_codes
    from mazu_tpu.synth import genome_parts

    unitigs, refs, _ = genome_parts(50_000, seed=3)
    k = unitigs.k
    reads, ref, pos, orient, words = cs.cut_reads(refs, 6, seed=3, k=k)
    nk = cs.READ_LEN - k + 1
    assert len(words) == 6 * nk and set(orient[:nk]) == {1} and set(orient[nk : 2 * nk]) == {0}
    fw = refs.seq.get_kmer_u64(refs.prefix_sum[ref] + pos, k)
    np.testing.assert_array_equal(np.where(orient == 1, fw, revcomp(fw, k)), words)
    assert all(len(r) == cs.READ_LEN and set(seq_to_codes(r)) <= {0, 1, 2, 3} for r in reads)


def test_assert_padded_equal_catches_a_wrong_position():
    from mazu_tpu.index.modindex import get_ref_pos_padded
    from mazu_tpu.synth import kmer_workload, toy_index

    idx = toy_index()
    work = kmer_workload(idx.k2u.unitigs, 256, seed=0)
    want = get_ref_pos_padded(idx.device_arrays(), work, np, idx.max_occs())
    cs.assert_padded_equal(want, want, "same")
    bad = dict(want, ref_pos=want["ref_pos"] + want["valid"])
    with pytest.raises(AssertionError, match="ref_pos"):
        cs.assert_padded_equal(bad, want, "shifted")
