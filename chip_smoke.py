#!/usr/bin/env python3
"""Smoke run of the k-mer index on one NVIDIA GPU, through its entry points.

    python chip_smoke.py [--seed S] [--bases N] [--batch B]
    python chip_smoke.py --cards 4 [--seed S] [--bases N] [--batch B]

Everything is built from ``--seed``; nothing is read from disk. Phases:

1. device   - platform, device kind and count, JAX version, and the card's
              name and power limit from nvidia-smi. Anything but a GPU fails.
2. branches - the seeded toy index that plants the hard branches (a heavy
              skew bucket, a mid-depth phase-2B bucket, three-occurrence
              unitigs): the compact query, the OneGraph pass and
              validate_self on the card, element for element against the
              NumPy path.
3. scale    - a seeded random genome of ``--bases`` (default 100 Mbp) served
              by the speed-tier SSHash index (tuned_query_config ->
              CompactQuery; reads through ReadMapper's two-phase driver)
              and by KCDict mono2 at load 0.25 (CompactQuery, also for
              reads, and OneGraphIndexQuery). Each engine takes three
              traffics of ``--batch`` lanes: indexed k-mers, the same with
              10% random misses, and 150 bp reads cut from the genome
              through ReadMapper.map_reads, checked against where they were
              cut. Every output field must equal the host oracle exactly.
4. kernels  - each hand-written kernel of the path against the plain XLA
              version it replaces, exact and timed at 1M lanes on the
              genome's table: alone, through the OneGraph pass and through
              CompactQuery; the prefix sum of the compaction at 1M int32.

``--cards 4`` runs only the multi-device paths (replicated data-parallel,
bucket-sharded fused and mono2 with the one-hot psum merge, all_to_all
routing, checkpoint placement onto the mesh) at the ``--bases`` index, each
compared exactly with the single-device result.

Times printed here are smoke figures of one run, not benchmark metrics.
The last line of a passing run is one JSON object:
{"ok": true, "device": {"platform": "gpu", "kind": ..., "count": ...}}
"""

from __future__ import annotations

import argparse
import json
import subprocess
import sys
import time
from functools import partial

import numpy as np

import mazu_tpu  # noqa: F401  (enables 64-bit mode before any array exists)
from mazu_tpu.index.modindex import get_ref_pos_compact, get_ref_pos_padded
from mazu_tpu.synth import genome_index, genome_parts, kmer_workload, toy_index

READ_LEN = 150
PADDED_FIELDS = ("unitig_id", "unitig_len", "pos", "mt", "n_occs", "valid")
OCC_FIELDS = ("ref_id", "ref_pos", "orient")


def log(*a):
    print(*a, flush=True)


def timed(fn, iters: int) -> float:
    """Seconds per call of ``fn`` in steady state (one warm call first);
    each call ends in ``block_until_ready``."""
    import jax

    jax.block_until_ready(fn())
    t = time.perf_counter()
    for _ in range(iters):
        jax.block_until_ready(fn())
    return (time.perf_counter() - t) / iters


def assert_padded_equal(got, want, label: str):
    """Every field of a merged padded result equals the oracle's; occurrence
    columns are compared where the oracle marks them valid (elsewhere both
    are padding)."""
    got = {k: np.asarray(v) for k, v in got.items()}
    width = np.asarray(want["valid"]).shape[1]
    # the compact merge pads to at least its fused width (2): extra
    # columns must hold no occurrence
    assert not got["valid"][:, width:].any(), f"{label}: occurrence past max_occs"
    got = {k: v[:, :width] if v.ndim == 2 else v for k, v in got.items()}
    for k in PADDED_FIELDS:
        np.testing.assert_array_equal(got[k], np.asarray(want[k]), err_msg=f"{label}: {k}")
    v = np.asarray(want["valid"])
    for k in OCC_FIELDS:
        np.testing.assert_array_equal(
            np.where(v, got[k], 0), np.where(v, np.asarray(want[k]), 0),
            err_msg=f"{label}: {k}",
        )


def nvidia_smi() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, timeout=60, check=True,
    )
    return out.stdout.strip()


def phase_device(cards: int) -> dict:
    import jax

    devs = jax.devices()
    d0 = devs[0]
    info = {"platform": d0.platform, "kind": d0.device_kind, "count": len(devs)}
    log(f"[device] jax {jax.__version__}: {info}")
    if d0.platform != "gpu":
        raise SystemExit(f"[device] no GPU: JAX platform is {d0.platform!r}")
    log(f"[device] nvidia-smi: {nvidia_smi()}")
    if len(devs) < cards:
        raise SystemExit(f"[device] {cards} cards asked for, {len(devs)} present")
    return info


def phase_branches(seed: int) -> None:
    """Toy index with the hard branches planted, on the device vs NumPy."""
    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.pipeline import OneGraphIndexQuery
    from mazu_tpu.index.validate import validate_self

    t = time.perf_counter()
    for engine in ("direct", "mono2"):
        idx = toy_index(engine=engine, seed=seed)
        mo = max(1, idx.max_occs())
        assert mo > 2, "toy index lost its three-occurrence unitigs"
        n = 4096
        work = kmer_workload(idx.k2u.unitigs, n, seed=seed, miss_frac=0.1)
        want = get_ref_pos_padded(idx.device_arrays(), work, np, mo)
        fused = idx.device_arrays(fused=True, pos_kind="inline2" if engine == "direct" else None)
        q = jax.jit(partial(get_ref_pos_compact, xp=jnp, max_occs=mo, probe_limit=2, m2=n))
        got = jax.device_get(q(jax.device_put(fused), jnp.asarray(work)))
        assert not bool(got["over_budget"])
        assert_padded_equal(got, want, f"branches/{engine}/compact")
        og = OneGraphIndexQuery(idx, batch=n, n_chunks=2, m2=n, probe_limit=2,
                                host_arrays=fused)
        stack = np.stack([work, np.roll(work, 977)])
        chk, worst = og.checksum_pass(jax.device_put(jnp.asarray(stack)))
        assert worst <= og.M2 and chk == og.checksum_host(stack), "branches: OneGraph"
        _, query = idx.make_query_fn()
        validate_self(idx, query_fn=query)
        if engine == "direct":
            depths = np.diff(idx.k2u.occs_prefix_sum)
            log(f"[branches] direct: skew k-mers {idx.k2u.n_kmers_in_skew_index}, "
                f"deepest bucket {int(depths.max())}, max_occs {mo}")
    log(f"[branches] exact on {n} lanes x 2 engines + validate_self "
        f"({time.perf_counter() - t:.1f}s incl. compile)")


def cut_reads(refs, n_reads: int, seed: int, k: int):
    """150 bp reads cut from random 10 kbp references, every other one
    reverse-complemented. Returns (reads, expected ref_id, ref_pos, orient
    per k-mer window, and the windows' query words)."""
    from mazu_tpu.kmer import codes_to_seq, revcomp

    rng = np.random.default_rng(seed)
    n_refs = refs.n_refs
    ref = rng.integers(0, n_refs, n_reads)
    lo = refs.prefix_sum[ref]
    span = refs.prefix_sum[ref + 1] - lo - READ_LEN
    off = (rng.random(n_reads) * (span + 1)).astype(np.int64)
    rc = (np.arange(n_reads) % 2) == 1
    codes = refs.seq.get_base((lo + off)[:, None] + np.arange(READ_LEN)[None, :])
    codes[rc] = (3 - codes[rc])[:, ::-1]
    reads = [codes_to_seq(c) for c in codes]
    nk = READ_LEN - k + 1
    j = np.arange(nk)[None, :]
    fw_pos = np.where(rc[:, None], off[:, None] + (nk - 1) - j, off[:, None] + j)
    words = refs.seq.get_kmer_u64((lo[:, None] + fw_pos).reshape(-1), k)
    words = np.where(np.repeat(rc, nk), revcomp(words, k), words)
    exp_ref = np.repeat(ref, nk)
    exp_orient = np.repeat((~rc).astype(np.int64), nk)
    return reads, exp_ref, fw_pos.reshape(-1), exp_orient, words


def serve_engine(name, index, traffic, reads_case, batch, iters):
    """One engine through its tuned configuration: the k-mer traffics
    through CompactQuery, the reads through ReadMapper (whose driver the
    tier picks), exact vs the host oracle; prints set-up and rate figures.
    Returns the mapper."""
    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.mapping import BatchHits, CompactQuery, ReadMapper
    from mazu_tpu.io.native import have_native

    mo = max(1, index.max_occs())
    t = time.perf_counter()
    mapper = ReadMapper(index, batch=batch)
    cq = mapper.tp if isinstance(mapper.tp, CompactQuery) else CompactQuery(index, mapper.config)
    jax.block_until_ready((cq.arrays, mapper.tp.arrays))
    log(f"[scale/{name}] config {mapper.config.tier} ({'; '.join(mapper.config.why)}); "
        f"reads driver {type(mapper.tp).__name__}; "
        f"layout + device_put {time.perf_counter() - t:.1f}s")
    plain = index.device_arrays()
    m2 = cq.budget(batch)
    for label, work in traffic:
        fw = jax.device_put(jnp.asarray(work))
        t = time.perf_counter()
        out = jax.block_until_ready(cq.query(fw, m2))
        first = time.perf_counter() - t
        got = jax.device_get(out)
        assert not bool(got["over_budget"]), f"{name}/{label}: phase-2 budget"
        t = time.perf_counter()
        want = get_ref_pos_padded(plain, work, np, mo)
        t_oracle = time.perf_counter() - t
        assert_padded_equal(got, want, f"{name}/{label}")
        dt = timed(lambda: cq.query(fw, m2), iters)
        log(f"[scale/{name}] {label}: exact on {len(work)} lanes "
            f"(hit {float((want['mt'] > 0).mean()):.4f}); compile+first {first:.2f}s, "
            f"host oracle {t_oracle:.1f}s; {len(work) / dt:.4g} queries/s "
            f"({dt * 1e3:.3f} ms/batch)")
    reads, exp_ref, exp_pos, exp_orient, words = reads_case
    t = time.perf_counter()
    res = mapper.map_reads(reads)
    t_map = time.perf_counter() - t
    offs, rid, rpo, orn = [], [], [], []
    base = 0
    for r in res:
        o, a, b, c = r.csr()
        offs.append(o[:-1] + base)
        base += int(o[-1])
        rid.append(a), rpo.append(b), orn.append(c)
    got = BatchHits(None, np.append(np.concatenate(offs), base),
                    np.concatenate(rid), np.concatenate(rpo), np.concatenate(orn))
    want = BatchHits.from_padded(get_ref_pos_padded(plain, words, np, mo))
    for k in ("offsets", "ref_id", "ref_pos", "orient"):
        np.testing.assert_array_equal(getattr(got, k), getattr(want, k), err_msg=f"{name}/reads: {k}")
    one = np.diff(got.offsets) == 1
    assert one.all(), f"{name}/reads: {int((~one).sum())} windows without exactly one hit"
    np.testing.assert_array_equal(got.ref_id, exp_ref, err_msg=f"{name}/reads: cut ref")
    np.testing.assert_array_equal(got.ref_pos, exp_pos, err_msg=f"{name}/reads: cut pos")
    np.testing.assert_array_equal(got.orient, exp_orient, err_msg=f"{name}/reads: cut orient")
    log(f"[scale/{name}] reads: {len(reads)} x {READ_LEN} bp -> {len(words)} k-mers, "
        f"every window at its cut position; map_reads {t_map:.2f}s incl. compile "
        f"({len(words) / t_map:.4g} k-mers/s, native host lib: {have_native()})")
    return mapper


def onegraph_engine(index, work, batch, chunks, iters):
    """mono2 through OneGraphIndexQuery: checksum vs the host composition,
    the compiled step's memory analysis, and the pass rate."""
    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.pipeline import OneGraphIndexQuery

    mo = max(1, index.max_occs())
    host = index.device_arrays(fused=True)
    t = time.perf_counter()
    out0 = get_ref_pos_compact(host, work, np, mo, merge=False, m2=batch)
    host_chk = int(OneGraphIndexQuery.checksum(out0, np))
    n_ovf = int(out0["n_ovf"])
    m2 = max(1024, -(-(n_ovf + 128) // 256) * 256)
    log(f"[scale/onegraph] host oracle {time.perf_counter() - t:.1f}s: "
        f"overflow {n_ovf}/{batch} -> m2 {m2}")
    t = time.perf_counter()
    og = OneGraphIndexQuery(index, batch, n_chunks=chunks, m2=m2, host_arrays=host)
    d_work = jax.device_put(jnp.asarray(work))
    jax.block_until_ready(og.arrays)
    log(f"[scale/onegraph] device_put {time.perf_counter() - t:.1f}s")
    t = time.perf_counter()
    chk, worst = og.checksum_pass_rolled(d_work)
    log(f"[scale/onegraph] compile+first pass {time.perf_counter() - t:.2f}s")
    assert worst <= m2, f"onegraph: phase-2 capacity {worst} > {m2}"
    assert chk == chunks * host_chk, ("onegraph checksum", chk, chunks, host_chk)
    ma = og.memory_analysis(d_work)
    log(f"[scale/onegraph] memory_analysis: arguments {ma.argument_size_in_bytes}, "
        f"outputs {ma.output_size_in_bytes}, temp {ma.temp_size_in_bytes}, "
        f"code {ma.generated_code_size_in_bytes} bytes")
    dt = timed(lambda: og._pass_roll(og.arrays, d_work), iters)
    log(f"[scale/onegraph] checksum exact; {chunks} x {batch} lanes per pass: "
        f"{chunks * batch / dt:.4g} queries/s ({dt * 1e3:.2f} ms/pass)")
    return og


def kernel_vs_xla(label, kernel_fn, xla_fn, iters):
    """Times the same step with the kernel and with the XLA probe, in the
    order kernel, xla, xla, kernel, and prints both pairs."""
    times = {"kernel": [], "xla": []}
    for name, fn in (("kernel", kernel_fn), ("xla", xla_fn), ("xla", xla_fn), ("kernel", kernel_fn)):
        times[name].append(timed(fn, iters))
    log(f"[kernels] {label} (order kernel, xla, xla, kernel): with the kernel "
        f"{[round(t * 1e3, 3) for t in times['kernel']]} ms, "
        f"XLA probe {[round(t * 1e3, 3) for t in times['xla']]} ms")


def compact_kernel_contest(mapper, index, work, iters):
    """The mono2 probe kernel end to end through CompactQuery, ReadMapper's
    driver: the mapper's own query (the platform picks the kernel) against
    one traced with the kernel switched off, exact and timed."""
    from unittest import mock

    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.mapping import CompactQuery
    from mazu_tpu.ops import mono2_probe

    cq = mapper.tp
    fw = jax.device_put(jnp.asarray(work))
    m2 = cq.budget(len(work))
    with mock.patch.object(mono2_probe, "use_mono2_probe", lambda *a: False):
        cq_x = CompactQuery(index, mapper.config)
        want = jax.device_get(cq_x.query(fw, m2))
    assert_padded_equal(jax.device_get(cq.query(fw, m2)), want, "CompactQuery: kernel vs XLA")
    kernel_vs_xla(f"CompactQuery, {len(work)} lanes",
                  lambda: cq.query(fw, m2), lambda: cq_x.query(fw, m2), iters)


def phase_kernels(og, work, iters, interpret=False):
    """Hand-written kernels of the path against the XLA code they replace:
    exact and timed alone, and (on a GPU, where the platform picks the
    kernel) end to end through the OneGraph pass ``og`` against the same
    pass traced with the kernel switched off. ``compact_kernel_contest``
    does the same through CompactQuery."""
    from unittest import mock

    import jax
    import jax.numpy as jnp

    from mazu_tpu.index.pipeline import OneGraphIndexQuery
    from mazu_tpu.kphf.kcdict import kcdict_k2u
    from mazu_tpu.ops import mono2_probe

    kc_arrays = og.arrays["k2u"]
    fw = jax.device_put(jnp.asarray(work))
    xla = jax.jit(lambda d, f: kcdict_k2u(d, f, jnp, mode="main"))
    ker = jax.jit(partial(mono2_probe.mono2_probe_k2u, interpret=interpret))
    a, b = jax.device_get(xla(kc_arrays, fw)), jax.device_get(ker(kc_arrays, fw))
    for k in a:
        np.testing.assert_array_equal(np.asarray(b[k]), np.asarray(a[k]), err_msg=f"mono2 probe: {k}")
    t_x = timed(lambda: xla(kc_arrays, fw), iters)
    t_k = timed(lambda: ker(kc_arrays, fw), iters)
    log(f"[kernels] mono2 probe alone, {len(work)} lanes: Pallas/Triton {t_k * 1e6:.1f} us, "
        f"XLA kcdict_k2u {t_x * 1e6:.1f} us (exact)")
    if jax.default_backend() == "gpu":
        with mock.patch.object(mono2_probe, "use_mono2_probe", lambda *a: False):
            og_x = OneGraphIndexQuery(og.index, og.batch, n_chunks=og.CH, m2=og.M2,
                                      host_arrays=og.host_arrays)
            chk_x = og_x.checksum_pass_rolled(fw)
        assert chk_x == og.checksum_pass_rolled(fw), "OneGraph: kernel vs XLA checksum"
        kernel_vs_xla(f"OneGraph pass, {og.CH} x {og.batch} lanes",
                      lambda: og._pass_roll(og.arrays, fw),
                      lambda: og_x._pass_roll(og_x.arrays, fw), iters)
        del og_x
    flags = jax.device_put(jnp.asarray(np.random.default_rng(0).random(1 << 20) < 0.1))
    cs = jax.jit(lambda f: jnp.cumsum(f.astype(jnp.int32), dtype=jnp.int32))
    np.testing.assert_array_equal(np.asarray(cs(flags)), np.cumsum(np.asarray(flags), dtype=np.int32))
    log(f"[kernels] XLA cumsum, 1M int32: {timed(lambda: cs(flags), iters) * 1e6:.1f} us (exact)")


def phase_scale(seed, bases, batch, chunks, iters, interpret=False):
    import gc

    import jax

    t = time.perf_counter()
    parts = genome_parts(bases, seed)
    unitigs, refs, _ = parts
    log(f"[scale] genome {bases} bases, {unitigs.n_kmers} k-mers, "
        f"{unitigs.n_unitigs} unitigs: {time.perf_counter() - t:.1f}s")
    hits = kmer_workload(unitigs, batch, seed=seed + 1, miss_frac=0.0)
    miss = kmer_workload(unitigs, batch, seed=seed + 2, miss_frac=0.1)
    traffic = [("hits", hits), ("misses10", miss)]
    reads_case = cut_reads(refs, batch // (READ_LEN - unitigs.k + 1), seed + 3, unitigs.k)

    t = time.perf_counter()
    ss = genome_index(parts, "direct", w=15, skew_param=4, load=0.25)
    log(f"[scale/speed] SSHash direct host build {time.perf_counter() - t:.1f}s "
        f"({ss.k2u.num_bits() / 8 / 1e9:.2f} GB packed)")
    serve_engine("speed", ss, traffic, reads_case, batch, iters)
    del ss
    gc.collect()

    t = time.perf_counter()
    kc = genome_index(parts, "mono2", load=0.25)
    log(f"[scale/mono2] KCDict mono2 host build {time.perf_counter() - t:.1f}s "
        f"(table {kc.k2u.table.nbytes / 1e9:.2f} GB, occ32 {kc.k2u.occ32})")
    og = onegraph_engine(kc, miss, batch, chunks, iters)
    phase_kernels(og, miss, iters, interpret=interpret)
    del og
    gc.collect()
    mapper = serve_engine("mono2", kc, traffic, reads_case, batch, iters)
    if jax.default_backend() == "gpu":
        compact_kernel_contest(mapper, kc, miss, iters)
    stats = jax.devices()[0].memory_stats() or {}
    log(f"[scale] peak_bytes_in_use {stats.get('peak_bytes_in_use', 'not reported')}")


def phase_cards(n, seed, bases, batch):
    """Multi-device paths on an n-device mesh vs the single-device result."""
    import tempfile

    import jax
    import jax.numpy as jnp
    from jax.sharding import Mesh

    from mazu_tpu.index.validate import merge_sharded_out
    from mazu_tpu.io.sharded_ckpt import device_put_fused_sharded, save_fused_sharded
    from mazu_tpu.parallel.sharding import (
        build_fused_sharded_query,
        make_alltoall_sharded_query,
        make_data_parallel_query,
        make_fused_sharded_query,
        make_mono_sharded_query,
    )

    devs = np.array(jax.devices()[:n])
    assert len(devs) == n, f"{n} devices asked for, {len(devs)} present"
    t = time.perf_counter()
    parts = genome_parts(bases, seed)
    ss = genome_index(parts, "direct", w=15, skew_param=4, load=0.25)
    kc = genome_index(parts, "mono2", load=0.25)
    log(f"[cards] {bases} bases, builds {time.perf_counter() - t:.1f}s")
    work = kmer_workload(parts[0], batch, seed=seed + 2, miss_frac=0.1)
    kms = jnp.asarray(work)
    mo = max(1, ss.max_occs())
    k2u_fields = ("unitig_id", "unitig_len", "pos", "mt")

    def single(idx, arrays, **kw):
        q = jax.jit(partial(get_ref_pos_compact, xp=jnp, max_occs=mo, m2=batch // 4, **kw))
        out = jax.device_get(q(jax.device_put(arrays, devs[0]), kms))
        assert not bool(out["over_budget"])
        return out

    def same(got, want, fields, label):
        for k in fields:
            np.testing.assert_array_equal(np.asarray(got[k]), np.asarray(want[k]), err_msg=f"{label}: {k}")
        log(f"[cards] {label}: exact vs single device")

    # replicated data-parallel: the full padded query, every field
    pad1 = jax.jit(partial(get_ref_pos_padded, xp=jnp, max_occs=mo))
    want_pad = jax.device_get(pad1(jax.device_put(ss.device_arrays(), devs[0]), kms))
    _, qdp = make_data_parallel_query(
        ss.device_arrays(), partial(get_ref_pos_padded, max_occs=mo), Mesh(devs, ("data",))
    )
    assert_padded_equal(jax.device_get(qdp(kms)), want_pad, "cards/data-parallel")
    log("[cards] replicated data-parallel: exact vs single device")

    mesh = Mesh(devs.reshape(1, n), ("data", "bucket"))
    fused = ss.device_arrays(fused=True, pos_kind="inline2")
    want_ss = single(ss, fused, probe_limit=2)
    out = jax.device_get(make_fused_sharded_query(ss, mesh, m2=batch // 4, probe_limit=2)(kms))
    assert not np.asarray(out["over_budget"]).any()
    same(merge_sharded_out(out), want_ss, k2u_fields, "bucket-sharded fused")

    want_kc = single(kc, kc.device_arrays(fused=True))
    out = jax.device_get(make_mono_sharded_query(kc, mesh, m2=batch // 4)(kms))
    assert not np.asarray(out["over_budget"]).any()
    same(merge_sharded_out(out), want_kc, k2u_fields, "bucket-sharded mono2")

    outa = jax.device_get(make_alltoall_sharded_query(ss.k2u, Mesh(devs, ("bucket",)))(kms))
    assert np.asarray(outa["routed_ok"]).all(), "all_to_all: a destination overflowed"
    same(outa, want_pad, ("unitig_id", "pos", "mt"), "all_to_all routed k2u")

    # checkpoint -> per-device placement: each shard's rows on its own card
    with tempfile.TemporaryDirectory() as td:
        save_fused_sharded(td, ss, n_shards=n)
        shared_host, shared_dev, stacked, manifest = device_put_fused_sharded(td, mesh)
        for name, arr in stacked.items():
            owners = {s.device for s in arr.addressable_shards}
            assert owners == set(devs.tolist()), f"ckpt leaf {name} on {owners}"
            for s in arr.addressable_shards:
                i = int(s.index[0].start or 0)
                assert s.data.devices() == {devs[i]}, f"ckpt leaf {name} shard {i}"
        qc = build_fused_sharded_query(shared_host, shared_dev, stacked, mesh, m2=batch // 4,
                                       max_occs=int(manifest["max_occs"]), probe_limit=2)
        outc = jax.device_get(qc(kms))
    same(merge_sharded_out(outc), want_ss, k2u_fields,
         f"checkpoint placement ({len(stacked)} leaves, shard s on card s)")


def main(argv=None) -> int:
    ap = argparse.ArgumentParser(description=__doc__.split("\n")[0])
    ap.add_argument("--seed", type=int, default=0)
    ap.add_argument("--bases", type=int, default=100_000_000)
    ap.add_argument("--batch", type=int, default=1 << 20)
    ap.add_argument("--chunks", type=int, default=8, help="OneGraph chunks per pass")
    ap.add_argument("--iters", type=int, default=5)
    ap.add_argument("--cards", type=int, default=1, choices=(1, 4))
    args = ap.parse_args(argv)

    from mazu_tpu.compile_cache import enable_compile_cache

    enable_compile_cache()
    info = phase_device(args.cards)
    if args.cards > 1:
        phase_cards(args.cards, args.seed, args.bases, args.batch)
    else:
        phase_branches(args.seed)
        phase_scale(args.seed, args.bases, args.batch, args.chunks, args.iters)
    print(json.dumps({"ok": True, "device": info}), flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
