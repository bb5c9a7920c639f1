"""Command-line interface (reference parity: src/bin/index/main.rs and
src/bin/kphf/main.rs).

  mazu-tpu index build piscem     -p <cf_prefix> -o out.piscem.npz [-m W] [-s SKEW] [--engine E]
  mazu-tpu index build pufferfish -p <cf_prefix> -o out.pf_dense.npz
  mazu-tpu index validate-fasta   -i out.npz -f refs.fa [--streaming]
  mazu-tpu index map       -i out.npz -f reads.(fa|fastq)[.gz]
  mazu-tpu index colors    -i out.npz [-o colors.npz]
  mazu-tpu index pseudomap -i out.npz -f reads.(fa|fastq)[.gz] [--policy P] [--tau T] [--list]
  mazu-tpu kphf build  (sshash|pfhash|sampled|cuckoo|mono|mono2) -p <cf_prefix> -o out.npz [--validate]
  mazu-tpu kphf validate -i kphf.npz
  mazu-tpu kphf stats    -i kphf.npz
  mazu-tpu kphf bench    -i kphf.npz -f queries.fa [--streaming] [--device]

Index arguments also accept a pufferfish (C++) index DIRECTORY anywhere an
.npz is accepted (dense or sparse, auto-detected).
"""

from __future__ import annotations

import argparse
import logging
import sys
import time

import numpy as np

log = logging.getLogger("mazu_tpu")

DEFAULT_SKEW = 64  # reference src/bin/index/main.rs:9
DEFAULT_W = 15


def _build_parser():
    p = argparse.ArgumentParser(prog="mazu-tpu")
    p.add_argument("-v", "--verbose", action="store_true")
    sub = p.add_subparsers(dest="tool", required=True)

    # ---- index tool
    idx = sub.add_parser("index").add_subparsers(dest="cmd", required=True)
    b = idx.add_parser("build")
    bsub = b.add_subparsers(dest="flavor", required=True)
    for flavor in ("piscem", "pufferfish"):
        f = bsub.add_parser(flavor)
        f.add_argument("-p", "--cf-prefix", required=True)
        f.add_argument("-o", "--output", required=True)
        if flavor == "piscem":
            f.add_argument("-m", "--minimizer-size", type=int, default=DEFAULT_W)
            f.add_argument("-s", "--skew-param", type=int, default=DEFAULT_SKEW)
            f.add_argument(
                "--engine",
                choices=["parity", "fast32", "direct", "cuckoo", "mono", "mono2"],
                default="parity",
                help=(
                    "query arithmetic engine (direct/fast32 = 32-bit hash chains; "
                    "mono/mono2 = single-gather flagship)"
                ),
            )
    st = idx.add_parser("stats", help="size accounting down the index stack")
    st.add_argument("-i", "--index", required=True)
    v = idx.add_parser("validate-fasta")
    v.add_argument("-i", "--index", required=True)
    v.add_argument("-f", "--fasta", required=True)
    v.add_argument("--streaming", action="store_true")
    mp = idx.add_parser("map")
    mp.add_argument("-i", "--index", required=True)
    mp.add_argument("-f", "--fasta", required=True, help="reads (FASTA/FASTQ, optionally .gz)")
    cc = idx.add_parser(
        "colors",
        help="build the color-class layer (unitig -> deduped ref-id set)",
    )
    cc.add_argument("-i", "--index", required=True)
    cc.add_argument("-o", "--output", help="save color classes to .npz")
    pm = idx.add_parser(
        "pseudomap",
        help="pseudo-align reads: candidate refs = intersection of k-mer color sets",
    )
    pm.add_argument("-i", "--index", required=True)
    pm.add_argument("-f", "--fasta", required=True, help="reads (FASTA/FASTQ, optionally .gz)")
    pm.add_argument("--list", action="store_true", help="print per-read candidate refs")
    pm.add_argument(
        "--policy", choices=["intersect", "union", "threshold"], default="intersect"
    )
    pm.add_argument("--tau", type=float, default=0.7, help="threshold-policy coverage fraction")

    # ---- kphf tool
    kp = sub.add_parser("kphf").add_subparsers(dest="cmd", required=True)
    b = kp.add_parser("build")
    bsub = b.add_subparsers(dest="flavor", required=True)
    for flavor in ("sshash", "pfhash", "sampled", "cuckoo", "mono", "mono2"):
        f = bsub.add_parser(flavor)
        f.add_argument("-p", "--cf-prefix", required=True)
        f.add_argument("-o", "--output", required=True)
        f.add_argument("--validate", action="store_true")
        if flavor == "sampled":
            f.add_argument("--sample-size", type=int, default=9)
            f.add_argument("--extension-size", type=int, default=4)
        if flavor == "sshash":
            f.add_argument("-m", "--minimizer-size", type=int, default=DEFAULT_W)
            f.add_argument("-s", "--skew-param", type=int, default=DEFAULT_SKEW)
            f.add_argument(
                "--engine",
                choices=["parity", "fast32", "direct", "cuckoo"],
                default="parity",
            )
    for cmd in ("validate", "stats"):
        c = kp.add_parser(cmd)
        c.add_argument("-i", "--input", required=True)
    c = kp.add_parser("bench")
    c.add_argument("-i", "--input", required=True)
    c.add_argument("-f", "--fasta", required=True)
    c.add_argument("--streaming", action="store_true")
    c.add_argument(
        "--device",
        action="store_true",
        help="run the jitted batched kernel on the ambient JAX device "
        "(reports compile and warm ns/kmer separately)",
    )
    return p


def _load_index_arg(path):
    """Load an index argument: .npz checkpoint, or a pufferfish (C++) index
    DIRECTORY (dense or sparse, auto-detected from info.json)."""
    import os as _os

    from .err import IndexLoad

    if _os.path.isdir(path):
        import json as _json

        from .io.pf1_index import load_dense_index, load_sparse_index

        info = _os.path.join(path, "info.json")
        if not _os.path.exists(info):
            raise IndexLoad(f"{path}: directory without info.json (not a pf1 index)")
        with open(info) as f:
            sampling = _json.load(f).get("sampling_type", "dense")
        return (load_sparse_index if sampling == "sparse" else load_dense_index)(path)
    if not _os.path.exists(path):
        raise IndexLoad(f"{path}: no such file")
    from .io.checkpoint import load_index

    return load_index(path)


def main(argv=None):
    from .err import MazuError

    try:
        return _main(argv)
    except (MazuError, FileNotFoundError, IsADirectoryError) as e:
        print(f"error: {e}", file=sys.stderr)
        return 1


def _main(argv=None):
    args = _build_parser().parse_args(argv)
    from .compile_cache import enable_compile_cache

    enable_compile_cache()
    logging.basicConfig(
        level=logging.INFO if args.verbose else logging.WARNING,
        format="%(levelname)s %(name)s: %(message)s",
    )
    from .containers.unitig_set import UnitigSet
    from .io.checkpoint import load_index, load_k2u, save_index, save_k2u
    from .io.cuttlefish import CfFiles

    if args.tool == "index":
        if args.cmd == "build":
            from .index.piscem_index import (
                piscem_index_from_cf_prefix,
                pufferfish_dense_index_from_cf_prefix,
            )

            t = time.time()
            if args.flavor == "piscem":
                sp = None if args.skew_param <= 0 else args.skew_param
                idx = piscem_index_from_cf_prefix(
                    args.cf_prefix, w=args.minimizer_size, skew_param=sp, engine=args.engine
                )
            else:
                idx = pufferfish_dense_index_from_cf_prefix(args.cf_prefix)
            log.info("built in %.1fs", time.time() - t)
            save_index(idx, args.output)
            print(f"wrote {args.output}")
        elif args.cmd == "stats":
            idx = _load_index_arg(args.index)
            n_k = max(1, idx.n_kmers)
            print(f"index_type: {idx.index_type}   k: {idx.k}")
            print(f"n_kmers: {idx.n_kmers}  n_unitigs: {idx.n_unitigs}  n_refs: {idx.n_refs}")
            k2u_bits = idx.k2u.num_bits()
            u2_bits = idx.u2pos.num_bits() if hasattr(idx.u2pos, "num_bits") else 0
            print(f"k2u:   {k2u_bits/8e6:10.2f} MB  ({k2u_bits/n_k:6.2f} bits/kmer)")
            print(f"u2pos: {u2_bits/8e6:10.2f} MB  ({u2_bits/n_k:6.2f} bits/kmer)")
            if hasattr(idx.k2u, "print_stats"):
                idx.k2u.print_stats()
        elif args.cmd == "validate-fasta":
            idx = _load_index_arg(args.index)
            if args.streaming:
                from .index.streaming import validate_fasta_streaming

                validate_fasta_streaming(idx, args.fasta)
            else:
                from .index.validate import validate_fasta

                validate_fasta(idx, args.fasta)
            print("valid")
        elif args.cmd == "colors":
            idx = _load_index_arg(args.index)
            t = time.time()
            cc = idx.color_classes()
            log.info("built in %.1fs", time.time() - t)
            cc.print_stats()
            if args.output:
                cc.save(args.output)
                print(f"wrote {args.output}")
        elif args.cmd == "pseudomap":
            import time as _t

            from .index.pseudoalign import PseudoAligner

            idx = _load_index_arg(args.index)
            pa = PseudoAligner(idx, policy=args.policy, tau=args.tau)
            t = _t.time()
            results = pa.map_file(args.fasta)
            dt = _t.time() - t
            names = idx.ref_names
            mapped = sum(1 for r, h, _ in results if h and len(r))
            n_k = sum(nk for _, _, nk in results)
            print(
                f"{len(results)} reads, {mapped} mapped "
                f"({idx.n_refs} refs, {pa.cc.n_classes} color classes)"
            )
            print(f"{dt:.3f}s total, {dt / max(n_k, 1) * 1e9:.1f} ns/kmer")
            if args.list:
                for i, (r, h, nk) in enumerate(results):
                    labels = [
                        names[j] if j < len(names) else str(j) for j in r.tolist()
                    ]
                    print(f"read {i}: {h}/{nk} k-mers hit -> {','.join(labels)}")
        elif args.cmd == "map":
            import time as _t

            from .index.mapping import ReadMapper

            idx = _load_index_arg(args.index)
            mapper = ReadMapper(idx)
            t = _t.time()
            results = mapper.map_file(args.fasta)
            dt = _t.time() - t
            n_kmers = sum(r.n_kmers for r in results)
            n_hit = sum(r.n_hit for r in results)
            print(f"{len(results)} reads, {n_kmers} k-mers, {n_hit} hits")
            print(f"{dt:.3f}s total, {dt / max(n_kmers, 1) * 1e9:.1f} ns/kmer")
    elif args.tool == "kphf":
        if args.cmd == "build":
            us, _ = UnitigSet.from_cf(CfFiles(args.cf_prefix))
            t = time.time()
            if args.flavor == "sshash":
                from .kphf.sshash import SSHash

                sp = None if args.skew_param <= 0 else args.skew_param
                k2u = SSHash.from_unitig_set(
                    us, args.minimizer_size, skew_param=sp, engine=args.engine
                )
            elif args.flavor == "sampled":
                from .kphf.sampled import SampledPFHash

                k2u = SampledPFHash.from_unitig_set(
                    us,
                    sample_size=args.sample_size,
                    extension_size=args.extension_size,
                )
            elif args.flavor in ("cuckoo", "mono", "mono2"):
                from .kphf.kcdict import KCDict

                k2u = (
                    KCDict.from_unitig_set(us)
                    if args.flavor == "cuckoo"
                    else KCDict.from_unitig_set(us, scheme=args.flavor, load=0.125)
                )
            else:
                from .kphf.pfhash import PFHash

                k2u = PFHash.from_unitig_set(us)
            log.info("built in %.1fs", time.time() - t)
            if args.validate:
                from .index.validate import validate_k2u_self

                t = time.time()
                validate_k2u_self(k2u)
                dt = time.time() - t
                n = 2 * k2u.n_kmers
                print(f"validated {n} queries in {dt:.2f}s ({dt / n * 1e9:.1f} ns/kmer)")
            save_k2u(k2u, args.output)
            print(f"wrote {args.output}")
        elif args.cmd == "validate":
            k2u = load_k2u(args.input)
            from .index.validate import validate_k2u_self

            validate_k2u_self(k2u)
            print("valid")
        elif args.cmd == "stats":
            k2u = load_k2u(args.input)
            print(f"n_kmers: {k2u.n_kmers}")
            print(f"k: {k2u.k}")
            print(f"n_unitigs: {k2u.unitigs.n_unitigs}")
            if hasattr(k2u, "print_stats"):
                k2u.print_stats()
        elif args.cmd == "bench":
            k2u = load_k2u(args.input)
            from .io.fasta import read_fasta

            if args.streaming and args.device:
                # flat cache mode: one jitted graph (cold kernel + derived
                # warm flags), the device reads path
                from .index.streaming import StreamingIndex, kmerize_reads

                si = StreamingIndex(k2u, mode="flat")
                reads = [seq for _, seq in read_fasta(args.fasta)]
                kms, valid, _ = kmerize_reads(reads, k2u.k)
                t = time.time()
                r = si.k2u_reads(kms, valid)
                print(f"compile+first: {time.time() - t:.2f}s")
                t = time.time()
                r = si.k2u_reads(kms, valid)
                dt = time.time() - t
                mt = r["mt"][valid]
            elif args.streaming:
                from .index.streaming import StreamingIndex, kmerize_reads

                si = StreamingIndex(k2u, use_jit=False)
                reads = [seq for _, seq in read_fasta(args.fasta)]
                kms, valid, _ = kmerize_reads(reads, k2u.k)
                t = time.time()
                r = si.k2u_reads(kms, valid)
                dt = time.time() - t
                mt = r["mt"][valid]
            else:
                from .index.modindex import k2u_batch
                from .index.validate import valid_kmer_windows

                words = np.concatenate(
                    [valid_kmer_windows(seq, k2u.k)[1] for _, seq in read_fasta(args.fasta)]
                )
                if args.device:
                    import jax
                    import jax.numpy as jnp

                    d = jax.device_put({"k2u": k2u.device_arrays()})
                    pad = (-len(words)) % 8192
                    wp = np.concatenate([words, np.zeros(pad, dtype=np.uint64)])
                    fn = jax.jit(lambda a, w: k2u_batch(a, w, jnp))
                    dw = jax.device_put(jnp.asarray(wp))
                    t = time.time()
                    r = {kk: np.asarray(v) for kk, v in fn(d, dw).items()}
                    print(f"compile+first: {time.time() - t:.2f}s")
                    t = time.time()
                    r = {kk: np.asarray(v) for kk, v in fn(d, dw).items()}
                    dt = time.time() - t
                    mt = r["mt"][: len(words)]
                else:
                    d = {"k2u": k2u.device_arrays()}
                    t = time.time()
                    r = k2u_batch(d, words, np)
                    dt = time.time() - t
                    mt = np.asarray(r["mt"])
            hits = int((mt > 0).sum())
            n = len(mt)
            print(f"{n} queries, {hits} hits, {n - hits} misses")
            print(f"{dt:.3f}s total, {dt / max(n,1) * 1e9:.1f} ns/kmer")
    return 0


if __name__ == "__main__":
    sys.exit(main())
