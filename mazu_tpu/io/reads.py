"""Packed read ingestion + device-side k-merization.

The reference k-merizes reads on the host (CanonicalKmerIterator over ASCII,
src/index/validate.rs:57, src/bin/kphf/main.rs:303). On an accelerator the
honest serving cost includes getting read k-mers ONTO the device: expanding each
k-mer to a u64 word costs 8 bytes/k-mer of host->device traffic, ~26x the
information content of the read itself (2 bits/base). This module ships the
bases, not the words:

- host: pack reads 2-bit (A/C/G/T -> 0..3) into per-read rows of a fixed
  base stride (multiple of 32 so every read starts word-aligned), plus an
  optional 1-bit/base "bad" mask for non-ACGT positions (rare; omitted
  entirely when absent) and a per-read length vector.
- device: ``kmerize_device`` reconstructs the [R, L] k-mer-word matrix with
  2 consecutive-word gathers per k-mer (nearly free vs random gathers)
  and derives the validity mask
  (in-read-bounds AND no bad base in the k-window, the reference's
  non-ACGT-restart semantics) with 2 more consecutive gathers when a bad
  mask exists.

Result parity: ``kmerize_device(pack_reads(reads, k)) ==
index.streaming.kmerize_reads(reads, k)`` bit-for-bit (tests).

Ingest bytes: 0.25 B/base (+0.125 B/base only when non-ACGT present) vs
8 B/k-mer for word upload — ~26x less for 150 bp reads.
"""

from __future__ import annotations

import numpy as np

from ..kmer import seq_to_codes
from ..pytree import meta

U64 = np.uint64


def pack_reads(reads: list[str], k: int):
    """Pack variable-length reads into a device-ingestible pytree.

    Returns a dict: ``words`` u64[R*S/32 (+1)] 2-bit codes at stride S
    bases/read, ``lengths`` int32[R], optional ``bad`` u64 words (1
    bit/base, set on non-ACGT), and a static Meta (R, stride, L, k,
    has_bad). L matches ``kmerize_reads``: max(len(r)) - k + 1 (>= 1).
    """
    k = int(k)
    R = len(reads)
    maxlen = max((len(r) for r in reads), default=0)
    L = max(maxlen - k + 1, 1)
    stride = max(((maxlen + 31) // 32) * 32, 32)
    codes = np.zeros(R * stride, dtype=np.uint8)
    bad = np.zeros(R * stride, dtype=bool)
    lengths = np.zeros(R, dtype=np.int32)
    for i, r in enumerate(reads):
        c = seq_to_codes(r)  # bad bases -> 255
        lengths[i] = len(c)
        row = codes[i * stride : i * stride + len(c)]
        b = c == 255
        row[:] = np.where(b, 0, c)
        if b.any():
            bad[i * stride : i * stride + len(c)] = b
    # 2-bit pack, LSB-first within each u64 word (SeqVector convention)
    cw = codes.astype(np.uint64).reshape(-1, 32)
    shifts = (np.arange(32, dtype=np.uint64) * U64(2))[None, :]
    words = np.bitwise_or.reduce(cw << shifts, axis=1)
    words = np.concatenate([words, np.zeros(1, dtype=np.uint64)])  # window pad
    out = {
        "words": words,
        "lengths": lengths,
        "meta": meta(R=R, stride=stride, L=L, k=k, has_bad=bool(bad.any())),
    }
    if out["meta"].has_bad:
        bw = np.packbits(bad, bitorder="little")
        pad = (-len(bw)) % 8
        bw = np.concatenate([bw, np.zeros(pad + 8, dtype=np.uint8)])
        out["bad"] = bw.view(np.uint64)
    return out


def pack_fastq(path: str, k: int) -> dict:
    """FASTQ(.gz) file -> ``pack_reads`` pytree in one fused native pass.

    The serving hot path: the reference k-merizes reads on the host per
    record (src/bin/kphf/main.rs:303); here parse+pack were the two
    dominant host stages of the serve pipeline (98+269 ms vs 46 ms upload
    per 16K-read pass). The native path decompresses once,
    then C scans the text twice (size, fill) writing the stride-aligned
    2-bit words directly — no per-read Python objects. Falls back to
    read_fastq + pack_reads (bit-identical output, tested) when the
    native lib is absent or the file needs the general reader.
    """
    from .fasta import open_binary
    from .native import fastq_pack

    with open_binary(path) as f:
        buf = f.read()
    out = fastq_pack(buf, k)
    if out is not None:
        return out
    from .fastq import read_fastq

    return pack_reads([s for _, s in read_fastq(path)], k)


def kmerize_device(packed: dict, xp, row_start=0, rows: int | None = None):
    """[rows, L] (kmer_words u64, valid bool) from a ``pack_reads`` pytree.

    Pure array math, jit-safe: per k-mer 2 consecutive-word gathers for the
    window read (+2 for the bad-bit window when present). Equals
    ``kmerize_reads`` exactly: invalid lanes are zeroed.

    ``row_start`` (traced ok) + ``rows`` (static) select a read-row window,
    letting a jitted scan process one packed batch in chunks.
    """
    from ..bits.bitvector import _read_window

    m = packed["meta"]
    L, k, stride = m.L, m.k, m.stride
    rows = m.R if rows is None else int(rows)
    ridx = row_start + xp.arange(rows, dtype=xp.int64)
    base = (ridx * stride)[:, None] + xp.arange(L, dtype=xp.int64)[None, :]
    kms = _read_window(packed["words"], base * 2, 2 * k, xp)
    valid = xp.arange(L, dtype=xp.int32)[None, :] <= (
        packed["lengths"][ridx][:, None] - np.int32(k)
    )
    if m.has_bad:
        badw = _read_window(packed["bad"], base, k, xp)
        valid = valid & (badw == 0)
        # host kmerize_reads LEFT-COMPACTS windows after non-ACGT restarts
        # (reference CanonicalKmerIterator semantics: the stream continues
        # in adjacent slots, so the warm cache still probes prev±1 across
        # a restart). Compact per row — a stable length-L row sort, paid
        # only when bad bases exist (static flag).
        if xp is np:
            order = np.argsort(~valid, axis=1, kind="stable")
        else:
            order = xp.argsort(~valid, axis=1, stable=True)
        kms = xp.take_along_axis(kms, order.astype(xp.int64), axis=1)
        valid = xp.arange(L, dtype=xp.int32)[None, :] < valid.sum(
            axis=1, dtype=xp.int32
        )[:, None]
    kms = xp.where(valid, kms, xp.zeros_like(kms))
    return kms, valid
