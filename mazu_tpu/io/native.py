"""ctypes bindings for the native host library (native/mazu_host.cpp).

Compiled lazily with g++ on first use into ``native/build/``, under a name
keyed on the source, the flags and the host, so a library built with
``-march=native`` on one machine is never loaded on another; every entry
point has a NumPy fallback so the package works without a toolchain.
"""

from __future__ import annotations

import ctypes
import hashlib
import os
import socket
import subprocess

import numpy as np

_HERE = os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))
_SRC = os.path.join(_HERE, "native", "mazu_host.cpp")
_FLAGS = ["-O3", "-march=native", "-fopenmp", "-shared", "-fPIC"]

_lib = None
_tried = False


def library_path() -> str:
    """Where this host's build of the current source lives."""
    with open(_SRC, "rb") as f:
        key = hashlib.sha256(f.read() + " ".join(_FLAGS).encode()).hexdigest()[:16]
    host = socket.gethostname() or "host"
    return os.path.join(_HERE, "native", "build", f"libmazu_host-{key}-{host}.so")


def _load():
    global _lib, _tried
    if _tried:
        return _lib
    _tried = True
    if os.environ.get("MAZU_NO_NATIVE"):
        return None
    try:
        so = library_path()
        if not os.path.exists(so):
            os.makedirs(os.path.dirname(so), exist_ok=True)
            tmp = f"{so}.{os.getpid()}.tmp"  # concurrent builders: atomic rename
            subprocess.run(
                ["g++", *_FLAGS, "-o", tmp, _SRC], check=True, capture_output=True
            )
            os.replace(tmp, so)
        lib = ctypes.CDLL(so)
        lib.seq_to_codes.restype = ctypes.c_int64
        lib.kmerize.restype = ctypes.c_int64
        _lib = lib
    except Exception:
        _lib = None
    return _lib


def have_native() -> bool:
    return _load() is not None


from contextlib import contextmanager  # noqa: E402


@contextmanager
def heap_reuse_scope():
    """Temporarily route malloc through the brk heap (mmap disabled) so
    CHUNKED temp churn reuses warm pages: a loop whose per-iteration
    NumPy temps exceed the mmap threshold otherwise faults fresh pages
    every iteration, which is slow on hosts with throttled page supply.
    Inside this scope freed temps are reused warm after a one-time heap
    first-touch.

    Scope it TIGHTLY: one-shot multi-GB allocations inside the scope
    first-touch through 4K brk pages (~90 s/GB measured, defeats THP) —
    allocate those OUTSIDE the scope."""
    libc = None
    try:
        libc = ctypes.CDLL("libc.so.6", use_errno=True)
        libc.mallopt(ctypes.c_int(-4), ctypes.c_int(0))  # M_MMAP_MAX = 0
        libc.mallopt(ctypes.c_int(-1), ctypes.c_int(-1))  # M_TRIM_THRESHOLD off
    except Exception:
        libc = None
    try:
        yield
    finally:
        if libc is not None:
            libc.mallopt(ctypes.c_int(-4), ctypes.c_int(65536))
            libc.mallopt(ctypes.c_int(-1), ctypes.c_int(128 * 1024))


def seq_to_codes(seq: bytes | str) -> np.ndarray:
    """ASCII DNA -> uint8 codes (255 for non-ACGT)."""
    if isinstance(seq, str):
        seq = seq.encode()
    lib = _load()
    if lib is None:
        from ..kmer import seq_to_codes as np_impl

        return np_impl(seq)
    n = len(seq)
    out = np.empty(n, dtype=np.uint8)
    lib.seq_to_codes(seq, ctypes.c_int64(n), out.ctypes.data_as(ctypes.c_void_p))
    return out


def codes_to_words(codes: np.ndarray) -> np.ndarray:
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lib = _load()
    if lib is None:
        from ..bits.seqvector import SeqVector

        return SeqVector.from_codes(codes).words[:-1]
    n = len(codes)
    nw = (2 * n + 63) // 64
    out = np.zeros(nw, dtype=np.uint64)
    lib.codes_to_words(
        codes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def kmerize(codes: np.ndarray, k: int) -> tuple[np.ndarray, np.ndarray]:
    """All valid k-mer windows of a code sequence: (positions, fw words)."""
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    lib = _load()
    if lib is None:
        from ..index.validate import windows_from_codes

        return windows_from_codes(codes, k)
    n = len(codes)
    cap = max(n - k + 1, 0)
    pos = np.empty(cap, dtype=np.int64)
    words = np.empty(cap, dtype=np.uint64)
    cnt = lib.kmerize(
        codes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        ctypes.c_int(k),
        pos.ctypes.data_as(ctypes.c_void_p),
        words.ctypes.data_as(ctypes.c_void_p),
    )
    return pos[:cnt].copy(), words[:cnt].copy()


def kmerize_batch(reads: list, k: int):
    """All valid k-mer windows of MANY reads in one native call (round 5:
    per-read ctypes dispatch cost more host time than the query kernel on
    the 16K-read serving path). Returns ``(bounds, positions, words)``
    with ``bounds`` int64[n_reads+1] CSR over the concatenated
    positions/words; positions are read-local. None without the lib
    (caller falls back to the per-read loop)."""
    lib = _load()
    if lib is None:
        return None
    if len(reads) == 0:
        z = np.zeros(1, dtype=np.int64)
        return z, np.zeros(0, dtype=np.int64), np.zeros(0, dtype=np.uint64)
    blob = "".join(reads).encode() if isinstance(reads[0], str) else b"".join(reads)
    codes = seq_to_codes(blob)
    lens = np.fromiter((len(r) for r in reads), dtype=np.int64, count=len(reads))
    rbounds = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum(lens, out=rbounds[1:])
    caps = np.maximum(lens - k + 1, 0)
    cap_off = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum(caps, out=cap_off[1:])
    pos = np.empty(cap_off[-1], dtype=np.int64)
    words = np.empty(cap_off[-1], dtype=np.uint64)
    counts = np.empty(len(reads), dtype=np.int64)
    lib.kmerize_batch(
        codes.ctypes.data_as(ctypes.c_void_p),
        rbounds.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(reads)),
        ctypes.c_int(k),
        cap_off.ctypes.data_as(ctypes.c_void_p),
        pos.ctypes.data_as(ctypes.c_void_p),
        words.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
    )
    bounds = np.zeros(len(reads) + 1, dtype=np.int64)
    np.cumsum(counts, out=bounds[1:])
    if int(bounds[-1]) == int(cap_off[-1]):  # no invalid windows anywhere
        return bounds, pos, words
    sel = np.repeat(np.arange(len(reads)), caps)
    keep = (np.arange(cap_off[-1]) - cap_off[sel]) < counts[sel]
    return bounds, pos[keep], words[keep]


def cumsum_i64(x: np.ndarray) -> np.ndarray:
    """Inclusive prefix sum, int64. NumPy's cumsum runs ~100 MB/s on this
    host; the native two-pass OpenMP scan is memory-bound (~30x)."""
    x = np.ascontiguousarray(x, dtype=np.int64)
    lib = _load()
    if lib is None or len(x) < (1 << 16):
        return np.cumsum(x)
    out = np.empty_like(x)
    lib.cumsum_i64(
        x.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(x)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def expand_ranges(starts: np.ndarray, counts: np.ndarray, total: int | None = None):
    """Concatenate [s, s+1, ..., s+c-1] for each (s, c) pair — the builder's
    range-expansion primitive (replaces np.repeat + arange temp chains)."""
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    offsets = np.concatenate([[0], cumsum_i64(counts)])
    if total is None:
        total = int(offsets[-1])
    lib = _load()
    if lib is None:
        uid = np.repeat(np.arange(len(counts)), counts)
        within = np.arange(total) - np.repeat(offsets[:-1], counts)
        return starts[uid] + within
    out = np.empty(total, dtype=np.int64)
    lib.expand_ranges(
        starts.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(starts)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def fill_prefix_i64(ub: np.ndarray, cum: np.ndarray, T: int) -> np.ndarray | None:
    """Step-function prefix over a bucket table: prefix[t] = total items in
    buckets < t, given sorted occupied bucket ids ``ub`` and cumulative
    totals ``cum`` (inclusive). Returns int64[T+1]; None without the lib."""
    lib = _load()
    if lib is None:
        return None
    ub = np.ascontiguousarray(ub, dtype=np.int64)
    cum = np.ascontiguousarray(cum, dtype=np.int64)
    out = np.empty(T + 1, dtype=np.int64)
    lib.fill_prefix_i64(
        ub.ctypes.data_as(ctypes.c_void_p),
        cum.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(ub)),
        ctypes.c_int64(T),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def fill_pairs_i32(ub: np.ndarray, cum: np.ndarray, T: int) -> np.ndarray | None:
    """Bucket-bounds pairs [T, 2] int32 (the device flat2 layout) straight
    from the sparse occupied-bucket form. None without the lib."""
    lib = _load()
    if lib is None:
        return None
    ub = np.ascontiguousarray(ub, dtype=np.int64)
    cum = np.ascontiguousarray(cum, dtype=np.int64)
    out = np.empty((T, 2), dtype=np.int32)
    lib.fill_pairs_i32(
        ub.ctypes.data_as(ctypes.c_void_p),
        cum.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(ub)),
        ctypes.c_int64(T),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def dedup_flags(mm: np.ndarray, pos: np.ndarray, isfw: np.ndarray) -> np.ndarray | None:
    """keep[i] = element i differs in (mm, pos) from the previous element
    of the same strand class — the per-strand consecutive dedup of the
    minimizer occurrence stream. None without the lib."""
    lib = _load()
    if lib is None:
        return None
    mm = np.ascontiguousarray(mm, dtype=np.uint64)
    pos = np.ascontiguousarray(pos, dtype=np.int64)
    isfw = np.ascontiguousarray(isfw, dtype=np.uint8)
    keep = np.empty(len(mm), dtype=np.uint8)
    lib.dedup_flags(
        mm.ctypes.data_as(ctypes.c_void_p),
        pos.ctypes.data_as(ctypes.c_void_p),
        isfw.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(mm)),
        keep.ctypes.data_as(ctypes.c_void_p),
    )
    return keep.astype(bool)


def pack_width(values: np.ndarray, width: int, nw: int) -> np.ndarray | None:
    """LSB-first fixed-width bit packing into u64 words (IntVector layout).
    Returns None when no native lib (caller falls back to NumPy)."""
    lib = _load()
    if lib is None:
        return None
    values = np.ascontiguousarray(values, dtype=np.uint64)
    words = np.zeros(nw + 1, dtype=np.uint64)
    lib.pack_width(
        values.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(values)),
        ctypes.c_int(int(width)),
        words.ctypes.data_as(ctypes.c_void_p),
    )
    return words[:nw]


def pack_codes2(codes: np.ndarray) -> np.ndarray | None:
    """2-bit DNA packing from byte codes (SeqVector word layout): one
    parallel seam-free pass, no 8x-expanded u64 temp (the NumPy path
    allocates ~17 bytes of fresh pages per base — ruinous at Gbp scale).
    None without the lib."""
    lib = _load()
    if lib is None:
        return None
    codes = np.ascontiguousarray(codes, dtype=np.uint8)
    n = len(codes)
    nw = (2 * n + 63) // 64
    # nw+1 with a zero guard word: SeqVector adopts this buffer as-is
    words = np.zeros(nw + 1, dtype=np.uint64)
    lib.pack_codes2(
        codes.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        words.ctypes.data_as(ctypes.c_void_p),
    )
    return words


def fastq_pack(buf: bytes, k: int) -> dict | None:
    """Fused FASTQ parse + 2-bit stride pack: the decompressed FASTQ text
    straight to the ``reads.pack_reads`` device pytree (words/bad/lengths/
    meta), one C pass each for sizing and filling. Returns None (caller
    falls back to the Python reader, which raises proper errors) when the
    lib is absent or the buffer has anything the fast path doesn't cover
    (malformed/truncated/empty-sequence records)."""
    lib = _load()
    if lib is None:
        return None
    from ..pytree import meta

    lib.fastq_count.restype = ctypes.c_int64
    lib.fastq_fill.restype = ctypes.c_int64
    n = len(buf)
    maxlen = ctypes.c_int64(0)
    R = lib.fastq_count(buf, ctypes.c_int64(n), ctypes.byref(maxlen))
    if R <= 0:
        return None
    maxlen = int(maxlen.value)
    k = int(k)
    L = max(maxlen - k + 1, 1)
    stride = max(((maxlen + 31) // 32) * 32, 32)
    words = np.zeros(R * stride // 32 + 1, dtype=np.uint64)
    badw = np.zeros(-(-R * stride // 64) + 1, dtype=np.uint64)
    lengths = np.zeros(R, dtype=np.int32)
    has_bad = lib.fastq_fill(
        buf,
        ctypes.c_int64(n),
        ctypes.c_int64(R),
        ctypes.c_int64(stride),
        words.ctypes.data_as(ctypes.c_void_p),
        badw.ctypes.data_as(ctypes.c_void_p),
        lengths.ctypes.data_as(ctypes.c_void_p),
    )
    if has_bad < 0:
        return None
    out = {
        "words": words,
        "lengths": lengths,
        "meta": meta(R=int(R), stride=stride, L=L, k=k, has_bad=bool(has_bad)),
    }
    if has_bad:
        out["bad"] = badw
    return out


def minimizer_scan32(useq_words: np.ndarray, kpos: np.ndarray, k: int, w: int, seed: int):
    """Canonical minimizers (hash32 ordering) of the k-mers at ``kpos`` in a
    packed 2-bit useq. Returns (mm u64, offset i32, is_fw bool) with exact
    parity vs kmer.canonical_minimizer_batch; None when no native lib."""
    lib = _load()
    if lib is None:
        return None
    words = np.ascontiguousarray(useq_words, dtype=np.uint64)
    words = np.concatenate([words, np.zeros(1, dtype=np.uint64)])  # read guard
    kpos = np.ascontiguousarray(kpos, dtype=np.int64)
    n = len(kpos)
    mm = np.empty(n, dtype=np.uint64)
    off = np.empty(n, dtype=np.int32)
    isfw = np.empty(n, dtype=np.uint8)
    lib.minimizer_scan32(
        words.ctypes.data_as(ctypes.c_void_p),
        kpos.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        ctypes.c_int(k),
        ctypes.c_int(w),
        ctypes.c_uint32(seed & 0xFFFFFFFF),
        mm.ctypes.data_as(ctypes.c_void_p),
        off.ctypes.data_as(ctypes.c_void_p),
        isfw.ctypes.data_as(ctypes.c_void_p),
    )
    return mm, off, isfw.astype(bool)


def radix_sort_pairs(keys: np.ndarray, vals: np.ndarray, key_bits: int) -> bool:
    """IN-PLACE parallel LSD radix sort of (u64 keys, i64 vals) by key.
    ``key_bits`` bounds the passes (minimizers are < 4^w). Returns False
    when no native lib (caller falls back to np.argsort). Stable, exact
    same order as np.argsort(keys, kind='stable') applied to both arrays."""
    lib = _load()
    if lib is None:
        return False
    assert keys.dtype == np.uint64 and keys.flags.c_contiguous
    assert vals.dtype == np.int64 and vals.flags.c_contiguous
    assert len(keys) == len(vals)
    lib.radix_sort_pairs_u64(
        keys.ctypes.data_as(ctypes.c_void_p),
        vals.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(keys)),
        ctypes.c_int(int(key_bits)),
    )
    return True


def run_bounds(mms: np.ndarray) -> np.ndarray | None:
    """Run start indices of a sorted u64 stream (np.flatnonzero of the
    boundary flags with 0 prepended). None without the lib."""
    lib = _load()
    if lib is None:
        return None
    mms = np.ascontiguousarray(mms, dtype=np.uint64)
    lib.run_bounds_u64.restype = ctypes.c_int64
    m = lib.run_bounds_u64(
        mms.ctypes.data_as(ctypes.c_void_p), ctypes.c_int64(len(mms)), None
    )
    starts = np.empty(m, dtype=np.int64)
    lib.run_bounds_u64(
        mms.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(mms)),
        starts.ctypes.data_as(ctypes.c_void_p),
    )
    return starts


def boophf32_level(keys: np.ndarray, s0: np.ndarray, s1: np.ndarray, n_bits: int):
    """One native BooPHF32 level: advances (s0, s1) chain states IN PLACE,
    returns (words singleton bitmap u32[n_bits/32], drop u8[n]). None
    without the lib."""
    lib = _load()
    if lib is None:
        return None
    n = len(keys)
    words = np.zeros(n_bits // 32, dtype=np.uint32)
    drop = np.empty(n, dtype=np.uint8)
    lib.boophf32_level(
        keys.ctypes.data_as(ctypes.c_void_p),
        s0.ctypes.data_as(ctypes.c_void_p),
        s1.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        ctypes.c_int64(n_bits),
        words.ctypes.data_as(ctypes.c_void_p),
        drop.ctypes.data_as(ctypes.c_void_p),
    )
    return words, drop


def compact_kept(keys, s0, s1, drop):
    """Stable compaction of (keys, s0, s1) where drop==0; returns the new
    (keys, s0, s1) arrays. None without the lib."""
    lib = _load()
    if lib is None:
        return None
    lib.compact_kept.restype = ctypes.c_int64
    n = len(keys)
    ok = np.empty(n, dtype=np.uint64)
    o0 = np.empty(n, dtype=np.uint32)
    o1 = np.empty(n, dtype=np.uint32)
    m = lib.compact_kept(
        keys.ctypes.data_as(ctypes.c_void_p),
        s0.ctypes.data_as(ctypes.c_void_p),
        s1.ctypes.data_as(ctypes.c_void_p),
        drop.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(n),
        ok.ctypes.data_as(ctypes.c_void_p),
        o0.ctypes.data_as(ctypes.c_void_p),
        o1.ctypes.data_as(ctypes.c_void_p),
    )
    return ok[:m].copy(), o0[:m].copy(), o1[:m].copy()


def boophf32_lookup_batch(d: dict, keys: np.ndarray) -> np.ndarray | None:
    """Native batched BooPHF32 lookup over the padded device-array layout
    (bit-parity with kphf.boophf32.boophf32_lookup). None without the lib."""
    lib = _load()
    if lib is None:
        return None
    meta = d["meta"]
    n_levels = len(meta.n_bits)
    keys = np.ascontiguousarray(keys, dtype=np.uint64)
    out = np.empty(len(keys), dtype=np.int32)
    nb = np.asarray(meta.n_bits or (1,), dtype=np.int64)
    wo = np.asarray(meta.word_offsets or (0,), dtype=np.int64)
    ro = np.asarray(meta.rank_offsets or (0,), dtype=np.int64)
    words = np.ascontiguousarray(d["words"], dtype=np.uint32)
    ranks = np.ascontiguousarray(d["ranks"], dtype=np.uint32)
    fhk = np.ascontiguousarray(d["fh_keys"], dtype=np.uint64)
    fhv = np.ascontiguousarray(d["fh_vals"], dtype=np.uint32)
    lib.boophf32_lookup_batch(
        words.ctypes.data_as(ctypes.c_void_p),
        ranks.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int(n_levels),
        nb.ctypes.data_as(ctypes.c_void_p),
        wo.ctypes.data_as(ctypes.c_void_p),
        ro.ctypes.data_as(ctypes.c_void_p),
        fhk.ctypes.data_as(ctypes.c_void_p),
        fhv.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(fhk)),
        keys.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(keys)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out


def minimizer_scan32_ranges(
    useq_words: np.ndarray, starts: np.ndarray, counts: np.ndarray, k: int, w: int, seed: int
):
    """Fused kmer-position generation + canonical minimizer scan: ranges
    (starts[r], counts[r]) replace the 8B/kmer kpos array (a pure multi-GB
    page-fault cost at Gbp scale). Returns (mm u64, occ_pos i64, isfw
    bool) where occ_pos = kmer_pos + minimizer_offset (the value the
    builder derives via np.add). None without the lib."""
    lib = _load()
    if lib is None:
        return None
    words = np.ascontiguousarray(useq_words, dtype=np.uint64)
    words = np.concatenate([words, np.zeros(1, dtype=np.uint64)])  # read guard
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    offsets = np.concatenate([[0], cumsum_i64(counts)])
    n = int(offsets[-1])
    mm = np.empty(n, dtype=np.uint64)
    occ_pos = np.empty(n, dtype=np.int64)
    isfw = np.empty(n, dtype=np.uint8)
    lib.minimizer_scan32_ranges(
        words.ctypes.data_as(ctypes.c_void_p),
        starts.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
        offsets.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(starts)),
        ctypes.c_int(k),
        ctypes.c_int(w),
        ctypes.c_uint32(seed & 0xFFFFFFFF),
        mm.ctypes.data_as(ctypes.c_void_p),
        occ_pos.ctypes.data_as(ctypes.c_void_p),
        isfw.ctypes.data_as(ctypes.c_void_p),
    )
    return mm, occ_pos, isfw.view(bool)


def scatter_ranges_gather(base, starts, counts, dest):
    """out[dest[i] + j] = base[starts[i] + j] — the builder's position
    scatter (ranges from the sorted stream land at their hash-ordered
    destinations). dest rows must be disjoint. None without the lib."""
    lib = _load()
    if lib is None:
        return None
    base = np.ascontiguousarray(base.view(np.int64))
    starts = np.ascontiguousarray(starts, dtype=np.int64)
    counts = np.ascontiguousarray(counts, dtype=np.int64)
    dest = np.ascontiguousarray(dest, dtype=np.int64)
    total = int(counts.sum())
    out = np.zeros(max(total, 1), dtype=np.int64)
    lib.expand_ranges_gather(
        base.ctypes.data_as(ctypes.c_void_p),
        starts.ctypes.data_as(ctypes.c_void_p),
        counts.ctypes.data_as(ctypes.c_void_p),
        dest.ctypes.data_as(ctypes.c_void_p),
        ctypes.c_int64(len(starts)),
        out.ctypes.data_as(ctypes.c_void_p),
    )
    return out.view(np.uint64)[:total]
