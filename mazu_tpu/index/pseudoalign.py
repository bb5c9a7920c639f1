"""Pseudo-alignment: read -> candidate reference set via color-set
intersection (themisto/salmon semantics, built on index/colors.py).

A read's candidate references are the INTERSECTION of the color sets of
its hitting k-mers (k-mer misses are ignored; ``n_hit``/``n_kmers`` are
reported so callers can threshold). This is the core operation of
transcript quantification front-ends; the reference reserves the color
layer (src/lib.rs:26) but implements neither it nor this.

Device formulation: color sets are BITSET rows (u64[n_classes, W],
W = ceil(n_refs/64)) — one wide row gather per hitting k-mer, then a
bitwise-AND reduction along the read (miss lanes contribute the neutral
all-ones row). The whole read batch is ONE fused graph reusing the flat
streaming k2u kernel. Bitsets suit reference panels up to ~10^4-10^5
sequences (W row bytes scale with n_refs); beyond that a CSR-merge
variant belongs on the host.
"""

from __future__ import annotations

import numpy as np

from ..pytree import meta
from .modindex import k2u_batch

U64 = np.uint64


def color_bitsets(cc) -> dict:
    """Pack a ColorClasses CSR into bitset rows + static meta."""
    W = max(1, -(-cc.n_refs // 64))
    bits = np.zeros((max(cc.n_classes, 1), W * 64), dtype=bool)
    if len(cc.refs):
        cls = (
            np.searchsorted(
                cc.offsets, np.arange(len(cc.refs), dtype=np.int64), side="right"
            )
            - 1
        )
        bits[cls, cc.refs] = True
    # LSB-first pack + little-endian u64 view = bit r of word w is ref
    # 64*w + r (matches the unpack in map_reads)
    words = np.packbits(bits, axis=1, bitorder="little").view(np.uint64)
    return {
        "u2c": cc.u2c,
        "bitsets": words,
        "meta": meta(n_refs=cc.n_refs, n_classes=cc.n_classes, W=W),
    }


def pseudoalign_batch(index_arrays: dict, cb: dict, kmat, valid, xp, policy: str = "intersect"):
    """[R, L] k-mer matrix -> per-read (bitset u64[R, W], n_hit, n_kmers).

    One fused graph: flat k2u over all R*L k-mers, class-bitset row gather
    per hit, bitwise reduction along the read. ``policy``:
    "intersect" (themisto default: refs covering EVERY hitting k-mer) or
    "union" (refs covering ANY hitting k-mer).
    """
    R, L = kmat.shape
    r = k2u_batch(index_arrays, kmat.reshape(R * L), xp)
    return pseudoalign_from_k2u(cb, r, valid, xp, policy=policy)


def pseudoalign_from_k2u(cb: dict, r: dict, valid, xp, policy: str = "intersect"):
    """Bitset-reduction half of :func:`pseudoalign_batch` over an ALREADY
    computed k2u result ``r`` (flat, R*L lanes; e.g. the merged output of
    a sharded query — color/bitset arrays are replicated, so sharded
    deployments resolve pseudoalignment per-lane after the psum merge,
    the same split as :func:`colors_from_k2u`)."""
    import jax

    assert policy in ("intersect", "union"), policy
    R, L = valid.shape
    hit = (r["mt"].reshape(R, L) > 0) & valid
    uid = xp.where(hit, r["unitig_id"].reshape(R, L), 0)
    cid = cb["u2c"][uid].astype(xp.int64)
    rows = cb["bitsets"][cid]  # [R, L, W]
    if policy == "intersect":
        neutral, op, red = ~np.uint64(0), jax.lax.bitwise_and, np.bitwise_and
    else:
        neutral, op, red = np.uint64(0), jax.lax.bitwise_or, np.bitwise_or
    rows = xp.where(hit[:, :, None], rows, xp.full_like(rows, neutral))
    if xp is np:
        out = red.reduce(rows, axis=1)
    else:
        out = jax.lax.reduce(rows, xp.asarray(neutral), op, (1,))
    n_hit = hit.sum(axis=1)
    out = xp.where((n_hit > 0)[:, None], out, xp.zeros_like(out))
    return out, n_hit, valid.sum(axis=1)


def tau_q32(tau: float) -> int:
    """Quantize the threshold fraction to 32 fractional bits.

    Both the device kernel and the host counting loop derive
    ``need = max(1, ceil(num * n_hit / 2**32))`` from this integer, so the
    two paths agree EXACTLY (a float ``ceil(tau * n_hit)`` can differ
    between float32/float64 at integer boundaries). Exactly-representable
    taus (0.5, 0.25, 1.0, ...) are unchanged by the quantization.
    """
    assert 0.0 < tau <= 1.0
    return max(1, min(int(round(tau * (1 << 32))), 1 << 32))


def pseudoalign_threshold_batch(index_arrays: dict, cb: dict, kmat, valid, xp, tau_num: int):
    """Threshold policy fully on device: refs covered by >= ceil(tau *
    n_hit) of a read's hitting k-mers, as a candidate bitset u64[R, W].

    Per-ref counts are accumulated with BIT-SLICED vertical counters: a
    scan over the read's L bitset rows ripple-carries into
    ``P = ceil(log2(L+1))`` u64 bit planes (pure word ops, 64 refs per
    lane), so the only per-ref expansion is the final [R, n_refs] i32
    compare against ``need``. Suits panels up to ~10^4-10^5 refs (the
    count matrix is R * n_refs i32); beyond that use the host counting
    path (PseudoAligner(threshold_on="host")).
    """
    R, L = kmat.shape
    r = k2u_batch(index_arrays, kmat.reshape(R * L), xp)
    hit = (r["mt"].reshape(R, L) > 0) & valid
    uid = xp.where(hit, r["unitig_id"].reshape(R, L), 0)
    cid = cb["u2c"][uid].astype(xp.int64)
    rows = cb["bitsets"][cid]  # [R, L, W]
    rows = xp.where(hit[:, :, None], rows, xp.zeros_like(rows))  # miss = +0
    W = rows.shape[2]
    P = max(1, int(L).bit_length())  # counts <= L < 2**P
    if xp is np:
        planes = [np.zeros((R, W), dtype=U64) for _ in range(P)]
        for col in range(L):
            carry = rows[:, col]
            for b in range(P):
                planes[b], carry = planes[b] ^ carry, planes[b] & carry
    else:
        import jax

        def body(pl, row):
            carry = row
            out = []
            for b in range(P):
                out.append(pl[b] ^ carry)
                carry = pl[b] & carry
            return tuple(out), None

        init = tuple(xp.zeros((R, W), U64) for _ in range(P))
        planes, _ = jax.lax.scan(body, init, xp.swapaxes(rows, 0, 1))
    shifts = xp.arange(64, dtype=U64)
    counts = xp.zeros((R, W, 64), xp.int32)
    for b in range(P):
        bit = ((planes[b][:, :, None] >> shifts) & U64(1)).astype(xp.int32)
        counts = counts + (bit << b)
    n_hit = hit.sum(axis=1).astype(xp.int64)
    # need = ceil(tau_num * n_hit / 2**32), clamped to >= 1
    need = xp.maximum(1, -(-(tau_num * n_hit) // (1 << 32)))
    cand = (counts >= need[:, None, None]) & (n_hit > 0)[:, None, None]
    words = (cand.astype(U64) << shifts).sum(axis=2)
    return words, n_hit, valid.sum(axis=1)


def classify_kmers(index_arrays: dict, cb: dict, kmat, valid, xp):
    """Per-k-mer class ids + hit mask (device part of the threshold
    policy; the per-ref counting happens on host over these small
    [R, L] outputs)."""
    R, L = kmat.shape
    r = k2u_batch(index_arrays, kmat.reshape(R * L), xp)
    hit = (r["mt"].reshape(R, L) > 0) & valid
    uid = xp.where(hit, r["unitig_id"].reshape(R, L), 0)
    cid = cb["u2c"][uid].astype(xp.int32)
    return xp.where(hit, cid, xp.full_like(cid, -1)), hit


class PseudoAligner:
    """Batched pseudo-aligner over a ModIndex (+ its color classes).

    Policies (themisto-style):
    - "intersect": refs covering EVERY hitting k-mer (default)
    - "union": refs covering ANY hitting k-mer
    - "threshold": refs covering >= ceil(tau * n_hit) hitting k-mers
      (tau=1.0 == intersect, tau->0 == union). By default the per-ref
      counting runs ON DEVICE (bit-sliced vertical counters over the
      color bitsets, one fused graph); ``threshold_on="host"`` keeps the
      device part bitset-free (classify only) and counts on host.

    Panel-size note: intersect/union/threshold(device) gather
    W = ceil(n_refs/64) u64 words per hitting k-mer — right up to
    ~10^4-10^5 refs (the device count matrix is R * n_refs i32). For
    larger panels use policy="threshold", threshold_on="host" (tau=1.0
    reproduces intersect exactly): the host counting touches only each
    read's own classes. tau is quantized to 32 fractional bits (tau_q32)
    so both counting paths share one exact integer ``need``.
    """

    def __init__(
        self,
        index,
        cc=None,
        use_jit: bool = True,
        policy: str = "intersect",
        tau: float = 0.7,
        threshold_on: str = "device",
    ):
        self.index = index
        self.k = index.k
        assert policy in ("intersect", "union", "threshold"), policy
        assert threshold_on in ("device", "host"), threshold_on
        assert 0.0 < tau <= 1.0
        cc = index.color_classes() if cc is None else cc
        self.cc = cc
        self.policy = policy
        self.tau = float(tau)
        self.threshold_on = threshold_on
        self._tau_num = tau_q32(self.tau)
        self._cb = color_bitsets(cc)
        self._arrays = index.device_arrays()
        self.use_jit = use_jit
        if use_jit:
            import jax
            import jax.numpy as jnp

            self._d_arrays = jax.device_put(self._arrays)
            self._d_cb = jax.device_put(self._cb)
            if policy == "threshold" and threshold_on == "host":
                self._fn = jax.jit(
                    lambda a, c, km, v: classify_kmers(a, c, km, v, jnp)
                )
            elif policy == "threshold":
                tn = self._tau_num
                self._fn = jax.jit(
                    lambda a, c, km, v: pseudoalign_threshold_batch(a, c, km, v, jnp, tn)
                )
            else:
                self._fn = jax.jit(
                    lambda a, c, km, v: pseudoalign_batch(a, c, km, v, jnp, policy)
                )

    def map_kmer_matrix(self, kmat: np.ndarray, valid: np.ndarray):
        if self.use_jit:
            import jax.numpy as jnp

            inter, n_hit, n_k = self._fn(
                self._d_arrays, self._d_cb, jnp.asarray(kmat), jnp.asarray(valid)
            )
            return np.asarray(inter), np.asarray(n_hit), np.asarray(n_k)
        if self.policy == "threshold":
            return pseudoalign_threshold_batch(
                self._arrays, self._cb, kmat, valid, np, self._tau_num
            )
        return pseudoalign_batch(self._arrays, self._cb, kmat, valid, np, self.policy)

    def _map_threshold(self, kmat: np.ndarray, valid: np.ndarray):
        if self.use_jit:
            import jax.numpy as jnp

            cid, hit = self._fn(
                self._d_arrays, self._d_cb, jnp.asarray(kmat), jnp.asarray(valid)
            )
            cid, hit = np.asarray(cid), np.asarray(hit)
        else:
            cid, hit = classify_kmers(self._arrays, self._cb, kmat, valid, np)
        out = []
        for i in range(len(kmat)):
            cids = cid[i][hit[i]]
            n_hit, n_k = len(cids), int(valid[i].sum())
            if n_hit == 0:
                out.append((np.zeros(0, dtype=np.int64), 0, n_k))
                continue
            need = max(1, -(-self._tau_num * n_hit // (1 << 32)))
            uc, cnt = np.unique(cids, return_counts=True)
            ref_counts = np.zeros(self.cc.n_refs, dtype=np.int64)
            for c, n in zip(uc.tolist(), cnt.tolist()):
                ref_counts[self.cc.refs_of_class(c)] += n
            out.append((np.flatnonzero(ref_counts >= need), n_hit, n_k))
        return out

    def map_reads(self, reads: list[str]):
        """Returns per read: (sorted ref-id array, n_hit, n_kmers)."""
        from .streaming import kmerize_reads

        kmat, valid, _ = kmerize_reads(reads, self.k)
        if self.policy == "threshold" and self.threshold_on == "host":
            return self._map_threshold(kmat, valid)
        inter, n_hit, n_k = self.map_kmer_matrix(kmat, valid)
        bits = np.unpackbits(
            inter.view(np.uint8), bitorder="little", axis=1
        )[:, : self.cc.n_refs]
        return [
            (np.flatnonzero(bits[i]), int(n_hit[i]), int(n_k[i]))
            for i in range(len(reads))
        ]

    def map_file(self, path: str):
        from ..io.fastq import read_seqs

        return self.map_reads([seq for _, seq in read_seqs(path)])
