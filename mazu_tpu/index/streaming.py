"""Streaming queries: the k-mer cache, batched.

Reference semantics (src/index/caching.rs): consecutive k-mers of a read
usually continue on the same unitig; a warm query checks position+1 on the
previous unitig (one fetch + equivalency) before falling back to a cold
full dictionary probe. Results are IDENTICAL to cold queries — the cache is
purely a work-saving device.

Device reformulation: reads are lanes. A scan over k-mer index j runs a cheap
vectorized warm kernel on all R lanes; lanes that miss are compacted on the
host and re-queried through the full k2u kernel in padded buckets (padded
to powers of two to bound recompiles). Warm-hit rate on L-k-mer reads is
~(L-1)/L, so the expensive probe runs on a tiny fraction of k-mers.

Two execution modes:

- host loop (default): per-column dispatch with host compaction of cold
  lanes — optimal WORK (cold probes only on cold lanes), the right mode
  when the cold probe is expensive (compact parity engines) and dispatch
  is cheap (CPU, local accelerators).
- ``device_scan=True``: the WHOLE matrix runs as one jitted ``lax.scan``
  over columns — no per-column host round trip. The cold kernel runs
  masked on all lanes, so per-column work is not reduced (the flat batched
  cold kernel resolves ~1-2 random gathers/k-mer, less than any
  warm/merge scheme pays). Results are IDENTICAL to the host loop.
- ``mode="flat"``: the device speed path for cache semantics. One jitted
  graph: the flat batched cold kernel over all R*L k-mers (full gather
  amortization — the scan's per-column dispatches are only R lanes wide),
  then warm flags DERIVED vectorized from result continuity. K-mers in a
  unitig set are unique (compacted dBG invariant the reference's cache
  also relies on: a warm probe at prev_pos±1 succeeds iff the dictionary
  maps this k-mer there), so ``warm(i,j) = hit(i,j) & hit(i,j-1) &
  same_unitig & |Δpos| == 1`` reproduces the sequential cache's warm/cold
  accounting bit-identically (asserted vs the host loop in tests and in
  the readscache bench).
"""

from __future__ import annotations

import numpy as np

from ..containers.unitig_set import us_get_kmer
from ..kmer import revcomp, word_equivalency
from .modindex import ModIndex, k2u_batch


def _warm_kernel(arrays, carry, fw, xp):
    """Check whether each lane's k-mer continues on the previous unitig.

    The reference warm check probes only pos+1 (src/index/caching.rs:73-97),
    which goes cold for reads traversing a unitig in the reverse
    orientation. We probe pos+1 and pos-1 — results are identical (the
    cold path would find the same hit), but reverse-strand reads stay warm,
    roughly halving cold probes on mixed-orientation workloads."""
    us = arrays["k2u"]["us"]
    k = arrays["meta"].k
    rc = revcomp(fw, k)
    out = None
    for step in (1, -1):
        next_pos = carry["pos"] + step
        ok_next = (
            carry["valid"] & (next_pos >= 0) & (next_pos <= carry["unitig_len"] - k)
        )
        gpos = us["accum"][carry["unitig_id"]] + next_pos
        gpos = xp.clip(gpos, 0, max(us["meta"].total_len - k, 0))
        kw = us_get_kmer(us, gpos, xp)
        mt = word_equivalency(fw, rc, kw, k)
        warm = ok_next & (mt > 0)
        if out is None:
            out = {
                "warm": warm,
                "unitig_id": carry["unitig_id"],
                "unitig_len": carry["unitig_len"],
                "pos": next_pos,
                "mt": mt,
            }
        else:
            take = warm & (~out["warm"])
            out["pos"] = xp.where(take, next_pos, out["pos"])
            out["mt"] = xp.where(take, mt, out["mt"])
            out["warm"] = out["warm"] | warm
    return out


def _bucket_size(n: int) -> int:
    b = 1
    while b < n:
        b <<= 1
    return b


class StreamingIndex:
    """Batched streaming wrapper around a ModIndex — or a bare K2U
    dictionary (then only k2u_reads is available)."""

    def __init__(
        self,
        index,
        use_jit: bool = True,
        device_scan: bool = False,
        mode: str | None = None,
    ):
        if hasattr(index, "u2pos"):
            self.index = index
            self._np_arrays = index.device_arrays()
        else:  # bare K2U (reference StreamingK2U, src/index/caching.rs:13-17)
            from ..pytree import meta as make_meta

            self.index = None
            self._np_arrays = {
                "k2u": index.device_arrays(),
                "meta": make_meta(k=index.k, index_type="K2U"),
            }
        self.k = index.k
        self.use_jit = use_jit
        if mode is None:
            mode = "scan" if device_scan else "host"
        assert mode in ("host", "scan", "flat"), mode
        self.mode = mode
        self.device_scan = mode == "scan"
        assert not (mode != "host" and not use_jit), f"{mode} requires jit"
        self._scan_fn = None
        self._flat_fn_cache = None
        self._flat_packed_cache = None
        if use_jit:
            import jax
            import jax.numpy as jnp

            self._arrays = jax.device_put(self._np_arrays)

            @jax.jit
            def warm(carry, fw):
                return _warm_kernel(self._arrays, carry, fw, jnp)

            @jax.jit
            def cold(fw):
                return k2u_batch(self._arrays, fw, jnp)

            self._warm = lambda c, f: {
                kk: np.asarray(v) for kk, v in warm(c, jnp.asarray(f)).items()
            }
            self._cold = lambda f: {
                kk: np.asarray(v) for kk, v in cold(jnp.asarray(f)).items()
            }
        else:
            self._warm = lambda c, f: _warm_kernel(self._np_arrays, c, f, np)
            self._cold = lambda f: k2u_batch(self._np_arrays, f, np)

    def _device_scan_fn(self):
        """One jitted graph for the whole [R, L] matrix: lax.scan over
        columns, warm kernel + masked cold kernel fused per step."""
        if self._scan_fn is not None:
            return self._scan_fn
        import jax
        import jax.numpy as jnp

        def step(carry, col):
            fw, val = col
            w = _warm_kernel(self._arrays, carry, fw, jnp)
            c = k2u_batch(self._arrays, fw, jnp)
            warm = w["warm"] & val
            res = {}
            for key in ("unitig_id", "unitig_len", "pos"):
                res[key] = jnp.where(
                    warm, w[key], jnp.where(val, c[key], jnp.zeros_like(c[key]))
                )
            mt = jnp.where(
                warm,
                w["mt"].astype(jnp.uint8),
                jnp.where(val, c["mt"].astype(jnp.uint8), jnp.uint8(0)),
            )
            res["mt"] = mt
            carry2 = {
                "unitig_id": res["unitig_id"],
                "unitig_len": res["unitig_len"],
                "pos": res["pos"],
                "valid": mt > 0,
            }
            n_cold = (val & ~warm).sum()
            return carry2, (res, n_cold)

        @jax.jit
        def scan(kmat, valid):
            R = kmat.shape[0]
            carry = {
                "unitig_id": jnp.zeros(R, dtype=jnp.int64),
                "unitig_len": jnp.zeros(R, dtype=jnp.int64),
                "pos": jnp.zeros(R, dtype=jnp.int64),
                "valid": jnp.zeros(R, dtype=bool),
            }
            _, (out, n_cold) = jax.lax.scan(step, carry, (kmat.T, valid.T))
            return {kk: v.T for kk, v in out.items()}, n_cold.sum()

        self._scan_fn = scan
        return scan

    def _flat_fn(self):
        """One jitted graph: flat batched cold kernel over all R*L k-mers +
        vectorized warm-flag derivation (see module docstring). The index
        pytree travels as a jit ARGUMENT (never a closure constant)."""
        if self._flat_fn_cache is not None:
            return self._flat_fn_cache
        import jax
        import jax.numpy as jnp

        def flatq(arrays, kmat, valid):
            R, L = kmat.shape
            c = k2u_batch(arrays, kmat.reshape(R * L), jnp)
            uid = c["unitig_id"].reshape(R, L)
            ulen = c["unitig_len"].reshape(R, L)
            pos = c["pos"].reshape(R, L)
            mt = c["mt"].reshape(R, L).astype(jnp.uint8)
            hit = (mt > 0) & valid
            # warm(i,j): prev column hit the same unitig at pos±1. By k-mer
            # uniqueness this is exactly when the sequential warm probe
            # (reference src/index/caching.rs:73-97 + the bidirectional
            # improvement) succeeds, so the accounting matches the scan.
            same_u = uid[:, 1:] == uid[:, :-1]
            dpos = pos[:, 1:] - pos[:, :-1]
            warm_tail = (
                hit[:, 1:] & hit[:, :-1] & same_u & ((dpos == 1) | (dpos == -1))
            )
            warm = jnp.concatenate(
                [jnp.zeros((R, 1), dtype=bool), warm_tail], axis=1
            )
            n_cold = (valid & ~warm).sum()
            out = {
                "unitig_id": jnp.where(valid, uid, jnp.zeros_like(uid)),
                "unitig_len": jnp.where(valid, ulen, jnp.zeros_like(ulen)),
                "pos": jnp.where(valid, pos, jnp.zeros_like(pos)),
                "mt": jnp.where(valid, mt, jnp.zeros_like(mt)),
            }
            return out, n_cold

        self._flat_fn_cache = jax.jit(flatq)
        return self._flat_fn_cache

    def _flat_packed_fn(self):
        """Fused ingest+query graph: device k-merization of 2-bit packed
        reads (io/reads.py — ~26x fewer host->device bytes than k-mer
        words) feeding the flat cold kernel + derived warm flags. One jit;
        index pytree and packed reads both travel as ARGUMENTS."""
        if self._flat_packed_cache is not None:
            return self._flat_packed_cache
        import jax

        from ..io.reads import kmerize_device

        flatq = self._flat_fn()

        def packedq(arrays, packed):
            import jax.numpy as jnp

            kmat, valid = kmerize_device(packed, jnp)
            out, n_cold = flatq(arrays, kmat, valid)
            return out, n_cold, valid.sum()

        self._flat_packed_cache = jax.jit(packedq)
        return self._flat_packed_cache

    def k2u_reads_packed(self, packed: dict):
        """k2u_reads from a ``pack_reads`` pytree: upload bases, k-merize
        on device, query — results identical to
        ``k2u_reads(*kmerize_reads(reads, k))``."""
        import jax

        out, n_cold, n_valid = self._flat_packed_fn()(
            self._arrays, jax.device_put(packed)
        )
        self.last_cold_fraction = int(n_cold) / max(1, int(n_valid))
        return {kk: np.asarray(v) for kk, v in out.items()}

    def k2u_reads(self, kmer_matrix: np.ndarray, valid: np.ndarray):
        """Streaming k2u over a lane-major k-mer matrix.

        kmer_matrix: uint64[R, L] (fw-orientation words), valid: bool[R, L]
        (False entries are skipped and reported as misses). Returns dict of
        [R, L] arrays (unitig_id, unitig_len, pos, mt) — identical to the
        cold batched k2u, computed with ~1 cold probe per unitig run
        (host loop) or in one dispatch (``device_scan``).
        """
        R, L = kmer_matrix.shape
        if self.mode == "flat":
            import jax.numpy as jnp

            out, n_cold = self._flat_fn()(
                self._arrays, jnp.asarray(kmer_matrix), jnp.asarray(valid)
            )
            self.last_cold_fraction = int(n_cold) / max(1, int(valid.sum()))
            return {kk: np.asarray(v) for kk, v in out.items()}
        if self.device_scan:
            import jax.numpy as jnp

            out, n_cold = self._device_scan_fn()(
                jnp.asarray(kmer_matrix), jnp.asarray(valid)
            )
            self.last_cold_fraction = int(n_cold) / max(1, int(valid.sum()))
            return {kk: np.asarray(v) for kk, v in out.items()}
        carry = {
            "unitig_id": np.zeros(R, dtype=np.int64),
            "unitig_len": np.zeros(R, dtype=np.int64),
            "pos": np.zeros(R, dtype=np.int64),
            "valid": np.zeros(R, dtype=bool),
        }
        out = {
            "unitig_id": np.zeros((R, L), dtype=np.int64),
            "unitig_len": np.zeros((R, L), dtype=np.int64),
            "pos": np.zeros((R, L), dtype=np.int64),
            "mt": np.zeros((R, L), dtype=np.uint8),
        }
        n_cold = 0
        for j in range(L):
            fw = kmer_matrix[:, j]
            w = self._warm(carry, fw)
            warm = np.asarray(w["warm"]) & valid[:, j]
            cold_lanes = np.flatnonzero(~warm & valid[:, j])
            res = {
                "unitig_id": np.where(warm, w["unitig_id"], 0),
                "unitig_len": np.where(warm, w["unitig_len"], 0),
                "pos": np.where(warm, w["pos"], 0),
                "mt": np.where(warm, w["mt"], 0).astype(np.uint8),
            }
            if len(cold_lanes):
                n_cold += len(cold_lanes)
                b = _bucket_size(len(cold_lanes))
                padded = np.zeros(b, dtype=np.uint64)
                padded[: len(cold_lanes)] = fw[cold_lanes]
                c = self._cold(padded)
                for key in ("unitig_id", "unitig_len", "pos"):
                    res[key][cold_lanes] = np.asarray(c[key][: len(cold_lanes)])
                res["mt"][cold_lanes] = np.asarray(c["mt"][: len(cold_lanes)])
            for key in out:
                out[key][:, j] = res[key]
            carry = {
                "unitig_id": res["unitig_id"],
                "unitig_len": res["unitig_len"],
                "pos": res["pos"],
                "valid": res["mt"] > 0,
            }
        self.last_cold_fraction = n_cold / max(1, int(valid.sum()))
        return out

    def get_ref_pos_reads(self, kmer_matrix, valid, max_occs: int | None = None):
        """Streaming get_ref_pos: k2u_reads + occurrence projection."""
        from .. import MATCH_IDENTITY
        from .unitig_table import decode_occs

        assert self.index is not None, "projection needs a full ModIndex"
        r = self.k2u_reads(kmer_matrix, valid)
        u2 = self._np_arrays["u2pos"]
        if max_occs is None:
            max_occs = max(1, self.index.max_occs())
        R, L = kmer_matrix.shape
        flat = {kk: v.reshape(R * L) for kk, v in r.items()}
        hit = flat["mt"] > 0
        uid = np.where(hit, flat["unitig_id"], 0)
        start = u2["offsets"][uid]
        cnt = np.where(hit, u2["offsets"][uid + 1] - start, 0)
        j = np.arange(max_occs)
        occ_idx = np.clip(start[:, None] + j[None, :], 0, max(u2["meta"].n_occs - 1, 0))
        valid_occ = j[None, :] < cnt[:, None]
        ref_id, occ_pos, occ_o = decode_occs(u2, occ_idx, np)
        k = self.k
        kpos = flat["pos"][:, None]
        ulen = flat["unitig_len"][:, None]
        ref_pos = np.where(occ_o == 1, kpos + occ_pos, occ_pos + (ulen - kpos) - k)
        o_match = (flat["mt"] == MATCH_IDENTITY).astype(np.int32)[:, None]
        orient = np.where(occ_o == 1, o_match, 1 - o_match)
        return {
            **{kk: v.reshape(R, L) for kk, v in flat.items()},
            "n_occs": cnt.reshape(R, L),
            "ref_id": ref_id.reshape(R, L, max_occs),
            "ref_pos": ref_pos.reshape(R, L, max_occs),
            "orient": orient.reshape(R, L, max_occs),
            "valid": valid_occ.reshape(R, L, max_occs),
        }


def kmerize_reads(reads: list[str], k: int):
    """Host k-merization of variable-length reads into a padded lane-major
    matrix: (kmers uint64[R, L], valid bool[R, L], positions int64[R, L])."""
    from .validate import valid_kmer_windows

    R = len(reads)
    L = max((len(r) - k + 1 for r in reads), default=0)
    L = max(L, 1)
    kms = np.zeros((R, L), dtype=np.uint64)
    valid = np.zeros((R, L), dtype=bool)
    positions = np.zeros((R, L), dtype=np.int64)
    for i, read in enumerate(reads):
        pos, words = valid_kmer_windows(read, k)
        kms[i, : len(words)] = words
        valid[i, : len(words)] = True
        positions[i, : len(words)] = pos
    return kms, valid, positions


def validate_fasta_streaming(
    index: ModIndex, path: str, lanes: int = 256, window: int = 2048
):
    """Streaming-path oracle: results must match the cold path on a FASTA
    (reference src/index/caching.rs:204-218).

    Long records are chopped into overlapping ``window``-sized lanes (the
    streaming cache is exact regardless of lane boundaries — boundary
    k-mers simply take a cold probe)."""
    from ..io.fasta import read_fasta

    si = StreamingIndex(index)
    pieces = []  # (ref_id, window_start, subseq)
    for ri, (_name, seq) in enumerate(read_fasta(path)):
        k = index.k
        step = window - (k - 1)
        for s in range(0, max(len(seq) - k + 1, 1), step):
            pieces.append((ri, s, seq[s : s + window]))

    for s in range(0, len(pieces), lanes):
        chunk = pieces[s : s + lanes]
        kms, valid, positions = kmerize_reads([p[2] for p in chunk], index.k)
        out = si.get_ref_pos_reads(kms, valid)
        for i, (ri, wstart, _) in enumerate(chunk):
            nv = int(valid[i].sum())
            want_pos = positions[i, :nv] + wstart
            ok = (
                (out["valid"][i, :nv])
                & (out["ref_id"][i, :nv] == ri)
                & (out["ref_pos"][i, :nv] == want_pos[:, None])
            ).any(axis=1)
            if not ok.all():
                bad = int(np.flatnonzero(~ok)[0])
                raise AssertionError(
                    f"streaming: no matching MRP in ref {ri} @ pos {want_pos[bad]}"
                )
