"""Two-phase full-query driver: the production serving path.

Phase 1 (whole batch, slim kernel): main-path k2u (no skew-structure
gathers) + occurrence projection padded to a SMALL width (default 2 —
covers ~99% of unitigs). Lanes that hit a heavy minimizer bucket or have
more occurrences than the small width are flagged.

Phase 2 (compacted flagged lanes, pow2-padded): full k2u + projection
padded to the index-wide max occurrence count.

Results are exactly those of the one-kernel full pipeline; the rare
expensive lanes no longer tax the whole batch (SIMD pays per-lane costs
batch-wide otherwise). Mirrors the reference's streaming cache philosophy
(src/index/caching.rs): do the cheap thing always, fall back rarely.
"""

from __future__ import annotations

import numpy as np

from .. import MATCH_IDENTITY
from .modindex import ModIndex, get_ref_pos_padded


def _main_phase(arrays, fw, xp, small_occs: int, probe_limit: int | None = None):
    if arrays["k2u"]["meta"].kind == "kcdict":
        from ..kphf.kcdict import kcdict_k2u

        r = kcdict_k2u(arrays["k2u"], fw, xp, mode="main")
    else:
        from ..kphf.sshash import sshash_k2u

        r = sshash_k2u(arrays["k2u"], fw, xp, mode="main", probe_limit=probe_limit)

    if "occ_cnt" in r:
        # fused layout: the probe row carried (first_occ_word, occ_cnt) —
        # single-occurrence lanes project with ZERO extra gathers
        p = _project_fused(arrays, r, xp)
        if "unresolved" in r:
            p["overflow"] = p["overflow"] | r["unresolved"]
        return p

    return _project_offsets(arrays, r, xp, small_occs)


def _project_offsets(arrays, r, xp, small_occs: int):
    """Small-width occurrence projection via the offsets table (2 extra
    gathers) for NON-fused layouts (the packed/EF compact tiers).

    ``overflow`` folds in heavy-bucket lanes (use_skew), shallow-probe
    lanes left unsettled (unresolved — present when a probe_limit was
    set), and lanes whose unitig has more occurrences than ``small_occs``;
    all of those re-resolve exactly in the caller's phase 2."""
    from .unitig_table import fetch_occ_block

    u2 = arrays["u2pos"]
    k = arrays["meta"].k
    hit = r["mt"] > 0
    uid = xp.where(hit, r["unitig_id"], xp.zeros_like(r["unitig_id"]))
    start = u2["offsets"][uid]
    cnt = xp.where(hit, u2["offsets"][uid + 1] - start, xp.zeros_like(start))
    overflow = r["use_skew"] | (cnt > small_occs)
    if "unresolved" in r:
        overflow = overflow | r["unresolved"]

    j = xp.arange(small_occs, dtype=start.dtype)
    valid = (j[None, :] < cnt[:, None]) & (~overflow)[:, None]
    ref_id, occ_pos, occ_o = fetch_occ_block(u2, start, small_occs, xp)
    kpos = r["pos"][:, None]
    ulen = r["unitig_len"][:, None]
    ref_pos = xp.where(occ_o == 1, kpos + occ_pos, occ_pos + (ulen - kpos) - k)
    o_match = (r["mt"] == MATCH_IDENTITY).astype(xp.int32)[:, None]
    orient = xp.where(occ_o == 1, o_match, 1 - o_match)
    return {
        **{kk: r[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
        "n_occs": cnt,
        "ref_id": ref_id,
        "ref_pos": ref_pos,
        "orient": orient,
        "valid": valid,
        "overflow": overflow,
    }


def _project_fused(arrays, r, xp):
    """Projection from fused k2u outputs (occ_word/occ_cnt) — zero gathers.
    With the inline2 layout (occ_word2 present) the row carries the first
    TWO occurrences: cnt <= 2 lanes complete without overflow."""
    from .unitig_table import decode_words

    u2 = arrays["u2pos"]
    k = arrays["meta"].k
    hit = r["mt"] > 0
    cnt = xp.where(hit, r["occ_cnt"], xp.zeros_like(r["occ_cnt"]))
    width = 2 if "occ_word2" in r else 1
    overflow = r["use_skew"] | (cnt > width)
    kpos = r["pos"]
    ulen = r["unitig_len"]
    o_match = (r["mt"] == MATCH_IDENTITY).astype(xp.int32)

    def proj(word):
        ref_id, occ_pos, occ_o = decode_words(u2, word, xp)
        ref_pos = xp.where(occ_o == 1, kpos + occ_pos, occ_pos + (ulen - kpos) - k)
        orient = xp.where(occ_o == 1, o_match, 1 - o_match)
        return ref_id, ref_pos, orient

    r1, p1, o1 = proj(r["occ_word"])
    base_valid = hit & (~overflow)
    if width == 2:
        r2, p2, o2 = proj(r["occ_word2"])
        ref_id = xp.stack([r1, r2], axis=1)
        ref_pos = xp.stack([p1, p2], axis=1)
        orient = xp.stack([o1, o2], axis=1)
        valid = xp.stack([base_valid & (cnt >= 1), base_valid & (cnt >= 2)], axis=1)
    else:
        ref_id = r1[:, None]
        ref_pos = p1[:, None]
        orient = o1[:, None]
        valid = (base_valid & (cnt >= 1))[:, None]
    return {
        **{kk: r[kk] for kk in ("unitig_id", "unitig_len", "pos", "mt")},
        "n_occs": cnt,
        "ref_id": ref_id,
        "ref_pos": ref_pos,
        "orient": orient,
        "valid": valid,
        "overflow": overflow,
    }


class ReadBatchQuery:
    """Read-pipeline driver: run-sharing main kernel (consecutive k-mers
    share bucket-row fetches) + fused projection + compact overflow pass.
    Results identical to the plain path; main kernel issues no N-sized
    gathers at all."""

    def __init__(self, index: ModIndex, device=None):
        import jax
        import jax.numpy as jnp

        from ..kphf.runshare import sshash_k2u_reads_runshare

        self._jnp = jnp
        self.max_occs = max(1, index.max_occs())
        self.arrays = jax.device_put(index.device_arrays(fused=True), device)

        @jax.jit
        def main_chk_a(arrays, fw, new_read):
            r = sshash_k2u_reads_runshare(arrays["k2u"], fw, new_read, jnp)
            p = _project_fused(arrays, r, jnp)
            s = (
                jnp.where(p["valid"], p["ref_pos"], 0).sum()
                + jnp.where(p["valid"], p["ref_id"], 0).sum()
                + p["unitig_id"].sum()
            )
            ov = p["overflow"]
            pad = (-ov.shape[0]) % 32
            ovp = jnp.pad(ov, (0, pad)).reshape(-1, 32)
            weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
            packed = (ovp.astype(jnp.uint32) * weights).sum(axis=1).astype(jnp.uint32)
            return s, packed, r["run_overflow"]

        @jax.jit
        def full_chk_a(arrays, fw, n_real):
            out = get_ref_pos_padded(arrays, fw, jnp, self.max_occs)
            lane_ok = jnp.arange(fw.shape[0]) < n_real
            v = out["valid"] & lane_ok[:, None]
            return (
                jnp.where(v, out["ref_pos"], 0).sum()
                + jnp.where(v, out["ref_id"], 0).sum()
                + jnp.where(lane_ok, out["unitig_id"], 0).sum()
            )

        self.main_chk = lambda fw, nr: main_chk_a(self.arrays, fw, nr)
        self.full_chk = lambda fw, n: full_chk_a(self.arrays, fw, n)

    def checksum_query(self, fw_dev, fw_host: np.ndarray, new_read_dev):
        import jax

        jnp = self._jnp
        chk, packed, run_ovf = self.main_chk(fw_dev, new_read_dev)
        assert not bool(jax.device_get(run_ovf)), "run budget exceeded (not a read batch?)"
        packed = np.asarray(jax.device_get(packed))
        bits = np.unpackbits(packed.view(np.uint8), bitorder="little")
        lanes = np.flatnonzero(bits[: len(fw_host)])
        total = int(jax.device_get(chk))
        if len(lanes):
            b = 1 << max(6, int(np.ceil(np.log2(len(lanes)))))
            padded = np.zeros(b, dtype=np.uint64)
            padded[: len(lanes)] = fw_host[lanes]
            total += int(jax.device_get(self.full_chk(jnp.asarray(padded), len(lanes))))
        return total, len(lanes)


class TwoPhaseIndexQuery:
    def __init__(
        self,
        index: ModIndex,
        small_occs: int = 2,
        device=None,
        fused: bool | None = None,
        probe_limit: int | None = None,
        pos_kind: str | None = None,
    ):
        import jax
        import jax.numpy as jnp

        self._jnp = jnp
        self.small_occs = int(small_occs)
        self.max_occs = max(1, index.max_occs())
        if fused is None:
            fused = (
                getattr(index.k2u, "hash32", False)
                and index.k2u.__class__.__name__ == "SSHash"
            )
        self.arrays = jax.device_put(index.device_arrays(fused=fused), device)

        self.probe_limit = probe_limit

        # arrays travel as jit ARGUMENTS, never closures: closed-over device
        # pytrees are lowered as captured CONSTANTS (gigabytes for large
        # indexes -> unbounded compile payloads)
        @jax.jit
        def main_a(arrays, fw):
            return _main_phase(arrays, fw, jnp, self.small_occs, probe_limit)

        @jax.jit
        def full_a(arrays, fw):
            return get_ref_pos_padded(arrays, fw, jnp, self.max_occs)

        self.main = lambda fw: main_a(self.arrays, fw)
        self.full = lambda fw: full_a(self.arrays, fw)

    def checksum_query(self, fw_words_dev, fw_words_host: np.ndarray):
        """Bench path: full two-phase query with results REDUCED on device
        (only the overflow bitmap and scalar checksums cross the host link).
        Returns (checksum:int, n_overflow:int)."""
        import jax

        jnp = self._jnp
        if not hasattr(self, "_main_chk"):

            @jax.jit
            def main_chk_a(arrays, fw):
                r = _main_phase(arrays, fw, jnp, self.small_occs, self.probe_limit)
                s = (
                    jnp.where(r["valid"], r["ref_pos"], 0).sum()
                    + jnp.where(r["valid"], r["ref_id"], 0).sum()
                    + r["unitig_id"].sum()
                )
                # bit-pack the overflow flags on device: 32x less readback
                ov = r["overflow"]
                pad = (-ov.shape[0]) % 32
                ovp = jnp.pad(ov, (0, pad)).reshape(-1, 32)
                weights = (jnp.uint32(1) << jnp.arange(32, dtype=jnp.uint32))[None, :]
                packed = (ovp.astype(jnp.uint32) * weights).sum(axis=1).astype(jnp.uint32)
                return s, packed

            @jax.jit
            def full_chk_a(arrays, fw, n_real):
                r = get_ref_pos_padded(arrays, fw, jnp, self.max_occs)
                lane_ok = jnp.arange(fw.shape[0]) < n_real
                v = r["valid"] & lane_ok[:, None]
                return (
                    jnp.where(v, r["ref_pos"], 0).sum()
                    + jnp.where(v, r["ref_id"], 0).sum()
                    + jnp.where(lane_ok, r["unitig_id"], 0).sum()
                )

            self._main_chk_a = main_chk_a
            self._main_chk = lambda fw: main_chk_a(self.arrays, fw)
            self._full_chk = lambda fw, n: full_chk_a(self.arrays, fw, n)

        chk, packed = self._main_chk(fw_words_dev)
        packed = np.asarray(jax.device_get(packed))
        bits = np.unpackbits(packed.view(np.uint8), bitorder="little")
        lanes = np.flatnonzero(bits[: len(fw_words_host)])
        total = int(jax.device_get(chk))
        if len(lanes):
            b = 1 << max(6, int(np.ceil(np.log2(len(lanes)))))
            padded = np.zeros(b, dtype=np.uint64)
            padded[: len(lanes)] = fw_words_host[lanes]
            total += int(jax.device_get(self._full_chk(jnp.asarray(padded), len(lanes))))
        return total, len(lanes)

    def query(self, fw_words: np.ndarray):
        """Returns (main_out, overflow_lane_indices, overflow_out).

        main_out holds exact results for non-overflow lanes (occurrences
        padded to small_occs); overflow_out holds exact results for
        ``overflow_lane_indices`` (padded to the index max)."""
        import jax

        jnp = self._jnp
        r = {k: np.array(v) for k, v in jax.device_get(self.main(jnp.asarray(fw_words))).items()}
        lanes = np.flatnonzero(r["overflow"])
        s = None
        if len(lanes):
            b = 1 << max(6, int(np.ceil(np.log2(len(lanes)))))
            padded = np.zeros(b, dtype=np.uint64)
            padded[: len(lanes)] = fw_words[lanes]
            s = {
                k: np.array(v)[: len(lanes)]
                for k, v in jax.device_get(self.full(jnp.asarray(padded))).items()
            }
        return r, lanes, s

    def get_ref_pos_batch(self, fw_words: np.ndarray):
        """Array-native CSR result (mapping.BatchHits) — the serving hot
        path (round 5): vectorized merge of the two phases, no per-k-mer
        Python objects."""
        from .mapping import BatchHits

        r, lanes, s = self.query(fw_words)
        return BatchHits.from_twophase(r, lanes, s)

    def get_ref_pos_eager(self, fw_words: np.ndarray) -> list:
        """Merged per-query hit lists (None for misses) — same shape of
        answer as ModIndex.get_ref_pos_eager."""
        r, lanes, s = self.query(fw_words)
        lane_pos = {int(q): i for i, q in enumerate(lanes)}
        out = []
        for q in range(len(fw_words)):
            if q in lane_pos:
                src, row = s, lane_pos[q]
            else:
                src, row = r, q
            if src["mt"][row] == 0:
                out.append(None)
                continue
            hits = []
            n = int(src["n_occs"][row])
            for j in range(n):
                hits.append(
                    (
                        int(src["ref_id"][row, j]),
                        int(src["ref_pos"][row, j]),
                        int(src["orient"][row, j]),
                    )
                )
            out.append(hits)
        return out
