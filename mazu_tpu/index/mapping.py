"""Read mapping: the production serving driver.

Reads -> (native C++) k-merization -> batched fused two-phase query ->
per-read per-k-mer reference hits. This is the end-to-end flow the
reference exposes through its bench/validate CLIs, packaged as a serving
API.
"""

from __future__ import annotations

from dataclasses import dataclass

import numpy as np

from .modindex import ModIndex
from .twophase import TwoPhaseIndexQuery
from .validate import valid_kmer_windows


@dataclass
class BatchHits:
    """Array-native CSR hits over a flat batch of k-mer queries (the
    serving decode is vectorized end-to-end; the per-k-mer Python tuple
    lists are a lazy compatibility shim on top).

    ``mt[i] == 0`` marks a miss; hits of query i live at
    ``ref_id/ref_pos/orient[offsets[i]:offsets[i+1]]``."""

    mt: np.ndarray  # uint8[N] match type (0 = miss)
    offsets: np.ndarray  # int64[N+1] CSR bounds into the hit arrays
    ref_id: np.ndarray
    ref_pos: np.ndarray
    orient: np.ndarray

    def __len__(self) -> int:
        return len(self.mt)

    @classmethod
    def from_padded(cls, out) -> "BatchHits":
        """Vectorized CSR compaction of a merged padded query result
        (``mt``/``n_occs``/``ref_id``/``ref_pos``/``orient`` [N, mo])."""
        mt = np.asarray(out["mt"]).astype(np.uint8, copy=False)
        hit = mt > 0
        n = np.where(hit, np.asarray(out["n_occs"], dtype=np.int64), 0)
        offsets = np.zeros(len(mt) + 1, dtype=np.int64)
        np.cumsum(n, out=offsets[1:])
        mo = np.asarray(out["ref_id"]).shape[1]
        sel = hit[:, None] & (np.arange(mo, dtype=np.int64)[None, :] < n[:, None])
        return cls(
            mt,
            offsets,
            np.asarray(out["ref_id"])[sel],
            np.asarray(out["ref_pos"])[sel],
            np.asarray(out["orient"])[sel],
        )

    @classmethod
    def from_twophase(cls, r, lanes, s) -> "BatchHits":
        """Vectorized merge of a two-phase result: main rows for
        non-overflow lanes, the compacted phase-2 block for ``lanes``."""
        N = len(r["mt"])
        mt = np.asarray(r["mt"]).astype(np.uint8, copy=True)
        is_ovf = np.zeros(N, dtype=bool)
        is_ovf[lanes] = True
        n = np.where(
            (~is_ovf) & (mt > 0), np.asarray(r["n_occs"], dtype=np.int64), 0
        )
        if s is not None:
            smt = np.asarray(s["mt"]).astype(np.uint8, copy=False)
            mt[lanes] = smt
            n[lanes] = np.where(smt > 0, np.asarray(s["n_occs"], np.int64), 0)
        offsets = np.zeros(N + 1, dtype=np.int64)
        np.cumsum(n, out=offsets[1:])
        rid = np.empty(offsets[-1], dtype=np.asarray(r["ref_id"]).dtype)
        rpo = np.empty(offsets[-1], dtype=np.asarray(r["ref_pos"]).dtype)
        orn = np.empty(offsets[-1], dtype=np.asarray(r["orient"]).dtype)
        wr = np.asarray(r["ref_id"]).shape[1]
        jr = np.arange(wr, dtype=np.int64)[None, :]
        selr = ((~is_ovf) & (mt > 0))[:, None] & (jr < n[:, None])
        dest = (offsets[:-1, None] + jr)[selr]
        rid[dest] = np.asarray(r["ref_id"])[selr]
        rpo[dest] = np.asarray(r["ref_pos"])[selr]
        orn[dest] = np.asarray(r["orient"])[selr]
        if s is not None and len(lanes):
            ws = np.asarray(s["ref_id"]).shape[1]
            js = np.arange(ws, dtype=np.int64)[None, :]
            sels = (smt > 0)[:, None] & (js < n[lanes][:, None])
            dests = (offsets[lanes][:, None] + js)[sels]
            rid[dests] = np.asarray(s["ref_id"])[sels]
            rpo[dests] = np.asarray(s["ref_pos"])[sels]
            orn[dests] = np.asarray(s["orient"])[sels]
        return cls(mt, offsets, rid, rpo, orn)

    @classmethod
    def concat(cls, parts: list) -> "BatchHits":
        if len(parts) == 1:
            return parts[0]
        offs = [parts[0].offsets]
        for p in parts[1:]:
            offs.append(p.offsets[1:] + (offs[-1][-1] - p.offsets[0]))
        return cls(
            np.concatenate([p.mt for p in parts]),
            np.concatenate(offs),
            np.concatenate([p.ref_id for p in parts]),
            np.concatenate([p.ref_pos for p in parts]),
            np.concatenate([p.orient for p in parts]),
        )

    def lane_lists(self, lo: int = 0, hi: int | None = None) -> list:
        """Per-query hit lists for lanes [lo, hi) — the legacy eager
        shape (None for misses). Bulk-converts once, then slices."""
        hi = len(self.mt) if hi is None else hi
        o0, o1 = int(self.offsets[lo]), int(self.offsets[hi])
        rid = self.ref_id[o0:o1].tolist()
        rpo = self.ref_pos[o0:o1].tolist()
        orn = self.orient[o0:o1].tolist()
        out = []
        for i in range(lo, hi):
            if self.mt[i] == 0:
                out.append(None)
                continue
            a, b = int(self.offsets[i]) - o0, int(self.offsets[i + 1]) - o0
            out.append(list(zip(rid[a:b], rpo[a:b], orn[a:b])))
        return out

    def to_lists(self) -> list:
        return self.lane_lists()


class ReadHits:
    """Hits of one read: parallel arrays over its valid k-mer windows.

    Array-native storage (a lane-range view into the batch's CSR
    ``BatchHits``); the per-k-mer ``hits`` list is decoded lazily for
    callers of the legacy API."""

    def __init__(self, read_pos, hits=None, batch: BatchHits | None = None, lane_lo: int = 0):
        self.read_pos = read_pos
        self._hits = hits
        self._batch = batch
        self._lo = int(lane_lo)

    @property
    def hits(self) -> list:
        if self._hits is None:
            self._hits = self._batch.lane_lists(
                self._lo, self._lo + len(self.read_pos)
            )
        return self._hits

    def csr(self):
        """Array-native accessor: (offsets, ref_id, ref_pos, orient) over
        this read's k-mer windows, offsets rebased to 0."""
        b, lo, hi = self._batch, self._lo, self._lo + len(self.read_pos)
        if b is None:
            raise ValueError("list-constructed ReadHits has no CSR view")
        o = b.offsets[lo : hi + 1]
        return o - o[0], b.ref_id[o[0]:o[-1]], b.ref_pos[o[0]:o[-1]], b.orient[o[0]:o[-1]]

    @property
    def n_kmers(self) -> int:
        return len(self.read_pos)

    @property
    def n_hit(self) -> int:
        if self._batch is not None:
            lo, hi = self._lo, self._lo + len(self.read_pos)
            return int((self._batch.mt[lo:hi] > 0).sum())
        return sum(h is not None for h in self.hits)


class CompactQuery:
    """Serving driver for a tuned configuration (index/tuning.py): the
    compact query (main phase + on-device compacted phase 2) on the
    layout the config picks — fused inline2 rows on the speed tier,
    packed positions on the capacity tier, the KCDict rows as they are."""

    def __init__(self, index: ModIndex, cfg, device=None):
        import jax
        import jax.numpy as jnp

        from .modindex import get_ref_pos_compact

        self.max_occs = mo = max(1, index.max_occs())
        self.arrays = jax.device_put(
            index.device_arrays(**cfg.arrays_kwargs()), device
        )
        qk = cfg.query_kwargs()

        from functools import partial

        @partial(jax.jit, static_argnums=2)
        def q(arrays, fw, m2):
            return get_ref_pos_compact(arrays, fw, jnp, mo, m2=int(m2), **qk)

        self._q = q
        self._jnp = jnp

    @staticmethod
    def budget(n: int) -> int:
        """Phase-2 lanes compiled for a batch of ``n`` queries."""
        return max(1024, n // 4)

    def query(self, fw_dev, m2: int):
        """The merged padded result of one device batch, left on the
        device (the timed path)."""
        return self._q(self.arrays, fw_dev, m2)

    def get_ref_pos_batch(self, fw_words: np.ndarray) -> BatchHits:
        """Array-native CSR result (ReadMapper's hot path — no per-k-mer
        Python objects anywhere)."""
        import jax

        fw = self._jnp.asarray(np.asarray(fw_words, dtype=np.uint64))
        out = jax.device_get(self.query(fw, self.budget(len(fw_words))))
        if bool(out["over_budget"]):  # rare: recompile with full budget
            out = jax.device_get(self.query(fw, max(1024, len(fw_words))))
            assert not bool(out["over_budget"])
        return BatchHits.from_padded(out)

    def get_ref_pos_eager(self, fw_words: np.ndarray) -> list:
        return self.get_ref_pos_batch(fw_words).to_lists()


class ReadMapper:
    def __init__(self, index: ModIndex, batch: int = 1 << 18):
        self.index = index
        self.k = index.k
        self.batch = int(batch)
        # SSHash and KCDict dictionaries serve on the device, on the tier
        # tuned_query_config picks for the device's memory: the speed tier
        # through the fused two-phase driver (host-compacted phase 2, the
        # faster of the two for read streams on the H100), the capacity
        # tier and KCDict through the compact query. Other K2Us answer
        # through the host's padded eager path.
        if index.k2u.__class__.__name__ in ("SSHash", "KCDict"):
            from .tuning import tuned_query_config

            self.config = tuned_query_config(index.k2u)
            if self.config.tier == "speed":
                self.tp = TwoPhaseIndexQuery(index)
            else:
                self.tp = CompactQuery(index, self.config)
        else:
            self.config = None
            self.tp = index

    def map_reads(self, reads: list[str]) -> list[ReadHits]:
        k = self.k
        from ..io.native import kmerize_batch

        kb = kmerize_batch(reads, k)
        if kb is not None:
            # one native OpenMP call k-merizes the whole batch (round 5:
            # 16K per-read ctypes calls cost more than the query kernel)
            b, flat_pos, flat = kb
            bounds = b.tolist()
            positions = [flat_pos[b[i] : b[i + 1]] for i in range(len(reads))]
        else:
            positions = []
            words = []
            bounds = [0]
            for r in reads:
                p, w = valid_kmer_windows(r, k)
                positions.append(p)
                words.append(w)
                bounds.append(bounds[-1] + len(w))
            flat = np.concatenate(words) if words else np.zeros(0, dtype=np.uint64)

        if hasattr(self.tp, "get_ref_pos_batch"):
            # array-native path (round 5): batch CSR straight through;
            # ReadHits holds lane-range views, lists decode lazily
            if len(flat) == 0:
                z = np.zeros(0, dtype=np.int64)
                bh = BatchHits(
                    np.zeros(0, np.uint8), np.zeros(1, np.int64), z, z, z
                )
            else:
                bh = BatchHits.concat(
                    [
                        self.tp.get_ref_pos_batch(flat[s : s + self.batch])
                        for s in range(0, len(flat), self.batch)
                    ]
                )
            return [
                ReadHits(positions[i], batch=bh, lane_lo=bounds[i])
                for i in range(len(reads))
            ]

        all_hits: list = []
        for s in range(0, len(flat), self.batch):
            chunk = flat[s : s + self.batch]
            all_hits.extend(self.tp.get_ref_pos_eager(chunk))

        out = []
        for i in range(len(reads)):
            out.append(ReadHits(positions[i], all_hits[bounds[i] : bounds[i + 1]]))
        return out

    def map_fasta(self, path: str) -> list[ReadHits]:
        from ..io.fasta import read_fasta

        return self.map_reads([seq for _, seq in read_fasta(path)])

    def map_file(self, path: str) -> list[ReadHits]:
        """FASTA or FASTQ (optionally gzipped), format-sniffed."""
        from ..io.fastq import read_seqs

        return self.map_reads([seq for _, seq in read_seqs(path)])
