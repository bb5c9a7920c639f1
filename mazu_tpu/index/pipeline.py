"""PipelinedIndexQuery: the production serving driver.

Batched-RPC pipelined two-phase full query (the design behind the headline
bench): CH query batches are staged on device; ONE dispatch runs all main
phases (shallow fused probe, ~2 random gathers/lane), ONE readback moves
the packed overflow bitmaps, the host compacts lanes (u16 deltas), ONE
upload + ONE dispatch resolves every flagged lane through the full padded
pipeline. Per CH x N queries the host-device round-trip cost is ~3 RPCs
regardless of CH.

Results are returned split (main + compacted overflow), exactly covering
every query:
  - main: fused-projection padded results, exact for non-overflow lanes
  - overflow: per chunk, (lanes, padded full results for those lanes)

``checksum`` mode reduces everything on device (used by bench.py).
"""

from __future__ import annotations

import numpy as np

from .modindex import ModIndex, get_ref_pos_compact, get_ref_pos_padded
from .twophase import TwoPhaseIndexQuery


class OneGraphIndexQuery:
    """Whole-pass SINGLE-GRAPH driver: CH stacked query chunks scanned
    inside one jitted function — shallow main phase, scatter-free
    on-device lane compaction (ops/compact.py), compacted full phase 2,
    and checksum reduction all fused. Per pass the host link carries ONE
    dispatch and ONE scalar readback: no overflow-bitmap download, no lane
    upload, and only one graph to compile.

    Exactness: identical to get_ref_pos_padded for every lane (asserted by
    tests and the bench parity check) unless a chunk's overflow count
    exceeds ``m2`` — then ``worst_ovf`` from checksum_pass exceeds m2 and
    the caller must rebuild with a larger m2 (deterministic workloads fail
    fast on the first pass).
    """

    def __init__(
        self,
        index: ModIndex,
        batch: int,
        n_chunks: int = 16,
        m2: int | None = None,
        probe_limit: int | None = 2,
        pos_kind: str | None = "inline2",
        device=None,
        host_arrays: dict | None = None,
        m2b: int | None = None,
        defer_valid: bool = False,
        mphf_level_limit: int | None = None,
        probe_limit2: int | None = None,
        m2c: int | None = None,
    ):
        import jax
        import jax.numpy as jnp

        self._jax = jax
        self._jnp = jnp
        self.index = index
        self.batch = int(batch)
        self.CH = int(n_chunks)
        self.M2 = int(m2 or max(8192, batch // 16))
        self.M2B = int(m2b) if m2b else None
        self.max_occs = max(1, index.max_occs())
        self.probe_limit = probe_limit
        # host_arrays may be passed in to avoid rebuilding the fused layout
        # (the fusion pass is a host-side array transform)
        self.host_arrays = (
            host_arrays
            if host_arrays is not None
            else index.device_arrays(fused=True, pos_kind=pos_kind)
        )
        self.arrays = jax.device_put(self.host_arrays, device)
        mo, M2, M2B, plim = self.max_occs, self.M2, self.M2B, probe_limit
        dv = bool(defer_valid)
        mlim = mphf_level_limit
        plim2 = probe_limit2
        M2C = int(m2c) if m2c else None
        self.defer_valid = dv
        self.mphf_level_limit = mlim
        self.probe_limit2 = plim2
        self.m2c = M2C

        def _novf(out):
            # (n_ovf, n_ovf_b, residue-truncated?) — the third channel
            # turns a clipped m_c into a hard failure instead of silently
            # returning unvalidated middle-phase rows for the truncated
            # lanes (found round 5: the tail lab's p2x3 "win" was exactly
            # this truncation)
            za = jnp.zeros_like(out["n_ovf"])
            return jnp.stack([
                out["n_ovf"],
                out.get("n_ovf_b", za),
                out.get("over_budget_c", za > 0).astype(out["n_ovf"].dtype),
            ])

        @jax.jit
        def pass_fn(arrays, stack):
            def step(carry, chunk):
                out = get_ref_pos_compact(
                    arrays, chunk, jnp, mo, merge=False, probe_limit=plim,
                    m2=M2, m2b=M2B, defer_valid=dv, mphf_level_limit=mlim,
                    probe_limit2=plim2, m2c=M2C,
                )
                return carry + OneGraphIndexQuery.checksum(out, jnp), _novf(out)

            tot, novf = jax.lax.scan(step, jnp.int64(0), stack)
            return tot, jnp.max(novf, axis=0)

        self._pass = pass_fn

        @jax.jit
        def pass_roll(arrays, work):
            # derived chunks: chunk i = roll(work, i * prime) — a distinct
            # permutation of the SAME multiset per chunk, generated on
            # device, so no [CH, batch] host stack (2 GB at CH=256) is
            # written and uploaded. Checksums are permutation-invariant
            # reductions, so the parity oracle (total == CH * host_chk) is
            # unchanged.
            def step(carry, i):
                chunk = jnp.roll(work, i * jnp.int64(40009))
                out = get_ref_pos_compact(
                    arrays, chunk, jnp, mo, merge=False, probe_limit=plim,
                    m2=M2, m2b=M2B, defer_valid=dv, mphf_level_limit=mlim,
                    probe_limit2=plim2, m2c=M2C,
                )
                return carry + OneGraphIndexQuery.checksum(out, jnp), _novf(out)

            tot, novf = jax.lax.scan(
                step, jnp.int64(0), jnp.arange(self.CH, dtype=jnp.int64)
            )
            return tot, jnp.max(novf, axis=0)

        self._pass_roll = pass_roll

    @staticmethod
    def checksum(out: dict, xp):
        """Device-reduced checksum over a merge=False compact result: sums
        ref_pos/ref_id over valid occurrences and unitig_id/pos over hits,
        split across the main and compacted phase-2 pieces."""
        m_, ov, p2, sr = out["main"], out["overflow"], out["phase2"], out["slot_real"]
        s = (
            xp.where(m_["valid"], m_["ref_pos"], 0).sum()
            + xp.where(m_["valid"], m_["ref_id"], 0).sum()
            + xp.where(~ov, m_["unitig_id"], 0).sum()
            + xp.where(~ov, m_["pos"], 0).sum()
        )
        v2 = p2["valid"] & sr[:, None]
        s = s + (
            xp.where(v2, p2["ref_pos"], 0).sum()
            + xp.where(v2, p2["ref_id"], 0).sum()
            + xp.where(sr, p2["unitig_id"], 0).sum()
            + xp.where(sr, p2["pos"], 0).sum()
        )
        if "phase2b" in out:  # type-split heavy phase: second block
            p2b, srb = out["phase2b"], out["slot_real_b"]
            v2b = p2b["valid"] & srb[:, None]
            s = s + (
                xp.where(v2b, p2b["ref_pos"], 0).sum()
                + xp.where(v2b, p2b["ref_id"], 0).sum()
                + xp.where(srb, p2b["unitig_id"], 0).sum()
                + xp.where(srb, p2b["pos"], 0).sum()
            )
        return s

    def checksum_pass(self, stack_dev):
        """One fused pass over a [CH, batch] device stack. Returns
        (checksum, worst_ovf); worst_ovf > m2 means phase-2 capacity was
        exceeded and the results are invalid — rebuild with larger m2.
        With the type-split phase (m2b set), worst_ovf is a (worst_a,
        worst_b) pair checked against (m2, m2b)."""
        return self._finish(self._pass(self.arrays, stack_dev))

    def checksum_pass_rolled(self, work_dev):
        """One fused pass over CH device-derived chunks: chunk i is
        roll(work, i*40009) — no [CH, batch] host stack, no stack upload.
        Same return contract as checksum_pass; chunk 0 is ``work`` itself
        so a host oracle on ``work`` sizes capacities and the full-pass
        checksum equals CH * oracle(work)."""
        return self._finish(self._pass_roll(self.arrays, work_dev))

    def memory_analysis(self, work_dev):
        """XLA's memory analysis of the compiled rolled pass (argument,
        output, temp and code bytes) for ``work_dev``'s shape."""
        return self._pass_roll.lower(self.arrays, work_dev).compile().memory_analysis()

    def _finish(self, out):
        import jax

        tot, worst = out
        worst = jax.device_get(worst)
        assert int(worst[2]) == 0, (
            "middle-phase residue capacity (m2c) exceeded — results for the "
            "truncated lanes are unvalidated; rebuild with a larger m2c"
        )
        if self.M2B is not None:
            return int(jax.device_get(tot)), (int(worst[0]), int(worst[1]))
        return int(jax.device_get(tot)), int(worst[0])

    def checksum_host(self, stack_host: np.ndarray) -> int:
        """Same computation with xp=numpy on the host arrays (cross-backend
        parity oracle for the bench)."""
        tot = 0
        for chunk in stack_host:
            out = get_ref_pos_compact(
                self.host_arrays,
                chunk,
                np,
                self.max_occs,
                merge=False,
                probe_limit=self.probe_limit,
                m2=self.M2,
                m2b=self.M2B,
                defer_valid=self.defer_valid,
                mphf_level_limit=self.mphf_level_limit,
                probe_limit2=self.probe_limit2,
                m2c=self.m2c,
            )
            assert not bool(out["over_budget"]), "phase-2 capacity exceeded"
            tot += int(self.checksum(out, np))
        return tot


class PipelinedIndexQuery:
    def __init__(
        self,
        index: ModIndex,
        batch: int,
        n_chunks: int = 8,
        m2: int | None = None,
        probe_limit: int | None = 1,
        device=None,
    ):
        import jax
        import jax.numpy as jnp

        self._jax = jax
        self._jnp = jnp
        self.batch = int(batch)
        self.CH = int(n_chunks)
        self.M2 = int(m2 or max(8192, -(-batch // 8 // 8192) * 8192))
        self.max_occs = max(1, index.max_occs())
        self.tp = TwoPhaseIndexQuery(index, probe_limit=probe_limit, device=device)
        # build the lazily-created packed-bitmap main kernel
        z = np.zeros(self.batch, dtype=np.uint64)
        self.tp.checksum_query(jnp.asarray(z), z)
        self._main_chk = self.tp._main_chk
        self._compiled = {}

    def _fns(self):
        if "all" in self._compiled:
            return self._compiled["all"]
        jax, jnp = self._jax, self._jnp
        tp, M2, CH, mo = self.tp, self.M2, self.CH, self.max_occs

        @jax.jit
        def all_mains(arrays, stack):
            def step(_, chunk):
                s, packed = tp._main_chk_a(arrays, chunk)
                return 0, (s, packed)

            _, (ss, ps) = jax.lax.scan(step, 0, stack)
            return ss, ps

        @jax.jit
        def all_phase2(arrays, stack, deltas_all, n_reals):
            def step(_, xs):
                chunk, deltas, n_real = xs
                lanes = jnp.cumsum(deltas.astype(jnp.int32), dtype=jnp.int32) - 1
                out = get_ref_pos_padded(arrays, chunk[lanes], jnp, mo)
                keep = {
                    kk: out[kk]
                    for kk in (
                        "unitig_id",
                        "unitig_len",
                        "pos",
                        "mt",
                        "n_occs",
                        "ref_id",
                        "ref_pos",
                        "orient",
                        "valid",
                    )
                }
                keep["lanes"] = lanes
                return 0, keep

            _, outs = jax.lax.scan(step, 0, (stack, deltas_all, n_reals))
            return outs

        self._compiled["all"] = (all_mains, all_phase2)
        return self._compiled["all"]

    def query_batches(self, batches: list[np.ndarray]):
        """Process up to ``n_chunks`` equal-size query batches in one
        pipelined pass. Returns (mains, overflows):

        - mains[i]: fused main-phase padded dict for batch i (fields exact
          where ``~overflow``)
        - overflows[i]: (lane_indices, full padded dict rows) resolving
          every flagged lane of batch i exactly.
        """
        jax, jnp = self._jax, self._jnp
        assert len(batches) <= self.CH
        CH = len(batches)
        for b in batches:
            assert len(b) == self.batch
        stack = jax.device_put(jnp.asarray(np.stack(batches)))
        all_mains, all_phase2 = self._fns()
        if CH != self.CH:
            # partial final group: pad with the first batch (discarded)
            pad = [batches[0]] * (self.CH - CH)
            stack = jax.device_put(jnp.asarray(np.stack(list(batches) + pad)))
        _, ps = all_mains(self.tp.arrays, stack)
        # main RESULTS need a second pass through tp.main (cheap, still on
        # device) — the checksum kernel only returns reductions
        mains = [
            {k: np.asarray(v) for k, v in jax.device_get(self.tp.main(stack[i])).items()}
            for i in range(CH)
        ]
        pa = np.asarray(jax.device_get(ps))
        deltas_all = np.zeros((self.CH, self.M2), dtype=np.uint16)
        n_reals = np.zeros(self.CH, dtype=np.int32)
        lanes_host = []
        for i in range(CH):
            bits = np.unpackbits(pa[i].view(np.uint8), bitorder="little")
            lanes = np.flatnonzero(bits[: self.batch]).astype(np.int64)
            assert len(lanes) <= self.M2, "phase-2 capacity exceeded; raise m2"
            d_ = np.diff(lanes, prepend=-1)
            deltas_all[i, : len(lanes)] = d_.astype(np.uint16)
            n_reals[i] = len(lanes)
            lanes_host.append(lanes)
        outs = jax.device_get(
            all_phase2(
                self.tp.arrays, stack, jnp.asarray(deltas_all), jnp.asarray(n_reals)
            )
        )
        overflows = []
        for i in range(CH):
            n = int(n_reals[i])
            rows = {k: np.asarray(v[i])[:n] for k, v in outs.items() if k != "lanes"}
            overflows.append((lanes_host[i], rows))
        return mains, overflows

    def get_ref_pos_eager(self, fw_words: np.ndarray) -> list:
        """Merged per-query hit lists (None for misses) for ONE batch —
        same answer shape as ModIndex.get_ref_pos_eager."""
        assert len(fw_words) == self.batch
        mains, overflows = self.query_batches([fw_words])
        r, (lanes, s) = mains[0], overflows[0]
        lane_pos = {int(q): i for i, q in enumerate(lanes)}
        out = []
        for q in range(self.batch):
            if q in lane_pos:
                src, row = s, lane_pos[q]
            else:
                src, row = r, q
            if src["mt"][row] == 0:
                out.append(None)
                continue
            n = int(src["n_occs"][row])
            width = src["ref_id"].shape[1]
            out.append(
                [
                    (
                        int(src["ref_id"][row, j]),
                        int(src["ref_pos"][row, j]),
                        int(src["orient"][row, j]),
                    )
                    for j in range(min(n, width))
                ]
            )
        return out
