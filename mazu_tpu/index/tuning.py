"""Query configuration per engine and index size.

The reference exposes one query path and leaves tuning to the caller
(src/kphf/sshash.rs:494-552 runs the same probe everywhere). Here the
deployment space is wider — layout kinds, probe depth, deferred
validation, truncated MPHF chains — and this module picks one
configuration from what fits the device:

- speed tier (the index fits device memory with room to spare): fused
  inline2 rows, one row gather resolves most lanes.
- capacity tier (packed IntVector positions, Gbp scale): the richest
  layout that still fits — bpos bucket-inline rows + useqrec window
  records when they fit, the lean packed base otherwise.
- prefix kind by bucket count: flat32 (12 B/bucket, 1-gather bounds)
  until the bucket table itself threatens the budget, then grouped16
  (2.06 B/bucket, ~3 cheap gathers).

Tier choice is a capacity fit. The probe-depth rules (plim by bucket
occupancy and w) are earlier measurements on another accelerator, kept
until an H100 cell re-derives them.
"""

from __future__ import annotations

from dataclasses import dataclass, field

# Footprints (bytes/unit) of the layouts: properties of the layouts, not
# of a device.
_SPEED_BYTES_PER_KMER = 21  # sshash direct inline2 at bucket load 0.25
_FLAT32_BYTES_PER_BUCKET = 12  # flat + flat2 pair arrays
# Device workspace of the compiled query graph, reserved on top of the
# index arrays: XLA's temp bytes for the OneGraph step (8 chunks of 1M
# lanes, m2 123392) on the 100 Mbp mono2 index of chip_smoke.py, compiled
# for an NVIDIA H100 80GB HBM3. Capped at 20% of small explicit budgets;
# device_hbm_budget's 3% allocator slack comes on top.
_GRAPH_WORKSPACE = 46_140_488


def device_hbm_budget(device=None) -> int:
    """Usable device memory on ``device`` (default: the first device) for
    index arrays PLUS the compiled query graph's workspace
    (``tuned_query_config`` subtracts the workspace itself).

    Resolution order: ``MAZU_HBM_BUDGET`` (bytes) →
    ``device.memory_stats()['bytes_limit']`` × 0.97 (allocator slack).
    A device that reports no memory stats (the CPU backend) is an error:
    pass ``hbm_budget`` explicitly there."""
    import os

    env = os.environ.get("MAZU_HBM_BUDGET")
    if env:
        return int(float(env))
    import jax

    if device is None:
        device = jax.devices()[0]
    stats = device.memory_stats() or {}
    limit = int(stats.get("bytes_limit", 0))
    if limit <= 0:
        raise ValueError(
            f"{device} reports no memory limit; pass hbm_budget explicitly "
            "or set MAZU_HBM_BUDGET"
        )
    return int(limit * 0.97)


def _arrays_budget(hbm_budget: int) -> int:
    """Bytes available for index arrays after the query-graph workspace
    reserve (min(workspace, 20% of the budget))."""
    return hbm_budget - min(_GRAPH_WORKSPACE, int(0.2 * hbm_budget))


@dataclass
class QueryConfig:
    """Layout + query knobs for the compact/padded drivers. Split into
    the two call sites: ``arrays_kwargs`` feeds
    ``ModIndex.device_arrays`` / ``SSHash.device_arrays``;
    ``query_kwargs`` feeds ``get_ref_pos_compact`` /
    ``OneGraphIndexQuery`` / ``PipelinedIndexQuery``."""

    tier: str  # "speed" | "capacity" | "mono"
    pos_kind: str | None = None
    prefix_kind: str | None = None
    fused: bool = False
    uproj: bool = False
    useqrec: bool = False
    bucket_inline: bool = False
    probe_limit: int | None = 2
    probe_limit2: int | None = None
    defer_valid: bool = False
    mphf_level_limit: int | None = None
    why: list[str] = field(default_factory=list)

    def arrays_kwargs(self) -> dict:
        out: dict = {}
        if self.fused:
            out["fused"] = True
        if self.pos_kind is not None:
            out["pos_kind"] = self.pos_kind
        if self.prefix_kind is not None:
            out["prefix_kind"] = self.prefix_kind
        if self.uproj:
            out["uproj"] = True  # ModIndex.device_arrays only (needs u2pos)
        if self.useqrec:
            out["useqrec"] = True  # ModIndex.device_arrays only
        if self.bucket_inline:
            out["bucket_inline"] = True
        return out

    def query_kwargs(self) -> dict:
        return {
            "probe_limit": self.probe_limit,
            "probe_limit2": self.probe_limit2,
            "defer_valid": self.defer_valid,
            "mphf_level_limit": self.mphf_level_limit,
        }


def tuned_query_config(k2u, hbm_budget: int | None = None) -> QueryConfig:
    """Pick the tier + knobs for a built K2U dictionary.

    ``hbm_budget`` is the device-bytes allowance for the whole index
    (default: introspected from the runtime device via
    ``device_hbm_budget``; pass the per-device budget when sharding)."""
    kind = type(k2u).__name__.lower()
    if "kcdict" in kind or hasattr(k2u, "slot_words"):
        # mono/mono2: single-hash one-gather engine; no layout kinds.
        return QueryConfig(tier="mono", why=["kcdict: one layout, no knobs"])
    if hbm_budget is None:
        hbm_budget = device_hbm_budget()

    n_kmers = int(getattr(k2u, "n_kmers", 0))
    why: list[str] = []
    avail = _arrays_budget(hbm_budget)

    speed_bytes = n_kmers * _SPEED_BYTES_PER_KMER
    if speed_bytes <= avail:
        why.append(
            f"speed tier: inline2 fused rows ~{speed_bytes/1e9:.2f}GB fits "
            f"budget ({hbm_budget/1e9:.1f}GB)"
        )
        return QueryConfig(
            tier="speed", pos_kind="inline2", fused=True, probe_limit=2, why=why
        )

    # Capacity tier: packed IntVector positions.
    direct = bool(getattr(k2u, "direct_T", None))
    n_buckets = (
        int(k2u.direct_T) if direct else int(getattr(k2u, "n_minimizers", n_kmers))
    )
    flat32_bytes = n_buckets * _FLAT32_BYTES_PER_BUCKET
    if flat32_bytes <= 0.25 * hbm_budget:
        prefix_kind = "flat32"
        why.append(
            f"flat32 bounds: {n_buckets/1e6:.0f}M buckets = "
            f"{flat32_bytes/1e9:.2f}GB, 1-gather bounds"
        )
    else:
        prefix_kind = "grouped16"
        why.append(
            f"grouped16 bounds: {n_buckets/1e6:.0f}M buckets — flat32 would be "
            f"{flat32_bytes/1e9:.2f}GB; 2.06B/bucket"
        )
    if direct:
        # Deep merged buckets (small w) probe 3 rows in the main phase;
        # wide-w Gbp builds are shallow and probe 2.
        w = int(getattr(k2u, "w", 15))
        plim = 2 if w >= 17 else 3
        # when the bpos bucket-inline table (16 B/bucket) + useqrec
        # window records (1.75 B/base) fit next to the lean packed base,
        # the main phase is 1+plim gather ops.
        total_len = int(getattr(getattr(k2u, "unitigs", None), "total_len", 0))
        try:
            # real packed-array bytes; ×1.2 covers the paired useq words
            # the packed device layout adds (×1.0-1.16 of num_bits)
            lean = int(k2u.num_bits() // 8 * 1.2)
        except Exception:
            lean = n_kmers * 3  # lean packed base ~2-3 B/k-mer
        rich = lean + 16 * n_buckets + int(1.75 * total_len)
        if total_len and total_len < (1 << 31) and rich <= avail:
            why.append(
                f"bpos+useqrec fit: ~{rich/1e9:.2f}GB of "
                f"{avail/1e9:.1f}GB array budget (workspace reserved) — "
                f"1+plim gather-op main phase"
            )
            # probe depth follows average bucket OCCUPANCY, not w:
            # load <= 1 probes 2 rows, deeper merged buckets 3
            occs = int(getattr(k2u, "n_minimizer_occs", 0)) or n_kmers
            bplim = 2 if occs <= n_buckets else 3
            # middle-phase depth plim+2
            bplim2 = bplim + 2
            why.append(
                f"bucket occupancy {occs/max(n_buckets,1):.2f} -> "
                f"probe_limit={bplim} + middle phase {bplim2}"
            )
            return QueryConfig(
                tier="capacity",
                pos_kind="packed",
                prefix_kind=prefix_kind,
                useqrec=True,
                bucket_inline=True,
                probe_limit=bplim,
                probe_limit2=bplim2,
                why=why,
            )
        why.append(f"direct engine, w={w}: probe_limit={plim}, defer_valid")
        why.append("uproj records: 1-gather tail (round-4 gather diet)")
        return QueryConfig(
            tier="capacity",
            pos_kind="packed",
            prefix_kind=prefix_kind,
            uproj=True,
            probe_limit=plim,
            defer_valid=True,
            why=why,
        )
    why.append(
        "MPHF engine: defer_valid + mphf_level_limit=4 (the full BooPHF "
        "chain is the longest dependent gather chain of the main phase)"
    )
    why.append("uproj records: 1-gather tail (round-4 gather diet)")
    return QueryConfig(
        tier="capacity",
        pos_kind="packed",
        prefix_kind=prefix_kind,
        uproj=True,
        probe_limit=2,
        defer_valid=True,
        mphf_level_limit=4,
        why=why,
    )
