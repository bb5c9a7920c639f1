"""mazu_tpu — a modular, batched k-mer index engine in JAX.

A from-scratch re-design of the capabilities of COMBINE-lab/mazu for an
accelerator: all index structures live as flat device-resident arrays;
queries are batched and fully vectorized in JAX/XLA (with a Pallas kernel
for the mono2 probe on the GPU); builders run host-side in NumPy
(optionally accelerated by the native C++ helpers in
``mazu_tpu.io.native``).

Layer map (mirrors reference SURVEY.md §1, re-designed arrays-first):

- ``mazu_tpu.bits``       — succinct primitives: rank/select bitvectors,
  packed int vectors, Elias-Fano, 2-bit sequence vectors.
- ``mazu_tpu.kmer``       — k-mer word math: revcomp, canonicalization,
  match types, minimizers (vectorized over query batches).
- ``mazu_tpu.containers`` — UnitigSet, RefSeqCollection.
- ``mazu_tpu.kphf``       — K2U dictionaries: BooPHF (load + build),
  SSHash, PFHash, SampledPFHash.
- ``mazu_tpu.index``      — ModIndex, U2Pos occurrence tables, SPT
  builders, projection, validation, streaming.
- ``mazu_tpu.io``         — cuttlefish / FASTA / pufferfish(pf1) binary
  interop and checkpoint save/load.
- ``mazu_tpu.parallel``   — multi-chip sharding (replicated and
  minimizer-bucket-sharded queries over a jax Mesh).

Dtype policy: k-mer words are uint64 (k <= 31 -> 62 bits). 64-bit mode is
enabled at import; the hot query paths keep most arithmetic in 32-bit lanes
(u32 hash chains, 2x32-bit key halves).
"""

import jax

jax.config.update("jax_enable_x64", True)

__version__ = "0.2.0"


def get_mazu_tpu_version() -> str:
    """Version string (parity: reference src/lib.rs:31-33)."""
    return __version__


# Orientation conventions (parity: reference src/lib.rs:36-85):
# Forward == 1, Backward == 0 in all packed encodings.
ORIENT_FORWARD = 1
ORIENT_BACKWARD = 0

# MatchType encoding for batched queries (kmers crate MatchType analog):
# 0 == NoMatch (also: "query missed"), 1 == IdentityMatch, 2 == TwinMatch.
MATCH_NONE = 0
MATCH_IDENTITY = 1
MATCH_TWIN = 2

# Lazy convenience exports (keep base import light)
_LAZY = {
    "ModIndex": "mazu_tpu.index.modindex",
    "SSHash": "mazu_tpu.kphf.sshash",
    "PFHash": "mazu_tpu.kphf.pfhash",
    "BooPHF": "mazu_tpu.kphf.boophf",
    "UnitigSet": "mazu_tpu.containers.unitig_set",
    "RefSeqCollection": "mazu_tpu.containers.refseq",
    "SPT": "mazu_tpu.index.spt",
    "StreamingIndex": "mazu_tpu.index.streaming",
    "load_dense_index": "mazu_tpu.io.pf1_index",
    "load_sparse_index": "mazu_tpu.io.pf1_index",
    "save_index": "mazu_tpu.io.checkpoint",
    "load_index": "mazu_tpu.io.checkpoint",
    "piscem_index_from_cf_prefix": "mazu_tpu.index.piscem_index",
    "validate_self": "mazu_tpu.index.validate",
    "validate_fasta": "mazu_tpu.index.validate",
    "ColorClasses": "mazu_tpu.index.colors",
    "PseudoAligner": "mazu_tpu.index.pseudoalign",
    "ReadMapper": "mazu_tpu.index.mapping",
    "pack_reads": "mazu_tpu.io.reads",
    "read_fasta": "mazu_tpu.io.fasta",
    "read_fastq": "mazu_tpu.io.fastq",
    "read_seqs": "mazu_tpu.io.fastq",
}


def __getattr__(name):
    if name in _LAZY:
        import importlib

        return getattr(importlib.import_module(_LAZY[name]), name)
    raise AttributeError(name)
