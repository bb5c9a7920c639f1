"""Succinct bit-level primitives (L0/L1 of the reference layer map).

Arrays-first re-design of the behavior mazu gets from the external ``simple-sds``
crate (BitVector rank/select, IntVector, RawVector) and of the in-tree
Elias-Fano vector (reference src/elias_fano.rs).

Design stance: every structure is a host-side builder class (NumPy) plus a
``device_arrays()`` pytree of flat uint32/uint64 arrays, queried by pure,
jit-compatible functions that do O(1) gathers per lookup.
"""

from .bitvector import BitVector, bv_rank, bv_select, bv_get_bit, bv_read_window
from .intvector import IntVector, iv_get
from .elias_fano import EFVector, ef_get
from .seqvector import SeqVector, sv_get_kmer

__all__ = [
    "BitVector",
    "bv_rank",
    "bv_select",
    "bv_get_bit",
    "bv_read_window",
    "IntVector",
    "iv_get",
    "EFVector",
    "ef_get",
    "SeqVector",
    "sv_get_kmer",
]
