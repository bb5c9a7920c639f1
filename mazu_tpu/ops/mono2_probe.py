"""mono2 bucket-row probe as a Pallas kernel through Triton.

Drop-in for the main phase of ``kcdict_k2u`` on a mono2-occ32 KCDict
(kphf/kcdict.py): every lane loads its hashed 56 B bucket row, compares
its canonical key with both slots, and selects the hit slot's unitig id,
position, length, occurrence count and two occurrence words. Key
preparation (canonical form, ``fold_hash32``) and output widening stay in
XLA, where they fuse into one elementwise pass.

One program handles ``BLK`` lanes. The row gather is a per-lane array
index into the table ref, which Triton lowers to one global load per lane
and column; the loads of a block are independent, so the hardware keeps
many rows in flight. The payload columns are read at the winning slot's
offset, so a lane reads 4 key words and 5 payload words of its row.
"""

from __future__ import annotations

import functools

import jax
import numpy as np

U32 = np.uint32
U64 = np.uint64

BLK = 1024  # lanes per program (a power of two, as Triton requires)


def _kernel(h_ref, clo_ref, chi_ref, isfw_ref, table_ref,
            uid_ref, pos_ref, ulen_ref, cnt_ref, mt_ref, ow_ref, ow2_ref,
            *, sw: int):
    import jax.numpy as jnp

    h = h_ref[...]
    clo = clo_ref[...]
    chi = chi_ref[...]
    is_fw_canon = isfw_ref[...] != 0
    hi_mask = U32(0x7FFFFFFF)
    khi0 = table_ref[h, 1]
    khi1 = table_ref[h, sw + 1]
    hit0 = (table_ref[h, 0] == clo) & ((khi0 & hi_mask) == chi)
    hit1 = ~hit0 & (table_ref[h, sw] == clo) & ((khi1 & hi_mask) == chi)
    found = hit0 | hit1
    c = jnp.where(hit1, sw, 0).astype(h.dtype)
    khi = jnp.where(hit1, khi1, khi0)
    canon_is_useq = (khi >> U32(31)) != 0
    a = table_ref[h, c + 3]
    b = table_ref[h, c + 4]
    zero = jnp.zeros_like(h)
    uid_ref[...] = jnp.where(found, table_ref[h, c + 2].astype(h.dtype), zero)
    pos_ref[...] = jnp.where(found, (a & U32(0xFFFFFF)).astype(h.dtype), zero)
    ulen = (a >> U32(24)).astype(h.dtype) | ((b & U32(0xFFFF)).astype(h.dtype) << 8)
    ulen_ref[...] = jnp.where(found, ulen, zero)
    cnt_ref[...] = jnp.where(found, (b >> U32(16)).astype(h.dtype), zero)
    mt = jnp.where(is_fw_canon == canon_is_useq, 1, 2).astype(h.dtype)
    mt_ref[...] = jnp.where(found, mt, zero)
    zu = jnp.zeros_like(clo)
    ow_ref[...] = jnp.where(found, table_ref[h, c + 5], zu)
    ow2_ref[...] = jnp.where(found, table_ref[h, c + 6], zu)


@functools.partial(jax.jit, static_argnames=("sw", "interpret"))
def _probe(table, h1, clo, chi, isfw, *, sw: int, interpret: bool):
    import jax.numpy as jnp
    from jax.experimental import pallas as pl
    from jax.experimental.pallas import triton as plgpu

    n = h1.shape[0]
    assert n % BLK == 0
    blk = pl.BlockSpec((BLK,), lambda i: (i,))
    i32 = jax.ShapeDtypeStruct((n,), jnp.int32)
    u32 = jax.ShapeDtypeStruct((n,), jnp.uint32)
    return pl.pallas_call(
        functools.partial(_kernel, sw=sw),
        grid=(n // BLK,),
        in_specs=[blk, blk, blk, blk, pl.BlockSpec(table.shape, lambda i: (0, 0))],
        out_specs=tuple(blk for _ in range(7)),
        out_shape=(i32, i32, i32, i32, i32, u32, u32),
        backend="triton",
        compiler_params=plgpu.CompilerParams(num_warps=4, num_stages=1),
        interpret=interpret,
        name="mono2_probe",
    )(h1, clo, chi, isfw, table)


def use_mono2_probe(meta, xp, platform: str) -> bool:
    """Whether the main phase takes this kernel: a mono2-occ32 table,
    traced with jnp, on a GPU. Everything else stays on ``kcdict_k2u``."""
    return (
        xp is not np
        and platform == "gpu"
        and getattr(meta, "scheme", "") == "mono2"
        and bool(getattr(meta, "occ32", False))
    )


def mono2_probe_k2u(d: dict, fw_words, interpret: bool = False) -> dict:
    """``kcdict_k2u(d, fw, jnp, mode="main")`` for a mono2-occ32 KCDict,
    with the bucket-row probe done by the kernel. Lanes are padded to a
    multiple of ``BLK`` (pad lanes probe bucket 0 and are dropped)."""
    import jax.numpy as jnp

    from ..kmer import revcomp
    from ..kphf.boophf32 import fold_hash32

    m = d["meta"]
    assert getattr(m, "scheme", "") == "mono2" and getattr(m, "occ32", False), (
        "the mono2 probe kernel reads the mono2-occ32 bucket rows"
    )
    assert m.t <= (1 << 31), "bucket ids are int32 in the kernel"
    fw = jnp.asarray(fw_words)
    canon = jnp.minimum(fw, revcomp(fw, m.k))
    clo = (canon & U64(0xFFFFFFFF)).astype(jnp.uint32)
    chi = (canon >> U64(32)).astype(jnp.uint32)
    isfw = (fw == canon).astype(jnp.int32)
    h1 = (fold_hash32(canon) & U32(m.t - 1)).astype(jnp.int32)
    n = fw.shape[0]
    pad = (-n) % BLK
    if pad:
        h1, clo, chi, isfw = (jnp.pad(x, (0, pad)) for x in (h1, clo, chi, isfw))
    uid, pos, ulen, cnt, mt, ow, ow2 = _probe(
        d["table"], h1, clo, chi, isfw, sw=m.sw, interpret=interpret
    )
    found = mt[:n] != 0
    return {
        "unitig_id": uid[:n].astype(jnp.int64),
        "unitig_len": ulen[:n].astype(jnp.int64),
        "pos": pos[:n].astype(jnp.int64),
        "mt": mt[:n].astype(jnp.uint8),
        "occ_word": ow[:n].astype(jnp.uint64),
        "occ_word2": ow2[:n].astype(jnp.uint64),
        "occ_cnt": cnt[:n].astype(jnp.int64),
        "use_skew": jnp.zeros((n,), dtype=bool),
        "unresolved": ~found,
    }
