"""Whole-index save/load (checkpointing).

The reference serializes indexes to single files with bincode
(src/bin/index/main.rs:103-124, .piscem/.pf_dense/.sshash/.pfhash). Here an
index is a tree of flat arrays + static metadata, saved as one compressed
``.npz`` container with ``/``-separated keys (the file maps 1:1 onto the
device pytree).
"""

from __future__ import annotations

import numpy as np

from ..bits.bitvector import BitVector
from ..bits.intvector import IntVector
from ..bits.seqvector import SeqVector
from ..containers.refseq import RefSeqCollection
from ..containers.unitig_set import UnitigSet
from ..index.modindex import ModIndex
from ..index.unitig_table import DenseUnitigTable, PiscemUnitigTable
from ..kphf.boophf import BooPHF
from ..kphf.pfhash import PFHash
from ..kphf.sampled import SampledPFHash
from ..kphf.sshash import SSHash

FORMAT_VERSION = 1


# ---------------------------------------------------------------- to_state
def _iv_state(iv: IntVector) -> dict:
    return {"words": iv.words, "length": np.int64(iv.length), "width": np.int64(iv.width)}


def _iv_from(d) -> IntVector:
    return IntVector(d["words"], int(d["length"]), int(d["width"]))


def _bv_state(bv: BitVector) -> dict:
    return {"words": bv.words, "n_bits": np.int64(bv.n_bits)}


def _bv_from(d) -> BitVector:
    return BitVector(d["words"], int(d["n_bits"]))


def _us_state(us: UnitigSet) -> dict:
    return {
        "k": np.int64(us.k),
        "useq_words": us.useq.words,
        "useq_len": np.int64(len(us.useq)),
        "accum": us.accum,
    }


def _us_from(d) -> UnitigSet:
    return UnitigSet(int(d["k"]), SeqVector(d["useq_words"], int(d["useq_len"])), d["accum"])


def _mphf_state(m) -> dict:
    from ..kphf.boophf32 import BooPHF32

    return {
        "mkind": "b32" if isinstance(m, BooPHF32) else "b64",
        "n_elem": np.int64(m.n_elem),
        "last_bitset_rank": np.int64(m.last_bitset_rank),
        "gamma": np.float64(m.gamma),
        "level_n_bits": np.array([n for (n, _, _) in m.levels], dtype=np.int64),
        "level_n_words": np.array([len(w) for (_, w, _) in m.levels], dtype=np.int64),
        "level_n_ranks": np.array([len(r) for (_, _, r) in m.levels], dtype=np.int64),
        "level_words": np.concatenate([w for (_, w, _) in m.levels])
        if m.levels
        else np.zeros(0, np.uint64),
        "level_ranks": np.concatenate([np.asarray(r, dtype=np.uint64) for (_, _, r) in m.levels])
        if m.levels
        else np.zeros(0, np.uint64),
        "fh_keys": m.fh_keys,
        "fh_vals": m.fh_vals,
    }


def _mphf_from(d):
    is32 = str(d.get("mkind", "b64")) == "b32"
    wdt = np.uint32 if is32 else np.uint64
    levels = []
    wo = ro = 0
    for n, nw, nr in zip(d["level_n_bits"], d["level_n_words"], d["level_n_ranks"]):
        n, nw, nr = int(n), int(nw), int(nr)
        levels.append(
            (
                n,
                d["level_words"][wo : wo + nw].astype(wdt),
                d["level_ranks"][ro : ro + nr].astype(wdt),
            )
        )
        wo += nw
        ro += nr
    cls = BooPHF
    if is32:
        from ..kphf.boophf32 import BooPHF32 as cls  # noqa: N813
    return cls(
        n_elem=int(d["n_elem"]),
        last_bitset_rank=int(d["last_bitset_rank"]),
        levels=levels,
        fh_keys=d["fh_keys"],
        fh_vals=d["fh_vals"].astype(wdt) if is32 else d["fh_vals"],
        gamma=float(d["gamma"]),
    )


def _k2u_state(k2u) -> dict:
    from ..kphf.kcdict import KCDict

    if isinstance(k2u, KCDict):
        d = {
            "kind": "kcdict",
            "us": _us_state(k2u.unitigs),
            "table": k2u.table,
            "T": np.int64(k2u.T),
            "salt": np.int64(k2u.salt),
            "scheme": np.int64({"cuckoo": 0, "mono": 1, "mono2": 2}[k2u.scheme]),
            "occ32": np.int64(1 if k2u.occ32 else 0),
            "side_T": np.int64(k2u.side_T),
            "side_salt": np.int64(k2u.side_salt),
        }
        if k2u.side is not None:
            d["side"] = k2u.side
        return d
    if isinstance(k2u, SSHash):
        d = {
            "kind": "sshash",
            "us": _us_state(k2u.unitigs),
            "w": np.int64(k2u.w),
            "seed": np.int64(k2u.seed),
            "hash32": np.int64(1 if k2u.hash32 else 0),
            "ordering": np.int64(
                {"mix64": 0, "mix32": 1, "wyhash": 2}[k2u.ordering]
            ),
            "direct_T": np.int64(k2u.direct_T or 0),
            "skew_param": np.int64(-1 if k2u.skew_param is None else k2u.skew_param),
            "prefix": k2u.occs_prefix_sum,
            "pos": _iv_state(k2u.pos),
        }
        if k2u.mphf is not None:
            d["mphf"] = _mphf_state(k2u.mphf)
        if k2u.skew_mphf is not None:
            d["skew_mphf"] = _mphf_state(k2u.skew_mphf)
            d["skew_pos"] = _iv_state(k2u.skew_pos)
        if k2u.skew_direct is not None:
            sd = k2u.skew_direct
            out = {"T": np.int64(sd["T"]), "pos": sd["pos"], "skind": sd.get("kind", "bucket")}
            if out["skind"] == "cuckoo":
                out["salt"] = np.int64(sd["salt"])
                out["slot_key"] = sd["slot_key"]
            else:
                out["bound"] = np.int64(sd["bound"])
                out["prefix"] = sd["prefix"]
            d["skew_direct"] = out
        return d
    if isinstance(k2u, PFHash):
        return {
            "kind": "pfhash",
            "us": _us_state(k2u.unitigs),
            "mphf": _mphf_state(k2u.mphf),
            "pos": _iv_state(k2u.pos),
        }
    if isinstance(k2u, SampledPFHash):
        return {
            "kind": "sampled",
            "us": _us_state(k2u.unitigs),
            "mphf": _mphf_state(k2u.mphf),
            "sampled_pos": _iv_state(k2u.sampled_pos),
            "sampled_vec": _bv_state(k2u.sampled_vec),
            "canonical_vec": _bv_state(k2u.canonical_vec),
            "direction_vec": _bv_state(k2u.direction_vec),
            "ext_sizes": _iv_state(k2u.ext_sizes),
            "ext_bases": _iv_state(k2u.ext_bases),
            "sample_size": np.int64(k2u.sample_size),
            "extension_size": np.int64(k2u.extension_size),
        }
    raise TypeError(type(k2u))


def _k2u_from(d):
    kind = str(d["kind"])
    if kind == "kcdict":
        from ..kphf.kcdict import KCDict

        kc = KCDict(_us_from(d["us"]), d["table"], int(d["T"]), int(d["salt"]))
        if "scheme" in d and int(d["scheme"]) != 0:
            kc.scheme = {1: "mono", 2: "mono2"}[int(d["scheme"])]
            kc.occ32 = bool(int(d.get("occ32", 0)))
            kc.side_T = int(d["side_T"])
            kc.side_salt = int(d["side_salt"])
            if "side" in d:
                kc.side = d["side"]
        return kc
    if kind == "sshash":
        sp = int(d["skew_param"])
        ss = SSHash(
            _us_from(d["us"]),
            int(d["w"]),
            _mphf_from(d["mphf"]) if "mphf" in d else None,
            d["prefix"],
            _iv_from(d["pos"]),
            None if sp < 0 else sp,
            _mphf_from(d["skew_mphf"]) if "skew_mphf" in d else None,
            _iv_from(d["skew_pos"]) if "skew_pos" in d else None,
            seed=int(d["seed"]),
            hash32=bool(int(d.get("hash32", 0))),
            ordering={0: "mix64", 1: "mix32", 2: "wyhash"}[
                int(d.get("ordering", int(d.get("hash32", 0))))
            ],
        )
        t = int(d.get("direct_T", 0))
        ss.direct_T = t or None
        if "skew_direct" in d:
            sd = d["skew_direct"]
            kind = str(sd.get("skind", "bucket"))
            if kind == "cuckoo":
                ss.skew_direct = {
                    "kind": "cuckoo",
                    "T": int(sd["T"]),
                    "salt": int(sd["salt"]),
                    "slot_key": sd["slot_key"],
                    "slot_pos": sd["pos"],
                    "pos": sd["pos"],
                }
            else:
                ss.skew_direct = {
                    "kind": "bucket",
                    "T": int(sd["T"]),
                    "bound": int(sd["bound"]),
                    "prefix": sd["prefix"],
                    "pos": sd["pos"],
                }
        return ss
    if kind == "pfhash":
        return PFHash(_us_from(d["us"]), _mphf_from(d["mphf"]), _iv_from(d["pos"]))
    if kind == "sampled":
        return SampledPFHash(
            _us_from(d["us"]),
            _mphf_from(d["mphf"]),
            _iv_from(d["sampled_pos"]),
            _bv_from(d["sampled_vec"]),
            _bv_from(d["canonical_vec"]),
            _bv_from(d["direction_vec"]),
            _iv_from(d["ext_sizes"]),
            _iv_from(d["ext_bases"]),
            int(d["sample_size"]),
            int(d["extension_size"]),
        )
    raise ValueError(kind)


def _u2pos_state(t) -> dict:
    names = np.array(t.ref_names, dtype="U") if t.ref_names else np.zeros(0, dtype="U1")
    if isinstance(t, DenseUnitigTable):
        return {"kind": "dense", "ctable": t.ctable, "offsets": t.offsets, "ref_names": names}
    if isinstance(t, PiscemUnitigTable):
        return {
            "kind": "piscem",
            "ctable": _iv_state(t.ctable),
            "offsets": t.offsets,
            "ref_shift": np.int64(t.ref_shift),
            "pos_mask": np.uint64(t.pos_mask),
            "ref_names": names,
        }
    raise TypeError(type(t))


def _u2pos_from(d):
    names = [str(x) for x in d["ref_names"]] if len(d["ref_names"]) else []
    if str(d["kind"]) == "dense":
        return DenseUnitigTable(d["ctable"], d["offsets"], names)
    return PiscemUnitigTable(
        _iv_from(d["ctable"]),
        d["offsets"],
        int(d["ref_shift"]),
        int(d["pos_mask"]),
        names,
    )


def _refs_state(r: RefSeqCollection) -> dict:
    d = {
        "prefix_sum": r.prefix_sum,
        "names": np.array(r.names, dtype="U") if r.names else np.zeros(0, dtype="U1"),
        "has_seq": np.int64(1 if r.has_seq else 0),
    }
    if r.has_seq:
        d["seq_words"] = r.seq.words
        d["seq_len"] = np.int64(len(r.seq))
    return d


def _refs_from(d) -> RefSeqCollection:
    seq = None
    if int(d["has_seq"]):
        seq = SeqVector(d["seq_words"], int(d["seq_len"]))
    names = [str(x) for x in d["names"]] if len(d["names"]) else None
    return RefSeqCollection(seq, d["prefix_sum"], names)


# ------------------------------------------------------------- flat (de)ser
def _flatten(prefix, tree, out):
    for k, v in tree.items():
        key = f"{prefix}/{k}" if prefix else k
        if isinstance(v, dict):
            _flatten(key, v, out)
        elif isinstance(v, str):
            out[key] = np.array(v)
        else:
            out[key] = v


def _unflatten(flat: dict) -> dict:
    root: dict = {}
    for key, v in flat.items():
        parts = key.split("/")
        d = root
        for p in parts[:-1]:
            d = d.setdefault(p, {})
        if v.dtype.kind == "U" and v.ndim == 0:
            v = str(v)
        d[parts[-1]] = v
    return root


def save_index(index: ModIndex, path: str, compress: bool = True) -> None:
    """``compress=False`` writes a STORE-only npz — at Gbp scale the zlib
    pass costs many minutes on this host for ~15% size; capacity-tier
    checkpoints that will be re-loaded the same day should skip it."""
    import json

    tree = {
        "format_version": np.int64(FORMAT_VERSION),
        "index_type": index.index_type,
        "version": index.version,
        "metadata_json": json.dumps(index.metadata),
        "k2u": _k2u_state(index.k2u),
        "u2pos": _u2pos_state(index.u2pos),
        "refs": _refs_state(index.refs),
    }
    flat: dict = {}
    _flatten("", tree, flat)
    (np.savez_compressed if compress else np.savez)(path, **flat)


def load_index(path: str) -> ModIndex:
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    import json

    assert int(tree["format_version"]) == FORMAT_VERSION
    idx = ModIndex(
        _k2u_from(tree["k2u"]),
        _u2pos_from(tree["u2pos"]),
        _refs_from(tree["refs"]),
        index_type=str(tree["index_type"]),
        metadata=json.loads(str(tree.get("metadata_json", "{}"))),
    )
    if "version" in tree:
        idx.version = str(tree["version"])
    return idx


def save_k2u(k2u, path: str, compress: bool = True) -> None:
    flat: dict = {}
    _flatten("", {"format_version": np.int64(FORMAT_VERSION), "k2u": _k2u_state(k2u)}, flat)
    (np.savez_compressed if compress else np.savez)(path, **flat)


def load_k2u(path: str):
    with np.load(path, allow_pickle=False) as z:
        flat = {k: z[k] for k in z.files}
    tree = _unflatten(flat)
    return _k2u_from(tree["k2u"])
