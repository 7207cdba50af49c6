"""Minimal pure-Python read-only LMDB parser (the port's own copy of
:mod:`gif_tpu.data.lmdb_reader`).

The reference ships its FFHQ frames in an LMDB built by
``prepare_lmdb/prepare_ffhq_multiscale_dataset.py`` (JPEG values keyed
``f'{size}-{idx:05d}'`` plus a ``length`` entry).  The C ``lmdb`` package is
an optional dependency; this module lets ``gif_tpu_torch.data.lmdb_import`` read
those databases with zero extra deps by parsing the on-disk format directly
(LMDB file-format v1: meta pages, B+tree branch/leaf pages, overflow pages).

Scope: read-only ``get``/``items`` on the *main* database of a quiescent
file (no concurrent writers, no named sub-databases, no DUPSORT) — exactly
what the dataset import needs.  Anything outside that raises.

Layout notes (from the LMDB spec, lmdb/libraries/liblmdb/mdb.c):
  page header   = pgno:u64  pad:u16  flags:u16  (lower:u16 upper:u16 | pages:u32)
  meta page     = header + magic:u32 version:u32 addr:u64 mapsize:u64
                  db[2]:48B each + last_pg:u64 + txnid:u64
  db record     = pad:u32 flags:u16 depth:u16 branch:u64 leaf:u64
                  overflow:u64 entries:u64 root:u64
  node          = lo:u16 hi:u16 flags:u16 ksize:u16 key[...] data[...]
  The page size lives in db[0] (the free DB)'s pad field; branch-node child
  pgno is lo | hi<<16 | flags<<32; F_BIGDATA leaf nodes store an 8-byte
  overflow pgno after the key, with the value contiguous after that chain's
  single 16-byte header.
"""

from __future__ import annotations

import io
import os
import struct

MAGIC = 0xBEEFC0DE
DATA_VERSION = 1

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01
F_SUBDATA = 0x02
F_DUPDATA = 0x04

PAGEHDRSZ = 16
_INVALID_PGNO = 0xFFFFFFFFFFFFFFFF

_META = struct.Struct("<IIQQ")  # magic, version, address, mapsize
_DB = struct.Struct("<IHHQQQQQ")  # pad, flags, depth, branch, leaf, ovf, entries, root
_PAGEHDR = struct.Struct("<QHHHH")  # pgno, pad, flags, lower, upper
_NODEHDR = struct.Struct("<HHHH")  # lo, hi, flags, ksize


class LmdbFormatError(ValueError):
    pass


class MiniLmdb:
    """Read-only view over one LMDB file (or subdir containing data.mdb)."""

    def __init__(self, path: str):
        if os.path.isdir(path):
            path = os.path.join(path, "data.mdb")
        with io.open(path, "rb") as f:  # io.open: module-level open() shadows the builtin
            self._buf = f.read()
        self.path = path
        self._load_meta()

    # -- metadata ---------------------------------------------------------

    def _parse_meta(self, off: int):
        magic, version, _addr, mapsize = _META.unpack_from(self._buf, off)
        if magic != MAGIC:
            raise LmdbFormatError(f"bad LMDB magic {magic:#x} in {self.path}")
        if version != DATA_VERSION:
            raise LmdbFormatError(f"unsupported LMDB data version {version}")
        free_db = _DB.unpack_from(self._buf, off + _META.size)
        main_db = _DB.unpack_from(self._buf, off + _META.size + _DB.size)
        (last_pg, txnid) = struct.unpack_from(
            "<QQ", self._buf, off + _META.size + 2 * _DB.size
        )
        return dict(
            psize=free_db[0],  # mm_psize aliases db[0].md_pad
            main=main_db,
            last_pg=last_pg,
            txnid=txnid,
            mapsize=mapsize,
        )

    def _load_meta(self):
        # Meta pages live at page 0 and 1; a reader must take the one with
        # the higher transaction id.  Page size is only known after parsing
        # meta 0, and the two default OS page sizes both start meta 1 at a
        # 4096 boundary only if psize==4096 — so locate meta 1 via meta 0's
        # recorded psize.
        m0 = self._parse_meta(PAGEHDRSZ)
        m1 = self._parse_meta(m0["psize"] + PAGEHDRSZ)
        meta = m0 if m0["txnid"] >= m1["txnid"] else m1
        self.psize = meta["psize"]
        (pad, flags, self.depth, _b, _l, _o, self.entries, self.root) = meta["main"]
        if flags & 0x04:  # MDB_DUPSORT
            raise LmdbFormatError("DUPSORT main DB is not supported")

    # -- page access ------------------------------------------------------

    def _page(self, pgno: int):
        off = pgno * self.psize
        if off + PAGEHDRSZ > len(self._buf):
            raise LmdbFormatError(f"page {pgno} out of range in {self.path}")
        _pgno, _pad, flags, lower, upper = _PAGEHDR.unpack_from(self._buf, off)
        return off, flags, lower, upper

    def _node(self, page_off: int, node_off: int):
        """(key, flags, datasize, data_off) of the node at page-relative
        ``node_off``."""
        base = page_off + node_off
        lo, hi, flags, ksize = _NODEHDR.unpack_from(self._buf, base)
        key_off = base + _NODEHDR.size
        key = self._buf[key_off : key_off + ksize]
        return key, flags, lo | (hi << 16), key_off + ksize

    def _num_keys(self, lower: int) -> int:
        return (lower - PAGEHDRSZ) // 2

    def _node_offsets(self, page_off: int, lower: int):
        n = self._num_keys(lower)
        return struct.unpack_from(f"<{n}H", self._buf, page_off + PAGEHDRSZ)

    # -- lookups ----------------------------------------------------------

    def _leaf_value(self, flags: int, datasize: int, data_off: int) -> bytes:
        if flags & (F_SUBDATA | F_DUPDATA):
            raise LmdbFormatError("sub-database / DUPSORT nodes unsupported")
        if flags & F_BIGDATA:
            (ovpg,) = struct.unpack_from("<Q", self._buf, data_off)
            start = ovpg * self.psize + PAGEHDRSZ
            return self._buf[start : start + datasize]
        return self._buf[data_off : data_off + datasize]

    def get(self, key: bytes, default=None):
        if self.root == _INVALID_PGNO:
            return default
        pgno = self.root
        for _ in range(self.depth + 1):
            page_off, flags, lower, upper = self._page(pgno)
            offsets = self._node_offsets(page_off, lower)
            if flags & P_LEAF2:
                raise LmdbFormatError("LEAF2 (fixed-size key) pages unsupported")
            if flags & P_BRANCH:
                # Rightmost child whose separator key <= target; node 0's
                # key is the implicit -inf separator.
                child = None
                for off in offsets:
                    lo, hi, nfl, ksize = _NODEHDR.unpack_from(
                        self._buf, page_off + off
                    )
                    key_off = page_off + off + _NODEHDR.size
                    k = self._buf[key_off : key_off + ksize]
                    if child is not None and k > key:
                        break
                    child = lo | (hi << 16) | (nfl << 32)
                pgno = child
            elif flags & P_LEAF:
                for off in offsets:
                    k, nflags, dsz, data_off = self._node(page_off, off)
                    if k == key:
                        return self._leaf_value(nflags, dsz, data_off)
                    if k > key:
                        break
                return default
            else:
                raise LmdbFormatError(f"unexpected page flags {flags:#x}")
        raise LmdbFormatError("B+tree deeper than recorded depth")

    def items(self):
        """Yield (key, value) in key order (full scan)."""
        if self.root == _INVALID_PGNO:
            return
        stack = [self.root]
        while stack:
            pgno = stack.pop()
            page_off, flags, lower, upper = self._page(pgno)
            offsets = self._node_offsets(page_off, lower)
            if flags & P_BRANCH:
                children = []
                for off in offsets:
                    lo, hi, nfl, _ks = _NODEHDR.unpack_from(
                        self._buf, page_off + off
                    )
                    children.append(lo | (hi << 16) | (nfl << 32))
                stack.extend(reversed(children))
            elif flags & P_LEAF:
                for off in offsets:
                    k, nflags, dsz, data_off = self._node(page_off, off)
                    yield k, self._leaf_value(nflags, dsz, data_off)
            else:
                raise LmdbFormatError(f"unexpected page flags {flags:#x}")

    def __len__(self):
        return self.entries

    # -- lmdb-package-compatible shim --------------------------------------
    # Just enough surface for gif_tpu_torch.data.lmdb_import's readonly usage.

    def begin(self, write: bool = False):
        if write:
            raise LmdbFormatError("MiniLmdb is read-only")
        return _Txn(self)

    def close(self):
        self._buf = b""


class _Txn:
    def __init__(self, db: MiniLmdb):
        self._db = db

    def get(self, key: bytes, default=None):
        return self._db.get(key, default)

    def __enter__(self):
        return self

    def __exit__(self, *a):
        return False


def open(path: str, **_ignored) -> MiniLmdb:  # noqa: A001 - lmdb API parity
    """`lmdb.open`-shaped constructor (readonly)."""
    return MiniLmdb(path)
