"""Read-only, pure-Python LMDB reader (a copy of
`advancedliteratemachinery_tpu/data/lmdb_reader.py`).

The reference's STR datasets are LMDB stores (MGP-STR dataset.py:142
LmdbDataset; LISTER dataset/dataset.py:67 — keys b"num-samples",
b"image-%09d", b"label-%09d"), accessed via the `lmdb` C binding, which
neither machine has. This module memory-maps `data.mdb` and walks the
B+tree directly (LMDB file format per lmdb/mdb.c: meta pages 0-1, 48-bit
page numbers in branch nodes, F_BIGDATA overflow chains), so it reads the
files of `data/lmdb_writer.py`, of the JAX writer and of liblmdb alike.

Supports: get(key), sequential iteration, stat. Read-only by design.
"""

from __future__ import annotations

import mmap
import os
import struct
from typing import Iterator, Optional, Tuple

MDB_MAGIC = 0xBEEFC0DE

P_BRANCH = 0x01
P_LEAF = 0x02
P_OVERFLOW = 0x04
P_META = 0x08
P_LEAF2 = 0x20

F_BIGDATA = 0x01


class LmdbError(RuntimeError):
    pass


class LmdbReader:
    def __init__(self, path: str):
        data_path = path
        if os.path.isdir(path):
            data_path = os.path.join(path, "data.mdb")
        self._f = open(data_path, "rb")
        self._mm = mmap.mmap(self._f.fileno(), 0, access=mmap.ACCESS_READ)
        self.page_size, self.root, self.entries = self._read_meta()

    # ---------- file structure ----------

    def _read_meta_at(self, off: int, page_size: int) -> Tuple[int, int, int, int]:
        """→ (magic, txnid, main_root, main_entries) for meta at offset."""
        base = off + 16  # past page header
        magic, version = struct.unpack_from("<II", self._mm, base)
        # MDB_meta: magic, version, address(8), mapsize(8), dbs[2], last_pg, txnid
        dbs_off = base + 4 + 4 + 8 + 8
        # MDB_db: pad(4) flags(2) depth(2) branch(8) leaf(8) overflow(8)
        #         entries(8) root(8) = 48 bytes; main db is dbs[1]
        main = dbs_off + 48
        entries, root = struct.unpack_from("<qq", self._mm, main + 16 + 16)
        txnid = struct.unpack_from("<Q", self._mm, dbs_off + 96 + 8)[0]
        return magic, txnid, root, entries

    def _read_meta(self) -> Tuple[int, int, int]:
        # probe page size: try common sizes; meta magic must appear on page 0
        for ps in (4096, 8192, 16384, 32768, 65536):
            magic0 = struct.unpack_from("<I", self._mm, 16)[0]
            if magic0 != MDB_MAGIC:
                raise LmdbError("not an LMDB data file (bad magic)")
            # meta 1 lives at offset ps; check its magic to find ps
            if len(self._mm) > ps + 20:
                magic1 = struct.unpack_from("<I", self._mm, ps + 16)[0]
                if magic1 == MDB_MAGIC:
                    m0 = self._read_meta_at(0, ps)
                    m1 = self._read_meta_at(ps, ps)
                    meta = m0 if m0[1] >= m1[1] else m1
                    return ps, meta[2], meta[3]
        raise LmdbError("could not determine LMDB page size")

    def _page(self, pgno: int) -> int:
        return pgno * self.page_size

    def _page_header(self, off: int):
        flags, lower, upper = struct.unpack_from("<HHH", self._mm, off + 10)
        return flags, lower, upper

    def _num_keys(self, lower: int) -> int:
        return (lower - 16) // 2

    def _node(self, page_off: int, i: int):
        """→ (lo, hi, flags, ksize, data_off)."""
        ptr = struct.unpack_from("<H", self._mm, page_off + 16 + 2 * i)[0]
        off = page_off + ptr
        lo, hi, flags, ksize = struct.unpack_from("<HHHH", self._mm, off)
        return lo, hi, flags, ksize, off + 8

    def _branch_child(self, page_off: int, i: int) -> int:
        lo, hi, flags, _, _ = self._node(page_off, i)
        return lo | (hi << 16) | (flags << 32)

    def _node_key(self, page_off: int, i: int) -> bytes:
        _, _, _, ksize, doff = self._node(page_off, i)
        return self._mm[doff:doff + ksize]

    def _leaf_value(self, page_off: int, i: int) -> bytes:
        lo, hi, flags, ksize, doff = self._node(page_off, i)
        dsize = lo | (hi << 16)
        voff = doff + ksize
        if flags & F_BIGDATA:
            ovpg = struct.unpack_from("<Q", self._mm, voff)[0]
            ooff = self._page(ovpg) + 16
            return self._mm[ooff:ooff + dsize]
        return self._mm[voff:voff + dsize]

    # ---------- public API ----------

    def get(self, key: bytes) -> Optional[bytes]:
        if self.root < 0:
            return None
        pgno = self.root
        while True:
            off = self._page(pgno)
            flags, lower, _ = self._page_header(off)
            n = self._num_keys(lower)
            if flags & P_BRANCH:
                # first branch key is implicit-low; find rightmost key <= target
                child_idx = 0
                for i in range(1, n):
                    if self._node_key(off, i) <= key:
                        child_idx = i
                    else:
                        break
                pgno = self._branch_child(off, child_idx)
            elif flags & P_LEAF:
                for i in range(n):
                    k = self._node_key(off, i)
                    if k == key:
                        return self._leaf_value(off, i)
                    if k > key:
                        return None
                return None
            else:
                raise LmdbError(f"unexpected page flags {flags:#x}")

    def items(self) -> Iterator[Tuple[bytes, bytes]]:
        if self.root < 0:
            return

        def walk(pgno: int):
            off = self._page(pgno)
            flags, lower, _ = self._page_header(off)
            n = self._num_keys(lower)
            if flags & P_BRANCH:
                for i in range(n):
                    yield from walk(self._branch_child(off, i))
            elif flags & P_LEAF:
                for i in range(n):
                    yield self._node_key(off, i), self._leaf_value(off, i)

        yield from walk(self.root)

    def __len__(self) -> int:
        return max(self.entries, 0)

    def close(self) -> None:
        self._mm.close()
        self._f.close()

    def __enter__(self):
        return self

    def __exit__(self, *a):
        self.close()
