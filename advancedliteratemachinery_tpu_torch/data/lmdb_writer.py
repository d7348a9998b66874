"""Minimal LMDB-format writer (port of
`advancedliteratemachinery_tpu/data/lmdb_writer.py`; no liblmdb).

Writes lmdb/mdb.c's on-disk layout (meta pages 0-1, leaf and branch pages,
overflow chains), readable by `data/lmdb_reader.py` and the JAX reader.
Backs the `create-lmdb` CLI command (reference
OCR/MGP-STR/create_lmdb_dataset.py).

For the same input the file is byte-equal to the JAX writer's wherever
that one's layout fits its pages. The JAX writer puts 30 nodes on a leaf
and every leaf under one branch page, so it overflows a page when 30
inline values (up to 1000 bytes each) pass a page, and it raises past
about 2,300 samples (about 156 leaves). Here a leaf takes up to 30 nodes
while they fit, and branch pages stack in as many levels as the leaves
need.

`create_str_lmdb` checks each image as the JAX one does with PIL's
`Image.open(...).verify()`, without PIL (`image_check`): PNG's chunks and
their CRCs, JPEG's markers up to the start of the scan; neither decodes
pixels, so a progressive JPEG is kept as PIL keeps it.
"""

from __future__ import annotations

import os
import re
import struct
from typing import Dict, List, Optional, Sequence, Tuple

from advancedliteratemachinery_tpu_torch.pipelines.file_loading import (
    PNG_SIGNATURE, other_format)

PAGE = 4096
MAGIC = 0xBEEFC0DE
P_BRANCH, P_LEAF, P_OVERFLOW, P_META = 0x01, 0x02, 0x04, 0x08
F_BIGDATA = 0x01
MAX_LEAF_ITEMS = 30           # nodes a leaf page takes at most (JAX's)
INLINE_MAX = 1000             # longer values go to overflow pages (JAX's)


def _page_header(pgno: int, flags: int, lower: int, upper: int) -> bytes:
    return struct.pack("<QHHHH", pgno, 0, flags, lower, upper)


def _overflow_header(pgno: int, pages: int) -> bytes:
    return struct.pack("<QHHI", pgno, 0, P_OVERFLOW, pages)


def _even(node: bytes) -> bytes:
    return node + b"\x00" if len(node) % 2 else node


def _leaf_node(key: bytes, val, nflags: int) -> bytes:
    """val: the value's bytes, or (its size, first overflow page)."""
    if nflags & F_BIGDATA:
        dsize, pgno = val
        return _even(struct.pack("<HHHH", dsize & 0xFFFF, dsize >> 16, nflags,
                                 len(key)) + key + struct.pack("<Q", pgno))
    return _even(struct.pack("<HHHH", len(val) & 0xFFFF, len(val) >> 16,
                             nflags, len(key)) + key + val)


def _branch_node(key: bytes, child: int) -> bytes:
    return _even(struct.pack("<HHHH", child & 0xFFFF, (child >> 16) & 0xFFFF,
                             (child >> 32) & 0xFFFF, len(key)) + key)


def _build_page(pgno: int, flags: int, nodes: Sequence[bytes]) -> bytes:
    """Nodes packed at the end of the page (upper grows downward), their
    offsets after the header."""
    page = bytearray(PAGE)
    pos, offsets = PAGE, []
    for node in reversed(nodes):
        pos -= len(node)
        offsets.append(pos)
    offsets.reverse()
    page[0:16] = _page_header(pgno, flags, 16 + 2 * len(nodes),
                              min(offsets) if offsets else PAGE)
    for i, (off, node) in enumerate(zip(offsets, nodes)):
        struct.pack_into("<H", page, 16 + 2 * i, off)
        page[off:off + len(node)] = node
    return bytes(page)


def _pack(sizes: Sequence[int], max_items: Optional[int]) -> List[range]:
    """Consecutive groups of nodes, each on one page: a group takes the
    next node while it has fewer than `max_items` and the node (and its
    2-byte pointer) still fits."""
    groups, start, used = [], 0, 0
    for i, n in enumerate(sizes):
        if i > start and (used + n + 2 > PAGE - 16
                          or (max_items and i - start == max_items)):
            groups.append(range(start, i))
            start, used = i, 0
        used += n + 2
    groups.append(range(start, len(sizes)))
    return groups


def _build_meta(pgno: int, txnid: int, root: int, entries: int,
                last_pg: int) -> bytes:
    page = bytearray(PAGE)
    page[0:16] = _page_header(pgno, P_META, 0, 0)
    base = 16
    struct.pack_into("<II", page, base, MAGIC, 1)
    struct.pack_into("<QQ", page, base + 8, 0, PAGE * 1024)  # address, mapsize
    dbs = base + 24
    # dbs[0] (FREE_DBI): zeros with root = -1
    struct.pack_into("<q", page, dbs + 40, -1)
    # dbs[1] (MAIN_DBI): pad, flags, depth (1, as the JAX writer writes
    # it, whatever the tree's depth; neither reader reads it)
    main = dbs + 48
    struct.pack_into("<IHH", page, main, 0, 0, 1)
    struct.pack_into("<QQQ", page, main + 8, 0, 1, 0)
    struct.pack_into("<qq", page, main + 32, entries, root)
    struct.pack_into("<QQ", page, dbs + 96, last_pg, txnid)
    return bytes(page)


def write_lmdb(path: str, data: Dict[bytes, bytes]) -> None:
    """Write data.mdb at `path` (a file path)."""
    items = sorted(data.items())
    pages: Dict[int, bytes] = {}
    next_pg = 2  # 0, 1 are meta

    nodes = []
    for k, v in items:
        if len(v) > INLINE_MAX:
            npages = (len(v) + 16 + PAGE - 1) // PAGE
            opg = next_pg
            next_pg += npages
            buf = bytearray(npages * PAGE)
            buf[0:16] = _overflow_header(opg, npages)
            buf[16:16 + len(v)] = v
            for j in range(npages):
                pages[opg + j] = bytes(buf[j * PAGE:(j + 1) * PAGE])
            nodes.append(_leaf_node(k, (len(v), opg), F_BIGDATA))
        else:
            nodes.append(_leaf_node(k, v, 0))

    # leaves, then each level of branch pages above them, the root last;
    # the first key of a branch page is empty (LMDB never compares it)
    level = []                                   # (low key, page number)
    for group in _pack([len(n) for n in nodes], MAX_LEAF_ITEMS):
        pages[next_pg] = _build_page(next_pg, P_LEAF,
                                     [nodes[i] for i in group])
        level.append((items[group[0]][0] if group else b"", next_pg))
        next_pg += 1
    while len(level) > 1:
        entries = [_branch_node(b"" if i == 0 else key, pg)
                   for i, (key, pg) in enumerate(level)]
        upper = []
        for group in _pack([len(e) for e in entries], None):
            first = _branch_node(b"", level[group[0]][1])
            pages[next_pg] = _build_page(
                next_pg, P_BRANCH, [first] + [entries[i] for i in group[1:]])
            upper.append((level[group[0]][0], next_pg))
            next_pg += 1
        level = upper
    root = level[0][1]

    out = bytearray(next_pg * PAGE)
    out[0:PAGE] = _build_meta(0, 1, root, len(items), next_pg - 1)
    out[PAGE:2 * PAGE] = _build_meta(1, 2, root, len(items), next_pg - 1)
    for pg, blob in pages.items():
        out[pg * PAGE:(pg + 1) * PAGE] = blob
    with open(path, "wb") as f:
        f.write(bytes(out))


# ---------------- PIL's open + verify, without PIL ----------------

_PNG_MODES = {(1, 0), (2, 0), (4, 0), (8, 0), (16, 0), (8, 2), (16, 2),
              (1, 3), (2, 3), (4, 3), (8, 3), (8, 4), (16, 4), (8, 6),
              (16, 6)}                           # (bit depth, colour type)
_CHUNK_TYPE = re.compile(rb"\w\w\w\w")
# chunks whose handler in PIL's PNG plugin reads fields of a fixed size
# (a shorter chunk raises) → the least length it takes
_PNG_MIN_LENGTH = {b"gAMA": 4, b"sRGB": 1, b"pHYs": 9, b"acTL": 8,
                   b"fcTL": 26, b"fdAT": 4}
# JPEG markers with a length-prefixed segment that PIL's plugin reads
_JPEG_SOF = {0xFFC0, 0xFFC1, 0xFFC2, 0xFFC3, 0xFFC5, 0xFFC6, 0xFFC7, 0xFFC9,
             0xFFCA, 0xFFCB, 0xFFCD, 0xFFCE, 0xFFCF, 0xFFDE}
_JPEG_SEGMENT = (_JPEG_SOF | {0xFFC4, 0xFFCC, 0xFFDA, 0xFFDB, 0xFFDC, 0xFFDD,
                              0xFFDF, 0xFFFE} | set(range(0xFFE0, 0xFFF0)))
_JPEG_BARE = ({0xFFC8, 0xFFD8, 0xFFD9} | set(range(0xFFD0, 0xFFD8))
              | set(range(0xFFF0, 0xFFFE)))

class _Reader:
    def __init__(self, data: bytes):
        self.data, self.pos = data, 0

    def read(self, n: int) -> bytes:
        out = self.data[self.pos:self.pos + max(n, 0)]
        self.pos += len(out)
        return out

    def exact(self, n: int) -> bytes:
        """PIL's `_safe_read`: nothing for n <= 0, else n bytes or fail."""
        if n <= 0:
            return b""
        out = self.read(n)
        if len(out) < n:
            raise ValueError("truncated")
        return out


def _u16(b: bytes, at: int = 0) -> int:
    if len(b) < at + 2:
        raise ValueError("truncated")
    return struct.unpack_from(">H", b, at)[0]


def _u32(b: bytes, at: int = 0) -> int:
    if len(b) < at + 4:
        raise ValueError("truncated")
    return struct.unpack_from(">I", b, at)[0]


def _png_chunk(r: _Reader) -> Tuple[bytes, int]:
    head = r.read(8)
    length = _u32(head)
    if not _CHUNK_TYPE.match(head[4:8]):
        raise ValueError(f"broken PNG file (chunk {head[4:8]!r})")
    return head[4:8], length


def _png_crc(r: _Reader, kind: bytes, body: bytes) -> None:
    import zlib
    if zlib.crc32(body, zlib.crc32(kind)) != _u32(r.read(4)):
        raise ValueError(f"broken PNG file (bad checksum in {kind!r})")


def _check_png(data: bytes) -> Tuple[int, int]:
    """`PngImageFile._open` (the chunks up to the first IDAT, each CRC
    checked) and `verify` (every chunk from the IDAT to IEND); returns
    the IHDR's (width, height)."""
    r = _Reader(data)
    r.read(8)
    size, ctype = (0, 0), None          # ctype: colour type of a valid mode
    while True:
        kind, length = _png_chunk(r)
        if kind in (b"IDAT", b"IEND"):
            break
        body = r.exact(length)
        if kind == b"IHDR":
            if length < 13:
                raise ValueError("Truncated IHDR chunk")
            size = _u32(body, 0), _u32(body, 4)
            if (body[8], body[9]) in _PNG_MODES:
                ctype = body[9]
            if body[11]:
                raise ValueError("unknown filter category")
        elif len(body) < _PNG_MIN_LENGTH.get(kind, 0):
            raise ValueError(f"truncated {kind!r} chunk")
        elif kind == b"tRNS" and length < {0: 2, 2: 6}.get(ctype, 0):
            raise ValueError("truncated tRNS chunk")
        elif kind == b"iCCP":         # the byte after the name (or the first)
            i = body.find(b"\0")
            if i + 1 >= len(body) or body[i + 1] != 0:
                raise ValueError("iCCP: truncated or unknown compression")
        elif kind == b"zTXt":
            i = body.find(b"\0")
            if 0 <= i < len(body) - 1 and body[i + 1] != 0:
                raise ValueError("zTXt: unknown compression method")
        _png_crc(r, kind, body)
    if ctype is None or size[0] <= 0 or size[1] <= 0:
        raise ValueError("PNG: not identified")
    if kind == b"IEND":
        raise ValueError("PNG: no image data")
    while True:                               # verify: from the IDAT on
        _png_crc(r, kind, r.exact(length))
        kind, length = _png_chunk(r)
        if kind == b"IEND":
            return size


def _check_jpeg(data: bytes) -> Tuple[int, int]:
    """`JpegImageFile._open`: the markers from SOI to the start of the
    scan, each segment read whole, the frame header parsed as PIL parses
    it (8-bit samples, 1, 3 or 4 components, a non-empty size); returns
    the last frame header's (width, height). Nothing is decoded, so any
    JPEG process (progressive and arithmetic too) gives its size."""
    r = _Reader(data)
    r.read(3)
    s = b"\xff"
    size = layers = 0
    icc = []
    while True:
        if s[:1] != b"\xff":
            s = r.read(1)
            if not s:
                raise ValueError("truncated")
            continue
        s += r.read(1)
        marker = _u16(s)
        if marker in _JPEG_SEGMENT:
            body = r.exact(_u16(r.read(2)) - 2)
            if marker in _JPEG_SOF:
                size = (_u16(body, 3), _u16(body, 1))
                if body[:1] != b"\x08":
                    raise ValueError("JPEG: not 8-bit samples")
                layers = body[5] if len(body) > 5 else -1
                if layers not in (1, 3, 4):
                    raise ValueError(f"JPEG: {layers} components")
                if (len(body) - 6) % 3:
                    raise ValueError("JPEG: truncated component list")
                if icc and len(min(icc)) <= 13:
                    raise ValueError("JPEG: truncated ICC profile")
                icc = []
            elif marker == 0xFFDB:
                while body:
                    n = 65 if body[0] < 16 else 129
                    if len(body) < n:
                        raise ValueError("bad quantization table marker")
                    body = body[n:]
            elif marker == 0xFFE0 and body.startswith(b"JFIF"):
                _u16(body, 5)
            elif marker == 0xFFEE and body.startswith(b"Adobe"):
                _u16(body, 5)
            elif marker == 0xFFE2 and body.startswith(b"ICC_PROFILE\0"):
                icc.append(body)
            if marker == 0xFFDA:
                break
            s = r.read(1)
        elif marker in _JPEG_BARE:
            s = r.read(1)
        elif marker in (0, 0xFFFF):
            s = b"\xff"
        elif marker == 0xFF00:
            s = r.read(1)
        else:
            raise ValueError("JPEG: no marker found")
    if not layers or size[0] <= 0 or size[1] <= 0:
        raise ValueError("JPEG: not identified")
    return size


def image_size(data: bytes) -> Tuple[int, int]:
    """(height, width) of a PNG or JPEG file's bytes, read from its header
    as PIL's `Image.open(...).size` reads it (the PNG IHDR, the JPEG frame
    header), after the checks of `image_check`; another format raises a
    `ValueError` naming it."""
    if data.startswith(PNG_SIGNATURE):
        w, h = _check_png(data)
    elif data.startswith(b"\xff\xd8\xff"):
        w, h = _check_jpeg(data)
    else:
        kind = other_format(data) or "unrecognised"
        raise ValueError(f"{kind} image: the port reads the size of PNG "
                         f"and JPEG files")
    return h, w


def image_check(data: bytes) -> Optional[str]:
    """None when PIL's `Image.open(BytesIO(data)).verify()` would pass,
    else the reason it would not. PNG and JPEG are checked as PIL's
    plugins check them; BMP, GIF, TIFF and WebP by their signature alone
    (a truncated one is kept where PIL refuses it); any other bytes are an
    unidentified image."""
    try:
        if data.startswith(PNG_SIGNATURE):
            _check_png(data)
        elif data.startswith(b"\xff\xd8\xff"):
            _check_jpeg(data)
        elif other_format(data) is None:
            raise ValueError("cannot identify image file")
    except ValueError as e:
        return str(e)
    return None


def create_str_lmdb(gt_file: str, out_dir: str, root: str = "",
                    check_valid: bool = True) -> int:
    """Build an STR LMDB from a gt file of `imagepath\\tlabel` lines
    (reference OCR/MGP-STR/create_lmdb_dataset.py createDataset): keys
    num-samples / image-%09d (encoded bytes) / label-%09d. Returns the
    number of samples written."""
    data: Dict[bytes, bytes] = {}
    n = 0
    with open(gt_file, encoding="utf-8") as f:
        for line in f:
            line = line.rstrip("\n")
            if not line:
                continue
            path, _, label = line.partition("\t")
            full = os.path.join(root, path) if root else path
            with open(full, "rb") as imf:
                img_bytes = imf.read()
            if check_valid and image_check(img_bytes) is not None:
                print(f"skipping invalid image: {full}")
                continue
            n += 1
            data[b"image-%09d" % n] = img_bytes
            data[b"label-%09d" % n] = label.encode("utf-8")
    data[b"num-samples"] = str(n).encode()
    os.makedirs(out_dir, exist_ok=True)
    write_lmdb(os.path.join(out_dir, "data.mdb"), data)
    return n
