"""Bitmap I/O: EXR / PFM / RGBE / TGA / BMP / PPM / PNG read and write
(host side; the port's own copy of the JAX package's core/io_bitmap.py).

Images are exchanged as numpy float32 arrays, HDR formats linearly, LDR
formats with the sRGB transfer (Bitmap::convert's gamma handling). Every
codec the JAX package writes itself is copied unchanged, so a file either
package writes is the other's byte for byte. The JAX package reads and
writes PNG through imageio; here 8- and 16-bit PNG is a codec of its own
(numpy, zlib and struct) with the same 8-bit quantization, so the port
needs no imaging library. JPEG still goes through imageio, imported when a
JPEG is read or written.
"""
from __future__ import annotations

import os
import struct
import zlib

import numpy as np

# ---------------------------------------------------------------------------
# sRGB transfer (Bitmap::convert / linear_to_srgb in math.h)
# ---------------------------------------------------------------------------

def srgb_to_linear(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.04045, x / 12.92,
                    ((np.abs(x) + 0.055) / 1.055) ** 2.4).astype(np.float32)


def linear_to_srgb(x: np.ndarray) -> np.ndarray:
    x = np.asarray(x, np.float32)
    return np.where(x <= 0.0031308, x * 12.92,
                    1.055 * np.abs(x) ** (1 / 2.4) - 0.055).astype(np.float32)


# ---------------------------------------------------------------------------
# OpenEXR (scanline, NO_COMPRESSION or ZIP/ZIPS, FLOAT or HALF channels)
# ---------------------------------------------------------------------------

_EXR_MAGIC = 20000630
_PT_HALF, _PT_FLOAT = 1, 2


def _exr_attr(name: str, typ: str, payload: bytes) -> bytes:
    return (name.encode() + b"\0" + typ.encode() + b"\0" +
            struct.pack("<i", len(payload)) + payload)


def write_exr(path: str, img: np.ndarray, half: bool = True) -> None:
    """Write (H, W, C<=4) float data as a scanline EXR (ZIP compressed)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    names = {1: ["Y"], 2: ["Y", "A"], 3: ["R", "G", "B"],
             4: ["R", "G", "B", "A"]}[C]
    order = sorted(range(C), key=lambda i: names[i])  # EXR wants alpha order
    pt = _PT_HALF if half else _PT_FLOAT
    dtype = np.float16 if half else np.float32

    chans = b""
    for i in order:
        chans += (names[i].encode() + b"\0" +
                  struct.pack("<iiii", pt, 0, 1, 1))
    chans += b"\0"

    header = b""
    header += _exr_attr("channels", "chlist", chans)
    header += _exr_attr("compression", "compression", bytes([3]))  # ZIP
    header += _exr_attr("dataWindow", "box2i",
                        struct.pack("<iiii", 0, 0, W - 1, H - 1))
    header += _exr_attr("displayWindow", "box2i",
                        struct.pack("<iiii", 0, 0, W - 1, H - 1))
    header += _exr_attr("lineOrder", "lineOrder", bytes([0]))
    header += _exr_attr("pixelAspectRatio", "float", struct.pack("<f", 1.0))
    header += _exr_attr("screenWindowCenter", "v2f",
                        struct.pack("<ff", 0.0, 0.0))
    header += _exr_attr("screenWindowWidth", "float", struct.pack("<f", 1.0))
    header += b"\0"

    # ZIP blocks of 16 scanlines
    BLOCK = 16
    n_blocks = (H + BLOCK - 1) // BLOCK
    blocks = []
    for b in range(n_blocks):
        y0 = b * BLOCK
        rows = min(BLOCK, H - y0)
        # channel-planar per scanline: for each y, each channel's row
        raw = bytearray()
        for y in range(y0, y0 + rows):
            for i in order:
                raw += img[y, :, i].astype(dtype).tobytes()
        raw = bytes(raw)
        # EXR zip preprocessing (ImfZip.cpp): reorder into two interleaved
        # halves, THEN delta-encode the reordered buffer
        d = np.frombuffer(raw, np.uint8)
        half_n = (len(d) + 1) // 2
        tmp = np.empty(len(d), np.uint8)
        tmp[:half_n] = d[0::2]
        tmp[half_n:] = d[1::2]
        enc = tmp.astype(np.int16)
        enc[1:] = (enc[1:] - enc[:-1] + 128 + 256) % 256
        comp = zlib.compress(enc.astype(np.uint8).tobytes())
        if len(comp) >= len(raw):
            comp = raw
        blocks.append((y0, comp))

    with open(path, "wb") as f:
        f.write(struct.pack("<ii", _EXR_MAGIC, 2))
        f.write(header)
        offset = f.tell() + 8 * n_blocks
        for y0, comp in blocks:
            f.write(struct.pack("<Q", offset))
            offset += 8 + len(comp)
        for y0, comp in blocks:
            f.write(struct.pack("<iI", y0, len(comp)))
            f.write(comp)


def _exr_unpredict(data: bytes) -> bytes:
    """Undo ImfZip.cpp preprocessing: un-delta, then de-interleave halves."""
    d = np.frombuffer(data, np.uint8).astype(np.int64)
    d[1:] -= 128
    t = (np.cumsum(d) % 256).astype(np.uint8)
    half_n = (len(t) + 1) // 2
    out = np.empty(len(t), np.uint8)
    out[0::2] = t[:half_n]
    out[1::2] = t[half_n:]
    return out.tobytes()


def read_exr(path: str) -> np.ndarray:
    """Read a scanline EXR (uncompressed / ZIP / ZIPS; float or half)."""
    with open(path, "rb") as f:
        data = f.read()
    magic, version = struct.unpack_from("<ii", data, 0)
    if magic != _EXR_MAGIC:
        raise ValueError(f"{path}: not an EXR file")
    if version & 0x200:
        raise ValueError("tiled EXR not supported")
    pos = 8
    channels, compression, dw = [], 0, None
    while True:
        end = data.index(b"\0", pos)
        name = data[pos:end].decode()
        pos = end + 1
        if name == "":
            break
        end = data.index(b"\0", pos)
        typ = data[pos:end].decode()
        pos = end + 1
        size, = struct.unpack_from("<i", data, pos)
        pos += 4
        payload = data[pos:pos + size]
        pos += size
        if name == "channels":
            p = 0
            while payload[p] != 0:
                e = payload.index(b"\0", p)
                cname = payload[p:e].decode()
                ptype, = struct.unpack_from("<i", payload, e + 1)
                channels.append((cname, ptype))
                p = e + 1 + 16
        elif name == "compression":
            compression = payload[0]
        elif name == "dataWindow":
            dw = struct.unpack("<iiii", payload)
    if compression not in (0, 2, 3):  # NONE, ZIPS, ZIP
        raise ValueError(f"EXR compression {compression} not supported")
    W = dw[2] - dw[0] + 1
    H = dw[3] - dw[1] + 1
    rows_per_block = {0: 1, 2: 1, 3: 16}[compression]
    n_blocks = (H + rows_per_block - 1) // rows_per_block
    offsets = struct.unpack_from(f"<{n_blocks}Q", data, pos)

    cdt = [np.float16 if pt == _PT_HALF else np.float32 for _, pt in channels]
    csz = [2 if pt == _PT_HALF else 4 for _, pt in channels]
    out = np.zeros((H, W, len(channels)), np.float32)
    for off in offsets:
        y0, sz = struct.unpack_from("<iI", data, off)
        y0 -= dw[1]
        rows = min(rows_per_block, H - y0)
        raw_len = rows * W * sum(csz)
        block = data[off + 8: off + 8 + sz]
        if compression in (2, 3) and sz < raw_len:
            block = _exr_unpredict(zlib.decompress(block))
        p = 0
        for r in range(rows):
            for ci, (dt, s) in enumerate(zip(cdt, csz)):
                row = np.frombuffer(block, dt, W, p)
                out[y0 + r, :, ci] = row.astype(np.float32)
                p += W * s
    # reorder alphabetical EXR channels to RGB(A) / Y(A)
    names = [c for c, _ in channels]
    for want in (["R", "G", "B", "A"], ["R", "G", "B"], ["Y", "A"], ["Y"]):
        if sorted(want) == sorted(names):
            idx = [names.index(w) for w in want]
            return out[..., idx]
    return out


# ---------------------------------------------------------------------------
# PFM (Bitmap's PFM codec)
# ---------------------------------------------------------------------------

def write_pfm(path: str, img: np.ndarray) -> None:
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    H, W, C = img.shape
    hdr = b"PF\n" if C == 3 else b"Pf\n"
    if C not in (1, 3):
        raise ValueError("PFM supports 1 or 3 channels")
    with open(path, "wb") as f:
        f.write(hdr + f"{W} {H}\n-1.0\n".encode())
        f.write(img[::-1].tobytes())  # bottom-up, little endian (scale<0)


def read_pfm(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        kind = f.readline().strip()
        C = 3 if kind == b"PF" else 1
        W, H = map(int, f.readline().split())
        scale = float(f.readline())
        data = np.frombuffer(f.read(), "<f4" if scale < 0 else ">f4")
    return data.reshape(H, W, C)[::-1].astype(np.float32)


# ---------------------------------------------------------------------------
# Dispatch (Bitmap::read/write by extension)
# ---------------------------------------------------------------------------
# Radiance RGBE (.hdr) — shared-exponent HDR (Bitmap::FileFormat::RGBE)
# ---------------------------------------------------------------------------

def write_rgbe(path: str, img: np.ndarray) -> None:
    """Flat (uncompressed) RGBE scanlines, -Y +X orientation."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    if img.shape[-1] == 1:
        img = np.repeat(img, 3, axis=-1)
    H, W = img.shape[:2]
    rgb = np.maximum(img[..., :3], 0.0)
    mx = rgb.max(-1)
    e = np.zeros((H, W), np.int32)
    nz = mx >= 1e-32
    e[nz] = np.frexp(mx[nz])[1]          # mx = f * 2^e, f in [0.5, 1)
    scale = np.where(nz, np.ldexp(256.0, -e), 0.0)[..., None]
    rgbe = np.zeros((H, W, 4), np.uint8)
    rgbe[..., :3] = np.clip(rgb * scale + 0.5, 0, 255).astype(np.uint8)
    rgbe[..., 3] = np.where(nz, e + 128, 0).astype(np.uint8)
    with open(path, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {H} +X {W}\n".encode())
        f.write(rgbe.tobytes())


def read_rgbe(path: str) -> np.ndarray:
    """RGBE reader: flat and RLE scanlines (radiance .hdr files)."""
    with open(path, "rb") as f:
        data = f.read()
    # header ends at the first blank line; resolution line follows
    pos = data.index(b"\n\n") + 2
    eol = data.index(b"\n", pos)
    m = data[pos:eol].decode().split()
    assert m[0] == "-Y" and m[2] == "+X", f"unsupported orientation {m}"
    H, W = int(m[1]), int(m[3])
    pos = eol + 1
    rgbe = np.zeros((H, W, 4), np.uint8)
    for y in range(H):
        # new-style RLE scanline starts 0x02 0x02 and W < 32768
        if (pos + 4 <= len(data) and data[pos] == 2 and data[pos + 1] == 2
                and (data[pos + 2] << 8 | data[pos + 3]) == W):
            pos += 4
            for c in range(4):
                x = 0
                while x < W:
                    n = data[pos]; pos += 1
                    if n > 128:   # run
                        rgbe[y, x:x + n - 128, c] = data[pos]; pos += 1
                        x += n - 128
                    else:         # literal
                        rgbe[y, x:x + n, c] = np.frombuffer(
                            data, np.uint8, n, pos)
                        pos += n
                        x += n
        else:                      # flat scanline
            row = np.frombuffer(data, np.uint8, W * 4, pos).reshape(W, 4)
            rgbe[y] = row
            pos += W * 4
    e = rgbe[..., 3].astype(np.int32)
    scale = np.where(e > 0, np.ldexp(1.0, e - 136), 0.0)  # /256 * 2^(e-128)
    return (rgbe[..., :3].astype(np.float32) *
            scale[..., None]).astype(np.float32)


# ---------------------------------------------------------------------------
# TGA / BMP (uncompressed 24-bit, the subset mitsuba's Bitmap emits)
# ---------------------------------------------------------------------------

def write_tga(path: str, img: np.ndarray) -> None:
    ldr = np.clip(linear_to_srgb(np.clip(img, 0, 1)) * 255 + 0.5,
                  0, 255).astype(np.uint8)
    if ldr.ndim == 2:
        ldr = ldr[..., None]
    if ldr.shape[-1] == 1:
        ldr = np.repeat(ldr, 3, axis=-1)
    H, W = ldr.shape[:2]
    hdr = struct.pack("<BBBHHBHHHHBB", 0, 0, 2, 0, 0, 0, 0, 0, W, H, 24, 0x20)
    with open(path, "wb") as f:
        f.write(hdr)
        f.write(ldr[..., ::-1].tobytes())  # BGR, top-down (bit 5 set)


def read_tga(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    idlen, _, itype = data[0], data[1], data[2]
    W, H = struct.unpack_from("<HH", data, 12)
    bpp, desc = data[16], data[17]
    assert itype == 2 and bpp in (24, 32), "only uncompressed truecolor TGA"
    off = 18 + idlen
    nc = bpp // 8
    img = np.frombuffer(data, np.uint8, H * W * nc, off).reshape(H, W, nc)
    img = img[..., :3][..., ::-1]  # BGR(A) -> RGB
    if not (desc & 0x20):          # bottom-up origin
        img = img[::-1]
    return img.astype(np.float32) / 255.0


def write_bmp(path: str, img: np.ndarray) -> None:
    ldr = np.clip(linear_to_srgb(np.clip(img, 0, 1)) * 255 + 0.5,
                  0, 255).astype(np.uint8)
    if ldr.ndim == 2:
        ldr = ldr[..., None]
    if ldr.shape[-1] == 1:
        ldr = np.repeat(ldr, 3, axis=-1)
    H, W = ldr.shape[:2]
    row = W * 3
    pad = (4 - row % 4) % 4
    size = 54 + (row + pad) * H
    with open(path, "wb") as f:
        f.write(b"BM" + struct.pack("<IHHI", size, 0, 0, 54))
        f.write(struct.pack("<IiiHHIIiiII", 40, W, H, 1, 24, 0,
                            (row + pad) * H, 2835, 2835, 0, 0))
        bgr = ldr[..., ::-1]
        zeros = b"\0" * pad
        for y in range(H - 1, -1, -1):  # bottom-up
            f.write(bgr[y].tobytes() + zeros)


def read_bmp(path: str) -> np.ndarray:
    with open(path, "rb") as f:
        data = f.read()
    assert data[:2] == b"BM"
    off, = struct.unpack_from("<I", data, 10)
    hsz, W, H = struct.unpack_from("<Iii", data, 14)
    bpp, = struct.unpack_from("<H", data, 28)
    comp, = struct.unpack_from("<I", data, 30)
    assert bpp == 24 and comp == 0, "only uncompressed 24-bit BMP"
    flip = H > 0
    H = abs(H)
    row = W * 3
    stride = (row + 3) & ~3
    img = np.zeros((H, W, 3), np.uint8)
    for y in range(H):
        img[y] = np.frombuffer(data, np.uint8, row,
                               off + y * stride).reshape(W, 3)
    if flip:
        img = img[::-1]
    return img[..., ::-1].astype(np.float32) / 255.0


# ---------------------------------------------------------------------------

_HDR_EXT = {".exr", ".pfm", ".hdr", ".rgbe"}


def write_ppm(path: str, img: np.ndarray) -> None:
    """Binary PPM (P6) / PGM (P5 for single-channel), 8-bit sRGB-encoded
    (Bitmap's PPM path in src/libcore/bitmap.cpp)."""
    img = np.asarray(img, np.float32)
    if img.ndim == 2:
        img = img[..., None]
    ldr = np.clip(linear_to_srgb(np.clip(img, 0, 1)) * 255 + 0.5,
                  0, 255).astype(np.uint8)
    h, w, c = ldr.shape
    if c == 1:
        magic, data = b"P5", ldr[..., 0]
    else:
        magic, data = b"P6", ldr[..., :3]
    with open(path, "wb") as f:
        f.write(magic + b"\n%d %d\n255\n" % (w, h))
        f.write(np.ascontiguousarray(data).tobytes())


def read_ppm(path: str) -> np.ndarray:
    """PPM/PGM: P6/P5 binary and P3/P2 ascii, 8- or 16-bit maxval.
    Returns the raw (sRGB-encoded) values in [0, 1] like the other LDR
    readers."""
    with open(path, "rb") as f:
        blob = f.read()
    magic = blob[:2]
    if magic not in (b"P2", b"P3", b"P5", b"P6"):
        raise ValueError(f"{path}: not a PPM/PGM file")
    # header: magic, width, height, maxval — whitespace/comment separated
    toks, pos = [], 2
    while len(toks) < 3:
        while pos < len(blob) and blob[pos:pos + 1].isspace():
            pos += 1
        if blob[pos:pos + 1] == b"#":
            pos = blob.index(b"\n", pos) + 1
            continue
        end = pos
        while end < len(blob) and not blob[end:end + 1].isspace():
            end += 1
        toks.append(int(blob[pos:end]))
        pos = end
    w, h, maxval = toks
    pos += 1  # single whitespace after maxval
    nch = 3 if magic in (b"P3", b"P6") else 1
    n = w * h * nch
    if magic in (b"P5", b"P6"):
        dt = ">u2" if maxval > 255 else "u1"
        data = np.frombuffer(blob, dt, n, pos).astype(np.float32)
    else:
        data = np.asarray(blob[pos:].split()[:n], np.float32)
    img = (data / float(maxval)).reshape(h, w, nch)
    return img


# ---------------------------------------------------------------------------
# PNG (8- and 16-bit, non-interlaced; gray, gray + alpha, RGB, RGBA and
# 8-bit palette), zlib only
# ---------------------------------------------------------------------------

_PNG_SIG = b"\x89PNG\r\n\x1a\n"
# color type -> samples a pixel
_PNG_SAMPLES = {0: 1, 2: 3, 3: 1, 4: 2, 6: 4}


def _png_chunk(tag: bytes, payload: bytes) -> bytes:
    return (struct.pack(">I", len(payload)) + tag + payload +
            struct.pack(">I", zlib.crc32(tag + payload) & 0xFFFFFFFF))


def write_png(path: str, ldr: np.ndarray) -> None:
    """(H, W), (H, W, 1 | 2 | 3 | 4) uint8 -> an 8-bit PNG (gray, gray +
    alpha, RGB or RGBA), each row unfiltered."""
    ldr = np.asarray(ldr, np.uint8)
    if ldr.ndim == 3 and ldr.shape[-1] == 1:
        ldr = ldr[..., 0]
    if ldr.ndim == 2:
        ctype = 0
    else:
        ctype = {2: 4, 3: 2, 4: 6}.get(ldr.shape[-1])
        if ctype is None:
            raise ValueError(f"PNG holds 1-4 channels, not {ldr.shape[-1]}")
    H, W = ldr.shape[:2]
    rows = np.ascontiguousarray(ldr).reshape(H, -1)
    raw = np.concatenate([np.zeros((H, 1), np.uint8), rows], 1)
    with open(path, "wb") as f:
        f.write(_PNG_SIG)
        f.write(_png_chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, ctype,
                                                0, 0, 0)))
        f.write(_png_chunk(b"IDAT", zlib.compress(raw.tobytes())))
        f.write(_png_chunk(b"IEND", b""))


def _png_unfilter(data: bytes, H: int, stride: int, bpp: int) -> np.ndarray:
    """Undo the five PNG row filters -> (H, stride) uint8."""
    buf = np.frombuffer(data, np.uint8, H * (stride + 1)).reshape(
        H, stride + 1)
    out = np.zeros((H, stride), np.uint8)
    prev = np.zeros(stride, np.uint8)
    for y in range(H):
        ftype, row = int(buf[y, 0]), buf[y, 1:]
        if ftype == 0:
            cur = row
        elif ftype == 1:            # sub: a running sum along each sample
            cur = (np.cumsum(row.reshape(-1, bpp).astype(np.int64), 0)
                   & 0xFF).astype(np.uint8).reshape(-1)
        elif ftype == 2:            # up
            cur = row + prev        # uint8 wraps mod 256
        elif ftype in (3, 4):       # average, Paeth: byte by byte
            r, b_, cur_l = row.tolist(), prev.tolist(), [0] * stride
            for x in range(stride):
                a = cur_l[x - bpp] if x >= bpp else 0
                b = b_[x]
                if ftype == 3:
                    pred = (a + b) >> 1
                else:
                    c = b_[x - bpp] if x >= bpp else 0
                    p = a + b - c
                    pa, pb, pc = abs(p - a), abs(p - b), abs(p - c)
                    pred = a if pa <= pb and pa <= pc else (
                        b if pb <= pc else c)
                cur_l[x] = (r[x] + pred) & 0xFF
            cur = np.asarray(cur_l, np.uint8)
        else:
            raise ValueError(f"PNG filter type {ftype} not supported")
        out[y] = cur
        prev = out[y]
    return out


def _png_decode(path: str) -> np.ndarray:
    """A PNG's samples: (H, W) or (H, W, C) uint8 or uint16."""
    with open(path, "rb") as f:
        data = f.read()
    if data[:8] != _PNG_SIG:
        raise ValueError(f"{path}: not a PNG file")
    pos, idat, plte, trns, hdr = 8, [], None, None, None
    while pos < len(data):
        n, = struct.unpack_from(">I", data, pos)
        tag = data[pos + 4:pos + 8]
        payload = data[pos + 8:pos + 8 + n]
        pos += 12 + n
        if tag == b"IHDR":
            hdr = struct.unpack(">IIBBBBB", payload)
        elif tag == b"PLTE":
            plte = np.frombuffer(payload, np.uint8).reshape(-1, 3)
        elif tag == b"tRNS":
            trns = np.frombuffer(payload, np.uint8)
        elif tag == b"IDAT":
            idat.append(payload)
        elif tag == b"IEND":
            break
    W, H, depth, ctype, _, _, interlace = hdr
    if interlace:
        raise ValueError(f"{path}: interlaced PNG not supported")
    if ctype not in _PNG_SAMPLES or depth not in (8, 16) or (
            ctype == 3 and depth != 8):
        raise ValueError(f"{path}: PNG of color type {ctype} at {depth} "
                         "bits not supported")
    nc = _PNG_SAMPLES[ctype]
    bpp = nc * depth // 8
    rows = _png_unfilter(zlib.decompress(b"".join(idat)), H, W * bpp, bpp)
    if depth == 16:
        img = rows.view(">u2").astype(np.uint16).reshape(H, W, nc)
    else:
        img = rows.reshape(H, W, nc)
    if ctype == 3:
        idx = img[..., 0]
        rgb = plte[idx]
        if trns is None:
            return rgb
        alpha = np.full(len(plte), 255, np.uint8)
        alpha[:len(trns)] = trns[:len(plte)]
        return np.concatenate([rgb, alpha[idx][..., None]], -1)
    return img[..., 0] if nc == 1 else img


def read_png(path: str) -> np.ndarray:
    """PNG -> float32 in [0, 1], the raw (sRGB-encoded) values: (H, W) for
    gray, (H, W, C) otherwise, as the JAX package's imageio path reads
    it."""
    img = _png_decode(path)
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32) / 255.0


def read(path: str) -> np.ndarray:
    """Read any supported image -> (H, W, C) float32. HDR formats return
    linear data; LDR formats return the raw (sRGB-encoded) values in [0,1]
    (apply srgb_to_linear yourself, as Bitmap's `raw` flag does). PNG is
    read here; other LDR formats (JPEG) need imageio."""
    ext = os.path.splitext(path)[1].lower()
    if ext == ".exr":
        return read_exr(path)
    if ext == ".pfm":
        return read_pfm(path)
    if ext in (".hdr", ".rgbe"):
        return read_rgbe(path)
    if ext == ".tga":
        return read_tga(path)
    if ext == ".bmp":
        return read_bmp(path)
    if ext in (".ppm", ".pgm", ".pnm"):
        return read_ppm(path)
    if ext == ".png":
        return read_png(path)
    iio = _imageio(ext)
    img = np.asarray(iio.imread(path))
    if img.dtype == np.uint8:
        return img.astype(np.float32) / 255.0
    if img.dtype == np.uint16:
        return img.astype(np.float32) / 65535.0
    return img.astype(np.float32)


def write(path: str, img: np.ndarray) -> None:
    """Write (H, W, C) float32. HDR formats store linearly; PNG/JPG/TGA/BMP
    apply the sRGB transfer + 8-bit quantization (Bitmap::convert)."""
    ext = os.path.splitext(path)[1].lower()
    img = np.asarray(img, np.float32)
    if ext == ".exr":
        return write_exr(path, img)
    if ext == ".pfm":
        return write_pfm(path, img)
    if ext in (".hdr", ".rgbe"):
        return write_rgbe(path, img)
    if ext == ".tga":
        return write_tga(path, img)
    if ext == ".bmp":
        return write_bmp(path, img)
    if ext in (".ppm", ".pgm", ".pnm"):
        return write_ppm(path, img)
    ldr = np.clip(linear_to_srgb(np.clip(img, 0, 1)) * 255 + 0.5, 0, 255)
    if ext == ".png":
        return write_png(path, ldr.astype(np.uint8))
    _imageio(ext).imwrite(path, ldr.astype(np.uint8))


def _imageio(ext: str):
    """imageio.v3, for the formats without a codec here (JPEG, ...)."""
    try:
        import imageio.v3 as iio
    except ImportError as e:
        raise ImportError(
            f"reading or writing {ext or 'extension-less'} images needs "
            "imageio, which is not installed; EXR, PFM, HDR, TGA, BMP, "
            "PPM and PNG need nothing") from e
    return iio
