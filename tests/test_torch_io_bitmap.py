"""The port's bitmap codecs (mitsuba2_tpu_torch/core/io_bitmap.py) against
the JAX package's.

Every codec the JAX package writes itself is the port's copy: a file
written by either package is the other's byte for byte and reads back to
equal arrays in both. PNG is the port's own codec (zlib only), held to the
JAX package's imageio path both ways: gray, gray + alpha, RGB and RGBA at
8 bits, PNGs with every row filter, 16-bit gray and a palette PNG.
"""
import os
import sys

import numpy as np
import pytest

from mitsuba2_tpu.core import io_bitmap as jio
from mitsuba2_tpu_torch.core import io_bitmap as tio

PKGS = {"port": tio, "jax": jio}


@pytest.fixture(scope="module")
def img():
    rng = np.random.default_rng(7)
    return (rng.uniform(0, 4, (33, 17, 3)) ** 2).astype(np.float32)


def _write(pkg, path, a, fmt):
    if fmt == "exr_half":
        PKGS[pkg].write_exr(path, a, half=True)
    elif fmt == "exr_float":
        PKGS[pkg].write_exr(path, a, half=False)
    else:
        PKGS[pkg].write(path, a)


# format -> extension (HDR files hold the image as is, LDR ones its
# values over 20, mostly in [0, 1])
FORMATS = {"exr_half": ".exr", "exr_float": ".exr", "pfm": ".pfm",
           "hdr": ".hdr", "tga": ".tga", "bmp": ".bmp", "ppm": ".ppm",
           "pgm": ".pgm"}


@pytest.mark.parametrize("writer", ["port", "jax"])
@pytest.mark.parametrize("fmt", sorted(FORMATS))
def test_files_cross_read_equal(tmp_path, img, fmt, writer):
    """A file either package writes: the other package writes the same
    bytes, and both read it to one array."""
    a = img if FORMATS[fmt] in (".exr", ".pfm", ".hdr") else img / 20.0
    if fmt == "pgm":
        a = a[..., 0]
    if fmt == "exr_float":
        a = np.concatenate([a, a[..., :1] * 0.5], -1)   # RGBA
    reader = "jax" if writer == "port" else "port"
    p, q = str(tmp_path / f"w{FORMATS[fmt]}"), str(tmp_path / f"r{FORMATS[fmt]}")
    _write(writer, p, a, fmt)
    _write(reader, q, a, fmt)
    with open(p, "rb") as f, open(q, "rb") as g:
        assert f.read() == g.read()
    got, want = PKGS[reader].read(p), PKGS[writer].read(p)
    assert got.dtype == want.dtype == np.float32
    assert got.shape == want.shape and np.array_equal(got, want)


def test_exr_values(tmp_path, img):
    """Float EXR keeps the values, half EXR their float16 quantization."""
    for half, want in ((False, img),
                       (True, img.astype(np.float16).astype(np.float32))):
        p = str(tmp_path / "v.exr")
        tio.write_exr(p, img, half=half)
        assert np.array_equal(jio.read_exr(p), want)
        assert np.array_equal(tio.read_exr(p), want)


def test_rgbe_rle_scanlines_read_equal(tmp_path):
    """An RLE-encoded Radiance scanline (runs and literals) decodes alike."""
    W, H = 40, 2
    rows = []
    for y in range(H):
        row = b"\x02\x02" + bytes([W >> 8, W & 0xFF])
        for c in range(4):
            # a run of 30 then a literal of 10
            val = 100 + 10 * c + y
            row += bytes([128 + 30, val]) + bytes([10]) + bytes(
                range(val, val + 10))
        rows.append(row)
    p = str(tmp_path / "rle.hdr")
    with open(p, "wb") as f:
        f.write(b"#?RADIANCE\nFORMAT=32-bit_rle_rgbe\n\n")
        f.write(f"-Y {H} +X {W}\n".encode())
        f.write(b"".join(rows))
    assert np.array_equal(tio.read(p), jio.read(p))


def test_srgb_transfers_match_jax():
    x = np.linspace(-0.1, 1.2, 2001, dtype=np.float32)
    assert np.array_equal(tio.srgb_to_linear(x), jio.srgb_to_linear(x))
    assert np.array_equal(tio.linear_to_srgb(x), jio.linear_to_srgb(x))


@pytest.mark.parametrize("channels", [None, 2, 3, 4])
def test_png_against_jax_imageio(tmp_path, channels):
    """The port's PNG codec against the JAX package's imageio path: each
    writes, the other reads, to equal arrays, with the JAX package's
    8-bit quantization (gray as (H, W))."""
    rng = np.random.default_rng(11)
    shape = (21, 13) if channels is None else (21, 13, channels)
    a = rng.uniform(-0.1, 1.1, shape).astype(np.float32)
    pt, pj = str(tmp_path / "t.png"), str(tmp_path / "j.png")
    tio.write(pt, a)
    jio.write(pj, a)
    want = jio.read(pj)
    assert want.shape == shape
    for p in (pt, pj):
        assert np.array_equal(tio.read(p), want)
        assert np.array_equal(jio.read(p), want)


def test_png_reads_every_row_filter(tmp_path):
    """PNGs with each row filter (none, sub, up, average, Paeth, by row),
    written by PIL with its adaptive filters, by imageio at 16 bits, and
    as a palette, read as the JAX package's imageio path reads them."""
    from PIL import Image
    yy, xx = np.mgrid[:40, :33]
    smooth = (np.stack([xx * 7, yy * 5, xx + yy, xx * yy], -1) % 256
              ).astype(np.uint8)
    p = str(tmp_path / "filters.png")
    _write_filtered_png(p, smooth)
    assert np.array_equal(tio.read(p), jio.read(p))
    assert np.array_equal(tio._png_decode(p), smooth)
    cases = {"rgb": Image.fromarray(smooth[..., :3]),
             "gray": Image.fromarray(smooth[..., 0]),
             "palette": Image.fromarray(smooth[..., :3]).convert(
                 "P", palette=Image.ADAPTIVE)}
    for name, im in cases.items():
        p = str(tmp_path / f"{name}.png")
        im.save(p, optimize=True)
        assert np.array_equal(tio.read(p), jio.read(p)), name
    import imageio.v3 as iio
    g16 = np.random.default_rng(2).integers(0, 65536, (9, 5)).astype(
        np.uint16)
    p = str(tmp_path / "g16.png")
    iio.imwrite(p, g16)
    assert np.array_equal(tio.read(p), jio.read(p))


def _write_filtered_png(path, rgba):
    """An 8-bit RGBA PNG whose row y is filtered with type y % 5 (the PNG
    specification's filters, encoded here)."""
    import struct
    import zlib
    H, W, bpp = rgba.shape[0], rgba.shape[1], 4
    rows = rgba.reshape(H, -1).astype(np.int64)
    out = b""
    for y in range(H):
        ftype, x = y % 5, rows[y]
        up = rows[y - 1] if y else np.zeros_like(x)
        left = np.concatenate([np.zeros(bpp, np.int64), x[:-bpp]])
        ul = np.concatenate([np.zeros(bpp, np.int64), up[:-bpp]])
        p = left + up - ul
        pa, pb, pc = abs(p - left), abs(p - up), abs(p - ul)
        paeth = np.where((pa <= pb) & (pa <= pc), left,
                         np.where(pb <= pc, up, ul))
        pred = [0, left, up, (left + up) >> 1, paeth][ftype]
        out += bytes([ftype]) + ((x - pred) & 0xFF).astype(np.uint8).tobytes()

    def chunk(tag, payload):
        return (struct.pack(">I", len(payload)) + tag + payload +
                struct.pack(">I", zlib.crc32(tag + payload)))
    with open(path, "wb") as f:
        f.write(b"\x89PNG\r\n\x1a\n")
        f.write(chunk(b"IHDR", struct.pack(">IIBBBBB", W, H, 8, 6, 0, 0, 0)))
        f.write(chunk(b"IDAT", zlib.compress(out)))
        f.write(chunk(b"IEND", b""))


def test_jpeg_without_imageio_raises_by_format(tmp_path, monkeypatch):
    """JPEG goes through imageio; without it the port raises an
    ImportError naming the format, and reads or writes PNG all the same."""
    monkeypatch.setitem(sys.modules, "imageio", None)
    monkeypatch.setitem(sys.modules, "imageio.v3", None)
    a = np.full((4, 4, 3), 0.5, np.float32)
    for call in (lambda: tio.write(str(tmp_path / "x.jpg"), a),
                 lambda: tio.read(str(tmp_path / "x.jpeg"))):
        with pytest.raises(ImportError, match=r"\.jpe?g"):
            call()
    p = str(tmp_path / "x.png")
    tio.write(p, a)
    assert os.path.exists(p) and tio.read(p).shape == (4, 4, 3)


@pytest.mark.parametrize("ext", [".jpg", ".jpeg"])
def test_jpeg_round_trip_matches_jax(tmp_path, ext):
    """With imageio installed, the port writes a JPEG byte-equal to the
    JAX package's and reads it byte-equal to the JAX package's read; the
    decode of a smooth image is near the image it encoded."""
    pytest.importorskip("imageio")
    y, x = np.mgrid[0:24, 0:40] / np.array([23.0, 39.0])[:, None, None]
    a = np.stack([x, y, 0.5 * (x + y)], -1).astype(np.float32)
    pt, pj = str(tmp_path / f"t{ext}"), str(tmp_path / f"j{ext}")
    tio.write(pt, a)
    jio.write(pj, a)
    assert open(pt, "rb").read() == open(pj, "rb").read()
    back = tio.read(pt)
    ref = np.asarray(jio.read(pt))
    assert back.dtype == np.float32 and back.tobytes() == ref.tobytes()
    assert back.shape == a.shape
    srgb = np.clip(tio.linear_to_srgb(a), 0, 1)
    assert np.abs(back - srgb).mean() < 0.05
