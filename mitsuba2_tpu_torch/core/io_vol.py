"""Mitsuba binary volume (.vol) codec (the port's own copy of
core/io_vol.py: numpy only, so the port imports nothing of the JAX
package).

The reference's heterogeneous medium reads density grids from `.vol`
files (gridvolume: include/mitsuba/render/volume.h + the grid3d plugin;
format documented in the Mitsuba plugin manual). Layout, little-endian:

    bytes 0-2   magic b"VOL"
    byte  3     version (3)
    int32       encoding: 1 = float32, 2 = float16, 3 = uint8
    int32 x3    xres, yres, zres
    int32       channels (1, 3, ...)
    float32 x6  world bbox: xmin ymin zmin xmax ymax zmax
    data        xres*yres*zres*channels values, x fastest:
                index = ((z*yres + y)*xres + x)*channels + c

uint8 data maps linearly [0, 255] -> [0, 1]. Arrays here are (zres,
yres, xres[, channels]) float32 — the (D, H, W) order GridVolume uses.
"""
from __future__ import annotations

import struct
from typing import Tuple

import numpy as np

_ENC_F32, _ENC_F16, _ENC_U8 = 1, 2, 3


def read_vol(path: str) -> Tuple[np.ndarray, np.ndarray, np.ndarray]:
    """Load a .vol file -> (data (D,H,W) or (D,H,W,C) f32, bbox_min, bbox_max)."""
    with open(path, "rb") as f:
        raw = f.read()
    if raw[:3] != b"VOL":
        raise ValueError(f"{path}: not a Mitsuba .vol file (bad magic)")
    version = raw[3]
    if version != 3:
        raise ValueError(f"{path}: unsupported .vol version {version}")
    enc, xres, yres, zres, nch = struct.unpack_from("<5i", raw, 4)
    bbox = struct.unpack_from("<6f", raw, 24)
    n = xres * yres * zres * nch
    off = 48
    if enc == _ENC_F32:
        data = np.frombuffer(raw, "<f4", n, off).astype(np.float32)
    elif enc == _ENC_F16:
        data = np.frombuffer(raw, "<f2", n, off).astype(np.float32)
    elif enc == _ENC_U8:
        data = np.frombuffer(raw, "u1", n, off).astype(np.float32) / 255.0
    else:
        raise ValueError(f"{path}: unsupported .vol encoding {enc}")
    data = data.reshape(zres, yres, xres, nch)
    if nch == 1:
        data = data[..., 0]
    return (np.ascontiguousarray(data),
            np.asarray(bbox[0:3], np.float32), np.asarray(bbox[3:6], np.float32))


def write_vol(path: str, data, bbox_min=(0, 0, 0), bbox_max=(1, 1, 1),
              encoding: str = "float32") -> None:
    """Write (D,H,W[,C]) data as a version-3 .vol file."""
    data = np.asarray(data, np.float32)
    if data.ndim == 3:
        data = data[..., None]
    if data.ndim != 4:
        raise ValueError(f"expected (D,H,W[,C]) data, got shape {data.shape}")
    zres, yres, xres, nch = data.shape
    enc = {"float32": _ENC_F32, "float16": _ENC_F16, "uint8": _ENC_U8}[encoding]
    with open(path, "wb") as f:
        f.write(b"VOL" + bytes([3]))
        f.write(struct.pack("<5i", enc, xres, yres, zres, nch))
        f.write(struct.pack("<6f", *np.asarray(bbox_min, np.float32),
                            *np.asarray(bbox_max, np.float32)))
        flat = data.reshape(-1)
        if enc == _ENC_F32:
            f.write(flat.astype("<f4").tobytes())
        elif enc == _ENC_F16:
            f.write(flat.astype("<f2").tobytes())
        else:
            f.write(np.clip(flat * 255.0 + 0.5, 0, 255)
                    .astype("u1").tobytes())
