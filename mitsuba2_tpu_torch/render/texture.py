"""Textures: spatially varying spectrum slots, bitmap and checkerboard
(counterpart of render/texture.py).

Every texture of a scene lives in one padded atlas (T, TH, TW, 3) of
linear RGB, with its per-texture metadata `info` (T, 4) [height, width,
wrap, filter] and affine uv transforms `uvt` (T, 6) [a, b, tx, c, d, ty],
packed on the host exactly as the JAX package packs them, and a mip
pyramid of every level below the first, built on the device from the
texels (`build_mips`, differentiable: texture gradients flow through
every level). A spectrum slot whose kind column names a texture id
(render/spectra.py) reads the atlas at the lane's uv: nearest or bilinear
at level 0, trilinear over the pyramid where the lane carries a
screen-space footprint (ray differentials, `duv`).

Texel fetches are row gathers on the flat (T*TH*TW, 3) table
(`texel_gather`), whose backward adds the lanes' gradients with
index_add_. A lookup runs inside the profiler range TEXTURE_RANGE and a
gather's backward inside TEXEL_BACKWARD_RANGE, so that a profile puts
their device time apart.
"""
from __future__ import annotations

import dataclasses
from typing import List, Optional

import numpy as np
import torch

from ..core.spec import Spec
from ..core.vec import Vec2

WRAP_REPEAT = 0
WRAP_CLAMP = 1
WRAP_MIRROR = 2
FILTER_BILINEAR = 0
FILTER_NEAREST = 1

_WRAP_NAME = {"repeat": WRAP_REPEAT, "clamp": WRAP_CLAMP, "mirror": WRAP_MIRROR}
_FILTER_NAME = {"bilinear": FILTER_BILINEAR, "nearest": FILTER_NEAREST}
# the atlas' host tables, the keys scene_from_numpy carries it by
TEX_FIELDS = ("data", "info", "uvt")
# torch.profiler ranges: a lookup (eval_rgb), a texel gather's backward
TEXTURE_RANGE = "texture lookup"
TEXEL_BACKWARD_RANGE = "texel gather backward"


@dataclasses.dataclass
class TextureAtlas:
    """All textures of a scene in one padded atlas, on one device."""
    data: torch.Tensor   # (T, TH, TW, 3) f32 linear RGB, zero-padded
    info: torch.Tensor   # (T, 4) f32 [height, width, wrap, filter]
    uvt: torch.Tensor    # (T, 6) f32 [a, b, tx, c, d, ty]
    # levels >= 1, flattened: level k's texel (t, y, x) at
    # level_offsets[k - 1] + (t * TH_k + y) * TW_k + x; None: no filtering
    mips: Optional[torch.Tensor]   # (S, 3)
    level_offsets: tuple = ()
    level_shapes: tuple = ()
    # (L, 3) i64 [offset, height, width] of each level >= 1, on the device
    levels: Optional[torch.Tensor] = None
    # the wrap modes and filters of its textures: the lookups compute these
    wraps: tuple = (WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR)
    filters: tuple = (FILTER_BILINEAR, FILTER_NEAREST)

    def to(self, device) -> "TextureAtlas":
        return dataclasses.replace(
            self, data=self.data.to(device), info=self.info.to(device),
            uvt=self.uvt.to(device),
            mips=None if self.mips is None else self.mips.to(device),
            levels=None if self.levels is None else self.levels.to(device))

    def with_data(self, data: torch.Tensor) -> "TextureAtlas":
        """The atlas with new texels and the pyramid rebuilt from them."""
        return dataclasses.replace(self, data=data,
                                   mips=build_mips(data, self.info))


class TextureBuild:
    """One texture staged on the host before the atlas is packed."""

    def __init__(self, data: np.ndarray, wrap: int, filter_: int,
                 uvt: np.ndarray, name: str = ""):
        self.data = np.asarray(data, np.float32)
        self.wrap = wrap
        self.filter = filter_
        self.uvt = np.asarray(uvt, np.float32)
        self.name = name


def _uv_transform(desc: dict) -> np.ndarray:
    """`to_uv` (a 3x3 or 4x4 matrix) -> the packed affine row."""
    t = desc.get("to_uv")
    if t is None:
        return np.array([1, 0, 0, 0, 1, 0], np.float32)
    t = np.asarray(t, np.float32)
    if t.ndim == 2:
        return np.array([t[0, 0], t[0, 1], t[0, -1],
                         t[1, 0], t[1, 1], t[1, -1]], np.float32)
    raise ValueError("to_uv must be a 3x3/4x4 matrix")


def build_texture(desc: dict, name: str = "") -> TextureBuild:
    """Texture descriptor -> staged host texture.

    bitmap: {"type": "bitmap", "data": (H, W, 3 | 1) array, "wrap_mode",
             "filter_type", "to_uv"} (an image file raises: the port reads
             none yet);
    checkerboard: {"type": "checkerboard", "color0", "color1", "to_uv"},
             a 2x2 nearest texture with a repeat wrap."""
    t = desc.get("type")
    if t == "checkerboard":
        c0 = np.asarray(desc.get("color0", [0.4] * 3), np.float32).reshape(-1)
        c1 = np.asarray(desc.get("color1", [0.2] * 3), np.float32).reshape(-1)
        if c0.size == 1:
            c0 = np.repeat(c0, 3)
        if c1.size == 1:
            c1 = np.repeat(c1, 3)
        # checkerboard.cpp's quadrants over [0, 1]^2: color0 where the
        # cell parities match; row 0 is v in [0, 0.5)
        data = np.array([[c0, c1], [c1, c0]], np.float32)
        return TextureBuild(data, WRAP_REPEAT, FILTER_NEAREST,
                            _uv_transform(desc), name)
    if t == "bitmap":
        if "data" not in desc:
            raise NotImplementedError(
                "mitsuba2_tpu_torch does not read image files yet (bitmap "
                f"filename {desc.get('filename')!r}); pass the image as "
                "'data'")
        data = np.asarray(desc["data"], np.float32)
        if data.ndim == 2:
            data = data[..., None]
        if data.shape[-1] == 1:
            data = np.repeat(data, 3, axis=-1)
        if data.shape[-1] == 4:
            data = data[..., :3]
        wrap = _WRAP_NAME[desc.get("wrap_mode", "repeat")]
        filt = _FILTER_NAME[desc.get("filter_type", "bilinear")]
        return TextureBuild(data, wrap, filt, _uv_transform(desc), name)
    raise ValueError(f"unknown texture type {t!r}")


def mip_level_geometry(TH: int, TW: int):
    """The pyramid of a (TH, TW) atlas: the shapes of levels >= 1, their
    offsets into the flat mip table (per texture), and its length."""
    shapes = []
    h, w = TH, TW
    while h > 1 or w > 1:
        h, w = max((h + 1) // 2, 1), max((w + 1) // 2, 1)
        shapes.append((h, w))
    offsets, acc = [], 0
    for (h, w) in shapes:
        offsets.append(acc)
        acc += h * w
    return tuple(shapes), tuple(offsets), acc


def build_mips(data: torch.Tensor, info: torch.Tensor) -> torch.Tensor:
    """(T, TH, TW, 3) atlas -> the flat (S, 3) pyramid of levels >= 1:
    2x2 sums pooled with each texture's validity mask, so that the zero
    padding beyond its (h, w) never bleeds into a level; sums carry down
    and each level is their average. A 2x2 block's texels add in the
    order ((x00 + x01) + x10) + x11, XLA's on the CPU, so that the
    pyramid is byte-equal to the JAX package's (the mask's counts are
    exact in any order). Differentiable."""
    T, TH, TW, _ = data.shape
    shapes = mip_level_geometry(TH, TW)[0]
    ys = torch.arange(TH, device=data.device)[None, :, None]
    xs = torch.arange(TW, device=data.device)[None, None, :]
    mask = ((ys < info[:, 0, None, None]) &
            (xs < info[:, 1, None, None])).to(torch.float32)

    def pool(x, h, w):
        ph, pw = h % 2, w % 2
        if ph or pw:   # pad the odd side with a zero row or column
            pad = (0, 0, 0, pw, 0, ph) if x.ndim == 4 else (0, pw, 0, ph)
            x = torch.nn.functional.pad(x, pad)
        nh, nw = (h + ph) // 2, (w + pw) // 2
        b = x.reshape(T, nh, 2, nw, 2, *x.shape[3:])
        return (((b[:, :, 0, :, 0] + b[:, :, 0, :, 1]) + b[:, :, 1, :, 0])
                + b[:, :, 1, :, 1]), nh, nw

    levels = []
    cur, cm = data * mask[..., None], mask
    h, w = TH, TW
    for (lh, lw) in shapes:
        cur, nh, nw = pool(cur, h, w)
        cm = pool(cm, h, w)[0]
        h, w = nh, nw
        assert (h, w) == (lh, lw), ((h, w), (lh, lw))
        avg = cur / torch.clamp_min(cm, 1e-8)[..., None]
        levels.append((avg * (cm[..., None] > 0)).reshape(T * lh * lw, 3))
    if not levels:
        return data.new_zeros((0, 3))
    return torch.cat(levels, 0)


def pack_atlas(textures: List[TextureBuild]) -> Optional[dict]:
    """Pad the staged textures to a common (TH, TW) and stack them: the
    atlas' host tables (TEX_FIELDS), byte-equal to the JAX package's, or
    None without a texture."""
    if not textures:
        return None
    TH = max(t.data.shape[0] for t in textures)
    TW = max(t.data.shape[1] for t in textures)
    data = np.zeros((len(textures), TH, TW, 3), np.float32)
    info = np.zeros((len(textures), 4), np.float32)
    uvt = np.zeros((len(textures), 6), np.float32)
    for i, t in enumerate(textures):
        h, w = t.data.shape[:2]
        data[i, :h, :w] = t.data
        info[i] = [h, w, t.wrap, t.filter]
        uvt[i] = t.uvt
    return dict(data=data, info=info, uvt=uvt)


def atlas_from_numpy(tabs: dict, device) -> TextureAtlas:
    """The atlas' host tables (TEX_FIELDS) -> TextureAtlas on `device`,
    its pyramid built there."""
    def up(a):
        return torch.from_numpy(np.array(a, np.float32, order="C")).to(device)
    data, info = up(tabs["data"]), up(tabs["info"])
    shapes, offsets, _ = mip_level_geometry(*data.shape[1:3])
    levels = torch.tensor([(o, h, w) for o, (h, w) in zip(offsets, shapes)],
                          dtype=torch.int64).reshape(-1, 3).to(device)
    modes = np.asarray(tabs["info"])[:, 2:4].astype(np.int64)
    return TextureAtlas(data=data, info=info, uvt=up(tabs["uvt"]),
                        mips=build_mips(data, info), level_offsets=offsets,
                        level_shapes=shapes, levels=levels,
                        wraps=tuple(sorted(set(modes[:, 0].tolist()))),
                        filters=tuple(sorted(set(modes[:, 1].tolist()))))


# ---------------------------------------------------------------------------
# Device evaluation
# ---------------------------------------------------------------------------

class _TexelGather(torch.autograd.Function):
    """table.index_select(0, idx) for an (M, 3) texel table and a
    wavefront of lanes; the backward adds each lane's gradient into its
    row with index_add_ (advanced indexing's backward, index_put_ with
    accumulate, sorts the indices first: ~15x slower on an H100)."""

    @staticmethod
    def forward(ctx, table, idx):
        ctx.save_for_backward(idx)
        ctx.rows = table.shape[0]
        return table.index_select(0, idx)

    @staticmethod
    def backward(ctx, g):
        idx, = ctx.saved_tensors
        with torch.profiler.record_function(TEXEL_BACKWARD_RANGE):
            out = g.new_zeros((ctx.rows, g.shape[1])).index_add_(0, idx, g)
        return out, None


def texel_gather(table, idx):
    """Rows `idx` of `table`: through _TexelGather where autograd records,
    else a plain index_select."""
    if torch.is_grad_enabled() and table.requires_grad:
        return _TexelGather.apply(table, idx)
    return table.index_select(0, idx)


def _wrap_coord(i, n, wrap, modes=(WRAP_REPEAT, WRAP_CLAMP, WRAP_MIRROR)):
    """Integer texel index wrap (repeat: floor-mod, clamp, mirror with
    period 2n); i, n, wrap (N,) integer tensors. Only the `modes` the
    atlas holds are computed."""
    n = torch.clamp_min(n, 1)
    out = None
    if WRAP_MIRROR in modes:
        m = torch.remainder(i, 2 * n)
        out = torch.where(m >= n, 2 * n - 1 - m, m)
    if WRAP_CLAMP in modes:
        clp = torch.minimum(torch.clamp_min(i, 0), n - 1)
        out = clp if out is None else torch.where(wrap == WRAP_CLAMP, clp, out)
    if WRAP_REPEAT in modes:
        rep = torch.remainder(i, n)
        out = rep if out is None else torch.where(wrap == WRAP_REPEAT, rep,
                                                  out)
    return out


def _bilinear(table, row_base, u, v, hh, ww, wrap, modes):
    """Bilinear lookups of the lanes at (u, v) in content of hh x ww
    texels (per lane, int64), the row of texel (y, x) row_base(y) + x in
    `table`: the four corners' rows in one gather -> (N, 3). The same f32
    operations, in the same order, as a corner at a time."""
    n = u.shape[0]
    x = u * ww.to(torch.float32) - 0.5
    y = v * hh.to(torch.float32) - 0.5
    x0f, y0f = torch.floor(x), torch.floor(y)
    fx, fy = (x - x0f)[:, None], (y - y0f)[:, None]
    x0, y0 = x0f.to(torch.int64), y0f.to(torch.int64)
    wrap2 = torch.cat([wrap, wrap])
    xw = _wrap_coord(torch.cat([x0, x0 + 1]), torch.cat([ww, ww]), wrap2,
                     modes)
    yb = row_base(_wrap_coord(torch.cat([y0, y0 + 1]), torch.cat([hh, hh]),
                              wrap2, modes))
    idx = torch.cat([yb[:n] + xw[:n], yb[:n] + xw[n:],
                     yb[n:] + xw[:n], yb[n:] + xw[n:]])
    c = texel_gather(table, idx).view(4, n, 3)
    return ((c[0] * (1 - fx) + c[1] * fx) * (1 - fy)
            + (c[2] * (1 - fx) + c[3] * fx) * fy)


def eval_rgb(atlas: TextureAtlas, tid, uv: Vec2, duv=None) -> Spec:
    """Texture lookup of a wavefront: (N,) texture ids and uv -> Spec3.

    bitmap.cpp's eval: the uv transform, the wrap, nearest or bilinear at
    level 0 (v runs top-down: row 0 is v just above 0). With `duv` =
    (duv_dx, duv_dy), the lanes' screen-space footprint, the lookup is
    trilinear over the pyramid at lod log2 of the footprint's longer side
    in texels, clamped to [0, levels]; a lane at lod < 1 blends level 0's
    value (nearest or bilinear) with level 1's."""
    with torch.profiler.record_function(TEXTURE_RANGE):
        return _eval_rgb(atlas, tid, uv, duv)


def _eval_rgb(atlas: TextureAtlas, tid, uv: Vec2, duv) -> Spec:
    T, TH, TW, _ = atlas.data.shape
    tid = torch.clamp(tid.to(torch.int64), 0, T - 1)
    meta = atlas.info.index_select(0, tid)
    h, w, wrap, filt = meta.to(torch.int64).unbind(1)
    uvt = atlas.uvt.index_select(0, tid).unbind(1)
    u = uvt[0] * uv.x + uvt[1] * uv.y + uvt[2]
    v = uvt[3] * uv.x + uvt[4] * uv.y + uvt[5]
    flat = atlas.data.reshape(T * TH * TW, 3)
    tbase = tid * TH
    tbase2 = torch.cat([tbase, tbase])

    def row0(yi):
        return ((tbase if yi.shape == tbase.shape else tbase2) + yi) * TW

    # nearest applies at level 0 alone: once a footprint spans texels the
    # pyramid's filtering overrides it (a checkerboard's 2x2 texels); the
    # filters the atlas lacks are not computed
    base = near = None
    if FILTER_NEAREST in atlas.filters:
        xn = _wrap_coord(torch.floor(u * meta[:, 1]).to(torch.int64), w, wrap,
                         atlas.wraps)
        yn = _wrap_coord(torch.floor(v * meta[:, 0]).to(torch.int64), h, wrap,
                         atlas.wraps)
        base = near = texel_gather(flat, row0(yn) + xn)
    if FILTER_BILINEAR in atlas.filters:
        base = _bilinear(flat, row0, u, v, h, w, wrap, atlas.wraps)
        if near is not None:
            base = torch.where((filt == FILTER_NEAREST)[:, None], near, base)
    n_levels = len(atlas.level_shapes)
    if duv is None or atlas.mips is None or n_levels == 0:
        return Spec(base.unbind(1))

    hf, wf = meta[:, 0], meta[:, 1]

    def texel_len(dv: Vec2):
        du_ = uvt[0] * dv.x + uvt[1] * dv.y
        dv_ = uvt[3] * dv.x + uvt[4] * dv.y
        return torch.sqrt((du_ * wf) ** 2 + (dv_ * hf) ** 2)

    rho = torch.clamp_min(torch.maximum(texel_len(duv[0]),
                                        texel_len(duv[1])), 1e-8)
    lod = torch.clamp(torch.log2(rho), 0.0, float(n_levels))
    l0f = torch.floor(lod)        # 0: the base level
    lfrac = (lod - l0f)[:, None]
    l0 = l0f.to(torch.int64)

    def sample_level(lvl):
        """Bilinear at level lvl >= 1 (per lane): the texture's content
        there is ceil(h / 2^lvl) x ceil(w / 2^lvl) texels."""
        li = torch.clamp(lvl - 1, 0, n_levels - 1)
        off, th_l, tw_l = atlas.levels.index_select(0, li).unbind(1)
        sh = torch.clamp_max(li + 1, 30)
        one = torch.ones_like(sh)
        hh = torch.clamp_min((h + (one << sh) - 1) >> sh, 1)
        ww = torch.clamp_min((w + (one << sh) - 1) >> sh, 1)
        off2, th2, tw2, t2 = (torch.cat([a, a]) for a in (off, th_l, tw_l,
                                                           tid))

        def row_l(yi):
            return off2 + (t2 * th2 + yi) * tw2

        return _bilinear(atlas.mips, row_l, u, v, hh, ww, wrap, atlas.wraps)

    lo = sample_level(l0)         # where l0 == 0 the base level stands in
    hi = sample_level(l0 + 1)
    out = torch.where((l0 == 0)[:, None], base, lo) * (1 - lfrac) + hi * lfrac
    return Spec(out.unbind(1))
