"""Spectral core (counterpart of core/spectrum.py): CIE tables, color
transforms, hero-wavelength sampling and the sigmoid-polynomial spectral
upsampling of Jakob & Hanika 2019.

The host half (the fits, the coefficient lattice and its reference-format
file I/O) is the port's own numpy copy of the JAX package's, so packed
spectrum slots and lattices are byte-equal between the two. The device
half works on planar (N,) tensors: the CIE and D65 tables are lerped at
hero wavelengths from 5 nm tables held once a device, and a slot's
coefficients are evaluated per wavelength. `diff.params.scene_with`
rebuilds a slot from a new RGB value on the device, differentiably,
through the lattice (`srgb_model_fetch_lattice`, `srgb_model_fetch_interp`).
"""
from __future__ import annotations

import os

import numpy as np
import torch

from . import cie_data as _cie

WAVELENGTH_MIN = 360.0
WAVELENGTH_MAX = 830.0
N_HERO = 4   # hero wavelengths a lane in spectral mode

_CIE_TBL = _cie.CIE_1931_TBL.astype(np.float32)          # (95, 3)
# D65 normalized to unit luminance (src/spectra/d65.cpp's convention): an
# illuminant slot of radiance (1, 1, 1) integrates to RGB (1, 1, 1)
_D65_LUM = float((_cie.D65_TBL * _cie.CIE_1931_TBL[:, 1]).sum()
                 / _cie.CIE_1931_TBL[:, 1].sum())
_D65_TBL = (_cie.D65_TBL / _D65_LUM).astype(np.float32)  # (95,)
# row k beside row k + 1: one row gather gives both ends of a lerp
_CIE_PAIR = np.concatenate(
    [_CIE_TBL, np.vstack([_CIE_TBL[1:], _CIE_TBL[-1:]])], axis=1)  # (95, 6)
_D65_PAIR = np.stack(
    [_D65_TBL, np.append(_D65_TBL[1:], _D65_TBL[-1])], axis=1)     # (95, 2)
_PAIRS = {"cie": _CIE_PAIR, "d65": _D65_PAIR}
_PAIR_ON = {}   # (name, device) -> the pair table as a tensor there


def _pair_on(name: str, device) -> torch.Tensor:
    """A pair table on `device`, uploaded once a device, outside inference
    mode so that autograd may use it."""
    key = (name, device)
    if key not in _PAIR_ON:
        with torch.inference_mode(False):
            _PAIR_ON[key] = torch.as_tensor(_PAIRS[name], device=device)
    return _PAIR_ON[key]


def _tbl_lerp_t(name: str, wl):
    """Planar lerp of pair table `name` ((M, 2K)) at (N,) wl -> K (N,)
    outputs, zero outside [CIE_MIN, CIE_MAX] (spectrum.h::cie1931_xyz)."""
    tbl = _pair_on(name, wl.device)
    t = (wl - _cie.CIE_MIN) / _cie.CIE_STEP
    i = torch.clamp(torch.floor(t), 0, _cie.CIE_COUNT - 1)
    f = torch.clamp(t - i, 0.0, 1.0)
    rows = tbl.index_select(0, i.to(torch.int64).reshape(-1)).reshape(
        wl.shape + (tbl.shape[1],))
    k = tbl.shape[1] // 2
    inside = (wl >= _cie.CIE_MIN) & (wl <= _cie.CIE_MAX)
    return tuple(torch.where(inside, rows[..., c] * (1.0 - f)
                             + rows[..., k + c] * f, 0.0)
                 for c in range(k))


def cie1931_xyz(wl):
    """CIE 1931 2-degree XYZ matching functions at wl (nm), (..., 3)."""
    return torch.stack(_tbl_lerp_t("cie", wl), -1)


def cie1931_y(wl):
    """The CIE 1931 ybar matching function at wl (nm)."""
    return _tbl_lerp_t("cie", wl)[1]


def cie1931_xyz_t(wl):
    """Planar CIE XYZ at one wavelength channel: a 3-tuple."""
    return _tbl_lerp_t("cie", wl)


# the trapezoid integral of the tabulated ybar (MTS_CIE_Y_NORMALIZATION)
CIE_Y_INTEGRAL = float(np.trapezoid(
    _cie.interp_table(_cie.CIE_1931_TBL[:, 1],
                      np.linspace(_cie.CIE_MIN, _cie.CIE_MAX, 941)),
    np.linspace(_cie.CIE_MIN, _cie.CIE_MAX, 941)))

# XYZ <-> linear sRGB (D65 white, Rec.709 primaries), the reference's
# matrices (src/libcore/spectrum.cpp)
XYZ_TO_SRGB = np.array([
    [3.240479, -1.537150, -0.498535],
    [-0.969256, 1.875991, 0.041556],
    [0.055648, -0.204043, 1.057311]], dtype=np.float32)
SRGB_TO_XYZ = np.linalg.inv(XYZ_TO_SRGB.astype(np.float64)).astype(np.float32)


def _apply_color_matrix(mat, v):
    """A 3x3 on the trailing axis, as three f32 sums of products."""
    m_ = [[float(x) for x in r] for r in mat]
    return torch.stack([
        v[..., 0] * m_[r][0] + v[..., 1] * m_[r][1] + v[..., 2] * m_[r][2]
        for r in range(3)], -1)


def xyz_to_srgb(xyz):
    return _apply_color_matrix(XYZ_TO_SRGB, xyz)


def srgb_to_xyz(rgb):
    return _apply_color_matrix(SRGB_TO_XYZ, rgb)


def luminance_rgb(rgb):
    """Luminance of a linear-sRGB color (..., 3) (mitsuba `luminance`)."""
    w = torch.tensor([0.212671, 0.715160, 0.072169], dtype=torch.float32,
                     device=rgb.device)
    return (rgb * w).sum(-1)


def luminance_t(r, g, b):
    """Planar luminance of linear sRGB channels (mono mode)."""
    return 0.212671 * r + 0.715160 * g + 0.072169 * b


def xyz_to_srgb_t(x, y, z):
    m_ = XYZ_TO_SRGB.tolist()
    return (x * m_[0][0] + y * m_[0][1] + z * m_[0][2],
            x * m_[1][0] + y * m_[1][1] + z * m_[1][2],
            x * m_[2][0] + y * m_[2][1] + z * m_[2][2])


def srgb_model_eval_t(c2, c1, c0, wl):
    """Planar sigmoid-polynomial eval: all arguments (N,)."""
    x = (c2 * wl + c1) * wl + c0
    return 0.5 + 0.5 * x / torch.sqrt(1.0 + x * x)


def srgb_model_eval(coeffs, wl):
    """R = 1/2 + x / (2 sqrt(1 + x^2)), x = c2 wl^2 + c1 wl + c0, with
    coeffs (..., 3) on the raw nm axis (srgb.cpp::srgb_model_eval)."""
    return srgb_model_eval_t(coeffs[..., 0], coeffs[..., 1], coeffs[..., 2],
                             wl)


# ---------------------------------------------------------------------------
# Hero-wavelength sampling (spectrum.h::sample_rgb_spectrum)
# ---------------------------------------------------------------------------

def srgb_model_mean(coeffs, n: int = 32):
    """Mean reflectance of (..., 3) model coefficients over the visible
    range (srgb_model_mean), at n wavelengths."""
    wl = torch.linspace(WAVELENGTH_MIN, WAVELENGTH_MAX, n,
                        dtype=torch.float32, device=coeffs.device)
    shape = coeffs.shape[:-1]
    vals = srgb_model_eval(coeffs[..., None, :], wl.expand(shape + (n,)))
    return vals.mean(-1)


def sample_rgb_spectrum(u):
    """Wavelengths importance-sampled for visible-range integration, pdf
    ~ sech^2(0.0072 (lambda - 538)), the reference's warp and constants:
    u (...) in [0, 1) -> (wavelength, pdf). f32 may land a hair outside
    the range at u -> 0 or 1: clipped."""
    wl = 538.0 - torch.atanh(0.8569106254698279
                             - 1.8275019724092267 * u) * 138.88888888888889
    wl = torch.clamp(wl, WAVELENGTH_MIN, WAVELENGTH_MAX)
    return wl, pdf_rgb_spectrum(wl)


def pdf_rgb_spectrum(wl):
    tmp = 1.0 / torch.cosh(0.0072 * (wl - 538.0))
    inside = (wl >= WAVELENGTH_MIN) & (wl <= WAVELENGTH_MAX)
    return torch.where(inside, tmp * tmp * 0.003939804229326285, 0.0)


def sample_hero_wavelengths(u):
    """One uniform sample -> N_HERO rotated hero wavelengths and their
    pdfs, (..., 4) each: the i-th from fract(u + i/4) (jnp.mod's result,
    0 at exactly 1.0)."""
    offs = torch.arange(N_HERO, dtype=u.dtype, device=u.device) / N_HERO
    return sample_rgb_spectrum(torch.remainder(u[..., None] + offs, 1.0))


def sample_hero_wavelengths_t(u):
    """Planar hero-wavelength sampling: u (N,) -> (wl Spec4, pdf Spec4)."""
    from .spec import Spec
    wls, pdfs = [], []
    for i in range(N_HERO):
        wl, pdf = sample_rgb_spectrum(torch.remainder(u + i / N_HERO, 1.0))
        wls.append(wl)
        pdfs.append(pdf)
    return Spec(tuple(wls)), Spec(tuple(pdfs))


def spectrum_to_srgb_t(values, wavelengths, pdfs):
    """Planar MC spectral -> linear sRGB: Spec4 x Spec4 x Spec4 -> Spec3."""
    from .spec import Spec
    X = Y = Z = 0.0
    for v, w, p in zip(values.ch, wavelengths.ch, pdfs.ch):
        s = v / torch.clamp_min(p, 1e-20)
        cx, cy, cz = cie1931_xyz_t(w)
        X = X + s * cx
        Y = Y + s * cy
        Z = Z + s * cz
    inv = 1.0 / (N_HERO * CIE_Y_INTEGRAL)
    return Spec(xyz_to_srgb_t(X * inv, Y * inv, Z * inv))


def spectrum_to_xyz(values, wavelengths, pdfs):
    """MC estimate of XYZ from hero samples: (..., 4) each -> (..., 3)."""
    xyz_w = cie1931_xyz(wavelengths)   # (..., 4, 3)
    contrib = (values[..., None] * xyz_w
               / torch.clamp_min(pdfs[..., None], 1e-20))
    return contrib.mean(-2) / CIE_Y_INTEGRAL


def spectrum_to_srgb(values, wavelengths, pdfs):
    return xyz_to_srgb(spectrum_to_xyz(values, wavelengths, pdfs))


# ---------------------------------------------------------------------------
# Blackbody (src/spectra/blackbody.cpp) and D65
# ---------------------------------------------------------------------------

def blackbody_radiance(wl_nm, temperature):
    """Planck's law, W/(m^2 sr nm) at wl (nm), in f32 as the JAX package
    computes it. A numpy input gives an f32 numpy result."""
    host = not torch.is_tensor(wl_nm)
    wl = torch.as_tensor(np.asarray(wl_nm, np.float32) if host else wl_nm,
                         dtype=torch.float32)
    h, c, kb = 6.62607015e-34, 2.99792458e8, 1.380649e-23
    lam = wl * 1e-9
    val = (2.0 * h * c * c) / (lam ** 5 * (torch.exp(
        (h * c / kb) / (lam * temperature)) - 1.0)) * 1e-9
    return val.numpy() if host else val


def d65_approx(wl):
    """CIE D65, the 5 nm table at unit luminance (the JAX package's name)."""
    return _tbl_lerp_t("d65", wl)[0]


# ---------------------------------------------------------------------------
# Host fits (numpy, f64)
# ---------------------------------------------------------------------------

_FIT_WL = np.linspace(WAVELENGTH_MIN, WAVELENGTH_MAX, 95)
_XYZ_W = (_cie.interp_table(_cie.CIE_1931_TBL, _FIT_WL)
          * (_cie.interp_table(_cie.D65_TBL, _FIT_WL) / _D65_LUM)[:, None])
_XYZ_W = _XYZ_W / np.trapezoid(_XYZ_W[:, 1], _FIT_WL)
_PROJ = (np.asarray(XYZ_TO_SRGB, np.float64) @
         (_XYZ_W.T * np.gradient(_FIT_WL)))  # (3, 95): rgb = PROJ @ R(wl)


def _to_raw(a, b, c):
    """Coefficients on the normalized axis (wl - 560) / 100 -> raw nm."""
    return (a / 100.0 ** 2, b / 100.0 - 2 * a * 560.0 / 100.0 ** 2,
            a * (560.0 / 100.0) ** 2 - b * 560.0 / 100.0 + c)


def fit_srgb_model(rgb, iters: int = 50):
    """Gauss–Newton fit of sigmoid-polynomial coefficients to one linear
    sRGB color; returns (coeffs (3,) on the raw wavelength axis, scale)."""
    rgb = np.asarray(rgb, np.float64)
    scale = 1.0
    mx = rgb.max()
    if mx > 0.999:
        scale = mx / 0.999
        rgb = rgb / scale
    lum = float(rgb @ np.array([0.2126, 0.7152, 0.0722]))
    lum = min(max(lum, 1e-4), 0.9999)
    x0 = np.arctanh(2.0 * lum - 1.0)
    wlc = (_FIT_WL - 560.0) / 100.0
    coeffs = np.array([0.0, 0.0, x0])

    def model(cf):
        x = (cf[0] * wlc + cf[1]) * wlc + cf[2]
        return 0.5 + 0.5 * x / np.sqrt(1.0 + x * x)

    for _ in range(iters):
        f = _PROJ @ model(coeffs) - rgb
        if np.abs(f).max() < 1e-7:
            break
        x = (coeffs[0] * wlc + coeffs[1]) * wlc + coeffs[2]
        dr_dx = 0.5 / np.power(1.0 + x * x, 1.5)
        J = _PROJ @ (dr_dx[:, None] * np.stack(
            [wlc * wlc, wlc, np.ones_like(wlc)], axis=-1))
        try:
            step = np.linalg.solve(J + 1e-12 * np.eye(3), f)
        except np.linalg.LinAlgError:
            break
        coeffs = coeffs - step
    return np.array(_to_raw(*coeffs), np.float64), scale


def fit_srgb_model_to_spectrum(wl, values, iters: int = 80):
    """Fit the coefficients to a tabulated spectrum directly (the data of
    src/spectra/{regular,irregular}.cpp, smoothed into the model): wl (K,)
    nm ascending, values (K,) >= 0 -> (coeffs (3,), scale)."""
    wl = np.asarray(wl, np.float64)
    values = np.asarray(values, np.float64)
    v = np.interp(_FIT_WL, wl, values, left=values[0], right=values[-1])
    scale = max(float(v.max()), 1e-9)
    target = np.clip(v / scale, 0.0, 0.9999)
    wlc = (_FIT_WL - 560.0) / 100.0
    lum = float(np.clip(target.mean(), 1e-4, 0.9999))
    coeffs = np.array([0.0, 0.0, np.arctanh(2.0 * lum - 1.0)])

    def model(cf):
        x = (cf[0] * wlc + cf[1]) * wlc + cf[2]
        return 0.5 + 0.5 * x / np.sqrt(1.0 + x * x)

    for _ in range(iters):
        f = model(coeffs) - target
        x = (coeffs[0] * wlc + coeffs[1]) * wlc + coeffs[2]
        dr_dx = 0.5 / np.power(1.0 + x * x, 1.5)
        J = dr_dx[:, None] * np.stack([wlc * wlc, wlc,
                                       np.ones_like(wlc)], axis=-1)
        JtJ = J.T @ J + 1e-9 * np.eye(3)
        step = np.linalg.solve(JtJ, J.T @ f)
        coeffs = coeffs - step
        if np.abs(step).max() < 1e-10:
            break
    return np.array(_to_raw(*coeffs), np.float64), scale


def spectrum_to_rgb_host(wl, values):
    """The exact CIE projection of a tabulated spectrum -> linear sRGB
    (reflectance convention: flat 1.0 maps to white)."""
    wl = np.asarray(wl, np.float64)
    v = np.interp(_FIT_WL, wl, np.asarray(values, np.float64),
                  left=values[0], right=values[-1])
    return _PROJ @ v


def _norm_to_raw(cf):
    return np.stack(_to_raw(cf[:, 0], cf[:, 1], cf[:, 2]), axis=-1)


def _fit_srgb_batch_norm(rgbs, iters: int = 60, init=None):
    """Damped batched Gauss–Newton on the normalized wavelength axis, a
    4-halving backtracking line search keeping each residual monotone;
    `init` chains from an adjacent converged solve (rgb2spec's slice
    propagation). Returns cf (N, 3), normalized axis."""
    rgbs = np.asarray(rgbs, np.float64)
    N = rgbs.shape[0]
    wlc = (_FIT_WL - 560.0) / 100.0
    basis = np.stack([wlc * wlc, wlc, np.ones_like(wlc)], axis=-1)  # (95,3)

    def resid(cf):
        x = (cf[:, 0:1] * wlc + cf[:, 1:2]) * wlc + cf[:, 2:3]   # (N, 95)
        r = 0.5 + 0.5 * x / np.sqrt(1.0 + x * x)
        return x, r @ _PROJ.T - rgbs

    if init is None:
        lum = np.clip(rgbs @ np.array([0.2126, 0.7152, 0.0722]),
                      1e-4, 0.9999)
        cf = np.zeros((N, 3))
        cf[:, 2] = np.arctanh(2.0 * lum - 1.0)
    else:
        cf = np.array(init, np.float64, copy=True)
    eye = 1e-10 * np.eye(3)
    x, f = resid(cf)
    cost = (f * f).sum(axis=1)
    for _ in range(iters):
        if np.sqrt(cost.max()) < 1e-10:
            break
        dr_dx = 0.5 / np.power(1.0 + x * x, 1.5)                  # (N, 95)
        J = np.einsum("pw,nw,wc->npc", _PROJ, dr_dx, basis)
        try:
            step = np.linalg.solve(J + eye, f[..., None])[..., 0]
        except np.linalg.LinAlgError:
            step = np.linalg.solve(J + 1e-5 * np.eye(3),
                                   f[..., None])[..., 0]
        best_cf, best_cost = cf, cost
        accepted = np.zeros(N, bool)
        for _h in range(4):
            cf_try = cf - step
            _, f_try = resid(cf_try)
            cost_try = (f_try * f_try).sum(axis=1)
            better = (cost_try < best_cost) & ~accepted
            best_cf = np.where(better[:, None], cf_try, best_cf)
            best_cost = np.where(better, cost_try, best_cost)
            accepted |= better
            step = step * 0.5
        cf = best_cf
        x, f = resid(cf)
        cost = (f * f).sum(axis=1)
    return cf


def fit_srgb_model_batch(rgbs, iters: int = 60, init_norm=None):
    """fit_srgb_model over (N, 3) colors at once (host, f64): (coeffs (N,
    3) raw-axis, scales (N,))."""
    rgbs = np.asarray(rgbs, np.float64)
    mx = rgbs.max(axis=1)
    scales = np.where(mx > 0.999, mx / 0.999, 1.0)
    cf = _fit_srgb_batch_norm(rgbs / scales[:, None], iters, init_norm)
    return _norm_to_raw(cf), scales


# ---------------------------------------------------------------------------
# The RGB -> coefficient lattice (rgb2spec's max-channel parameterization)
# ---------------------------------------------------------------------------

LATTICE_RES = 64      # the committed table's resolution (data/srgb_coeff_64.npz)
_LATTICE_CACHE = {}   # res -> host lattice
_LATTICE_ON = {}      # device -> [(host lattice, its tensor there)]
_ACTIVE_EXTERNAL = None   # (lattice, z nodes) of an active .coeff file


def load_rgb2spec_coeff(path):
    """A binary rgb2spec table in the reference's own format
    (resources/data/srgb.coeff; rgb2spec.h::rgb2spec_load): b'SPEC', a
    little-endian uint32 res, f32 scale[res] (the z nodes), then f32
    data[3 * res^3 * 3] indexed [max channel][z][y][x][c2 c1 c0]. Returns
    (lattice (3, res, res, res, 3) f32, z nodes (res,) f64)."""
    with open(path, "rb") as f:
        magic = f.read(4)
        if magic != b"SPEC":
            raise ValueError(f"{path}: bad rgb2spec magic {magic!r} "
                             "(expected b'SPEC')")
        hdr = f.read(4)
        if len(hdr) != 4:
            raise ValueError(f"{path}: truncated header")
        res = int(np.frombuffer(hdr, "<u4")[0])
        if not (2 <= res <= 4096):
            raise ValueError(f"{path}: implausible resolution {res}")
        zn = np.frombuffer(f.read(4 * res), "<f4")
        if zn.size != res:
            raise ValueError(f"{path}: truncated scale array")
        if not (np.all(np.diff(zn) > 0) and zn[0] >= 0.0
                and zn[-1] <= 1.0 + 1e-6):
            raise ValueError(f"{path}: scale array not ascending in [0,1]")
        n = 3 * res * res * res * 3
        data = np.frombuffer(f.read(4 * n), "<f4")
        if data.size != n:
            raise ValueError(f"{path}: truncated data "
                             f"({data.size} of {n} floats)")
    lattice = np.ascontiguousarray(
        data.reshape(3, res, res, res, 3), np.float32)
    return lattice, zn.astype(np.float64)


def save_rgb2spec_coeff(path, lattice, z_nodes=None):
    """Write a lattice in the reference's binary .coeff format
    (load_rgb2spec_coeff's)."""
    lattice = np.asarray(lattice, np.float32)
    assert lattice.ndim == 5 and lattice.shape[0] == 3 \
        and lattice.shape[4] == 3, lattice.shape
    res = lattice.shape[1]
    assert lattice.shape[1:4] == (res, res, res), lattice.shape
    zn = _z_nodes(res) if z_nodes is None else np.asarray(z_nodes)
    assert zn.shape == (res,), zn.shape
    with open(path, "wb") as f:
        f.write(b"SPEC")
        f.write(np.asarray([res], "<u4").tobytes())
        f.write(zn.astype("<f4").tobytes())
        f.write(np.ascontiguousarray(lattice, "<f4").tobytes())


def use_rgb2spec_coeff(path):
    """Activate an external .coeff table: srgb_model_fetch_lattice()
    returns it from now on, and the fetch uses its own z nodes."""
    global _ACTIVE_EXTERNAL
    _ACTIVE_EXTERNAL = load_rgb2spec_coeff(path)
    _LATTICE_CACHE.clear()
    return _ACTIVE_EXTERNAL[0]


def _z_nodes(res: int):
    """Nonuniform z (max-channel value) lattice nodes: a double smoothstep
    (ext/rgb2spec's scale array)."""
    t = np.linspace(0.0, 1.0, res)
    s = t * t * (3.0 - 2.0 * t)
    return (s * s * (3.0 - 2.0 * s)).astype(np.float64)


def srgb_model_fetch_lattice(res: int = LATTICE_RES) -> np.ndarray:
    """The (3, res, res, res, 3) f32 coefficient lattice indexed [max
    channel k][z node][y][x][coeff]. The committed tables
    (data/srgb_coeff_{64,32}.npz, the JAX package's bytes) load, other
    resolutions are fitted (_build_srgb_lattice), and an external
    reference-format table (MI_SRGB_COEFF=<path>, the JAX package's name,
    or use_rgb2spec_coeff) replaces the default."""
    env = os.environ.get("MI_SRGB_COEFF")
    if env and _ACTIVE_EXTERNAL is None:
        use_rgb2spec_coeff(env)
    if res == LATTICE_RES and _ACTIVE_EXTERNAL is not None:
        return _ACTIVE_EXTERNAL[0]
    if res not in _LATTICE_CACHE:
        path = os.path.join(os.path.dirname(os.path.dirname(
            os.path.abspath(__file__))), "data", f"srgb_coeff_{res}.npz")
        if os.path.exists(path):
            out = np.load(path)["coeffs"].astype(np.float32)
            assert out.shape == (3, res, res, res, 3), out.shape
        else:
            out = _build_srgb_lattice(res)
        _LATTICE_CACHE[res] = out
    return _LATTICE_CACHE[res]


def _build_srgb_lattice(res: int):
    """Fit the (3, res, res, res, 3) lattice, z slices middle-out, each
    seeded from its converged neighbour (rgb2spec's propagation)."""
    zn = _z_nodes(res)
    grid = np.linspace(0.0, 1.0, res)
    yv, xv = np.meshgrid(grid, grid, indexing="ij")    # (iy, ix)
    out = np.zeros((3, res, res, res, 3), np.float32)
    mid = res // 2
    order = [mid]
    for d in range(1, res):
        if mid + d < res:
            order.append(mid + d)
        if mid - d >= 0:
            order.append(mid - d)
    for k in range(3):
        norm_cache = {}
        for iz in order:
            z = zn[iz]
            rgb = np.zeros((res, res, 3), np.float64)
            rgb[..., k] = z
            rgb[..., (k + 1) % 3] = xv * z
            rgb[..., (k + 2) % 3] = yv * z
            seed_iz = iz + 1 if iz < mid else iz - 1
            init = norm_cache.get(seed_iz)
            mx = rgb.reshape(-1, 3).max(axis=1)
            scales = np.where(mx > 0.999, mx / 0.999, 1.0)
            cf = _fit_srgb_batch_norm(rgb.reshape(-1, 3) / scales[:, None],
                                      iters=60, init=init)
            norm_cache[iz] = cf
            out[k, iz] = _norm_to_raw(cf).reshape(res, res, 3) \
                .astype(np.float32)
    return out


def _lattice_on(lattice, device) -> torch.Tensor:
    """`lattice` as a tensor on `device`, uploaded once a device and host
    array (held beside it, so the identity test cannot alias), outside
    inference mode so that autograd may use it."""
    held = _LATTICE_ON.setdefault(device, [])
    for host, tensor in held:
        if host is lattice:
            return tensor
    with torch.inference_mode(False):
        tensor = torch.as_tensor(np.array(lattice), device=device)
    held.append((lattice, tensor))
    return tensor


def _max(x, c: float):
    """jnp.maximum(x, c): half the derivative to each side of a tie, as
    torch.maximum gives it (torch.clamp would give all of it)."""
    return torch.maximum(x, torch.tensor(c, dtype=x.dtype, device=x.device))


def _clip(x, lo: float, hi: float):
    """jnp.clip(x, lo, hi), with its derivative at the bounds."""
    return torch.minimum(_max(x, lo),
                         torch.tensor(hi, dtype=x.dtype, device=x.device))


def srgb_model_fetch_interp_t(lattice, r, g, b):
    """Planar trilinear coefficient fetch: (N,) rgb channels -> (c2, c1,
    c0) each (N,), differentiable in the channels. The lattice is sliced
    by the max channel k, z = that channel's value on the z-node scale
    (an active external table's own when its depth matches), (x, y) = the
    other two channels divided by it."""
    lat = _lattice_on(lattice, r.device)
    ZR, R = lat.shape[1], lat.shape[2]
    mx = torch.maximum(torch.maximum(r, g), b)
    k = torch.where(r >= torch.maximum(g, b), 0,
                    torch.where(g >= b, 1, 2))
    mxc = _max(mx, 1e-9)
    x = torch.where(k == 0, g, torch.where(k == 1, b, r)) / mxc
    y = torch.where(k == 0, b, torch.where(k == 1, r, g)) / mxc
    z = _clip(mx, 0.0, 1.0)

    nodes = (_ACTIVE_EXTERNAL[1] if _ACTIVE_EXTERNAL is not None
             and _ACTIVE_EXTERNAL[1].shape[0] == ZR else _z_nodes(ZR))
    zn = torch.as_tensor(nodes, dtype=torch.float32, device=r.device)
    iz = torch.clamp((z[..., None] >= zn).sum(-1) - 1, 0, ZR - 2)
    z_lo, z_hi = zn[iz], zn[iz + 1]
    fz = _clip((z - z_lo) / _max(z_hi - z_lo, 1e-12), 0.0, 1.0)

    tx = _clip(x, 0.0, 1.0) * (R - 1)
    ty = _clip(y, 0.0, 1.0) * (R - 1)
    ix = torch.clamp(torch.floor(tx).to(torch.int64), 0, R - 2)
    iy = torch.clamp(torch.floor(ty).to(torch.int64), 0, R - 2)
    fx, fy = tx - ix, ty - iy

    flat = lat.reshape(3 * ZR * R * R, 3)
    out = []
    for c in range(3):
        col = flat[:, c]
        acc = 0.0
        for dz in (0, 1):
            wz = fz if dz else (1.0 - fz)
            for dy in (0, 1):
                wy = fy if dy else (1.0 - fy)
                for dx in (0, 1):
                    wx = fx if dx else (1.0 - fx)
                    idx = ((k * ZR + iz + dz) * R + iy + dy) * R + ix + dx
                    acc = acc + col[idx] * (wz * wy * wx)
        out.append(acc)
    return out[0], out[1], out[2]


def srgb_model_fetch_interp(lattice, rgb):
    """(..., 3) rgb in [0, 1]^3 -> (..., 3) coefficients (c2, c1, c0)."""
    shape = rgb.shape[:-1]
    r, g, b = (rgb[..., i].reshape(-1) for i in range(3))
    c2, c1, c0 = srgb_model_fetch_interp_t(lattice, r, g, b)
    return torch.stack([c2, c1, c0], -1).reshape(shape + (3,))
