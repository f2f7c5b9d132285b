"""RGL `.bsdf` (Dupuy-Jakob) measured-material loader (counterpart of
render/rgl.py, a copy the port owns: numpy only, its spectral branch
through the port's core/cie_data.py and core/spectrum.py, so that one
file gives a byte-equal table in both packages).

The reference's `measured` plugin streams captures from the RGL material
database (src/bsdfs/measured.cpp; Dupuy & Jakob 2018, "An Adaptive
Parameterization for Efficient Material Acquisition and Rendering",
distributed as `powitacq`): a `tensor_file` container holding the
VNDF-parameterized tensors

    theta_i (n_ti,)                incident elevations of the slices
    phi_i   (n_phi,)              incident azimuths (1 for isotropic)
    ndf     (res, res)            microfacet NDF over the warped square
    sigma   (res, res)            projected-area normalization sigma(wi)
    vndf    (n_ti, n_phi, r, r)   visible-NDF warp per incident slice
    rgb     (n_ti, n_phi, 3, r2, r2)   residual reflectance in warp coords
    (or `spectra` + `wavelengths` for spectral captures)

and evaluated as  fr(wi, wo) = rgb(u1, u2) * ndf(u_wm) / (4 * sigma(u_wi))
where (u1, u2) is the INVERSE of the per-slice VNDF sampling warp at the
half vector wm (powitacq.inl::eval).

The container is parsed and fr reconstructed on the host, then RESAMPLED
onto the renderer's (theta_i, theta_o, phi_d) grid, the table layout of
render/measured.py. The elevation warp is u = sqrt(2 theta / pi)
(powitacq theta2u); the azimuth's u = phi / (2 pi) + 0.5. `write_rgl_ggx`
bakes a synthetic GGX capture through the FORWARD warp: the tests'
fixture, and the documentation of the pipeline the loader inverts.
"""
from __future__ import annotations

import struct
from typing import Dict, Tuple

import numpy as np

# --- tensor_file container --------------------------------------------------

_MAGIC = b"tensor_file\x00"
_DTYPES = {1: np.uint8, 2: np.int8, 3: np.uint16, 4: np.int16,
           5: np.uint32, 6: np.int32, 7: np.uint64, 8: np.int64,
           9: np.float16, 10: np.float32, 11: np.float64}
_DTYPE_IDS = {np.dtype(v): k for k, v in _DTYPES.items()}


def read_tensor_file(path: str) -> Dict[str, np.ndarray]:
    """Parse a powitacq `tensor_file` container -> {name: array}."""
    buf = open(path, "rb").read()
    if buf[:12] != _MAGIC:
        raise ValueError(f"{path}: not a tensor_file (bad magic)")
    ver_major, ver_minor = buf[12], buf[13]
    if ver_major != 1:
        raise ValueError(f"unsupported tensor_file version {ver_major}")
    (n_fields,) = struct.unpack_from("<I", buf, 14)
    pos = 18
    fields = {}
    for _ in range(n_fields):
        (name_len,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        name = buf[pos:pos + name_len].decode()
        pos += name_len
        (ndim,) = struct.unpack_from("<H", buf, pos)
        pos += 2
        dtype_id = buf[pos]
        pos += 1
        (offset,) = struct.unpack_from("<Q", buf, pos)
        pos += 8
        shape = struct.unpack_from(f"<{ndim}Q", buf, pos)
        pos += 8 * ndim
        dt = _DTYPES[dtype_id]
        count = int(np.prod(shape)) if shape else 1
        arr = np.frombuffer(buf, dt, count=count, offset=offset)
        fields[name] = arr.reshape(shape).copy()
    return fields


def write_tensor_file(path: str, fields: Dict[str, np.ndarray]) -> None:
    """Write a powitacq-layout tensor_file (test fixture / export path)."""
    header = bytearray()
    header += _MAGIC + bytes([1, 0])
    header += struct.pack("<I", len(fields))
    recs = []
    for name, arr in fields.items():
        arr = np.ascontiguousarray(arr)
        recs.append((name.encode(), arr))
    # first pass to size the header
    fixed = len(header)
    for name_b, arr in recs:
        fixed += 2 + len(name_b) + 2 + 1 + 8 + 8 * arr.ndim
    offset = fixed
    body = bytearray()
    for name_b, arr in recs:
        header += struct.pack("<H", len(name_b)) + name_b
        header += struct.pack("<H", arr.ndim)
        header += bytes([_DTYPE_IDS[arr.dtype]])
        header += struct.pack("<Q", offset)
        header += struct.pack(f"<{arr.ndim}Q", *arr.shape)
        body += arr.tobytes()
        offset += arr.nbytes
    with open(path, "wb") as f:
        f.write(bytes(header) + bytes(body))


# --- warp helpers (powitacq.inl conventions) --------------------------------

def theta2u(theta):
    return np.sqrt(np.asarray(theta) * (2.0 / np.pi))


def u2theta(u):
    return np.square(np.asarray(u)) * (np.pi / 2.0)


def phi2u(phi):
    return np.asarray(phi) * (0.5 / np.pi) + 0.5


def u2phi(u):
    return (np.asarray(u) - 0.5) * (2.0 * np.pi)


def _bilinear(grid: np.ndarray, u: np.ndarray, v: np.ndarray) -> np.ndarray:
    """Sample grid[(v_rows, u_cols)] bilinearly at unit coords (u, v)
    (cell-centered). grid: (..., H, W); u/v broadcastable arrays."""
    H, W = grid.shape[-2], grid.shape[-1]
    x = np.clip(u * W - 0.5, 0.0, W - 1.0)
    y = np.clip(v * H - 0.5, 0.0, H - 1.0)
    x0 = np.clip(np.floor(x).astype(int), 0, W - 2) if W > 1 else np.zeros_like(x, int)
    y0 = np.clip(np.floor(y).astype(int), 0, H - 2) if H > 1 else np.zeros_like(y, int)
    fx, fy = x - x0, y - y0
    c00 = grid[..., y0, x0]
    c01 = grid[..., y0, np.minimum(x0 + 1, W - 1)]
    c10 = grid[..., np.minimum(y0 + 1, H - 1), x0]
    c11 = grid[..., np.minimum(y0 + 1, H - 1), np.minimum(x0 + 1, W - 1)]
    return ((c00 * (1 - fx) + c01 * fx) * (1 - fy) +
            (c10 * (1 - fx) + c11 * fx) * fy)


class _Marginal2D:
    """Host Marginal2D over a density grid (rows = v, cols = u): sample
    (u1,u2)->(u,v) by conditional CDF inversion, and the INVERSE map
    (u,v)->(u1,u2) — the warp the RGL eval chain runs through
    (distr_2d.h::Marginal2D, host numpy edition)."""

    def __init__(self, density: np.ndarray):
        d = np.maximum(np.asarray(density, np.float64), 0.0) + 1e-18
        self.d = d
        H, W = d.shape
        # row marginal (integrate over u)
        row = d.mean(axis=1)
        self.row_cdf = np.cumsum(row)
        self.row_cdf /= self.row_cdf[-1]
        cond = np.cumsum(d, axis=1)
        self.cond_cdf = cond / cond[:, -1:]

    def invert(self, u: np.ndarray, v: np.ndarray):
        """(u, v) in the unit square -> the (u1, u2) that sample() maps
        there. Piecewise-constant cell model (adequate for resampling)."""
        H, W = self.d.shape
        yi = np.clip((v * H).astype(int), 0, H - 1)
        # u2: position of v inside the row CDF
        lo = np.where(yi > 0, self.row_cdf[yi - 1], 0.0)
        hi = self.row_cdf[yi]
        frac_v = v * H - yi
        u2 = lo + (hi - lo) * frac_v
        xi = np.clip((u * W).astype(int), 0, W - 1)
        clo = np.where(xi > 0, self.cond_cdf[yi, np.maximum(xi - 1, 0)], 0.0)
        chi = self.cond_cdf[yi, xi]
        frac_u = u * W - xi
        u1 = clo + (chi - clo) * frac_u
        return u1, u2

    def sample(self, u1: np.ndarray, u2: np.ndarray):
        """Inverse of invert: (u1,u2) -> (u, v)."""
        H, W = self.d.shape
        yi = np.searchsorted(self.row_cdf, u2)
        yi = np.clip(yi, 0, H - 1)
        lo = np.where(yi > 0, self.row_cdf[yi - 1], 0.0)
        hi = self.row_cdf[yi]
        v = (yi + (u2 - lo) / np.maximum(hi - lo, 1e-18)) / H
        cc = self.cond_cdf[yi]
        xi = np.empty_like(yi)
        for i in np.ndindex(u1.shape):  # small host grids only
            xi[i] = np.searchsorted(cc[i], u1[i])
        xi = np.clip(xi, 0, W - 1)
        clo = np.where(xi > 0, self.cond_cdf[yi, np.maximum(xi - 1, 0)], 0.0)
        chi = self.cond_cdf[yi, xi]
        u = (xi + (u1 - clo) / np.maximum(chi - clo, 1e-18)) / W
        return u, np.clip(v, 0.0, 1.0)


# --- RGL eval chain + resampling -------------------------------------------

class RGLMaterial:
    """Host-side evaluator of a parsed RGL capture (isotropic)."""

    def __init__(self, fields: Dict[str, np.ndarray]):
        self.theta_i = np.asarray(fields["theta_i"], np.float64).ravel()
        self.ndf = np.asarray(fields["ndf"], np.float64)
        self.sigma = np.asarray(fields["sigma"], np.float64)
        vndf = np.asarray(fields["vndf"], np.float64)
        rgb = np.asarray(fields.get("rgb"), np.float64) if "rgb" in fields \
            else None
        if rgb is None:
            # spectral capture: integrate to rgb with the CIE tables
            spectra = np.asarray(fields["spectra"], np.float64)
            wav = np.asarray(fields["wavelengths"], np.float64).ravel()
            from ..core import cie_data as cie
            from ..core import spectrum as sp
            xyz_w = cie.interp_table(cie.CIE_1931_TBL, wav)       # (n_wl, 3)
            d65 = cie.interp_table(cie.D65_TBL, wav) / 100.0
            w = xyz_w * d65[:, None]
            w /= np.trapezoid(w[:, 1], wav)
            dl = np.gradient(wav)
            xyz = np.einsum("tpwyx,wc,w->tpcyx", spectra, w, dl)
            rgb = np.einsum("cd,tpdyx->tpcyx",
                            np.asarray(sp.XYZ_TO_SRGB, np.float64), xyz)
        # collapse the phi_i axis (isotropic captures have n_phi == 1)
        self.vndf = vndf[:, 0] if vndf.ndim == 4 else vndf
        self.rgb = rgb[:, 0] if rgb.ndim == 5 else rgb
        self.vndf_warps = [_Marginal2D(v) for v in self.vndf]

    def _slice_eval(self, ti_idx: int, theta_i, theta_o, phi_d):
        """fr (RGB) of one incident slice on a (theta_o, phi_d) grid."""
        # local directions (phi_i = 0 frame)
        st_i, ct_i = np.sin(theta_i), np.cos(theta_i)
        wi = np.array([st_i, 0.0, ct_i])
        st_o, ct_o = np.sin(theta_o), np.cos(theta_o)
        wo = np.stack([st_o * np.cos(phi_d), st_o * np.sin(phi_d), ct_o], -1)
        wm = wo + wi
        wm /= np.maximum(np.linalg.norm(wm, axis=-1, keepdims=True), 1e-12)
        theta_m = np.arccos(np.clip(wm[..., 2], -1, 1))
        phi_m = np.arctan2(wm[..., 1], wm[..., 0])

        u_wm = (phi2u(phi_m), theta2u(theta_m))          # (u, v) coords
        u1, u2 = self.vndf_warps[ti_idx].invert(u_wm[0], u_wm[1])
        u1 = np.clip(u1, 0.0, 1.0)
        u2 = np.clip(u2, 0.0, 1.0)

        ndf_v = _bilinear(self.ndf, u_wm[0], u_wm[1])
        u_wi = (phi2u(0.0), theta2u(theta_i))
        sigma_v = _bilinear(self.sigma, np.full_like(u1, u_wi[0]),
                            np.full_like(u1, u_wi[1]))
        rgb_v = np.stack([_bilinear(self.rgb[ti_idx, c], u1, u2)
                          for c in range(3)], -1)
        fr = rgb_v * (ndf_v / np.maximum(4.0 * sigma_v, 1e-12))[..., None]
        return np.maximum(fr, 0.0)

    def resample(self, n_ti=32, n_to=64, n_phi=64) -> np.ndarray:
        """Reconstruct f*cos on the renderer's native grid
        (render/measured.py layout)."""
        ti = (np.arange(n_ti) + 0.5) / n_ti * (np.pi / 2)
        to = (np.arange(n_to) + 0.5) / n_to * (np.pi / 2)
        ph = (np.arange(n_phi) + 0.5) / n_phi * (2 * np.pi)
        TO, PH = np.meshgrid(to, ph, indexing="ij")
        out = np.zeros((n_ti, n_to, n_phi, 3), np.float32)
        for k, t in enumerate(ti):
            # interpolate between the two neighboring captured slices
            j = np.searchsorted(self.theta_i, t)
            j0 = np.clip(j - 1, 0, len(self.theta_i) - 1)
            j1 = np.clip(j, 0, len(self.theta_i) - 1)
            if j1 == j0:
                w1 = 0.0
            else:
                w1 = ((t - self.theta_i[j0]) /
                      (self.theta_i[j1] - self.theta_i[j0]))
            fr = self._slice_eval(j0, t, TO, PH)
            if w1 > 0:
                fr = fr * (1 - w1) + self._slice_eval(j1, t, TO, PH) * w1
            out[k] = (fr * np.cos(TO)[..., None]).astype(np.float32)
        return out


def load_rgl(path: str, n_ti=32, n_to=64, n_phi=64) -> np.ndarray:
    """RGL .bsdf file -> native measured table (n_ti, n_to, n_phi, 3)."""
    return RGLMaterial(read_tensor_file(path)).resample(n_ti, n_to, n_phi)


# --- synthetic capture baker (test fixture + documentation of the forward
#     pipeline the loader inverts) ------------------------------------------

def write_rgl_ggx(path: str, alpha: float, rgb_tint=(0.9, 0.7, 0.4),
                  n_ti=16, res=64, res2=64, spectral=None) -> None:
    """Bake a synthetic isotropic GGX rough-conductor capture in RGL
    layout: ndf/sigma/vndf from GGX closed forms on the warped grids, and
    the rgb tensor holding fr * 4 sigma / ndf evaluated at the FORWARD
    vndf-warped sample positions — the residual the real pipeline stores.
    Loading it back reconstructs the analytic model.

    spectral=(wavelengths_nm, S): write a SPECTRAL capture instead —
    `spectra` (n_ti, 1, n_wav, res2, res2) with per-texel SPD
    residual * S(lambda) plus a `wavelengths` field, exercising
    measured.cpp's spectral branch. Also emits the aux fields real RGL
    database files carry (description/jacobian/valid/luminance) in
    name-shuffled header order, so the loader proves it keys on field
    NAMES and skips unknown entries."""
    a2 = alpha * alpha
    resids = []

    def D(theta_m):
        c = np.cos(theta_m)
        c2 = np.clip(c * c, 0.0, 1.0)
        denom = np.pi * (c2 * (a2 - 1.0) + 1.0) ** 2
        return np.where(c > 0, a2 / np.maximum(denom, 1e-18), 0.0)

    def smith_lambda(theta):
        t = np.tan(np.clip(theta, 0, np.pi / 2 - 1e-6))
        return 0.5 * (np.sqrt(1.0 + a2 * t * t) - 1.0)

    def sigma_fn(theta_i):
        # projected area of visible microfacets = cos(theta) (1 + Lambda)
        return np.cos(theta_i) * (1.0 + smith_lambda(theta_i))

    # grids in warped unit coords (rows = v = elevation, cols = u = azimuth)
    v_grid = (np.arange(res) + 0.5) / res
    u_grid = (np.arange(res) + 0.5) / res
    TH = u2theta(v_grid)                      # (res,)
    ndf = np.broadcast_to(D(TH)[:, None], (res, res)).copy()
    sigma = np.broadcast_to(sigma_fn(TH)[:, None], (res, res)).copy()

    theta_i = u2theta((np.arange(n_ti) + 0.5) / n_ti)
    vndf = np.zeros((n_ti, 1, res, res))
    PH = u2phi(u_grid)                        # (res,)
    for k, ti in enumerate(theta_i):
        wi = np.array([np.sin(ti), 0.0, np.cos(ti)])
        st, ct = np.sin(TH)[:, None], np.cos(TH)[:, None]
        wm = np.stack([st * np.cos(PH)[None, :], st * np.sin(PH)[None, :],
                       np.broadcast_to(ct, (res, res))], -1)
        cos_im = np.maximum(wm @ wi, 0.0)
        dvis = D(TH)[:, None] * cos_im / np.maximum(sigma_fn(ti), 1e-12)
        # density over the WARPED square: include the (theta, phi)->(u, v)
        # Jacobian sin(theta) dtheta/dv dphi/du
        dth_dv = np.pi * theta2u(TH)          # d(u^2 pi/2)/du = pi u
        vndf[k, 0] = dvis * st * dth_dv[:, None] * (2.0 * np.pi)

    # rgb residual tensor on the (u1, u2) sample grid, via the FORWARD warp
    tint = np.asarray(rgb_tint)
    rgb = np.zeros((n_ti, 1, 3, res2, res2))
    U1 = np.broadcast_to((np.arange(res2) + 0.5) / res2, (res2, res2))
    U2 = U1.T.copy()
    for k, ti in enumerate(theta_i):
        warp = _Marginal2D(vndf[k, 0])
        u, v = warp.sample(U1, U2)            # unit coords of wm
        th_m, ph_m = u2theta(v), u2phi(u)
        st, ct = np.sin(th_m), np.cos(th_m)
        wm = np.stack([st * np.cos(ph_m), st * np.sin(ph_m), ct], -1)
        wi = np.array([np.sin(ti), 0.0, np.cos(ti)])
        wo = 2.0 * (wm @ wi)[..., None] * wm - wi
        cos_o = wo[..., 2]
        # analytic GGX rough conductor (fresnel folded into the tint)
        lam_i = smith_lambda(ti)
        lam_o = smith_lambda(np.arccos(np.clip(cos_o, 1e-6, 1.0)))
        G = 1.0 / (1.0 + lam_i + lam_o)
        fr = (D(th_m) * G /
              np.maximum(4.0 * np.cos(ti) * np.maximum(cos_o, 1e-6), 1e-9))
        fr = np.where(cos_o > 0, fr, 0.0)
        resid = fr * 4.0 * sigma_fn(ti) / np.maximum(D(th_m), 1e-12)
        for c in range(3):
            rgb[k, 0, c] = resid * tint[c]
        resids.append(resid)

    fields = {
        "theta_i": theta_i.astype(np.float32),
        "phi_i": np.zeros(1, np.float32),
        "ndf": ndf.astype(np.float32),
        "sigma": sigma.astype(np.float32),
        "vndf": vndf.astype(np.float32),
        "description": np.frombuffer(b"synthetic ggx", np.uint8).copy(),
        # aux fields real RGL database files carry (powitacq reads past
        # them; our loader must too): emulate the full field census
        "jacobian": np.ones(1, np.uint8),
        "valid": np.ones((res, res), np.uint8),
        "luminance": rgb.mean(axis=2).astype(np.float32),
    }
    if spectral is None:
        fields["rgb"] = rgb.astype(np.float32)
    else:
        # spectral capture variant (the `spectra` + `wavelengths` branch
        # of measured.cpp): per-texel SPD = residual * S(lambda)
        wav, S = (np.asarray(a, np.float64) for a in spectral)
        spectra = np.zeros((n_ti, 1, wav.size, res2, res2), np.float32)
        for k in range(n_ti):
            spectra[k, 0] = (resids[k][None] * S[:, None, None]
                             ).astype(np.float32)
        fields["spectra"] = spectra
        fields["wavelengths"] = wav.astype(np.float32)
    # shuffled field order: a loader must key on names, never on the
    # header sequence (real files' field order is unspecified)
    names = sorted(fields, key=lambda n: hash(n) % 97)
    write_tensor_file(path, {n: fields[n] for n in names})
