"""The BSDF families of config 2 and `twosided` in the PyTorch port against
the JAX package's.

Rows and flags from `build_material` are byte-equal; each family's
`sample`, `eval` and `pdf`, on 4 096 lanes with `wi` in both hemispheres
(grazing and normal incidence included) and the same `u1`, `u2`, agree
within rtol 1e-4 / atol 1e-5 with the same sampled flags, in rgb and
mono, alone and through the dispatch (twosided rows hit from behind
included). The refusals: every family the port lacks (null and the
wrappers, refused before the textures' slice, now build the JAX
package's rows), and a textured slot whose atlas is missing; a texture
in any slot a row carries and a textured roughness carry across with
their atlas. The JAX package's compiled lanes and gradients are committed
(tests/goldens/test_torch_bsdf.npz); one entry is recomputed live.
"""
import dataclasses

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

import mitsuba2_tpu as mi
from mitsuba2_tpu.core.geometry import Frame as JFrame
from mitsuba2_tpu.core.vec import Vec2 as JVec2, Vec3 as JVec3
from mitsuba2_tpu.render import bsdf as JB
from mitsuba2_tpu.render.interaction import SurfaceInteraction as JSI
from mitsuba2_tpu.render.spectra import LaneRows as JRows
from mitsuba2_tpu.scene import shapes as jshapes
from mitsuba2_tpu.scene.scene import build_scene as jbuild

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch.core.geometry import Frame
from mitsuba2_tpu_torch.core.vec import Vec2, Vec3
from mitsuba2_tpu_torch.render import bsdf as B
from mitsuba2_tpu_torch.render import fresnel as fr, ior, microfacet as mf
from mitsuba2_tpu_torch.render.interaction import SurfaceInteraction
from mitsuba2_tpu_torch.render.spectra import LaneRows
from mitsuba2_tpu_torch.scene import shapes as tshapes
from mitsuba2_tpu_torch.scene.scene import FIELDS

from goldens.jax_refs import Refs
from test_torch_scene import OPTICS_DESCS

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REFS = Refs("test_torch_bsdf")
N = 4096
RTOL, ATOL = 1e-4, 1e-5

# parameter sets of each family: GGX and Beckmann, isotropic and
# anisotropic roughness, named and numeric IORs, conductor "none" and
# explicit eta / k, nonlinear plastic, nested twosided
DESCS = [
    {"type": "diffuse", "reflectance": [0.2, 0.5, 0.8]},
    {"type": "conductor", "material": "Au"},
    {"type": "conductor", "material": "none"},
    {"type": "conductor", "eta": [0.2, 0.9, 1.1], "k": [3.9, 2.4, 2.1],
     "specular_reflectance": [0.9, 0.8, 0.7]},
    {"type": "conductor", "eta": 1.7},
    {"type": "roughconductor", "material": "Cu", "alpha": 0.3},
    {"type": "roughconductor", "material": "Al", "distribution": "beckmann",
     "alpha_u": 0.05, "alpha_v": 0.4},
    {"type": "roughconductor", "eta": [1.6, 0.9, 0.5], "k": [9.2, 6.3, 4.8],
     "distribution": "ggx", "alpha_u": 0.4, "alpha_v": 0.08},
    {"type": "roughconductor", "material": "Ag", "alpha": 0.005},
    {"type": "dielectric", "int_ior": "bk7", "ext_ior": "air"},
    {"type": "dielectric", "int_ior": 1.33, "ext_ior": 1.0,
     "specular_transmittance": [0.9, 0.95, 1.0]},
    {"type": "dielectric"},
    {"type": "thindielectric", "int_ior": "water"},
    {"type": "thindielectric", "int_ior": 1.7,
     "specular_reflectance": [0.8, 0.8, 0.9]},
    {"type": "roughdielectric", "alpha": 0.2, "int_ior": 1.5},
    {"type": "roughdielectric", "distribution": "beckmann", "alpha_u": 0.1,
     "alpha_v": 0.4, "int_ior": "diamond"},
    {"type": "roughdielectric", "distribution": "ggx", "alpha": 0.6,
     "int_ior": 1.0, "ext_ior": 1.33},
    {"type": "plastic", "diffuse_reflectance": [0.3, 0.5, 0.7]},
    {"type": "plastic", "nonlinear": True, "int_ior": "acrylic glass",
     "diffuse_reflectance": [0.8, 0.2, 0.1]},
    {"type": "plastic", "int_ior": 1.0, "ext_ior": 1.33},
    {"type": "roughplastic", "alpha": 0.2, "distribution": "beckmann"},
    {"type": "roughplastic", "alpha": 0.05, "nonlinear": True,
     "diffuse_reflectance": [0.35, 0.6, 0.4]},
    {"type": "twosided", "bsdf": {"type": "roughconductor",
                                  "material": "Al", "alpha": 0.1}},
    {"type": "twosided", "bsdf": {"type": "twosided", "bsdf": {
        "type": "plastic", "diffuse_reflectance": [0.5, 0.5, 0.2]}}},
    {"type": "twosided", "bsdf": {"type": "diffuse"}},
    {"type": "twosided"},
]
# the eight leaf families of DESCS; null and the wrappers have their own
# tests (tests/test_torch_wrappers.py), and so do the optical elements
# polarizer and retarder (tests/test_torch_polarized.py)
FAMILY_IDS = sorted(set(B.LEAF_FAMILIES) - {B.NULL_BSDF, B.POLARIZER,
                                            B.RETARDER})
# the families this file's refusal tests were written for: the first six
# render since the textures' slice, the last four since the polarized
# slice; each builds the JAX package's rows here
UNPORTED = ["null", "mask", "blendbsdf", "blend", "normalmap", "bumpmap",
            "measured", "measured_polarized", "polarizer", "retarder"]
MEASURED = ("measured", "measured_polarized")


def _build(build_material):
    mats = []
    rows = [build_material(d, mats) for d in DESCS]
    return mats, rows


@pytest.fixture(scope="module")
def tables():
    """Both packages' material tables of DESCS and the lanes: wi (random
    directions, 1/8 grazing at |cos| in [1e-3, 2e-2], eight at normal
    incidence, both hemispheres), u1, u2, a random wo a lane and a row a
    lane (random over every row, or over one family's rows)."""
    mats_j, _ = _build(JB.build_material)
    mats_t, _ = _build(B.build_material)
    rng = np.random.default_rng(15)
    d = rng.normal(size=(N, 3))
    g = N // 8
    d[:g, 2] = np.sign(rng.uniform(-1, 1, g)) * rng.uniform(1e-3, 2e-2, g)
    d[:g, :2] /= np.linalg.norm(d[:g, :2], axis=1, keepdims=True)
    d[:g, :2] *= np.sqrt(1 - d[:g, 2:] ** 2)
    d[g:] /= np.linalg.norm(d[g:], axis=1, keepdims=True)
    d[g:g + 8] = [[0, 0, 1]] * 4 + [[0, 0, -1]] * 4
    wo = rng.normal(size=(N, 3))
    wo /= np.linalg.norm(wo, axis=1, keepdims=True)
    u = rng.uniform(size=(N, 3))
    return dict(mats_j=mats_j, mats_t=mats_t, wi=d.astype(np.float32),
                wo=wo.astype(np.float32), u=u.astype(np.float32),
                pick=rng.integers(0, 1 << 30, N))


def _rows_of(mats, fid):
    return [i for i, m in enumerate(mats) if m[0] == fid]


def _lane_rows(tables, fid):
    """Each lane's row: one of family `fid`'s, or any row for None."""
    mats = tables["mats_t"]
    rows = (np.arange(len(mats)) if fid is None
            else np.asarray(_rows_of(mats, fid)))
    return rows[tables["pick"] % len(rows)].astype(np.int32)


def _table(mats):
    return np.stack([m[2] for m in mats]).astype(np.float32)


def _si_j(wi, idx):
    n = wi.shape[0]
    nrm = JVec3.full((n,), 0.0, 0.0, 1.0)
    return JSI(valid=jnp.ones(n, bool), t=jnp.ones(n), p=JVec3.zeros((n,)),
               n=nrm, sh_frame=JFrame.from_n(nrm), uv=JVec2.zeros((n,)),
               wi=JVec3.from_array(jnp.asarray(wi)),
               shape=jnp.asarray(idx), prim_index=jnp.zeros(n, jnp.int32),
               wavelengths=None)


def _si_t(wi, idx):
    n = wi.shape[0]
    z, o = torch.zeros(n), torch.ones(n)
    nrm = Vec3(z, z, o)
    w = torch.from_numpy(wi)
    return SurfaceInteraction(
        valid=torch.ones(n, dtype=torch.bool), t=o, p=Vec3(z, z, z), n=nrm,
        sh_frame=Frame.from_n(nrm), uv=Vec2(z, z),
        wi=Vec3(w[:, 0], w[:, 1], w[:, 2]), shape=torch.from_numpy(idx),
        prim_index=torch.zeros(n, dtype=torch.int32))


def _v3t(a):
    a = torch.from_numpy(a)
    return Vec3(a[:, 0], a[:, 1], a[:, 2])


def _np_v3(v):
    return np.stack([np.asarray(v.x), np.asarray(v.y), np.asarray(v.z)], -1)


def _np_spec(s):
    return np.stack([np.asarray(c) for c in s.ch], -1)


def _run_j(fam, mats, idx, t, mode, scene=None):
    """The JAX side: sample, then eval and pdf at the random wo, jitted."""
    cfg = mi.RenderConfig(color_mode=mode)

    def go(wi, idx, u, wo):
        si = _si_j(wi, idx)
        u1, u2 = u[:, 0], (u[:, 1], u[:, 2])
        wo = JVec3.from_array(wo)
        if scene is None:
            data = JRows(jnp.asarray(_table(mats)), idx)
            bs, w = fam.sample(data, si, u1, u2, cfg)
            f = fam.eval(data, si, wo, cfg)
            p = fam.pdf(data, si, wo, cfg)
        else:
            bs, w = JB.sample(scene, si, u1, u2, cfg)
            f = JB.eval_(scene, si, wo, cfg)
            p = JB.pdf(scene, si, wo, cfg)
        return (bs.wo.x, bs.wo.y, bs.wo.z, bs.pdf, bs.eta, bs.sampled_flags,
                w.ch, f.ch, p)

    out = jax.jit(go)(jnp.asarray(t["wi"]), jnp.asarray(idx),
                      jnp.asarray(t["u"]), jnp.asarray(t["wo"]))
    return _pack(*out)


def _pack(wx, wy, wz, pdf, eta, flags, w, f, p):
    return dict(wo=np.stack([np.asarray(a) for a in (wx, wy, wz)], -1),
                pdf=np.asarray(pdf), eta=np.asarray(eta),
                flags=np.asarray(flags),
                weight=np.stack([np.asarray(c) for c in w], -1),
                eval=np.stack([np.asarray(c) for c in f], -1),
                eval_pdf=np.asarray(p))


def _run_t(fam, mats, idx, t, mode, scene=None):
    cfg = mt.RenderConfig(color_mode=mode)
    si = _si_t(t["wi"], idx)
    u = torch.from_numpy(t["u"])
    u1, u2 = u[:, 0], (u[:, 1], u[:, 2])
    wo = _v3t(t["wo"])
    if scene is None:
        data = LaneRows(torch.from_numpy(_table(mats)),
                        torch.from_numpy(idx).long())
        bs, w = fam.sample(data, si, u1, u2, cfg)
        f = fam.eval(data, si, wo, cfg)
        p = fam.pdf(data, si, wo, cfg)
    else:
        bs, w = B.sample(scene, si, u1, u2, cfg)
        f = B.eval_(scene, si, wo, cfg)
        p = B.pdf(scene, si, wo, cfg)
    return _pack(bs.wo.x, bs.wo.y, bs.wo.z, bs.pdf, bs.eta,
                 bs.sampled_flags, w.ch, f.ch, p)


def _assert_close(got, want, what=""):
    """Within rtol 1e-4 / atol 1e-5 on all but 1 lane in 1 000, and every
    lane within 100x that. The reference's formulas are ill-conditioned
    on a few lanes (Beckmann's sin_t = sqrt(1 - cos_t^2) where cos_t -> 1,
    reflect_m at grazing wi, cos_t near total internal reflection), where
    an ulp of a sine, a log or an rsqrt, which XLA and torch round
    differently, grows to ~1e-5."""
    assert got.shape == want.shape, what
    assert np.isfinite(got).all() and np.isfinite(want).all(), what
    lanes = got.reshape(got.shape[0], -1)
    ok = np.isclose(lanes, want.reshape(lanes.shape), rtol=RTOL,
                    atol=ATOL).all(-1)
    assert ok.mean() >= 0.999, (what, np.nonzero(~ok)[0][:8])
    np.testing.assert_allclose(got, want, rtol=100 * RTOL, atol=100 * ATOL,
                               err_msg=what)


def _assert_same(out_t, out_j):
    np.testing.assert_array_equal(out_t["flags"], out_j["flags"])
    for k in ("wo", "pdf", "eta", "weight", "eval", "eval_pdf"):
        _assert_close(out_t[k], out_j[k], k)


# --------------------------------------------------------------------------
# packing
# --------------------------------------------------------------------------

def test_build_material_rows_and_flags_byte_equal(tables):
    mats_j, mats_t = tables["mats_j"], tables["mats_t"]
    assert len(mats_j) == len(mats_t) == len(DESCS)
    for (tj, fj, rj), (tt, ft, rt), d in zip(mats_j, mats_t, DESCS):
        assert (tj, fj) == (tt, ft), d
        assert rj.dtype == rt.dtype == np.float32 and rj.shape == rt.shape
        assert rj.tobytes() == rt.tobytes(), d
    # every family and the twosided flag are exercised
    assert {m[0] for m in mats_t} == set(FAMILY_IDS)
    assert sum(m[1] & B.F_TWOSIDED_FLAG != 0 for m in mats_t) == 4


def test_param_spec_and_flags_match_jax():
    for fid, cls in B.FAMILIES.items():
        jcls = JB.FAMILIES[fid]
        assert cls.param_spec == jcls.param_spec
        assert cls.flags == jcls.flags
    for name in ("F_NULL", "F_DIFFUSE_R", "F_DIFFUSE_T", "F_GLOSSY_R",
                 "F_GLOSSY_T", "F_DELTA_R", "F_DELTA_T", "F_TWOSIDED_FLAG",
                 "F_SMOOTH", "F_DELTA", "ALPHA_SLOT", "MAT_W"):
        assert getattr(B, name) == getattr(JB, name), name
    for name, jcls in JB._BY_NAME.items():
        assert B._BY_NAME[name].id == jcls.id, name


def test_ior_tables_match_jax():
    from mitsuba2_tpu.render import ior as jior
    assert ior.DIELECTRIC_IOR == jior.DIELECTRIC_IOR
    assert ior.CONDUCTOR_IOR == jior.CONDUCTOR_IOR
    for v in (None, 1.33, 2, "BK7", "water"):
        assert ior.lookup_dielectric(v) == jior.lookup_dielectric(v)
    assert ior.lookup_conductor(None) == jior.lookup_conductor(None)
    with pytest.raises(ValueError, match="unobtainium"):
        ior.lookup_dielectric("unobtainium")
    with pytest.raises(ValueError, match="Xx"):
        ior.lookup_conductor("Xx")


# --------------------------------------------------------------------------
# fresnel and microfacet against the JAX package
# --------------------------------------------------------------------------

def test_fresnel_matches_jax(tables):
    from mitsuba2_tpu.render import fresnel as jfr
    rng = np.random.default_rng(3)
    cos_i = np.concatenate([tables["wi"][:, 2], [0.0, 1.0, -1.0]])
    eta = rng.choice([1.0, 1.5, 1 / 1.33, 2.4], cos_i.shape[0]).astype(
        np.float32)
    got = fr.fresnel(torch.from_numpy(cos_i), torch.from_numpy(eta))
    want = jfr.fresnel(jnp.asarray(cos_i), jnp.asarray(eta))
    for a, b in zip(got, want):
        _assert_close(a.numpy(), np.asarray(b))
    e, k = (rng.uniform(0.1, 3, cos_i.shape[0]).astype(np.float32)
            for _ in range(2))
    np.testing.assert_allclose(
        fr.fresnel_conductor(torch.from_numpy(cos_i).abs(),
                             torch.from_numpy(e), torch.from_numpy(k)).numpy(),
        np.asarray(jfr.fresnel_conductor(jnp.abs(jnp.asarray(cos_i)),
                                         jnp.asarray(e), jnp.asarray(k))),
        rtol=RTOL, atol=ATOL)
    x = np.asarray([0.5, 0.8, 1.0, 1.33, 2.0], np.float32)
    np.testing.assert_allclose(
        fr.fresnel_diffuse_reflectance(torch.from_numpy(x)).numpy(),
        np.asarray(jfr.fresnel_diffuse_reflectance(jnp.asarray(x))),
        rtol=1e-6)


@pytest.mark.parametrize("dist", [mf.GGX, mf.BECKMANN])
def test_microfacet_matches_jax(tables, dist):
    from mitsuba2_tpu.render import microfacet as jmf
    rng = np.random.default_rng(4)
    au = rng.uniform(0.01, 0.8, N).astype(np.float32)
    av = rng.uniform(0.01, 0.8, N).astype(np.float32)
    d = np.full(N, dist, np.int32)
    wi, u = tables["wi"], tables["u"]
    m_t, pdf_t = mf.sample(torch.from_numpy(d), _v3t(wi),
                           torch.from_numpy(au), torch.from_numpy(av),
                           (torch.from_numpy(u[:, 1]),
                            torch.from_numpy(u[:, 2])))
    m_j, pdf_j = jmf.sample(jnp.asarray(d), JVec3.from_array(wi),
                            jnp.asarray(au), jnp.asarray(av),
                            (jnp.asarray(u[:, 1]), jnp.asarray(u[:, 2])))
    _assert_close(_np_v3(m_t), _np_v3(m_j), "m")
    _assert_close(pdf_t.numpy(), np.asarray(pdf_j), "pdf")
    wo = tables["wo"]
    h_t = _v3t(wo)
    h_j = JVec3.from_array(wo)
    for name in ("eval_d", "smith_g1", "pdf"):
        args_t = (torch.from_numpy(d),) + ((h_t,) if name == "eval_d" else
                                           (_v3t(wi), h_t)) + (
            torch.from_numpy(au), torch.from_numpy(av))
        args_j = (jnp.asarray(d),) + ((h_j,) if name == "eval_d" else
                                      (JVec3.from_array(wi), h_j)) + (
            jnp.asarray(au), jnp.asarray(av))
        _assert_close(getattr(mf, name)(*args_t).numpy(),
                      np.asarray(getattr(jmf, name)(*args_j)), name)


def test_smith_g1_gradients_are_finite():
    """The NaN guards of smith_g1: under autograd, the Beckmann branch on
    GGX lanes and v at normal incidence (tan -> 0) give finite alpha
    gradients."""
    au = torch.full((4,), 0.3, requires_grad=True)
    v = Vec3(torch.tensor([0.0, 0.0, 0.3, 1e-4]),
             torch.tensor([0.0, 1e-7, 0.2, 0.0]),
             torch.tensor([1.0, 1.0, 0.9, 0.999]))
    dist = torch.tensor([mf.GGX, mf.BECKMANN, mf.GGX, mf.BECKMANN],
                        dtype=torch.int32)
    g = mf.smith_g1(dist, v, Vec3(torch.zeros(4), torch.zeros(4),
                                  torch.ones(4)), au, au)
    g.sum().backward()
    assert bool(torch.isfinite(au.grad).all())


# --------------------------------------------------------------------------
# each family alone, then through the dispatch
# --------------------------------------------------------------------------

def test_golden_is_fresh(tables):
    """The golden's diffuse family in mono recomputed by the JAX package
    now: a stale golden (new lanes, new rows) fails here."""
    fid = FAMILY_IDS[0]
    idx = _lane_rows(tables, fid)
    stored, live = REFS.fresh(f"family_{fid}_mono", lambda: _run_j(
        JB.FAMILIES[fid], tables["mats_j"], idx, tables, "mono"))
    for k in live:
        np.testing.assert_array_equal(stored[k], live[k], err_msg=k)


@pytest.mark.parametrize("mode", ["rgb", "mono"])
@pytest.mark.parametrize("fid", FAMILY_IDS)
def test_family_sample_eval_pdf_match_jax(tables, fid, mode):
    idx = _lane_rows(tables, fid)
    out_j = REFS.get(f"family_{fid}_{mode}", lambda: _run_j(
        JB.FAMILIES[fid], tables["mats_j"], idx, tables, mode))
    out_t = _run_t(B.FAMILIES[fid], tables["mats_t"], idx, tables, mode)
    _assert_same(out_t, out_j)
    # the lanes sample something, in the hemisphere the family allows
    assert (out_t["flags"] != 0).mean() > 0.2


class _StandIn:
    """A scene's material tables, every row of DESCS, one shape a row."""

    def __init__(self, mats, lib):
        up = jnp.asarray if lib is jnp else torch.from_numpy
        self.mat_type = up(np.asarray([m[0] for m in mats], np.int32))
        self.mat_flags = up(np.asarray([m[1] for m in mats], np.int32))
        self.mat_data = up(_table(mats))
        self.shape_mat = up(np.arange(len(mats), dtype=np.int32))
        self.mat_families = tuple(sorted({m[0] for m in mats}))
        self.family_rows = tuple(
            [m[0] for m in mats].index(f) for f in self.mat_families)
        self.has_twosided = any(m[1] & B.F_TWOSIDED_FLAG for m in mats)
        self.family_tex = B.textured_slots(np.asarray([m[0] for m in mats]),
                                           _table(mats))
        self.wrapper_children = B.wrapper_children(
            np.asarray([m[0] for m in mats]), _table(mats))


@pytest.mark.parametrize("mode", ["rgb", "mono"])
def test_dispatch_matches_jax(tables, mode):
    """sample, eval_ and pdf over a wavefront of every row (the twosided
    ones from both sides), with the masked evaluate-all."""
    idx = _lane_rows(tables, None)
    out_j = REFS.get(f"dispatch_{mode}", lambda: _run_j(
        None, None, idx, tables, mode, scene=_StandIn(tables["mats_j"],
                                                      jnp)))
    out_t = _run_t(None, None, idx, tables, mode,
                   scene=_StandIn(tables["mats_t"], torch))
    _assert_same(out_t, out_j)
    two = np.asarray([tables["mats_t"][i][1] & B.F_TWOSIDED_FLAG != 0
                      for i in idx])
    behind = two & (tables["wi"][:, 2] < 0)
    assert behind.sum() > 100
    # a twosided row hit from behind samples into its own side
    ok = behind & (out_t["flags"] != 0)
    assert ok.sum() > 50 and (out_t["wo"][ok, 2] < 0).all()
    assert (out_t["weight"][ok] > 0).any()


def test_twosided_diffuse_from_behind():
    """tests/test_bsdf.py's case on the port: twosided diffuse is lit from
    behind, one-sided diffuse is black there."""
    cfg = mt.RenderConfig(color_mode="rgb")
    si = _si_t(np.asarray([[0.0, 0.0, -1.0]], np.float32),
               np.zeros(1, np.int32))
    wo = _v3t(np.asarray([[0.5, 0.0, -np.sqrt(0.75)]], np.float32))
    for desc, lit in (({"type": "twosided", "bsdf": {"type": "diffuse"}},
                       True), ({"type": "diffuse"}, False)):
        mats = []
        B.build_material(desc, mats)
        val = _np_spec(B.eval_(_StandIn(mats, torch), si, wo, cfg))
        assert (val.min() > 0) if lit else (val.max() == 0)


# --------------------------------------------------------------------------
# refusals
# --------------------------------------------------------------------------

@pytest.mark.parametrize("name", UNPORTED)
def test_unported_family_raises_by_name(name):
    """Null, the wrappers, the polarizer and retarder and the measured
    families build the JAX package's rows and flags, twosided too; a
    measured one stages the JAX package's table (and Mueller table) in
    the build's list, and without a table source both raise."""
    from mitsuba2_tpu.render import measured as jms
    leaf = OPTICS_DESCS.get(name, {"type": name})
    for desc in (leaf, {"type": "twosided", "bsdf": leaf}):
        mats_t, mats_j, staged = [], [], []
        B.build_material(desc, mats_t, staged)
        jms.begin_staging()
        try:
            JB.build_material(desc, mats_j)
        finally:
            staged_j = jms.end_staging()
        assert [(t, f, r.tobytes()) for t, f, r in mats_t] == \
            [(t, f, r.tobytes()) for t, f, r in mats_j]
        assert len(staged) == len(staged_j) == (name in MEASURED)
        for (tab, mm), (tab_j, mm_j) in zip(staged, staged_j):
            assert tab.tobytes() == tab_j.tobytes()
            assert (mm is None) == (mm_j is None) == (name == "measured")
            assert mm is None or mm.tobytes() == mm_j.tobytes()
    if name in MEASURED:
        for build in (lambda d: B.build_material(d, [], []),
                      lambda d: JB.build_material(d, [])):
            with pytest.raises(ValueError, match="'filename'"):
                build({"type": name})


def _jax_fields(desc, emitter=None, textures=False):
    """A JAX-built rectangle's tables; with `textures`, its atlas' too."""
    sensor = {"type": "perspective", "to_world": np.eye(4), "fov": 45.0}
    sj = jbuild([jshapes.rectangle(bsdf=desc, emitter=emitter)], sensor)
    out = {**{k: np.asarray(getattr(sj, k)) for k in FIELDS},
           "param_paths": sj.param_paths}
    if textures:
        out["textures"] = {k: np.asarray(getattr(sj.textures, k))
                           for k in ("data", "info", "uvt")}
        out["mips"] = np.asarray(sj.textures.mips)
    return out


@pytest.mark.parametrize("fid", range(8, 17))
def test_scene_from_numpy_names_unported_family(fid):
    """The JAX package's family ids 8-16 carry across: null, the wrappers,
    the polarizer (14) and the retarder (15); the measured ones (13, 16)
    need their tables under "measured" (KeyError without them, as a
    heterogeneous medium without its grid), which a JAX build of such a
    row carries."""
    fields = _jax_fields({"type": "diffuse"})
    fields["mat_type"] = np.full_like(fields["mat_type"], fid)
    if fid not in (B.MEASURED, B.MEASURED_POLARIZED):
        assert mt.scene_from_numpy(fields, device="cpu").mat_families == (fid,)
        return
    with pytest.raises(KeyError, match="measured"):
        mt.scene_from_numpy(fields, device="cpu")
    name = B.FAMILIES[fid].__name__
    desc = OPTICS_DESCS[MEASURED[fid == B.MEASURED_POLARIZED]]
    sensor = {"type": "perspective", "to_world": np.eye(4), "fov": 45.0}
    sj = jbuild([jshapes.rectangle(bsdf=desc)], sensor)
    fields = {**{k: np.asarray(getattr(sj, k)) for k in FIELDS},
              "measured": {k: None if getattr(sj.measured, k) is None
                           else np.asarray(getattr(sj.measured, k))
                           for k in ("values", "weights", "marg_cdf",
                                     "cond_cdf", "mueller")}}
    st = mt.scene_from_numpy(fields, device="cpu")
    assert st.mat_families == (fid,), name
    assert np.array_equal(st.measured.values.numpy(), fields["measured"][
        "values"])


@pytest.mark.parametrize("desc,what", [
    ({"type": "null"}, "'null' BSDF"),
    ({"type": "mask", "opacity": 0.5, "bsdf": {"type": "diffuse"}},
     "'mask' BSDF"),
    ({"type": "blendbsdf", "weight": 0.3,
      "bsdf_a": {"type": "diffuse"}, "bsdf_b": {"type": "conductor"}},
     "'blendbsdf' BSDF"),
])
def test_scene_from_numpy_refuses_jax_built_unported(desc, what):
    """null, mask and blendbsdf (refused before the textures' slice) carry
    across: the rows, flags and families of the JAX build."""
    fields = _jax_fields(desc)
    st = mt.scene_from_numpy(fields, device="cpu")
    assert np.array_equal(st.mat_data.numpy(), fields["mat_data"])
    assert np.array_equal(st.mat_flags.numpy(), fields["mat_flags"])
    assert st.mat_families == tuple(sorted(set(fields["mat_type"].tolist())))
    assert what.split("'")[1] in {B.FAMILIES[f].__name__.lower()
                                  for f in st.mat_families} | {"blendbsdf"}


CHECKER = {"type": "checkerboard", "color0": [0.2] * 3, "color1": [0.8] * 3}


@pytest.mark.parametrize("col,desc,what", [
    # kitchen_sink's metal: a checkerboard roughness (ALPHA_SLOT, col 39)
    (39, {"type": "roughconductor", "material": "Al", "alpha": {
        "type": "checkerboard", "color0": [0.05] * 3,
        "color1": [0.4] * 3}}, "textured roughness"),
    (15, {"type": "conductor", "eta": [0.2, 0.9, 1.1], "k": CHECKER},
     "textured colors"),
    (15, {"type": "plastic", "specular_reflectance": CHECKER},
     "textured colors"),
    (23, {"type": "conductor", "material": "Au",
          "specular_reflectance": CHECKER}, "textured colors"),
])
def test_scene_from_numpy_refuses_textures_in_any_slot(col, desc, what):
    """A JAX-built row with a texture in slot 1, slot 2 or the roughness
    slot (refused before the textures' slice) carries across with its
    atlas, whose pyramid the port rebuilds byte-equal; without the atlas
    it raises."""
    fields = _jax_fields(desc, textures=True)
    assert (fields["mat_data"][:, col] >= 2).any()
    assert not (fields["mat_data"][:, 7] >= 2).any()
    st = mt.scene_from_numpy(fields, device="cpu")
    assert np.array_equal(st.textures.mips.numpy(), fields["mips"])
    alpha = B.ALPHA_SLOT // 8 in dict(st.family_tex)[int(fields["mat_type"][0])]
    assert alpha == (what == "textured roughness")
    with pytest.raises(KeyError, match="textures"):
        mt.scene_from_numpy({k: v for k, v in fields.items()
                             if k != "textures"}, device="cpu")


def test_scene_from_numpy_refuses_textured_emitter():
    """An emitter slot naming a texture the scene has no atlas for."""
    fields = _jax_fields({"type": "diffuse"},
                         {"type": "area", "radiance": [1.0, 1.0, 1.0]})
    mt.scene_from_numpy(fields, device="cpu")
    fields["emitter_data"] = fields["emitter_data"].copy()
    fields["emitter_data"][:, 7] = 2.0
    with pytest.raises(KeyError, match="textures"):
        mt.scene_from_numpy(fields, device="cpu")


def test_build_refuses_textured_roughness():
    """A textured roughness builds the JAX package's row inside a scene
    build's texture staging, and raises outside one, as there."""
    from mitsuba2_tpu.render import spectra as jspectra
    from mitsuba2_tpu_torch.render import spectra
    desc = {"type": "roughdielectric", "alpha_u": CHECKER}
    for build in (B.build_material, JB.build_material):
        with pytest.raises(RuntimeError, match="staging"):
            build(desc, [])
    with spectra.texture_staging() as staged:
        mats_t = []
        B.build_material(desc, mats_t)
    jspectra.begin_texture_staging()
    try:
        mats_j = []
        JB.build_material(desc, mats_j)
    finally:
        staged_j = jspectra.end_texture_staging()
    assert mats_t[0][2].tobytes() == mats_j[0][2].tobytes()
    assert mats_t[0][2][B.ALPHA_SLOT + 7] == 2.0 and len(staged) == 1
    assert np.array_equal(staged[0].data, staged_j[0].data)
    with pytest.raises(ValueError, match="unknown bsdf type"):
        B.build_material({"type": "velvet"}, [])


def test_twosided_scene_carries_across():
    """A JAX-built twosided rough conductor converts and keeps its flag;
    the port's own build equals it."""
    desc = {"type": "twosided", "bsdf": {"type": "roughconductor",
                                         "alpha": 0.1}}
    fields = _jax_fields(desc)
    conv = mt.scene_from_numpy(fields, device="cpu")
    sensor = {"type": "perspective", "to_world": np.eye(4), "fov": 45.0}
    own = mt.build_scene([tshapes.rectangle(bsdf=desc)], sensor,
                         device="cpu")
    assert conv.has_twosided and own.has_twosided
    for f in dataclasses.fields(conv):
        a, b = getattr(conv, f.name), getattr(own, f.name)
        if torch.is_tensor(a):
            assert torch.equal(a, b), f.name
        else:
            assert a == b, f.name


# --------------------------------------------------------------------------
# gradients, lane by lane
# --------------------------------------------------------------------------

def _grads_j(fid, rows, t):
    """jax.grad of the sums of a family's sample weight, eval and pdfs
    with respect to a table of one row a lane (4 096 rows: a plain gather,
    whose backward keeps each lane's gradient in its own row)."""
    fam, cfg = JB.FAMILIES[fid], mi.RenderConfig(color_mode="rgb")
    idx = jnp.arange(N, dtype=jnp.int32)

    def outs(table):
        si = _si_j(jnp.asarray(t["wi"]), idx)
        u = jnp.asarray(t["u"])
        wo = JVec3.from_array(jnp.asarray(t["wo"]))
        data = JRows(table, idx)
        bs, w = fam.sample(data, si, u[:, 0], (u[:, 1], u[:, 2]), cfg)
        return (sum(jnp.sum(c) for c in w.ch),
                sum(jnp.sum(c) for c in fam.eval(data, si, wo, cfg).ch),
                jnp.sum(fam.pdf(data, si, wo, cfg)) + jnp.sum(bs.pdf))

    g = jax.jit(lambda tb: tuple(jax.grad(lambda x, k=k: outs(x)[k])(tb)
                                 for k in range(3)))(jnp.asarray(rows))
    return [np.asarray(a) for a in g]


def _compact(grads):
    """Each gradient table as (its columns not all zero, those columns):
    most of a row's 40 columns are another family's, zero throughout."""
    out = []
    for g in grads:
        cols = np.nonzero((g != 0).any(0))[0]
        out.append((cols, g[:, cols]))
    return out


def _expand(compact, shape):
    """_compact's tables, whole again."""
    out = []
    for cols, data in compact:
        g = np.zeros(shape, np.float32)
        g[:, np.asarray(cols, np.int64)] = data
        out.append(g)
    return out


def _outs_t(fid, table, t):
    """A family's per-lane sample weight (summed over channels), eval
    (summed) and pdfs (at the random wo, plus the sample's), in the
    table's dtype."""
    fam, cfg = B.FAMILIES[fid], mt.RenderConfig(color_mode="rgb")
    dt = table.dtype
    si = _si_t(t["wi"], np.zeros(N, np.int32))
    si = dataclasses.replace(si, wi=Vec3(*(c.to(dt) for c in (
        si.wi.x, si.wi.y, si.wi.z))))
    u = torch.from_numpy(t["u"]).to(dt)
    wo = Vec3(*(c.to(dt) for c in dataclasses.astuple(_v3t(t["wo"]))))
    data = LaneRows(table, torch.arange(N))
    bs, w = fam.sample(data, si, u[:, 0], (u[:, 1], u[:, 2]), cfg)
    f = fam.eval(data, si, wo, cfg)
    return (sum(w.ch), sum(f.ch), fam.pdf(data, si, wo, cfg) + bs.pdf)


def _grads_t(fid, rows, t, dtype):
    out = []
    for k in range(3):
        table = torch.from_numpy(rows).to(dtype).requires_grad_(True)
        s = _outs_t(fid, table, t)[k].sum()
        # a delta family's eval and pdf are constant zeros
        out.append(torch.autograd.grad(s, table)[0].double().numpy()
                   if s.requires_grad else np.zeros(rows.shape))
    return out


def _param_cols(fid):
    cols = []
    for where, loc in B.FAMILIES[fid].param_spec.values():
        cols += list(range(8 * loc, 8 * loc + 3)) if where == "slot" else [loc]
    return cols


def _lane_err(a, b, scale):
    return (np.abs(a - b) / scale).max(-1)


@pytest.mark.parametrize("fid", FAMILY_IDS)
def test_family_gradients_match_jax(tables, fid):
    """d(sample weight, eval, pdf) / d(the lane's row), lane by lane
    (each lane reads its own row), for the port's arithmetic run in
    float64 against the JAX package's in float32, on the lanes where the
    JAX package's are finite: 99% of them within 1e-3 of the lane's
    largest entry (floored at 1e-3 of the largest over all lanes), every
    one within 5%. The JAX package's are NaN on some lanes of the rough
    families and the plastics: its backward multiplies a zero cotangent
    by the infinite derivative of sqrt or rsqrt at 0, where torch's masks
    it. The port's float32 gradients are finite on every lane and within
    1e-2 of its float64 ones on 95% of the lanes (the near-specular row,
    alpha 0.005, loses 1e-4 of h = normalize(wi + wo) to cancellation,
    which terms of size 1 / alpha that cancel raise to ~1e-1 on a few of
    its lanes; XLA's fused multiply-adds lose less)."""
    idx = _lane_rows(tables, fid)
    rows = _table(tables["mats_t"])[idx]
    g_j = _expand(REFS.get(f"grads_{fid}", lambda: _compact(
        _grads_j(fid, rows, tables))), rows.shape)
    g_64 = _grads_t(fid, rows, tables, torch.float64)
    g_32 = _grads_t(fid, rows, tables, torch.float32)
    for k, (a, b, c) in enumerate(zip(g_64, g_j, g_32)):
        ok_j = np.isfinite(b).all(-1)
        assert ok_j.mean() >= 0.5, k
        assert np.isfinite(a).all() and np.isfinite(c).all(), k
        floor = max(1e-3 * np.abs(a).max(), 1e-9)
        scale = np.maximum(np.abs(a).max(-1, keepdims=True), floor)
        e = _lane_err(a, b, scale)[ok_j]
        assert (e <= 1e-3).mean() >= 0.99 and e.max() <= 5e-2, (k, e.max())
        assert (_lane_err(c, a, scale) <= 1e-2).mean() >= 0.95, k
    # the parameters a family's param_spec names carry gradient
    total = sum(np.abs(a).sum(0) for a in g_64)
    assert all(total[c] > 0 for c in _param_cols(fid))
