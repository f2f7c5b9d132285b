"""The chi^2 harness of the PyTorch port (mitsuba2_tpu_torch/chi2.py) on
the port's BSDF samplers: tests/test_bsdf.py's bsdf_chi2 cases (its
:37), run on each leaf family and on mask and blendbsdf over two leaves.

A smooth lobe's directions are binned over the sphere against its pdf
(400 000 draws, 16 x 32 bins, 16^2 midpoints a bin, the reference
harness' significance 0.01). The delta families (conductor, dielectric,
thindielectric) have no pdf to bin: their draws must land on the analytic
mirror or refraction direction, and the choice between those lobes is
held to the sampled probabilities by Pearson's test on the lobe counts.
mask's null lobe (wo = -wi, F_NULL) is such a delta: its draws count
toward the total and no bin, as the pdf, q times the child's, integrates
to q. The harness itself is held against the JAX package's on the same
statistics.
"""
import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch import chi2
from mitsuba2_tpu_torch.core.geometry import Frame
from mitsuba2_tpu_torch.core.vec import Vec2, Vec3, vwhere
from mitsuba2_tpu_torch.render import bsdf as B
from mitsuba2_tpu_torch.render import fresnel as fr
from mitsuba2_tpu_torch.render.interaction import SurfaceInteraction
from mitsuba2_tpu_torch.render.spectra import LaneRows

CFG = mt.RenderConfig(color_mode="rgb")
WI_30 = np.array([np.sin(np.pi / 6), 0.0, np.cos(np.pi / 6)])
WI_60 = np.array([np.sin(np.pi / 3), 0.0, np.cos(np.pi / 3)])


def make_si(wi, n):
    w = torch.as_tensor(np.asarray(wi, np.float32)).expand(n, 3)
    z = torch.zeros(n)
    nrm = Vec3(z, z, torch.ones(n))
    return SurfaceInteraction(
        valid=torch.ones(n, dtype=torch.bool), t=torch.ones(n),
        p=Vec3(z, z, z), n=nrm, sh_frame=Frame.from_n(nrm), uv=Vec2(z, z),
        wi=Vec3(*w.unbind(1)), shape=torch.zeros(n, dtype=torch.int64),
        prim_index=torch.zeros(n, dtype=torch.int32))


class _Scene:
    """The tables the dispatch reads, for the rows of one descriptor
    (shape 0 takes its first row)."""

    def __init__(self, desc):
        mats = []
        B.build_material(desc, mats)
        self.mat_type = torch.tensor([m[0] for m in mats], dtype=torch.int32)
        self.mat_flags = torch.tensor([m[1] for m in mats],
                                      dtype=torch.int32)
        self.mat_data = torch.from_numpy(np.stack([m[2] for m in mats]))
        self.shape_mat = torch.zeros(1, dtype=torch.int64)
        self.mat_families = tuple(sorted({m[0] for m in mats}))
        self.family_rows = tuple(
            next(i for i, m in enumerate(mats) if m[0] == f)
            for f in self.mat_families)
        self.has_twosided = False
        self.family_tex = B.textured_slots(self.mat_type.numpy(),
                                           self.mat_data.numpy())
        self.wrapper_children = B.wrapper_children(self.mat_type.numpy(),
                                                   self.mat_data.numpy())


def _leaf(desc, n):
    mats = []
    B.build_material(desc, mats)
    row = torch.from_numpy(mats[0][2])[None]
    return B.FAMILIES[mats[0][0]], LaneRows(row, torch.zeros(n,
                                                              dtype=torch.int64))


def _split(u):
    return u[:, 0], (u[:, 1], u[:, 2])


def bsdf_chi2(desc, wi, sample_count=400_000, res=16, ires=16,
              wrapper=False):
    """tests/test_bsdf.py's bsdf_chi2 on the port: a leaf family through
    its own sample and pdf, a wrapper through the wavefront dispatch. A
    draw the sampler rejects (pdf 0 or a zero weight) or that took the
    null lobe is a zero direction: no bin."""
    scene = _Scene(desc) if wrapper else None

    def sample_fn(u):
        n = u.shape[0]
        si = make_si(wi, n)
        u1, u2 = _split(u)
        if wrapper:
            bs, w = B.sample(scene, si, u1, u2, CFG)
        else:
            cls, data = _leaf(desc, n)
            bs, w = cls.sample(data, si, u1, u2, CFG)
        ok = ((bs.pdf > 0) & w.any_positive()
              & ((bs.sampled_flags & B.F_NULL) == 0))
        return vwhere(ok, bs.wo, Vec3.zeros(n, "cpu"))

    def pdf_fn(d):
        n = d.shape[0] * d.shape[1] if d.ndim == 3 else d.shape[0]
        flat = d.reshape(n, 3)
        si = make_si(wi, n)
        wo = Vec3(*flat.unbind(1))
        if wrapper:
            out = B.pdf(scene, si, wo, CFG)
        else:
            cls, data = _leaf(desc, n)
            out = cls.pdf(data, si, wo, CFG)
        return out.reshape(d.shape[:-1])

    t = chi2.ChiSquareTest(chi2.SphericalDomain(), sample_fn, pdf_fn,
                           sample_count=sample_count, res=res, ires=ires,
                           sample_dim=3)
    assert t.run(), "\n".join(t.messages)
    return t


SMOOTH = {
    "diffuse": ({"type": "diffuse"}, WI_30, {}),
    "roughconductor-ggx": ({"type": "roughconductor", "alpha": 0.3,
                            "distribution": "ggx", "material": "Au"},
                           WI_30, {}),
    "roughconductor-beckmann": ({"type": "roughconductor", "alpha": 0.5,
                                 "distribution": "beckmann",
                                 "material": "Au"}, WI_30, {}),
    "roughconductor-anisotropic": ({"type": "roughconductor",
                                    "alpha_u": 0.2, "alpha_v": 0.45,
                                    "distribution": "ggx",
                                    "material": "Cu"}, WI_60, {}),
    "roughdielectric-outside": ({"type": "roughdielectric", "alpha": 0.4,
                                 "int_ior": 1.5, "ext_ior": 1.0}, WI_30,
                                {"sample_count": 600_000}),
    "roughdielectric-inside": ({"type": "roughdielectric", "alpha": 0.4,
                                "int_ior": 1.5, "ext_ior": 1.0}, -WI_30,
                               {"sample_count": 600_000}),
    "plastic": ({"type": "plastic"}, WI_30, {}),
    "roughplastic": ({"type": "roughplastic", "alpha": 0.3}, WI_30, {}),
    "mask": ({"type": "mask", "opacity": 0.5, "bsdf": {
        "type": "roughplastic", "alpha": 0.3}}, WI_30, {"wrapper": True}),
    "blendbsdf": ({"type": "blend", "weight": 0.3, "bsdfs": [
        {"type": "diffuse"}, {"type": "roughconductor", "alpha": 0.3}]},
        WI_30, {"wrapper": True}),
}


@pytest.mark.parametrize("case", sorted(SMOOTH))
def test_chi2_smooth_lobes(case):
    desc, wi, kw = SMOOTH[case]
    bsdf_chi2(desc, wi, **kw)


def _lobes(desc, wi, n=200_000):
    """A delta family's draws: (the lobe each took: 0 reflection, 1
    transmission, -1 neither), their sample pdfs, the exact directions."""
    u = torch.from_numpy(np.random.default_rng(2).random(
        (n, 3)).astype(np.float32))
    si = make_si(wi, n)
    cls, data = _leaf(desc, n)
    bs, w = cls.sample(data, si, *_split(u), CFG)
    refl = fr.reflect(si.wi)
    is_r = (bs.sampled_flags & B.F_DELTA_R) != 0
    is_t = (bs.sampled_flags & B.F_DELTA_T) != 0
    lobe = np.where(is_r, 0, np.where(is_t, 1, -1))
    return lobe, bs, refl, si


@pytest.mark.parametrize("case", ["conductor", "dielectric-outside",
                                  "dielectric-inside", "thindielectric"])
def test_chi2_delta_lobes(case):
    """Every draw on the mirror direction (conductor) or on one of the two
    analytic directions, the lobe counts against their probabilities."""
    desc = {"conductor": {"type": "conductor", "material": "Au"},
            "thindielectric": {"type": "thindielectric", "int_ior": 1.5,
                               "ext_ior": 1.0}
            }.get(case, {"type": "dielectric", "int_ior": 1.5,
                         "ext_ior": 1.0})
    wi = -WI_30 if case.endswith("inside") else WI_30
    lobe, bs, refl, si = _lobes(desc, wi)
    wo = torch.stack([bs.wo.x, bs.wo.y, bs.wo.z], -1).numpy()
    r = torch.stack([refl.x, refl.y, refl.z], -1).numpy()
    assert (lobe >= 0).all() and (bs.pdf.numpy() > 0).all()
    np.testing.assert_allclose(wo[lobe == 0], r[lobe == 0], atol=1e-6)
    if case == "conductor":
        assert (lobe == 0).all() and (bs.pdf.numpy() == 1).all()
        return
    F = fr.fresnel(si.wi.z.abs() if case == "thindielectric" else si.wi.z,
                   torch.full_like(si.wi.z, 1.5))[0].numpy().astype(np.float64)
    wo_t = wo[lobe == 1]
    if case == "thindielectric":
        F = F + (1 - F) ** 2 * F / (1 - F * F)    # R' = 2R / (1 + R)
        np.testing.assert_allclose(wo_t, np.broadcast_to(-wi, wo_t.shape),
                                   atol=1e-6)
    else:
        # Snell: the tangential components scale by eta_ti, and the lobe
        # crosses the surface
        eta_ti = 1 / 1.5 if wi[2] > 0 else 1.5
        np.testing.assert_allclose(
            wo_t[:, :2], np.broadcast_to(-eta_ti * wi[:2], wo_t[:, :2].shape),
            atol=1e-5)
        assert (np.sign(wo_t[:, 2]) == -np.sign(wi[2])).all()
    pdf = bs.pdf.numpy().astype(np.float64)
    np.testing.assert_allclose(pdf, np.where(lobe == 0, F, 1 - F),
                               rtol=1e-5)
    ok, msg = chi2.lobe_test(lobe, np.stack([F, 1 - F], -1))
    assert ok, msg


def test_harness_matches_jax():
    """rlgamma and the pooled statistic against the JAX package's harness
    on the same counts."""
    from mitsuba2_tpu import chi2 as jchi2
    from mitsuba2_tpu.core.math import rlgamma as jrlgamma
    for a, x in ((0.5, 0.1), (3.0, 2.0), (40.0, 38.5), (100.0, 130.0)):
        assert chi2.rlgamma(a, x) == jrlgamma(a, x)
    rng = np.random.default_rng(4)
    exp = rng.uniform(0.1, 50.0, (16, 32))
    obs = rng.poisson(exp).astype(np.float64)
    obs[0, 0] += obs.sum() * 0.01 - (obs.sum() - exp.sum())
    for h in (exp, obs):
        t = chi2.ChiSquareTest(chi2.SphericalDomain(), None, None)
        tj = jchi2.ChiSquareTest(jchi2.SphericalDomain(), None, None)
        t.histogram, t.pdf = h, exp
        tj.histogram, tj.pdf = h, exp
        assert t.run() == tj.run()
        assert t.p_value == tj.p_value
