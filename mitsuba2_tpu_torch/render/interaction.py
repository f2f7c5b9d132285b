"""Interaction records (counterpart of render/interaction.py)."""
from __future__ import annotations

import dataclasses

import torch

from ..core import math as m
from ..core.geometry import Frame, Ray
from ..core.vec import Vec2, Vec3, vdot, vmax_abs


@dataclasses.dataclass
class SurfaceInteraction:
    """Full shading record; wi is in the LOCAL shading frame."""
    valid: torch.Tensor
    t: torch.Tensor
    p: Vec3
    n: Vec3            # geometric normal
    sh_frame: Frame    # shading frame (n = shading normal)
    uv: Vec2
    wi: Vec3
    shape: torch.Tensor
    prim_index: torch.Tensor
    wavelengths: object = None   # the ray's Spec4 (spectral mode) or None
    tex: object = None           # the scene's TextureAtlas, None without
    duv_dx: Vec2 = None          # the uv footprint of a camera ray's
    duv_dy: Vec2 = None          # differentials; zero past the first hit

    def to_world(self, v: Vec3) -> Vec3:
        return self.sh_frame.to_world(v)

    def to_local(self, v: Vec3) -> Vec3:
        return self.sh_frame.to_local(v)

    def spawn_ray_d(self, d_world: Vec3, maxt=None) -> Ray:
        """Offset the origin along the geometric normal (Interaction::spawn_ray)."""
        eps = m.mulsign(m.RAY_EPSILON * (1.0 + vmax_abs(self.p)),
                        vdot(self.n, d_world))
        return Ray.make(self.p + self.n * eps, d_world, maxt=maxt,
                        wavelengths=self.wavelengths)


@dataclasses.dataclass
class DirectionSample:
    """DirectionSample3f, the parts next-event estimation reads: the unit
    direction to a sampled emitter point, its distance, the pdf in solid
    angle at the reference point, and whether it is a delta sample."""
    d: Vec3
    dist: torch.Tensor
    pdf: torch.Tensor
    delta: torch.Tensor
