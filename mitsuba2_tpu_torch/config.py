"""Render configuration (counterpart of mitsuba2_tpu/config.py).

Same fields as the JAX package's `RenderConfig`, so a configuration reads
the same in both. The port renders a subset of what the fields can name;
a value it does not render yet raises `NotImplementedError` when the
config is made, never later and never silently.
"""
from __future__ import annotations

import dataclasses
from typing import Optional

import torch

COLOR_MODES = ("mono", "rgb", "spectral")
# the samplers (render/sampler.py::make_sampler)
SAMPLERS = ("independent", "stratified", "ldsampler", "halton")


def check_kaux(k: int) -> int:
    """The auxiliary rays a reparameterized direction traces, refused
    below 1 with the JAX package's message (diff/reparam.py)."""
    if int(k) < 1:
        raise ValueError(
            f"reparam_kaux={k}: the warp needs >= 1 auxiliary ray")
    return int(k)


@dataclasses.dataclass(frozen=True)
class RenderConfig:
    color_mode: str = "rgb"           # mono | rgb | spectral
    polarized: bool = False
    max_depth: int = 2                # path depth; 2 = direct illumination
    rr_depth: int = 5                 # start Russian roulette at this depth
    spp: int = 64                     # samples per pixel
    spp_per_pass: int = 64            # wavefront chunk (memory bound)
    width: int = 256
    height: int = 256
    seed: int = 0
    rfilter: str = "box"
    film_width: Optional[int] = None  # crop window (films/hdrfilm.cpp)
    film_height: Optional[int] = None
    crop_x: int = 0
    crop_y: int = 0
    hide_emitters: bool = False
    sampler: str = "independent"
    integrator: str = "path"
    aovs: tuple = ()
    aov_child: str = "path"
    remat: bool = False               # JAX adjoint's memory knob; inert here
    compact: bool = False
    reparam: bool = False
    reparam_kaux: int = 16
    dtype: str = "float32"

    def __post_init__(self):
        if self.color_mode not in COLOR_MODES:
            raise ValueError(f"unknown color_mode {self.color_mode!r}")
        if self.dtype not in ("float32", "float64"):
            raise ValueError(f"unknown dtype {self.dtype!r}")
        if self.integrator not in ("path", "volpath", "volpathmis", "direct",
                                   "depth", "aov", "moment", "stokes"):
            raise ValueError(f"unknown integrator {self.integrator!r}")
        # the aov wrapper's child is a transport integrator (no aov in aov)
        if self.aov_child not in ("path", "volpath", "volpathmis", "direct",
                                  "moment", "stokes"):
            raise ValueError(f"invalid aov child {self.aov_child!r}")
        from .render.film import FILTER_RADIUS
        if self.rfilter not in FILTER_RADIUS:
            raise ValueError(f"unknown rfilter {self.rfilter!r}")
        if self.sampler not in SAMPLERS:
            raise ValueError(f"unknown sampler {self.sampler!r}")
        if self.dtype == "float64":
            raise NotImplementedError(
                "mitsuba2_tpu_torch does not render dtype='float64' yet")
        if self.reparam:
            check_kaux(self.reparam_kaux)

    @property
    def float_dtype(self) -> torch.dtype:
        return torch.float32

    @property
    def n_channels(self) -> int:
        """Channels a lane carries: spectral mode's 4 hero wavelengths."""
        return {"mono": 1, "rgb": 3, "spectral": 4}[self.color_mode]

    @property
    def n_image_channels(self) -> int:
        """Channels of the image: spectral develops to linear sRGB."""
        return 3 if self.color_mode == "spectral" else self.n_channels

    def replace(self, **kw) -> "RenderConfig":
        return dataclasses.replace(self, **kw)

    @property
    def variant(self) -> str:
        """The reference-style variant string of this config."""
        return (self.color_mode
                + ("_polarized" if self.polarized else "")
                + ("_double" if self.dtype == "float64" else ""))


def variants() -> tuple:
    """The JAX package's variant strings (mitsuba.variants()):
    {mono,rgb,spectral}[_polarized][_double]. The port renders the
    single-precision ones; a config of a _double one raises."""
    return tuple(mode + pol + dbl for mode in COLOR_MODES
                 for pol in ("", "_polarized") for dbl in ("", "_double"))


def parse_variant(name: str) -> dict:
    """Variant string -> RenderConfig.replace keywords (the CLI's -m).
    Raises ValueError on a name outside variants()."""
    mode, kw = name, {}
    if mode.endswith("_double"):
        mode, kw["dtype"] = mode[: -len("_double")], "float64"
    else:
        kw["dtype"] = "float32"
    if mode.endswith("_polarized"):
        mode, kw["polarized"] = mode[: -len("_polarized")], True
    else:
        kw["polarized"] = False
    if mode not in COLOR_MODES:
        raise ValueError(
            f"unknown variant {name!r}: expected "
            "{mono,rgb,spectral}[_polarized][_double]")
    kw["color_mode"] = mode
    return kw
