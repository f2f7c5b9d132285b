"""Named index-of-refraction presets (counterpart of render/ior.py).

The port's own copy of the JAX package's tables: dielectric IORs by name
(ior.h's lookup table) and conductors' complex IORs (eta, k) as
linear-sRGB triples.
"""
from __future__ import annotations

# Dielectric IORs (ior.h lookup_ior table)
DIELECTRIC_IOR = {
    "vacuum": 1.0,
    "air": 1.000277,
    "helium": 1.000036,
    "hydrogen": 1.000132,
    "carbon dioxide": 1.00045,
    "water": 1.3330,
    "acetone": 1.36,
    "ethanol": 1.361,
    "carbon tetrachloride": 1.461,
    "glycerol": 1.4729,
    "benzene": 1.501,
    "silicone oil": 1.52045,
    "bromine": 1.661,
    "water ice": 1.31,
    "fused quartz": 1.458,
    "pyrex": 1.470,
    "acrylic glass": 1.49,
    "polypropylene": 1.49,
    "bk7": 1.5046,
    "sodium chloride": 1.544,
    "amber": 1.55,
    "pet": 1.5750,
    "diamond": 2.419,
}

# Conductor complex IOR (eta, k) as linear-sRGB triples
CONDUCTOR_IOR = {
    # metal: (eta_rgb, k_rgb)
    "Au": ((0.1431, 0.3749, 1.4424), (3.9831, 2.3857, 1.6032)),
    "Ag": ((0.1552, 0.1160, 0.1383), (4.8283, 3.1222, 2.1457)),
    "Al": ((1.6574, 0.8803, 0.5212), (9.2238, 6.2694, 4.8370)),
    "Cu": ((0.2004, 0.9240, 1.1022), (3.9129, 2.4528, 2.1421)),
    "Cr": ((4.3696, 2.9167, 1.6547), (5.2068, 4.2312, 3.7549)),
    "Ni": ((2.3672, 1.6633, 1.4670), (4.4988, 3.0501, 2.3454)),
    "Hg": ((2.3989, 1.4410, 0.9087), (6.3151, 4.3623, 3.4140)),
    "TiO2": ((3.4566, 2.8017, 2.9051), (0.0001, 0.0000, 0.0000)),
    "W": ((4.3707, 3.3002, 2.9982), (3.5006, 2.6048, 2.2731)),
    # perfect mirror convention (ior.h: "none")
    "none": ((0.0, 0.0, 0.0), (1.0, 1.0, 1.0)),
}


def lookup_dielectric(name_or_value, default=1.5046):
    """A dielectric's IOR: a number as given, a name from the table, or
    `default` for None."""
    if name_or_value is None:
        return default
    if isinstance(name_or_value, (int, float)):
        return float(name_or_value)
    key = str(name_or_value).lower()
    if key not in DIELECTRIC_IOR:
        raise ValueError(f"unknown dielectric material {name_or_value!r}")
    return DIELECTRIC_IOR[key]


def lookup_conductor(name, default="Cu"):
    """A conductor's (eta, k) by name (`default` for None)."""
    key = name if name is not None else default
    if key not in CONDUCTOR_IOR:
        raise ValueError(f"unknown conductor material {key!r}")
    return CONDUCTOR_IOR[key]
