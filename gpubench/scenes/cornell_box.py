"""The Cornell box as the port's `presets.cornell_box()` approximates it
(the repository's BASELINE configs 1 and 4): a unit box of its own
values, not those of Mitsuba's `cbox` file, with its ceiling light as
two one-triangle emitters (_geometry.quad_light).
"""
from __future__ import annotations

from . import _geometry as g

WHITE = [0.730, 0.735, 0.729]
RED = [0.611, 0.0555, 0.062]
GREEN = [0.117, 0.449, 0.115]
LIGHT = [18.4, 15.6, 8.0]


def build(boxes: bool = True) -> dict:
    s = [
        g.quad([0, 0, 0], [0, 0, 1], [1, 0, 1], [1, 0, 0], WHITE, "floor"),
        g.quad([0, 1, 0], [1, 1, 0], [1, 1, 1], [0, 1, 1], WHITE, "ceiling"),
        g.quad([0, 0, 1], [0, 1, 1], [1, 1, 1], [1, 0, 1], WHITE, "back"),
        g.quad([1, 0, 0], [1, 0, 1], [1, 1, 1], [1, 1, 0], RED, "left"),
        g.quad([0, 0, 0], [0, 1, 0], [0, 1, 1], [0, 0, 1], GREEN, "right"),
    ]
    lx0, lx1, lz0, lz1, ly = 0.37, 0.63, 0.40, 0.61, 0.9995
    s += g.quad_light([lx0, ly, lz0], [lx1, ly, lz0], [lx1, ly, lz1],
                      [lx0, ly, lz1], WHITE, LIGHT, "light")
    if boxes:
        t_tall = (g.translate([0.66, 0.30, 0.65]) @ g.rotate([0, 1, 0], 17.0)
                  @ g.scale([0.15, 0.30, 0.15]))
        s.append(g.cube(t_tall, WHITE, "tall_box"))
        t_short = (g.translate([0.33, 0.15, 0.35])
                   @ g.rotate([0, 1, 0], -18.0) @ g.scale([0.15, 0.15, 0.15]))
        s.append(g.cube(t_short, WHITE, "short_box"))
    cam = g.look_at(origin=[0.5, 0.5, -1.39], target=[0.5, 0.5, 0.5],
                    up=[0, 1, 0])
    return {"shapes": s, "camera": {"to_world": cam, "fov": 39.5}}
