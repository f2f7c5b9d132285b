"""Scene loaders: Mitsuba XML and python dicts -> SceneData + RenderConfig
(the port's own copy of the JAX package's scene/loader.py).

Counterpart of mitsuba2's scene loading layer (src/libcore/xml.cpp ::
xml::load_file/load_string + the dict loader): parsing produces the same
descriptor dicts and MeshData the JAX package's loader does, and the
port's build_scene packs them on the device asked for (the CUDA device
unless `device` names another). A BSDF type registered with
render/bsdf.py::register_bsdf loads as a built-in one does.

Supported XML surface (the subset exercised by mitsuba's test scenes):
- tags: scene, shape, bsdf, emitter, sensor, film, sampler, integrator,
  texture, ref, default, include, alias, + property tags (float/integer/
  boolean/string/rgb/spectrum/point/vector/transform/volume)
- transform children: translate, rotate, scale, matrix, lookat
- `$var` parameter substitution (CLI -D flags) and <default> declarations
- version upgrades for pre-2.0 scenes (camelCase props, <lookAt>)
"""
from __future__ import annotations

import os
import re
import xml.etree.ElementTree as ET
from typing import Dict, List, Optional, Tuple

import numpy as np

from ..config import RenderConfig
from ..core.geometry import Transform4
from . import mesh_io, shapes as shapes_mod
from .scene import SceneData, build_scene


# ---------------------------------------------------------------------------
# Value parsing helpers
# ---------------------------------------------------------------------------

def _parse_vec(s: str) -> np.ndarray:
    parts = re.split(r"[,\s]+", s.strip())
    vals = [float(p) for p in parts if p]
    if len(vals) == 1:
        vals = vals * 3
    return np.asarray(vals, np.float32)


def _subst(value: str, params: Dict[str, str]) -> str:
    """`$name` substitution (xml.cpp's parameter mechanism)."""
    def repl(mt):
        name = mt.group(1)
        if name not in params:
            raise ValueError(f"undefined parameter ${name}")
        return str(params[name])
    return re.sub(r"\$(\w+)", repl, value)


def _attr(node, name, params, default=None):
    v = node.get(name)
    if v is None:
        return default
    return _subst(v, params)


# ---------------------------------------------------------------------------
# Transform accumulation (xml.cpp's <transform> handler)
# ---------------------------------------------------------------------------

def _parse_transform(node, params) -> np.ndarray:
    t = Transform4.identity()
    for child in node:
        tag = child.tag
        if tag == "translate":
            vec = _xyz_attrs(child, params, default=0.0)
            step = Transform4.translate(vec)
        elif tag == "scale":
            v = _attr(child, "value", params)
            if v is not None:
                vec = _parse_vec(v)
            else:
                vec = _xyz_attrs(child, params, default=1.0)
            step = Transform4.scale(vec)
        elif tag == "rotate":
            axis = _xyz_attrs(child, params, default=0.0)
            angle = float(_attr(child, "angle", params, "0"))
            step = Transform4.rotate(axis, angle)
        elif tag == "matrix":
            vals = _parse_vec(_attr(child, "value", params))
            if vals.size == 9:
                mat = np.eye(4, dtype=np.float32)
                mat[:3, :3] = vals.reshape(3, 3)
            else:
                mat = vals.reshape(4, 4)
            step = Transform4.from_matrix(mat)
        elif tag == "lookat":
            step = Transform4.look_at(
                origin=_parse_vec(_attr(child, "origin", params)),
                target=_parse_vec(_attr(child, "target", params)),
                up=_parse_vec(_attr(child, "up", params, "0 1 0")))
        else:
            raise ValueError(f"unknown transform op <{tag}>")
        t = step @ t  # sequential application: later ops post-multiply
    return np.asarray(t.matrix, np.float32)


def _read_spd(path: str):
    """Two-column spectral-data text file (wavelength_nm value per line,
    '#' comments) — the reference's .spd format (resources/data/ior)."""
    wls, vals = [], []
    with open(path) as f:
        for line in f:
            line = line.split("#", 1)[0].strip()
            if not line:
                continue
            a, b = line.split()[:2]
            wls.append(float(a))
            vals.append(float(b))
    return wls, vals


def _xyz_attrs(node, params, default: float) -> np.ndarray:
    v = _attr(node, "value", params)
    if v is not None:
        return _parse_vec(v)
    return np.asarray([float(_attr(node, k, params, default))
                       for k in ("x", "y", "z")], np.float32)


# ---------------------------------------------------------------------------
# Property collection: child tags -> descriptor dict entries
# ---------------------------------------------------------------------------

def _collect_props(node, ctx) -> dict:
    """Parse property/child-object tags of an XML node into a dict."""
    props: dict = {}
    for child in node:
        tag = child.tag
        name = _attr(child, "name", ctx.params)
        if tag == "float":
            props[name] = float(_attr(child, "value", ctx.params))
        elif tag == "integer":
            props[name] = int(_attr(child, "value", ctx.params))
        elif tag == "boolean":
            props[name] = _attr(child, "value", ctx.params).lower() == "true"
        elif tag == "string":
            props[name] = _attr(child, "value", ctx.params)
        elif tag == "rgb":
            props[name] = _parse_vec(_attr(child, "value", ctx.params)).tolist()
        elif tag == "spectrum":
            fn = _attr(child, "filename", ctx.params)
            if fn:
                # .spd file (two-column "wavelength value" text, the
                # reference's resources/data/ior format) -> irregular
                # spectrum dict, exact CIE projection in pack_color
                wls, vals = _read_spd(ctx.resolve(fn))
                props[name] = {"type": "irregular",
                               "wavelengths": wls, "values": vals}
            else:
                v = _attr(child, "value", ctx.params)
                if ":" in v:
                    # "400:0.1, 500:0.2" wavelength:value pairs
                    pairs = [p.split(":")
                             for p in re.split(r"[,\s]+", v) if ":" in p]
                    props[name] = {
                        "type": "irregular",
                        "wavelengths": [float(a) for a, _ in pairs],
                        "values": [float(b) for _, b in pairs]}
                else:
                    props[name] = [float(v)] * 3
        elif tag in ("point", "vector"):
            props[name] = _xyz_attrs(child, ctx.params, 0.0).tolist()
        elif tag == "transform":
            props[name] = _parse_transform(child, ctx.params)
        elif tag == "texture":
            props[name] = _parse_texture(child, ctx)
        elif tag == "volume":
            # src/media XML: <volume name="density" type="gridvolume">
            # (a .vol file, resolved) or type="constvolume" (a value)
            vtype = _attr(child, "type", ctx.params)
            vprops = _collect_props(child, ctx)
            if vtype == "gridvolume":
                props[name] = ctx.resolve(vprops["filename"])
            elif vtype == "constvolume":
                props[name] = vprops.get("value", 1.0)
            else:
                raise ValueError(f"unknown volume type {vtype!r}")
        elif tag == "ref":
            rid = _attr(child, "id", ctx.params)
            if rid not in ctx.refs:
                raise ValueError(f"<ref id={rid!r}>: undefined reference")
            props[name or "bsdf"] = ctx.refs[rid]
        elif tag in ("bsdf", "emitter", "film", "sampler", "integrator",
                     "shape", "default", "include", "phase", "medium"):
            pass  # handled by the caller / top level
        else:
            raise ValueError(f"unknown property tag <{tag}>")
    return props


def _parse_texture(node, ctx) -> dict:
    ttype = _attr(node, "type", ctx.params)
    props = _collect_props(node, ctx)
    desc = {"type": ttype, **props}
    tid = node.get("id")
    if tid:
        desc["id"] = tid
        ctx.refs[tid] = desc
    return desc


def _parse_bsdf(node, ctx) -> dict:
    btype = _attr(node, "type", ctx.params)
    props = _collect_props(node, ctx)
    children = [c for c in node if c.tag == "bsdf"]
    if children:
        if btype in ("twosided", "mask"):
            props["bsdf"] = _parse_bsdf(children[0], ctx)
        elif btype in ("blendbsdf", "blend"):
            props["bsdfs"] = [_parse_bsdf(c, ctx) for c in children]
        else:
            props["bsdf"] = _parse_bsdf(children[0], ctx)
    desc = {"type": btype, **props}
    bid = node.get("id")
    if bid:
        desc["id"] = bid
        ctx.refs[bid] = desc
    return desc


def _parse_emitter(node, ctx) -> dict:
    etype = _attr(node, "type", ctx.params)
    props = _collect_props(node, ctx)
    if "filename" in props:
        props["filename"] = ctx.resolve(props["filename"])
    return {"type": etype, **props}


_ANALYTIC_SHAPES = {"rectangle", "cube", "disk", "sphere", "cylinder"}


def _parse_shape(node, ctx) -> shapes_mod.MeshData:
    stype = _attr(node, "type", ctx.params)
    props = _collect_props(node, ctx)
    bsdf = props.get("bsdf")
    emitter = None
    interior = None
    for c in node:
        if c.tag == "emitter":
            emitter = _parse_emitter(c, ctx)
        elif c.tag == "bsdf":
            # inline child bsdf (the common scene idiom) — overrides a
            # <ref name="bsdf"> if both are present
            bsdf = _parse_bsdf(c, ctx)
        elif c.tag == "medium":
            if _attr(c, "name", ctx.params, "interior") == "interior":
                mprops = _collect_props(c, ctx)
                interior = {"type": _attr(c, "type", ctx.params), **mprops}
                for pc in c:
                    if pc.tag == "phase":
                        php = _collect_props(pc, ctx)
                        if _attr(pc, "type", ctx.params) == "hg":
                            interior["g"] = float(php.get("g", 0.0))
    sid = node.get("id") or props.get("id", "")

    if stype == "shapegroup":
        # shapegroup (src/shapes/shapegroup.cpp): a named collection of
        # child shapes, emitted only through <instance> references
        group = []
        for c in node:
            if c.tag == "shape":
                sub = _parse_shape(c, ctx)
                group.extend(sub if isinstance(sub, list) else [sub])
        # stored as a TUPLE: instance() passes tuples through unchanged,
        # so every <instance> of this group shares ONE handle identity
        # (the key build_scene dedupes BLASes by)
        ctx.refs[sid or node.get("id", "")] = ("shapegroup", tuple(group))
        return []
    if stype == "instance":
        # instance (src/shapes/instance.cpp): SHARED-BLAS instancing —
        # every instance of a shapegroup references the group's geometry
        # once (one BLAS; the traversal kernels re-derive rays at
        # instance boundaries — the OptiX-IAS design, bvh.py::
        # build_two_level). Set MI_FLATTEN_INSTANCES=1 to restore the
        # round-2 flattening (duplicated, transformed prim records).
        ref_id = None
        for c in node:
            if c.tag == "ref":
                ref_id = c.get("id")
        entry = ctx.refs.get(ref_id)
        if not (isinstance(entry, tuple) and entry[0] == "shapegroup"):
            raise ValueError(f"instance references unknown shapegroup {ref_id!r}")
        flatten = os.environ.get("MI_FLATTEN_INSTANCES", "0").lower() \
            in ("1", "true")
        return shapes_mod.instance(entry[1], props.get("to_world"),
                                   id=sid or ref_id, flatten=flatten)

    if stype in ("obj", "ply", "serialized"):
        path = ctx.resolve(props["filename"])
        kw = {}
        if stype == "serialized":
            kw["shape_index"] = int(props.get("shape_index", 0))
        mesh = mesh_io.load_mesh(path, bsdf=bsdf, emitter=emitter, id=sid,
                                 face_normals=bool(props.get("face_normals",
                                                             False)), **kw)
    elif stype == "sphere":
        mesh = shapes_mod.sphere(center=props.get("center", [0, 0, 0]),
                                 radius=float(props.get("radius", 1.0)),
                                 bsdf=bsdf, emitter=emitter, id=sid)
    elif stype == "rectangle":
        mesh = shapes_mod.rectangle(bsdf=bsdf, emitter=emitter, id=sid)
    elif stype == "cube":
        mesh = shapes_mod.cube(bsdf=bsdf, emitter=emitter, id=sid)
    elif stype == "disk":
        mesh = shapes_mod.disk(bsdf=bsdf, emitter=emitter, id=sid)
    elif stype == "cylinder":
        mesh = shapes_mod.cylinder(
            radius=float(props.get("radius", 1.0)), bsdf=bsdf,
            emitter=emitter, id=sid)
    else:
        raise ValueError(f"unknown shape type {stype!r}")

    if props.get("flip_normals", False):
        mesh = mesh.flipped()
    if "to_world" in props:
        mesh = mesh.transformed(props["to_world"])
    mesh.interior = interior
    return mesh


SENSOR_TYPES = ("perspective", "thinlens", "orthographic", "radiancemeter",
                "irradiancemeter", "distant")


def _finish_sensor(stype: str, props: dict, film: dict, sampler: dict
                   ) -> Tuple[dict, dict]:
    """Shared XML/dict sensor assembly: film/sampler overrides + the
    fov_axis -> x-fov conversion (perspective.cpp) + clip/shutter props."""
    sensor = {"type": stype,
              "to_world": np.asarray(
                  props.get("to_world", np.eye(4)), np.float32)}
    if "direction" in props:
        sensor["direction"] = props["direction"]
    for k in ("aperture_radius", "focus_distance", "near_clip", "far_clip",
              "shutter_open", "shutter_close"):
        if k in props:
            sensor[k] = float(props[k])
    overrides = {}
    if film:
        overrides["width"] = int(film.get("width", 256))
        overrides["height"] = int(film.get("height", 256))
        if film.get("rfilter"):
            overrides["rfilter"] = film["rfilter"]
    if sampler:
        overrides["spp"] = int(sampler.get("sample_count", 64))
        styp = sampler.get("type", "independent")
        if styp in ("independent", "stratified", "ldsampler", "halton"):
            overrides["sampler"] = styp

    # fov_axis: the declared fov applies to the named film axis;
    # internally everything is x-fov (needs the film dims)
    fov = float(props.get("fov", 45.0))
    axis = str(props.get("fov_axis", "x"))
    w = float(overrides.get("width", 256))
    h = float(overrides.get("height", 256))
    if axis in ("smaller", "larger"):
        axis = ("y" if (h < w) == (axis == "smaller") else "x")
    t = np.tan(np.deg2rad(fov) * 0.5)
    if axis == "y":
        t *= w / h
    elif axis == "diagonal":
        t *= w / np.hypot(w, h)
    elif axis != "x":
        raise ValueError(f"unknown fov_axis {axis!r}")
    sensor["fov"] = float(np.rad2deg(2.0 * np.arctan(t)))
    return sensor, overrides


def _parse_sensor(node, ctx) -> Tuple[dict, dict]:
    """Returns (sensor dict, config overrides from film/sampler)."""
    props = _collect_props(node, ctx)
    film = sampler = None
    for c in node:
        if c.tag == "film":
            film = _collect_props(c, ctx)
            film.setdefault("width", 256)
            film.setdefault("height", 256)
            for rc in c:
                if rc.tag == "rfilter":
                    film["rfilter"] = _attr(rc, "type", ctx.params)
        elif c.tag == "sampler":
            sampler = _collect_props(c, ctx)
            sampler["type"] = _attr(c, "type", ctx.params, "independent")
    return _finish_sensor(_attr(node, "type", ctx.params, "perspective"),
                          props, film, sampler)


class _Ctx:
    def __init__(self, params: Dict[str, str], base_dir: str):
        self.params = dict(params)
        self.base_dir = base_dir
        self.refs: Dict[str, dict] = {}

    def resolve(self, path: str) -> str:
        """FileResolver: scene-relative asset paths (fresolver.cpp)."""
        if os.path.isabs(path) or not self.base_dir:
            return path
        cand = os.path.join(self.base_dir, path)
        return cand if os.path.exists(cand) else path


def load_string(xml: str, base_dir: str = "",
                **params) -> Tuple[SceneData, RenderConfig]:
    """xml::load_string — parse scene XML text. Keywords substitute `$var`
    parameters but for two reserved ones: `sensor_index` (which <sensor>
    to render) and `device` (where the scene is built: None = the CUDA
    device, raising without one; "cpu" for the CPU)."""
    root = ET.fromstring(xml)
    return _load_root(root, base_dir, params)


def load_file(path: str, **params) -> Tuple[SceneData, RenderConfig]:
    """xml::load_file — parse a scene XML file (with <include> support).
    Keywords as load_string's: `$var` values, and the reserved
    `sensor_index` and `device`."""
    tree = ET.parse(path)
    return _load_root(tree.getroot(), os.path.dirname(os.path.abspath(path)),
                      params)


def _camel_to_snake(name: str) -> str:
    out = []
    for ch in name:
        if ch.isupper():
            out.append("_")
            out.append(ch.lower())
        else:
            out.append(ch)
    return "".join(out)


def _upgrade_tree(root) -> None:
    """Version upgrades (xml.cpp::upgrade_tree): scenes declaring
    version < 2.0 use Mitsuba 0.5/0.6 conventions — camelCase property
    names (`toWorld`, `filterType`, `fov_axis` as `fovAxis`, `lookAt`
    tags) are rewritten in place to the 2.x snake_case forms. 2.x files
    pass through untouched."""
    ver = root.get("version", "2.0.0")
    try:
        major = int(str(ver).split(".")[0])
    except ValueError:
        major = 2
    if major >= 2:
        return
    for node in root.iter():
        if node.tag == "lookAt":
            node.tag = "lookat"
        n = node.get("name")
        if n and any(c.isupper() for c in n):
            node.set("name", _camel_to_snake(n))
    root.set("version", "2.0.0")


def _integrator_props(ip: dict, overrides: dict) -> None:
    """Shared MonteCarloIntegrator properties -> RenderConfig overrides."""
    if "max_depth" in ip:
        md = int(ip["max_depth"])
        overrides["max_depth"] = md if md > 0 else 16
    if "rr_depth" in ip:
        overrides["rr_depth"] = int(ip["rr_depth"])
    if "hide_emitters" in ip:
        overrides["hide_emitters"] = bool(ip["hide_emitters"])


def _load_root(root, base_dir, params) -> Tuple[SceneData, RenderConfig]:
    if root.tag != "scene":
        raise ValueError(f"expected <scene>, got <{root.tag}>")
    _upgrade_tree(root)
    params = dict(params)
    sel_sensor = params.pop("sensor_index", 0)  # reserved, not a $var
    device = params.pop("device", None)         # reserved, not a $var
    ctx = _Ctx({k: str(v) for k, v in params.items()}, base_dir)

    # pass 1: defaults (may be overridden by caller params)
    for node in root:
        if node.tag == "default":
            name = node.get("name")
            if name not in ctx.params:
                ctx.params[name] = node.get("value")

    # expand includes inline
    nodes = []
    for node in root:
        if node.tag == "include":
            inc = ET.parse(ctx.resolve(_attr(node, "filename", ctx.params)))
            nodes.extend(list(inc.getroot()))
        else:
            nodes.append(node)

    shape_list: List[shapes_mod.MeshData] = []
    emitters: List[dict] = []
    sensors: List[tuple] = []
    overrides: dict = {}

    for node in nodes:
        tag = node.tag
        if tag == "bsdf":
            _parse_bsdf(node, ctx)  # registers id for later <ref>
        elif tag == "texture":
            _parse_texture(node, ctx)
        elif tag == "alias":
            # xml.cpp: <alias id="existing" as="new"/> re-registers a
            # named object under a second id
            src = _attr(node, "id", ctx.params)
            if src not in ctx.refs:
                raise ValueError(f"<alias id={src!r}>: undefined reference")
            ctx.refs[_attr(node, "as", ctx.params)] = ctx.refs[src]
        elif tag == "shape":
            sh = _parse_shape(node, ctx)
            shape_list.extend(sh if isinstance(sh, list) else [sh])
        elif tag == "emitter":
            emitters.append(_parse_emitter(node, ctx))
        elif tag == "sensor":
            sensors.append(_parse_sensor(node, ctx))
        elif tag == "integrator":
            ityp = _attr(node, "type", ctx.params, "path")
            known = ("path", "volpath", "volpathmis", "direct", "depth",
                     "aov", "moment", "stokes")
            if ityp not in known:
                # unported plugin (ptracer, photonmapper, ...): render
                # with the path tracer rather than refusing the scene
                import logging
                logging.getLogger("mitsuba2_tpu_torch").warning(
                    "integrator %r not available; falling back to 'path'",
                    ityp)
                ityp = "path"
            if ityp in ("aov", "stokes", "moment"):
                # wrapper integrators: nested child sets the transport
                overrides["integrator"] = ityp
                for c in node:
                    if c.tag == "integrator":
                        cp = _collect_props(c, ctx)
                        ctyp = _attr(c, "type", ctx.params, "path")
                        if ityp == "aov" and ctyp in (
                                "path", "volpath", "volpathmis", "direct",
                                "moment", "stokes"):
                            overrides["aov_child"] = ctyp
                        _integrator_props(cp, overrides)
                ip = _collect_props(node, ctx)
                if ityp == "aov" and "aovs" in ip:
                    # "name:type, name2:type2" (src/integrators/aov.cpp)
                    overrides["aovs"] = tuple(
                        p.split(":")[-1].strip()
                        for p in str(ip["aovs"]).split(",") if p.strip())
            else:
                if ityp not in ("path",):
                    overrides["integrator"] = ityp
                _integrator_props(_collect_props(node, ctx), overrides)
        elif tag == "default":
            pass
        else:
            raise ValueError(f"unknown top-level tag <{tag}>")

    # sensor selection (Scene holds a sensor LIST in the reference;
    # render uses sensors[0] unless told otherwise). Reserved loader
    # param `sensor_index` picks another one: load_file(p, sensor_index=1)
    if sensors:
        idx = int(sel_sensor)
        if not 0 <= idx < len(sensors):
            raise ValueError(f"sensor_index {idx} out of range "
                             f"({len(sensors)} sensors)")
        sensor, sensor_overrides = sensors[idx]
        overrides.update(sensor_overrides)
    else:
        sensor = {"type": "perspective",
                  "to_world": np.eye(4, dtype=np.float32), "fov": 45.0}
    # the config first: a bad value raises before the build
    config = RenderConfig(**overrides)
    scene = build_scene(shape_list, sensor, emitters=emitters, device=device)
    return scene, config


# ---------------------------------------------------------------------------
# Dict loader (mitsuba.load_dict)
# ---------------------------------------------------------------------------

def _dict_shape(name, obj, refs):
    """One shape dict -> MeshData (shared by load_dict's shape and
    shapegroup branches)."""
    t = obj.get("type")
    bsdf = obj.pop("bsdf", None)
    if isinstance(bsdf, str):  # reference by name
        bsdf = refs[bsdf]
    emitter = obj.pop("emitter", None)
    interior = obj.pop("interior", None)
    to_world = obj.pop("to_world", None)
    if t in ("obj", "ply", "serialized"):
        kw = {}
        if t == "serialized":
            kw["shape_index"] = int(obj.get("shape_index", 0))
        mesh = mesh_io.load_mesh(obj["filename"], bsdf=bsdf,
                                 emitter=emitter, id=name, **kw)
    elif t == "sphere":
        mesh = shapes_mod.sphere(center=obj.get("center", [0, 0, 0]),
                                 radius=float(obj.get("radius", 1.0)),
                                 bsdf=bsdf, emitter=emitter, id=name)
    elif t in ("rectangle", "cube", "disk", "cylinder"):
        mesh = getattr(shapes_mod, t)(bsdf=bsdf, emitter=emitter, id=name)
    else:
        raise ValueError(f"unknown object type {t!r} for {name!r}")
    if obj.get("flip_normals", False):
        mesh = mesh.flipped()
    if to_world is not None:
        mesh = mesh.transformed(np.asarray(to_world, np.float32))
    mesh.interior = interior
    return mesh


def load_dict(d: dict, device=None) -> Tuple[SceneData, RenderConfig]:
    """load_dict: {"type": "scene", <name>: {"type": ...}, ...}, built on
    `device` (None = the CUDA device, raising without one).

    Object dicts use the same property names as XML; shapes may embed
    "bsdf"/"emitter" sub-dicts. Every BSDF name the JAX package knows is
    a BSDF here.
    """
    if d.get("type") != "scene":
        raise ValueError('top-level dict must have type "scene"')
    shape_list, emitters = [], []
    sensor = None
    overrides: dict = {}
    refs: Dict[str, dict] = {}
    from ..render import bsdf as bsdf_mod

    bsdf_types = set(bsdf_mod._BY_NAME) | {"twosided"}
    emitter_types = {"area", "point", "constant", "envmap", "spot",
                     "directional", "projector"}
    integrator_types = {"path", "volpath", "volpathmis", "direct", "depth",
                        "aov", "moment", "stokes"}
    for name, obj in d.items():
        if name == "type":
            continue
        t = obj.get("type")
        if t in bsdf_types:
            refs[name] = obj
        elif t in emitter_types:
            emitters.append(obj)
        elif t in SENSOR_TYPES:
            props = dict(obj)
            film = props.pop("film", None)
            smp = props.pop("sampler", None)
            sensor, s_over = _finish_sensor(t, props, film, smp)
            overrides.update(s_over)
        elif t in integrator_types:
            if t != "path":
                overrides["integrator"] = t
            if t == "aov" and "aovs" in obj:
                overrides["aovs"] = tuple(
                    p.split(":")[-1].strip()
                    for p in str(obj["aovs"]).split(",") if p.strip())
            _integrator_props(obj, overrides)
        elif t == "shapegroup":
            # named group of child shape dicts (xml <shape type=
            # "shapegroup">): children are the non-"type" values
            grp = [_dict_shape(cname, dict(cobj), refs)
                   for cname, cobj in obj.items() if cname != "type"]
            refs[name] = ("shapegroup", shapes_mod.shapegroup(grp, id=name))
        elif t == "instance":
            entry = refs.get(obj.get("shapegroup"))
            if not (isinstance(entry, tuple) and entry[0] == "shapegroup"):
                raise ValueError(
                    f"instance {name!r} references unknown shapegroup "
                    f"{obj.get('shapegroup')!r}")
            got = shapes_mod.instance(
                entry[1], obj.get("to_world"), id=name,
                flatten=os.environ.get("MI_FLATTEN_INSTANCES", "0").lower()
                in ("1", "true"))
            shape_list.extend(got if isinstance(got, list) else [got])
        else:  # shape
            shape_list.append(_dict_shape(name, dict(obj), refs))
    if sensor is None:
        sensor = {"type": "perspective",
                  "to_world": np.eye(4, dtype=np.float32), "fov": 45.0}
    config = RenderConfig(**overrides)
    return build_scene(shape_list, sensor, emitters=emitters,
                       device=device), config
