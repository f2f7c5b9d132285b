"""The port's mesh loaders (mitsuba2_tpu_torch/scene/mesh_io.py, the OBJ
parser native/obj_parser.cpp) and the shapes the loader's table needs
(disk, cylinder, flip_normals) against the JAX package's.

Each file goes through both packages' loaders, and the MeshData arrays
must be equal (dtype, shape and every value). The port's C++ OBJ parser is
held to its Python twin `_load_obj_py` as the JAX package holds its own:
the same triangle soup, normals and uvs up to the order the two number
their split vertices in (first use against sorted).
"""
import numpy as np
import pytest

from mitsuba2_tpu.scene import mesh_io as jmio
from mitsuba2_tpu.scene import shapes as jshapes
from mitsuba2_tpu_torch import native
from mitsuba2_tpu_torch.scene import mesh_io as tmio
from mitsuba2_tpu_torch.scene import shapes as tshapes

ARRAYS = ("vertices", "faces", "normals", "uvs", "sphere_center")


def assert_same_mesh(a, b):
    for k in ARRAYS:
        x, y = getattr(a, k), getattr(b, k)
        assert (x is None) == (y is None), k
        if x is not None:
            x, y = np.asarray(x), np.asarray(y)
            assert x.dtype == y.dtype and x.shape == y.shape, k
            assert np.array_equal(x, y), k
    for k in ("sphere_radius", "sphere_flip", "id", "bsdf", "emitter"):
        assert getattr(a, k) == getattr(b, k), k


def _obj(path, with_n=True, with_uv=True):
    """A displaced quad grid as OBJ: v/vt/vn corners, a quad fan per cell
    written with negative indices on odd rows, shared and split vertices,
    comments and blank lines."""
    rng = np.random.default_rng(5)
    n = 4
    lines = ["# grid", ""]
    for j in range(n + 1):
        for i in range(n + 1):
            z = rng.uniform(-0.1, 0.1)
            lines.append(f"v {i / n:.9g} {j / n:.9g} {z:.9g}")
            lines.append(f"vt {i / n:.9g} {j / n:.9g}")
    lines += ["vn 0 0 1", "vn 0.1 0.2 0.97"]
    nv = (n + 1) ** 2
    for j in range(n):
        for i in range(n):
            corners = [j * (n + 1) + i, j * (n + 1) + i + 1,
                       (j + 1) * (n + 1) + i + 1, (j + 1) * (n + 1) + i]
            toks = []
            for c in corners:
                vi = c + 1 if j % 2 == 0 else c - nv   # 1-based or negative
                tok = str(vi)
                if with_uv or with_n:
                    tok += "/" + (str(vi) if with_uv else "")
                if with_n:
                    tok += f"/{1 + (i + j) % 2}"
                toks.append(tok)
            lines.append("f " + " ".join(toks))
    with open(path, "w") as f:
        f.write("\n".join(lines) + "\n")


@pytest.mark.parametrize("attrs", ["v", "v/vt", "v//vn", "v/vt/vn"])
@pytest.mark.parametrize("flip", [True, False])
def test_obj_matches_jax(tmp_path, attrs, flip):
    """load_obj (native parser) and _load_obj_py each equal to the JAX
    package's, and the native parser to its Python twin."""
    p = str(tmp_path / "g.obj")
    _obj(p, with_n="vn" in attrs, with_uv="vt" in attrs)
    kw = dict(flip_tex_coords=flip, id="g", bsdf={"type": "diffuse"})
    m_t, m_j = tmio.load_obj(p, **kw), jmio.load_obj(p, **kw)
    assert_same_mesh(m_t, m_j)
    py_t, py_j = tmio._load_obj_py(p, **kw), jmio._load_obj_py(p, **kw)
    assert_same_mesh(py_t, py_j)
    # the native parse (not the fallback) and its twin: one soup
    verts, faces, normals, uvs = native.parse_obj_native(p, flip)
    assert np.array_equal(m_t.vertices, verts)
    assert np.array_equal(m_t.faces, faces)
    assert faces.shape == py_t.faces.shape == (32, 3)
    assert np.array_equal(verts[faces], py_t.vertices[py_t.faces])
    for a, b in ((normals, py_t.normals), (uvs, py_t.uvs)):
        assert (a is None) == (b is None)
        if a is not None:
            np.testing.assert_allclose(a[faces], b[py_t.faces], rtol=0,
                                       atol=1e-7)
    assert (normals is not None) == ("vn" in attrs)
    assert (uvs is not None) == ("vt" in attrs)


def test_obj_face_normals_and_fan(tmp_path):
    p = str(tmp_path / "q.obj")
    with open(p, "w") as f:
        f.write("v 0 0 0\nv 1 0 0\nv 1 1 0\nv 0 1 0\nv 0.5 1.5 0\n"
                "vn 0 0 1\nf -5//1 -4//1 -3//1 -1//1 -2//1\n")
    for fn in ("load_obj", "_load_obj_py"):
        a = getattr(tmio, fn)(p, face_normals=True)
        b = getattr(jmio, fn)(p, face_normals=True)
        assert_same_mesh(a, b)
        assert a.normals is None and a.faces.shape == (3, 3)


@pytest.mark.parametrize("fmt", ["ascii", "binary_little_endian",
                                 "binary_big_endian"])
@pytest.mark.parametrize("arity", ["tri", "quad", "mixed"])
def test_ply_matches_jax(tmp_path, fmt, arity):
    """PLY in ASCII and binary of both byte orders, with normals and uvs,
    triangles (the binary fast path), quads and mixed rows."""
    rng = np.random.default_rng(9)
    nv = 24
    v = rng.normal(size=(nv, 3)).astype(np.float32)
    nrm = rng.normal(size=(nv, 3)).astype(np.float32)
    uv = rng.uniform(size=(nv, 2)).astype(np.float32)
    k = {"tri": [3] * 10, "quad": [4] * 10, "mixed": [3, 4] * 5}[arity]
    rows = [rng.integers(0, nv, c) for c in k]
    names = ["x", "y", "z", "nx", "ny", "nz", "s", "t"]
    hdr = (f"ply\nformat {fmt} 1.0\ncomment made by a test\n"
           f"element vertex {nv}\n"
           + "".join(f"property float {a}\n" for a in names)
           + f"element face {len(rows)}\n"
           "property list uchar int vertex_indices\nend_header\n")
    vals = np.concatenate([v, nrm, uv], -1)
    p = str(tmp_path / "m.ply")
    with open(p, "wb") as f:
        f.write(hdr.encode())
        if fmt == "ascii":
            for r in vals:
                f.write((" ".join(f"{x:.9g}" for x in r) + "\n").encode())
            for r in rows:
                f.write((f"{len(r)} " + " ".join(map(str, r)) + "\n").encode())
        else:
            e = "<" if fmt.endswith("little_endian") else ">"
            f.write(vals.astype(e + "f4").tobytes())
            for r in rows:
                f.write(bytes([len(r)]) + np.asarray(r, e + "i4").tobytes())
    for fn in (tmio.load_ply, tmio.load_mesh):
        a = fn(p, id="m")
        b = getattr(jmio, fn.__name__)(p, id="m")
        assert_same_mesh(a, b)
    assert np.array_equal(a.vertices, v) and np.array_equal(a.uvs, uv)
    assert a.faces.shape == (sum(c - 2 for c in k), 3)
    assert_same_mesh(tmio.load_ply(p, face_normals=True),
                     jmio.load_ply(p, face_normals=True))


@pytest.mark.parametrize("writer", ["port", "jax"])
def test_serialized_round_trip(tmp_path, writer):
    """save_serialized by either package, the same bytes, read by both."""
    cube = tshapes.cube()
    wt, wj = str(tmp_path / "t.serialized"), str(tmp_path / "j.serialized")
    tmio.save_serialized(wt, cube, name="cube")
    jmio.save_serialized(wj, jshapes.cube(), name="cube")
    with open(wt, "rb") as f, open(wj, "rb") as g:
        assert f.read() == g.read()
    p = wt if writer == "port" else wj
    a, b = tmio.load_serialized(p), jmio.load_serialized(p)
    assert_same_mesh(a, b)
    assert a.id == "cube" and np.array_equal(a.vertices, cube.vertices)
    assert np.array_equal(a.faces, cube.faces)
    assert_same_mesh(tmio.load_mesh(p, id="x", face_normals=True),
                     jmio.load_mesh(p, id="x", face_normals=True))


def test_load_mesh_refuses_other_formats(tmp_path):
    for mod in (tmio, jmio):
        with pytest.raises(ValueError, match=r"unsupported mesh format \.stl"):
            mod.load_mesh(str(tmp_path / "m.stl"))


@pytest.mark.parametrize("make", ["disk", "cylinder", "rectangle", "cube",
                                  "sphere"])
def test_shapes_and_flipped_match_jax(make):
    """The loader's shape table: each constructor and its flip_normals,
    and both after a transform, equal to the JAX package's."""
    kw = {"cylinder": dict(radius=0.7, length=2.0, segments=12),
          "disk": dict(segments=9),
          "sphere": dict(center=(1, 2, 3), radius=0.5)}.get(make, {})
    a = getattr(tshapes, make)(id="s", **kw)
    b = getattr(jshapes, make)(id="s", **kw)
    assert_same_mesh(a, b)
    assert_same_mesh(a.flipped(), b.flipped())
    assert_same_mesh(a.flipped().flipped(), b)
    mat = np.array([[0, -2, 0, 1], [2, 0, 0, 0], [0, 0, 2, 3], [0, 0, 0, 1]],
                   np.float32)
    assert_same_mesh(a.flipped().transformed(mat),
                     b.flipped().transformed(mat))
    if make == "sphere":
        assert a.flipped().sphere_flip and not a.sphere_flip
    else:
        assert np.array_equal(a.flipped().faces, a.faces[:, [0, 2, 1]])
