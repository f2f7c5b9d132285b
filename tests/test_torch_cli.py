"""The port's command line (`python -m mitsuba2_tpu_torch`, cli.py) and
its variant switcher, on the CPU.

The CLI given `--device cpu` writes the image of the in-process
load_file + render_any of the same scene at the same seed, bit for bit
(a PFM keeps float32); without a CUDA device and without that flag it
exits non-zero. Its flags are the JAX package's: a bad `-m` exits through
argparse, `-s` overrides the samples, `-D` substitutes parameters; a
polarized variant, and the stokes integrator, write S0 as the image and
the other Stokes components beside it (`_s1.exr` to `_s3.exr`); a
double variant writes the float64 render (rounded to the PFM's float32).
"""
import os
import subprocess
import sys

import numpy as np
import pytest
import torch

import mitsuba2_tpu_torch as mt
from mitsuba2_tpu_torch import cli

import test_cli

# one intra-op thread: the suite's test processes share the cores
# (pytest-xdist), and torch's OpenMP regions stall when they
# oversubscribe them
torch.set_num_threads(1)

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
# the JAX CLI test's scene, its sample count a parameter and its camera
# on the lit side of the light (the JAX test's sees its back: black)
XML = test_cli.XML.replace('name="sample_count" value="4"',
                           'name="sample_count" value="$spp"').replace(
    'origin="0,0,-3"', 'origin="0.3,0.2,3"').replace(
    "<scene version=\"2.0.0\">",
    "<scene version=\"2.0.0\">\n  <default name=\"spp\" value=\"4\"/>")


@pytest.fixture(scope="module")
def scene_file(tmp_path_factory):
    p = tmp_path_factory.mktemp("cli") / "s.xml"
    p.write_text(XML)
    return str(p)


def _in_process(path, **params):
    scene, cfg = mt.load_file(path, device="cpu", **params)
    return mt.render_any(scene, cfg, device="cpu").numpy(), cfg


@pytest.mark.parametrize("args,params", [([], {}), (["-D", "spp=2"],
                                                    {"spp": 2}),
                                         (["-s", "3", "-m", "mono"], None)])
def test_cli_writes_the_in_process_render(scene_file, tmp_path, args, params):
    out = str(tmp_path / "out.pfm")
    assert cli.main([scene_file, "-o", out, "--device", "cpu", *args]) == 0
    img = mt.read_bitmap(out)
    if params is None:   # -s 3 -m mono: the config the CLI derives
        scene, cfg = mt.load_file(scene_file, device="cpu")
        cfg = cfg.replace(spp=3, spp_per_pass=3, color_mode="mono")
        want = mt.render_any(scene, cfg, device="cpu").numpy()
    else:
        want, cfg = _in_process(scene_file, **params)
    assert img.shape == want.shape and np.array_equal(img, want)
    assert np.isfinite(img).all() and img.max() > 0


def test_cli_rejects_bad_variant(scene_file):
    with pytest.raises(SystemExit) as e:
        cli.main([scene_file, "-m", "rgb_duble", "--device", "cpu"])
    assert e.value.code != 0


def test_cli_without_a_card_exits_nonzero(scene_file, tmp_path, monkeypatch):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    out = tmp_path / "out.pfm"
    with pytest.raises(SystemExit) as e:
        cli.main([scene_file, "-o", str(out)])
    assert e.value.code == 1 and not out.exists()


def _assert_stokes_files(out, stokes):
    """The CLI's image `out` (a PFM) is S0 bit for bit, its _s1.._s3
    sidecars (half-float EXR) the other components rounded to half."""
    from mitsuba2_tpu_torch.core import io_bitmap
    img = mt.read_bitmap(out)
    assert np.array_equal(img.reshape(stokes[..., 0].shape), stokes[..., 0])
    for i in (1, 2, 3):
        arr = io_bitmap.read(out.rsplit(".", 1)[0] + f"_s{i}.exr")
        half = stokes[..., i].astype(np.float16).astype(np.float32)
        assert np.array_equal(arr.reshape(half.shape), half), i


@pytest.mark.parametrize("args,name", [
    # AOVs render since the integrator variants' slice and the polarized
    # variants since the polarized slice (the cases keep their ids)
    pytest.param(["-m", "mono_polarized"], "polarized", id="args0-AOV"),
    (["-m", "rgb_polarized"], "polarized"),
    # the _double variants render since the float64 slice
    (["-m", "rgb_double"], "float64")])
def test_cli_refuses_by_name(scene_file, tmp_path, args, name):
    """A _double variant writes the in-process float64 render (in the
    PFM's float32); a _polarized one the in-process render_polarized's S0
    and its S1-S3 sidecars."""
    out = str(tmp_path / "o.pfm")
    argv = [scene_file, "-o", out, "--device", "cpu", *args]
    assert cli.main(argv) == 0
    if name == "float64":
        scene, cfg = mt.load_file(scene_file, device="cpu")
        cfg = cfg.replace(**mt.parse_variant(args[1]))
        img = mt.render_any(scene, cfg, device="cpu").numpy()
        assert img.dtype == np.float64 and cfg.variant == "rgb_double"
        assert np.array_equal(mt.read_bitmap(out), img.astype(np.float32))
        return
    scene, cfg = mt.load_file(scene_file, device="cpu")
    cfg = cfg.replace(**mt.parse_variant(args[1]))
    stokes = mt.render_polarized(scene, cfg, device="cpu").numpy()
    assert stokes.shape[-2:] == (cfg.n_image_channels, 4)
    _assert_stokes_files(out, stokes)


def test_cli_stokes_integrator_writes_sidecars(tmp_path):
    """The stokes integrator: the image is S0 (one channel), S1-S3
    beside it, as the in-process render_any's."""
    p = tmp_path / "stokes.xml"
    p.write_text(XML.replace('<integrator type="path">',
                             '<integrator type="stokes">'))
    out = str(tmp_path / "o.pfm")
    assert cli.main([str(p), "-o", out, "--device", "cpu"]) == 0
    scene, cfg = mt.load_file(str(p), device="cpu")
    assert cfg.integrator == "stokes"
    stokes = mt.render_any(scene, cfg, device="cpu").numpy()
    assert stokes.shape[-1] == 4 and stokes[..., 0].max() > 0
    _assert_stokes_files(out, stokes[..., None, :])


def test_set_variant_applies_to_loaded_scenes(scene_file, monkeypatch):
    monkeypatch.setattr(mt, "_variant", None)
    assert mt.variant() is None
    _, cfg = mt.load_file(scene_file, device="cpu")
    assert cfg.variant == "rgb"
    mt.set_variant("mono")
    assert mt.variant() == "mono"
    for scene, cfg in (mt.load_file(scene_file, device="cpu"),
                       mt.load_string(XML, device="cpu"),
                       mt.load_dict({"type": "scene", "s": {
                           "type": "sphere", "center": [0, 0, 3]}},
                           device="cpu")):
        assert cfg.color_mode == "mono" and cfg.variant == "mono"
    img = mt.render_any(scene, cfg.replace(width=4, height=4, spp=1),
                        device="cpu")
    assert img.shape == (4, 4, 1)
    with pytest.raises(ValueError, match="unknown variant"):
        mt.set_variant("rgbb")
    assert mt.variant() == "mono"


def test_variants_match_jax():
    from mitsuba2_tpu import config as jconfig
    assert mt.variants() == jconfig.variants()
    for name in mt.variants():
        assert mt.parse_variant(name) == jconfig.parse_variant(name)
    for bad in ("rgbb", "rgb_double_polarized", ""):
        for mod in (mt, jconfig):
            with pytest.raises(ValueError, match="unknown variant"):
                mod.parse_variant(bad)


def test_python_m_runs_the_cli(scene_file, tmp_path):
    """`python -m mitsuba2_tpu_torch` itself: with --device cpu it writes
    the in-process render; without it, and without a card, it exits
    non-zero and writes nothing."""
    env = dict(os.environ, PYTHONPATH=REPO)
    out = tmp_path / "m.pfm"
    cmd = [sys.executable, "-m", "mitsuba2_tpu_torch", scene_file, "-o",
           str(out)]
    proc = subprocess.run(cmd + ["--device", "cpu"], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=300)
    assert proc.returncode == 0, proc.stderr
    assert "Mrays/s" in proc.stderr and "kernel launches: {}" in proc.stderr
    assert np.array_equal(mt.read_bitmap(str(out)),
                          _in_process(scene_file)[0])
    if not torch.cuda.is_available():
        os.unlink(out)
        proc = subprocess.run(cmd, cwd=REPO, env=env, capture_output=True,
                              text=True, timeout=300)
        assert proc.returncode != 0 and "--device cpu" in proc.stderr
        assert not out.exists()
