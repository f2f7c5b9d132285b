"""The PyTorch port's examples (examples/torch/*.py), one for each of the
JAX package's examples/*.py, each run once on the CPU at tiny sizes,
in-process as a script (runpy, its own sys.argv, in a scratch working
directory), its outputs finite and its checks those of its workflow."""
import os

import numpy as np
import pytest
import torch

import chip_smoke

torch.set_num_threads(1)

EXAMPLES = chip_smoke.EXAMPLES_DIR
# each example's tiny arguments (the smoke's examples phase runs the same)
ARGS = chip_smoke.EXAMPLE_ARGS


def _finite(v):
    if torch.is_tensor(v):
        return bool(torch.isfinite(v).all())
    if isinstance(v, (list, tuple)):
        return all(_finite(x) for x in v)
    return bool(np.isfinite(v))


def test_one_example_per_jax_example():
    jax_examples = sorted(f[:-3] for f in os.listdir(
        os.path.dirname(EXAMPLES)) if f.endswith(".py"))
    assert sorted(ARGS) == jax_examples
    assert sorted(f[:-3] for f in os.listdir(EXAMPLES)
                  if f.endswith(".py")) == jax_examples


@pytest.mark.parametrize("name", sorted(ARGS))
def test_example_runs_on_cpu(name, tmp_path):
    result = chip_smoke.run_example(name, [*ARGS[name], "--device", "cpu"],
                                    str(tmp_path))
    assert result and all(_finite(v) for v in result.values()), result
    if name == "spectral_render":
        assert result["warm"].shape == (8, 8, 3)
    if name == "polarized_stokes":
        assert result["malus"][0] == 1.0 and result["malus"][-1] < 0.2
    if name == "occluder_pose_grad":
        assert result["ad_reparam"] != result["ad_plain"]
    written = [f for f in os.listdir(tmp_path) if f.endswith(".exr")]
    if name in ("render_cbox", "spectral_render", "instancing_field",
                "volumetric_smoke", "polarized_stokes", "neural_occlusion"):
        assert written, name
