"""Writes tests/goldens/<name>.npz: the JAX package's references of the
port's test file tests/<name>.py (tests/goldens/jax_refs.py). It runs
that file's tests in one process with the recorder on, so every
reference the tests ask for is computed by the JAX package and stored.
Run from the repository's root after changing what a reference
computes:

    python tests/goldens/make_refs.py test_torch_dense [...]
"""
import os
import subprocess
import sys

HERE = os.path.dirname(os.path.abspath(__file__))
ROOT = os.path.dirname(os.path.dirname(HERE))
sys.path.insert(0, HERE)

from jax_refs import RECORD_ENV  # noqa: E402


def main(names):
    for name in names:
        path = os.path.join(HERE, f"{name}.npz")
        if os.path.exists(path):
            os.remove(path)
        env = dict(os.environ, JAX_PLATFORMS="cpu", **{RECORD_ENV: name})
        rc = subprocess.call(
            [sys.executable, "-m", "pytest", f"tests/{name}.py", "-q",
             "-p", "no:randomly", "-p", "no:xdist", "-p", "no:cacheprovider",
             "-m", "not slow"], cwd=ROOT, env=env)
        if rc != 0 or not os.path.exists(path):
            sys.exit(f"make_refs: {name}: the tests failed ({rc})")
        print("wrote", path, os.path.getsize(path), "bytes")


if __name__ == "__main__":
    main(sys.argv[1:])
