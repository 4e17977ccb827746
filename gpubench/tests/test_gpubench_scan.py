"""What the benchmark runs imports neither JAX nor the JAX package, and its
reference imports nothing of the port; compared by whole top-level module
names (so `coclr_tpu_torch` is not `coclr_tpu`)."""

import ast
import os
import subprocess
import sys

import pytest

from gpubench import run

FORBIDDEN = {"jax", "jaxlib", "flax", "coclr_tpu"}


def _imports(path):
    tree = ast.parse(open(path).read(), path)
    for node in ast.walk(tree):
        if isinstance(node, ast.Import):
            for alias in node.names:
                yield alias.name.split(".")[0]
        elif isinstance(node, ast.ImportFrom) and node.level == 0:
            yield node.module.split(".")[0]


def _sources(*dirs):
    for d in dirs:
        for base, _, files in os.walk(os.path.join(run.ROOT, d)):
            for name in files:
                if name.endswith(".py"):
                    yield os.path.join(base, name)


@pytest.mark.parametrize("package", ["gpubench", "coclr_tpu_torch"])
def test_no_jax_in_sources(package):
    found = {(path, mod) for path in _sources(package)
             for mod in _imports(path) if mod in FORBIDDEN}
    assert not found


def test_reference_imports_nothing_of_the_port():
    found = {(path, mod) for path in _sources("gpubench/reference")
             for mod in _imports(path) if mod == "coclr_tpu_torch"}
    assert not found


def test_a_run_loads_no_jax():
    code = ("import sys; sys.argv = ['x']; import gpubench.run as r; "
            "import gpubench.calibrate, gpubench.check, gpubench.feed; "
            "import coclr_tpu_torch.train.pretrain, "
            "coclr_tpu_torch.data.datasets; "
            "[r.reader(m) for m in r.resolve('s3d.infonce.resident')"
            "['per_layer']]; print(','.join(r.forbidden_modules()))")
    env = dict(os.environ)
    env.pop("JAX_PLATFORMS", None)
    out = subprocess.run([sys.executable, "-c", code], cwd=run.ROOT, env=env,
                         capture_output=True, text=True, timeout=300)
    assert out.returncode == 0, out.stderr
    assert out.stdout.strip() == ""
