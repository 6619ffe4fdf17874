"""Import hygiene of the port, module by module: importing any module of
``elasticdiffusion_tpu_torch``, or ``chip_smoke.py``, brings in neither jax,
flax nor the JAX package, and needs neither nvcc nor triton. One fresh
interpreter imports them in turn and reports after each."""

import json
import os
import pkgutil
import subprocess
import sys

import pytest

import elasticdiffusion_tpu_torch

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MODULES = sorted(m.name for m in pkgutil.walk_packages(
    elasticdiffusion_tpu_torch.__path__, "elasticdiffusion_tpu_torch."))
TARGETS = ["elasticdiffusion_tpu_torch"] + MODULES + ["chip_smoke"]

PROBE = """
import importlib, json, sys
FORBIDDEN = ('jax', 'jaxlib', 'flax', 'elasticdiffusion_tpu', 'triton',
             'gradio', 'sklearn')
report = {}
for name in json.loads(sys.argv[1]):
    try:
        importlib.import_module(name)
        error = None
    except Exception as e:
        error = repr(e)
    report[name] = {"error": error, "bad": sorted(
        m for m in sys.modules if m.split('.')[0] in FORBIDDEN)}
print(json.dumps(report))
"""


@pytest.fixture(scope="module")
def report():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE, json.dumps(TARGETS)],
                         cwd=ROOT, env=env, capture_output=True, text=True,
                         timeout=300)
    assert out.returncode == 0, out.stderr[-2000:]
    return json.loads(out.stdout.strip().splitlines()[-1])


def test_the_walk_finds_the_new_modules():
    assert "elasticdiffusion_tpu_torch.kernels.conv3x3" in MODULES
    assert "elasticdiffusion_tpu_torch.models.registry" in MODULES
    for name in ("models.controlnet", "models.dpt", "apps.preprocessors",
                 "parallel.halo_decode", "core.entry", "utils.timeit",
                 "apps.cli", "apps.cli_controlnet", "apps.pca_scores",
                 "apps.gradio_app", "apps.gradio_img2img", "utils.flops"):
        assert f"elasticdiffusion_tpu_torch.{name}" in MODULES
    assert len(MODULES) >= 43


@pytest.mark.parametrize("name", TARGETS)
def test_module_imports_without_jax(name, report):
    assert report[name]["error"] is None, report[name]["error"]
    assert report[name]["bad"] == [], report[name]["bad"]
