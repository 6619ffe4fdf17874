"""The port's top-level names are the JAX package's.

``elasticdiffusion_tpu`` exports the configs, ``get_bundle_config`` and the
RRG weight schedules eagerly and ``ElasticDiffusion`` through a module
``__getattr__``; ``elasticdiffusion_tpu_torch`` exports the same names from
its own modules, the pipeline class as lazily: a fresh interpreter that
imports the port's package loads neither its pipeline, nor a model module,
nor jax.
"""

import json
import os
import subprocess
import sys

import pytest

import elasticdiffusion_tpu
import elasticdiffusion_tpu_torch
from elasticdiffusion_tpu_torch import configs as tcfg
from elasticdiffusion_tpu_torch.sched import weight_schedulers as tws

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _public(module):
    return sorted(n for n in vars(module) if not n.startswith("_")
                  and not isinstance(vars(module)[n], type(sys)))


def test_the_eager_names_are_the_jax_packages():
    assert _public(elasticdiffusion_tpu_torch) == _public(elasticdiffusion_tpu)
    assert len(_public(elasticdiffusion_tpu_torch)) == 9


@pytest.mark.parametrize("name", ["SDVersion", "ModelBundleConfig",
                                  "UNetConfig", "VAEConfig", "CLIPTextConfig",
                                  "get_bundle_config"])
def test_each_config_name_is_the_configs_module_s(name):
    assert getattr(elasticdiffusion_tpu_torch, name) is getattr(tcfg, name)


@pytest.mark.parametrize("name", ["CosineScheduler", "LinearScheduler",
                                  "ConstScheduler"])
def test_each_schedule_is_the_sched_module_s(name):
    assert getattr(elasticdiffusion_tpu_torch, name) is getattr(tws, name)


def test_elastic_diffusion_is_the_pipeline_class():
    from elasticdiffusion_tpu_torch import ElasticDiffusion
    from elasticdiffusion_tpu_torch.core.pipeline import (
        ElasticDiffusion as pipeline_class)
    assert ElasticDiffusion is pipeline_class


def test_one_line_imports_the_entry_point_and_its_helpers():
    from elasticdiffusion_tpu_torch import (  # noqa: F401
        CosineScheduler, ElasticDiffusion, get_bundle_config)
    assert get_bundle_config("XL1.0").is_xl


@pytest.mark.parametrize("name", ["elastic_diffusion", "load_bundle",
                                  "ElasticDiffusionPipeline"])
def test_an_unknown_name_raises_attribute_error(name):
    with pytest.raises(AttributeError, match=name):
        getattr(elasticdiffusion_tpu_torch, name)
    with pytest.raises(ImportError):
        exec(f"from elasticdiffusion_tpu_torch import {name}", {})


PROBE = """
import json, sys
import elasticdiffusion_tpu_torch
print(json.dumps(sorted(m for m in sys.modules if m == 'jax'
                        or m.startswith(('jax.', 'flax', 'elasticdiffusion_tpu.',
                                         'elasticdiffusion_tpu_torch.core',
                                         'elasticdiffusion_tpu_torch.models')))))
"""


def test_importing_the_package_loads_no_model_module():
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    out = subprocess.run([sys.executable, "-c", PROBE], cwd=ROOT, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr[-2000:]
    assert json.loads(out.stdout.strip().splitlines()[-1]) == []
