"""ElasticDiffusion on PyTorch and CUDA: the port of ``elasticdiffusion_tpu``.

Same sub-packages and module names as the JAX package, so each counterpart
is found by name: ``configs``, ``sched``, ``kernels``, ``models``, ``ops``,
``core``, ``parallel``, ``apps``, ``utils``. The port imports ``torch`` and
never ``jax``, ``flax`` or anything of the JAX package. Entry points
(``load_bundle``, ``ElasticDiffusion``, the apps) run on the GPU unless the
caller passes ``device="cpu"``.

The top level exports the JAX package's names: the configs and
``get_bundle_config`` from ``configs``, the RRG weight schedules from
``sched.weight_schedulers``, and ``ElasticDiffusion`` from
``core.pipeline``, imported on first use (PEP 562), so that importing the
package loads no model module.
"""

__version__ = "0.1.0"

from elasticdiffusion_tpu_torch.configs import (  # noqa: F401
    SDVersion,
    ModelBundleConfig,
    UNetConfig,
    VAEConfig,
    CLIPTextConfig,
    get_bundle_config,
)
from elasticdiffusion_tpu_torch.sched.weight_schedulers import (  # noqa: F401
    CosineScheduler,
    LinearScheduler,
    ConstScheduler,
)


def __getattr__(name):
    """``ElasticDiffusion``, imported from ``core.pipeline`` on first use."""
    if name == "ElasticDiffusion":
        from elasticdiffusion_tpu_torch.core.pipeline import ElasticDiffusion
        return ElasticDiffusion
    raise AttributeError(f"module {__name__!r} has no attribute {name!r}")
