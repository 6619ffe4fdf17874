"""ElasticDiffusion on PyTorch and CUDA: the port of ``elasticdiffusion_tpu``.

Same sub-packages and module names as the JAX package, so each counterpart
is found by name: ``configs``, ``sched``, ``kernels``, ``models``, ``ops``,
``core``, ``parallel``, ``apps``, ``utils``. The port imports ``torch`` and
never ``jax``, ``flax`` or anything of the JAX package. Entry points
(``load_bundle``, ``ElasticDiffusion``, the apps) run on the GPU unless the
caller passes ``device="cpu"``.
"""

__version__ = "0.1.0"
