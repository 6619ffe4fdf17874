"""A map of the JAX package's public API onto the port, held name by name.

For every module under ``elasticdiffusion_tpu/``, every public top-level
function and class and every public method of such a class is one of:

  1. in the port module of the same path, under the same name;
  2. renamed: ``RENAMED`` names its counterparts (``module:name``, a method
     as ``Class.method``), and each must exist;
  3. not ported: ``NOT_PORTED`` (or ``NOT_PORTED_MODULES`` for a whole
     module) gives the reason in one line.

Both packages are read with ``ast``; neither is imported. One case per JAX
module: a name none of the three covers, a counterpart that does not exist,
or an entry for a name that the JAX module no longer has, fails it.
"""

import ast
import pathlib

import pytest

ROOT = pathlib.Path(__file__).resolve().parents[1]
JAX = ROOT / "elasticdiffusion_tpu"
PORT = ROOT / "elasticdiffusion_tpu_torch"

TPU_RUNTIME = ("a TPU-runtime workaround, not ported by the ROADMAP port "
               "rules")

NOT_PORTED_MODULES = {
    "core/segmented.py": "the segmented UNet chain and its aot/exec warm "
                         "start: " + TPU_RUNTIME,
    "utils/cache.py": "XLA's persistent compile cache and scan_depth "
                      "priming: " + TPU_RUNTIME,
    "ops/native_planner.py": "the ctypes loader of native/libedplanner.so: "
                             "the port's plans are its own numpy (ROADMAP "
                             "runtime independence)",
}

RENAMED = {
    "kernels/attention.py": {
        "reference_attention": ("kernels/flash_attention.py:"
                                "reference_attention",),
    },
    "kernels/conv3x3.py": {
        "conv3x3_plan_exists": ("kernels/conv3x3.py:conv_plan",),
    },
    "kernels/flash_attention.py": {
        "oneshot_fits_vmem": ("kernels/flash_attention.py:attention_plan",),
    },
    "models/convert.py": {
        "save_params_npz": ("models/convert.py:save_bundle",),
        "convert_unet": ("models/convert.py:hf_to_port",
                         "models/convert.py:read_model"),
        "convert_controlnet": ("models/convert.py:hf_to_port",
                               "models/convert.py:read_model"),
        "convert_vae": ("models/convert.py:hf_to_port",
                        "models/convert.py:read_model"),
        "convert_clip": ("models/convert.py:hf_to_port",
                         "models/convert.py:read_model"),
        "convert_dpt": ("models/convert.py:hf_to_port",
                        "models/dpt.py:load_dpt"),
        "convert_checkpoint": ("models/convert.py:read_model",
                               "models/convert.py:save_bundle"),
        "validate_structure": ("models/convert.py:load_into",),
    },
    "models/unet.py": {
        "CrossAttnBlock": ("models/unet.py:_Block",
                           "models/unet.py:UNetTrunk"),
    },
    "models/vae.py": {
        "AutoencoderKL.setup": ("models/vae.py:AutoencoderKL.__init__",),
    },
    "parallel/sharding.py": {
        "replicated": ("parallel/sharding.py:put_replicated",),
        "shard_views": ("parallel/sharding.py:sharded_call",),
        "pad_and_shard_views": ("parallel/sharding.py:pad_rows_to_mesh",
                                "parallel/sharding.py:sharded_call"),
        "replicate_mesh": ("parallel/sharding.py:put_replicated",),
    },
    "utils/image.py": {
        "to_pil_device": ("utils/image.py:to_pil",),
    },
}

NOT_PORTED = {
    "core/signals.py": {
        "UNetCallConfig": "dead code in the reference: defined, used by no "
                          "module, test or app of the JAX package",
    },
    "models/convert.py": {
        "main": "the conversion CLI: the port reads a diffusers directory "
                "as it stands (read_model), so there is nothing to convert",
    },
    "models/layers.py": {
        "subpixel_upsample_conv": "ED_UPSAMPLE_SUBPIXEL, a TPU formulation "
                                  "of Upsample2D's nearest-x2 + conv",
    },
    "models/registry.py": {
        "ModelBundle.warm_unet_segmented": "the segmented chain's warm "
                                           "start: " + TPU_RUNTIME,
        "ModelBundle.apply_unet_segmented": "the segmented UNet chain: "
                                            + TPU_RUNTIME,
        "ModelBundle.offload_text_encoders": "the packed text-encoder "
                                             "offload: " + TPU_RUNTIME,
    },
    "models/unet.py": {
        "stack_transformer_scan_params": "stacks params for the scan_depth "
                                         "lax.scan: " + TPU_RUNTIME,
    },
    "parallel/sharding.py": {
        "shard_batch": "no caller in the JAX package: its 'data' axis "
                       "places nothing (ROADMAP Queue 1)",
    },
}

JAX_MODULES = sorted(str(p.relative_to(JAX)) for p in JAX.rglob("*.py"))


def _tree(path: pathlib.Path) -> ast.Module:
    return ast.parse(path.read_text(), filename=str(path))


DEFS = (ast.FunctionDef, ast.AsyncFunctionDef, ast.ClassDef)


def defined(path: pathlib.Path, public: bool) -> set:
    """Top-level functions and classes of a module and the methods of its
    classes (``Class.method``); with `public`, only names without a leading
    underscore (a method only of a public class)."""
    names = set()
    for node in _tree(path).body:
        if not isinstance(node, DEFS) or (public and node.name[0] == "_"):
            continue
        names.add(node.name)
        if isinstance(node, ast.ClassDef):
            names.update(f"{node.name}.{m.name}" for m in node.body
                         if isinstance(m, DEFS[:2])
                         and not (public and m.name[0] == "_"))
    return names


def _counterpart_exists(ref: str) -> bool:
    module, name = ref.split(":")
    path = PORT / module
    return path.is_file() and name in defined(path, public=False)


@pytest.mark.parametrize("module", JAX_MODULES)
def test_every_public_name_is_ported_or_mapped(module):
    names = defined(JAX / module, public=True)
    renamed = RENAMED.get(module, {})
    skipped = NOT_PORTED.get(module, {})
    stale = sorted((set(renamed) | set(skipped)) - names)
    assert not stale, f"{module}: the map names what it does not define: {stale}"
    assert not set(renamed) & set(skipped)
    if module in NOT_PORTED_MODULES:
        assert not renamed and not skipped and NOT_PORTED_MODULES[module]
        return
    port_path = PORT / module
    assert port_path.is_file(), f"no port module {module}"
    port = defined(port_path, public=False)
    unmapped = sorted(n for n in names
                      if n not in port and n not in renamed
                      and n not in skipped)
    missing = sorted(ref for refs in renamed.values() for ref in refs
                     if not _counterpart_exists(ref))
    # a name the port has as it is needs no entry
    redundant = sorted(n for n in set(renamed) | set(skipped) if n in port)
    assert not unmapped, f"{module}: not in the port and not mapped: {unmapped}"
    assert not missing, f"{module}: counterparts that do not exist: {missing}"
    assert not redundant, f"{module}: in the port under the same name: " \
                          f"{redundant}"
    assert all(skipped.values())


def test_the_map_names_only_modules_of_the_jax_package():
    keys = set(RENAMED) | set(NOT_PORTED) | set(NOT_PORTED_MODULES)
    assert keys <= set(JAX_MODULES), sorted(keys - set(JAX_MODULES))
    assert not set(NOT_PORTED_MODULES) & {
        str(p.relative_to(PORT)) for p in PORT.rglob("*.py")}
