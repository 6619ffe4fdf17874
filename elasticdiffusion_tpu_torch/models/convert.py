"""Weights into the port's modules: checkpoints on disk, and the JAX
package's parameter trees.

Checkpoints (counterpart of ``elasticdiffusion_tpu/models/convert.py``'s
readers). ``load_state_dict`` reads the ``*.safetensors`` / ``*.bin`` /
``*.pt`` files of one HF model directory as they are (fp16 and bf16 stay so)
onto a device; ``hf_to_port`` makes a diffusers / transformers state dict
loadable by name: legacy VAE attention names (``query``, ``key``, ``value``,
``proj_attn``) become ``to_q``, ``to_k``, ``to_v``, ``to_out.0``, 1x1-conv
shaped attention weights lose their two unit dims (the port's are
``nn.Linear``; SD 1.x ``proj_in`` / ``proj_out`` stay 1x1 convs), and
buffers (CLIP's ``position_ids``) and the modules a DPT depth model never
runs are dropped. ``load_params_npz`` / ``load_converted_params`` read the
JAX package's converted ``.npz`` trees. ``read_model`` gives one model of a
checkpoint directory in either layout as a state dict of the port, and
``load_into`` copies it into a module, strictly. ``save_bundle`` writes a
bundle as a diffusers pipeline directory.

Parameter trees. ``unet_from_jax``, ``vae_from_jax``, ``clip_from_jax``,
``controlnet_from_jax`` and ``dpt_from_jax`` take a parameter pytree of the
JAX package (nested dicts whose leaves are numpy-convertible arrays) and
return a ``state_dict`` for the port's module of the same model.
They reverse the layout transforms of the JAX package's checkpoint converter

  conv   flax (kh, kw, I, O) -> torch (O, I, kh, kw)
  linear flax (I, O)         -> torch (O, I)
  norms  scale / bias        -> weight / bias

and its Flax names (``GroupNorm_0/scale``, ``blocks_{i}``, ``to_out``, ...).
The port's modules are named after the diffusers / transformers checkpoint
keys, so the result carries exactly those keys.
"""

from __future__ import annotations

import os
import re
from typing import Any, Dict, Iterator, Optional, Tuple

import numpy as np
import torch


def _flatten(tree: Dict[str, Any], prefix=()) -> Iterator[Tuple[tuple, Any]]:
    for k, v in tree.items():
        if isinstance(v, dict):
            yield from _flatten(v, prefix + (k,))
        else:
            yield prefix + (k,), v


def _leaf(name: str, value) -> Tuple[str, torch.Tensor]:
    """Flax leaf name and array -> torch parameter name and tensor."""
    a = np.asarray(value)
    if name == "kernel":
        a = a.transpose(3, 2, 0, 1) if a.ndim == 4 else a.transpose(1, 0)
        name = "weight"
    elif name in ("scale", "embedding"):
        name = "weight"
    return name, torch.tensor(np.ascontiguousarray(a))


def _resnet(rest: tuple) -> str:
    # norm1/GroupNorm_0/scale -> norm1 ; conv1/kernel -> conv1
    return rest[0]


def _attention(rest: tuple) -> str:
    return "to_out.0" if rest[0] == "to_out" else rest[0]


def _transformer(rest: tuple) -> str:
    head = rest[0]
    if head in ("norm", "proj_in", "proj_out"):
        return head
    m = re.fullmatch(r"blocks_(\d+)", head)
    if not m:
        raise KeyError(f"unknown transformer entry {rest}")
    blk = f"transformer_blocks.{m.group(1)}"
    sub = rest[1]
    if sub in ("norm1", "norm2", "norm3"):
        return f"{blk}.{sub}"
    if sub in ("attn1", "attn2"):
        return f"{blk}.{sub}.{_attention(rest[2:])}"
    if sub == "ff":
        return f"{blk}.ff." + {"proj_in": "net.0.proj",
                               "proj_out": "net.2"}[rest[2]]
    raise KeyError(f"unknown transformer block entry {rest}")


def _unet_module(path: tuple, n_blocks: int) -> str:
    head, rest = path[0], path[1:]
    if head in ("conv_in", "conv_out", "conv_norm_out"):
        return head
    if head in ("time_embedding", "add_embedding"):
        return f"{head}.{rest[0]}"
    m = re.fullmatch(r"mid_resnet_(\d)", head)
    if m:
        return f"mid_block.resnets.{m.group(1)}.{_resnet(rest)}"
    if head == "mid_attn":
        return f"mid_block.attentions.0.{_transformer(rest)}"
    m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", head)
    if m:
        side, i = m.group(1), int(m.group(2))
        blk = i if side == "down" else n_blocks - 1 - i
        return f"{side}_blocks.{blk}.{m.group(3)}rs.0.conv"
    m = re.fullmatch(r"(down|up)_(\d+)_(\d+)(_resnet)?", head)
    if m:
        side, i, j = m.group(1), int(m.group(2)), m.group(3)
        blk = i if side == "down" else n_blocks - 1 - i
        if m.group(4):  # attention-free block: the resnet sits at top level
            return f"{side}_blocks.{blk}.resnets.{j}.{_resnet(rest)}"
        if rest[0] == "resnet":
            return f"{side}_blocks.{blk}.resnets.{j}.{_resnet(rest[1:])}"
        if rest[0] == "attn":
            return f"{side}_blocks.{blk}.attentions.{j}.{_transformer(rest[1:])}"
    raise KeyError(f"unknown UNet entry {path}")


def _n_blocks(tree: Dict[str, Any]) -> int:
    return 1 + max(int(m.group(1)) for k in tree
                   if (m := re.match(r"down_(\d+)_", k)))


def unet_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX UNet2DCondition params -> state_dict of the port's UNet."""
    n_blocks = _n_blocks(tree)
    out = {}
    for path, value in _flatten(tree):
        name, tensor = _leaf(path[-1], value)
        out[f"{_unet_module(path[:-1], n_blocks)}.{name}"] = tensor
    return out


def controlnet_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX ControlNet params -> state_dict of the port's ControlNet. The
    trunk is named as in the UNet; ``controlnet_cond_embedding/blocks_{i}``,
    ``controlnet_down_{k}`` and ``controlnet_mid`` take the diffusers names
    ``controlnet_cond_embedding.blocks.{i}``, ``controlnet_down_blocks.{k}``
    and ``controlnet_mid_block``."""
    n_blocks = _n_blocks(tree)
    out = {}
    for path, value in _flatten(tree):
        name, tensor = _leaf(path[-1], value)
        head = path[0]
        if head == "controlnet_cond_embedding":
            key = head + "." + path[1].replace("blocks_", "blocks.")
        elif m := re.fullmatch(r"controlnet_down_(\d+)", head):
            key = f"controlnet_down_blocks.{m.group(1)}"
        elif head == "controlnet_mid":
            key = "controlnet_mid_block"
        else:
            key = _unet_module(path[:-1], n_blocks)
        out[f"{key}.{name}"] = tensor
    return out


def _vae_module(path: tuple) -> str:
    side, head, rest = path[0], path[1], path[2:]
    if head in ("conv_in", "conv_out", "conv_norm_out"):
        return f"{side}.{head}"
    m = re.fullmatch(r"mid_resnet_(\d)", head)
    if m:
        return f"{side}.mid_block.resnets.{m.group(1)}.{_resnet(rest)}"
    if head == "mid_attn":
        sub = "group_norm" if rest[0] == "group_norm" else _attention(rest[1:])
        return f"{side}.mid_block.attentions.0.{sub}"
    m = re.fullmatch(r"(down|up)_(\d+)_(downsample|upsample)", head)
    if m:
        return f"{side}.{m.group(1)}_blocks.{m.group(2)}.{m.group(3)}rs.0.conv"
    m = re.fullmatch(r"(down|up)_(\d+)_(\d+)", head)
    if m:
        return (f"{side}.{m.group(1)}_blocks.{m.group(2)}.resnets."
                f"{m.group(3)}.{_resnet(rest)}")
    raise KeyError(f"unknown VAE entry {path}")


def vae_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX AutoencoderKL params -> state_dict of the port's AutoencoderKL."""
    out = {}
    for path, value in _flatten(tree):
        name, tensor = _leaf(path[-1], value)
        if path[0] in ("quant_conv", "post_quant_conv"):
            out[f"{path[0]}.{name}"] = tensor
        else:
            out[f"{_vae_module(path[:-1])}.{name}"] = tensor
    return out


def clip_from_jax(tree: Dict[str, Any]) -> Dict[str, torch.Tensor]:
    """JAX CLIPTextModel params -> state_dict of the port's CLIPTextModel."""
    out = {}
    for path, value in _flatten(tree):
        head = path[0]
        if head == "position_embedding":  # a bare array in the JAX tree
            out["text_model.embeddings.position_embedding.weight"] = \
                torch.tensor(np.asarray(value))
            continue
        name, tensor = _leaf(path[-1], value)
        m = re.fullmatch(r"layers_(\d+)", head)
        if m:
            sub = path[1]
            if sub in ("q_proj", "k_proj", "v_proj", "out_proj"):
                sub = f"self_attn.{sub}"
            elif sub in ("fc1", "fc2"):
                sub = f"mlp.{sub}"
            key = f"text_model.encoder.layers.{m.group(1)}.{sub}"
        elif head == "token_embedding":
            key = "text_model.embeddings.token_embedding"
        elif head == "final_layer_norm":
            key = "text_model.final_layer_norm"
        elif head == "text_projection":
            key = "text_projection"
        else:
            raise KeyError(f"unknown CLIP entry {path}")
        out[f"{key}.{name}"] = tensor
    return out


_DPT_LAYER = {"query": "attention.attention.query",
              "key": "attention.attention.key",
              "value": "attention.attention.value",
              "attn_out": "attention.output.dense",
              "intermediate": "intermediate.dense",
              "output": "output.dense",
              "layernorm_before": "layernorm_before",
              "layernorm_after": "layernorm_after"}
_DPT_HEAD = {"head_conv1": "head.head.0", "head_conv2": "head.head.2",
             "head_conv3": "head.head.4"}


def _dpt_module(path: tuple) -> str:
    head = path[0]
    if head == "patch_embeddings":
        return "dpt.embeddings.patch_embeddings.projection"
    if head in _DPT_HEAD:
        return _DPT_HEAD[head]
    m = re.fullmatch(r"([a-z_]+?)_(\d+)", head)
    if m:
        kind, j = m.group(1), m.group(2)
        if kind == "layer":
            return f"dpt.encoder.layer.{j}.{_DPT_LAYER[path[1]]}"
        if kind == "readout_project":
            return f"neck.reassemble_stage.readout_projects.{j}.0"
        if kind in ("reassemble_proj", "reassemble_resize"):
            sub = "projection" if kind == "reassemble_proj" else "resize"
            return f"neck.reassemble_stage.layers.{j}.{sub}"
        if kind == "neck_conv":
            return f"neck.convs.{j}"
        if kind == "fusion":
            return f"neck.fusion_stage.layers.{j}." + ".".join(path[1:])
    raise KeyError(f"unknown DPT entry {path}")


def dpt_from_jax(tree: Dict[str, Any],
                 reassemble_factors: Tuple[float, ...] = (4, 2, 1, 0.5)
                 ) -> Dict[str, torch.Tensor]:
    """JAX DPTDepthModel params -> state_dict of the port's DPTDepthModel,
    named as ``transformers.DPTForDepthEstimation``. The reassemble stages
    whose factor is above 1 upsample with a transposed conv: its Flax kernel
    (kh, kw, I, O) becomes torch's (I, O, kh, kw), flipped in space, since
    Flax's ``ConvTranspose`` (``transpose_kernel=False``) applies the kernel
    unflipped where ``nn.ConvTranspose2d`` flips it."""
    out = {}
    for path, value in _flatten(tree):
        if path[0] in ("cls_token", "position_embeddings"):
            out[f"dpt.embeddings.{path[0]}"] = torch.tensor(np.asarray(value))
            continue
        key = _dpt_module(path[:-1])
        m = re.fullmatch(r"reassemble_resize_(\d+)", path[0])
        if m and path[-1] == "kernel" \
                and reassemble_factors[int(m.group(1))] > 1:
            a = np.asarray(value)[::-1, ::-1].transpose(2, 3, 0, 1)
            out[f"{key}.weight"] = torch.tensor(np.ascontiguousarray(a))
            continue
        name, tensor = _leaf(path[-1], value)
        out[f"{key}.{name}"] = tensor
    return out


# ---------------------------------------------------------------------------
# checkpoints on disk
# ---------------------------------------------------------------------------

def load_state_dict(model_dir: str, device="cpu") -> Dict[str, torch.Tensor]:
    """Every tensor of the ``*.safetensors``, ``*.bin``, ``*.pt`` and
    ``*.pth`` files of one HF model directory, in the dtypes they are stored
    in; files are read in name order and a later file's key wins.
    safetensors files are read straight onto `device`, one tensor at a time;
    torch pickles are mapped from disk and stay there until copied."""
    sd: Dict[str, torch.Tensor] = {}
    for fname in sorted(os.listdir(model_dir)):
        path = os.path.join(model_dir, fname)
        if fname.endswith(".safetensors"):
            from safetensors.torch import load_file
            sd.update(load_file(path, device=str(torch.device(device))))
        elif fname.endswith((".bin", ".pt", ".pth")):
            sd.update(torch.load(path, map_location="cpu", weights_only=True,
                                 mmap=True))
    if not sd:
        raise FileNotFoundError(f"no weight files in {model_dir}")
    return sd


KINDS = ("unet", "vae", "clip", "controlnet", "dpt")
_LEGACY_VAE_ATTENTION = {"query": "to_q", "key": "to_k", "value": "to_v",
                         "proj_attn": "to_out.0"}
_BUFFERS = ("position_ids",)
# what transformers' DPTForDepthEstimation holds and its depth forward never
# runs: the backbone's final LayerNorm, the first fusion layer's
# residual_layer1
_DPT_UNUSED = ("dpt.layernorm.", "neck.fusion_stage.layers.0.residual_layer1.")


def hf_to_port(sd: Dict[str, torch.Tensor], kind: str) -> Dict[str, torch.Tensor]:
    """A diffusers / transformers state dict of a model of `kind` (one of
    ``KINDS``) under the port's names, with the variants the JAX package's
    converter accepts: legacy VAE attention names, 1x1-conv shaped
    attention weights (the port's are ``nn.Linear``), non-parameter buffers
    and unused DPT modules dropped. SD 1.x ``proj_in`` / ``proj_out`` keep
    their 4-D weights: the port keeps them as 1x1 convolutions."""
    if kind not in KINDS:
        raise ValueError(f"kind must be one of {KINDS}, got {kind!r}")
    out = {}
    for key, t in sd.items():
        if key.rsplit(".", 1)[-1] in _BUFFERS \
                or (kind == "dpt" and key.startswith(_DPT_UNUSED)):
            continue
        if kind == "vae":
            m = re.fullmatch(r"(.*\.attentions\.0)\.(query|key|value|proj_attn)"
                             r"\.(weight|bias)", key)
            if m:
                key = (f"{m.group(1)}.{_LEGACY_VAE_ATTENTION[m.group(2)]}."
                       f"{m.group(3)}")
        if t.dim() == 4 and tuple(t.shape[2:]) == (1, 1) \
                and re.search(r"\.(to_q|to_k|to_v|to_out\.0)\.weight$", key):
            t = t[:, :, 0, 0]
        out[key] = t
    return out


def load_params_npz(path: str) -> Dict[str, Any]:
    """One ``.npz`` file of the JAX package's converter (keys are
    '/'-joined tree paths) as a nested dict of numpy arrays."""
    tree: Dict[str, Any] = {}
    with np.load(path) as data:
        for k in data.files:
            node = tree
            *parents, leaf = k.split("/")
            for p in parents:
                node = node.setdefault(p, {})
            node[leaf] = data[k]
    return tree


def load_converted_params(out_dir: str) -> Dict[str, Any]:
    """Every ``.npz`` tree of a converted directory, by file name."""
    return {f[:-4]: load_params_npz(os.path.join(out_dir, f))
            for f in os.listdir(out_dir) if f.endswith(".npz")}


# each model of a bundle: its file in the JAX package's converted directory
# is '<name>.npz'; its directory in a diffusers pipeline, and its kind
CHECKPOINT_MODELS = {"unet": ("unet", "unet"), "vae": ("vae", "vae"),
                     "text_encoder_0": ("text_encoder", "clip"),
                     "text_encoder_1": ("text_encoder_2", "clip"),
                     "controlnet": ("controlnet", "controlnet")}
_FROM_JAX = {"unet": unet_from_jax, "vae": vae_from_jax, "clip": clip_from_jax,
             "controlnet": controlnet_from_jax}


def checkpoint_layout(checkpoint_dir: str) -> str:
    """'npz' for the JAX package's converted directory (``unet.npz``,
    ``vae.npz``, ``text_encoder_{0,1}.npz``, ``controlnet.npz``), 'diffusers'
    for an HF pipeline directory (``unet/``, ``vae/``, ``text_encoder/``,
    ``text_encoder_2/``, ``controlnet/``). Raises FileNotFoundError, naming
    the path, for anything else."""
    if not os.path.isdir(checkpoint_dir):
        raise FileNotFoundError(f"no checkpoint directory at {checkpoint_dir}")
    if any(os.path.isfile(os.path.join(checkpoint_dir, f"{n}.npz"))
           for n in CHECKPOINT_MODELS):
        return "npz"
    if any(os.path.isdir(os.path.join(checkpoint_dir, sub))
           for sub, _ in CHECKPOINT_MODELS.values()):
        return "diffusers"
    raise FileNotFoundError(
        f"{checkpoint_dir} holds neither converted files "
        f"({', '.join(n + '.npz' for n in CHECKPOINT_MODELS)}) nor diffusers "
        f"model directories "
        f"({', '.join(s + '/' for s, _ in CHECKPOINT_MODELS.values())})")


def read_model(checkpoint_dir: str, name: str,
               device="cpu") -> Optional[Dict[str, torch.Tensor]]:
    """Model `name` (a key of ``CHECKPOINT_MODELS``) of a checkpoint
    directory in either layout, as a state dict under the port's names; None
    when the directory has no file for it."""
    sub, kind = CHECKPOINT_MODELS[name]
    if checkpoint_layout(checkpoint_dir) == "npz":
        path = os.path.join(checkpoint_dir, f"{name}.npz")
        return _FROM_JAX[kind](load_params_npz(path)) \
            if os.path.isfile(path) else None
    path = os.path.join(checkpoint_dir, sub)
    return hf_to_port(load_state_dict(path, device), kind) \
        if os.path.isdir(path) else None


@torch.no_grad()
def load_into(module: torch.nn.Module, sd: Dict[str, torch.Tensor],
              where: str) -> None:
    """Copy `sd` into every parameter and buffer of `module`, in place: each
    tensor keeps its dtype, device and memory layout (the values are cast).
    Strict: keys missing from `sd`, keys the module does not have and
    shapes that differ raise ValueError naming them and `where`, before
    anything is copied."""
    own = module.state_dict()
    missing = sorted(set(own) - set(sd))
    unexpected = sorted(set(sd) - set(own))
    if missing or unexpected:
        show = lambda ks: f"{len(ks)} {ks[:12]}"
        raise ValueError(f"{where}: missing keys {show(missing)}, unexpected "
                         f"keys {show(unexpected)}")
    for k, t in own.items():
        if tuple(sd[k].shape) != tuple(t.shape):
            raise ValueError(f"{where}: {k} has shape {tuple(sd[k].shape)} in "
                             f"the checkpoint and {tuple(t.shape)} in the model")
    for k, t in own.items():
        t.copy_(sd[k])


def save_bundle(bundle, out_dir: str) -> int:
    """Write a bundle's models as a diffusers pipeline directory: ``unet/``,
    ``vae/`` (the fp32 master), ``text_encoder/`` (and ``text_encoder_2/``)
    and, with a ControlNet, ``controlnet/``, one safetensors file each, in
    the dtypes the models hold. Returns the bytes written."""
    from safetensors.torch import save_file
    models = {"unet": bundle.unet, "vae": bundle.vae_fp32}
    models.update({f"text_encoder_{i}": m
                   for i, m in enumerate(bundle.text_models)})
    if bundle.controlnet is not None:
        models["controlnet"] = bundle.controlnet
    written = 0
    for name, module in models.items():
        sub, kind = CHECKPOINT_MODELS[name]
        os.makedirs(os.path.join(out_dir, sub), exist_ok=True)
        path = os.path.join(out_dir, sub, "model.safetensors" if kind == "clip"
                            else "diffusion_pytorch_model.safetensors")
        save_file({k: v.detach().cpu().contiguous()
                   for k, v in module.state_dict().items()}, path)
        written += os.path.getsize(path)
    return written
