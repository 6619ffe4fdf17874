"""ControlNet CLI of the port.

Counterpart of ``elasticdiffusion_tpu/apps/cli_controlnet.py``: the text2img
flags plus ``--controlnet_conditioning_scale``, ``--condition_image`` and
``--controlnet_model`` (canny | depth). The condition is made at the
downsampled size times the VAE's scale factor and handed to the pipeline at
that size. Depth comes from ``apps/preprocessors.py``'s ``default_depth_fn``
(``ED_DPT_DIR``).

    ED_DPT_DIR=ckpt/dpt-large python -m elasticdiffusion_tpu_torch.apps.cli_controlnet \\
        --sd_version 1.5 --checkpoint_dir ckpt/sd15 --controlnet_model depth \\
        --condition_image photo.png --H 512 --W 768
"""

from __future__ import annotations

from .cli import build_parser, make_pipe, request_kwargs, save_outputs
from .preprocessors import prepare_image, process_condition_image


def make_condition(opt, pipe, depth_fn=None):
    """The (1, 3, h, w) condition in [0, 1] of a parsed command line, at the
    downsampled size times the VAE's scale factor: the pipeline zero-pads it
    for the direction and nearest-upsamples and crops it for the views."""
    from PIL import Image
    img = Image.open(opt.condition_image)
    dh, dw = pipe.get_downsample_size(opt.H, opt.W)
    vsf = pipe.vae_scale_factor
    img_small = img.resize((dw * vsf, dh * vsf)).convert("RGB")
    cond = process_condition_image(img_small, opt.controlnet_model, depth_fn)
    return prepare_image(cond, dw * vsf, dh * vsf, batch_size=1)


def main(argv=None):
    """Run one command line; returns the directory the images went to."""
    opt = build_parser(controlnet=True).parse_args(argv)
    from tqdm import tqdm
    from ..utils.timeit import timelog
    timelog.sync = opt.verbose

    pipe = make_pipe(opt, controlnet_model=opt.controlnet_model)
    pipe.seed_everything(opt.seed)
    imgs, image_log = pipe.generate_image(
        progress=tqdm, condition_image=make_condition(opt, pipe),
        controlnet_conditioning_scale=opt.controlnet_conditioning_scale,
        **request_kwargs(opt))
    if opt.verbose:
        timelog.print_results()
    save_dir = save_outputs(opt, imgs, image_log)
    print(f"[INFO] saved to {save_dir}")
    return save_dir


if __name__ == "__main__":
    main()
