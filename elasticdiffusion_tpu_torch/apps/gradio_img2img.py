"""Gradio ControlNet demo of the port.

Counterpart of ``elasticdiffusion_tpu/apps/gradio_img2img.py``: an input
image, the condition (canny | depth), the ControlNet scale; the pipe is built
again when the condition or low_vram changes (``get_pipe``). The widget
callback ``generate_image_fn`` is a module-level function of the app's state.
gradio is an optional dependency, imported by ``build_app``, which raises a
clear error without it.
"""

from __future__ import annotations

import functools
import time

import numpy as np

from .preprocessors import prepare_image, process_condition_image


def get_pipe(state, controlnet, low_vram):
    """The pipe for a (condition, low_vram) pair: the cached one, or a new
    one from ``state['new_pipe'](controlnet_model=..., low_vram=...)``."""
    if (state["pipe"] is None or state["controlnet"] != controlnet
            or state["low_vram"] != low_vram):
        state["pipe"] = state["new_pipe"](controlnet_model=controlnet,
                                          low_vram=low_vram)
        state["controlnet"] = controlnet
        state["low_vram"] = low_vram
    return state["pipe"]


def generate_image_fn(state, image, prompt, negative, condition_type,
                      cn_scale, width, height, resampling_steps,
                      resampling_keep_p, rrg_scale, guidance_scale,
                      cosine_scale, view_batch_size, steps, seed, low_vram,
                      tiled_decoder):
    """One request of the demo. `state`: {'pipe', 'controlnet', 'low_vram',
    'new_pipe'}. The condition is made at the downsampled size times the
    VAE's scale factor and handed to the pipeline at that size."""
    if height % 8 or width % 8:
        raise ValueError("H and W must be multiples of 8")
    t0 = time.time()
    p = get_pipe(state, condition_type, low_vram)
    p.seed_everything(int(seed))
    p.view_batch_size = int(view_batch_size)
    from PIL import Image
    img = Image.fromarray(np.asarray(image))
    dh, dw = p.get_downsample_size(int(height), int(width))
    vsf = p.vae_scale_factor
    cond = process_condition_image(
        img.resize((dw * vsf, dh * vsf)), condition_type)
    cond_low = prepare_image(cond, dw * vsf, dh * vsf)
    imgs, _ = p.generate_image(
        prompts=prompt, negative_prompts=negative,
        height=int(height), width=int(width),
        num_inference_steps=int(steps), guidance_scale=guidance_scale,
        resampling_steps=int(resampling_steps), new_p=resampling_keep_p,
        rrg_init_weight=rrg_scale, rrg_stop_t=0.4,
        cosine_scale=cosine_scale, tiled_decoder=tiled_decoder,
        condition_image=cond_low,
        controlnet_conditioning_scale=cn_scale)
    print(f"Time taken: {time.time() - t0} seconds")
    return imgs


def build_app(sd_version: str = "XL1.0", checkpoint_dir=None, server_port=7861):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("gradio is not installed in this environment") from e
    from ..core.pipeline import ElasticDiffusion

    state = {"pipe": None, "controlnet": None, "low_vram": None,
             "new_pipe": functools.partial(ElasticDiffusion,
                                           sd_version=sd_version,
                                           checkpoint_dir=checkpoint_dir)}
    demo = gr.Interface(
        fn=functools.partial(generate_image_fn, state),
        inputs=[
            gr.Image(label="Input image"),
            gr.Textbox(label="Prompt"),
            gr.Textbox(label="Negative prompt",
                       value="blurry, ugly, duplicate, low quality"),
            gr.Dropdown(["canny", "depth"], value="depth", label="Condition"),
            gr.Slider(0.0, 2.0, value=0.2, step=0.05, label="ControlNet scale"),
            gr.Slider(128, 2048, value=1536, step=128, label="Width"),
            gr.Slider(128, 2048, value=1536, step=128, label="Height"),
            gr.Slider(0, 20, value=7, step=1, label="Resampling steps"),
            gr.Slider(0.0, 1.0, value=0.3, step=0.05, label="Resampling keep percentage"),
            gr.Slider(0, 8000, value=2000, step=100, label="RRG scale"),
            gr.Slider(1.0, 20.0, value=10.0, step=0.5, label="Guidance scale"),
            gr.Slider(1.0, 20.0, value=10.0, step=0.5, label="Cosine scale"),
            gr.Slider(1, 64, value=16, step=1, label="View batch size"),
            gr.Slider(10, 100, value=50, step=5, label="Steps"),
            gr.Number(label="Seed", value=0),
            gr.Checkbox(label="Low VRAM", value=False),
            gr.Checkbox(label="Tiled decoder", value=False),
        ],
        outputs=gr.Gallery(label="Generated images"),
        title="ElasticDiffusion img2img + ControlNet (PyTorch/CUDA)",
    )
    return demo, server_port


def main():
    demo, port = build_app()
    demo.launch(server_port=port)


if __name__ == "__main__":
    main()
