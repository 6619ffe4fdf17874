"""Gradio text2img demo of the port.

Counterpart of ``elasticdiffusion_tpu/apps/gradio_app.py``: the same
example table (the reference's per-resolution hyper-parameters), the live
pipe's ``view_batch_size`` / ``set_view_config`` set by each call, the fixed
``rrg_stop_t=0.4`` and the UI's keep percentage fed to ``new_p``. The widget
callback ``generate_image_fn`` is a module-level function of the app's state
(the pipe, its ``low_vram`` and how to build a new one). gradio is an
optional dependency, imported by ``build_app``, which raises a clear error
without it.
"""

from __future__ import annotations

import functools
import time

# (prompt, negative, W, H, resampling_steps, keep_p, rrg_scale, cfg,
#  cosine_scale, view_batch_size, steps, patch_size, seed, low_vram, tiled)
# row for row the JAX package's table; columns the reference leaves as None
# take the widget defaults (cfg 10, cosine 10, view batch 16, 50 steps;
# tiled decode on for 2048x2048)
_NEG = "blurry, ugly, duplicate, low quality"
EXAMPLES = [
    ["A cute cat sitting on a couch, high resolution photo", _NEG, 2048, 2048, 10, 0.3, 2000, 10, 10, 16, 50, None, 0, False, True],
    ["An astronaut riding a horse on mars, artstation", _NEG, 1536, 1536, 7, 0.3, 1000, 10, 10, 16, 50, None, 0, False, False],
    ["A fantasy castle floating in the clouds", _NEG, 1024, 2048, 7, 0.3, 1000, 10, 10, 16, 50, None, 0, False, False],
    ["A panoramic photo of a mountain lake at sunrise", _NEG, 2048, 1024, 7, 0.3, 1000, 10, 10, 16, 50, None, 0, False, False],
    ["A lighthouse on a rocky cliff in a storm, dramatic light", _NEG, 1080, 1920, 7, 0.3, 1000, 10, 10, 16, 50, None, 0, False, False],
    ["A cinematic still of a desert highway at dusk", _NEG, 1920, 1080, 7, 0.3, 1000, 10, 10, 16, 50, None, 0, False, False],
    ["A detailed oil painting of a harbor town", _NEG, 2048, 1536, 10, 0.3, 1500, 10, 10, 16, 50, None, 0, False, False],
    ["A watercolor of a terraced tea plantation in the mist", _NEG, 1536, 2048, 10, 0.3, 1500, 10, 10, 16, 50, None, 0, False, False],
    ["A tall waterfall in a mossy canyon, long exposure", _NEG, 768, 2048, 7, 0.3, 1000, 10, 10, 16, 50, None, 0, False, False],
    ["A wide shot of a train crossing an autumn valley", _NEG, 2048, 768, 7, 0.3, 1000, 10, 10, 16, 50, None, 0, False, False],
    ["A portrait of a golden retriever wearing glasses", "blurry, ugly, duplicate", 768, 768, 0, 0.3, 0, 10, 10, 16, 50, None, 0, False, False],
    ["A bowl of ramen, studio lighting", "blurry, ugly, duplicate", 512, 512, 0, 0.3, 0, 10, 10, 16, 50, None, 0, False, False],
    ["An ultrawide mountain ridgeline panorama at golden hour", _NEG, 2048, 512, 7, 0.3, 1000, 10, 10, 16, 50, None, 0, False, False],
    ["A skyscraper facade from street level, looking straight up", _NEG, 512, 2048, 7, 0.3, 1000, 10, 10, 16, 50, None, 0, False, False],
]


def generate_image_fn(state, prompt, negative, width, height,
                      resampling_steps, resampling_keep_p, rrg_scale,
                      guidance_scale, cosine_scale, view_batch_size, steps,
                      patch_size, seed, low_vram, tiled_decoder,
                      progress=None):
    """One request of the demo. `state`: {'pipe', 'low_vram', 'new_pipe'};
    a change of low_vram builds a new pipe with ``new_pipe(low_vram=...)``.
    `progress` is gradio's own argument and unused: the bar is gradio's
    ``Progress().tqdm``, none without gradio."""
    if height % 8 or width % 8:
        raise ValueError("H and W must be multiples of 8")
    t0 = time.time()
    p = state["pipe"]
    if low_vram != state["low_vram"]:
        p = state["new_pipe"](low_vram=low_vram)
        state["pipe"], state["low_vram"] = p, low_vram
    p.seed_everything(int(seed))
    p.view_batch_size = int(view_batch_size)
    p.set_view_config(patch_size=int(patch_size) if patch_size else None)
    try:
        import gradio as gr
        prog = gr.Progress().tqdm
    except ImportError:
        prog = None
    imgs, _ = p.generate_image(
        prompts=prompt, negative_prompts=negative,
        height=int(height), width=int(width),
        num_inference_steps=int(steps),
        guidance_scale=guidance_scale,
        resampling_steps=int(resampling_steps),
        new_p=resampling_keep_p,  # the UI's keep percentage feeds new_p
        rrg_init_weight=rrg_scale, rrg_stop_t=0.4,
        cosine_scale=cosine_scale, tiled_decoder=tiled_decoder,
        progress=prog)
    print(f"Time taken: {time.time() - t0} seconds")
    return imgs


def build_app(sd_version: str = "XL1.0", checkpoint_dir=None, server_port=7860,
              pipe=None):
    try:
        import gradio as gr
    except ImportError as e:
        raise RuntimeError("gradio is not installed in this environment; "
                           "`pip install gradio` to run the demo UI") from e
    from ..core.pipeline import ElasticDiffusion

    new_pipe = functools.partial(ElasticDiffusion, sd_version=sd_version,
                                 checkpoint_dir=checkpoint_dir)
    state = {"pipe": pipe or new_pipe(), "low_vram": False,
             "new_pipe": new_pipe}
    demo = gr.Interface(
        fn=functools.partial(generate_image_fn, state),
        inputs=[
            gr.Textbox(label="Prompt"),
            gr.Textbox(label="Negative prompt",
                       value="blurry, ugly, duplicate, low quality"),
            gr.Slider(128, 2048, value=1024, step=128, label="Width"),
            gr.Slider(128, 2048, value=1024, step=128, label="Height"),
            gr.Slider(0, 20, value=7, step=1, label="Resampling steps"),
            gr.Slider(0.0, 1.0, value=0.3, step=0.05, label="Resampling keep percentage"),
            gr.Slider(0, 8000, value=1000, step=100, label="RRG scale"),
            gr.Slider(1.0, 20.0, value=10.0, step=0.5, label="Guidance scale"),
            gr.Slider(1.0, 20.0, value=10.0, step=0.5, label="Cosine scale"),
            gr.Slider(1, 64, value=16, step=1, label="View batch size"),
            gr.Slider(10, 100, value=50, step=5, label="Steps"),
            gr.Number(label="Patch size (blank = default)", value=None),
            gr.Number(label="Seed", value=0),
            gr.Checkbox(label="Low VRAM", value=False),
            gr.Checkbox(label="Tiled decoder", value=False),
        ],
        outputs=gr.Gallery(label="Generated images"),
        examples=EXAMPLES,
        title="ElasticDiffusion (PyTorch/CUDA)",
    )
    return demo, server_port


def main():
    demo, port = build_app()
    demo.launch(server_port=port)


if __name__ == "__main__":
    main()
