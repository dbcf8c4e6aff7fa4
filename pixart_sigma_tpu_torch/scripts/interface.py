"""Interactive demo over a checkpoint: a Gradio UI when `gradio` imports,
else a REPL on stdin.

Port of scripts/interface.py: a prompt, a style preset (`STYLES`), the
sampler, steps, CFG scale and seed; `--ar h:w` / `--hw h:w` inside a prompt
pick the aspect. The model is PixArtMS-XL-2 at `--image-size`, as JAX's,
or the model of `--config`; the text encoder `--t5-path` (an HF
directory) or `--pseudo-t5 DIM` (whose CFG null is the model's learned
null caption, as the batch CLI's); the VAE `--vae-path` (a diffusers
`.safetensors`) or `--vae-flax` (a `scripts.train_vae` directory); without
one the REPL saves latents as `.npy`.

    python -m pixart_sigma_tpu_torch.scripts.interface --model-path M.pth \\
        [--config CONFIG] [--pseudo-t5 DIM | --t5-path DIR] \\
        [--vae-flax DIR | --vae-path VAE.safetensors] [--save-root output/demo]

runs on the card unless given `--device cpu`. In the REPL a line is a
prompt, optionally followed by `--style NAME`; an empty line, `quit`,
`exit` or the end of input ends it.
"""

from __future__ import annotations

import argparse
import os

# style presets of the upstream app
STYLES = {
    "None": ("{prompt}", ""),
    "Cinematic": (
        "cinematic still {prompt} . emotional, harmonious, vignette, highly "
        "detailed, high budget, bokeh, cinemascope, moody, epic, gorgeous, film grain, grainy",
        "anime, cartoon, graphic, text, painting, crayon, graphite, abstract, glitch, deformed, "
        "mutated, ugly, disfigured",
    ),
    "Photographic": (
        "cinematic photo {prompt} . 35mm photograph, film, bokeh, professional, 4k, "
        "highly detailed",
        "drawing, painting, crayon, sketch, graphite, impressionist, noisy, blurry, soft, "
        "deformed, ugly",
    ),
    "Anime": (
        "anime artwork {prompt} . anime style, key visual, vibrant, studio anime, highly detailed",
        "photo, deformed, black and white, realism, disfigured, low contrast",
    ),
    "Digital Art": (
        "concept art {prompt} . digital artwork, illustrative, painterly, matte painting, "
        "highly detailed",
        "photo, photorealistic, realism, ugly",
    ),
    "Fantasy art": (
        "ethereal fantasy concept art of {prompt} . magnificent, celestial, ethereal, "
        "painterly, epic, majestic, magical, fantasy art, cover art, dreamy",
        "photographic, realistic, realism, 35mm film, dslr, cropped, frame, text, deformed, "
        "glitch, noise, noisy, off-center, deformed, cross-eyed, closed eyes, bad anatomy, "
        "ugly, disfigured, sloppy, duplicate, mutated, black and white",
    ),
}
PE_INTERP = {256: 0.5, 512: 1.0, 1024: 2.0, 2048: 4.0}
SAMPLERS = ["dpm-solver", "sa-solver", "iddpm", "lcm"]


def apply_style(style: str, prompt: str, negative: str = ""):
    pos, neg = STYLES.get(style, STYLES["None"])
    return pos.format(prompt=prompt), (negative or neg)


def build_pipeline(args):
    """(pipeline, the CFG null caption row or None) from the flags."""
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline
    from pixart_sigma_tpu_torch.scripts.serve import load_encoders
    from pixart_sigma_tpu_torch.utils.checkpoint import load_checkpoint
    from pixart_sigma_tpu_torch.utils.device import resolve_device

    device = resolve_device(args.device)
    if args.config:
        from pixart_sigma_tpu_torch.config import read_config
        from pixart_sigma_tpu_torch.models.builder import build_model_from_config

        config = read_config(args.config)
        model = build_model_from_config(config, device=device)
        res = config.get("image_size", args.image_size)
        scale = args.scale_factor or config.get("scale_factor", 0.13025)
    else:
        from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2

        model = PixArtMS_XL_2(device=device, input_size=args.image_size // 8,
                              pe_interpolation=PE_INTERP[args.image_size], model_max_length=300)
        res, scale = args.image_size, args.scale_factor or 0.13025
    load_checkpoint(args.model_path, model)
    t5, y_null_row, vae = load_encoders(args, model, scale, device)
    pipe = PixArtPipeline(model, t5=t5, vae=vae, scale_factor=scale, base_resolution=res,
                          device=device)
    return pipe, y_null_row


def _y_null(y_null_row):
    return None if y_null_row is None else y_null_row[None]


def run_repl(pipe, args, y_null_row=None) -> list:
    """Prompts from stdin until an empty line, quit/exit or its end; each
    saved as save_root/demo_<i>.jpg (or .jpg.npy latents without a VAE).
    Returns the paths written."""
    from PIL import Image

    print("PixArt demo. Type a prompt ('quit' to exit). "
          "Flags: --ar h:w, --style <name>, --steps N, --cfg X, --seed N")
    written = []
    i = 0
    while True:
        try:
            line = input("prompt> ").strip()
        except EOFError:
            break
        if not line or line.lower() in ("quit", "exit"):
            break
        style = "None"
        parts = line.split("--style")
        if len(parts) > 1:
            line = parts[0].strip()
            style = parts[1].split()[0]
        prompt, negative = apply_style(style, line)
        imgs = pipe([prompt], num_inference_steps=args.steps, guidance_scale=args.cfg_scale,
                    sampler=args.sampling_algo, seed=i, negative_prompt=negative,
                    y_null=_y_null(y_null_row), return_latents=pipe.vae is None)
        out = os.path.join(args.save_root, f"demo_{i:03d}.jpg")
        os.makedirs(args.save_root, exist_ok=True)
        if pipe.vae is None:
            import numpy as np

            out += ".npy"
            np.save(out, imgs)
        else:
            Image.fromarray(imgs[0]).save(out)
        print(f"saved {out}")
        written.append(out)
        i += 1
    return written


def run_gradio(pipe, args, y_null_row=None):
    import gradio as gr
    from PIL import Image

    def generate(prompt, style, sampler, steps, cfg, seed):
        prompt, negative = apply_style(style, prompt)
        imgs = pipe([prompt], num_inference_steps=int(steps), guidance_scale=cfg,
                    sampler=sampler, seed=int(seed), negative_prompt=negative,
                    y_null=_y_null(y_null_row))
        return Image.fromarray(imgs[0])

    demo = gr.Interface(
        fn=generate,
        inputs=[
            gr.Textbox(label="Prompt"),
            gr.Dropdown(list(STYLES), value="None", label="Style"),
            gr.Dropdown(SAMPLERS, value="dpm-solver", label="Sampler"),
            gr.Slider(1, 100, value=20, step=1, label="Steps"),
            gr.Slider(1.0, 10.0, value=4.5, label="CFG scale"),
            gr.Number(value=0, label="Seed"),
        ],
        outputs=gr.Image(type="pil"),
        title="PixArt-Sigma",
    )
    demo.launch(server_name="0.0.0.0", server_port=args.port)


def parse_args(argv=None):
    p = argparse.ArgumentParser(description="PixArt-Sigma interactive demo")
    p.add_argument("--model-path", required=True)
    p.add_argument("--config", default=None,
                   help="model config (else PixArtMS-XL-2 at --image-size)")
    p.add_argument("--t5-path", default=None)
    p.add_argument("--pseudo-t5", type=int, default=None, metavar="DIM")
    p.add_argument("--vae-path", default=None)
    p.add_argument("--vae-flax", default=None, help="a VAE directory of scripts.train_vae")
    p.add_argument("--scale-factor", type=float, default=None)
    p.add_argument("--image-size", type=int, default=1024, choices=sorted(PE_INTERP))
    p.add_argument("--sampling-algo", default="dpm-solver")
    p.add_argument("--steps", type=int, default=20)
    p.add_argument("--cfg-scale", type=float, default=4.5)
    p.add_argument("--save-root", default="output/demo")
    p.add_argument("--port", type=int, default=7860)
    p.add_argument("--device", default="cuda", help="cuda (default) or cpu")
    return p.parse_args(argv)


def main(argv=None):
    args = parse_args(argv)
    pipe, y_null_row = build_pipeline(args)
    try:
        import gradio  # noqa: F401
    except ImportError:
        return run_repl(pipe, args, y_null_row)
    return run_gradio(pipe, args, y_null_row)


if __name__ == "__main__":
    main()
