"""The offline toy workflow's front ends on the CPU, against the JAX
package's where it has them:

- `tools.make_toy_dataset` writes the JAX tool's files byte for byte
  (PNGs, data_info.json and the `--pseudo-t5` caption features);
- `tools.convert_images_to_json` writes the JAX tool's data_info.json byte
  for byte (sub-folders, a captions map, sidecar .txt files);
- `scripts.interface`: the styles as JAX's, the REPL on stdin and the
  Gradio wiring with a stub pipeline (and a stub `gradio`, which neither
  machine has), as tests/test_interface.py drives JAX's, then the REPL over
  a real toy pipeline with `--vae-flax` and `--pseudo-t5`;
- `--vae-flax` through `scripts.inference`: the JPGs it writes are those of
  the pipeline called with the VAE `load_flax_vae` reads.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import io
import os
import runpy
import sys
import types

import numpy as np
import pytest
import torch
from PIL import Image

from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.models.pixart import init_weights
from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
from pixart_sigma_tpu_torch.models.vae import (
    VAEConfig,
    build_vae,
    init_vae_weights,
    load_flax_vae,
    save_flax_vae,
)
from pixart_sigma_tpu_torch.pipelines import PixArtPipeline
from pixart_sigma_tpu_torch.scripts import inference, interface
from pixart_sigma_tpu_torch.scripts.train_vae import PRESETS
from pixart_sigma_tpu_torch.tools import convert_images_to_json, make_toy_dataset
from pixart_sigma_tpu_torch.utils.checkpoint import save_pth

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(ROOT, "configs/toy/pixart_toy_img128.py")


def _run_jax_script(rel, argv):
    old = sys.argv
    sys.argv = [rel, *argv]
    try:
        return runpy.run_path(os.path.join(ROOT, rel), run_name="__main__")
    finally:
        sys.argv = old


def _tree_bytes(root):
    out = {}
    for d, _, files in os.walk(root):
        for f in files:
            p = os.path.join(d, f)
            with open(p, "rb") as fh:
                out[os.path.relpath(p, root)] = fh.read()
    return out


@pytest.mark.parametrize("pseudo", [True, False])
def test_make_toy_dataset_writes_the_jax_tools_bytes(tmp_path, pseudo):
    argv = ["--n", "7", "--size", "48", "--seed", "3", "--caption-dim", "16", "--max-length",
            "5"] + (["--pseudo-t5"] if pseudo else [])
    _run_jax_script("tools/make_toy_dataset.py", ["--out", str(tmp_path / "jax"), *argv])
    make_toy_dataset.main(["--out", str(tmp_path / "port"), *argv])
    want, got = _tree_bytes(tmp_path / "jax"), _tree_bytes(tmp_path / "port")
    assert len(want) == (7 * 2 + 1 if pseudo else 7 + 1)
    assert got.keys() == want.keys()
    for k in want:
        assert got[k] == want[k], k
    if pseudo:  # the features are the embedder's rows
        npz = np.load(tmp_path / "port" / "InternData" / "caption_features_new" / "toy_000000.npz")
        import json

        with open(tmp_path / "port" / "InternData" / "data_info.json") as f:
            prompt = json.load(f)[0]["prompt"]
        y, mask = PseudoT5Embedder(16, 5).get_text_embeddings([prompt])
        n = int(npz["attention_mask"].sum())
        np.testing.assert_array_equal(npz["caption_feature"][0].astype(np.float32), y[0, :n])
        assert int(mask.sum()) == n == 5


def test_convert_images_to_json_writes_the_jax_tools_bytes(tmp_path):
    imgs = tmp_path / "imgs"
    os.makedirs(imgs / "sub")
    rng = np.random.RandomState(0)
    for name, hw in (("b.png", (20, 30)), ("a.jpg", (16, 16)), ("sub/c.png", (40, 10)),
                     ("sub/d.webp", (8, 12))):
        Image.fromarray(rng.randint(0, 255, (*hw, 3)).astype(np.uint8)).save(imgs / name)
    (imgs / "notes.txt").write_text("not an image")
    (imgs / "sub" / "c.txt").write_text("  a sidecar caption \n")
    caps = tmp_path / "captions.json"
    caps.write_text('{"a.jpg": "from the map", "sub/d.webp": "by relative path"}')
    for extra in ([], ["--captions", str(caps)]):
        argv = ["--image-dir", str(imgs), *extra]
        _run_jax_script("tools/convert_images_to_json.py",
                        [*argv, "--out", str(tmp_path / "jax" / "info.json")])
        convert_images_to_json.main([*argv, "--out", str(tmp_path / "port" / "info.json")])
        want = (tmp_path / "jax" / "info.json").read_bytes()
        assert (tmp_path / "port" / "info.json").read_bytes() == want and b"sidecar" in want


def test_styles_match_jax():
    jmod = runpy.run_path(os.path.join(ROOT, "scripts", "interface.py"), run_name="jax_interface")
    assert interface.STYLES == jmod["STYLES"]
    for style in list(interface.STYLES) + ["Unknown"]:
        for neg in ("", "my negative"):
            assert interface.apply_style(style, "a cat", neg) == jmod["apply_style"](
                style, "a cat", neg)


class _StubPipe:
    """Records its calls; returns a uint8 image (or latents without a VAE)."""

    def __init__(self, vae=True):
        self.vae = object() if vae else None
        self.calls = []

    def __call__(self, prompts, **kw):
        self.calls.append((prompts, kw))
        if kw.get("return_latents"):
            return np.zeros((1, 8, 8, 4), np.float32)
        return np.full((1, 16, 16, 3), 7, np.uint8)


def _args(tmp_path, **kw):
    base = dict(steps=3, cfg_scale=2.0, sampling_algo="dpm-solver",
                save_root=str(tmp_path / "demo"), port=7861)
    return types.SimpleNamespace(**dict(base, **kw))


def test_repl_reads_prompts_from_stdin(tmp_path, monkeypatch):
    pipe = _StubPipe()
    monkeypatch.setattr(sys, "stdin", io.StringIO("a red cat --style Anime\nblue sky\n\nnot read\n"))
    written = interface.run_repl(pipe, _args(tmp_path))
    assert written == [str(tmp_path / "demo" / "demo_000.jpg"),
                       str(tmp_path / "demo" / "demo_001.jpg")]
    (p0, kw0), (p1, kw1) = pipe.calls
    assert p0 == [interface.apply_style("Anime", "a red cat")[0]]
    assert kw0["negative_prompt"] == interface.STYLES["Anime"][1]
    assert p1 == ["blue sky"] and kw1["seed"] == 1 and kw1["num_inference_steps"] == 3
    assert Image.open(written[0]).size == (16, 16)
    latents = _StubPipe(vae=False)
    monkeypatch.setattr(sys, "stdin", io.StringIO("x\nquit\n"))
    out = interface.run_repl(latents, _args(tmp_path, save_root=str(tmp_path / "lat")))
    assert out == [str(tmp_path / "lat" / "demo_000.jpg.npy")]
    assert np.load(out[0]).shape == (1, 8, 8, 4)


def test_gradio_wiring_with_a_stub_gradio(tmp_path, monkeypatch):
    created = []

    class Interface:
        def __init__(self, *, fn, inputs, outputs, title=None):
            self.fn, self.inputs, self.outputs, self.title = fn, inputs, outputs, title
            self.launched = None
            created.append(self)

        def launch(self, **kw):
            self.launched = kw

    widget = lambda *a, **kw: types.SimpleNamespace(args=a, kwargs=kw)
    gr = types.ModuleType("gradio")
    gr.Interface, gr.Textbox, gr.Dropdown, gr.Slider, gr.Number, gr.Image = (
        Interface, widget, widget, widget, widget, widget)
    monkeypatch.setitem(sys.modules, "gradio", gr)
    pipe = _StubPipe()
    interface.run_gradio(pipe, _args(tmp_path), y_null_row=torch.ones(3, 2))
    (demo,) = created
    assert demo.launched == {"server_name": "0.0.0.0", "server_port": 7861}
    assert len(demo.inputs) == 6
    assert set(demo.inputs[2].args[0]) >= {"dpm-solver", "sa-solver", "iddpm", "lcm"}
    img = demo.fn("a tiny red square", "Cinematic", "iddpm", 5, 3.5, 2)
    assert isinstance(img, Image.Image) and img.size == (16, 16)
    prompts, kw = pipe.calls[0]
    assert prompts == [interface.apply_style("Cinematic", "a tiny red square")[0]]
    assert kw["sampler"] == "iddpm" and kw["seed"] == 2 and kw["num_inference_steps"] == 5
    assert kw["y_null"].shape == (1, 3, 2)


@pytest.fixture(scope="module")
def toy(tmp_path_factory):
    """A toy model config (depth 2) and `.pth`, and a small-preset VAE
    directory as `scripts.train_vae` writes it, all seeded."""
    tmp = tmp_path_factory.mktemp("toy")
    config = tmp / "toy.py"
    config.write_text(f"_base_ = [{TOY!r}]\n"
                      "model_overrides = dict(depth=2, hidden_size=64, num_heads=2, "
                      "caption_channels=16)\nmixed_precision = 'fp32'\n")
    model = build_model_from_config(read_config(str(config)), device="cpu")
    gen = torch.Generator().manual_seed(0)
    init_weights(model, gen)
    with torch.no_grad():  # the zero-initialised output layers, so the model is not constant
        for p in (model.final_layer.linear.weight, *(b.cross_attn.proj.weight
                                                     for b in model.blocks)):
            p.normal_(0.0, 0.02, generator=gen)
    pth = str(tmp / "toy.pth")
    save_pth(pth, model.state_dict())
    vae = init_vae_weights(build_vae(VAEConfig(**PRESETS["small"]), device="cpu"),
                           torch.Generator().manual_seed(1))
    save_flax_vae(vae, str(tmp / "vae"))
    return dict(config=str(config), pth=pth, vae=str(tmp / "vae"), model=model)


def test_inference_reads_a_vae_flax_directory(toy, tmp_path):
    prompts = tmp_path / "p.txt"
    prompts.write_text("a red circle on a black background\na blue square\n")
    inference.main(["--config", toy["config"], "--model-path", toy["pth"], "--txt-file",
                    str(prompts), "--save-root", str(tmp_path / "out"), "--vae-flax", toy["vae"],
                    "--pseudo-t5", "16", "--scale-factor", "0.3264", "--steps", "3", "--bs", "2",
                    "--device", "cpu"])
    files = sorted(os.listdir(tmp_path / "out"))
    assert files == ["00000_dpm-solver_3.jpg", "00001_dpm-solver_3.jpg"]
    model = toy["model"]
    pipe = PixArtPipeline(model, t5=PseudoT5Embedder(16, 12),
                          vae=load_flax_vae(toy["vae"], device="cpu"), scale_factor=0.3264,
                          base_resolution=128, device="cpu")
    null = model.y_embedder.y_embedding.detach().float()
    want = pipe(prompts.read_text().split("\n")[:2], num_inference_steps=3, seed=0,
                y_null=null[None].expand(2, *null.shape))
    assert want.shape == (2, 128, 128, 3) and want.std() > 0
    for f, img in zip(files, want):
        buf = io.BytesIO()
        Image.fromarray(img).save(buf, format="JPEG")
        assert (tmp_path / "out" / f).read_bytes() == buf.getvalue()


def test_interface_repl_over_a_toy_pipeline(toy, tmp_path, monkeypatch):
    monkeypatch.setattr(sys, "stdin", io.StringIO("a green triangle on a white background\n"))
    monkeypatch.setitem(sys.modules, "gradio", None)  # the REPL, even where gradio imports
    written = interface.main(["--config", toy["config"], "--model-path", toy["pth"],
                              "--vae-flax", toy["vae"], "--pseudo-t5", "16", "--scale-factor",
                              "0.3264", "--steps", "2", "--save-root", str(tmp_path / "demo"),
                              "--device", "cpu"])
    assert written == [str(tmp_path / "demo" / "demo_000.jpg")]
    with Image.open(written[0]) as im:
        assert im.size == (128, 128)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            interface.main(["--config", toy["config"], "--model-path", toy["pth"]])
