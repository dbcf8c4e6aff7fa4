"""The trainer's on-the-fly encoding against the JAX package, on the CPU.

- `Trainer.prepare_batch` on an image- and prompt-mode batch (PNG images in
  two aspect buckets at 256px) against the JAX trainer's, run on a
  stand-in of its Trainer, with toy VAE and T5 weights carried across
  (`vae_state_dict_from_jax`, `t5_state_dict_from_jax`): with
  `sample_posterior` False, and with it True and JAX's normal draw passed
  to the port; latents and captions within 1e-5 relative L2, masks equal;
- one training step from images and prompts equals, bit for bit, the step
  from the latents and caption features they encode to;
- the port's `extract_features` writes files that the port's datasets read
  back into the same latents and caption features (to the fp16 of the
  files: 2e-3 relative L2), single- and multi-scale.
"""

import json
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.models.t5 import T5Config as JaxT5Config
from pixart_sigma_tpu.models.t5 import T5Embedder as JaxT5Embedder
from pixart_sigma_tpu.models.vae import AutoencoderKL as JaxVAE
from pixart_sigma_tpu.models.vae import VAEConfig as JaxVAEConfig
from pixart_sigma_tpu.training.trainer import Trainer as JaxTrainer
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.datasets import PixArtDataset, PixArtMSDataset
from pixart_sigma_tpu_torch.data.synthetic import write_image_dataset
from pixart_sigma_tpu_torch.models.t5 import T5Config, T5Embedder, build_t5
from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
from pixart_sigma_tpu_torch.tools.extract_features import extract_caption_t5, extract_img_vae
from pixart_sigma_tpu_torch.training.train_step import train_step
from pixart_sigma_tpu_torch.training.trainer import Trainer
from pixart_sigma_tpu_torch.utils.checkpoint import (
    t5_state_dict_from_jax,
    vae_state_dict_from_jax,
)
from tests.test_torch_t5 import WordHashTokenizer, _jax_params
from tests.test_torch_trainer_features import SIGMA_1024
from tests.test_torch_vae import _random_vae_params

# a VAE of the SDXL layout (three stride-2 downsamplings: latents at 1/8)
# at toy widths, and a T5 of the DiT's toy caption width
VAE_KW = dict(block_out_channels=(8, 8, 16, 16), layers_per_block=1, norm_num_groups=4)
T5_KW = dict(num_layers=2)
SIZES = [(256, 256), (300, 260), (256, 256), (330, 290)]  # buckets 256x256, 272x240


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.fixture(scope="module")
def encoders():
    """(JAX VAE config, params, JAX T5 config, params; port VAE, port T5
    embedder) with the same weights."""
    vcfg = JaxVAEConfig.small_test(**VAE_KW)
    vparams = _random_vae_params(vcfg, 3)
    tcfg = JaxT5Config.small_test(**T5_KW)
    tparams = _jax_params(tcfg, seed=4)
    vae = build_vae(VAEConfig.small_test(**VAE_KW), device="cpu")
    vae.load_diffusers_state_dict(vae_state_dict_from_jax(vparams, vcfg))
    enc = build_t5(T5Config.small_test(**T5_KW), device="cpu")
    enc.load_hf_state_dict(t5_state_dict_from_jax(tparams, tcfg))
    return vcfg, vparams, tcfg, tparams, vae, T5Embedder(enc, WordHashTokenizer())


def _config(data_root, **overrides):
    cfg = read_config(SIGMA_1024)
    cfg.update(image_size=256, aspect_ratio_type=256, train_batch_size=2, data_root=data_root,
               num_workers=2, log_interval=1, lr_schedule_args=dict(num_warmup_steps=1),
               save_model_steps=0, save_model_epochs=10**6, real_prompt_ratio=0.5,
               model_overrides=dict(depth=2, hidden_size=144, num_heads=2,
                                    caption_channels=32, kv_compress_layers=(1,)))
    cfg.data = dict(cfg.data, root="data", load_vae_feat=False, load_t5_feat=False)
    cfg.update(overrides)
    return cfg


@pytest.mark.parametrize("sample_posterior", [False, True])
def test_prepare_batch_from_images_and_prompts_matches_jax(tmp_path, encoders,
                                                           sample_posterior):
    vcfg, vparams, tcfg, tparams, vae, t5 = encoders
    write_image_dataset(str(tmp_path / "data"), SIZES, seed=1)
    cfg = _config(str(tmp_path), sample_posterior=sample_posterior)
    trainer = Trainer(cfg, str(tmp_path / "work"), device="cpu", vae=vae, t5=t5)
    batch = next(iter(trainer.build_loader()))
    assert "image" in batch and "latents" not in batch and "y" not in batch
    step = 3
    fake = types.SimpleNamespace(
        vae=JaxVAE(vcfg), vae_params={"params": vparams}, _encode_jit=None, config=cfg,
        t5=JaxT5Embedder(tparams, tcfg, WordHashTokenizer(), model_max_length=300),
        model=types.SimpleNamespace(cfg=types.SimpleNamespace(
            micro_condition=trainer.model.cfg.micro_condition)),
        _put_global=np.asarray)
    fake._encode_images = types.MethodType(JaxTrainer._encode_images, fake)
    want = JaxTrainer.prepare_batch(fake, batch, step)
    noise = None
    if sample_posterior:  # the JAX trainer's draw at this step
        shape = want["latents"].shape
        noise = torch.from_numpy(np.array(jax.random.normal(
            jax.random.fold_in(jax.random.PRNGKey(cfg.seed), step), shape, jnp.float32)))
    got = trainer.prepare_batch(batch, step, noise=noise)
    assert set(got) == set(want)
    assert got["latents"].shape == want["latents"].shape
    assert got["latents"].shape in ((2, 32, 32, 4), (2, 34, 30, 4))
    assert _rel(got["latents"], want["latents"]) <= 1e-5
    assert _rel(got["y"], want["y"]) <= 1e-5 and got["y"].shape == (2, 300, 32)
    np.testing.assert_array_equal(got["y_mask"].numpy(), np.asarray(want["y_mask"]))
    if sample_posterior:  # the trainer's own draw is keyed on (seed, step)
        again = trainer.prepare_batch(batch, step)["latents"]
        assert torch.equal(again, trainer.prepare_batch(batch, step)["latents"])
        assert not torch.equal(again, trainer.prepare_batch(batch, step + 1)["latents"])
        assert _rel(again, want["latents"]) > 1e-3


def test_step_from_images_equals_step_from_their_encodings(tmp_path, encoders):
    *_, vae, t5 = encoders
    write_image_dataset(str(tmp_path / "data"), SIZES, seed=2)
    cfg = _config(str(tmp_path))
    img = Trainer(cfg, str(tmp_path / "a"), device="cpu", vae=vae, t5=t5)
    feat = Trainer(cfg, str(tmp_path / "b"), device="cpu")
    batch = next(iter(img.build_loader()))
    latents = img._encode_images(batch["image"], 0).numpy()
    y, y_mask = t5.get_text_embeddings(batch["prompt"])
    fbatch = {k: v for k, v in batch.items() if k not in ("image", "y_mask")}
    fbatch.update(latents=latents, y=y.numpy(), y_mask=y_mask.numpy())
    dev_img, dev_feat = img.prepare_batch(batch, 0), feat.prepare_batch(fbatch, 0)
    for k in dev_img:
        assert torch.equal(dev_img[k], dev_feat[k]), k
    metrics = []
    for tr, b in ((img, dev_img), (feat, dev_feat)):
        tr.build_state(10)
        metrics.append(train_step(tr.state, tr.diffusion, b, generator=tr.generator,
                                  grad_clip=cfg.gradient_clip))
    assert metrics[0]["loss"] == metrics[1]["loss"] and np.isfinite(metrics[0]["loss"])
    for (n, p), (_, q) in zip(img.model.named_parameters(), feat.model.named_parameters()):
        assert torch.equal(p, q), n


@pytest.mark.parametrize("multi_scale", [False, True])
def test_extract_features_round_trip(tmp_path, encoders, multi_scale):
    """extract_features on PNGs, then the feature datasets read the files:
    each item's y and mask are the T5 features of its prompt, and its
    latents the dataset's keyed posterior draw from the VAE's mean and std
    of its image."""
    *_, vae, t5 = encoders
    root = write_image_dataset(str(tmp_path / "data"), SIZES, seed=3)
    with open(os.path.join(root, "data_info.json")) as f:
        meta = json.load(f)
    extract_caption_t5(root, meta, t5, batch=3)
    vae_dir = extract_img_vae(root, meta, vae, 256, multi_scale=multi_scale, batch=3)
    assert vae_dir.endswith("_ms_new" if multi_scale else "resolution_new")
    common = dict(resolution=256, max_length=300, seed=5)
    if multi_scale:
        make = lambda **kw: PixArtMSDataset(root, aspect_ratio_type=256, **common, **kw)
    else:
        make = lambda **kw: PixArtDataset(root, **common, **kw)
    feats = make(load_vae_feat=True, load_t5_feat=True)
    images = make()
    for i, m in enumerate(meta):
        item = feats.getdata(i)
        y, mask = t5.get_text_embeddings([m["prompt"]])
        assert item["prompt"] == m["prompt"]
        np.testing.assert_array_equal(item["y_mask"], mask[0].numpy())
        assert _rel(item["y"], y[0]) <= 2e-3
        with torch.no_grad():
            mean, logvar = vae.encode(torch.from_numpy(images.getdata(i)["image"][None]))
        mean, std = mean[0].numpy(), torch.exp(0.5 * logvar[0]).numpy()
        h, w, c = mean.shape  # the dataset draws in the files' CHW layout
        z = np.random.default_rng((5, 0, i)).standard_normal((c, h, w), dtype=np.float32)
        want = mean + std * z.transpose(1, 2, 0)
        assert item["latents"].shape == want.shape
        assert _rel(item["latents"], want) <= 2e-3


def test_extract_features_refuses_a_jax_vae_directory(tmp_path):
    from pixart_sigma_tpu_torch.tools.extract_features import main

    root = write_image_dataset(str(tmp_path), SIZES[:1])
    with pytest.raises(NotImplementedError, match="ROADMAP"):
        main(["--root", root, "--vae-flax", str(tmp_path), "--device", "cpu"])
