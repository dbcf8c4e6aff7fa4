"""DreamBooth-LoRA of the port against the JAX package, on the CPU (f32).

- `make_dreambooth_step`, with prior preservation (the batch stacked
  [instance; class], split at B // 2, the class half weighted) and without:
  two steps with JAX's draws, `loss`, `instance` and `prior` within 1e-5
  relative, the adapters within 1e-4 relative L2;
- `_load_latents` of the CLI: PNGs encoded by a small VAE as a posterior
  sample, with JAX's eps, against JAX's `_load_latents` (1e-5 relative L2);
- `scripts.train_dreambooth_lora` end to end on four tiny PNGs per
  directory, a random SDXL VAE and `--prompt-embeds`.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.models.vae import AutoencoderKL as JaxVAE
from pixart_sigma_tpu.models.vae import VAEConfig as JaxVAEConfig
from pixart_sigma_tpu.training import dreambooth as jdb
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
from pixart_sigma_tpu_torch.scripts import train_dreambooth_lora as cli
from pixart_sigma_tpu_torch.training import dreambooth, lora
from pixart_sigma_tpu_torch.utils.checkpoint import (
    load_pth,
    save_pth,
    save_safetensors,
    vae_state_dict_from_jax,
)
from pixart_sigma_tpu_torch.utils.png import write_png
from tests.test_torch_lora import _jax_adapters, _rel_l2, _toy
from tests.test_torch_vae import _random_vae_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
DREAMBOOTH = os.path.join(ROOT, "configs/pixart_alpha_config/PixArt_xl2_img1024_dreambooth.py")


@pytest.mark.parametrize("prior", [True, False])
def test_dreambooth_step_matches_jax(prior):
    jm, params, tm, cfg = _toy(class_dropout_prob=0.3)  # no drop: the step runs train=False
    jdiff = JaxIDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    diff = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    jad = _jax_adapters(params, False, 7)
    base = {n: p.detach() for n, p in tm.named_parameters()}
    ad = lora.lora_state_dict_from_jax(jad, base, cfg)
    rng = np.random.RandomState(8)
    batch = {"latents": rng.randn(4, 16, 16, 4).astype(np.float32),
             "y": rng.randn(4, 8, 24).astype(np.float32),
             "y_mask": (np.arange(8)[None] < np.asarray([[8], [8], [2], [2]])).astype(np.int32)}
    tx = optax.adamw(1e-3)
    jstep = jdb.make_dreambooth_step(jm, jdiff, params, tx, with_prior_preservation=prior,
                                     prior_loss_weight=0.7)
    opt_state = tx.init(jad)
    step = dreambooth.make_dreambooth_step(
        tm, diff, base, lora.adamw(list(lora.lora_parameters(ad)), 1e-3),
        with_prior_preservation=prior, prior_loss_weight=0.7)
    for i in range(2):
        key = jax.random.PRNGKey(20 + i)
        jad, opt_state, jm_ = jstep(jad, opt_state, {k: jnp.asarray(v) for k, v in batch.items()},
                                    key)
        t_rng, n_rng = jax.random.split(key)
        t = torch.from_numpy(np.array(jax.random.randint(t_rng, (4,), 0, 1000)))
        noise = torch.from_numpy(np.array(jax.random.normal(n_rng, (4, 16, 16, 4))))
        got = step(ad, {k: torch.from_numpy(v) for k, v in batch.items()}, t=t, noise=noise)
        assert sorted(got) == sorted(jm_) == (["instance", "loss", "prior"] if prior
                                               else ["loss"])
        for k, v in jm_.items():
            assert abs(got[k] - float(v)) <= 1e-5 * abs(float(v)), (i, k, got[k], float(v))
    if prior:
        assert got["loss"] == pytest.approx(got["instance"] + 0.7 * got["prior"], rel=1e-6)
    want = lora.lora_state_dict_from_jax(jad, base, cfg)
    for m, entry in want.items():
        for leaf, v in entry.items():
            assert _rel_l2(ad[m][leaf].detach(), v.detach()) <= 1e-4, (m, leaf)


def _pngs(d, n, seed):
    os.makedirs(d)
    rng = np.random.RandomState(seed)
    for i in range(n):
        write_png(os.path.join(d, f"{i}.png"),
                  rng.randint(0, 256, (24 + 8 * i, 32, 3)).astype(np.uint8))
    return d


def test_load_latents_matches_jax(tmp_path, monkeypatch):
    monkeypatch.syspath_prepend(ROOT)
    from scripts.train_dreambooth_lora import _load_latents as jax_load_latents

    d = _pngs(str(tmp_path / "inst"), 3, 0)
    jcfg = JaxVAEConfig.small_test()
    params = _random_vae_params(jcfg, 1)
    vae = build_vae(VAEConfig.small_test(), device="cpu")
    vae.load_diffusers_state_dict(vae_state_dict_from_jax(params, VAEConfig.small_test()))
    want = jax_load_latents(d, JaxVAE(jcfg), {"params": params}, 0.13025, 32)
    eps = np.array(jax.random.normal(jax.random.PRNGKey(0), want.shape, jnp.float32))
    got = cli._load_latents(d, vae, 32, "cpu", noise=torch.from_numpy(eps))
    assert got.shape == want.shape == (3, 16, 16, 4)
    assert _rel_l2(got, want) <= 1e-5, _rel_l2(got, want)
    np.save(str(tmp_path / "inst" / "z.npy"), want[0])
    assert np.array_equal(cli._load_latents(d, None, 32, "cpu"), want[:1])


def test_cli_end_to_end(tmp_path):
    config = tmp_path / "db.py"
    config.write_text(
        f"_base_ = [{DREAMBOOTH!r}]\n"
        "image_size = 64\naspect_ratio_type = 256\npe_interpolation = 0.25\nmodel_max_length = 8\n"
        "log_interval = 1\n"
        "model_overrides = dict(depth=2, hidden_size=64, num_heads=2, caption_channels=16)\n")
    cfg = read_config(str(config))
    base_path = save_pth(str(tmp_path / "base.pth"),
                         build_model_from_config(cfg, device="cpu", train=True).state_dict())
    torch.manual_seed(2)
    vae_path = save_safetensors(str(tmp_path / "vae.safetensors"),
                                build_vae(VAEConfig.sdxl(), device="cpu").state_dict())
    rng = np.random.RandomState(3)
    np.savez(str(tmp_path / "emb.npz"), y_instance=rng.randn(8, 16).astype(np.float32),
             mask_instance=(np.arange(8) < 5).astype(np.int32),
             y_class=rng.randn(8, 16).astype(np.float32),
             mask_class=(np.arange(8) < 3).astype(np.int32))
    out = cli.main([str(config), "--base", base_path, "--work-dir", str(tmp_path / "work"),
                    "--instance-dir", _pngs(str(tmp_path / "inst"), 4, 4),
                    "--class-dir", _pngs(str(tmp_path / "cls"), 4, 5),
                    "--prompt-embeds", str(tmp_path / "emb.npz"), "--vae-path", vae_path,
                    "--rank", "2", "--max-steps", "2", "--device", "cpu"])
    assert len(out["metrics"]) == 2
    assert all(np.isfinite(m["loss"]) and set(m) == {"loss", "instance", "prior", "seconds"}
               for m in out["metrics"])
    merged = lora.merge_lora(out["base"], out["lora"])
    fresh = load_pth(build_model_from_config(cfg, device="cpu", train=True), out["merged_path"])
    for n, p in fresh.named_parameters():
        assert torch.equal(p, merged[n]), n
