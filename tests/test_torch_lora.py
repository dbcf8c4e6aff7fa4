"""LoRA / DoRA of the port against the JAX package, on the CPU (f32).

- the adapted set: the port adapts exactly the weights JAX's
  `init_lora_params` names (the blocks' projections and MLPs, the patch
  embedding, the timestep, caption and size embedders' MLPs, `t_block`,
  the final linear; not the KV-compression conv), one adapter per block of
  each scan group;
- zero-initialised LoRA and DoRA give back every weight, and the forward,
  bit for bit;
- `apply_lora` (with `alpha`, rsLoRA on and off) and `merge_lora` equal JAX's
  merged params to 1e-6 relative L2, with JAX's adapters carried across by
  `lora_state_dict_from_jax`;
- two `make_lora_train_step` steps with JAX's draws (t, noise; caption drop
  probability 0 or 1, so the drops agree): losses 1e-5 relative, adapters
  1e-4 relative L2, the base weights unmoved; one case with `snr_gamma`,
  DoRA and remat;
- `scripts.train_pixart_lora` writes a `lora_merged.pth` that `load_pth`
  reads back as the merged model.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.training import lora as jlora
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.models.pixart import PixArtConfig, PixArtMS_XL_2
from pixart_sigma_tpu_torch.scripts import train_pixart_lora
from pixart_sigma_tpu_torch.training import lora
from pixart_sigma_tpu_torch.utils.checkpoint import (
    jax_param_path,
    load_pth,
    save_pth,
    state_dict_from_jax,
)

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(input_size=16, depth=4, hidden_size=96, num_heads=2, caption_channels=24,
           model_max_length=8, kv_compress_sampling="conv", kv_compress_scale=2,
           kv_compress_layers=(2, 3))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _perturb(tree, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + scale * rng.randn(*a.shape), jnp.float32), tree)


def _toy(**kw):
    """(JAX model, perturbed params, port training model with those weights
    and frozen, port cfg)."""
    jcfg = JaxConfig(**dict(TOY, **kw), dtype=jnp.float32)
    jm = JaxPixArt(jcfg)
    extra = {}
    if jcfg.micro_condition:
        extra = dict(img_hw=jnp.ones((1, 2)), aspect_ratio=jnp.ones((1, 1)))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 8, 24)), jnp.ones((1, 8), jnp.int32),
                              **extra)["params"]
    params = _perturb(params, 1)
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = PixArtConfig(**fields, dtype=torch.float32)
    tm = PixArtMS_XL_2(device="cpu", train=True, **fields, dtype=torch.float32)
    tm.load_state_dict(state_dict_from_jax(params, cfg))
    return jm, params, tm.requires_grad_(False), cfg


@pytest.fixture(scope="module")
def micro():
    return _toy(micro_condition=True)


def _base(tm):
    return {n: p.detach() for n, p in tm.named_parameters()}


def test_the_adapted_set_equals_jax(micro):
    _, params, tm, cfg = micro
    want = jlora.init_lora_params(params, rank=2, rng=jax.random.PRNGKey(3))
    modules = lora.lora_modules(_base(tm), cfg)
    keys = [jax_param_path(f"{m}.weight", cfg).rsplit("/", 1)[0] for m in modules]
    assert set(keys) == set(want)
    for key, entry in want.items():  # one port adapter per stacked layer
        lead = entry["a"].shape[0] if key.startswith("blocks_scan_") else 1
        assert keys.count(key) == lead, key
    assert {"x_embedder.proj", "t_block.1", "final_layer.linear", "t_embedder.mlp.0",
            "y_embedder.y_proj.fc2", "csize_embedder.mlp.0", "ar_embedder.mlp.2",
            "blocks.3.attn.qkv", "blocks.0.cross_attn.kv_linear"} <= set(modules)
    assert not any(".sr" in m or "norm" in m for m in modules)


@pytest.mark.parametrize("use_dora", [False, True])
def test_zero_init_is_the_identity_bit_for_bit(micro, use_dora):
    _, _, tm, cfg = micro
    base = _base(tm)
    ad = lora.init_lora_params(base, cfg, rank=3, generator=torch.Generator().manual_seed(0),
                               use_dora=use_dora)
    merged = lora.apply_lora(base, ad, alpha=6.0)
    for n, v in base.items():
        assert torch.equal(merged[n], v), n
    rng = np.random.RandomState(2)
    args = (torch.from_numpy(rng.randn(2, 16, 16, 4).astype(np.float32)),
            torch.tensor([5.0, 600.0]), torch.from_numpy(rng.randn(2, 8, 24).astype(np.float32)),
            torch.ones(2, 8, dtype=torch.int32), torch.full((2, 2), 128.0), torch.ones(2, 1))
    with torch.no_grad():
        want = tm(*args)
        with lora.swapped_weights(tm, lora.adapted_weights(merged, ad)):
            got = tm(*args)
    assert torch.equal(got, want)
    assert all(isinstance(p, torch.nn.Parameter) for p in tm.parameters())


def _jax_adapters(params, use_dora, seed):
    """JAX's adapters with b (and m) moved off their initial values."""
    ad = jlora.init_lora_params(params, rank=3, rng=jax.random.PRNGKey(seed), use_dora=use_dora)
    rng = np.random.RandomState(seed)
    return {k: {n: jnp.asarray(np.asarray(v) + (0.02 if n != "a" else 0.0)
                               * rng.randn(*v.shape), jnp.float32) for n, v in e.items()}
            for k, e in ad.items()}


@pytest.mark.parametrize("use_dora,alpha,use_rslora", [
    (False, None, False), (False, 8.0, False), (False, 8.0, True), (True, 8.0, True),
    (True, None, False)])
def test_apply_and_merge_match_jax(micro, use_dora, alpha, use_rslora):
    _, params, tm, cfg = micro
    jad = _jax_adapters(params, use_dora, 4)
    kw = dict(alpha=alpha, use_rslora=use_rslora)
    want = state_dict_from_jax(jlora.apply_lora(params, jad, **kw), cfg)
    base = _base(tm)
    ad = lora.lora_state_dict_from_jax(jad, base, cfg)
    got = lora.apply_lora(base, ad, **kw)
    merged = lora.merge_lora(base, ad, **kw)
    assert sorted(got) == sorted(want)
    changed = 0
    for n, v in want.items():
        assert _rel_l2(got[n].detach(), v) <= 1e-6, (n, _rel_l2(got[n].detach(), v))
        assert torch.equal(merged[n], got[n].detach()), n
        changed += not torch.equal(v, base[n])
    assert changed == len(ad)
    jax_merged = state_dict_from_jax(jlora.merge_lora(params, jad, **kw), cfg)
    assert all(torch.equal(jax_merged[n], want[n]) for n in want)


def _draws(rng, B, T):
    t_rng, n_rng, _ = jax.random.split(rng, 3)
    t = jax.random.randint(t_rng, (B,), 0, T)
    noise = jax.random.normal(n_rng, (B, 16, 16, 4))
    return torch.from_numpy(np.array(t)), torch.from_numpy(np.array(noise))


@pytest.mark.parametrize("use_dora,snr_gamma,remat,drop", [
    (False, None, False, 0.0), (True, 5.0, True, 1.0)])
def test_two_train_steps_match_jax(use_dora, snr_gamma, remat, drop):
    jm, params, tm, cfg = _toy(class_dropout_prob=drop, grad_checkpointing=remat)
    jdiff = JaxIDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    diff = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    jad = _jax_adapters(params, use_dora, 5)
    base = _base(tm)
    ad = lora.lora_state_dict_from_jax(jad, base, cfg)
    rng = np.random.RandomState(6)
    batch = {"latents": rng.randn(2, 16, 16, 4).astype(np.float32),
             "y": rng.randn(2, 8, 24).astype(np.float32),
             "y_mask": (np.arange(8)[None] < np.asarray([[8], [3]])).astype(np.int32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}

    tx = optax.adamw(1e-3)
    jstep = jlora.make_lora_train_step(jm, jdiff, params, tx, snr_gamma=snr_gamma)
    opt_state = tx.init(jad)
    step = lora.make_lora_train_step(tm, diff, base, lora.adamw(list(lora.lora_parameters(ad)),
                                                                1e-3), snr_gamma=snr_gamma)
    before = {n: p.clone() for n, p in tm.named_parameters()}
    for i in range(2):
        key = jax.random.PRNGKey(10 + i)
        jad, opt_state, jloss = jstep(jad, opt_state, jbatch, key)
        t, noise = _draws(key, 2, 1000)
        loss = step(ad, tbatch, t=t, noise=noise)
        assert abs(loss - float(jloss)) <= 1e-5 * abs(float(jloss)), (i, loss, float(jloss))
    want = lora.lora_state_dict_from_jax(jad, base, cfg)
    for m, entry in want.items():
        for leaf, v in entry.items():
            assert _rel_l2(ad[m][leaf].detach(), v.detach()) <= 1e-4, (m, leaf)
    for n, p in tm.named_parameters():
        assert torch.equal(p, before[n]) and p.grad is None, n


def test_cli_writes_the_merged_pth(tmp_path):
    cfg_path = os.path.join(ROOT, "configs/pixart_sigma_config/"
                            "PixArt_sigma_xl2_img1024_internalms_kvcompress.py")
    write_feature_dataset(str(tmp_path / "data"), [(256, 256)] * 4, resolution=256,
                          caption_channels=24, max_length=8)
    config = tmp_path / "lora.py"
    config.write_text(
        f"_base_ = [{cfg_path!r}]\nimage_size = 256\naspect_ratio_type = 256\n"
        f"data_root = {str(tmp_path)!r}\n"
        "data = dict(root='data', load_vae_feat=True, load_t5_feat=True)\n"
        "model_max_length = 8\ntrain_batch_size = 2\nnum_workers = 2\nlog_interval = 1\n"
        "model_overrides = dict(depth=2, hidden_size=96, num_heads=2, caption_channels=24,\n"
        "                       kv_compress_layers=(1,))\n")
    cfg = read_config(str(config))
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config

    model = build_model_from_config(cfg, device="cpu", train=True)
    base_path = save_pth(str(tmp_path / "base.pth"), model.state_dict())
    out = train_pixart_lora.main([str(config), "--base", base_path, "--work-dir",
                                  str(tmp_path / "work"), "--rank", "2", "--max-steps", "2",
                                  "--device", "cpu"])
    assert len(out["losses"]) == 2 and all(np.isfinite(out["losses"]))
    assert any(e["b"].abs().sum() > 0 for e in out["lora"].values())  # the adapters moved
    merged = lora.merge_lora(out["base"], out["lora"])
    fresh = load_pth(build_model_from_config(cfg, device="cpu", train=True), out["merged_path"])
    for n, p in fresh.named_parameters():
        assert torch.equal(p, merged[n]), n
    assert not torch.equal(merged["blocks.0.attn.qkv.weight"],
                           out["base"]["blocks.0.attn.qkv.weight"])
