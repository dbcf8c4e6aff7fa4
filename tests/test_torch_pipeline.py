"""The port's sampling path against the JAX package, on the CPU.

A 20-step DPM-Solver++ CFG trajectory of a toy PixArt (depth 4, hidden 144,
2 heads, a 16x16 latent, KV compression conv x2 on layers 2-3, padded
12-token captions) runs through both pipelines from the same initial
`latents=`, both in float32: latents agree to atol 1e-3, and the uint8 images
through the same small VAE to within 1 level. The host-side schedule, time
grid, prompt and bucket helpers agree exactly.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.data import aspect as jaspect
from pixart_sigma_tpu.diffusion import dpm_solver as jdpm
from pixart_sigma_tpu.diffusion.schedules import named_beta_schedule as jax_betas
from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.models.t5 import PseudoT5Embedder as JaxPseudoT5
from pixart_sigma_tpu.models.vae import AutoencoderKL as JaxVAE
from pixart_sigma_tpu.models.vae import VAEConfig as JaxVAEConfig
from pixart_sigma_tpu.pipelines import PixArtPipeline as JaxPipeline
from pixart_sigma_tpu.utils.prompt import prepare_prompt_ar as jax_prepare_prompt_ar
from pixart_sigma_tpu_torch.data import aspect
from pixart_sigma_tpu_torch.diffusion import dpm_solver as tdpm
from pixart_sigma_tpu_torch.diffusion.schedules import named_beta_schedule
from pixart_sigma_tpu_torch.models.pixart import PixArtConfig, PixArtMS_XL_2
from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
from pixart_sigma_tpu_torch.pipelines import PixArtPipeline
from pixart_sigma_tpu_torch.utils.checkpoint import state_dict_from_jax, vae_state_dict_from_jax
from pixart_sigma_tpu_torch.utils.prompt import prepare_prompt_ar
from tests.test_torch_vae import _random_vae_params

TOY = dict(input_size=16, depth=4, hidden_size=144, num_heads=2, caption_channels=32,
           model_max_length=12, kv_compress_sampling="conv", kv_compress_scale=2,
           kv_compress_layers=(2, 3), dtype=jnp.float32)


def _perturb(tree, seed, scale):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + scale * rng.randn(*a.shape), jnp.float32), tree)


@pytest.fixture(scope="module")
def pipelines():
    """(JAX pipeline, port pipeline) with the same perturbed weights."""
    jcfg = JaxConfig(**TOY)
    jm = JaxPixArt(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 12, 32)), jnp.ones((1, 12), jnp.int32))
    params = {"params": _perturb(params["params"], 1, 0.05)}
    vcfg = JaxVAEConfig.small_test()
    jvae = JaxVAE(vcfg)
    vparams = {"params": _random_vae_params(vcfg, 2)}
    jpipe = JaxPipeline(jm, params, vae=jvae, vae_params=vparams)

    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = PixArtConfig(**kw, dtype=torch.float32)
    tm = PixArtMS_XL_2(device="cpu", **{f.name: getattr(cfg, f.name)
                                          for f in dataclasses.fields(cfg)})
    tm.load_state_dict(state_dict_from_jax(params["params"], cfg))
    tvae = build_vae(VAEConfig.small_test(), device="cpu")
    tvae.load_diffusers_state_dict(vae_state_dict_from_jax(vparams["params"], vcfg))
    return jpipe, PixArtPipeline(tm, vae=tvae, device="cpu")


def _conditioning(seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randn(2, 12, 32).astype(np.float32)
    y_null = rng.randn(2, 12, 32).astype(np.float32)
    mask = np.zeros((2, 12), np.int32)
    mask[0, :12], mask[1, :4] = 1, 1
    x0 = rng.randn(2, 16, 16, 4).astype(np.float32)
    return y, y_null, mask, x0


def test_dpm_solver_trajectory_matches_jax(pipelines):
    jpipe, tpipe = pipelines
    y, y_null, mask, x0 = _conditioning()
    call = dict(height=128, width=128, num_inference_steps=20, guidance_scale=4.5)
    want = jpipe(["a", "b"], y=jnp.asarray(y), y_mask=jnp.asarray(mask),
                 y_null=jnp.asarray(y_null), latents=jnp.asarray(x0), return_latents=True,
                 **call)
    got = tpipe(["a", "b"], y=torch.from_numpy(y), y_mask=torch.from_numpy(mask),
                y_null=torch.from_numpy(y_null), latents=torch.from_numpy(x0),
                return_latents=True, **call)
    assert got.shape == (2, 16, 16, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3, rtol=1e-3)
    want_img = jpipe._latents_to_images(jnp.asarray(want))
    got_img = tpipe._latents_to_images(torch.from_numpy(got))
    assert got_img.dtype == np.uint8 and got_img.shape == want_img.shape == (2, 32, 32, 3)
    assert np.abs(got_img.astype(int) - want_img.astype(int)).max() <= 1


def test_pipeline_with_text_encoder_and_ar_prompt(pipelines):
    """Prompt flags, the pseudo text encoder and the VAE, end to end."""
    _, tpipe = pipelines
    tpipe.t5 = PseudoT5Embedder(dim=32, model_max_length=12)
    try:
        img = tpipe(["a cat on a mat --ar 1:2", "a dog"], height=128, width=128,
                    num_inference_steps=3, negative_prompt="blurry")
    finally:
        tpipe.t5 = None
    assert img.shape == (2, 32, 32, 3) and img.dtype == np.uint8


def test_pipeline_refuses_what_is_not_ported(pipelines):
    _, tpipe = pipelines
    with pytest.raises(NotImplementedError, match="not ported"):
        tpipe(["a"], sampler="deis")
    with pytest.raises(NotImplementedError, match="not ported"):
        tpipe(["a"], block_cache_interval=2)
    ns = tdpm.NoiseScheduleVP("discrete", betas=named_beta_schedule("linear", 1000))
    with pytest.raises(NotImplementedError):
        tdpm.DPMSolver(lambda x, t: x, ns, algorithm_type="dpmsolver")
    with pytest.raises(NotImplementedError):
        tdpm.DPMSolver(lambda x, t: x, ns).sample(torch.zeros(1), steps=5, order=3)
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            PixArtPipeline(tpipe.model)


@pytest.mark.parametrize("schedule", ["linear", "squaredcos_cap_v2"])
def test_schedule_and_time_grid_match_jax(schedule):
    betas = named_beta_schedule(schedule, 1000)
    np.testing.assert_array_equal(betas, jax_betas(schedule, 1000))
    ns, jns = tdpm.NoiseScheduleVP("discrete", betas=betas), jdpm.NoiseScheduleVP(
        "discrete", betas=betas)
    np.testing.assert_array_equal(ns.log_alpha_array, jns.log_alpha_array)
    t = np.linspace(1e-3, 1.0, 7)
    for fn in ("marginal_alpha", "marginal_std", "marginal_lambda"):
        np.testing.assert_array_equal(getattr(ns, fn)(t), getattr(jns, fn)(t))
    for skip in ("logSNR", "time_uniform", "time_quadratic", "karras"):
        np.testing.assert_array_equal(tdpm.get_time_steps(ns, skip, 1.0, 1e-3, 20),
                                      jdpm.get_time_steps(jns, skip, 1.0, 1e-3, 20))


def test_prompt_buckets_and_pseudo_t5_match_jax():
    for base in (256, 1024, 2048, 128):
        for test in (False, True):
            assert aspect.aspect_ratio_table(base, test) == jaspect.aspect_ratio_table(base, test)
    table = aspect.aspect_ratio_table(1024, True)
    assert aspect.get_closest_ratio(1152, 896, table) == jaspect.get_closest_ratio(
        1152, 896, table)
    for prompt in ("a cat", "a fox --hw 1152:896", "a dog --ar 1:2 ", "x --ar 16:9"):
        for got, want in zip(prepare_prompt_ar(prompt, table),
                             jax_prepare_prompt_ar(prompt, table)):
            np.testing.assert_array_equal(np.asarray(got), np.asarray(want))
    texts = ["a red cat on a hill", "", "one"]
    y, mask = PseudoT5Embedder(16, 4).get_text_embeddings(texts)
    jy, jmask = JaxPseudoT5(16, 4).get_text_embeddings(texts)
    np.testing.assert_array_equal(y.numpy(), np.asarray(jy))
    np.testing.assert_array_equal(mask.numpy(), np.asarray(jmask))
