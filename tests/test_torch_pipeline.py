"""The port's sampling path against the JAX package, on the CPU.

A 20-step DPM-Solver++ CFG trajectory of a toy PixArt (depth 4, hidden 144,
2 heads, a 16x16 latent, KV compression conv x2 on layers 2-3, padded
12-token captions) runs through both pipelines from the same initial
`latents=`, both in float32: latents agree to atol 1e-3, and the uint8 images
through the same small VAE to within 1 level, beyond 1024px through the tiled
decode. A toy trajectory through the flash kernels in both packages agrees
the same way. The host-side schedule, time grid, prompt and bucket helpers
(the 2880 grid included) agree exactly.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from jax.experimental.pallas import tpu as pltpu

from pixart_sigma_tpu.data import aspect as jaspect
from pixart_sigma_tpu.diffusion import dpm_solver as jdpm
from pixart_sigma_tpu.diffusion.schedules import named_beta_schedule as jax_betas
from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.models.t5 import PseudoT5Embedder as JaxPseudoT5
from pixart_sigma_tpu.models.vae import AutoencoderKL as JaxVAE
from pixart_sigma_tpu.models.vae import VAEConfig as JaxVAEConfig
from pixart_sigma_tpu.models.vae import make_tiled_decode as jax_make_tiled_decode
from pixart_sigma_tpu.pipelines import PixArtPipeline as JaxPipeline
from pixart_sigma_tpu.utils.prompt import prepare_prompt_ar as jax_prepare_prompt_ar
from pixart_sigma_tpu_torch.data import aspect
from pixart_sigma_tpu_torch.diffusion import dpm_solver as tdpm
from pixart_sigma_tpu_torch.diffusion.schedules import named_beta_schedule
from pixart_sigma_tpu_torch.models.pixart import PixArtConfig, PixArtMS_XL_2
from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae, tiled_decode
from pixart_sigma_tpu_torch.ops import attention as tattention
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
    """Block caching needs a model built with cache_span and the dpm-solver
    sampler, as in JAX (every sampler name is ported); an unknown sampler,
    algorithm or an SDE solver without noise is an error."""
    _, tpipe = pipelines
    for kw in (dict(block_cache_interval=2), dict(block_cache_threshold=0.1)):
        with pytest.raises(ValueError, match="cache_span"):
            tpipe(["a"], **kw)
    with pytest.raises(ValueError, match="requires sampler='dpm-solver'"):
        tpipe(["a"], sampler="sa-solver", block_cache_schedule=[0, 2])
    with pytest.raises(ValueError, match="unknown sampler"):
        tpipe(["a"], sampler="euler")
    ns = tdpm.NoiseScheduleVP("discrete", betas=named_beta_schedule("linear", 1000))
    with pytest.raises(ValueError):
        tdpm.DPMSolver(lambda x, t: x, ns, algorithm_type="dpm-solver")
    with pytest.raises(ValueError, match="sample_sde"):
        tdpm.DPMSolver(lambda x, t: x, ns, "sde-dpmsolver++").sample(torch.zeros(1), steps=5)
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


def test_aspect_tables_match_jax_for_every_base_resolution():
    """The hand-tuned 2880 grid and its test table, whose square bucket is
    4096 x 4096, beside the scaled tables and the single-bucket fallback."""
    for base in (256, 512, 1024, 2048, 2880, 128, 4096):
        for test in (False, True):
            assert aspect.aspect_ratio_table(base, test) == jaspect.aspect_ratio_table(base, test)
    assert aspect.aspect_ratio_table(2880, True)["1.0"] == [4096, 4096]
    assert aspect.aspect_ratio_table(2880)["1.0"] == [2880.0, 2880.0]


def test_latents_beyond_1024px_take_the_tiled_decode(pipelines):
    """136 x 144 latents: both pipelines decode tile by tile (64 latents,
    overlap 16: 3 x 3 tiles) to the same uint8 images within 1 level."""
    jpipe, tpipe = pipelines
    z = np.random.RandomState(5).randn(1, 136, 144, 4).astype(np.float32) * 0.5
    want = jpipe._latents_to_images(jnp.asarray(z))
    got = tpipe._latents_to_images(torch.from_numpy(z))
    assert got.dtype == np.uint8 and got.shape == want.shape == (1, 272, 288, 3)
    assert np.abs(got.astype(int) - want.astype(int)).max() <= 1


def test_flash_trajectory_matches_jax(monkeypatch):
    """A toy PixArtMS (2 blocks, 2 heads of 72, KV compression on layer 1)
    with attn_impl="flash" in both packages (the JAX flash kernel in
    interpret mode): a 4-step CFG trajectory to latents, then the tiled
    decode of those latents with tile 8 and overlap 2, float32 throughout.
    Latents within 1e-3, images within 1 level."""
    toy = dict(TOY, depth=2, kv_compress_layers=(1,), attn_impl="flash")
    jcfg = JaxConfig(**toy)
    jm = JaxPixArt(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(3), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 12, 32)), jnp.ones((1, 12), jnp.int32))
    params = {"params": _perturb(params["params"], 4, 0.05)}
    jpipe = JaxPipeline(jm, params)
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = PixArtConfig(**kw, dtype=torch.float32)
    tm = PixArtMS_XL_2(device="cpu", **{f.name: getattr(cfg, f.name)
                                          for f in dataclasses.fields(cfg)})
    tm.load_state_dict(state_dict_from_jax(params["params"], cfg))
    tpipe = PixArtPipeline(tm, device="cpu")
    y, y_null, mask, x0 = _conditioning(1)
    call = dict(height=128, width=128, num_inference_steps=4, guidance_scale=4.5,
                return_latents=True)
    with pltpu.force_tpu_interpret_mode():
        want = jpipe(["a", "b"], y=jnp.asarray(y), y_mask=jnp.asarray(mask),
                     y_null=jnp.asarray(y_null), latents=jnp.asarray(x0), **call)
    calls = []
    flash = tattention.flash_attention
    monkeypatch.setattr(tattention, "flash_attention",
                        lambda *a, **kw: calls.append(1) or flash(*a, **kw))
    got = tpipe(["a", "b"], y=torch.from_numpy(y), y_mask=torch.from_numpy(mask),
                y_null=torch.from_numpy(y_null), latents=torch.from_numpy(x0), **call)
    assert got.shape == (2, 16, 16, 4) and np.isfinite(got).all()
    assert len(calls) == 4 * 2 * 2  # steps x blocks x (self, cross)
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3, rtol=1e-3)

    vcfg = JaxVAEConfig.small_test()
    jvae, vparams = JaxVAE(vcfg), _random_vae_params(vcfg, 6)
    tvae = build_vae(VAEConfig.small_test(), device="cpu")
    tvae.load_diffusers_state_dict(vae_state_dict_from_jax(vparams, vcfg))
    scale = jpipe.scale_factor
    decode = lambda zz: jvae.apply({"params": vparams}, zz, method=JaxVAE.decode)
    want_img = jax_make_tiled_decode(decode, tile=8, overlap=2)(jnp.asarray(want) / scale)
    with torch.no_grad():
        got_img = tiled_decode(tvae.decode, torch.from_numpy(got) / scale, tile=8, overlap=2)
    to_u8 = lambda a: (np.clip((np.asarray(a) + 1) / 2, 0, 1) * 255).round().astype(int)
    assert np.abs(to_u8(got_img.numpy()) - to_u8(want_img)).max() <= 1


def test_pipeline_with_the_t5_encoder_matches_jax(pipelines):
    """Prompts and the negative prompt encoded by each package's
    T5Embedder (toy widths, one toy tokenizer object, the same weights),
    cleaned and padded to 12 tokens, then the same CFG trajectory."""
    from pixart_sigma_tpu.models.t5 import T5Config as JaxT5Config
    from pixart_sigma_tpu.models.t5 import T5Embedder as JaxT5Embedder
    from pixart_sigma_tpu_torch.models.t5 import T5Config, T5Embedder, build_t5
    from pixart_sigma_tpu_torch.utils.checkpoint import t5_state_dict_from_jax
    from tests.test_torch_t5 import WordHashTokenizer, _jax_params

    jpipe, tpipe = pipelines
    tcfg = JaxT5Config.small_test(num_layers=2)
    tparams = _jax_params(tcfg, seed=7)
    enc = build_t5(T5Config.small_test(num_layers=2), device="cpu")
    enc.load_hf_state_dict(t5_state_dict_from_jax(tparams, tcfg))
    jpipe.t5 = JaxT5Embedder(tparams, tcfg, WordHashTokenizer(), model_max_length=12)
    tpipe.t5 = T5Embedder(enc, WordHashTokenizer(), model_max_length=12)
    x0 = np.random.RandomState(3).randn(2, 16, 16, 4).astype(np.float32)
    prompts = ["A <i>red</i> fox in the snow", "a lighthouse on a cliff at dusk, oil painting"]
    call = dict(height=128, width=128, num_inference_steps=8, guidance_scale=4.5,
                negative_prompt="blurry, low quality", return_latents=True)
    try:
        want = jpipe(prompts, latents=jnp.asarray(x0), **call)
        got = tpipe(prompts, latents=torch.from_numpy(x0), **call)
    finally:
        jpipe.t5 = tpipe.t5 = None
    assert got.shape == (2, 16, 16, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), atol=1e-3, rtol=1e-3)
