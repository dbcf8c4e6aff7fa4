"""Every sampler of the port's pipeline against the JAX pipeline, on the CPU.

The toy PixArt of `tests/test_torch_pipeline.py` (depth 4, hidden 144, 2
heads, a 16x16 latent, KV compression conv x2 on layers 2-3, 12-token
captions, perturbed weights) runs in both pipelines with the pseudo text
encoder, so the negative prompt's mask (1 token) differs from the prompts'
(5 and 2 tokens): iDDPM's [cond, uncond] batch runs under the
[negative, prompt] masks in both. Both start from the same `latents=`; the
port takes JAX's per-step draws, rebuilt here from the pipeline's key as
each JAX sampler splits it. Float32: latents agree to atol 1e-3 with rtol
1e-3 (the DPM test's limits; the toy's random eps drives the latents to a
few hundred, and they read about 1e-6 relative L2). In bfloat16 the two
models round differently and the x0 predictions amplify it by 1/alpha at
the start: an SA-Solver and an LCM trajectory agree within 4e-2 relative L2,
twice the worst reading of the guided samplers (1.8e-2; LCM 4.8e-3).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.models.t5 import PseudoT5Embedder as JaxPseudoT5
from pixart_sigma_tpu.pipelines import PixArtPipeline as JaxPipeline
from pixart_sigma_tpu_torch.models.pixart import PixArtConfig, PixArtMS_XL_2
from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
from pixart_sigma_tpu_torch.pipelines import PixArtPipeline
from pixart_sigma_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.test_torch_pipeline import TOY, _perturb

PROMPTS = ["a cat on a mat", "a dog"]
NEGATIVE = "blurry"
SEED = 3
# sampler -> (steps, guidance); the short step counts keep the file quick
CASES = {"deis": (6, 4.5), "sde-dpm-solver": (8, 4.5), "sa-solver": (6, 4.5),
         "iddpm": (10, 4.5), "lcm": (4, 1.0), "dmd": (1, 1.0)}


def jax_draws(sampler: str, steps: int, seed: int = SEED):
    """The port's noise_fn(k, shape) holding the JAX pipeline's k-th
    per-step draw: the pipeline splits PRNGKey(seed) into (rng, init) and
    hands rng to the sampler."""
    rng, _ = jax.random.split(jax.random.PRNGKey(seed))
    if sampler == "sde-dpm-solver":  # sample_sde: split(rng, steps)[k]
        keys, offset = jax.random.split(rng, steps), 0
    elif sampler == "sa-solver":  # step k >= 1 takes split(rng, steps + 1)[k]
        keys, offset = jax.random.split(rng, steps + 1), 1
    elif sampler in ("iddpm", "lcm"):  # rng, _ = split(rng); split(rng, n)[k]
        rng, _ = jax.random.split(rng)
        keys, offset = jax.random.split(rng, steps), 0
    else:
        return None
    return lambda k, shape: torch.from_numpy(
        np.array(jax.random.normal(keys[k + offset], tuple(shape), jnp.float32)))


def _pair(dtype, seed):
    jcfg = JaxConfig(**dict(TOY, dtype=dtype))
    jm = JaxPixArt(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(seed), jnp.zeros((1, 16, 16, 4)),
                              jnp.zeros((1,)), jnp.zeros((1, 12, 32)),
                              jnp.ones((1, 12), jnp.int32))
    params = {"params": _perturb(params["params"], seed + 1, 0.05)}
    jpipe = JaxPipeline(jm, params, t5=JaxPseudoT5(32, 12))
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = PixArtConfig(**kw, dtype=torch.bfloat16 if dtype == jnp.bfloat16 else torch.float32)
    tm = PixArtMS_XL_2(device="cpu", **{f.name: getattr(cfg, f.name)
                                          for f in dataclasses.fields(cfg)})
    tm.load_state_dict(state_dict_from_jax(params["params"], cfg))
    return jpipe, PixArtPipeline(tm, t5=PseudoT5Embedder(32, 12), device="cpu")


@pytest.fixture(scope="module")
def pipelines():
    return _pair(jnp.float32, 0)


@pytest.fixture(scope="module")
def pipelines_bf16():
    return _pair(jnp.bfloat16, 5)


def _run_both(jpipe, tpipe, sampler, steps, guidance):
    x0 = np.random.RandomState(7).randn(2, 16, 16, 4).astype(np.float32)
    call = dict(height=128, width=128, num_inference_steps=steps, guidance_scale=guidance,
                sampler=sampler, negative_prompt=NEGATIVE, seed=SEED, return_latents=True)
    want = np.asarray(jpipe(PROMPTS, latents=jnp.asarray(x0), **call))
    got = tpipe(PROMPTS, latents=torch.from_numpy(x0), noise_fn=jax_draws(sampler, steps),
                **call)
    assert got.shape == want.shape == (2, 16, 16, 4) and np.isfinite(got).all()
    assert np.abs(got - x0).max() > 1e-2  # the sampler moved the latents
    return got, want


def test_negative_mask_differs_from_the_prompts(pipelines):
    _, tpipe = pipelines
    _, mask = tpipe.encode_prompts(PROMPTS)
    _, null_mask = tpipe.encode_prompts([NEGATIVE] * 2)
    assert mask.sum(1).tolist() == [5, 2] and null_mask.sum(1).tolist() == [1, 1]


@pytest.mark.parametrize("sampler", list(CASES))
def test_sampler_trajectory_matches_jax(pipelines, sampler):
    steps, guidance = CASES[sampler]
    got, want = _run_both(*pipelines, sampler, steps, guidance)
    np.testing.assert_allclose(got, want, atol=1e-3, rtol=1e-3)


def test_iddpm_pairs_the_cond_batch_with_the_negative_mask(pipelines, monkeypatch):
    """The model sees captions [cond, uncond] under masks [negative, prompt]
    and integer timesteps from the respaced chain, as in JAX."""
    _, tpipe = pipelines
    seen = []
    forward = tpipe.model.forward

    def spy(x, t, y, y_mask=None, **kw):
        seen.append((t.clone(), y_mask.clone(), kw["cross_kv"][0].clone()))
        return forward(x, t, y, y_mask, **kw)

    monkeypatch.setattr(tpipe.model, "forward", spy)
    x0 = torch.from_numpy(np.random.RandomState(7).randn(2, 16, 16, 4).astype(np.float32))
    tpipe(PROMPTS, height=128, width=128, num_inference_steps=10, sampler="iddpm",
          negative_prompt=NEGATIVE, latents=x0, return_latents=True)
    assert len(seen) == 10
    t, mask, kv = seen[0]
    assert t.dtype == torch.long and t.tolist() == [999] * 4
    assert [int(tt[0]) for tt, _, _ in seen][-1] == 0
    assert mask.sum(1).tolist() == [1, 1, 5, 2]
    y, _ = tpipe.encode_prompts(PROMPTS)
    y_null, _ = tpipe.encode_prompts([NEGATIVE] * 2)
    want = tpipe._hoisted_kv(torch.cat([y, y_null]))[0]
    torch.testing.assert_close(kv, want)


@pytest.mark.parametrize("sampler", ["sa-solver", "lcm"])
def test_sampler_trajectory_matches_jax_in_bfloat16(pipelines_bf16, sampler):
    steps, guidance = CASES[sampler]
    got, want = _run_both(*pipelines_bf16, sampler, steps, guidance)
    assert np.linalg.norm(got - want) / np.linalg.norm(want) < 4e-2


def test_default_noise_is_seeded_and_on_the_generator(pipelines):
    """Without noise_fn the draws come from the seeded generator: the same
    seed repeats, another seed moves a stochastic sampler."""
    _, tpipe = pipelines
    call = dict(height=128, width=128, num_inference_steps=6, sampler="sa-solver",
                return_latents=True)
    a = tpipe(PROMPTS, seed=1, **call)
    b = tpipe(PROMPTS, seed=1, **call)
    x0 = torch.randn(a.shape, generator=torch.Generator().manual_seed(0))
    c = tpipe(PROMPTS, seed=1, latents=x0, **call)
    d = tpipe(PROMPTS, seed=2, latents=x0, **call)
    np.testing.assert_array_equal(a, b)
    assert np.abs(c - d).max() > 1e-3
