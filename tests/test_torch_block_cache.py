"""Delta block caching in the port against the JAX package, on the CPU.

A toy PixArt (depth 4, width 64, 2 heads, 16-token captions, KV compression
on layers 2-3, `cache_span=(1, 3)`), f32, with the same perturbed weights in
both packages:

- the model's three cache branches (no cache; reuse; compute) against JAX's
  `model.apply(block_cache=, use_block_cache=)`: the output and the new
  cache within 1e-4 (the uncached model's tolerance);
- the pipeline's cached DPM-Solver++ (10 steps, CFG 4.5) against JAX
  `_build_dpm_cached` from the same initial latents, within 1e-3 (the
  uncached trajectory's tolerance in tests/test_torch_pipeline.py), for
  interval 1 and 2, a schedule of every step and a sparse one, and the
  adaptive threshold at 0, 0.15 and 1.0;
- interval 1, a schedule of every step and threshold 0 equal the uncached
  trajectory bit for bit (the same operations), and the refusals.
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
from pixart_sigma_tpu.pipelines import PixArtPipeline as JaxPipeline
from pixart_sigma_tpu_torch.diffusion.dpm_solver import DPMSolver, NoiseScheduleVP
from pixart_sigma_tpu_torch.diffusion.schedules import named_beta_schedule
from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2
from pixart_sigma_tpu_torch.pipelines import PixArtPipeline
from pixart_sigma_tpu_torch.utils.checkpoint import state_dict_from_jax

TOY = dict(input_size=16, depth=4, hidden_size=64, num_heads=2, caption_channels=32,
           model_max_length=16, kv_compress_sampling="conv", kv_compress_scale=2,
           kv_compress_layers=(2, 3), cache_span=(1, 3))
MODEL_TOL = dict(atol=1e-4, rtol=1e-4)
PATH_TOL = dict(atol=1e-3, rtol=1e-3)
STEPS = 10


def _port_model(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    fields.update(kw)
    return PixArtMS_XL_2(device="cpu", dtype=torch.float32, **fields)


@pytest.fixture(scope="module")
def toy():
    """(JAX model, its params, the port model with the same weights)."""
    jcfg = JaxConfig(**TOY, dtype=jnp.float32)
    jm = JaxPixArt(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 16, 32)), jnp.ones((1, 16), jnp.int32))
    rng = np.random.RandomState(1)
    params = {"params": jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape), jnp.float32),
        params["params"])}
    tm = _port_model(jcfg)
    tm.load_state_dict(state_dict_from_jax(params["params"], tm.cfg))
    return jm, params, tm


def _model_inputs(seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(2, 16, 16, 4).astype(np.float32)
    t = np.asarray([10.0, 700.0], np.float32)
    y = rng.randn(2, 16, 32).astype(np.float32)
    mask = np.zeros((2, 16), np.int32)
    mask[0], mask[1, :5] = 1, 1
    cache = (rng.randn(2, 64, 64) * 0.5).astype(np.float32)
    return x, t, y, mask, cache


@pytest.mark.parametrize("branch", ["none", "reuse", "compute"])
def test_model_cache_branches_match_jax(toy, branch):
    jm, params, tm = toy
    x, t, y, mask, cache = _model_inputs()
    jargs = tuple(map(jnp.asarray, (x, t, y, mask)))
    targs = tuple(torch.from_numpy(a) for a in (x, t, y, mask))
    if branch == "none":  # the span runs; the new cache is not returned
        want = jax.jit(jm.apply)(params, *jargs)
        with torch.no_grad():
            got = tm(*targs)
            plain = _port_model(jm.cfg, cache_span=None)
            plain.load_state_dict(tm.state_dict())
            assert torch.equal(got, plain(*targs))
        np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
        return
    use = branch == "reuse"
    want, want_cache = jax.jit(lambda p, *a, c: jm.apply(
        p, *a, block_cache=c, use_block_cache=jnp.asarray(use)))(params, *jargs,
                                                                 c=jnp.asarray(cache))
    with torch.no_grad():
        got, got_cache = tm(*targs, block_cache=torch.from_numpy(cache), use_block_cache=use)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), **MODEL_TOL)
    np.testing.assert_allclose(got_cache.numpy(), np.asarray(want_cache), **MODEL_TOL)
    if use:  # the cache passes through
        np.testing.assert_array_equal(got_cache.numpy(), cache)


@pytest.fixture(scope="module")
def pipelines(toy):
    jm, params, tm = toy
    return JaxPipeline(jm, params, base_resolution=256), PixArtPipeline(tm, device="cpu")


def _conditioning(seed=0):
    rng = np.random.RandomState(seed)
    y = rng.randn(2, 16, 32).astype(np.float32)
    y_null = rng.randn(2, 16, 32).astype(np.float32)
    mask = np.zeros((2, 16), np.int32)
    mask[0], mask[1, :6] = 1, 1
    x0 = rng.randn(2, 16, 16, 4).astype(np.float32)
    return y, y_null, mask, x0


def _call(pipe, module, **kw):
    y, y_null, mask, x0 = _conditioning()
    cast = jnp.asarray if module is jnp else torch.from_numpy
    return np.asarray(pipe(["a", "b"], height=128, width=128, num_inference_steps=STEPS,
                           guidance_scale=4.5, y=cast(y), y_mask=cast(mask), y_null=cast(y_null),
                           latents=cast(x0), return_latents=True, **kw))


def _interval_one(pipe, module):
    """A package's cached builder called directly with interval 1 (the
    pipelines' routing takes the cache from interval 2 on)."""
    y, y_null, mask, x0 = _conditioning()
    args = (x0, y, y_null, np.concatenate([mask, mask]), np.ones((2, 2), np.float32),
            np.ones((2, 1), np.float32))
    if module is jnp:
        run = pipe._build_dpm_cached(2, 16, 16, STEPS, 4.5, False, interval=1)
        return np.asarray(run(pipe.params, *map(jnp.asarray, args)))
    with torch.no_grad():
        return pipe._build_dpm_cached(STEPS, 4.5, 1)(*map(torch.from_numpy, args), None).numpy()


POLICIES = {
    "interval 2": dict(block_cache_interval=2),
    "schedule of every step": dict(block_cache_schedule=list(range(STEPS))),
    "sparse schedule": dict(block_cache_schedule=[9, 0, 1, 3, 3, 6]),
    "threshold 0": dict(block_cache_threshold=0.0),
    "threshold 0.15": dict(block_cache_threshold=0.15),
    # 0.15 refreshes every step of this toy trajectory; 1.0 reuses the
    # cache on 3 of the 10 model calls (4, 6 and 8)
    "threshold 1.0": dict(block_cache_threshold=1.0),
}


@pytest.mark.parametrize("policy", ["interval 1", *POLICIES])
def test_cached_dpm_solver_matches_jax(pipelines, policy):
    jpipe, tpipe = pipelines
    if policy == "interval 1":
        got, want = _interval_one(tpipe, torch), _interval_one(jpipe, jnp)
    else:
        want = _call(jpipe, jnp, **POLICIES[policy])
        got = _call(tpipe, torch, **POLICIES[policy])
    assert got.shape == (2, 16, 16, 4) and np.isfinite(got).all()
    np.testing.assert_allclose(got, want, **PATH_TOL)


def test_exact_policies_equal_the_uncached_trajectory(pipelines):
    _, tpipe = pipelines
    exact = _call(tpipe, torch)
    np.testing.assert_array_equal(_interval_one(tpipe, torch), exact)
    for policy in ("schedule of every step", "threshold 0"):
        np.testing.assert_array_equal(_call(tpipe, torch, **POLICIES[policy]), exact)
    # the approximate policies do change the trajectory
    for policy in ("interval 2", "sparse schedule", "threshold 1.0"):
        assert np.abs(_call(tpipe, torch, **POLICIES[policy]) - exact).max() > 1e-3


def test_cache_refusals(pipelines):
    _, tpipe = pipelines
    with pytest.raises(ValueError, match="requires sampler='dpm-solver'"):
        _call(tpipe, torch, sampler="sa-solver", block_cache_interval=2)
    with pytest.raises(ValueError, match="step 0"):
        _call(tpipe, torch, block_cache_schedule=[1, 4])
    plain = PixArtPipeline(_port_model(tpipe.model.cfg, cache_span=None), device="cpu")
    with pytest.raises(ValueError, match="cache_span"):
        _call(plain, torch, block_cache_interval=2)
    with pytest.raises(ValueError, match="cache_span"):
        _port_model(tpipe.model.cfg, cache_span=(3, 5))


def test_sample_scan_carries_the_state_and_refreshes_step_zero():
    """The state rides the loop; the first call refreshes whatever the mask
    says, and step i gets use_cache = not refresh_mask[i]."""
    ns = NoiseScheduleVP("discrete", betas=named_beta_schedule("linear", 1000))
    calls = []

    def state_model_fn(x, t, state, use_cache):
        calls.append(use_cache)
        return 0.1 * x, state + 1

    solver = DPMSolver(lambda *_: None, ns, algorithm_type="dpmsolver++")
    x, state = solver.sample_scan(torch.ones(2, 3), steps=5, t_start=ns.T, t_end=1e-3,
                                  state_model_fn=state_model_fn, model_state=0,
                                  refresh_mask=[False, True, False, False, True],
                                  return_state=True)
    assert calls == [False, False, True, True, False] and state == 5
    plain = DPMSolver(lambda x, t: 0.1 * x, ns, algorithm_type="dpmsolver++").sample_scan(
        torch.ones(2, 3), steps=5, t_start=ns.T, t_end=1e-3)
    assert torch.equal(x, plain)
