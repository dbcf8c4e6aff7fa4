"""The sampling half of the port's iDDPM diffusion against the JAX package's,
on the CPU: ancestral (`p_sample_loop`), DDIM (`ddim_sample_loop`) and DDIM
inversion (`ddim_reverse_sample_loop`) through a 10-step `SpacedDiffusion`,
each variance and mean type, clipping, classifier guidance of the mean and
of the score. A fixed analytic model in both frameworks sees the timesteps
each loop feeds it; the port takes JAX's per-step draws (the loop's key
split as `p_sample_loop` splits it). Float32 trajectories agree to rtol and
atol 1e-4; the variance tables exactly (the same f32 arrays).
"""

from functools import partial

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussian
from pixart_sigma_tpu.diffusion.gaussian import ModelMeanType as JMean
from pixart_sigma_tpu.diffusion.gaussian import ModelVarType as JVar
from pixart_sigma_tpu.diffusion.gaussian import LossType as JLoss
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.diffusion.gaussian import (
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
)
from pixart_sigma_tpu_torch.diffusion.schedules import ScheduleCoefficients, named_beta_schedule

SHAPE = (2, 4, 4, 3)
_B = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
_X = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)


def close(got, want, tol=1e-4):
    got = got.numpy()
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol)


def models(channels: int):
    """(torch, jax) model_fn(x, t): eps-like 0.3 x + (t / 1000) b, then a
    tanh(x) variance head when the model learns its variance."""
    def tmodel(x, t):
        out = 0.3 * x + (t.float() / 1000.0).reshape(-1, 1, 1, 1) * torch.from_numpy(_B)
        return out if channels == 3 else torch.cat([out, torch.tanh(x)], -1)

    def jmodel(x, t):
        out = 0.3 * x + (t.astype(jnp.float32) / 1000.0).reshape(-1, 1, 1, 1) * _B
        return out if channels == 3 else jnp.concatenate([out, jnp.tanh(x)], -1)

    return tmodel, jmodel


def loop_draws(rng, T):
    """p_sample_loop's keys: rng, _ = split(rng); split(rng, T)[k] at step k."""
    keys = jax.random.split(jax.random.split(rng)[0], T)
    return lambda k, shape: torch.from_numpy(
        np.array(jax.random.normal(keys[k], tuple(shape), jnp.float32)))


SPACED = [
    dict(learn_sigma=True),
    dict(learn_sigma=False),
    dict(learn_sigma=False, sigma_small=True),
    dict(learn_sigma=True, predict_xstart=True),
]


@pytest.mark.parametrize("kw", SPACED)
@pytest.mark.parametrize("clip", [True, False])
def test_p_sample_loop_matches_jax(kw, clip):
    td, jd = IDDPM("10", **kw), JaxIDDPM("10", **kw)
    tmodel, jmodel = models(6 if kw["learn_sigma"] else 3)
    rng = jax.random.PRNGKey(3)
    got = td.p_sample_loop(tmodel, torch.from_numpy(_X), loop_draws(rng, 10), clip_denoised=clip)
    want = jd.p_sample_loop(jmodel, SHAPE, rng, noise=jnp.asarray(_X), clip_denoised=clip)
    close(got, want)


def test_p_sample_loop_feeds_the_original_chain_timesteps():
    seen = []
    td = IDDPM("10").to("cpu")
    tmodel, _ = models(6)
    td.p_sample_loop(lambda x, t: seen.append(t.tolist()) or tmodel(x, t),
                     torch.from_numpy(_X), lambda k, s: torch.zeros(s))
    assert [s[0] for s in seen] == td.timestep_map.flip(0).tolist()
    assert seen[0] == [999, 999] and seen[-1] == [0, 0]


def test_guided_and_single_steps_match_jax():
    """condition_mean through p_sample_loop, one p_sample step, and the
    model variants the factory does not build (x_{t-1} prediction, learned
    log-variance)."""
    td, jd = IDDPM("10"), JaxIDDPM("10")
    tmodel, jmodel = models(6)
    tgrad = lambda x, t: -0.1 * x
    jgrad = lambda x, t: -0.1 * x
    rng = jax.random.PRNGKey(4)
    close(td.p_sample_loop(tmodel, torch.from_numpy(_X), loop_draws(rng, 10), cond_fn=tgrad),
          jd.p_sample_loop(jmodel, SHAPE, rng, noise=jnp.asarray(_X), cond_fn=jgrad))
    t, key = np.array([7, 0]), jax.random.PRNGKey(5)
    z = np.array(jax.random.normal(key, SHAPE, jnp.float32))
    got, got_x0 = td.p_sample(tmodel, torch.from_numpy(_X), torch.from_numpy(t),
                              torch.from_numpy(z))
    want, want_x0 = jd.p_sample(jmodel, jnp.asarray(_X), jnp.asarray(t), key)
    close(got, want)
    close(got_x0, want_x0)
    betas = named_beta_schedule("linear", 50)
    for mean, var, channels in ((ModelMeanType.PREVIOUS_X, ModelVarType.FIXED_LARGE, 3),
                                (ModelMeanType.EPSILON, ModelVarType.LEARNED, 6)):
        tg = GaussianDiffusion(ScheduleCoefficients.create(betas), mean, var)
        jg = JaxGaussian.create(betas=betas, model_mean_type=JMean[mean.name],
                                model_var_type=JVar[var.name], loss_type=JLoss.MSE)
        tmodel, jmodel = models(channels)
        rng = jax.random.PRNGKey(6)
        close(tg.p_sample_loop(tmodel, torch.from_numpy(_X), loop_draws(rng, 50)),
              jg.p_sample_loop(jmodel, SHAPE, rng, noise=jnp.asarray(_X)))


@pytest.mark.parametrize("eta", [0.0, 0.5])
@pytest.mark.parametrize("guided", [False, True])
def test_ddim_sample_loop_matches_jax(eta, guided):
    td, jd = IDDPM("10"), JaxIDDPM("10")
    tmodel, jmodel = models(6)
    rng = jax.random.PRNGKey(7)
    grad = (lambda x, t: 0.05 * x) if guided else None
    got = td.ddim_sample_loop(tmodel, torch.from_numpy(_X), loop_draws(rng, 10), eta=eta,
                              cond_fn=grad)
    want = jd.ddim_sample_loop(jmodel, SHAPE, rng, noise=jnp.asarray(_X), eta=eta, cond_fn=grad)
    close(got, want)


@pytest.mark.parametrize("spaced", [False, True])
def test_ddim_reverse_loop_matches_jax(spaced):
    td, jd = IDDPM("10", learn_sigma=False), JaxIDDPM("10", learn_sigma=False)
    tmodel, jmodel = models(3)
    x0 = np.tanh(_X)
    # the port's SpacedDiffusion always feeds the original-chain timestep;
    # unspaced, the base loop feeds the loop index, as JAX's does without a map
    loop = td.ddim_reverse_sample_loop if spaced else partial(
        GaussianDiffusion.ddim_reverse_sample_loop, td)
    got = loop(tmodel, torch.from_numpy(x0))
    want = jd.ddim_reverse_sample_loop(jmodel, jnp.asarray(x0),
                                       timestep_map=jd.timestep_map if spaced else None)
    close(got, want)
    with pytest.raises(ValueError):
        td.ddim_reverse_sample(tmodel(torch.from_numpy(x0), torch.zeros(2, dtype=torch.long)),
                               torch.from_numpy(x0), torch.zeros(2, dtype=torch.long), eta=0.5)


def test_variance_tables_and_eps_algebra_match_jax():
    td, jd = IDDPM("10", learn_sigma=False), JaxIDDPM("10", learn_sigma=False)
    x, x0 = torch.from_numpy(_X), torch.from_numpy(np.tanh(_B))
    t = torch.tensor([9, 0])
    for var in (ModelVarType.FIXED_LARGE, ModelVarType.FIXED_SMALL):
        td.model_var_type = var
        jd = jd.replace(model_var_type=JVar[var.name])
        for got, want in zip(td.model_variance(None, x, t),
                             jd.model_variance(None, jnp.asarray(_X), jnp.asarray(t.numpy()))):
            np.testing.assert_array_equal(got.numpy(), np.asarray(want))
    close(td.predict_eps_from_xstart(x, t, x0),
          jd.predict_eps_from_xstart(jnp.asarray(_X), jnp.asarray(t.numpy()),
                                     jnp.asarray(x0.numpy())))
    close(td.predict_xstart_from_xprev(x, t, x0),
          jd.predict_xstart_from_xprev(jnp.asarray(_X), jnp.asarray(t.numpy()),
                                       jnp.asarray(x0.numpy())))
    assert td.loss_type == LossType.MSE


@pytest.mark.parametrize("mean,var", [(ModelMeanType.PREVIOUS_X, ModelVarType.FIXED_LARGE),
                                      (ModelMeanType.START_X, ModelVarType.FIXED_SMALL),
                                      (ModelMeanType.EPSILON, ModelVarType.LEARNED)])
def test_training_losses_of_the_lifted_types_match_jax(mean, var):
    """The mean and variance types no longer refused train as in JAX."""
    betas = named_beta_schedule("linear", 50)
    tg = GaussianDiffusion(ScheduleCoefficients.create(betas), mean, var)
    jg = JaxGaussian.create(betas=betas, model_mean_type=JMean[mean.name],
                            model_var_type=JVar[var.name], loss_type=JLoss.MSE)
    tmodel, jmodel = models(6 if var == ModelVarType.LEARNED else 3)
    x0, t, noise = np.tanh(_X), np.array([0, 31]), _B
    got = tg.training_losses(tmodel, torch.from_numpy(x0), torch.from_numpy(t),
                             torch.from_numpy(noise))
    want = jg.training_losses(jmodel, jnp.asarray(x0), jnp.asarray(t), noise=jnp.asarray(noise))
    for key in want:
        close(got[key].detach(), want[key])
