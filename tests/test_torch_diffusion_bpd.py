"""The rest of the port's iDDPM diffusion against the JAX package's, on the
CPU (f32): `q_mean_variance`, `prior_bpd` and `calc_bpd_loop` over an
8-step cosine chain and a 40-step linear one (and through a spaced chain's
`timestep_map`) with JAX's per-step draws passed in; the KL and rescaled-KL training losses;
`training_losses_diffusers` with and without `return_startx` (and
`skip_noise`); `training_losses_startx` through `SpacedDiffusion`; and
`IDDPM(use_kl=True)`. A fixed analytic model in both frameworks sees the
timesteps each entry feeds it. Everything agrees within 1e-5 relative,
but the KL loss's decoder NLL at t = 0 under the fixed small variance
(1e-4: see `test_kl_losses_match_jax`) and a gradient (1e-4).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.diffusion.gaussian import GaussianDiffusion as JaxGaussian
from pixart_sigma_tpu.diffusion.gaussian import LossType as JLoss
from pixart_sigma_tpu.diffusion.gaussian import ModelMeanType as JMean
from pixart_sigma_tpu.diffusion.gaussian import ModelVarType as JVar
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.diffusion.gaussian import (
    GaussianDiffusion,
    LossType,
    ModelMeanType,
    ModelVarType,
)
from pixart_sigma_tpu_torch.diffusion.schedules import ScheduleCoefficients, named_beta_schedule

SHAPE = (2, 4, 4, 3)
TOL = 1e-5
_B = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
# x0 in the decoder's interior bins, as VAE latents scaled to [-1, 1] are
X0 = np.random.RandomState(1).uniform(-0.95, 0.95, SHAPE).astype(np.float32)
NOISE = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)


def close(got, want, tol=TOL):
    got = got.detach().numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=tol, atol=tol * 1e-2)


def models(learned: bool = True):
    """(torch, jax) model_fn(x, t): 0.3 x + (t / 1000) b, and a tanh(x / 2)
    variance head when the model learns its variance."""
    def tmodel(x, t):
        out = 0.3 * x + (t.float() / 1000.0).reshape(-1, 1, 1, 1) * torch.from_numpy(_B)
        return torch.cat([out, torch.tanh(0.5 * x)], -1) if learned else out

    def jmodel(x, t):
        out = 0.3 * x + (t.astype(jnp.float32) / 1000.0).reshape(-1, 1, 1, 1) * _B
        return jnp.concatenate([out, jnp.tanh(0.5 * x)], -1) if learned else out

    return tmodel, jmodel


def pair(T=8, schedule="squaredcos_cap_v2", mean=ModelMeanType.EPSILON,
         var=ModelVarType.LEARNED_RANGE, loss=LossType.MSE):
    betas = named_beta_schedule(schedule, T)
    port = GaussianDiffusion(ScheduleCoefficients.create(betas), model_mean_type=mean,
                             model_var_type=var, loss_type=loss)
    jax_ = JaxGaussian.create(betas=betas, model_mean_type=JMean[mean.name],
                              model_var_type=JVar[var.name], loss_type=JLoss[loss.name])
    return port, jax_


def bpd_draws(rng, T):
    """calc_bpd_loop's draws: split(rng, T)[k] at step k."""
    keys = jax.random.split(rng, T)
    return lambda k, shape: torch.from_numpy(
        np.array(jax.random.normal(keys[k], tuple(shape), jnp.float32)))


def test_q_mean_variance_and_prior_bpd_match_jax():
    port, jax_ = pair()
    t = np.array([0, 7], np.int32)
    got = port.q_mean_variance(torch.from_numpy(X0), torch.from_numpy(t).long())
    want = jax_.q_mean_variance(jnp.asarray(X0), jnp.asarray(t))
    for g, w in zip(got, want):
        close(g, np.broadcast_to(np.asarray(w), g.shape))
    close(port.prior_bpd(torch.from_numpy(X0)), jax_.prior_bpd(jnp.asarray(X0)))


@pytest.mark.parametrize("clip", [True, False])
@pytest.mark.parametrize("schedule,T", [("squaredcos_cap_v2", 8), ("linear", 40)])
def test_calc_bpd_loop_matches_jax(schedule, T, clip):
    port, jax_ = pair(T, schedule)
    tmodel, jmodel = models()
    rng = jax.random.PRNGKey(7)
    want = jax_.calc_bpd_loop(jmodel, jnp.asarray(X0), rng, clip_denoised=clip)
    got = port.calc_bpd_loop(tmodel, torch.from_numpy(X0), bpd_draws(rng, T), clip_denoised=clip)
    assert got["vb"].shape == (2, T)
    for key in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        close(got[key], want[key])


def test_calc_bpd_loop_through_a_spaced_chain_matches_jax():
    """A 4-step chain of 1000: the model sees the original-chain timesteps
    only through the `timestep_map` passed in, in both packages."""
    port = IDDPM(timestep_respacing="4")
    jax_ = JaxIDDPM(timestep_respacing="4")
    seen = []
    tmodel, jmodel = models()

    def spy(x, t):
        seen.append(t.tolist())
        return tmodel(x, t)

    rng = jax.random.PRNGKey(3)
    want = jax_.calc_bpd_loop(jmodel, jnp.asarray(X0), rng, timestep_map=jax_.timestep_map)
    got = port.calc_bpd_loop(spy, torch.from_numpy(X0), bpd_draws(rng, 4),
                             timestep_map=port.timestep_map)
    assert [s[0] for s in seen] == [999, 666, 333, 0]
    for key in ("total_bpd", "prior_bpd", "vb", "xstart_mse", "mse"):
        close(got[key], want[key])


@pytest.mark.parametrize("loss", [LossType.KL, LossType.RESCALED_KL])
@pytest.mark.parametrize("mean,var", [(ModelMeanType.EPSILON, ModelVarType.LEARNED_RANGE),
                                      (ModelMeanType.START_X, ModelVarType.FIXED_SMALL),
                                      (ModelMeanType.EPSILON, ModelVarType.LEARNED)])
def test_kl_losses_match_jax(loss, mean, var):
    port, jax_ = pair(T=50, schedule="linear", mean=mean, var=var, loss=loss)
    tmodel, jmodel = models(learned=var in (ModelVarType.LEARNED, ModelVarType.LEARNED_RANGE))
    t = np.array([0, 31], np.int32)
    got = port.training_losses(tmodel, torch.from_numpy(X0), torch.from_numpy(t).long(),
                               torch.from_numpy(NOISE))
    want = jax_.training_losses(jmodel, jnp.asarray(X0), jnp.asarray(t), noise=jnp.asarray(NOISE))
    assert set(got) == set(want) == {"loss"}
    close(got["loss"][1], want["loss"][1])
    # t = 0 is the decoder NLL: with the fixed small variance (std 0.045) it
    # takes the log of a difference of two CDF values near 1, where XLA's
    # and torch's f32 tanh, 2 ulp apart, read 3.7e-5 apart
    close(got["loss"][0], want["loss"][0], tol=1e-4)


def test_iddpm_use_kl_matches_jax():
    port, jax_ = IDDPM(timestep_respacing="", use_kl=True), JaxIDDPM(use_kl=True)
    assert port.loss_type == LossType.RESCALED_KL and jax_.loss_type == JLoss.RESCALED_KL
    tmodel, jmodel = models()
    t = np.array([5, 640], np.int32)
    x0 = torch.from_numpy(X0).requires_grad_(True)
    got = port.training_losses(tmodel, x0, torch.from_numpy(t).long(), torch.from_numpy(NOISE))
    want = jax_.training_losses(jmodel, jnp.asarray(X0), jnp.asarray(t), noise=jnp.asarray(NOISE))
    close(got["loss"], want["loss"])
    # the gradient of the rescaled bound with respect to x0, as JAX's
    got["loss"].sum().backward()
    gwant = jax.grad(lambda x: jax_.training_losses(
        jmodel, x, jnp.asarray(t), noise=jnp.asarray(NOISE))["loss"].sum())(jnp.asarray(X0))
    close(x0.grad, gwant, tol=1e-4)


@pytest.mark.parametrize("skip_noise", [False, True])
def test_training_losses_diffusers_matches_jax(skip_noise):
    port, jax_ = pair(T=1000, schedule="linear")
    tmodel, jmodel = models()
    t = np.array([3, 777], np.int32)
    got = port.training_losses_diffusers(lambda x, timestep: tmodel(x, timestep),
                                         torch.from_numpy(X0), torch.from_numpy(t).long(),
                                         torch.from_numpy(NOISE), skip_noise=skip_noise)
    want = jax_.training_losses_diffusers(lambda x, timestep: jmodel(x, timestep),
                                          jnp.asarray(X0), jnp.asarray(t),
                                          noise=jnp.asarray(NOISE), skip_noise=skip_noise)
    for key in ("loss", "mse", "vb", "pred_xstart", "x_t"):
        close(got[key], want[key])


def test_training_losses_diffusers_return_startx_matches_jax():
    """The early exit feeds the model t as given, also on a spaced chain."""
    port, jax_ = IDDPM(timestep_respacing="10"), JaxIDDPM(timestep_respacing="10")
    tmodel, jmodel = models()
    t = np.array([2, 9], np.int32)
    seen = []

    def spy(x, timestep):
        seen.append(timestep.tolist())
        return tmodel(x, timestep)

    got = port.training_losses_diffusers(spy, torch.from_numpy(X0), torch.from_numpy(t).long(),
                                         torch.from_numpy(NOISE), return_startx=True)
    want = jax_.training_losses_diffusers(lambda x, timestep: jmodel(x, timestep),
                                          jnp.asarray(X0), jnp.asarray(t),
                                          noise=jnp.asarray(NOISE), return_startx=True)
    assert seen == [[2, 9]]
    for g, w in zip(got, want):
        close(g, w)


def test_training_losses_startx_through_spaced_diffusion_matches_jax():
    port, jax_ = IDDPM(timestep_respacing="10"), JaxIDDPM(timestep_respacing="10")
    tmodel, jmodel = models()
    t = np.array([1, 8], np.int32)
    seen = []

    def spy(x, tt):
        seen.append(tt.tolist())
        return tmodel(x, tt)

    got = port.training_losses_startx(spy, torch.from_numpy(X0), torch.from_numpy(t).long(),
                                      torch.from_numpy(NOISE))
    want = jax_.training_losses_startx(jmodel, jnp.asarray(X0), jnp.asarray(t),
                                       noise=jnp.asarray(NOISE))
    assert seen == [[int(port.timestep_map[1]), int(port.timestep_map[8])]]
    for g, w in zip(got, want):
        close(g, w)
