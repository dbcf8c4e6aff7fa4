"""The port's samplers against the JAX package's, solver by solver, on the CPU.

Host coefficient functions (SA-Solver's exponential integrals, Lagrange and
gradient coefficients and time grid, DEIS's Lagrange integrals, the LCM
timesteps and boundary scalings, the Karras sigmas, DPM-Solver's singlestep
order allocation, the continuous schedule, SASolverScheduler's timesteps)
agree to rtol 1e-12. Trajectories run a fixed analytic model written in
both frameworks (eps = 0.3 x + 0.5 sin(3 t) b, b a fixed tensor) from the
same x in float32, the stochastic ones on JAX's per-step draws: they agree
to rtol 1e-4 and atol 1e-4 (the JAX side computes sin and the time grids in
f32 on traced times, the port in f64 on the host; f32 rounding elsewhere).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import math

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.diffusion import deis as jdeis
from pixart_sigma_tpu.diffusion import dpm_solver as jdpm
from pixart_sigma_tpu.diffusion import edm as jedm
from pixart_sigma_tpu.diffusion import lcm as jlcm
from pixart_sigma_tpu.diffusion import sa_solver as jsa
from pixart_sigma_tpu.diffusion import sa_solver_scheduler as jsched
from pixart_sigma_tpu.diffusion.schedules import named_beta_schedule
from pixart_sigma_tpu_torch.diffusion import deis, dpm_solver, edm, lcm, sa_solver
from pixart_sigma_tpu_torch.diffusion import sa_solver_scheduler as sched

RTOL = ATOL = 1e-4
SHAPE = (2, 4, 4, 3)
BETAS = named_beta_schedule("linear", 1000)
_B = np.random.RandomState(0).randn(*SHAPE).astype(np.float32)
_X = np.random.RandomState(1).randn(*SHAPE).astype(np.float32)


def exact(got, want):
    np.testing.assert_allclose(np.asarray(got, np.float64), np.asarray(want, np.float64),
                               rtol=1e-12, atol=0)


def close(got, want, rtol=RTOL, atol=ATOL):
    got = got.numpy() if isinstance(got, torch.Tensor) else np.asarray(got)
    assert np.isfinite(got).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=rtol, atol=atol)


def jax_eps(x, t):
    return 0.3 * x + 0.5 * jnp.sin(3.0 * jnp.asarray(t, jnp.float32)) * _B


def torch_eps(x, t):
    return 0.3 * x + float(np.float32(0.5) * np.sin(np.float32(3.0) * np.float32(t))) \
        * torch.from_numpy(_B)


def draws(keys, offset=0):
    """noise_fn(k, shape) -> JAX's normal draw from keys[k + offset]."""
    return lambda k, shape: torch.from_numpy(
        np.array(jax.random.normal(keys[k + offset], tuple(shape), jnp.float32)))


def schedules():
    return (dpm_solver.NoiseScheduleVP("discrete", betas=BETAS),
            jdpm.NoiseScheduleVP("discrete", betas=BETAS))


# ---------------------------------------------------------------- host math
def test_sa_solver_coefficients_match_jax_exactly():
    for a, b in ((-2.0, -1.5), (0.3, 1.1), (-4.9, 2.6)):
        for order in range(4):
            exact(sa_solver._exp_int_negative(order, a, b), jsa._exp_int_negative(order, a, b))
            for tau in (0.0, 0.5, 1.0):
                exact(sa_solver._exp_int_positive(order, a, b, tau),
                      jsa._exp_int_positive(order, a, b, tau))
    lams = [-1.3, -0.7, 0.2, 0.9]
    for order in range(4):
        exact(sa_solver._lagrange_coeffs(order, lams[: order + 1]),
              jsa._lagrange_coeffs(order, lams[: order + 1]))
    for order in range(1, 5):
        for tau in (0.0, 1.0):
            for x0 in (True, False):
                exact(sa_solver._gradient_coefficients(order, -0.7, -0.2, lams[:order], tau, x0),
                      jsa._gradient_coefficients(order, -0.7, -0.2, lams[:order], tau, x0))
    ns, jns = schedules()
    for skip, order in (("logSNR", 1), ("logSNR", 2), ("time", 1), ("time", 2), ("karras", 1)):
        exact(sa_solver.sa_get_time_steps(ns, skip, 1.0, 1e-3, 25, order),
              jsa.sa_get_time_steps(jns, skip, 1.0, 1e-3, 25, order))


def test_deis_lcm_edm_coefficients_match_jax_exactly():
    for nodes in ([0.5], [2.0, 1.1], [9.0, 4.0, 1.5]):
        exact(deis._lagrange_integrals(nodes, 1.1, 0.4),
              jdeis._lagrange_integrals(nodes, 1.1, 0.4))
    for n in (1, 2, 4, 8):
        np.testing.assert_array_equal(lcm.lcm_inference_timesteps(n),
                                      jlcm.lcm_inference_timesteps(n))
    t = np.arange(0, 1000, 37, dtype=np.float64)
    for got, want in zip(lcm.scalings_for_boundary_conditions(t),
                         jlcm.scalings_for_boundary_conditions(t)):
        exact(got, want)
    for n in (2, 7, 18):
        exact(edm.karras_sigmas(n), jedm.karras_sigmas(n))
        exact(edm.karras_sigmas(n, 0.01, 10.0, 5.0), jedm.karras_sigmas(n, 0.01, 10.0, 5.0))


@pytest.mark.parametrize("skip", ["time_uniform", "logSNR", "karras"])
def test_singlestep_orders_and_timesteps_match_jax_exactly(skip):
    ns, jns = schedules()
    solver, jsolver = dpm_solver.DPMSolver(None, ns), jdpm.DPMSolver(None, jns)
    for order in (1, 2, 3):
        for steps in (5, 6, 7, 20):
            outer, orders = solver.singlestep_orders_and_timesteps(steps, order, skip, 1.0, 1e-3)
            j_outer, j_orders = jsolver.singlestep_orders_and_timesteps(
                steps, order, skip, 1.0, 1e-3)
            assert orders == j_orders
            exact(outer, j_outer)


def test_continuous_and_cumprod_schedules_match_jax_exactly():
    acp = np.cumprod(1.0 - BETAS)
    t = np.linspace(1e-3, 1.0, 9)
    for args in (dict(schedule="linear"), dict(schedule="discrete", alphas_cumprod=acp)):
        ns, jns = dpm_solver.NoiseScheduleVP(**args), jdpm.NoiseScheduleVP(**args)
        for fn in ("marginal_log_mean_coeff", "marginal_alpha", "marginal_std",
                   "marginal_lambda", "model_input_time"):
            exact(getattr(ns, fn)(t), getattr(jns, fn)(t))
        exact(ns.inverse_lambda(ns.marginal_lambda(t)), jns.inverse_lambda(jns.marginal_lambda(t)))
        exact(dpm_solver.get_time_steps(ns, "logSNR", 1.0, 1e-3, 10),
              jdpm.get_time_steps(jns, "logSNR", 1.0, 1e-3, 10))


@pytest.mark.parametrize("kw", [
    dict(), dict(timestep_spacing="leading", steps_offset=1), dict(timestep_spacing="trailing"),
    dict(use_karras_sigmas=True), dict(beta_schedule="squaredcos_cap_v2"),
    dict(beta_schedule="scaled_linear", lambda_min_clipped=-5.1)])
def test_sa_scheduler_timesteps_match_jax_exactly(kw):
    for n in (4, 20, 25):
        s, js = sched.SASolverScheduler(**kw), jsched.SASolverScheduler(**kw)
        s.set_timesteps(n)
        js.set_timesteps(n)
        np.testing.assert_array_equal(s.timesteps, js.timesteps)
        exact(s.sigmas, js.sigmas)
        exact(s.lambda_t, js.lambda_t)


# --------------------------------------------------------- DPM trajectories
def _dpm(algorithm="dpmsolver++", ns_args=None):
    ns_args = ns_args or dict(schedule="discrete", betas=BETAS)
    ns, jns = dpm_solver.NoiseScheduleVP(**ns_args), jdpm.NoiseScheduleVP(**ns_args)
    return (dpm_solver.DPMSolver(torch_eps, ns, algorithm_type=algorithm),
            jdpm.DPMSolver(jax_eps, jns, algorithm_type=algorithm))


@pytest.mark.parametrize("algorithm", ["dpmsolver++", "dpmsolver"])
@pytest.mark.parametrize("method,order,solver_type,extra", [
    ("multistep", 1, "dpmsolver", {}),
    ("multistep", 2, "dpmsolver", {}),
    ("multistep", 2, "dpmsolver", dict(jax_use_scan=False)),
    ("multistep", 2, "taylor", dict(skip_type="logSNR")),
    ("multistep", 3, "dpmsolver", {}),
    ("multistep", 3, "taylor", dict(lower_order_final=False, skip_type="time_quadratic")),
    ("multistep", 2, "dpmsolver", dict(denoise_to_zero=True, skip_type="karras")),
    ("singlestep", 1, "dpmsolver", {}),
    ("singlestep", 2, "taylor", dict(skip_type="logSNR")),
    ("singlestep", 3, "dpmsolver", dict(denoise_to_zero=True)),
    ("singlestep", 3, "taylor", {}),
    ("singlestep_fixed", 2, "dpmsolver", {}),
])
def test_dpm_solver_trajectory_matches_jax(algorithm, method, order, solver_type, extra):
    """The port has one path per update form; `jax_use_scan=False` holds its
    order-2 dpmsolver++ path against JAX's unrolled loop as well as its scan."""
    solver, jsolver = _dpm(algorithm)
    extra = dict(extra)
    jax_kw = dict(use_scan=extra.pop("jax_use_scan", True))
    kw = dict(steps=8, order=order, method=method, solver_type=solver_type, **extra)
    close(solver.sample(torch.from_numpy(_X), **kw),
          jsolver.sample(jnp.asarray(_X), **kw, **jax_kw))


@pytest.mark.parametrize("algorithm,order", [("dpmsolver++", 2), ("dpmsolver", 3)])
def test_dpm_solver_adaptive_matches_jax(algorithm, order):
    solver, jsolver = _dpm(algorithm)
    got, nfe = solver.sample_adaptive(torch.from_numpy(_X), order=order, rtol=0.1,
                                      return_nfe=True)
    want, jnfe = jsolver.sample_adaptive(jnp.asarray(_X), order=order, rtol=0.1,
                                         return_nfe=True)
    assert nfe == int(jnfe) and nfe > 2 * order
    close(got, want)


def test_dpm_solver_on_the_continuous_schedule_matches_jax():
    solver, jsolver = _dpm(ns_args=dict(schedule="linear"))
    kw = dict(steps=6, order=3, skip_type="logSNR", t_end=1e-3)
    close(solver.sample(torch.from_numpy(_X), **kw), jsolver.sample(jnp.asarray(_X), **kw))


@pytest.mark.parametrize("algorithm", ["sde-dpmsolver++", "sde-dpmsolver"])
@pytest.mark.parametrize("order", [1, 2])
def test_sde_dpm_solver_matches_jax(algorithm, order):
    solver, jsolver = _dpm(algorithm)
    rng = jax.random.PRNGKey(4)
    steps = 8
    got = solver.sample_sde(torch.from_numpy(_X), draws(jax.random.split(rng, steps)),
                            steps=steps, order=order)
    want = jsolver.sample_sde(jnp.asarray(_X), rng, steps=steps, order=order)
    close(got, want)


@pytest.mark.parametrize("model_type", ["noise", "x_start", "v", "score"])
@pytest.mark.parametrize("guidance", ["classifier-free", "uncond", "classifier"])
def test_model_wrapper_matches_jax(model_type, guidance):
    """make_cfg_model_fn's model types and guidance types under a 6-step
    multistep run; the classifier's gradient comes from torch.autograd."""
    ns, jns = schedules()
    cond = np.random.RandomState(2).randn(*SHAPE).astype(np.float32)
    uncond = np.random.RandomState(3).randn(*SHAPE).astype(np.float32)

    def apply(lib, x, t, c):
        return 0.2 * x + 0.1 * c * (t / 1000.0).reshape(-1, 1, 1, 1) + 0.05

    def jclassifier(x, t, c):
        return -jnp.sum((x - c) ** 2, axis=(1, 2, 3)) * (1.0 + t / 1000.0)

    def tclassifier(x, t, c):
        return -((x - c) ** 2).sum(dim=(1, 2, 3)) * (1.0 + t / 1000.0)

    kw = dict(cfg_scale=2.5, model_type=model_type, guidance_type=guidance)
    fn = dpm_solver.make_cfg_model_fn(
        lambda x, t, c: apply(torch, x, t, c), ns, torch.from_numpy(cond),
        torch.from_numpy(uncond), classifier_fn=tclassifier, **kw)
    jfn = jdpm.make_cfg_model_fn(
        lambda x, t, c: apply(jnp, x, t, c), jns, jnp.asarray(cond), jnp.asarray(uncond),
        classifier_fn=jclassifier, **kw)
    got = dpm_solver.DPMSolver(fn, ns).sample(torch.from_numpy(_X), steps=6, order=2)
    want = jdpm.DPMSolver(jfn, jns).sample(jnp.asarray(_X), steps=6, order=2, use_scan=False)
    close(got, want, rtol=2e-4)


@pytest.mark.parametrize("order", [1, 2, 3])
def test_deis_matches_jax(order):
    ns, jns = schedules()
    kw = dict(steps=7, order=order, skip_type="logSNR" if order == 3 else "time_uniform")
    close(deis.DEISMultistep(torch_eps, ns).sample(torch.from_numpy(_X), **kw),
          jdeis.DEISMultistep(jax_eps, jns).sample(jnp.asarray(_X), **kw))


# ---------------------------------------------------------- SA trajectories
@pytest.mark.parametrize("mode,pc_mode,orders,algorithm,skip", [
    ("few_steps", "PEC", (2, 2), "data_prediction", "time"),
    ("few_steps", "PECE", (2, 2), "data_prediction", "time"),
    ("few_steps", "PEC", (3, 3), "noise_prediction", "logSNR"),
    ("more_steps", "PEC", (3, 4), "data_prediction", "time"),
    ("more_steps", "PECE", (2, 3), "noise_prediction", "karras"),
    ("more_steps", "PEC", (1, 0), "data_prediction", "time"),
])
def test_sa_solver_matches_jax(mode, pc_mode, orders, algorithm, skip):
    ns, jns = schedules()
    steps, rng = 6, jax.random.PRNGKey(5)
    tau = lambda t: 1.0 if 0.2 <= t <= 0.8 else 0.0
    kw = dict(predictor_order=orders[0], corrector_order=orders[1], pc_mode=pc_mode,
              skip_type=skip)
    got = sa_solver.SASolver(torch_eps, ns, algorithm).sample(
        mode, torch.from_numpy(_X), tau, steps, draws(jax.random.split(rng, steps + 1), 1), **kw)
    want = jsa.SASolver(jax_eps, jns, algorithm).sample(
        mode, jnp.asarray(_X), tau, steps, rng, use_scan=False, **kw)
    close(got, want)


def test_sa_solver_matches_jax_scan_path():
    """The pipeline's setting, whose JAX path is one lax.scan over f32
    coefficient columns: the port's loop agrees within the same limits
    (f32 coefficients against the loop's Python floats are an ulp apart)."""
    ns, jns = schedules()
    steps, rng = 9, jax.random.PRNGKey(6)
    tau = lambda t: 1.0 if 0.2 <= t <= 0.8 else 0.0
    got = sa_solver.sa_solver_sample(torch_eps, BETAS, torch.from_numpy(_X),
                                     draws(jax.random.split(rng, steps + 1), 1), steps=steps)
    want = jsa.sa_solver_sample(jax_eps, BETAS, jnp.asarray(_X), rng, steps=steps)
    close(got, want)


# ------------------------------------------------ LCM, EDM, the scheduler
def test_lcm_matches_jax():
    jmodel = lambda x, t: 0.3 * x + jnp.sin(t / 500.0).reshape(-1, 1, 1, 1) * _B
    tmodel = lambda x, t: 0.3 * x + torch.sin(t / 500.0).reshape(-1, 1, 1, 1) \
        * torch.from_numpy(_B)
    rng = jax.random.PRNGKey(7)
    for n in (1, 4):
        keys = jax.random.split(jax.random.split(rng)[0], n)
        got = lcm.LCMScheduler().sample(tmodel, torch.from_numpy(_X), draws(keys),
                                        num_inference_steps=n)
        want = jlcm.LCMScheduler().sample(jmodel, SHAPE, rng, num_inference_steps=n,
                                          noise=jnp.asarray(_X))
        close(got, want)
    acp = np.cumprod(1.0 - BETAS)
    idx = np.array([3, 49])
    close(lcm.DDIMSolver(acp).ddim_step(torch.from_numpy(_X), torch.from_numpy(_B),
                                        torch.from_numpy(idx)),
          jlcm.DDIMSolver(acp).ddim_step(jnp.asarray(_X), jnp.asarray(_B), jnp.asarray(idx)))


@pytest.mark.parametrize("kw", [
    dict(fn="edm_sampler", num_steps=6),
    dict(fn="edm_sampler", num_steps=6, s_churn=10.0, s_min=0.05, s_max=50.0),
    dict(fn="ablation_sampler", num_steps=5, discretization="vp", schedule="vp", scaling="vp"),
    dict(fn="ablation_sampler", num_steps=5, discretization="ve", schedule="ve",
         solver="euler", s_churn=5.0),
    dict(fn="ablation_sampler", num_steps=5, discretization="iddpm", alpha=0.7),
])
def test_edm_samplers_match_jax(kw):
    kw = dict(kw)
    fn = kw.pop("fn")
    jden = lambda x, s: x / (1.0 + s**2) + 0.1 * _B
    tden = lambda x, s: x / (1.0 + s**2) + 0.1 * torch.from_numpy(_B)
    rng = jax.random.PRNGKey(8)
    keys = jax.random.split(rng, kw["num_steps"])
    got = getattr(edm, fn)(tden, torch.from_numpy(_X), draws(keys), **kw)
    want = getattr(jedm, fn)(jden, jnp.asarray(_X), rng, **kw)
    close(got, want, rtol=2e-4)


@pytest.mark.parametrize("kw", [
    dict(), dict(algorithm_type="noise_prediction", predictor_order=3, corrector_order=3),
    dict(prediction_type="v_prediction", use_karras_sigmas=True),
    dict(prediction_type="sample", thresholding=True, sample_max_value=1.5),
])
def test_sa_scheduler_steps_match_jax(kw):
    s, js = sched.SASolverScheduler(**kw), jsched.SASolverScheduler(**kw)
    s.set_timesteps(7)
    js.set_timesteps(7)
    x, jx = torch.from_numpy(_X), jnp.asarray(_X)
    for i, t in enumerate(s.timesteps):
        noise = np.random.RandomState(10 + i).randn(*SHAPE).astype(np.float32)
        out = 0.3 * x + math.sin(t / 300.0) * torch.from_numpy(_B)
        jout = 0.3 * jx + math.sin(t / 300.0) * _B
        x = s.step(out, t, x, noise=torch.from_numpy(noise)).prev_sample
        jx = js.step(jout, t, jx, noise=jnp.asarray(noise)).prev_sample
        close(x, jx)
    np.testing.assert_allclose(
        s.add_noise(torch.from_numpy(_X), torch.from_numpy(_B), [3, 500]).numpy(),
        np.asarray(js.add_noise(jnp.asarray(_X), jnp.asarray(_B), [3, 500])), rtol=1e-6)
