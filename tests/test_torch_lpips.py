"""The port's LPIPS and DMD's LPIPS regression against the JAX package's,
on the CPU (f32):

- `VGG16Features` and `LPIPS` at 64px with JAX's params carried across
  (`flax_lpips_to_torch`; the heads perturbed off JAX's ones): every tap and
  the distance within 1e-5 relative;
- the weight maps both ways, bit for bit, and against JAX's converter;
- one DMD generator step with the regression on (a toy PixArt, the tiny
  VAE's decoder, LPIPS at 32px) with JAX's t and noise: dm_loss, lpips_loss
  and the loss within 1e-5 relative, the generator's parameters after an
  SGD step within 1e-4 relative L2 each, as `tests/test_torch_distill.py`
  holds the step without it.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.models.lpips import LPIPS as JaxLPIPS
from pixart_sigma_tpu.models.lpips import VGG16Features as JaxVGG
from pixart_sigma_tpu.models.lpips import torch_lpips_to_flax as jax_lpips_to_flax
from pixart_sigma_tpu.models.vae import AutoencoderKL as JaxVAE
from pixart_sigma_tpu.models.vae import VAEConfig as JaxVAEConfig
from pixart_sigma_tpu.training import dmd as jdmd
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.models.lpips import (
    LPIPS,
    build_lpips,
    flax_lpips_to_torch,
    lpips_state_dict,
    torch_lpips_to_flax,
)
from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
from pixart_sigma_tpu_torch.training import dmd
from pixart_sigma_tpu_torch.utils.checkpoint import state_dict_from_jax, vae_state_dict_from_jax
from tests.test_torch_distill import _batch, _port_copy
from tests.test_torch_lora import _perturb, _rel_l2, _toy
from tests.test_torch_vae import _random_vae_params


@pytest.fixture(scope="module")
def lpips_params():
    params = jax.jit(JaxLPIPS().init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 3)),
                                      jnp.zeros((1, 32, 32, 3)))["params"]
    rng = np.random.RandomState(1)
    for i in range(5):  # JAX's heads are ones: perturb them so their map shows
        k = params[f"lin_{i}"]["kernel"]
        params[f"lin_{i}"]["kernel"] = jnp.asarray(
            np.asarray(k) * rng.uniform(0.5, 1.5, k.shape), jnp.float32)
    return params


def port_lpips(params) -> LPIPS:
    model = build_lpips("cpu")
    model.load_state_dict(lpips_state_dict(*flax_lpips_to_torch(params)), strict=True)
    return model


def test_vgg_features_and_lpips_match_jax(lpips_params):
    rng = np.random.RandomState(2)
    x0, x1 = (rng.uniform(-1, 1, (2, 64, 64, 3)).astype(np.float32) for _ in range(2))
    model = port_lpips(lpips_params)
    with torch.no_grad():
        taps = model.vgg(torch.from_numpy(x0))
        got = model(torch.from_numpy(x0), torch.from_numpy(x1)).numpy()
    want_taps = JaxVGG().apply({"params": lpips_params["vgg"]}, jnp.asarray(x0))
    assert [tuple(t.shape) for t in taps] == [(2, c, 64 >> i, 64 >> i) for i, c in
                                              enumerate((64, 128, 256, 512, 512))]
    for t, w in zip(taps, want_taps):
        assert _rel_l2(t.permute(0, 2, 3, 1), w) <= 1e-5
    want = JaxLPIPS().apply({"params": lpips_params}, jnp.asarray(x0), jnp.asarray(x1))
    assert got.shape == (2,) and (got > 0).all()
    np.testing.assert_allclose(got, np.asarray(want), rtol=1e-5)
    with torch.no_grad():
        assert float(model(torch.from_numpy(x0), torch.from_numpy(x0)).abs().max()) == 0.0


def test_lpips_weight_maps_round_trip_and_match_jax(lpips_params):
    vgg_sd, lin_sd = flax_lpips_to_torch(lpips_params)
    assert len(vgg_sd) == 26 and len(lin_sd) == 5
    np_vgg = {k: v.numpy() for k, v in vgg_sd.items()}
    np_lin = {k: v.numpy() for k, v in lin_sd.items()}
    flat = jax.tree_util.tree_leaves_with_path(lpips_params)
    for tree in (torch_lpips_to_flax(np_vgg, np_lin), jax_lpips_to_flax(np_vgg, np_lin)):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(got) == len(flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    assert set(lpips_state_dict(vgg_sd, lin_sd)) == set(build_lpips("cpu").state_dict())


def test_dmd_generator_step_with_the_lpips_regression_matches_jax(lpips_params):
    jm, params, gen, cfg = _toy()
    gen.requires_grad_(True)
    real_p, fake_p = _perturb(params, 4), _perturb(params, 5)
    real, fake = _port_copy(gen, cfg, real_p), _port_copy(gen, cfg, fake_p)
    vcfg = JaxVAEConfig.small_test()
    jvae = JaxVAE(vcfg)
    vparams = _random_vae_params(vcfg, 9)
    vae = build_vae(VAEConfig.small_test(), device="cpu")
    vae.load_diffusers_state_dict(vae_state_dict_from_jax(vparams, vcfg))
    scale = 0.5
    jlp = JaxLPIPS()
    tlp = port_lpips(lpips_params)

    def jdecode(z):
        return jvae.apply({"params": vparams}, z / scale, method=JaxVAE.decode)

    lr = 0.1
    gtx = optax.sgd(lr)
    jgen, _, _ = jdmd.make_dmd_train_steps(
        jm, JaxIDDPM(timestep_respacing=[1000], learn_sigma=True), start_ts=400,
        regression_weight=0.25, lpips_fn=lambda a, b: jlp.apply({"params": lpips_params}, a, b),
        decode_fn=jdecode, generator_tx=gtx, fake_tx=optax.sgd(lr))
    gen_step, _, _ = dmd.make_dmd_train_steps(
        cfg, IDDPM(timestep_respacing=[1000], learn_sigma=True), start_ts=400,
        regression_weight=0.25, lpips_fn=tlp, decode_fn=lambda z: vae.decode(z / scale),
        generator_optimizer=torch.optim.SGD(gen.parameters(), lr=lr))
    rng = np.random.RandomState(8)
    B = 2
    b = _batch()
    batch = {"init_noise": rng.randn(B, 16, 16, 4).astype(np.float32), "y": b["y"],
             "y_mask": b["y_mask"], "uncond_y": rng.randn(B, 8, 24).astype(np.float32),
             "base_latent": rng.randn(B, 16, 16, 4).astype(np.float32)}
    key = jax.random.PRNGKey(11)
    new_params, _, jmetrics, _ = jgen(params, gtx.init(params), real_p, fake_p,
                                      {k: jnp.asarray(v) for k, v in batch.items()}, key)
    noise_rng, t_rng = jax.random.split(key)
    t = torch.from_numpy(np.array(jax.random.randint(t_rng, (B,), 1, 400)))
    noise = torch.from_numpy(np.array(jax.random.normal(noise_rng, (B, 16, 16, 4))))
    metrics, _ = gen_step(gen, real, fake, {k: torch.from_numpy(v) for k, v in batch.items()},
                          t=t, noise=noise)
    assert set(metrics) == {"dm_loss", "lpips_loss", "loss"}
    assert metrics["lpips_loss"] > 0
    for k in metrics:
        assert abs(metrics[k] - float(jmetrics[k])) <= 1e-5 * abs(float(jmetrics[k])), (
            k, metrics[k], float(jmetrics[k]))
    got = dict(gen.named_parameters())
    for n, v in state_dict_from_jax(new_params, cfg).items():
        assert _rel_l2(got[n].detach(), v) <= 1e-4, (n, _rel_l2(got[n].detach(), v))
    assert all(p.grad is None for p in vae.parameters())
