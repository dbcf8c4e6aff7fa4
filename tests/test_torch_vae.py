"""The port's VAE against the JAX package, on the CPU.

`VAEConfig.small_test` decode with the same (perturbed) weights agrees to
float32 atol 1e-4, and so does the tiled decode with both JAX tiled
decoders; `encode`'s mean and log-variance agree to 1e-5 relative L2 (odd
image sizes included, where the (0, 1) pad before each stride-2 conv
matters), and so does the posterior sample through the decoder with JAX's
normal draw passed in; `vae_state_dict_from_jax` is the exact inverse of
the JAX package's `diffusers_vae_to_flax`.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.models.vae import AutoencoderKL as JaxVAE
from pixart_sigma_tpu.models.vae import VAEConfig as JaxVAEConfig
from pixart_sigma_tpu.models.vae import diffusers_vae_to_flax
from pixart_sigma_tpu.models.vae import make_tiled_decode as jax_make_tiled_decode
from pixart_sigma_tpu.models.vae import tiled_decode as jax_tiled_decode
from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae, posterior_sample, tiled_decode
from pixart_sigma_tpu_torch.utils.checkpoint import vae_state_dict_from_jax


def _random_vae_params(cfg, seed):
    """Seeded random JAX VAE params, shaped by abstract evaluation of the
    initialiser (compiling the real one costs seconds): conv kernels scaled
    by fan-in, norm scales near 1, small biases."""
    shapes = jax.eval_shape(JaxVAE(cfg).init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 16, 16, 3)), jax.random.PRNGKey(1))["params"]
    rng = np.random.RandomState(seed)

    def draw(path, leaf):
        name = path[-1].key
        x = rng.randn(*leaf.shape).astype(np.float32)
        if name == "kernel":
            return jnp.asarray(x / np.sqrt(np.prod(leaf.shape[:-1])))
        return jnp.asarray(1.0 + 0.05 * x if name == "scale" else 0.05 * x)

    return jax.tree_util.tree_map_with_path(draw, shapes)


def _jax_vae():
    cfg = JaxVAEConfig.small_test()
    return cfg, JaxVAE(cfg), _random_vae_params(cfg, 0)


def test_small_vae_decode_matches_jax():
    jcfg, jvae, params = _jax_vae()
    z = np.random.RandomState(1).randn(2, 6, 10, 4).astype(np.float32)
    decode = jax.jit(lambda p, z: jvae.apply({"params": p}, z, method=JaxVAE.decode))
    want = decode(params, jnp.asarray(z))
    vae = build_vae(VAEConfig.small_test(), device="cpu")
    vae.load_diffusers_state_dict(vae_state_dict_from_jax(params, jcfg))
    with torch.no_grad():
        got = vae.decode(torch.from_numpy(z))
    assert got.shape == (2, 12, 20, 3)
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


def test_vae_state_dict_round_trips_through_diffusers_vae_to_flax():
    jcfg, _, params = _jax_vae()
    sd = vae_state_dict_from_jax(params, jcfg)
    back = diffusers_vae_to_flax({k: v.numpy() for k, v in sd.items()}, jcfg)
    flat = jax.tree_util.tree_leaves_with_path(params)
    back_flat = dict(jax.tree_util.tree_leaves_with_path(back))
    assert len(flat) == len(back_flat)
    for path, leaf in flat:
        np.testing.assert_array_equal(np.asarray(back_flat[path]), np.asarray(leaf))
    assert any(k.startswith("encoder.") for k in sd)
    assert set(sd) == set(build_vae(VAEConfig.small_test(), device="cpu").state_dict())


def test_tiled_decode_matches_both_jax_tiled_decoders():
    """Tile 8, overlap 2 over a 21 x 17 latent: neither side a multiple of
    the stride, so the last tiles are clamped to the edge and overlap more."""
    jcfg, jvae, params = _jax_vae()
    z = np.random.RandomState(3).randn(2, 21, 17, 4).astype(np.float32)
    apply_decode = lambda zz: jvae.apply({"params": params}, zz, method=JaxVAE.decode)
    want_scan = jax_make_tiled_decode(apply_decode, tile=8, overlap=2)(jnp.asarray(z))
    want_loop = jax_tiled_decode(jax.jit(apply_decode), jnp.asarray(z), tile=8, overlap=2)
    vae = build_vae(VAEConfig.small_test(), device="cpu")
    vae.load_diffusers_state_dict(vae_state_dict_from_jax(params, jcfg))
    calls = []

    def decode(zt):
        calls.append(tuple(zt.shape))
        return vae.decode(zt)

    with torch.no_grad():
        got = tiled_decode(decode, torch.from_numpy(z), tile=8, overlap=2)
        whole = tiled_decode(vae.decode, torch.from_numpy(z[:, :8, :6]), tile=8, overlap=2)
    assert got.shape == (2, 42, 34, 3) and got.dtype == torch.float32
    assert calls == [(2, 8, 8, 4)] * 12  # 4 x 3 tiles, each decoding both images
    np.testing.assert_allclose(got.numpy(), np.asarray(want_scan), atol=1e-4, rtol=1e-4)
    np.testing.assert_allclose(got.numpy(), np.asarray(want_loop), atol=1e-4, rtol=1e-4)
    with torch.no_grad():
        np.testing.assert_array_equal(whole.numpy(), vae.decode(torch.from_numpy(z[:, :8, :6])))


def _rel(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return float(np.linalg.norm(got - want) / np.linalg.norm(want))


@pytest.mark.parametrize("shape", [(2, 24, 40), (1, 17, 23), (3, 8, 8)])
def test_small_vae_encode_matches_jax(shape):
    """Mean and clamped log-variance of the posterior, f32."""
    jcfg, jvae, params = _jax_vae()
    B, H, W = shape
    x = np.random.RandomState(4).uniform(-1, 1, (B, H, W, 3)).astype(np.float32)
    mean_j, logvar_j = jax.jit(lambda p, x: jvae.apply({"params": p}, x,
                                                       method=JaxVAE.encode))(params, x)
    vae = build_vae(VAEConfig.small_test(), device="cpu")
    vae.load_diffusers_state_dict(vae_state_dict_from_jax(params, jcfg))
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(x))
    assert mean.shape == logvar.shape == np.asarray(mean_j).shape
    assert _rel(mean, mean_j) <= 1e-5 and _rel(logvar, logvar_j) <= 1e-5


def test_symmetric_pad_is_not_the_encoder():
    """The check above sees the (0, 1) pad: at even sizes a symmetric
    padding=1 gives the same shapes and other numbers."""
    jcfg, jvae, params = _jax_vae()
    x = np.random.RandomState(4).uniform(-1, 1, (1, 16, 24, 3)).astype(np.float32)
    mean_j, _ = jvae.apply({"params": params}, x, method=JaxVAE.encode)
    vae = build_vae(VAEConfig.small_test(), device="cpu")
    vae.load_diffusers_state_dict(vae_state_dict_from_jax(params, jcfg))
    down = vae.encoder.down_blocks[0].downsamplers[0]
    down.forward = lambda h: torch.nn.functional.conv2d(
        h, down.conv.weight, down.conv.bias, stride=2, padding=1)
    with torch.no_grad():
        mean, _ = vae.encode(torch.from_numpy(x))
    assert mean.shape == np.asarray(mean_j).shape and _rel(mean, mean_j) > 1e-2


def test_posterior_sample_with_given_noise_matches_jax():
    """The JAX module's call (encode, sample, decode) with its normal draw
    passed to the port."""
    jcfg, jvae, params = _jax_vae()
    x = np.random.RandomState(5).uniform(-1, 1, (2, 16, 24, 3)).astype(np.float32)
    rng = jax.random.PRNGKey(3)
    recon_j, mean_j, _ = jvae.apply({"params": params}, x, rng)
    noise = np.array(jax.random.normal(rng, np.asarray(mean_j).shape, jnp.float32))
    vae = build_vae(VAEConfig.small_test(), device="cpu")
    vae.load_diffusers_state_dict(vae_state_dict_from_jax(params, jcfg))
    with torch.no_grad():
        mean, logvar = vae.encode(torch.from_numpy(x))
        recon = vae.decode(posterior_sample(mean, logvar, torch.from_numpy(noise)))
    assert recon.shape == (2, 16, 24, 3)
    assert _rel(mean, mean_j) <= 1e-5 and _rel(recon, recon_j) <= 1e-5
