"""The port's VAE decoder against the JAX package, on the CPU.

`VAEConfig.small_test` decode with the same (perturbed) weights agrees to
float32 atol 1e-4, and `vae_state_dict_from_jax` is the exact inverse of the
JAX package's `diffusers_vae_to_flax`.
"""

import jax
import jax.numpy as jnp
import numpy as np
import torch

from pixart_sigma_tpu.models.vae import AutoencoderKL as JaxVAE
from pixart_sigma_tpu.models.vae import VAEConfig as JaxVAEConfig
from pixart_sigma_tpu.models.vae import diffusers_vae_to_flax
from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
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
    decoder_keys = {k for k in sd if k.startswith(("decoder.", "post_quant_conv."))}
    assert decoder_keys == set(build_vae(VAEConfig.small_test(), device="cpu").state_dict())
