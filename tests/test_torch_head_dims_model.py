"""A small PixArt at head dims other than 72 against the JAX model, on the
CPU: width 256 with 2 heads (Dh = 128, as XL-2's 1152 with 9 heads) and
width 144 with 4 heads (Dh = 36, as 1152 with 32), 2 blocks, KV compression
on block 1, from the same perturbed params: the forward, and one training
step's loss and every parameter's gradient (the iDDPM losses with the
learned-range term).

Tolerances as tests/test_torch_model.py and test_torch_training.py: the
forward f32 1e-4; the loss 3e-4 relative, gradients 3e-4 relative L2 per
parameter (both sides multiply in f32 and sum in other orders).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.models.pixart import PixArtConfig, PixArtMS_XL_2
from pixart_sigma_tpu_torch.training.train_step import compute_losses
from pixart_sigma_tpu_torch.utils.checkpoint import state_dict_from_jax


# ---------------------------------------------------------------- a small PixArt


SMALL = {  # hidden, heads: Dh = 128 (XL-2's 1152 with 9 heads) and 36 (32 heads)
    128: dict(hidden_size=256, num_heads=2),
    36: dict(hidden_size=144, num_heads=4),
}


@functools.cache
def _jax_small(dh):
    """(JAX model, its perturbed params, the inputs): the JAX init is the
    slow part, so both tests of a head dim share it."""
    cfg = dict(input_size=16, depth=2, caption_channels=32, model_max_length=12,
               kv_compress_sampling="conv", kv_compress_scale=2, kv_compress_layers=(1,),
               **SMALL[dh])
    jm = JaxPixArt(JaxConfig(**cfg, dtype=jnp.float32, scan_blocks=False))
    rng = np.random.RandomState(dh)
    x0 = rng.randn(2, 16, 16, 4).astype(np.float32)
    y = rng.randn(2, 12, 32).astype(np.float32)
    mask = (np.arange(12)[None] < np.asarray([[12], [5]])).astype(np.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x0[:1]),
                              jnp.asarray(np.zeros(1, np.float32)), jnp.asarray(y[:1]),
                              jnp.asarray(mask[:1]))["params"]
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape), jnp.float32), params)
    return jm, params, (x0, y, mask)


def _small(dh):
    """(JAX model, params, a fresh port training model with those weights,
    its config, the inputs)."""
    jm, params, inputs = _jax_small(dh)
    kw = {f.name: getattr(jm.cfg, f.name) for f in dataclasses.fields(jm.cfg)
          if f.name != "dtype"}
    pcfg = PixArtConfig(**kw, dtype=torch.float32)
    tm = PixArtMS_XL_2(device="cpu", train=True,
                       **{f.name: getattr(pcfg, f.name) for f in dataclasses.fields(pcfg)})
    tm.load_state_dict(state_dict_from_jax(params, pcfg))
    return jm, params, tm, pcfg, inputs


@pytest.mark.parametrize("dh", sorted(SMALL))
def test_small_pixart_forward_matches_jax(dh):
    jm, params, tm, _, (x0, y, mask) = _small(dh)
    assert tm.cfg.hidden_size // tm.cfg.num_heads == dh
    t = np.asarray([10.0, 700.0], np.float32)
    want = jm.apply({"params": params}, jnp.asarray(x0), jnp.asarray(t), jnp.asarray(y),
                    jnp.asarray(mask))
    with torch.no_grad():
        got = tm(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(y),
                 torch.from_numpy(mask))
    np.testing.assert_allclose(got.numpy(), np.asarray(want), atol=1e-4, rtol=1e-4)


@pytest.mark.parametrize("dh", sorted(SMALL))
def test_small_pixart_training_step_matches_jax(dh):
    """One training step's loss and every parameter's gradient (relative L2
    per parameter), the iDDPM losses with the learned-range term."""
    jm, params, tm, pcfg, (x0, y, mask) = _small(dh)
    noise = np.random.RandomState(dh + 1).randn(*x0.shape).astype(np.float32)
    t, drop = np.asarray([3, 731], np.int32), np.asarray([0, 1], np.int32)
    jd = JaxIDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)

    def loss_fn(p):
        model_fn = lambda x_t, t_in: jm.apply(
            {"params": p}, x_t, t_in, jnp.asarray(y), jnp.asarray(mask), train=True,
            force_drop_ids=jnp.asarray(drop))
        terms = jd.training_losses(model_fn, jnp.asarray(x0), jnp.asarray(t),
                                   noise=jnp.asarray(noise))
        return jnp.mean(terms["loss"])

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    td = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    batch = {"latents": torch.from_numpy(x0), "y": torch.from_numpy(y),
             "y_mask": torch.from_numpy(mask)}
    terms = compute_losses(tm, td, batch, torch.from_numpy(t).long(), torch.from_numpy(noise),
                           force_drop_ids=torch.from_numpy(drop))
    terms["loss"].backward()
    np.testing.assert_allclose(float(terms["loss"].detach()), float(want_loss), rtol=3e-4)
    want = state_dict_from_jax(want_grads, pcfg)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    rel = lambda g, w: float(np.linalg.norm(g - w) / max(np.linalg.norm(w), 1e-30))
    worst = max((rel(got[k].grad.double().numpy(), want[k].double().numpy()), k) for k in want)
    assert worst[0] <= 3e-4, worst
