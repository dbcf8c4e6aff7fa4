"""The sharded training step against the JAX step on one device, which the
JAX package's own DP, FSDP, TP and seq steps equal (tests/test_fsdp.py,
tests/test_seq_parallel.py): one step on 2 gloo ranks with fsdp = 2, one
with tensor = 2 and one with seq = 2, from perturbed JAX weights, with
JAX's draws passed in (t, noise, caption drops) for the global batch of 4.
Each rank holds 2 rows (fsdp) or all 4 (tensor; seq, with half the tokens:
its gradients summed over the seq ranks give the gradient norm). The
gradients' global norm and the loss, the CAME update behind a 0.01 clip and
the EMA are compared with JAX (the port's gradients differ from JAX's by
float rounding, 3e-4 relative, as in tests/test_torch_training.py), and
with the port's own one-rank step at f32 noise (rtol 2e-5, atol 2e-6). The
same two processes also check `parallel.dist`'s collectives over gloo.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.training.optim import build_optimizer as jax_build_optimizer
from pixart_sigma_tpu.training.train_state import TrainState as JaxTrainState
from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.torch_parallel_worker import (
    assert_same,
    key_bias_free,
    run_step,
    spawn,
    tiny_config,
)

LR, CLIP, EMA_RATE, HIDDEN = 1e-3, 0.01, 0.9999, 128
CASES = {
    "fsdp2": dict(mesh=dict(data=1, fsdp=2), use_fsdp=True, fsdp_min_size=4096),
    "tensor2": dict(mesh=dict(data=1, tensor=2), use_tensor_parallel=True),
    "seq2": dict(mesh=dict(data=1, seq=2)),
}


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """(files of the weights and the batch, the port config, the JAX step's
    loss, gradient norm, parameters and EMA as port state dicts, the port's
    weights before the step)."""
    tmp = tmp_path_factory.mktemp("jax_step")
    cfg = tiny_config("", model_max_length=16)
    pcfg = build_model_from_config(cfg, device="cpu", train=True).cfg
    kw = {f.name: getattr(pcfg, f.name) for f in dataclasses.fields(JaxConfig)
          if f.name != "dtype"}
    # no remat: the same numbers, compiled faster
    jcfg = JaxConfig(**dict(kw, grad_checkpointing=False), dtype=jnp.float32)
    jm = JaxPixArt(jcfg)
    rng = np.random.RandomState(0)
    B = 4
    x0 = rng.randn(B, 16, 16, 4).astype(np.float32)
    y = rng.randn(B, 16, 64).astype(np.float32)
    mask = (np.arange(16)[None] < np.asarray([[16], [5], [9], [1]])).astype(np.int32)
    noise = rng.randn(B, 16, 16, 4).astype(np.float32)
    t = np.asarray([0, 731, 15, 402], np.int32)
    drop = np.asarray([0, 1, 0, 0], np.int32)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x0[:1]), jnp.asarray(t[:1]),
                              jnp.asarray(y[:1]), jnp.asarray(mask[:1]))["params"]
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape), jnp.float32), params)
    jd = JaxIDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)

    def loss_fn(p):
        model_fn = lambda x_t, t_in: jm.apply({"params": p}, x_t, t_in, jnp.asarray(y),
                                              jnp.asarray(mask), train=True,
                                              force_drop_ids=jnp.asarray(drop))
        return jnp.mean(jd.training_losses(model_fn, jnp.asarray(x0), jnp.asarray(t),
                                           noise=jnp.asarray(noise))["loss"])

    loss, grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    gnorm = np.sqrt(sum(float(jnp.sum(jnp.square(g))) for g in jax.tree_util.tree_leaves(grads)))
    tx = jax_build_optimizer(name="came", learning_rate=LR, grad_clip_norm=CLIP,
                             betas=(0.9, 0.999, 0.9999), eps=(1e-30, 1e-16))
    js = JaxTrainState.create(params=params, tx=tx, ema=True, ema_rate=EMA_RATE)
    js = jax.jit(lambda s, g: s.apply_gradients(g))(js, grads)
    before = state_dict_from_jax(params, pcfg)
    files = dict(weights=str(tmp / "weights.npz"), batch=str(tmp / "batch.npz"))
    np.savez(files["weights"], **{k: v.numpy() for k, v in before.items()})
    np.savez(files["batch"], latents=x0, y=y, y_mask=mask, noise=noise, t=t, drop=drop)
    return dict(files=files, loss=float(loss), grad_norm=gnorm, before=before,
                params=state_dict_from_jax(js.params, pcfg),
                ema=state_dict_from_jax(js.ema_params, pcfg))


def _run(files, config):
    return dict(kind="step", config=dict(config, model_max_length=16), lr=LR, clip=CLIP,
                ema_rate=EMA_RATE, **files)


@pytest.fixture(scope="module")
def runs(jax_step, tmp_path_factory):
    """Both cases in one pair of gloo processes (the collectives first), and
    the port's one-rank step without a process group."""
    files = jax_step["files"]
    ranks = spawn(tmp_path_factory.mktemp("step_ranks"), 2,
                  [dict(kind="collectives")] + [_run(files, CASES[c]) for c in sorted(CASES)])
    return ranks, run_step(_run(files, {}))


def test_collectives_over_gloo(runs):
    for r, results in enumerate(runs[0]):
        c = results[0]
        assert torch.equal(c["gathered"], torch.tensor([[0.0, 1, 2], [1, 2, 3]]))
        # d/dx_r of sum_s (s + 1) * (i + 1) * gathered[i]: rank r's row is
        # i = r, weighed (r + 1) by every rank s
        assert torch.equal(c["grad"], torch.full((1, 3), (r + 1.0) * 3))
        assert {k: float(v) for k, v in c["reduced"].items()} == {"a": 0.5, "b": 1.0}
        assert c["objects"] == [{"rank": 0}, {"rank": 1}]
        assert c["broadcast"] == {"from": 0}


@pytest.mark.parametrize("case", sorted(CASES))
def test_sharded_step_matches_jax(case, jax_step, runs):
    ranks, one = runs
    i = 1 + sorted(CASES).index(case)
    got = ranks[0][i]
    for other in ranks[1:]:  # every rank ends with the same whole tensors
        assert_same(other[i]["params"], got["params"], HIDDEN, rtol=0, atol=0)
    m = got["history"][0]
    assert m["grad_norm"] == pytest.approx(jax_step["grad_norm"], rel=3e-4)
    assert m["loss"] == pytest.approx(jax_step["loss"], rel=3e-4)
    assert m["grad_norm"] == pytest.approx(one["history"][0]["grad_norm"], rel=2e-5)
    assert m["loss"] == pytest.approx(one["history"][0]["loss"], rel=2e-5)
    before = jax_step["before"]
    for key in ("params", "ema"):
        assert_same(got[key], one[key], HIDDEN)
        worst = max((_rel_l2(key_bias_free(n, got[key][n] - before[n], HIDDEN),
                             key_bias_free(n, jax_step[key][n] - before[n], HIDDEN)), n)
                    for n in before)
        assert worst[0] < 2e-3, (key, worst)
