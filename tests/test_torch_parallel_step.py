"""The sharded training step against the JAX step, which the JAX
package's own DP, FSDP, TP and seq steps equal (tests/test_fsdp.py,
tests/test_seq_parallel.py), from perturbed JAX weights, for the global
batch of 4. CAME behind a 0.01 clip and the EMA; the gradients' global norm
and the loss, the CAME update and the EMA are compared with JAX (the port's
gradients differ from JAX's by float rounding, 3e-4 relative, as in
tests/test_torch_training.py), and with the port's own one-rank step at f32
noise (rtol 2e-5, atol 2e-6).

- On 2 gloo ranks, fsdp = 2, tensor = 2 and seq = 2, with JAX's draws
  passed in (t, noise, caption drops), against JAX's one-device step. Each
  rank holds 2 rows (fsdp) or all 4 (tensor; seq, with half the tokens: its
  gradients summed over the seq ranks give the gradient norm). The same
  two processes also check `parallel.dist`'s collectives over gloo.
- The seq axis with tensor parallelism: tensor 2 x seq 2 on 4 ranks, and
  fsdp 2 x tensor 2 x seq 2 on 8 (`fsdp_min_size` 4096), against JAX's
  `make_train_step` (key 7) under `build_mesh` of the same mesh on JAX's
  virtual CPU devices, and against JAX's one-device step. Both that
  one-device step and the port are given the draws `make_train_step`
  makes (t, noise, caption drops). The 8 ranks also run the Trainer over
  data 2 x tensor 2 x seq 2 against one process at the global batch
  (tests/test_torch_parallel_train.py's checks).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.models.layers import CaptionEmbedder
from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.parallel.mesh import MeshConfig, build_mesh
from pixart_sigma_tpu.training.optim import build_optimizer as jax_build_optimizer
from pixart_sigma_tpu.training.train_state import TrainState as JaxTrainState
from pixart_sigma_tpu.training.train_step import make_train_step
from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.utils.checkpoint import state_dict_from_jax
from tests.test_torch_parallel_train import VALIDATE, _reference, check_against_reference
from tests.torch_parallel_worker import (
    assert_same,
    key_bias_free,
    run_step,
    spawn,
    tiny_config,
    write_data,
)

LR, CLIP, EMA_RATE, HIDDEN = 1e-3, 0.01, 0.9999, 128
CASES = {
    "fsdp2": dict(mesh=dict(data=1, fsdp=2), use_fsdp=True, fsdp_min_size=4096),
    "tensor2": dict(mesh=dict(data=1, tensor=2), use_tensor_parallel=True),
    "seq2": dict(mesh=dict(data=1, seq=2)),
}
# the seq axis with tensor parallelism: the port's config and its world
MESH_CASES = {
    "tensor2_seq2": (dict(mesh=dict(data=1, tensor=2, seq=2), use_tensor_parallel=True), 4),
    "fsdp2_tensor2_seq2": (dict(mesh=dict(data=1, fsdp=2, tensor=2, seq=2), use_fsdp=True,
                                use_tensor_parallel=True, fsdp_min_size=4096), 8),
}
TRAINER_8 = dict(mesh=dict(data=2, tensor=2, seq=2), use_tensor_parallel=True,
                 train_batch_size=2)
JAX_KEY = 7
# captions of 16 tokens; JAX's own step draws its caption drops at 0.5, so
# that some are dropped and some kept (the other steps are given theirs)
STEP_CONFIG = dict(model_max_length=16, class_dropout_prob=0.5)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


@pytest.fixture(scope="module")
def jax_step(tmp_path_factory):
    """(files of the weights and the batch, the port config, the JAX step's
    loss, gradient norm, parameters and EMA as port state dicts, the port's
    weights before the step)."""
    tmp = tmp_path_factory.mktemp("jax_step")
    cfg = tiny_config("", **STEP_CONFIG)
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

    def loss_fn(p, t, noise, drop):
        model_fn = lambda x_t, t_in: jm.apply({"params": p}, x_t, t_in, jnp.asarray(y),
                                              jnp.asarray(mask), train=True,
                                              force_drop_ids=jnp.asarray(drop))
        return jnp.mean(jd.training_losses(model_fn, jnp.asarray(x0), jnp.asarray(t),
                                           noise=jnp.asarray(noise))["loss"])

    tx = jax_build_optimizer(name="came", learning_rate=LR, grad_clip_norm=CLIP,
                             betas=(0.9, 0.999, 0.9999), eps=(1e-30, 1e-16))
    js0 = JaxTrainState.create(params=params, tx=tx, ema=True, ema_rate=EMA_RATE)
    value_and_grad = jax.jit(jax.value_and_grad(loss_fn))
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    loss, grads = value_and_grad(params, t, noise, drop)
    gnorm = np.sqrt(sum(float(jnp.sum(jnp.square(g))) for g in jax.tree_util.tree_leaves(grads)))
    js = apply(js0, grads)
    before = state_dict_from_jax(params, pcfg)
    files = dict(weights=str(tmp / "weights.npz"), batch=str(tmp / "batch.npz"))
    np.savez(files["weights"], **{k: v.numpy() for k, v in before.items()})
    np.savez(files["batch"], latents=x0, y=y, y_mask=mask, noise=noise, t=t, drop=drop)
    jax_parts = dict(model=jm, diffusion=jd, state=js0, value_and_grad=value_and_grad,
                     apply=apply, params=params,
                     batch=dict(latents=jnp.asarray(x0), y=jnp.asarray(y),
                                y_mask=jnp.asarray(mask)))
    return dict(files=files, loss=float(loss), grad_norm=gnorm, before=before,
                params=state_dict_from_jax(js.params, pcfg),
                ema=state_dict_from_jax(js.ema_params, pcfg), jax=jax_parts, cfg=pcfg)


def _step_draws(jm, params, batch, key):
    """The draws of `make_train_step`'s first step from `key`: t and the
    noise from the key folded with the step and split four ways, and the
    caption drops that the caption embedder draws from the third key (read
    off its output: a dropped row is the null caption's)."""
    t_rng, noise_rng, drop_rng, _ = jax.random.split(jax.random.fold_in(key, 0), 4)
    latents, y = batch["latents"], batch["y"]
    B = latents.shape[0]
    t = jax.random.randint(t_rng, (B,), 0, 1000)
    noise = jax.random.normal(noise_rng, latents.shape, latents.dtype)
    _, seen = jm.apply({"params": params}, latents, t, y, batch["y_mask"], train=True,
                       rngs={"caption_drop": drop_rng}, mutable=["intermediates"],
                       capture_intermediates=lambda mdl, _: mdl.name == "y_embedder")
    drawn = np.asarray(seen["intermediates"]["y_embedder"]["__call__"][0])
    cfg = jm.cfg
    null = np.asarray(CaptionEmbedder(cfg.caption_channels, cfg.hidden_size,
                                      token_num=cfg.model_max_length).apply(
        {"params": params["y_embedder"]}, y, force_drop_ids=jnp.ones((B,), jnp.int32)))
    drop = np.asarray([np.array_equal(drawn[i], null[i]) for i in range(B)], np.int32)
    return np.asarray(t, np.int32), np.asarray(noise), drop


@pytest.fixture(scope="module")
def jax_mesh_steps(jax_step, tmp_path_factory):
    """JAX's own step from the weights and the batch of `jax_step`:
    `make_train_step` keyed `JAX_KEY` under each case's mesh on the virtual
    devices, and on one device `jax_step`'s step given the draws that
    `make_train_step` makes (its loss must be theirs); JAX's metrics,
    parameters and EMA as port state dicts, and the batch file with the
    draws, for the workers."""
    tmp = tmp_path_factory.mktemp("jax_mesh_steps")
    j, pcfg = jax_step["jax"], jax_step["cfg"]
    key = jax.random.PRNGKey(JAX_KEY)
    t, noise, drop = _step_draws(j["model"], j["params"], j["batch"], key)
    assert set(drop.tolist()) == {0, 1}, drop  # the null caption is learned, and a caption
    loss, grads = j["value_and_grad"](j["params"], t, noise, drop)
    state = j["apply"](j["state"], grads)
    gnorm = np.sqrt(sum(float(jnp.sum(jnp.square(g))) for g in jax.tree_util.tree_leaves(grads)))
    out = {"one": dict(loss=float(loss), grad_norm=gnorm,
                       params=state_dict_from_jax(state.params, pcfg),
                       ema=state_dict_from_jax(state.ema_params, pcfg))}
    for case, (cfg, world) in MESH_CASES.items():
        mesh = build_mesh(MeshConfig(**cfg["mesh"]), devices=jax.devices()[:world])
        step = make_train_step(j["model"], j["diffusion"], mesh=mesh, donate=False,
                               fsdp=cfg.get("use_fsdp", False), tensor=True,
                               fsdp_min_size=cfg.get("fsdp_min_size", 2**16))
        state, metrics = step(j["state"], j["batch"], key)
        out[case] = dict(loss=float(metrics["loss"]), grad_norm=float(metrics["grad_norm"]),
                         params=state_dict_from_jax(state.params, pcfg),
                         ema=state_dict_from_jax(state.ema_params, pcfg))
        # the draws read back are the mesh step's
        assert out[case]["loss"] == pytest.approx(out["one"]["loss"], rel=1e-5)
    batch = str(tmp / "batch.npz")
    np.savez(batch, **{k: np.asarray(v) for k, v in j["batch"].items()}, t=t, noise=noise,
             drop=drop)
    out["files"] = dict(jax_step["files"], batch=batch)
    return out


def _run(files, config):
    return dict(kind="step", config=dict(config, **STEP_CONFIG), lr=LR, clip=CLIP,
                ema_rate=EMA_RATE, **files)


@pytest.fixture(scope="module")
def runs(jax_step, tmp_path_factory):
    """Both cases in one pair of gloo processes (the collectives first), and
    the port's one-rank step without a process group."""
    files = jax_step["files"]
    ranks = spawn(tmp_path_factory.mktemp("step_ranks"), 2,
                  [dict(kind="collectives")] + [_run(files, CASES[c]) for c in sorted(CASES)])
    return ranks, run_step(_run(files, {}))


@pytest.fixture(scope="module")
def mesh_runs(jax_mesh_steps, tmp_path_factory):
    """The seq x tensor steps from JAX's draws: tensor 2 x seq 2 on 4 gloo
    processes; fsdp 2 x tensor 2 x seq 2 on 8, then in the same processes
    the Trainer over data 2 x tensor 2 x seq 2; the port's one-rank step from
    the same draws; and one process's Trainer run at the global batch:
    (case -> rank results, one-rank step, reference, the Trainer's work
    dir)."""
    files = jax_mesh_steps["files"]
    got = {}
    for case, (cfg, world) in MESH_CASES.items():
        runs = [_run(files, cfg)]
        if world == 8:
            root = write_data(tmp_path_factory.mktemp("mesh_data"))
            work = str(tmp_path_factory.mktemp("mesh_trainer") / "data2_tensor2_seq2")
            runs.append(dict(kind="trainer", data_root=root, work_dir=work, steps=3,
                             config=dict(TRAINER_8, **VALIDATE)))
        got[case] = spawn(tmp_path_factory.mktemp(f"mesh_{world}"), world, runs)
    return got, run_step(_run(files, {})), _reference(root, "one"), work


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


@pytest.mark.parametrize("case", sorted(MESH_CASES))
def test_seq_with_tensor_step_matches_jax_under_the_same_mesh(case, jax_step, jax_mesh_steps,
                                                               mesh_runs):
    """The port's step over `case`'s ranks against JAX's `make_train_step`
    under the same mesh and on one device: the loss and the gradients' norm
    (the seq sum and the tensor-sharded parameters counted once each), the
    CAME update behind the clip and the EMA; and against the port's one-rank
    step from the same draws."""
    ranks, one = mesh_runs[0][case], mesh_runs[1]
    got = ranks[0][0]
    for other in ranks[1:]:  # every rank ends with the same whole tensors
        assert_same(other[0]["params"], got["params"], HIDDEN, rtol=0, atol=0)
    m = got["history"][0]
    before = jax_step["before"]
    for want in (jax_mesh_steps[case], jax_mesh_steps["one"]):
        assert m["grad_norm"] == pytest.approx(want["grad_norm"], rel=3e-4)
        assert m["loss"] == pytest.approx(want["loss"], rel=3e-4)
        for key in ("params", "ema"):
            worst = max((_rel_l2(key_bias_free(n, got[key][n] - before[n], HIDDEN),
                                 key_bias_free(n, want[key][n] - before[n], HIDDEN)), n)
                        for n in before)
            assert worst[0] < 2e-3, (key, worst)
    assert m["grad_norm"] == pytest.approx(one["history"][0]["grad_norm"], rel=2e-5)
    assert m["loss"] == pytest.approx(one["history"][0]["loss"], rel=2e-5)
    for key in ("params", "ema"):
        assert_same(got[key], one[key], HIDDEN)


def test_trainer_over_data_tensor_and_seq_matches_one_process(mesh_runs):
    """data 2 x tensor 2 x seq 2 on 8 ranks, 2 rows each: the history,
    parameters, EMA and validation latents of one process at the global
    batch of 4."""
    ranks, _, reference, work = mesh_runs
    got = [r[1] for r in ranks["fsdp2_tensor2_seq2"]]
    check_against_reference(got, reference, work)
    assert [r["batch_rank"] for r in got] == [0, 0, 0, 0, 1, 1, 1, 1]

