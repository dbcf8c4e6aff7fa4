"""The port's training path against the JAX package, on the CPU.

- the iDDPM losses (`training_losses`, with the learned-range VB term) on a
  fixed model function;
- the loss and every parameter gradient of a toy PixArtMS (depth 4, hidden
  144, 2 heads, KV compression conv x2 on layers 2-3, so the depthwise conv
  and the patch-embedding conv take gradients), from the same perturbed
  params, x0, t, noise and forced caption drops, at f32 and at bf16 compute;
- CAME behind the global-norm clip, with the EMA, and AdamW, over 3 steps
  on the same gradients, and the LR schedules;
- the single-card Trainer for 3 steps on a synthetic feature dataset.

Tolerances: losses f32 1e-5 relative; gradients by relative L2 per
parameter, f32 3e-4 (both sides multiply in f32 and sum in other orders;
the worst parameter reads 6.9e-5), bf16 5e-2 (the two frameworks round
activations to bf16 at other places; the worst reads 2.2e-2);
optimizer states and parameters after 3 steps 1e-5 relative (all f32).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.diffusion.respace import space_timesteps as jax_space_timesteps
from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.training import lr_schedule as jlr
from pixart_sigma_tpu.training.optim import build_optimizer as jax_build_optimizer
from pixart_sigma_tpu.training.train_state import TrainState as JaxTrainState
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.diffusion.respace import space_timesteps
from pixart_sigma_tpu_torch.models.pixart import PixArtConfig, PixArtMS_XL_2
from pixart_sigma_tpu_torch.training import lr_schedule as tlr
from pixart_sigma_tpu_torch.training.optim import build_optimizer, clip_by_global_norm
from pixart_sigma_tpu_torch.training.train_state import TrainState
from pixart_sigma_tpu_torch.training.train_step import compute_losses
from pixart_sigma_tpu_torch.training.trainer import Trainer
from pixart_sigma_tpu_torch.utils.checkpoint import load_pth, state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGMA_1024 = os.path.join(
    ROOT, "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_internalms_kvcompress.py")
TOY = dict(input_size=16, depth=4, hidden_size=144, num_heads=2, caption_channels=32,
           model_max_length=12, kv_compress_sampling="conv", kv_compress_scale=2,
           kv_compress_layers=(2, 3))
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _perturb(tree, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + scale * rng.randn(*a.shape), jnp.float32), tree)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(2, 16, 16, 4).astype(np.float32)
    y = rng.randn(2, 12, 32).astype(np.float32)
    mask = (np.arange(12)[None] < np.asarray([[12], [5]])).astype(np.int32)
    noise = rng.randn(2, 16, 16, 4).astype(np.float32)
    t = np.asarray([0, 731], np.int32)  # t = 0 takes the decoder-NLL branch of the VB term
    drop = np.asarray([0, 1], np.int32)
    return x0, y, mask, noise, t, drop


def test_space_timesteps_match_jax():
    for n, counts in ((1000, [1000]), (1000, "10,15,20"), (100, "ddim25"), (50, [7, 3])):
        assert space_timesteps(n, counts) == jax_space_timesteps(n, counts)


def test_training_losses_match_jax():
    """All loss terms on a fixed model function of (x_t, t)."""
    x0, _, _, noise, t, _ = _batch()
    x0 = np.tanh(x0)  # a [-1, 1] image, so the decoder NLL sees its edges
    fn = lambda lib: lambda x, tt: lib.concatenate(
        [0.5 * x + 0.01 * tt.reshape(-1, 1, 1, 1), lib.tanh(x)], axis=-1)
    jd = JaxIDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    want = jd.training_losses(fn(jnp), jnp.asarray(x0), jnp.asarray(t), noise=jnp.asarray(noise))
    tfn = lambda x, tt: torch.cat([0.5 * x + 0.01 * tt.reshape(-1, 1, 1, 1), torch.tanh(x)], -1)
    td = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    got = td.training_losses(tfn, torch.from_numpy(x0), torch.from_numpy(t).long(),
                             torch.from_numpy(noise))
    for key in ("loss", "mse", "vb", "pred_xstart", "x_t"):
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


def _toy_models(dtype):
    """(JAX model, perturbed params, port training model with those weights)."""
    jcfg = JaxConfig(**TOY, dtype=dtype, scan_blocks=False)
    jm = JaxPixArt(jcfg)
    x0, y, mask, _, t, _ = _batch()
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x0[:1]),
                              jnp.asarray(t[:1]), jnp.asarray(y[:1]),
                              jnp.asarray(mask[:1]))["params"]
    params = _perturb(params, 1)
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = PixArtConfig(**kw, dtype=TORCH_DTYPE[dtype])
    tm = PixArtMS_XL_2(device="cpu", train=True,
                       **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    tm.load_state_dict(state_dict_from_jax(params, cfg))
    return jm, params, tm, cfg


@pytest.mark.parametrize("dtype,remat,tol", [
    (jnp.float32, False, 3e-4),
    (jnp.float32, True, 3e-4),   # per-block recompute gives the same gradients
    (jnp.bfloat16, False, 5e-2),
])
def test_model_gradients_match_jax(dtype, remat, tol):
    jm, params, tm, cfg = _toy_models(dtype)
    if remat:
        tm.cfg = dataclasses.replace(cfg, grad_checkpointing=True)
    x0, y, mask, noise, t, drop = _batch()
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
    np.testing.assert_allclose(float(terms["loss"].detach()), float(want_loss), rtol=tol)
    want = state_dict_from_jax(want_grads, cfg)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    worst = max((_rel_l2(got[k].grad.numpy(), want[k].numpy()), k) for k in want)
    assert worst[0] <= tol, worst
    assert all(p.grad.dtype == torch.float32 for p in got.values())


def test_came_clip_and_ema_match_jax_over_three_steps():
    """CAME (every kind of parameter of the toy model, the convolutions
    included) behind a 0.01 global-norm clip, then the EMA with warmup."""
    _, params, tm, cfg = _toy_models(jnp.float32)
    rng = np.random.RandomState(2)
    grads = [jax.tree_util.tree_map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32),
                                    params) for _ in range(3)]
    schedule = jlr.constant_with_warmup(1e-3, 2)
    tx = jax_build_optimizer(name="came", learning_rate=schedule, grad_clip_norm=0.01,
                             betas=(0.9, 0.999, 0.9999), eps=(1e-30, 1e-16))
    js = JaxTrainState.create(params=params, tx=tx, ema=True, ema_rate=0.9999)
    named = list(tm.named_parameters())
    state = TrainState(tm, build_optimizer(named, name="came", lr=0.0), tlr.constant_with_warmup(
        1e-3, 2), ema=True, ema_rate=0.9999)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for g in grads:
        js = apply(js, g)
        for name, tg in state_dict_from_jax(g, cfg).items():
            dict(named)[name].grad = tg.clone()
        clip_by_global_norm([p for _, p in named], 0.01)
        state.apply_gradients()
    assert state.step == int(js.step) == 3
    for tree, got in ((js.params, dict(tm.named_parameters())), (js.ema_params, state.ema)):
        want = state_dict_from_jax(tree, cfg)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)


def test_adamw_matches_jax_over_three_steps():
    rng = np.random.RandomState(4)
    params = {"w": rng.randn(3, 5).astype(np.float32), "b": rng.randn(5).astype(np.float32)}
    grads = [{k: rng.randn(*v.shape).astype(np.float32) for k, v in params.items()}
             for _ in range(3)]
    tx = jax_build_optimizer(name="adamw", learning_rate=1e-2, weight_decay=3e-2, eps=1e-10,
                             grad_clip_norm=1.0)
    jp = {k: jnp.asarray(v) for k, v in params.items()}
    opt_state = tx.init(jp)
    named = [(k, torch.tensor(v, requires_grad=True)) for k, v in params.items()]
    opt = build_optimizer(named, name="adamw", lr=1e-2, weight_decay=3e-2, eps=1e-10)
    for g in grads:
        upd, opt_state = tx.update({k: jnp.asarray(v) for k, v in g.items()}, opt_state, jp)
        jp = {k: jp[k] + upd[k] for k in jp}
        for k, p in named:
            p.grad = torch.from_numpy(g[k])
        clip_by_global_norm([p for _, p in named], 1.0)
        opt.step()
    for k, p in named:
        np.testing.assert_allclose(p.detach().numpy(), np.asarray(jp[k]), rtol=1e-5, atol=1e-6)


@pytest.mark.parametrize("name,kwargs", [
    ("constant", dict(num_warmup_steps=5)),
    ("cosine", dict(num_warmup_steps=5, num_training_steps=40)),
    ("cosine_decay_to_constant", dict(num_warmup_steps=5, num_training_steps=40,
                                      lr_scale_ratio=4.0)),
])
def test_lr_schedules_match_jax(name, kwargs):
    want = jlr.build_lr_schedule(name, 2e-5, **kwargs)
    got = tlr.build_lr_schedule(name, 2e-5, **kwargs)
    for step in (0, 1, 4, 5, 6, 20, 26, 27, 39, 40, 55):
        np.testing.assert_allclose(got(step), float(want(step)), rtol=1e-6, atol=1e-12)


def _tiny_config(data_root):
    cfg = read_config(SIGMA_1024)
    cfg.update(image_size=256, aspect_ratio_type=256, train_batch_size=2, data_root=data_root,
               num_workers=2, log_interval=1, lr_schedule_args=dict(num_warmup_steps=1),
               model_overrides=dict(depth=2, hidden_size=144, num_heads=2,
                                    caption_channels=32, kv_compress_layers=(1,)))
    cfg.data = dict(cfg.data, root="data", load_vae_feat=True, load_t5_feat=True)
    return cfg


def test_trainer_runs_three_steps_on_the_cpu(tmp_path):
    """The operating point's config (CAME, clip 0.01, EMA, KV compression,
    grad checkpointing, bf16 compute) cut to a tiny model at 256px."""
    write_feature_dataset(str(tmp_path / "data"), [(256, 256)] * 2 + [(272, 240)] * 2,
                          resolution=256, caption_channels=32)
    cfg = _tiny_config(str(tmp_path))
    trainer = Trainer(cfg, str(tmp_path / "work"), device="cpu")
    assert trainer.model.cfg.grad_checkpointing and trainer.model.cfg.dtype == torch.bfloat16
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    state = trainer.train(max_steps=3)
    assert state.step == 3 and len(trainer.history) == 3
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in trainer.history)
    assert {h["hw"] for h in trainer.history} == {(32, 32), (34, 30)}
    # parameters behind a zero-initialised projection get no gradient yet
    moved = {n for n, p in trainer.model.named_parameters() if not torch.equal(p, before[n])}
    assert {"x_embedder.proj.weight", "blocks.1.attn.sr.weight", "blocks.0.attn.qkv.weight",
            "final_layer.linear.weight"} <= moved and len(moved) > 0.7 * len(before)
    assert any(not torch.equal(state.ema[n], before[n]) for n in moved)
    path = trainer.save(state.step, 0)
    ckpt = torch.load(path, weights_only=True)
    assert {"state_dict", "state_dict_ema", "optimizer"} <= set(ckpt)
    reloaded = load_pth(PixArtMS_XL_2(device="cpu", train=True, **{
        f.name: getattr(trainer.model.cfg, f.name) for f in dataclasses.fields(PixArtConfig)}),
        path)
    for n, p in reloaded.named_parameters():
        assert torch.equal(p, dict(trainer.model.named_parameters())[n])
    assert not torch.cuda.is_initialized()


def test_trainer_needs_a_card_unless_asked_for_the_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        Trainer(_tiny_config(str(tmp_path)), str(tmp_path / "work"))
