"""The trainer features of the port against the JAX package, on the CPU.

- Min-SNR weights, the SNR-switching objective and the masked per-patch
  losses of `training_losses` on a fixed model function, with given t and
  noise;
- the loss-second-moment resampler's weights and its ring update (a
  timestep drawn twice in one batch takes both losses);
- `get_mask` with JAX's draw, the FFT and Laplacian strengths,
  `mask_out_token` and `unmask_tokens`;
- the masked model's loss and gradients from JAX params (`mask_token`
  carried by `state_dict_from_jax`), with JAX's mask draw passed in;
- `jax_param_path` against the JAX param tree, and CAME, Lion and AdamW
  with `no_weight_decay_on` over 3 steps;
- gradient accumulation k = 2 against `optax.MultiSteps` in the JAX
  TrainState over 4 micro-steps;
- every remat policy against "nothing", and the attention launches
  "save_attn" saves;
- `log_validation` against the JAX trainer's, with the same noise;
- the balanced bucket sampler, the logging and NaN-report helpers, and the
  masked toy config through the Trainer.

Tolerances: losses and weights f32 1e-5 relative; masking ids exact;
gradients by relative L2 per parameter 3e-4 (f32, as
tests/test_torch_training.py); optimizer states and parameters 1e-5 relative;
remat policies exact; validation latents 1e-3
relative L2 (14 CFG steps of a random model in f32).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import os
import types

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

import pixart_sigma_tpu.ops.masking as jax_masking
from pixart_sigma_tpu.data.sampler import (
    BalancedAspectRatioBatchSampler as JaxBalancedSampler,
)
from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.diffusion.timestep_sampler import (
    LossSecondMomentResampler as JaxResampler,
)
from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.parallel.mesh import build_mesh
from pixart_sigma_tpu.training import lr_schedule as jlr
from pixart_sigma_tpu.training.optim import build_optimizer as jax_build_optimizer
from pixart_sigma_tpu.training.train_state import TrainState as JaxTrainState
from pixart_sigma_tpu.training.trainer import Trainer as JaxTrainer
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table
from pixart_sigma_tpu_torch.data.sampler import BalancedAspectRatioBatchSampler
from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.diffusion.timestep_sampler import LossSecondMomentResampler
from pixart_sigma_tpu_torch.models.pixart import REMAT_SAVED, PixArtConfig, PixArtMS_XL_2
from pixart_sigma_tpu_torch.ops import flash_attention as fa
from pixart_sigma_tpu_torch.ops import masking
from pixart_sigma_tpu_torch.training import lr_schedule as tlr
from pixart_sigma_tpu_torch.training.optim import block_stacks, build_optimizer
from pixart_sigma_tpu_torch.training.train_state import TrainState
from pixart_sigma_tpu_torch.training.train_step import compute_losses, train_step
from pixart_sigma_tpu_torch.training.trainer import Trainer
from pixart_sigma_tpu_torch.utils.checkpoint import jax_param_path, state_dict_from_jax
from pixart_sigma_tpu_torch.utils.debug import find_nonfinite, first_bad_module
from pixart_sigma_tpu_torch.utils.logging import LogBuffer, Tracker
from tests.test_torch_trainer_resume import _features_config

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
MASKED_TOY = os.path.join(ROOT, "configs/toy/pixart_toy_img128_masked.py")
TOY = dict(input_size=16, depth=4, hidden_size=144, num_heads=2, caption_channels=32,
           model_max_length=12)
TOY_KV = dict(TOY, kv_compress_sampling="conv", kv_compress_scale=2, kv_compress_layers=(2, 3))


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _perturb(tree, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + scale * rng.randn(*a.shape), jnp.float32), tree)


def _toy(arch, **jax_kw):
    """(JAX model, perturbed params, port training model with those weights, port cfg)."""
    jcfg = JaxConfig(**arch, dtype=jnp.float32, **jax_kw)
    jm = JaxPixArt(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 12, 32)), jnp.ones((1, 12), jnp.int32))["params"]
    params = _perturb(params, 1)
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = PixArtConfig(**kw, dtype=torch.float32)
    tm = PixArtMS_XL_2(device="cpu", train=True,
                       **{f.name: getattr(cfg, f.name) for f in dataclasses.fields(cfg)})
    tm.load_state_dict(state_dict_from_jax(params, cfg))
    return jm, params, tm, cfg


def _batch(seed=0):
    rng = np.random.RandomState(seed)
    x0 = rng.randn(2, 16, 16, 4).astype(np.float32)
    y = rng.randn(2, 12, 32).astype(np.float32)
    mask = (np.arange(12)[None] < np.asarray([[12], [5]])).astype(np.int32)
    noise = rng.randn(2, 16, 16, 4).astype(np.float32)
    t = np.asarray([120, 731], np.int32)  # one on each side of the snr switch at 249
    drop = np.asarray([0, 1], np.int32)
    return x0, y, mask, noise, t, drop


# ------------------------------------------------------------------ losses


@pytest.mark.parametrize("gamma", [1.0, 5.0])
@pytest.mark.parametrize("prediction_type", ["epsilon", "v_prediction"])
def test_min_snr_weight_matches_jax(gamma, prediction_type):
    t = np.asarray([0, 1, 30, 249, 250, 600, 999], np.int32)
    jd = JaxIDDPM(timestep_respacing=[1000])
    td = IDDPM(timestep_respacing=[1000])
    np.testing.assert_allclose(td.compute_snr(torch.from_numpy(t)).numpy(),
                               np.asarray(jd.compute_snr(jnp.asarray(t))), rtol=1e-5)
    np.testing.assert_allclose(
        td.min_snr_weight(torch.from_numpy(t), gamma, prediction_type).numpy(),
        np.asarray(jd.min_snr_weight(jnp.asarray(t), gamma, prediction_type)), rtol=1e-5)


@pytest.mark.parametrize("snr,masked,mask_loss_coef,weighted", [
    (True, False, 0.0, False),    # the SNR-switching objective
    (False, True, 0.0, False),    # masked per-patch MSE over the kept patches
    (False, True, 1.0, True),     # ... with the removed-patch "mae" term and both weights
    (True, True, 0.5, True),
])
def test_training_losses_options_match_jax(snr, masked, mask_loss_coef, weighted):
    x0, _, _, noise, t, _ = _batch()
    token_mask = (np.random.RandomState(3).rand(2, 64) < 0.25).astype(np.float32)
    token_mask[:, 0] = 1.0  # at least one removed and one kept patch per sample
    token_mask[:, 1] = 0.0

    def fn(lib, mask):
        def f(x, tt):
            out = lib.concatenate([0.5 * x + 0.01 * tt.reshape(-1, 1, 1, 1), lib.tanh(x)], -1)
            return (out, mask) if masked else out
        return f

    mse_w = np.asarray([0.7, 1.3], np.float32) if weighted else None
    loss_w = np.asarray([2.0, 0.5], np.float32) if weighted else None
    jd = JaxIDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True,
                  snr=snr)
    opt = lambda a, lib: None if a is None else lib(a)
    want = jd.training_losses(fn(jnp, jnp.asarray(token_mask)), jnp.asarray(x0), jnp.asarray(t),
                              noise=jnp.asarray(noise), mse_weight=opt(mse_w, jnp.asarray),
                              loss_weight=opt(loss_w, jnp.asarray),
                              mask_loss_coef=mask_loss_coef, patch_size=2)
    td = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True, snr=snr)
    tlib = types.SimpleNamespace(concatenate=torch.cat, tanh=torch.tanh)
    got = td.training_losses(fn(tlib, torch.from_numpy(token_mask)), torch.from_numpy(x0),
                             torch.from_numpy(t).long(), torch.from_numpy(noise),
                             mse_weight=opt(mse_w, torch.from_numpy),
                             loss_weight=opt(loss_w, torch.from_numpy),
                             mask_loss_coef=mask_loss_coef, patch_size=2)
    assert set(got) == set(want)
    for key in want:
        np.testing.assert_allclose(got[key].numpy(), np.asarray(want[key]), rtol=1e-5,
                                   atol=1e-6, err_msg=key)


# ------------------------------------------------------------- resampler


def test_resampler_matches_jax_with_duplicated_timesteps():
    """T = 5 timesteps, a ring of 3: batches with repeated t fill, warm and
    wrap the rings; the weights and the rings agree after each update."""
    rng = np.random.RandomState(0)
    js = JaxResampler.create(5, history_per_term=3)
    ts = LossSecondMomentResampler(5, history_per_term=3)
    batches = [[0, 0, 1, 2], [3, 4, 4, 4], [0, 1, 2, 3], [1, 1, 1, 1], [4, 2, 0, 3], [2, 2, 3, 0]]
    warmed = False
    for t in batches:
        t = np.asarray(t, np.int32)
        losses = rng.rand(4).astype(np.float32) + 0.1
        js = jax.jit(lambda s, a, b: s.update(a, b))(js, jnp.asarray(t), jnp.asarray(losses))
        ts.update(torch.from_numpy(t), torch.from_numpy(losses))
        np.testing.assert_array_equal(ts.history.numpy(), np.asarray(js.history))
        np.testing.assert_array_equal(ts.counts.numpy(), np.asarray(js.counts))
        np.testing.assert_allclose(ts.weights().numpy(), np.asarray(js.weights()), rtol=1e-5)
        warmed |= bool((ts.counts == 3).all())
    assert warmed and not np.allclose(np.asarray(js.weights()), 0.2)
    # the loss weights of a draw: 1 / (T p_t)
    t, w = ts.sample(64, torch.Generator().manual_seed(0))
    np.testing.assert_allclose(w.numpy(), 1.0 / (5 * np.asarray(js.weights())[t.numpy()]),
                               rtol=1e-5)


# ---------------------------------------------------------------- masking


@pytest.mark.parametrize("mask_type", ["random", "group", "fft", "laplacian"])
def test_get_mask_matches_jax(mask_type):
    B, p, ratio = 3, 2, 0.3
    img = np.random.RandomState(1).randn(B, 12, 16, 4).astype(np.float32)
    L = (12 // p) * (16 // p)
    key = jax.random.PRNGKey(7)
    strength = tstrength = None
    if mask_type in ("fft", "laplacian"):
        f = {"fft": "fft_strength", "laplacian": "laplacian_strength"}[mask_type]
        strength = getattr(jax_masking, f)(jnp.asarray(img), p)
        tstrength = getattr(masking, f)(torch.from_numpy(img), p)
        np.testing.assert_allclose(tstrength.numpy(), np.asarray(strength), rtol=1e-4, atol=1e-3)
        noise = np.array(jax.random.gumbel(key, (B, L)))
    else:
        noise = np.array(jax.random.uniform(key, (B, L)))
    want = jax_masking.get_mask(key, B, L, ratio, mask_type=mask_type, strength=strength)
    got = masking.get_mask(B, L, ratio, mask_type, strength=tstrength,
                           noise=torch.from_numpy(noise))
    for k in want:
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(want[k]), err_msg=k)
    x = np.random.RandomState(2).randn(B, L, 8).astype(np.float32)
    kept = jax_masking.mask_out_token(jnp.asarray(x), want["ids_keep"])
    tkept = masking.mask_out_token(torch.from_numpy(x), got["ids_keep"])
    np.testing.assert_array_equal(tkept.numpy(), np.asarray(kept))
    token = np.random.RandomState(3).randn(1, 1, 8).astype(np.float32)
    np.testing.assert_array_equal(
        masking.unmask_tokens(tkept, got["ids_restore"], torch.from_numpy(token)).numpy(),
        np.asarray(jax_masking.unmask_tokens(kept, want["ids_restore"], jnp.asarray(token))))


def test_masked_model_gradients_match_jax(monkeypatch):
    """A masked toy model (mask_ratio 0.25, no KV compression) from the same
    params, JAX's mask draw passed to the port, and the removed-patch loss."""
    jm, params, tm, cfg = _toy(TOY, mask_ratio=0.25, mask_type="random", scan_blocks=False)
    assert "mask_token" in params and tm.mask_token.shape == (1, 1, 144)
    x0, y, mask, noise, t, drop = _batch()
    key = jax.random.PRNGKey(11)
    orig = jax_masking.get_mask
    monkeypatch.setattr(jax_masking, "get_mask", lambda _rng, *a, **k: orig(key, *a, **k))
    mask_noise = np.array(jax.random.uniform(key, (2, 64)))
    jd = JaxIDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)

    def loss_fn(p):
        model_fn = lambda x_t, t_in: jm.apply(
            {"params": p}, x_t, t_in, jnp.asarray(y), jnp.asarray(mask), train=True,
            force_drop_ids=jnp.asarray(drop), rngs={"mask": jax.random.PRNGKey(0)})
        terms = jd.training_losses(model_fn, jnp.asarray(x0), jnp.asarray(t),
                                   noise=jnp.asarray(noise), mask_loss_coef=1.0, patch_size=2)
        return jnp.mean(terms["loss"])

    want_loss, want_grads = jax.jit(jax.value_and_grad(loss_fn))(params)
    td = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    batch = {"latents": torch.from_numpy(x0), "y": torch.from_numpy(y),
             "y_mask": torch.from_numpy(mask)}
    terms = compute_losses(tm, td, batch, torch.from_numpy(t).long(), torch.from_numpy(noise),
                           force_drop_ids=torch.from_numpy(drop),
                           mask_noise=torch.from_numpy(mask_noise), mask_loss_coef=1.0)
    assert "mae" in terms
    terms["loss"].backward()
    np.testing.assert_allclose(float(terms["loss"].detach()), float(want_loss), rtol=1e-5)
    want = state_dict_from_jax(want_grads, cfg)
    got = dict(tm.named_parameters())
    assert set(got) == set(want)
    worst = max((_rel_l2(got[k].grad.numpy(), want[k].numpy()), k) for k in want)
    assert worst[0] <= 3e-4, worst
    assert float(tm.mask_token.grad.abs().sum()) > 0


def test_masking_refuses_kv_compression():
    tm = PixArtMS_XL_2(device="cpu", train=True, **TOY_KV, mask_ratio=0.25)
    x0, y, mask, _, t, _ = _batch()
    with pytest.raises(ValueError, match="KV compression"):
        tm(torch.from_numpy(x0), torch.from_numpy(t), torch.from_numpy(y), train=True)


# ------------------------------------------------------------- optimizers


def test_jax_param_path_names_every_jax_leaf():
    """Scanned groups (blocks_scan_<g>, the KV-compressed layers apart) and
    unrolled blocks: the port's names map onto exactly the JAX tree's paths."""
    for scan in (True, False):
        _, params, tm, cfg = _toy(TOY_KV, scan_blocks=scan)
        want = {"/".join(str(getattr(k, "key", k)) for k in path)
                for path, _ in jax.tree_util.tree_leaves_with_path(params)}
        got = {jax_param_path(n, cfg) for n, _ in tm.named_parameters()}
        assert got == want


@pytest.mark.parametrize("name,kw,scan", [
    # CAME factors each leaf: the port the unrolled tree's (tests/test_torch_training.py)
    ("came", dict(betas=(0.9, 0.999, 0.9999), eps=(1e-30, 1e-16)), False),
    ("lion", dict(betas=(0.9, 0.99)), True),
    ("adamw", dict(eps=1e-10), True),
    # the scan-stacked tree of the shipped configs: two groups (layers 0-1,
    # and the KV-compressed 2-3), each leaf factored and clipped as one stack
    ("came", dict(betas=(0.9, 0.999, 0.9999), eps=(1e-30, 1e-16)), True),
])
def test_optimizers_with_no_weight_decay_match_jax(name, kw, scan):
    """Three steps with weight decay 0.1 behind a global-norm clip, with the
    biases, norms and embedding tables exempt (matched on the JAX path, in
    scan groups on the scanned tree); CAME on the scanned tree updates the
    stacks of `block_stacks`."""
    _, params, tm, cfg = _toy(TOY_KV, scan_blocks=scan)
    no_decay = ["bias", "norm", "y_embedding", "scale_shift_table"]
    skip = lambda path, p: any(s in "/".join(path) for s in no_decay)
    rng = np.random.RandomState(5)
    grads = [jax.tree_util.tree_map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32),
                                    params) for _ in range(3)]
    tx = jax_build_optimizer(name=name, learning_rate=1e-2, weight_decay=0.1, grad_clip_norm=1.0,
                             skip_decay_fn=skip, **kw)
    js = JaxTrainState.create(params=params, tx=tx, ema=False)
    named = list(tm.named_parameters())
    skipped = {n for n, _ in named if any(s in jax_param_path(n, cfg) for s in no_decay)}
    assert "blocks.3.attn.qkv.bias" in skipped and "blocks.3.attn.qkv.weight" not in skipped
    stacks = block_stacks([n for n, _ in named], cfg.block_groups()) if scan else None
    if scan:
        assert cfg.block_groups() == [(1, 2), (2, 2)] and len(stacks) == len(
            [n for n, _ in named if n.startswith(("blocks.0.", "blocks.2."))])
    opt = build_optimizer(named, name=name, lr=1e-2, weight_decay=0.1,
                          skip_decay=lambda n: n in skipped, stacks=stacks, **kw)
    state = TrainState(tm, opt, lambda step: 1e-2, ema=False)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for g in grads:
        js = apply(js, g)
        for n, tg in state_dict_from_jax(g, cfg).items():
            dict(named)[n].grad = tg.clone()
        state.apply_gradients(1.0)
    want = state_dict_from_jax(js.params, cfg)
    for n, p in named:
        np.testing.assert_allclose(p.detach().numpy(), want[n].numpy(), rtol=1e-5, atol=1e-6,
                                   err_msg=n)


def test_gradient_accumulation_matches_optax_multisteps():
    """k = 2 over 4 micro-steps: the running mean of the gradients, the clip
    on the average, CAME and the schedule once per 2, the EMA with its warmup
    on every micro-step."""
    _, params, tm, cfg = _toy(TOY_KV, scan_blocks=False)
    rng = np.random.RandomState(6)
    grads = [jax.tree_util.tree_map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32),
                                    params) for _ in range(4)]
    tx = jax_build_optimizer(name="came", learning_rate=jlr.constant_with_warmup(1e-3, 2),
                             grad_clip_norm=0.01, betas=(0.9, 0.999, 0.9999),
                             eps=(1e-30, 1e-16))
    tx = optax.MultiSteps(tx, every_k_schedule=2)
    js = JaxTrainState.create(params=params, tx=tx, ema=True, ema_rate=0.9999)
    named = list(tm.named_parameters())
    state = TrainState(tm, build_optimizer(named, name="came", lr=0.0),
                       tlr.constant_with_warmup(1e-3, 2), ema=True, ema_rate=0.9999,
                       accumulation_steps=2)
    apply = jax.jit(lambda s, g: s.apply_gradients(g))
    for i, g in enumerate(grads):
        js = apply(js, g)
        for n, tg in state_dict_from_jax(g, cfg).items():
            dict(named)[n].grad = tg.clone()
        state.apply_gradients(0.01)
        assert state.step == int(js.step) == i + 1 and state.opt_step == (i + 1) // 2
    for tree, got in ((js.params, dict(tm.named_parameters())), (js.ema_params, state.ema)):
        want = state_dict_from_jax(tree, cfg)
        for k, w in want.items():
            np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=1e-5, atol=1e-7,
                                       err_msg=k)


# ------------------------------------------------------------------- remat


@pytest.mark.parametrize("policy", sorted(REMAT_SAVED))
def test_remat_policies_give_the_gradients_of_nothing(policy, monkeypatch):
    """Every policy with checkpointing gives the gradients of no
    checkpointing, through the kernels' autograd Functions (their plain
    versions on the CPU). The forward launches counted: "nothing", "dots" and
    "dots_no_batch" recompute each block's attention, "save_attn" and
    "everything" do not; the cross-attention backward always recomputes its
    lse through onepass."""
    x0, y, mask, noise, t, drop = _batch()
    batch = {"latents": torch.from_numpy(x0), "y": torch.from_numpy(y),
             "y_mask": torch.from_numpy(mask)}
    td = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    calls = {"onepass": 0, "allheads": 0}
    for name, fn in (("onepass", fa._onepass_forward), ("allheads", fa._allheads_forward)):
        def counted(*a, _fn=fn, _name=name, **k):
            calls[_name] += 1
            return _fn(*a, **k)
        monkeypatch.setattr(fa, f"_{name}_forward", counted)

    def grads(checkpointing, remat_policy):
        torch.manual_seed(0)
        tm = PixArtMS_XL_2(device="cpu", train=True, **TOY_KV, grad_checkpointing=checkpointing,
                           remat_policy=remat_policy)
        with torch.no_grad():
            for p in tm.parameters():
                p.add_(0.05 * torch.randn_like(p))
        for block in tm.blocks:
            block.attn.attn_impl, block.cross_attn.attn_impl = "onepass", "allheads"
        calls.update(onepass=0, allheads=0)
        compute_losses(tm, td, batch, torch.from_numpy(t).long(), torch.from_numpy(noise),
                       force_drop_ids=torch.from_numpy(drop))["loss"].backward()
        return {n: p.grad for n, p in tm.named_parameters()}, dict(calls)

    want, _ = grads(False, "nothing")
    got, launched = grads(True, policy)
    for n in want:
        torch.testing.assert_close(got[n], want[n], rtol=0, atol=0, msg=n)
    depth = TOY_KV["depth"]
    recomputed = policy in ("nothing", "dots", "dots_no_batch")
    assert launched == {"onepass": (3 if recomputed else 2) * depth,
                        "allheads": (2 if recomputed else 1) * depth}


def test_unknown_remat_policy_raises():
    with pytest.raises(ValueError, match="remat_policy"):
        PixArtMS_XL_2(device="cpu", **TOY, remat_policy="dots_with_no_batch_dims")


def test_train_step_refuses_t_beside_a_schedule_sampler():
    """With a sampler t is drawn by the sampler, so a given t is refused."""
    sampler = LossSecondMomentResampler(num_timesteps=10, device="cpu")
    with pytest.raises(ValueError, match="schedule sampler"):
        train_step(None, IDDPM(timestep_respacing=""), {"latents": torch.zeros(2, 4, 4, 4)},
                   t=torch.zeros(2, dtype=torch.long), schedule_sampler=sampler)


# ------------------------------------------------------------------ trainer


def test_log_validation_matches_jax(tmp_path):
    """The EMA weights, 14 DPM-Solver++ steps of order 2 with CFG 4.5 against
    the learned null caption, the same noise: the JAX trainer's
    log_validation (run on a stand-in of its Trainer) and the port's."""
    write_feature_dataset(str(tmp_path / "data"), [(256, 256)] * 2, resolution=256,
                          caption_channels=32)
    cfg = _features_config(str(tmp_path), mixed_precision="fp32", cfg_scale=4.5,
                           deterministic_validation=True)
    trainer = Trainer(cfg, str(tmp_path / "work"), device="cpu")
    trainer.build_state(10)
    mcfg = trainer.model.cfg
    jcfg = JaxConfig(**{f.name: getattr(mcfg, f.name) for f in dataclasses.fields(mcfg)
                        if f.name != "dtype"}, dtype=jnp.float32)
    jm = JaxPixArt(jcfg)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 32, 32, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 300, 32)), jnp.ones((1, 300), jnp.int32))["params"]
    ema = _perturb(params, 2)
    for n, v in state_dict_from_jax(ema, mcfg).items():
        trainer.state.ema[n].copy_(v)
    batch = trainer.prepare_batch(next(iter(trainer.build_loader())))
    latents = np.asarray(batch["latents"])
    noise = np.array(jax.random.normal(jax.random.PRNGKey(cfg.seed), latents.shape))
    got = trainer.log_validation(5, batch, noise=torch.from_numpy(noise))
    assert os.path.exists(tmp_path / "work" / "validation_step_5.npy")

    jdir = tmp_path / "jax"
    jdir.mkdir()
    fake = types.SimpleNamespace(
        config=cfg, model=jm, mesh=build_mesh(devices=jax.devices()[:1]),
        state=types.SimpleNamespace(ema_params=ema, params=params), vae=None,
        work_dir=str(jdir), logger=trainer.logger, tracker=None)
    JaxTrainer.log_validation(fake, 5, {k: jnp.asarray(np.asarray(v)) for k, v in batch.items()})
    want = np.load(jdir / "validation_step_5.npy")
    assert got.shape == want.shape == (2, 32, 32, 4)
    assert _rel_l2(got, want) <= 1e-3, _rel_l2(got, want)


def test_balanced_sampler_matches_jax(tmp_path):
    write_feature_dataset(str(tmp_path), [(256, 256)] * 7 + [(272, 240)] * 3 + [(192, 336)] * 2,
                          resolution=256, caption_channels=8, max_length=4, valid_tokens=(1, 3))
    from pixart_sigma_tpu.data.datasets import PixArtMSDataset as JaxDataset
    from pixart_sigma_tpu_torch.data.datasets import PixArtMSDataset

    common = dict(resolution=256, load_vae_feat=True, load_t5_feat=True, max_length=4,
                  aspect_ratio_type=256)
    table = aspect_ratio_table(256)
    for epoch in range(3):
        got = BalancedAspectRatioBatchSampler(PixArtMSDataset(str(tmp_path), **common), 2, table,
                                              seed=3)
        want = JaxBalancedSampler(JaxDataset(str(tmp_path), **common), 2, table, seed=3)
        got.set_epoch(epoch)
        want.set_epoch(epoch)
        batches = list(got)
        assert batches == list(want)
        assert any(min(b) >= 10 for b in batches)  # the rare bucket takes its turn


def test_logging_and_nan_report():
    buf = LogBuffer()
    buf.update({"loss": 1.0})
    buf.update({"loss": 3.0})
    buf.average()
    assert buf.output == {"loss": 2.0}
    with pytest.raises(ValueError, match="wandb"):
        Tracker("/nonexistent", "wandb")
    tm = PixArtMS_XL_2(device="cpu", **TOY, dtype=torch.float32)
    with torch.no_grad():
        tm.blocks[2].mlp.fc1.weight[0, 0] = float("nan")
    assert find_nonfinite(dict(tm.named_parameters())) == ["blocks.2.mlp.fc1.weight"]
    x0, y, mask, _, t, _ = _batch()
    bad = first_bad_module(tm, lambda: tm(torch.from_numpy(x0), torch.from_numpy(t),
                                          torch.from_numpy(y), torch.from_numpy(mask)))
    assert bad["module"] == "blocks.2.mlp.fc1" and bad["layer"] == 2 and bad["nonfinite"]


def test_masked_toy_config_trains_two_steps(tmp_path):
    """configs/toy/pixart_toy_img128_masked.py (mask_ratio 0.25, the
    removed-patch loss with coefficient 1) cut to depth 2 and batch 2."""
    cfg = read_config(MASKED_TOY)
    write_feature_dataset(str(tmp_path / "data"), [(128, 128)] * 4, resolution=128,
                          multi_scale=False, caption_channels=64, max_length=12)
    cfg.update(data_root=str(tmp_path), train_batch_size=2, num_workers=2, log_interval=1,
               save_model_epochs=10**6, model_overrides=dict(cfg.model_overrides, depth=2))
    cfg.data = dict(cfg.data, root="data")
    trainer = Trainer(cfg, str(tmp_path / "work"), device="cpu")
    assert trainer.model.cfg.mask_ratio == 0.25 and hasattr(trainer.model, "mask_token")
    state = trainer.train(max_steps=2)
    assert state.step == 2
    assert all(np.isfinite(h["loss"]) and h["mae"] > 0 for h in trainer.history)
