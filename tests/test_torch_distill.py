"""LCM and DMD distillation of the port against the JAX package, on the CPU
(f32).

- `TrainState.apply_gradients(ema_rate=)` bypasses the EMA warmup ramp as
  JAX's does, over the first steps, where the ramp differs most;
- one LCM step (huber and l2) against `make_lcm_train_step` with JAX's
  DDIM index and noise, three different networks (student, teacher, EMA
  target): loss within 1e-5 relative, student and target within 1e-4
  relative L2 per parameter after the step;
- one DMD generator step and one fake-score step against
  `make_dmd_train_steps` with JAX's t and noise: `dm_loss`, `sg_loss` within
  1e-5 relative, both networks within 1e-4; `one_step_generate` within 1e-6;
- `DMDDataset` reads what `tools.generate_dmd_data` writes (the toy config,
  `--pseudo-t5`, a padded last batch) item for item as JAX's `DMDDataset`;
- `scripts.train_pixart_lcm` and `scripts.train_pixart_dmd` run two steps.

The steps update by SGD, so the parameters hold the gradients: the first
step of Adam moves every parameter by about the learning rate whatever its
gradient's size, and the key bias, whose true gradient is zero (softmax is
shift-invariant), would move by the sign of rounding noise.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import json
import os

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixart_sigma_tpu.data.dmd_dataset import DMDDataset as JaxDMDDataset
from pixart_sigma_tpu.diffusion import IDDPM as JaxIDDPM
from pixart_sigma_tpu.training import dmd as jdmd
from pixart_sigma_tpu.training import lcm_trainer as jlcm
from pixart_sigma_tpu.training.train_state import TrainState as JaxTrainState
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.dmd_dataset import DMDDataset
from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.models.pixart import init_weights
from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
from pixart_sigma_tpu_torch.scripts import train_pixart_dmd, train_pixart_lcm
from pixart_sigma_tpu_torch.tools import generate_dmd_data
from pixart_sigma_tpu_torch.training import dmd, lcm_trainer
from pixart_sigma_tpu_torch.training.train_state import TrainState
from pixart_sigma_tpu_torch.utils.checkpoint import save_pth, state_dict_from_jax
from tests.test_torch_lora import _perturb, _rel_l2, _toy

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = os.path.join(ROOT, "configs/toy/pixart_toy_img128.py")
TOY_LCM = os.path.join(ROOT, "configs/toy/pixart_toy_img128_lcm.py")
LR = 0.1


def test_explicit_ema_rate_bypasses_the_warmup_as_jax():
    lin = torch.nn.Linear(3, 2)
    params = {"w": jnp.asarray(lin.weight.detach().numpy().T), "b": jnp.asarray(
        lin.bias.detach().numpy())}
    jstate = JaxTrainState.create(params=params, tx=optax.sgd(0.1), ema=True)
    state = TrainState(lin, torch.optim.SGD(lin.parameters(), lr=0.1), lambda s: 0.1, ema=True)
    rng = np.random.RandomState(0)
    for step in range(3):
        g = rng.randn(2, 3).astype(np.float32), rng.randn(2).astype(np.float32)
        jstate = jstate.apply_gradients({"w": jnp.asarray(g[0].T), "b": jnp.asarray(g[1])},
                                        ema_rate=0.95)
        lin.weight.grad, lin.bias.grad = torch.from_numpy(g[0]), torch.from_numpy(g[1])
        state.apply_gradients(ema_rate=0.95)
        np.testing.assert_allclose(state.ema["weight"].numpy(),
                                   np.asarray(jstate.ema_params["w"]).T, rtol=1e-6, atol=1e-7)
        np.testing.assert_allclose(state.ema["bias"].numpy(), np.asarray(jstate.ema_params["b"]),
                                   rtol=1e-6, atol=1e-7)
    # the warmup ramp would have given (1 + 0) / (10 + 0) = 0.1 at the first step
    assert state.step == 3 and float(jstate.step) == 3


def _batch(B=2, seed=6):
    rng = np.random.RandomState(seed)
    return {"latents": rng.randn(B, 16, 16, 4).astype(np.float32),
            "y": rng.randn(B, 8, 24).astype(np.float32),
            "y_mask": (np.arange(8)[None] < np.asarray([[8], [3]])).astype(np.int32)}


def _port_copy(tm, cfg, params):
    """Another port model of tm's architecture holding JAX `params`."""
    other = build_like(tm)
    other.load_state_dict(state_dict_from_jax(params, cfg))
    return other


def build_like(tm):
    import dataclasses

    from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2

    return PixArtMS_XL_2(device="cpu", train=True, **{
        f.name: getattr(tm.cfg, f.name) for f in dataclasses.fields(tm.cfg)})


@pytest.mark.parametrize("loss_type", ["huber", "l2"])
def test_lcm_step_matches_jax(loss_type):
    jm, params, student, cfg = _toy(grad_checkpointing=loss_type == "l2")
    student.requires_grad_(True)
    teacher_p, target_p = _perturb(params, 2), _perturb(params, 3)
    teacher, target = _port_copy(student, cfg, teacher_p), _port_copy(student, cfg, target_p)
    kw = dict(num_ddim_timesteps=50, cfg_scale=4.5, loss_type=loss_type, huber_c=0.001,
              ema_decay=0.95)
    jdiff = JaxIDDPM(timestep_respacing=[1000], learn_sigma=True)
    diff = IDDPM(timestep_respacing=[1000], learn_sigma=True)
    tx = optax.sgd(LR)
    jstate = JaxTrainState.create(params=params, tx=tx, ema=True).replace(ema_params=target_p)
    batch = _batch()
    B = 2
    uncond = np.broadcast_to(np.asarray(params["y_embedder"]["y_embedding"])[None],
                             (B, 8, 24)).astype(np.float32)
    key = jax.random.PRNGKey(7)
    jstate, jmetrics = jlcm.make_lcm_train_step(jm, jdiff, **kw)(
        jstate, teacher_p, jnp.asarray(uncond), {k: jnp.asarray(v) for k, v in batch.items()}, key)
    i_rng, n_rng = jax.random.split(jax.random.fold_in(key, 0), 2)
    index = torch.from_numpy(np.array(jax.random.randint(i_rng, (B,), 0, 50)))
    noise = torch.from_numpy(np.array(jax.random.normal(n_rng, (B, 16, 16, 4))))

    before = {n: p.detach().clone() for n, p in student.named_parameters()}
    state = TrainState(student, torch.optim.SGD(student.parameters(), lr=LR), lambda s: LR,
                       ema=True)
    state.ema = {n: p.detach().clone() for n, p in target.named_parameters()}
    metrics = lcm_trainer.make_lcm_train_step(cfg, diff, **kw)(
        state, teacher, torch.from_numpy(uncond), {k: torch.from_numpy(v) for k, v in batch.items()},
        index=index, noise=noise)
    assert abs(metrics["loss"] - float(jmetrics["loss"])) <= 1e-5 * abs(float(jmetrics["loss"]))
    for name, want in (("student", jstate.params), ("target", jstate.ema_params)):
        got = (dict(student.named_parameters()) if name == "student" else state.ema)
        for n, v in state_dict_from_jax(want, cfg).items():
            assert _rel_l2(got[n].detach(), v) <= 1e-4, (name, n, _rel_l2(got[n].detach(), v))
    assert not torch.equal(before["blocks.0.mlp.fc1.weight"], student.blocks[0].mlp.fc1.weight)


def test_dmd_steps_match_jax():
    jm, params, gen, cfg = _toy()
    gen.requires_grad_(True)
    real_p, fake_p = _perturb(params, 4), _perturb(params, 5)
    real, fake = _port_copy(gen, cfg, real_p), _port_copy(gen, cfg, fake_p)
    jdiff = JaxIDDPM(timestep_respacing=[1000], learn_sigma=True)
    diff = IDDPM(timestep_respacing=[1000], learn_sigma=True)
    gtx, ftx = optax.sgd(LR), optax.sgd(LR)
    jgen, jfake, jone = jdmd.make_dmd_train_steps(jm, jdiff, start_ts=400, cfg_scale=4.5,
                                                  generator_tx=gtx, fake_tx=ftx)
    rng = np.random.RandomState(8)
    B = 2
    b = _batch()
    batch = {"init_noise": rng.randn(B, 16, 16, 4).astype(np.float32), "y": b["y"],
             "y_mask": b["y_mask"], "uncond_y": rng.randn(B, 8, 24).astype(np.float32)}
    jbatch = {k: jnp.asarray(v) for k, v in batch.items()}
    tbatch = {k: torch.from_numpy(v) for k, v in batch.items()}
    gen_step, fake_step, one = dmd.make_dmd_train_steps(
        cfg, diff, start_ts=400, cfg_scale=4.5,
        generator_optimizer=torch.optim.SGD(gen.parameters(), lr=LR),
        fake_optimizer=torch.optim.SGD(fake.parameters(), lr=LR))

    with torch.no_grad():
        x0 = one(gen, tbatch["init_noise"], tbatch["y"], tbatch["y_mask"])
    want = jone(params, jbatch["init_noise"], jbatch["y"], jbatch["y_mask"])
    assert _rel_l2(x0, want) <= 1e-6, _rel_l2(x0, want)

    def draws(key):
        noise_rng, t_rng = jax.random.split(key)
        return (torch.from_numpy(np.array(jax.random.randint(t_rng, (B,), 1, 400))),
                torch.from_numpy(np.array(jax.random.normal(noise_rng, (B, 16, 16, 4)))))

    k1, k2 = jax.random.PRNGKey(11), jax.random.PRNGKey(12)
    new_gen, _, jm1, jx0 = jgen(params, gtx.init(params), real_p, fake_p, jbatch, k1)
    new_fake, _, jm2 = jfake(fake_p, ftx.init(fake_p), jx0, jbatch, k2)
    t, noise = draws(k1)
    m1, x0 = gen_step(gen, real, fake, tbatch, t=t, noise=noise)
    t, noise = draws(k2)
    m2 = fake_step(fake, x0, tbatch, t=t, noise=noise)
    assert _rel_l2(x0, jx0) <= 1e-6
    for got, want in ((m1["dm_loss"], jm1["dm_loss"]), (m2["sg_loss"], jm2["sg_loss"])):
        assert abs(got - float(want)) <= 1e-5 * abs(float(want)), (got, float(want))
    for model, want in ((gen, new_gen), (fake, new_fake)):
        got = dict(model.named_parameters())
        for n, v in state_dict_from_jax(want, cfg).items():
            assert _rel_l2(got[n].detach(), v) <= 1e-4, (n, _rel_l2(got[n].detach(), v))
    for n, p in real.named_parameters():
        assert p.grad is None, n


@pytest.fixture(scope="module")
def dmd_data(tmp_path_factory):
    """Three items with captions, a toy teacher cut to depth 2, and the
    triplets `tools.generate_dmd_data` writes for them."""
    d = tmp_path_factory.mktemp("dmd")
    config = d / "teacher.py"
    config.write_text(f"_base_ = [{TOY!r}]\n"
                      "model_overrides = dict(depth=2, hidden_size=64, num_heads=2, "
                      "caption_channels=64)\n")
    cfg = read_config(str(config))
    model = build_model_from_config(cfg, device="cpu", train=True)
    init_weights(model, torch.Generator().manual_seed(3))
    teacher = save_pth(str(d / "teacher.pth"), model.state_dict())
    root = d / "InternData"
    root.mkdir()
    prompts = ["a red circle", "two blue squares on grass", "a cat"]
    meta = [{"path": f"part0/{i:06d}.png", "prompt": p, "ratio": 1.0}
            for i, p in enumerate(prompts)]
    (root / "data_info.json").write_text(json.dumps(meta))
    (root / "caption_features").mkdir()
    y, mask = PseudoT5Embedder(64, 12).get_text_embeddings(prompts)
    for i in range(3):  # the training captions, as a T5 feature run writes them
        np.savez(str(root / "caption_features" / f"{i:06d}.npz"),
                 caption_feature=y[i:i + 1].numpy()[:, :mask[i].sum()],
                 attention_mask=mask[i:i + 1].numpy()[:, :mask[i].sum()])
    generate_dmd_data.main(["--data-root", str(root), "--config", str(config), "--model-path",
                            teacher, "--pseudo-t5", "64", "--steps", "2", "--batch", "2",
                            "--device", "cpu"])
    return dict(root=str(root), config=str(config), teacher=teacher)


def test_dmd_dataset_reads_what_the_generator_writes_as_jax(dmd_data):
    root = dmd_data["root"]
    assert sorted(os.listdir(os.path.join(root, "noise"))) == [f"{i:06d}.npy" for i in range(3)]
    got, want = DMDDataset(root, max_length=12), JaxDMDDataset(root, max_length=12)
    assert len(got) == len(want) == 3
    for i in range(3):
        a, b = got[i], want[i]
        assert sorted(a) == sorted(b)
        for k in a:
            if k == "prompt":
                assert a[k] == b[k]
            else:
                assert a[k].dtype == b[k].dtype and np.array_equal(a[k], b[k]), (i, k)
        assert a["init_noise"].shape == a["base_latent"].shape == (16, 16, 4)
        assert np.isfinite(a["base_latent"]).all() and not np.array_equal(
            a["base_latent"], a["init_noise"])
    assert got.get_data_info(0) == want.get_data_info(0)
    # an item's noise is the seeded draw of its index, whatever the batching
    np.testing.assert_array_equal(got[2]["init_noise"],
                                  generate_dmd_data.item_noise(0, 2, (16, 16, 4)))


def test_dmd_cli_runs_two_steps(dmd_data, tmp_path):
    out = train_pixart_dmd.main([
        "--data-root", dmd_data["root"], "--teacher", dmd_data["teacher"], "--config",
        dmd_data["config"], "--work-dir", str(tmp_path), "--batch-size", "2", "--max-steps", "2",
        "--save-steps", "2", "--log-interval", "1", "--device", "cpu"])
    assert len(out["history"]) == 2
    assert all(np.isfinite(h["dm_loss"]) and np.isfinite(h["sg_loss"]) for h in out["history"])
    assert os.path.exists(tmp_path / "dmd_step_2.pth")
    assert next(out["real"].parameters()).dtype == torch.bfloat16


def test_lcm_cli_runs_two_steps(tmp_path):
    write_feature_dataset(str(tmp_path / "InternData"), [(128, 128)] * 4, resolution=128,
                          multi_scale=False, caption_channels=64, max_length=12)
    config = tmp_path / "lcm.py"
    config.write_text(f"_base_ = [{TOY_LCM!r}]\n"
                      f"data_root = {str(tmp_path)!r}\nwork_dir = {str(tmp_path / 'work')!r}\n"
                      "train_batch_size = 2\nnum_workers = 2\nlog_interval = 1\n"
                      "save_model_steps = 2\n"
                      "model_overrides = dict(depth=2, hidden_size=64, num_heads=2, "
                      "caption_channels=64)\n")
    cfg = read_config(str(config))
    model = build_model_from_config(cfg, device="cpu", train=True)
    init_weights(model, torch.Generator().manual_seed(4))
    teacher = save_pth(str(tmp_path / "teacher.pth"), model.state_dict())
    out = train_pixart_lcm.main([str(config), "--teacher", teacher, "--max-steps", "2",
                                 "--device", "cpu"])
    assert out["state"].step == 2 and len(out["history"]) == 2
    assert all(np.isfinite(h["loss"]) for h in out["history"])
    assert os.path.exists(tmp_path / "work" / "checkpoints" / "step_2.pth")
    moved = [n for n, p in out["state"].model.named_parameters()
             if not torch.equal(p.detach(), model.state_dict()[n])]
    assert moved
