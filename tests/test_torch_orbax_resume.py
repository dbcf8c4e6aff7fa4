"""Resuming the port's Trainer from the JAX trainer's orbax checkpoints, and
the entry points that take them, on the CPU.

Resume: a JAX TrainState of the fixture's model
(`tests/fixtures/orbax_small/config.py`) is saved with `save_train_state`
(the committed fixture at step 2, or a save made here after three steps of
seeded gradients) and JAX's `restore_train_state` reads it back; JAX then
takes two more steps. The port's Trainer, with `resume_from="latest"` in a
work dir that holds only that `checkpoints/step_N`, must return N from
`maybe_resume`, and two `apply_gradients` on the same gradients must give
JAX's params and EMA at f32 (rtol 1e-5, atol 1e-6: the limits of
`tests/test_torch_training.py`'s CAME and AdamW checks, which run the same
arithmetic from a fresh state). Three chains: CAME behind the global-norm
clip (the committed fixture's), AdamW behind it, and CAME inside
`optax.MultiSteps(k=2)`, saved with its accumulator half full.

Entry points: `scripts.inference` and `scripts.serve`'s `build_pipeline`
take `--model-path` a `step_N`, `tools.generate_dmd_data` a run directory,
`scripts.train` a `--load-from` and a `--resume-from`.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import json
import os
import shutil

import jax
import jax.numpy as jnp
import numpy as np
import optax
import pytest
import torch

from pixart_sigma_tpu.config import read_config as jax_read_config
from pixart_sigma_tpu.models.builder import build_model_from_config as jax_build_model
from pixart_sigma_tpu.training import TrainState as JaxTrainState
from pixart_sigma_tpu.training import build_lr_schedule as jax_lr_schedule
from pixart_sigma_tpu.training import build_optimizer as jax_build_optimizer
from pixart_sigma_tpu.utils import checkpoint as jckpt
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
from pixart_sigma_tpu_torch.scripts import inference, serve
from pixart_sigma_tpu_torch.scripts import train as train_cli
from pixart_sigma_tpu_torch.tools import generate_dmd_data
from pixart_sigma_tpu_torch.training.trainer import Trainer
from pixart_sigma_tpu_torch.utils.checkpoint import latest_checkpoint, state_dict_from_jax

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
FIXTURE = os.path.join(ROOT, "tests", "fixtures", "orbax_small")
FIXTURE_CONFIG = os.path.join(FIXTURE, "config.py")
TOTAL_STEPS = 100


@pytest.fixture(scope="module")
def jax_setup():
    """(JAX model, perturbed params, five seeded gradient trees)."""
    jm = jax_build_model(jax_read_config(FIXTURE_CONFIG))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.zeros((1, 8, 8, 4)), jnp.zeros((1,)),
                              jnp.zeros((1, 8, 32)), jnp.ones((1, 8), jnp.int32))["params"]
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape), jnp.float32), params)
    grads = [jax.tree_util.tree_map(lambda a: jnp.asarray(rng.randn(*a.shape), jnp.float32),
                                    params) for _ in range(5)]
    return jm, params, grads


def _config(name, accumulation):
    config = read_config(FIXTURE_CONFIG)
    if name == "adamw":
        config.optimizer = dict(type="adamw", lr=1e-3, weight_decay=3e-2, eps=1e-10)
    config.gradient_accumulation_steps = accumulation
    config.resume_from = dict(checkpoint="latest")
    return config


def _jax_tx(config):
    schedule = jax_lr_schedule(config.lr_schedule, config.optimizer["lr"],
                               num_training_steps=TOTAL_STEPS, **config.lr_schedule_args)
    opt = dict(config.optimizer)
    tx = jax_build_optimizer(name=opt.pop("type"), learning_rate=schedule,
                             grad_clip_norm=config.gradient_clip, **{k: v for k, v in opt.items()
                                                                     if k != "lr"})
    k = config.gradient_accumulation_steps
    return optax.MultiSteps(tx, every_k_schedule=k) if k > 1 else tx


@pytest.mark.parametrize("name,accumulation", [("came", 1), ("adamw", 1), ("came", 2)])
def test_resume_from_a_jax_step_matches_jax_restore(jax_setup, tmp_path, name, accumulation):
    """CAME behind the clip resumes from the committed fixture (saved at step
    2 after two JAX train steps); AdamW and MultiSteps from a save made here
    after three steps of seeded gradients."""
    jm, params, grads = jax_setup
    config = _config(name, accumulation)
    tx = _jax_tx(config)
    create = lambda p: JaxTrainState.create(params=p, tx=tx, ema=True, ema_rate=config.ema_rate)
    compiled = []

    def apply(s, g):  # compiled once, by XLA's cheapest pass: a handful of small ops
        if not compiled:
            compiled.append(jax.jit(lambda s, g: s.apply_gradients(g)).lower(s, g).compile(
                compiler_options={"xla_backend_optimization_level": 0}))
        return compiled[0](s, g)

    work = tmp_path / "work"
    if (name, accumulation) == ("came", 1):
        shutil.copytree(os.path.join(FIXTURE, "checkpoints"), work / "checkpoints")
        path = str(work / "checkpoints" / "step_2")
        state = jckpt.restore_train_state(path, jax.eval_shape(create, params))
    else:
        state = jax.jit(create)(params)
        for g in grads[:3]:
            state = apply(state, g)
        path = jckpt.save_train_state(str(work / "checkpoints"), state)
        restored = jckpt.restore_train_state(path, state)
        for a, b in zip(jax.tree_util.tree_leaves(restored), jax.tree_util.tree_leaves(state)):
            assert np.array_equal(np.asarray(a), np.asarray(b))  # so the steps go on from state
    if accumulation > 1:
        assert int(state.opt_state.mini_step) == 1  # the accumulator is half full
    step = int(state.step)
    for g in grads[3:]:
        state = apply(state, g)

    assert latest_checkpoint(str(work / "checkpoints")) == path
    trainer = Trainer(config, str(work), device="cpu")
    trainer.build_state(TOTAL_STEPS)
    assert trainer.maybe_resume() == step
    named = dict(trainer.model.named_parameters())
    cfg = trainer.model.cfg
    for g in grads[3:]:
        for n, t in state_dict_from_jax(g, cfg).items():
            named[n].grad = t.clone()
        trainer.state.apply_gradients(grad_clip=config.gradient_clip)
    assert trainer.state.step == int(state.step) == step + 2
    for tree, got in ((state.params, named), (state.ema_params, trainer.state.ema)):
        for k, w in state_dict_from_jax(tree, cfg).items():
            np.testing.assert_allclose(got[k].detach().numpy(), w.numpy(), rtol=1e-5, atol=1e-6,
                                       err_msg=k)


def test_resume_options_and_a_chain_that_does_not_match(tmp_path):
    """From the committed fixture (CAME behind the clip, step 2): the weights
    from the EMA with `load_ema`, the schedule from 0 without
    `resume_lr_scheduler`, the generator seeded from (seed, step); a
    config whose optimizer is Lion names the key paths it found."""
    work = tmp_path / "work"
    shutil.copytree(os.path.join(FIXTURE, "checkpoints"), work / "checkpoints")
    config = _config("came", 1)
    config.resume_from = dict(checkpoint="latest", load_ema=True, resume_lr_scheduler=False)
    trainer = Trainer(config, str(work), device="cpu")
    trainer.build_state(TOTAL_STEPS)
    assert trainer.maybe_resume() == 2
    assert trainer.state.opt_step == 0
    ema = trainer.state.ema
    assert all(torch.equal(p, ema[n]) for n, p in trainer.model.named_parameters())
    seed = np.random.SeedSequence([config.seed, 2]).generate_state(1)[0]
    assert torch.equal(trainer.generator.get_state(),
                       torch.Generator().manual_seed(int(seed)).get_state())
    config = _config("came", 1)
    config.optimizer = dict(type="lion", lr=1e-4, weight_decay=0.0)
    trainer = Trainer(config, str(work), device="cpu")
    trainer.build_state(TOTAL_STEPS)
    with pytest.raises(ValueError, match="exp_avg"):
        trainer.maybe_resume()


def _fixture_step():
    return os.path.join(FIXTURE, "checkpoints", "step_2")


def _serve_args(*extra):
    return serve.parse_args(["--config", FIXTURE_CONFIG, "--model-path", _fixture_step(),
                             "--pseudo-t5", "32", "--device", "cpu", *extra])


def test_inference_and_serve_take_a_step_dir(tmp_path):
    with open(os.path.join(FIXTURE, "expected.json")) as f:
        expected = json.load(f)
    pipe, _, _, _ = serve.build_pipeline(_serve_args())
    inp = {k: torch.tensor(v) for k, v in expected["inputs"].items()}
    with torch.no_grad():
        out = pipe.model(inp["x"], inp["t"], inp["y"], inp["mask"]).numpy()
    want = np.asarray(expected["output"])
    assert np.linalg.norm(out - want) / np.linalg.norm(want) <= 1e-5
    prompts = tmp_path / "p.txt"
    prompts.write_text("a cat\n")
    inference.main(["--config", FIXTURE_CONFIG, "--model-path", _fixture_step(), "--txt-file",
                    str(prompts), "--pseudo-t5", "32", "--image-size", "256", "--steps", "2",
                    "--save-root", str(tmp_path / "out"), "--device", "cpu"])
    saved = [f for _, _, fs in os.walk(tmp_path / "out") for f in fs]
    assert saved and all(f.endswith(".npy") for f in saved)
    latents = np.load(next(os.path.join(d, f) for d, _, fs in os.walk(tmp_path / "out")
                           for f in fs))
    assert latents.shape == (32, 32, 4) and np.isfinite(latents).all()


def test_dmd_data_and_the_training_cli_take_orbax_directories(tmp_path):
    """`tools.generate_dmd_data --model-path` a run directory; `scripts.train`
    with `--load-from` the run directory and, in another run, `--resume-from`
    its `step_2` (one step each on synthetic features)."""
    root = tmp_path / "InternData"
    root.mkdir()
    meta = [{"path": f"part0/{i:06d}.png", "prompt": p, "ratio": 1.0}
            for i, p in enumerate(["a red circle", "a cat"])]
    (root / "data_info.json").write_text(json.dumps(meta))
    generate_dmd_data.main(["--data-root", str(root), "--config", FIXTURE_CONFIG, "--model-path",
                            FIXTURE, "--pseudo-t5", "32", "--steps", "2", "--batch", "2",
                            "--device", "cpu"])
    latents = [np.load(root / "base_latents" / f"{i:06d}.npy") for i in range(2)]
    assert all(a.shape == (32, 32, 4) and np.isfinite(a).all() for a in latents)

    data = tmp_path / "features"
    write_feature_dataset(str(data / read_config(FIXTURE_CONFIG).data["root"]),
                          [(256, 256)] * 4, resolution=256, caption_channels=32, max_length=8,
                          valid_tokens=(3, 8))
    common = [FIXTURE_CONFIG, "--data-root", str(data), "--features", "--debug", "--max-steps",
              "1", "--device", "cpu"]
    loaded = train_cli.main(common + ["--work-dir", str(tmp_path / "a"), "--load-from", FIXTURE])
    resumed = train_cli.main(common + ["--work-dir", str(tmp_path / "b"), "--resume-from",
                                       _fixture_step()])
    assert loaded.state.step == 1 and resumed.state.step == 3
    assert np.isfinite(loaded.history[0]["loss"]) and np.isfinite(resumed.history[0]["loss"])
