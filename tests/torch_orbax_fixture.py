"""Write tests/fixtures/orbax_small/: an orbax checkpoint of the JAX trainer
at a small size, and what the port must read from it.

    JAX_PLATFORMS=cpu python tests/torch_orbax_fixture.py

The model is `tests/fixtures/orbax_small/config.py`'s, built by the JAX
package from that config, its params perturbed (a fresh PixArt's zero-init
projections would hide most weights from its output). Its TrainState takes
CAME behind the config's global-norm clip and the EMA, and two JAX train
steps (`make_train_step`) on a seeded batch, so the moments and factored
statistics are not zero; the JAX package's `save_train_state` writes
`checkpoints/step_2/`. Beside it, `expected.json` holds every leaf of the
checkpoint as orbax reads it back (key path, shape, dtype, SHA-256 of its
C-order bytes), a seeded input and the JAX model's f32 output on it with
the saved params. Re-run only when the format changes: the committed bytes
are what the tests and `chip_smoke.py` read. Needs JAX, orbax and the JAX
package; the port is not imported.
"""

import hashlib
import json
import os
import shutil
import sys

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, ROOT)
os.environ.setdefault("JAX_PLATFORMS", "cpu")

import jax  # noqa: E402
import jax.numpy as jnp  # noqa: E402
import numpy as np  # noqa: E402

from pixart_sigma_tpu.config import read_config  # noqa: E402
from pixart_sigma_tpu.diffusion import IDDPM  # noqa: E402
from pixart_sigma_tpu.models.builder import build_model_from_config  # noqa: E402
from pixart_sigma_tpu.training import TrainState, build_lr_schedule, build_optimizer  # noqa: E402
from pixart_sigma_tpu.training import make_train_step  # noqa: E402
from pixart_sigma_tpu.utils.checkpoint import save_train_state  # noqa: E402

FIXTURE = os.path.join(ROOT, "tests", "fixtures", "orbax_small")
CONFIG = os.path.join(FIXTURE, "config.py")
STEPS = 2
LATENT = 8  # an 8x8x4 latent: 16 tokens at patch 2


def inputs(config):
    """The seeded forward input of expected.json: x [1, 8, 8, 4], t [1],
    y [1, L, C], a caption mask of 5 valid tokens."""
    rng = np.random.RandomState(0)
    length, channels = config.model_max_length, config.model_overrides["caption_channels"]
    return dict(x=rng.randn(1, LATENT, LATENT, 4).astype(np.float32),
                t=np.asarray([500.0], np.float32),
                y=rng.randn(1, length, channels).astype(np.float32),
                mask=(np.arange(length)[None] < 5).astype(np.int32))


def main():
    config = read_config(CONFIG)
    model = build_model_from_config(config)
    inp = inputs(config)
    params = jax.jit(model.init)(jax.random.PRNGKey(0), jnp.asarray(inp["x"]),
                                 jnp.asarray(inp["t"]), jnp.asarray(inp["y"]),
                                 jnp.asarray(inp["mask"]))["params"]
    rng = np.random.RandomState(1)
    params = jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape), jnp.float32), params)
    schedule = build_lr_schedule(config.lr_schedule, config.optimizer["lr"],
                                 num_training_steps=100, **config.lr_schedule_args)
    opt = dict(config.optimizer)
    tx = build_optimizer(name=opt.pop("type"), learning_rate=schedule,
                         grad_clip_norm=config.gradient_clip, **{k: opt[k] for k in (
                             "weight_decay", "betas", "eps")})
    state = TrainState.create(params=params, tx=tx, ema=True, ema_rate=config.ema_rate)
    diffusion = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    step = make_train_step(model, diffusion, donate=False)
    batch_rng = np.random.RandomState(2)
    batch = dict(
        latents=jnp.asarray(batch_rng.randn(2, LATENT, LATENT, 4).astype(np.float32)),
        y=jnp.asarray(batch_rng.randn(2, config.model_max_length, 32).astype(np.float32)),
        y_mask=jnp.ones((2, config.model_max_length), jnp.int32))
    for i in range(STEPS):
        state, _ = step(state, batch, jax.random.PRNGKey(10 + i))
    ckpt_dir = os.path.join(FIXTURE, "checkpoints")
    shutil.rmtree(ckpt_dir, ignore_errors=True)
    path = save_train_state(ckpt_dir, state)

    import orbax.checkpoint as ocp

    restored = ocp.PyTreeCheckpointer().restore(path)
    leaves = []
    for key_path, leaf in jax.tree_util.tree_leaves_with_path(restored):
        arr = np.ascontiguousarray(np.asarray(leaf))
        leaves.append(dict(
            path=[str(getattr(k, "key", getattr(k, "idx", k))) for k in key_path],
            shape=list(arr.shape), dtype=str(arr.dtype),
            sha256=hashlib.sha256(arr.tobytes()).hexdigest()))
    out = model.apply({"params": state.params}, *(jnp.asarray(inp[k])
                                                  for k in ("x", "t", "y", "mask")))
    expected = dict(step=int(state.step), leaves=leaves,
                    inputs={k: v.tolist() for k, v in inp.items()},
                    output=np.asarray(out, np.float32).tolist())
    with open(os.path.join(FIXTURE, "expected.json"), "w") as f:
        json.dump(expected, f, indent=0)
    size = sum(os.path.getsize(os.path.join(d, n)) for d, _, ns in os.walk(FIXTURE) for n in ns)
    print(f"{path}: {len(leaves)} leaves, fixture {size} bytes")


if __name__ == "__main__":
    main()
