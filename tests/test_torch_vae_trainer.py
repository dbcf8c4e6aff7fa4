"""The VAE trainer and its files against the JAX package, on the CPU:

- `utils.flax_msgpack` reads what `flax.serialization.to_bytes` writes, bit
  for bit (f32, f16, int32 and 0-d arrays, a numpy scalar, maps past 15
  keys), writes the same bytes for the same tree, and refuses flax's
  chunked arrays;
- `models.vae.load_flax_vae` reads a directory the JAX package wrote, and
  the JAX package's `load_flax_vae` reads what `save_flax_vae` writes, the
  parameters bit for bit;
- `scripts.train_vae` (small preset, 32px, B = 2) against JAX's
  `scripts/train_vae.py` run for 2 steps from JAX's init with JAX's eps:
  the logged losses within 1e-5 relative, the written parameters within
  1e-4 relative L2 each (f32 Adam, the same batches), but the key biases,
  whose true gradient is 0 and which Adam moves by the sign of rounding
  noise (each within Adam's lr per step).
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import logging
import os
import runpy
import sys

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from flax import serialization

from pixart_sigma_tpu.models.vae import AutoencoderKL as JaxVAE
from pixart_sigma_tpu.models.vae import VAEConfig as JaxVAEConfig
from pixart_sigma_tpu.models.vae import load_flax_vae as jax_load_flax_vae
from pixart_sigma_tpu_torch.models.vae import (
    VAEConfig,
    build_vae,
    load_flax_vae,
    save_flax_vae,
)
from pixart_sigma_tpu_torch.scripts import train_vae
from pixart_sigma_tpu_torch.utils import flax_msgpack
from pixart_sigma_tpu_torch.utils.checkpoint import vae_state_dict_from_jax
from pixart_sigma_tpu_torch.utils.png import write_png
from tests.test_torch_lora import _rel_l2
from tests.test_torch_vae import _random_vae_params

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _leaves(tree):
    return dict(jax.tree_util.tree_leaves_with_path(tree))


def _assert_trees_equal(got, want):
    got, want = _leaves(got), _leaves(want)
    assert got.keys() == want.keys()
    for k, w in want.items():
        g = got[k]
        assert np.asarray(g).dtype == np.asarray(w).dtype, k
        np.testing.assert_array_equal(np.asarray(g), np.asarray(w))


def test_msgpack_reads_and_writes_flax_bytes():
    rng = np.random.RandomState(0)
    tree = {"params": {
        "conv": {"kernel": rng.randn(3, 3, 4, 8).astype(np.float32),
                 "bias": rng.randn(8).astype(np.float16)},
        "ids": np.arange(70000, dtype=np.int32).reshape(7, 10000),
        "zero_d": np.asarray(2.5, np.float32),
        "scalar": np.float32(-1.25),
        "wide": {f"key_{i:02d}": rng.randn(i + 1).astype(np.float32) for i in range(17)},
        "empty": np.zeros((0, 3), np.float32),
    }}
    data = serialization.to_bytes(tree)
    got = flax_msgpack.from_bytes(data)
    _assert_trees_equal(got, serialization.msgpack_restore(data))
    assert isinstance(got["params"]["scalar"], np.float32)
    assert flax_msgpack.to_bytes(tree) == data
    with pytest.raises(TypeError):
        flax_msgpack.to_bytes({"x": [1, 2]})


def test_msgpack_refuses_chunked_arrays(monkeypatch):
    """Chunked arrays were refused; they are now read and written as flax
    does (tests/test_torch_flax_msgpack.py holds both directions): a file
    with one reads back whole, and the writer chunks past MAX_CHUNK_SIZE."""
    monkeypatch.setattr(serialization, "MAX_CHUNK_SIZE", 64)
    w = np.arange(100, dtype=np.float32)
    data = serialization.to_bytes({"w": w})
    np.testing.assert_array_equal(flax_msgpack.from_bytes(data)["w"], w)
    monkeypatch.setattr(flax_msgpack, "MAX_CHUNK_SIZE", 64)
    assert flax_msgpack.to_bytes({"w": w}) == data


def _write_jax_dir(path, cfg, params):
    os.makedirs(path, exist_ok=True)
    with open(os.path.join(path, "vae_params.msgpack"), "wb") as f:
        f.write(serialization.to_bytes({"params": params}))
    import json

    with open(os.path.join(path, "vae_config.json"), "w") as f:
        json.dump(dict(in_channels=cfg.in_channels, latent_channels=cfg.latent_channels,
                       block_out_channels=list(cfg.block_out_channels),
                       layers_per_block=cfg.layers_per_block,
                       norm_num_groups=cfg.norm_num_groups,
                       scaling_factor=cfg.scaling_factor), f)


def test_flax_vae_directories_round_trip_with_jax(tmp_path, monkeypatch):
    jcfg = JaxVAEConfig.small_test(scaling_factor=0.5)
    params = _random_vae_params(jcfg, 3)
    _write_jax_dir(tmp_path / "jax", jcfg, params)
    vae = load_flax_vae(str(tmp_path / "jax"), device="cpu")
    assert vae.cfg == VAEConfig.small_test(scaling_factor=0.5)
    want = vae_state_dict_from_jax(params, jcfg)
    got = vae.state_dict()
    assert got.keys() == want.keys()
    for k in want:
        assert torch.equal(got[k], want[k]), k

    save_flax_vae(vae, str(tmp_path / "port"))
    # JAX's loader inits a template VAE op by op (~25 s on the CPU); an
    # abstract init gives the same template shapes for `from_bytes`
    init = JaxVAE.init
    monkeypatch.setattr(JaxVAE, "init", lambda self, *a: jax.eval_shape(
        lambda *b: init(self, *b), *a))
    jvae, jparams = jax_load_flax_vae(str(tmp_path / "port"))
    assert jvae.cfg.block_out_channels == jcfg.block_out_channels
    _assert_trees_equal(jparams["params"], params)
    with open(tmp_path / "port" / "vae_params.msgpack", "rb") as f:
        assert flax_msgpack.from_bytes(f.read()).keys() == {"params"}


def test_load_flax_vae_needs_a_card_unless_told_cpu(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    save_flax_vae(build_vae(VAEConfig.small_test(), device="cpu"), str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        load_flax_vae(str(tmp_path))
    with pytest.raises(RuntimeError, match="no CUDA device"):
        train_vae.main(["--data-root", str(tmp_path), "--out", str(tmp_path / "out")])


@pytest.fixture
def images(tmp_path):
    rng = np.random.RandomState(4)
    d = tmp_path / "imgs"
    os.makedirs(d)
    for i in range(3):
        write_png(str(d / f"{i}.png"), rng.randint(0, 256, (40, 36, 3)).astype(np.uint8))
    return str(d)


def test_train_vae_matches_jax_with_the_same_eps(tmp_path, images):
    argv = ["--data-root", images, "--resolution", "32", "--preset", "small", "--batch", "2",
            "--steps", "2", "--lr", "1e-4", "--kl-weight", "0.01", "--log-interval", "1",
            "--seed", "3"]
    # JAX's run; its logger ("pixart") is shared by the process: listen on it
    records = []
    handler = logging.Handler()
    handler.emit = lambda r: records.append(r.getMessage())
    jlog = logging.getLogger("pixart")
    jlog.addHandler(handler)
    old_argv = sys.argv
    sys.argv = ["train_vae.py", *argv, "--out", str(tmp_path / "jax")]
    try:
        runpy.run_path(os.path.join(ROOT, "scripts", "train_vae.py"), run_name="__main__")
    finally:
        sys.argv = old_argv
        jlog.removeHandler(handler)
    jlosses = [float(m.split(" loss ")[1].split()[0]) for m in records if m.startswith("step ")]
    assert len(jlosses) == 2

    # JAX's init and eps: vae.init(PRNGKey(seed), x, PRNGKey(seed)); per step
    # rng, key = split(rng) and eps = normal(key, mean's shape)
    cfg = JaxVAEConfig(**train_vae.PRESETS["small"])
    rng = jax.random.PRNGKey(3)
    init = jax.jit(JaxVAE(cfg).init)(rng, jnp.zeros((1, 32, 32, 3)), rng)["params"]
    keys = []
    for _ in range(2):
        rng, key = jax.random.split(rng)
        keys.append(key)

    def eps_fn(step, shape):
        return torch.from_numpy(np.array(jax.random.normal(keys[step - 1], shape, jnp.float32)))

    out = train_vae.main([*argv, "--out", str(tmp_path / "port"), "--device", "cpu"],
                         init_state=vae_state_dict_from_jax(init, cfg), eps_fn=eps_fn)
    losses = [h[1] for h in out["history"]]
    for got, want in zip(losses, jlosses):
        assert abs(got - want) <= 1e-5 * abs(want) + 5e-6, (losses, jlosses)
    with open(tmp_path / "jax" / "vae_params.msgpack", "rb") as f:
        jparams = serialization.msgpack_restore(f.read())["params"]
    want = vae_state_dict_from_jax(jparams, cfg)
    got = load_flax_vae(str(tmp_path / "port"), device="cpu").state_dict()
    # the key biases' true gradient is 0 (softmax is shift-invariant over the
    # keys): both packages move them by Adam's normalisation of rounding
    # noise, at most lr per step
    noise = [k for k in want if k.endswith("to_k.bias")]
    assert len(noise) == 2
    for k in noise:
        assert float(got[k].abs().max()) <= 2e-4 * 1.001 and float(want[k].abs().max()) <= 2e-4 * 1.001
    bad = {k: _rel_l2(got[k], w) for k, w in want.items()
           if k not in noise and _rel_l2(got[k], w) > 1e-4}
    assert not bad, bad
