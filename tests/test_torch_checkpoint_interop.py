"""Checkpoint interop of the port against the JAX package, on the CPU.

- the diffusers <-> upstream `.pth` name maps equal JAX's on a toy state
  dict (micro-conditioned, qk_norm): the same keys, values bit for bit;
- the safetensors reader equals `safetensors.numpy` on a file and on a
  directory of two shards;
- `load_checkpoint` of a diffusers file gives the model JAX's
  `load_checkpoint` gives (forward within 1e-6 relative L2, f32), and
  raises without a null embedding, as JAX does; a KV-compressed model
  refuses a diffusers file, whose names carry no KV-compression conv;
- `tools.convert_checkpoint`: `.pth` -> diffusers -> `.pth` bit for bit, and
  `merge` equal to JAX's tool bit for bit.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import argparse
import dataclasses
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch
from safetensors.numpy import load_file as np_load_file
from safetensors.numpy import save_file as np_save_file

from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.utils import checkpoint as jckpt
from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.models.builder import build_model_from_config
from pixart_sigma_tpu_torch.models.pixart import PixArtConfig, PixArtMS_XL_2
from pixart_sigma_tpu_torch.tools import convert_checkpoint
from pixart_sigma_tpu_torch.utils import checkpoint as ckpt

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
TOY = dict(input_size=16, depth=3, hidden_size=96, num_heads=2, caption_channels=24,
           model_max_length=8, micro_condition=True, qk_norm=True, scan_blocks=False)


def _rel_l2(got, want):
    got, want = np.asarray(got, np.float64), np.asarray(want, np.float64)
    return np.linalg.norm(got - want) / max(np.linalg.norm(want), 1e-30)


def _jax_params(jcfg, seed):
    jm = JaxPixArt(jcfg)
    params = jax.jit(jm.init)(
        jax.random.PRNGKey(0), jnp.zeros((1, 16, 16, 4)), jnp.zeros((1,)),
        jnp.zeros((1, 8, 24)), jnp.ones((1, 8), jnp.int32),
        img_hw=jnp.ones((1, 2)), aspect_ratio=jnp.ones((1, 1)))["params"]
    rng = np.random.RandomState(seed)
    return jm, jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape), jnp.float32), params)


@pytest.fixture(scope="module")
def toy():
    jcfg = JaxConfig(**TOY, dtype=jnp.float32)
    jm, params = _jax_params(jcfg, 1)
    sd = jckpt.flax_to_torch_state_dict(params, jcfg)  # numpy, upstream names
    return jcfg, jm, params, sd


def _port_model(jcfg, **kw):
    fields = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg)
              if f.name != "dtype"}
    fields.update(kw)
    return PixArtMS_XL_2(device="cpu", **fields, dtype=torch.float32)


def _tensors(sd):
    return {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}


def _inputs(seed=3):
    rng = np.random.RandomState(seed)
    return dict(x=rng.randn(2, 16, 16, 4).astype(np.float32),
                t=np.asarray([10.0, 700.0], np.float32),
                y=rng.randn(2, 8, 24).astype(np.float32),
                mask=(np.arange(8)[None] < np.asarray([[8], [3]])).astype(np.int32),
                hw=np.asarray([[128, 128], [128, 128]], np.float32),
                ar=np.ones((2, 1), np.float32))


def _port_forward(model, inp):
    with torch.no_grad():
        return model(*(torch.from_numpy(inp[k]) for k in ("x", "t", "y", "mask", "hw", "ar")))


def _jax_forward(jm, params, inp):
    return np.asarray(jm.apply({"params": params}, inp["x"], inp["t"], inp["y"], inp["mask"],
                               img_hw=inp["hw"], aspect_ratio=inp["ar"]))


def test_name_maps_equal_jax(toy):
    jcfg, _, _, sd = toy
    want = jckpt.torch_to_diffusers_state_dict(sd)
    got = ckpt.torch_to_diffusers_state_dict(_tensors(sd))
    assert sorted(got) == sorted(want) and any("q_norm" in k for k in got)
    for k, v in want.items():
        assert np.array_equal(got[k].numpy(), v), k
    back_want = jckpt.diffusers_to_torch_state_dict(want, depth=jcfg.depth)
    back = ckpt.diffusers_to_torch_state_dict(_tensors(want), depth=jcfg.depth)
    assert sorted(back) == sorted(back_want) == sorted(sd)
    for k, v in back_want.items():
        assert np.array_equal(back[k].numpy(), v), k


def test_safetensors_reader_equals_safetensors_numpy(tmp_path):
    rng = np.random.RandomState(0)
    arrays = {f"w{i}": rng.randn(3, i + 2).astype(np.float32) for i in range(4)}
    arrays["h"] = rng.randn(5).astype(np.float16)
    np_save_file(arrays, str(tmp_path / "one.safetensors"))
    got = ckpt.load_safetensors_state_dict(str(tmp_path / "one.safetensors"))
    want = np_load_file(str(tmp_path / "one.safetensors"))
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert got[k].dtype == torch.float32
        assert np.array_equal(got[k].numpy(), v.astype(np.float32)), k
    shards = tmp_path / "shards"
    shards.mkdir()
    names = sorted(arrays)
    np_save_file({k: arrays[k] for k in names[:2]}, str(shards / "a-00001.safetensors"))
    np_save_file({k: arrays[k] for k in names[2:]}, str(shards / "a-00002.safetensors"))
    got = ckpt.load_safetensors_state_dict(str(shards))
    assert sorted(got) == names
    for k in names:
        assert np.array_equal(got[k].numpy(), arrays[k].astype(np.float32)), k
    (tmp_path / "empty").mkdir()
    with pytest.raises(FileNotFoundError):
        ckpt.load_safetensors_state_dict(str(tmp_path / "empty"))


def test_load_checkpoint_reads_a_diffusers_file_as_jax_does(toy, tmp_path):
    jcfg, jm, params, sd = toy
    dsd = jckpt.torch_to_diffusers_state_dict(sd)
    path = str(tmp_path / "transformer.safetensors")
    np_save_file({k: np.ascontiguousarray(v) for k, v in dsd.items()}, path)
    inp = _inputs()
    want = _jax_forward(jm, jckpt.load_checkpoint(path, jcfg), inp)
    model = ckpt.load_checkpoint(path, _port_model(jcfg))
    got = _port_forward(model, inp).numpy()
    assert _rel_l2(got, want) <= 1e-6, _rel_l2(got, want)
    assert _rel_l2(want, _jax_forward(jm, params, inp)) == 0.0

    # a diffusers transformer without the learned null caption
    no_null = {k: v for k, v in dsd.items() if k != "caption_projection.y_embedding"}
    path = str(tmp_path / "no_null.safetensors")
    np_save_file({k: np.ascontiguousarray(v) for k, v in no_null.items()}, path)
    with pytest.raises(AssertionError, match="null_embedding"):
        jckpt.load_checkpoint(path, jcfg)
    with pytest.raises(ValueError, match="null_embedding"):
        ckpt.load_checkpoint(path, _port_model(jcfg))
    null = np.random.RandomState(4).randn(8, 24).astype(np.float32)
    want = _jax_forward(jm, jckpt.load_checkpoint(path, jcfg, null_embedding=null), inp)
    got = _port_forward(ckpt.load_checkpoint(path, _port_model(jcfg), null_embedding=null),
                        inp).numpy()
    assert _rel_l2(got, want) <= 1e-6, _rel_l2(got, want)


def test_diffusers_file_of_a_kv_compressed_model_is_refused(tmp_path):
    kv = dict(TOY, micro_condition=False, qk_norm=False, kv_compress_sampling="conv",
              kv_compress_scale=2, kv_compress_layers=(1,))
    model = PixArtMS_XL_2(device="cpu", **kv, dtype=torch.float32)
    dsd = ckpt.torch_to_diffusers_state_dict(model.state_dict())
    assert not any(".sr." in k or "attn1.norm" in k for k in dsd)
    path = ckpt.save_safetensors(str(tmp_path / "kv.safetensors"), dsd)
    with pytest.raises(NotImplementedError, match="KV-compression"):
        ckpt.load_checkpoint(path, PixArtMS_XL_2(device="cpu", **kv, dtype=torch.float32))


def test_an_orbax_directory_is_refused(tmp_path):
    """An empty `step_10/` is refused by the name of what it lacks; the JAX
    trainer's real save (the committed fixture) loads."""
    (tmp_path / "step_10").mkdir()
    with pytest.raises(FileNotFoundError, match="_CHECKPOINT_METADATA"):
        ckpt.load_checkpoint(str(tmp_path / "step_10"), _port_model(JaxConfig(**TOY)))
    fixture = os.path.join(ROOT, "tests", "fixtures", "orbax_small")
    model = build_model_from_config(read_config(os.path.join(fixture, "config.py")), device="cpu")
    step = os.path.join(fixture, "checkpoints", "step_2")
    ckpt.load_checkpoint(step, model)
    want = ckpt.state_dict_from_jax(ckpt.load_orbax_params(step), model.cfg)
    for name, tensor in model.state_dict().items():
        assert torch.equal(tensor, want[name]), name


def test_convert_checkpoint_round_trip_and_merge_equal_jax(toy, tmp_path, monkeypatch):
    jcfg, _, _, sd = toy
    src = str(tmp_path / "model.pth")
    torch.save({"state_dict": _tensors(sd)}, src)
    convert_checkpoint.main(["to-diffusers", src, str(tmp_path / "d.safetensors")])
    convert_checkpoint.main(["to-pth", str(tmp_path / "d.safetensors"),
                             str(tmp_path / "back.pth")])
    back = torch.load(str(tmp_path / "back.pth"), weights_only=True)["state_dict"]
    assert sorted(back) == sorted(sd)
    for k, v in sd.items():
        assert np.array_equal(back[k].numpy(), v), k
    assert _port_model(jcfg).load_state_dict(back, strict=True) is not None

    _, params2 = _jax_params(jcfg, 2)
    other = str(tmp_path / "other.pth")
    torch.save({"state_dict": _tensors(jckpt.flax_to_torch_state_dict(params2, jcfg))}, other)
    convert_checkpoint.main(["merge", src, other, str(tmp_path / "merged.pth"),
                             "--alpha", "0.3"])
    monkeypatch.syspath_prepend(ROOT)
    from tools import convert_checkpoint as jax_tool

    jax_tool.merge(argparse.Namespace(src=src, src2=other, dst=str(tmp_path / "jax.pth"),
                                      alpha=0.3))
    got = torch.load(str(tmp_path / "merged.pth"), weights_only=True)["state_dict"]
    want = torch.load(str(tmp_path / "jax.pth"), weights_only=False)["state_dict"]
    assert sorted(got) == sorted(want)
    for k, v in want.items():
        assert torch.equal(got[k], v), k
