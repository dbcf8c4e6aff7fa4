"""The port's PixArt layers and model against the JAX package, on the CPU.

Toy size: depth 4, hidden 144, 2 heads (Dh = 72), a 16x16 latent (64
tokens), KV compression conv x2 on layers 2-3, caption_channels 32 and
L = 12 captions with a padded mask. Every JAX param is perturbed first (the
zero-initialised cross-attention `proj` and final `linear` would otherwise
make the output independent of the input). Weights reach the port through
`state_dict_from_jax`. Inputs are seeded numpy arrays handed to both.

Tolerances: float32 atol 1e-4 (both run exact f32 matmuls; differences are
summation order); bfloat16 atol 6e-2 on outputs of unit scale (the two
frameworks round intermediate activations at different places).
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.models import layers as jl
from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.models.pixart import precompute_cross_kv as jax_precompute_cross_kv
from pixart_sigma_tpu.ops.pos_embed import get_2d_sincos_pos_embed as jax_pos_embed
from pixart_sigma_tpu.utils.checkpoint import flax_to_torch_state_dict
from pixart_sigma_tpu_torch.models import layers as tl
from pixart_sigma_tpu_torch.models.pixart import (
    PixArtConfig,
    PixArtMS_XL_2,
    precompute_cross_kv,
)
from pixart_sigma_tpu_torch.ops.pos_embed import get_2d_sincos_pos_embed
from pixart_sigma_tpu_torch.utils.checkpoint import load_pth, state_dict_from_jax

F32 = dict(atol=1e-4, rtol=1e-4)
BF16 = dict(atol=6e-2, rtol=6e-2)
TOY = dict(input_size=16, depth=4, hidden_size=144, num_heads=2, caption_channels=32,
           model_max_length=12, kv_compress_sampling="conv", kv_compress_scale=2,
           kv_compress_layers=(2, 3))
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _perturb(tree, seed, scale=0.05):
    rng = np.random.RandomState(seed)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + scale * rng.randn(*a.shape), jnp.float32), tree)


def _port_cfg(jcfg: JaxConfig) -> PixArtConfig:
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    return PixArtConfig(**kw, dtype=TORCH_DTYPE[jcfg.dtype])


def _inputs(B=2, L=12, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 16, 16, 4).astype(np.float32)
    t = np.asarray([10.0, 700.0][:B], np.float32)
    y = rng.randn(B, L, 32).astype(np.float32)
    mask = np.zeros((B, L), np.int32)
    for i, n in enumerate([12, 5][:B]):
        mask[i, :n] = 1
    return x, t, y, mask


def _toy(dtype=jnp.float32, scan_blocks=True):
    """(JAX model, perturbed params, port model with the same weights)."""
    jcfg = JaxConfig(**TOY, dtype=dtype, scan_blocks=scan_blocks)
    jm = JaxPixArt(jcfg)
    x, t, y, mask = _inputs(1)
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), jnp.asarray(x), jnp.asarray(t),
                              jnp.asarray(y), jnp.asarray(mask))["params"]
    params = _perturb(params, 1)
    cfg = _port_cfg(jcfg)
    tm = PixArtMS_XL_2(device="cpu", **{f.name: getattr(cfg, f.name)
                                          for f in dataclasses.fields(cfg)})
    tm.load_state_dict(state_dict_from_jax(params, cfg))
    return jm, params, tm


@pytest.fixture(scope="module")
def toy_f32():
    return _toy(jnp.float32, scan_blocks=False)


def _t(a, dtype=torch.float32):
    return torch.tensor(np.asarray(a, np.float32), dtype=dtype)


def _close(got, want, tol):
    np.testing.assert_allclose(got.detach().float().numpy(), np.asarray(want, np.float32), **tol)


# ---------------------------------------------------------------- elementwise

def test_elementwise_helpers_match_jax():
    rng = np.random.RandomState(0)
    x, s, b = (rng.randn(2, 5, 8).astype(np.float32) for _ in range(3))
    _close(tl.t2i_modulate(_t(x), _t(b), _t(s)), jl.t2i_modulate(x, b, s), F32)
    _close(tl.gelu_tanh(_t(x)), jl.gelu_tanh(jnp.asarray(x)), F32)
    t = np.asarray([0.0, 3.5, 999.0], np.float32)
    for dim in (256, 7):
        _close(tl.timestep_embedding(_t(t), dim), jl.timestep_embedding(jnp.asarray(t), dim),
               F32)


def test_pos_embed_matches_jax():
    for args in ((144, 8, 8, 1.0, 8), (1152, 72, 56, 2.0, 64)):
        np.testing.assert_array_equal(get_2d_sincos_pos_embed(*args), jax_pos_embed(*args))


# ---------------------------------------------------------------- layers

def _apply(module, params, *args, **kw):
    return module.apply({"params": params}, *args, **kw)


def test_embedders_match_jax(toy_f32):
    jm, p, tm = toy_f32
    x, t, y, _ = _inputs()
    with torch.no_grad():
        _close(tm.x_embedder(_t(x)), _apply(jl.PatchEmbed(2, 144), p["x_embedder"], x), F32)
        _close(tm.t_embedder(_t(t)),
               _apply(jl.TimestepEmbedder(144), p["t_embedder"], jnp.asarray(t)), F32)
        drop = np.asarray([0, 1])
        want = _apply(jl.CaptionEmbedder(32, 144, token_num=12), p["y_embedder"],
                      jnp.asarray(y), force_drop_ids=jnp.asarray(drop))
        _close(tm.y_embedder(_t(y), force_drop_ids=torch.from_numpy(drop)), want, F32)


def test_size_embedder_and_mlp_match_jax():
    rng = np.random.RandomState(3)
    s = rng.rand(2, 2).astype(np.float32) * 1024
    jse = jl.SizeEmbedder(48)
    p = _perturb(jse.init(jax.random.PRNGKey(0), jnp.asarray(s))["params"], 2)
    tse = tl.SizeEmbedder(48)
    tse.load_state_dict({"mlp.0.weight": _t(p["fc1"]["kernel"]).T,
                         "mlp.0.bias": _t(p["fc1"]["bias"]),
                         "mlp.2.weight": _t(p["fc2"]["kernel"]).T,
                         "mlp.2.bias": _t(p["fc2"]["bias"])})
    with torch.no_grad():
        _close(tse(_t(s)), _apply(jse, p, jnp.asarray(s)), F32)
    x = rng.randn(3, 7, 16).astype(np.float32)
    jmlp = jl.Mlp(hidden_features=24, out_features=16)
    p = _perturb(jmlp.init(jax.random.PRNGKey(1), jnp.asarray(x))["params"], 3)
    tmlp = tl.Mlp(16, 24, 16)
    tmlp.load_state_dict({f"{n}.{w}": (_t(p[n]["kernel"]).T if w == "weight" else _t(p[n]["bias"]))
                          for n in ("fc1", "fc2") for w in ("weight", "bias")})
    with torch.no_grad():
        _close(tmlp(_t(x)), _apply(jmlp, p, jnp.asarray(x)), F32)


def _attn_state_dict(p):
    sd = {}
    for name, tree in p.items():
        if name in ("qkv", "proj"):
            sd[f"{name}.weight"], sd[f"{name}.bias"] = _t(tree["kernel"]).T, _t(tree["bias"])
        elif name in ("q_norm", "k_norm", "sr_norm"):
            key = "norm" if name == "sr_norm" else name
            sd[f"{key}.weight"], sd[f"{key}.bias"] = _t(tree["scale"]), _t(tree["bias"])
    if "sr_kernel" in p:
        sd["sr.weight"] = _t(p["sr_kernel"]).permute(3, 2, 0, 1)
        sd["sr.bias"] = _t(p["sr_bias"])
    return sd


@pytest.mark.parametrize("sampling,qk_norm", [
    ("conv", False), ("conv", True), ("ave", False), ("uniform", True),
    ("uniform_every", False), (None, True),
])
def test_self_attention_kv_compress_matches_jax(sampling, qk_norm):
    rng = np.random.RandomState(4)
    x = rng.randn(2, 48, 144).astype(np.float32)  # a 6x8 grid
    kw = dict(dim=144, num_heads=2, sampling=sampling, sr_ratio=2, qk_norm=qk_norm)
    jattn = jl.SelfAttentionKVCompress(**kw, hw=(6, 8))
    p = _perturb(jattn.init(jax.random.PRNGKey(0), jnp.asarray(x))["params"], 5)
    tattn = tl.SelfAttentionKVCompress(**kw)
    tattn.load_state_dict(_attn_state_dict(p))
    with torch.no_grad():
        _close(tattn(_t(x), hw=(6, 8)), _apply(jattn, p, jnp.asarray(x)), F32)


def test_cross_attention_matches_jax_with_and_without_hoisted_kv(toy_f32):
    _, p, tm = toy_f32
    rng = np.random.RandomState(6)
    x = rng.randn(2, 64, 144).astype(np.float32)
    cond = rng.randn(2, 12, 144).astype(np.float32)
    _, _, _, mask = _inputs()
    jca = jl.MultiHeadCrossAttention(dim=144, num_heads=2)
    pc = p["blocks_1"]["cross_attn"]
    kv = _apply(jl.nn.Dense(288), pc["kv_linear"], jnp.asarray(cond))
    want = _apply(jca, pc, jnp.asarray(x), jnp.asarray(cond), jnp.asarray(mask))
    with torch.no_grad():
        tca = tm.blocks[1].cross_attn
        _close(tca(_t(x), _t(cond), torch.from_numpy(mask)), want, F32)
        _close(tca(_t(x), None, torch.from_numpy(mask), kv=_t(kv)), want, F32)


@pytest.mark.parametrize("layer", [1, 2])  # a plain and a KV-compressed block
def test_block_and_final_layer_match_jax(toy_f32, layer):
    _, p, tm = toy_f32
    rng = np.random.RandomState(7)
    x = rng.randn(2, 64, 144).astype(np.float32)
    y = rng.randn(2, 12, 144).astype(np.float32)
    t0 = rng.randn(2, 6 * 144).astype(np.float32)
    _, _, _, mask = _inputs()
    jblock = jl.PixArtBlock(144, 2, sampling="conv", sr_ratio=tm.cfg.sr_ratio(layer), hw=(8, 8))
    want = _apply(jblock, p[f"blocks_{layer}"], *map(jnp.asarray, (x, y, t0, mask)))
    with torch.no_grad():
        got = tm.blocks[layer](_t(x), _t(y), _t(t0), torch.from_numpy(mask), hw=(8, 8))
        _close(got, want, F32)
        t = t0[:, :144]
        jfinal = jl.T2IFinalLayer(144, 2, 8)
        _close(tm.final_layer(_t(x), _t(t)),
               _apply(jfinal, p["final_layer"], jnp.asarray(x), jnp.asarray(t)), F32)


# ---------------------------------------------------------------- model

def test_toy_model_f32_matches_jax(toy_f32):
    jm, p, tm = toy_f32
    x, t, y, mask = _inputs()
    want = jax.jit(jm.apply)({"params": p}, *map(jnp.asarray, (x, t, y, mask)))
    with torch.no_grad():
        got = tm(_t(x), _t(t), _t(y), torch.from_numpy(mask))
    assert got.dtype == torch.float32 and got.shape == (2, 16, 16, 8)
    _close(got, want, F32)
    with torch.no_grad():
        eps = tm.forward_with_dpmsolver(_t(x), _t(t), _t(y), torch.from_numpy(mask))
    _close(eps, np.asarray(want)[..., :4], F32)


def test_precompute_cross_kv_matches_jax_and_the_plain_forward(toy_f32):
    jm, p, tm = toy_f32
    x, t, y, mask = _inputs()
    want = jax_precompute_cross_kv(p, jm.cfg, jnp.asarray(y))
    with torch.no_grad():
        kvs = precompute_cross_kv(tm, _t(y))
        assert len(kvs) == 4
        for got, w in zip(kvs, want):
            _close(got, w, F32)
        hoisted = tm(_t(x), _t(t), _t(y), torch.from_numpy(mask), cross_kv=kvs)
        plain = tm(_t(x), _t(t), _t(y), torch.from_numpy(mask))
    _close(hoisted, plain.numpy(), F32)


def test_pos_embed_is_converted_once_and_equals_a_fresh_one(toy_f32):
    """The model keeps its positional embedding on the device per
    (h, w, dtype, device): the kept tensor is the fresh host conversion, and a
    second forward reuses it with the same output."""
    _, _, tm = toy_f32
    x, t, y, mask = _inputs()
    tm._pos_cache.clear()
    with torch.no_grad():
        first = tm(_t(x), _t(t), _t(y), torch.from_numpy(mask))
        kept = tm.pos_embed(8, 8, torch.device("cpu"))
        second = tm(_t(x), _t(t), _t(y), torch.from_numpy(mask))
    fresh = torch.from_numpy(get_2d_sincos_pos_embed(
        144, 8, 8, pe_interpolation=tm.cfg.pe_interpolation, base_size=tm.cfg.base_size))
    assert list(tm._pos_cache) == [(8, 8, torch.float32, torch.device("cpu"))]
    assert tm.pos_embed(8, 8, torch.device("cpu")) is kept
    assert torch.equal(kept, fresh.to(torch.float32))
    assert torch.equal(first, second)
    assert tm.pos_embed(4, 6, torch.device("cpu")).shape == (24, 144)


def test_toy_model_bf16_matches_jax():
    jm, p, tm = _toy(jnp.bfloat16)
    assert next(tm.parameters()).dtype == torch.bfloat16
    x, t, y, mask = _inputs()
    want = jax.jit(jm.apply)({"params": p}, *map(jnp.asarray, (x, t, y, mask)))
    with torch.no_grad():
        got = tm(_t(x), _t(t), _t(y), torch.from_numpy(mask))
    _close(got, want, BF16)


# ---------------------------------------------------------------- weights

@pytest.mark.parametrize("scan_blocks", [True, False])
def test_state_dict_from_jax_matches_flax_to_torch(scan_blocks):
    jcfg = JaxConfig(**TOY, scan_blocks=scan_blocks, micro_condition=True, qk_norm=True)
    x, t, y, mask = map(jnp.asarray, _inputs(1))
    init = jax.jit(lambda *a: JaxPixArt(jcfg).init(
        *a, img_hw=jnp.ones((1, 2)), aspect_ratio=jnp.ones((1, 1))))
    params = init(jax.random.PRNGKey(0), x, t, y, mask)
    params = _perturb(params["params"], 8)
    assert any(k.startswith("blocks_scan_") for k in params) == scan_blocks
    want = flax_to_torch_state_dict(params, jcfg)
    got = state_dict_from_jax(params, _port_cfg(jcfg))
    assert set(got) == set(want)
    for k, w in want.items():
        np.testing.assert_array_equal(got[k].numpy(), np.asarray(w, np.float32), err_msg=k)
    model = PixArtMS_XL_2(device="cpu", **{f.name: getattr(_port_cfg(jcfg), f.name)
                                           for f in dataclasses.fields(PixArtConfig)})
    assert set(model.state_dict()) == set(got)


def test_load_pth_reads_the_upstream_dialect(toy_f32, tmp_path):
    jm, p, _ = toy_f32
    sd = flax_to_torch_state_dict(p, jm.cfg)
    path = tmp_path / "toy.pth"
    torch.save({"state_dict": {k: torch.from_numpy(np.array(v)) for k, v in sd.items()}}, path)
    cfg = _port_cfg(jm.cfg)
    model = load_pth(PixArtMS_XL_2(device="cpu", **{f.name: getattr(cfg, f.name)
                                                    for f in dataclasses.fields(cfg)}), path)
    x, t, y, mask = _inputs()
    with torch.no_grad():
        got = model(_t(x), _t(t), _t(y), torch.from_numpy(mask))
    _close(got, jax.jit(jm.apply)({"params": p}, *map(jnp.asarray, (x, t, y, mask))), F32)


def test_builders_default_to_the_card():
    if torch.cuda.is_available():
        pytest.skip("a card is present")
    with pytest.raises(RuntimeError, match="no CUDA device"):
        PixArtMS_XL_2(depth=1, hidden_size=144, num_heads=2)
    with pytest.raises(NotImplementedError, match="not ported"):
        PixArtMS_XL_2(device="cpu", depth=1, hidden_size=144, num_heads=2, quant_int8=True)
