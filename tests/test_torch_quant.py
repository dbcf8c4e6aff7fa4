"""The port's dynamic int8 (W8A8) path against the JAX package, on the CPU.

- `quantize_rows` / `quantize_cols`: the int8 values equal JAX's exactly and
  the scales agree to 1 f32 ulp, on f32 and bf16 inputs with a row of zeros
  and values on .5 ties (round half to even).
- The int32 accumulator of the plain version (an f64 product, exact) equals
  JAX's int32 `dot_general` exactly; `int8_matmul` at f32 agrees within 1e-6
  relative.
- `QuantLinear` keeps f32 weights when the model is cast, quantizes anew when
  the weight is loaded, and a `quant_int8` toy model (depth 4, width 64)
  agrees with JAX's `quant_int8` model, in relative L2, within 2e-3 at f32
  (a rounding flip in one activation moves an output by one quantization
  step, 1/127 of its row's absmax; reading 4.7e-4) and 2e-2 at bf16
  (reading 8.5e-3), and within a sanity bound: the packages' agreement
  without int8 plus half of what int8 changes in the port's output (f32:
  4e-7 + 3.7e-3 / 2; bf16: 7.2e-3 plus half of the int8 change).
- Training refuses `quant_int8`; the hoisted caption K/V are the same with
  and without it, as JAX's hoist.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import dataclasses
import functools

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.models.pixart import PixArt as JaxPixArt
from pixart_sigma_tpu.models.pixart import PixArtConfig as JaxConfig
from pixart_sigma_tpu.models.pixart import precompute_cross_kv as jax_precompute_cross_kv
from pixart_sigma_tpu.ops import quant as jquant
from pixart_sigma_tpu_torch.models.layers import QuantLinear
from pixart_sigma_tpu_torch.models.pixart import PixArtConfig, PixArtMS_XL_2, precompute_cross_kv
from pixart_sigma_tpu_torch.ops import quant as tquant
from pixart_sigma_tpu_torch.utils.checkpoint import state_dict_from_jax

TOY = dict(input_size=16, depth=4, hidden_size=64, num_heads=2, caption_channels=32,
           model_max_length=16, kv_compress_sampling="conv", kv_compress_scale=2,
           kv_compress_layers=(2, 3))
TORCH_DTYPE = {jnp.float32: torch.float32, jnp.bfloat16: torch.bfloat16}


def _ties(rng, rows, cols):
    """rows x cols values with row 0 all zeros and row 1 on .5 ties: its
    absmax is 127, so its scale is 127 / 127 + 1e-8 = 1.0 in f32 and the
    values 2.5, -0.5, 3.5, ... land halfway between integers."""
    x = rng.randn(rows, cols).astype(np.float32) * 3
    x[0] = 0
    x[1] = (np.arange(cols) % 9 - 4).astype(np.float32) + 0.5
    x[1, 0] = 127
    return x


def _ulps(a, b):
    a, b = np.asarray(a, np.float32), np.asarray(b, np.float32)
    return np.abs(a.view(np.int32).astype(np.int64) - b.view(np.int32).astype(np.int64)).max()


@pytest.mark.parametrize("dtype", [jnp.float32, jnp.bfloat16])
def test_quantizers_match_jax_exactly(dtype):
    rng = np.random.RandomState(0)
    x = _ties(rng, 6, 40)
    w = _ties(rng, 6, 40).T.copy()  # [in, out]: column 0 zeros, column 1 on ties
    jx, jw = jnp.asarray(x, dtype), jnp.asarray(w, dtype)
    tx, tw = (torch.from_numpy(np.array(a.astype(jnp.float32))).to(TORCH_DTYPE[dtype])
              for a in (jx, jw))
    for (jq, js), (tq, ts) in ((jquant.quantize_rows(jx), tquant.quantize_rows(tx)),
                               (jquant.quantize_cols(jw), tquant.quantize_cols(tw))):
        assert tq.dtype == torch.int8 and ts.dtype == torch.float32
        np.testing.assert_array_equal(tq.numpy(), np.asarray(jq))
        assert tuple(ts.shape) == js.shape and _ulps(ts.numpy(), js) <= 1
    q, s = tquant.quantize_rows(tx)
    assert (q[0] == 0).all() and float(s[0, 0]) == np.float32(1e-8)
    if dtype == jnp.float32:  # half to even: -2.5 -> -2, -1.5 -> -2, 0.5 -> 0, 4.5 -> 4
        assert float(s[1, 0]) == 1.0
        np.testing.assert_array_equal(q[1, 1:10].numpy(), [-2, -2, 0, 0, 2, 2, 4, 4, -4])
    # the port's [out, in] weight, quantized per output channel, is JAX's
    # [in, out] kernel's quantization in the layout _int_mm takes
    qw, sw = tquant.quantize_weight(tw.t().contiguous())
    assert qw.t().is_contiguous() and qw.shape == tw.shape
    np.testing.assert_array_equal(qw.numpy(), np.asarray(jquant.quantize_cols(jw)[0]))


def test_int8_accumulator_and_matmul_match_jax():
    rng = np.random.RandomState(1)
    x = rng.randn(3, 24, 96).astype(np.float32)
    x[0, 5] = 0.0
    kernel = (rng.randn(96, 40) * 0.1).astype(np.float32)
    bias = rng.randn(40).astype(np.float32)
    jqx, _ = jquant.quantize_rows(jnp.asarray(x))
    jqw, _ = jquant.quantize_cols(jnp.asarray(kernel))
    want_acc = jax.lax.dot_general(jqx, jqw, (((2,), (0,)), ((), ())),
                                   preferred_element_type=jnp.int32)
    got_acc = tquant.int8_accumulate(torch.from_numpy(np.array(jqx)).reshape(-1, 96),
                                     torch.from_numpy(np.array(jqw)))
    assert got_acc.dtype == torch.int32
    np.testing.assert_array_equal(got_acc.numpy(), np.asarray(want_acc).reshape(-1, 40))
    for b in (None, bias):
        want = np.asarray(jquant.int8_matmul(jnp.asarray(x), jnp.asarray(kernel),
                                             None if b is None else jnp.asarray(b)))
        got = tquant.int8_matmul(torch.from_numpy(x), torch.from_numpy(kernel),
                                 None if b is None else torch.from_numpy(b)).numpy()
        assert got.shape == (3, 24, 40) and got.dtype == np.float32
        np.testing.assert_allclose(got, want, rtol=1e-6, atol=1e-6 * np.abs(want).max())
    # bf16 activations: the output in the input's dtype, the bias added in f32
    xb = torch.from_numpy(x).bfloat16()
    got = tquant.int8_matmul(xb, torch.from_numpy(kernel), torch.from_numpy(bias))
    want = jquant.int8_matmul(jnp.asarray(x, jnp.bfloat16), jnp.asarray(kernel),
                              jnp.asarray(bias))
    assert got.dtype == torch.bfloat16
    np.testing.assert_array_equal(got.float().numpy(), np.asarray(want.astype(jnp.float32)))


def test_int_mm_shape_checks_raise():
    """The card's `_int_mm` limits, checked before the launch (the CPU path
    has none): M > 16, K and N multiples of 8, each operand row- or
    column-major but not both column-major."""
    q = lambda *s: torch.zeros(s, dtype=torch.int8)
    col = lambda r, c: q(c, r).t()
    for a, b in ((q(32, 64), col(64, 40)), (q(32, 64), q(64, 40)), (col(32, 64), q(64, 40))):
        tquant.check_int_mm(a, b)
    for a, b in ((q(16, 64), col(64, 40)), (q(32, 60), col(60, 40)), (q(32, 64), col(64, 36)),
                 (col(32, 64), col(64, 40)), (q(32, 128)[:, ::2], col(64, 40))):
        with pytest.raises(ValueError):
            tquant.check_int_mm(a, b)
    with pytest.raises(ValueError, match="int8"):
        tquant.check_int_mm(torch.zeros(32, 64), col(64, 40))


def test_quant_linear_keeps_f32_weights_and_requantizes_on_load():
    torch.manual_seed(0)
    lin = QuantLinear(64, 48).to(torch.bfloat16)
    assert lin.weight.dtype == lin.bias.dtype == torch.float32
    x = torch.randn(5, 64).bfloat16()
    first = lin(x)
    qw, sw = lin.quantized_weight()
    assert first.dtype == torch.bfloat16 and lin.quantized_weight()[0] is qw
    want = tquant.int8_matmul(x, lin.weight.t(), lin.bias)
    assert torch.equal(first, want)
    # quantized from the f32 master, not its bf16 cast
    np.testing.assert_array_equal(qw.numpy(), tquant.quantize_cols(lin.weight.t())[0].numpy())
    new = {k: torch.randn_like(v) for k, v in lin.state_dict().items()}
    lin.load_state_dict(new)
    second = lin(x)
    assert lin.quantized_weight()[0] is not qw
    assert not torch.equal(first, second)
    assert torch.equal(second, tquant.int8_matmul(x, new["weight"].t(), new["bias"]))


@functools.lru_cache(maxsize=None)
def _params():
    """Perturbed params of the toy model; int8 or not, the tree is the same."""
    jm = JaxPixArt(JaxConfig(**TOY))
    params = jax.jit(jm.init)(jax.random.PRNGKey(0), *map(jnp.asarray, _inputs()))
    rng = np.random.RandomState(1)
    return jax.tree_util.tree_map(
        lambda a: jnp.asarray(np.asarray(a) + 0.05 * rng.randn(*a.shape), jnp.float32),
        params["params"])


@functools.lru_cache(maxsize=None)
def _toy(dtype, quant_int8=True):
    """(JAX model, perturbed params, port model with the same weights)."""
    jcfg = JaxConfig(**TOY, dtype=dtype, quant_int8=quant_int8)
    jm = JaxPixArt(jcfg)
    params = _params()
    kw = {f.name: getattr(jcfg, f.name) for f in dataclasses.fields(jcfg) if f.name != "dtype"}
    cfg = PixArtConfig(**kw, dtype=TORCH_DTYPE[dtype])
    tm = PixArtMS_XL_2(device="cpu", **{f.name: getattr(cfg, f.name)
                                          for f in dataclasses.fields(cfg)})
    tm.load_state_dict(state_dict_from_jax(params, cfg))
    return jm, params, tm


def _inputs(B=2, seed=0):
    rng = np.random.RandomState(seed)
    x = rng.randn(B, 16, 16, 4).astype(np.float32)
    t = np.asarray([10.0, 700.0][:B], np.float32)
    y = rng.randn(B, 16, 32).astype(np.float32)
    mask = np.zeros((B, 16), np.int32)
    for i, n in enumerate([16, 5][:B]):
        mask[i, :n] = 1
    return x, t, y, mask


def _rel(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.mark.parametrize("dtype,tol", [(jnp.float32, 2e-3), (jnp.bfloat16, 2e-2)])
def test_quant_model_matches_jax(dtype, tol):
    jm, params, tm = _toy(dtype)
    jplain, _, tplain = _toy(dtype, quant_int8=False)
    assert isinstance(tm.blocks[0].mlp.fc1, QuantLinear)
    assert tm.blocks[3].attn.qkv.weight.dtype == torch.float32
    x, t, y, mask = _inputs()
    apply = lambda m: np.asarray(jax.jit(m.apply)({"params": params},
                                                  *map(jnp.asarray, (x, t, y, mask))))
    args = [torch.from_numpy(a) for a in (x, t, y, mask)]
    with torch.no_grad():
        got, plain = tm(*args).numpy(), tplain(*args).numpy()
    err = _rel(got, apply(jm))
    base = _rel(plain, apply(jplain))  # the packages' agreement without int8
    effect = _rel(plain, got)  # what int8 changes
    assert np.isfinite(got).all() and err <= tol and err <= base + effect / 2, (err, base, effect)


def test_training_refuses_int8_and_the_hoist_stays_plain():
    jm, params, tm = _toy(jnp.float32)
    x, t, y, mask = (torch.from_numpy(a) for a in _inputs())
    with pytest.raises(ValueError, match="serving-only"):
        tm(x, t, y, mask, train=True)
    plain_model = PixArtMS_XL_2(device="cpu", **{
        f.name: getattr(tm.cfg, f.name) for f in dataclasses.fields(tm.cfg)
        if f.name != "quant_int8"})
    plain_model.load_state_dict(tm.state_dict())
    want = jax_precompute_cross_kv(params, jm.cfg, jnp.asarray(y.numpy()))
    with torch.no_grad():
        kvs, kvs_plain = precompute_cross_kv(tm, y), precompute_cross_kv(plain_model, y)
    want = [layer for stack in want for layer in stack]  # scan groups -> layers
    assert len(kvs) == len(want) == 4
    for got, got_plain, w in zip(kvs, kvs_plain, want):
        assert torch.equal(got, got_plain)
        np.testing.assert_allclose(got.numpy(), np.asarray(w), atol=1e-4, rtol=1e-4)
