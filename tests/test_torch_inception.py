"""The port's FID extractor and statistic against the JAX package's, on the
CPU (f32):

- `InceptionV3` with JAX's variables carried across (`flax_inception_to_torch`;
  conv kernels He-normal as `random_inception_params` draws them, BatchNorm
  statistics and affines perturbed) at 139px with `resize_input=False`, where
  Mixed_7c still pools a 3x3 map: relative L2 <= 1e-5 per image, |err| <=
  1e-5 (features ~0.1-1);
- the resize against `jax.image.resize(..., "bilinear")` at an enlargement
  (17x23 -> 299) and at the 1024 -> 299 and 512 -> 299 shrinks, where JAX
  antialiases: |err| <= 5e-6 on [0, 1] inputs (a few ulp: the taps sum in
  another order);
- the whole extractor with the resize at 256px: relative L2 <= 1e-5;
- the weight map both ways, bit for bit, and against JAX's converter;
- `extract_activations`' tail batch, the port's own random extractor, and
  `frechet_distance` against JAX's `tools/compute_fid.py`; the CLI.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import importlib.util
import os

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from pixart_sigma_tpu.models.inception import InceptionV3 as JaxInception
from pixart_sigma_tpu.models.inception import torch_inception_to_flax as jax_to_flax
from pixart_sigma_tpu_torch.models.inception import (
    FEATURE_DIM,
    build_inception,
    extract_activations,
    flax_inception_to_torch,
    random_inception_params,
    resize_299,
    torch_inception_to_flax,
)
from pixart_sigma_tpu_torch.tools import compute_fid

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _jax_compute_fid():
    spec = importlib.util.spec_from_file_location("jax_compute_fid",
                                                  os.path.join(ROOT, "tools", "compute_fid.py"))
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


def _rel_l2(a, b):
    a, b = np.asarray(a, np.float64), np.asarray(b, np.float64)
    return float(np.linalg.norm(a - b) / np.linalg.norm(b))


@pytest.fixture(scope="module")
def variables():
    """JAX InceptionV3 variables from the abstract init's shapes: kernels
    He-normal, as `random_inception_params` scales them, from a numpy seed;
    BatchNorm affines and statistics perturbed so the map of each shows."""
    shapes = jax.eval_shape(JaxInception().init, jax.random.PRNGKey(0),
                            jnp.zeros((1, 299, 299, 3)))
    rng = np.random.RandomState(0)

    def draw(path, leaf):
        name = path[-1].key
        if name == "kernel":
            kh, kw, cin, _ = leaf.shape
            return (rng.randn(*leaf.shape) * np.sqrt(2.0 / (kh * kw * cin))).astype(np.float32)
        if name in ("scale", "var"):
            return rng.uniform(0.8, 1.2, leaf.shape).astype(np.float32)
        return (0.05 * rng.randn(*leaf.shape)).astype(np.float32)

    return jax.tree_util.tree_map_with_path(draw, {k: shapes[k] for k in ("params",
                                                                           "batch_stats")})


@pytest.fixture(scope="module")
def port_model(variables):
    model = build_inception("cpu")
    model.load_state_dict(flax_inception_to_torch(variables), strict=True)
    return model


def test_inception_matches_jax_without_the_resize(variables):
    x = np.random.RandomState(1).uniform(0, 1, (2, 139, 139, 3)).astype(np.float32)
    jm = JaxInception(resize_input=False)
    want = np.asarray(jax.jit(jm.apply)(variables, jnp.asarray(x)))
    model = build_inception("cpu", resize_input=False)
    model.load_state_dict(flax_inception_to_torch(variables))
    with torch.no_grad():
        got = model(torch.from_numpy(x)).numpy()
    assert got.shape == want.shape == (2, FEATURE_DIM)
    for b in range(2):
        assert _rel_l2(got[b], want[b]) <= 1e-5, _rel_l2(got[b], want[b])
    np.testing.assert_allclose(got, want, atol=1e-5, rtol=0)


@pytest.mark.parametrize("hw", [(17, 23), (1024, 1024), (512, 512)])
def test_resize_matches_jax_image_resize(hw):
    x = np.random.RandomState(2).uniform(0, 1, (1, *hw, 3)).astype(np.float32)
    want = np.asarray(jax.image.resize(jnp.asarray(x), (1, 299, 299, 3), method="bilinear"))
    got = resize_299(torch.from_numpy(x).permute(0, 3, 1, 2)).permute(0, 2, 3, 1).numpy()
    np.testing.assert_allclose(got, want, atol=5e-6, rtol=0)
    if hw[0] > 299:  # a plain bilinear sample misses JAX's filter by far
        plain = torch.nn.functional.interpolate(
            torch.from_numpy(x).permute(0, 3, 1, 2), size=(299, 299), mode="bilinear",
            align_corners=False).permute(0, 2, 3, 1).numpy()
        assert np.abs(plain - want).max() > 0.1


def test_inception_with_the_resize_matches_jax(variables, port_model):
    x = np.random.RandomState(3).uniform(0, 1, (1, 256, 256, 3)).astype(np.float32)
    want = np.asarray(jax.jit(JaxInception().apply)(variables, jnp.asarray(x)))
    with torch.no_grad():
        got = port_model(torch.from_numpy(x)).numpy()
    assert _rel_l2(got, want) <= 1e-5, _rel_l2(got, want)


def test_weight_maps_round_trip_and_match_jax(variables, port_model):
    sd = port_model.state_dict()
    assert set(sd) == set(flax_inception_to_torch(variables))
    back = torch_inception_to_flax({**{k: v.numpy() for k, v in sd.items()},
                                    "fc.weight": np.zeros((1008, 2048), np.float32),
                                    "Mixed_5b.branch1x1.bn.num_batches_tracked": np.zeros(())})
    theirs = jax_to_flax({k: v.numpy() for k, v in sd.items()})
    flat = jax.tree_util.tree_leaves_with_path(variables)
    for tree in (back, theirs):
        got = dict(jax.tree_util.tree_leaves_with_path(tree))
        assert len(got) == len(flat)
        for path, leaf in flat:
            np.testing.assert_array_equal(np.asarray(got[path]), np.asarray(leaf))
    with pytest.raises(ValueError, match="unrecognised"):
        torch_inception_to_flax({"Mixed_5b.branch1x1.conv.bias": np.zeros(3)})


def test_extract_activations_tail_batch(variables):
    model = build_inception("cpu", resize_input=False)
    model.load_state_dict(flax_inception_to_torch(variables))
    imgs = np.random.RandomState(5).uniform(0, 1, (5, 80, 80, 3)).astype(np.float32)
    acts = extract_activations(model, imgs, batch=2)
    assert acts.shape == (5, FEATURE_DIM) and acts.dtype == np.float32
    whole = extract_activations(model, imgs, batch=5)
    one = extract_activations(model, imgs[4:5], batch=2)
    np.testing.assert_allclose(acts, whole, rtol=1e-5, atol=1e-6)
    np.testing.assert_allclose(acts[4], one[0], rtol=1e-5, atol=1e-6)


def _shapes(n, seed, size=107):
    r = np.random.RandomState(seed)
    out = np.zeros((n, size, size, 3), np.float32)
    y, x = np.ogrid[:size, :size]
    for i in range(n):
        c0, c1 = r.randint(8, size - 8, 2)
        mask = (y - c0) ** 2 + (x - c1) ** 2 < r.randint(6, 16) ** 2
        out[i][mask] = r.uniform(0.5, 1.0, 3)
    return out


def test_random_extractor_is_fixed_and_discriminates():
    """He-normal kernels from the seed: the same seed gives the same
    extractor, and the embedding separates structure from noise (at 107px
    without the resize, where Mixed_7c still pools a 2x2 map, to spare the
    CPU)."""
    model = random_inception_params(seed=0, device="cpu")
    model.resize_input = False
    again = random_inception_params(seed=0, device="cpu")
    w = model.Mixed_6b.branch7x7_2.conv.weight
    assert torch.equal(w, again.Mixed_6b.branch7x7_2.conv.weight)
    assert abs(float(w.std()) - np.sqrt(2.0 / (w.shape[1] * 7))) < 0.01
    # the Fréchet distance of the first 256 features: a 2048-wide one costs
    # four 2048x2048 eigendecompositions, which the parallel test run's
    # workers fight over
    fd = lambda x, y: compute_fid.frechet_distance(x[:, :256], y[:, :256])
    a = extract_activations(model, _shapes(6, 10), batch=6).astype(np.float64)
    b = extract_activations(model, _shapes(6, 11), batch=6).astype(np.float64)
    noise = extract_activations(model, np.random.RandomState(7).uniform(
        0, 1, (6, 107, 107, 3)).astype(np.float32), batch=6).astype(np.float64)
    assert fd(a, noise) > 5 * fd(a, b)
    assert a.std(axis=0).mean() > 1e-3


def test_frechet_distance_matches_jax_tool():
    jfd = _jax_compute_fid().frechet_distance
    rng = np.random.RandomState(6)
    a = rng.randn(300, 16)
    b = 0.7 * rng.randn(200, 16) @ rng.randn(16, 16) * 0.3 + 0.2
    for x, y in ((a, a), (a, b), (b, a)):
        assert compute_fid.frechet_distance(x, y) == jfd(x, y)


def test_compute_fid_cli(tmp_path):
    from PIL import Image

    for sub, seed in (("real", 20), ("fake", 21)):
        os.makedirs(tmp_path / sub)
        for i, img in enumerate(_shapes(2, seed, size=48)):
            Image.fromarray((img * 255).astype(np.uint8)).save(tmp_path / sub / f"{i}.png")
    acts = tmp_path / "acts"
    fid = compute_fid.main([str(tmp_path / "real"), str(tmp_path / "fake"), "--device", "cpu",
                            "--batch", "1", "--save-acts", str(acts)])
    saved = np.load(acts / "fake_acts.npz")["activations"]
    want = extract_activations(random_inception_params(0, "cpu"),
                               compute_fid.load_image_dir(str(tmp_path / "fake")))
    np.testing.assert_array_equal(saved, want)
    assert np.isfinite(fid) and fid > 0
    # .npz inputs (16 features, to spare 2048-wide eigendecompositions)
    rng = np.random.RandomState(8)
    for name in ("x", "y"):
        np.savez(tmp_path / f"{name}.npz", activations=rng.randn(40, 16))
    got = compute_fid.main([str(tmp_path / "x.npz"), str(tmp_path / "y.npz")])
    assert got == compute_fid.frechet_distance(np.load(tmp_path / "x.npz")["activations"],
                                               np.load(tmp_path / "y.npz")["activations"])
    if not torch.cuda.is_available():
        with pytest.raises(RuntimeError, match="no CUDA device"):
            compute_fid.main([str(tmp_path / "real"), str(tmp_path / "fake")])
