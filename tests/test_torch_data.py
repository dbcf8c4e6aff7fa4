"""The port's datasets, bucket sampler and loader give the JAX package's
batches bit for bit: feature mode on a synthetic Sigma-dialect fixture with
two aspect buckets (written by `data.synthetic.write_feature_dataset`);
image and prompt mode on PNGs written with PIL (odd sizes and ratios, so
every resize and crop of the transforms runs), single- and multi-scale;
the alpha layout (partition/ JSONs, caption_feature_wmask/, the noflip and
multi-scale VAE directories, the 4.0 ratio cut); and the transforms."""

import json
import os

import numpy as np
import pytest
from PIL import Image

from pixart_sigma_tpu.data import AspectRatioBatchSampler as JaxSampler
from pixart_sigma_tpu.data import DataLoader as JaxLoader
from pixart_sigma_tpu.data import PixArtDataset as JaxDataset
from pixart_sigma_tpu.data import PixArtMSDataset as JaxMSDataset
from pixart_sigma_tpu.data import transforms as jax_transforms
from pixart_sigma_tpu_torch.data import transforms
from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table
from pixart_sigma_tpu_torch.data.datasets import PixArtDataset, PixArtMSDataset
from pixart_sigma_tpu_torch.data.loader import DataLoader
from pixart_sigma_tpu_torch.data.sampler import AspectRatioBatchSampler
from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset

COMMON = dict(resolution=256, load_vae_feat=True, load_t5_feat=True, max_length=24,
              real_prompt_ratio=0.5, dialect="sigma", seed=7)


def _assert_same(got, want):
    assert set(got) == set(want)
    for key, w in want.items():
        if isinstance(w, np.ndarray):
            assert got[key].dtype == w.dtype, key
            np.testing.assert_array_equal(got[key], w, err_msg=key)
        else:
            assert got[key] == w, key


@pytest.fixture(scope="module")
def fixture_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sigma_features"))
    # 5 square items and 4 at ratio 1.13 (a 17 x 15 token grid at 256px)
    sizes = [(256, 256)] * 5 + [(272, 240)] * 4
    return write_feature_dataset(root, sizes, resolution=256, caption_channels=16,
                                 max_length=24, valid_tokens=(3, 19))


def test_ms_batches_match_the_jax_package(fixture_root):
    table = aspect_ratio_table(256)
    port = PixArtMSDataset(fixture_root, aspect_ratio_type=256, **COMMON)
    jax_ds = JaxMSDataset(fixture_root, aspect_ratio_type=256, **COMMON)
    assert port.ratio_nums == jax_ds.ratio_nums
    loaders = (DataLoader(port, AspectRatioBatchSampler(port, 2, table, seed=7), num_workers=2),
               JaxLoader(jax_ds, JaxSampler(jax_ds, 2, table, seed=7), num_workers=2))
    shapes = set()
    for epoch in range(2):  # a new shuffle and new posterior draws each epoch
        for ld in loaders:
            ld.batch_sampler.set_epoch(epoch)
        got, want = list(loaders[0]), list(loaders[1])
        assert len(got) == len(want) == 4
        for g, w in zip(got, want):
            _assert_same(g, w)
            shapes.add(g["latents"].shape)
    assert shapes == {(2, 32, 32, 4), (2, 34, 30, 4)}


def test_single_scale_items_match_and_image_mode_is_refused(tmp_path):
    root = write_feature_dataset(str(tmp_path), [(256, 256)] * 3, resolution=256,
                                 multi_scale=False, caption_channels=16, max_length=24)
    port, jax_ds = PixArtDataset(root, **COMMON), JaxDataset(root, **COMMON)
    for i in range(3):
        _assert_same(port[i], jax_ds[i])
    # image mode is ported: on a features-only tree (no image files) every
    # retry fails, and both packages give up the same way
    for cls in (PixArtDataset, JaxDataset):
        with pytest.raises(RuntimeError, match="Too many bad data"):
            cls(root, **dict(COMMON, load_vae_feat=False))[0]


# (height, width) of the fixture's images: odd sizes, both orientations, one
# past the alpha layout's 4.0 ratio cut (kept by the Sigma dialect's 4.5)
IMAGE_SIZES = [(301, 257), (256, 256), (255, 383), (500, 333), (97, 410), (420, 101),
               (256, 300), (333, 333)]
IMAGE_MODE = dict(COMMON, load_vae_feat=False, load_t5_feat=False)


def _write_images(root, sizes=IMAGE_SIZES, seed=0):
    """PNG images written with PIL under root/part0 and their meta entries."""
    rng = np.random.RandomState(seed)
    os.makedirs(os.path.join(root, "part0"), exist_ok=True)
    meta = []
    for i, (h, w) in enumerate(sizes):
        name = f"img{i}.png"
        pix = rng.randint(0, 256, (h, w, 3)).astype(np.uint8)
        pix = (pix.astype(np.float32) * 0.3 + np.linspace(0, 170, w)[None, :, None]).astype(
            np.uint8)
        Image.fromarray(pix).save(os.path.join(root, "part0", name))
        meta.append({"path": f"part0/{name}", "height": h, "width": w, "ratio": h / w,
                     "prompt": f"caption number {i}", "sharegpt4v": f"a longer caption {i}"})
    return meta


@pytest.fixture(scope="module")
def image_root(tmp_path_factory):
    root = str(tmp_path_factory.mktemp("sigma_images"))
    meta = _write_images(root)
    with open(os.path.join(root, "data_info.json"), "w") as f:
        json.dump(meta, f)
    return root


@pytest.mark.parametrize("multi_scale", [False, True])
def test_image_and_prompt_items_match_the_jax_package(image_root, multi_scale):
    """Image mode (`image` [H, W, 3] in [-1, 1] at the resolution, or at the
    bucket's size) and prompt mode (`prompt`, a ones `y_mask`), with the
    dual-caption choice keyed on (seed, epoch, index), over two epochs."""
    if multi_scale:
        port = PixArtMSDataset(image_root, aspect_ratio_type=256, **IMAGE_MODE)
        jax_ds = JaxMSDataset(image_root, aspect_ratio_type=256, **IMAGE_MODE)
    else:
        port, jax_ds = PixArtDataset(image_root, **IMAGE_MODE), JaxDataset(image_root,
                                                                            **IMAGE_MODE)
    assert len(port) == len(jax_ds) == len(IMAGE_SIZES)
    prompts, shapes = set(), set()
    for epoch in range(2):
        port.set_epoch(epoch)
        jax_ds.set_epoch(epoch)
        for i in range(len(port)):
            got, want = port[i], jax_ds[i]
            _assert_same(got, want)
            assert "latents" not in got and "y" not in got
            assert got["image"].dtype == np.float32 and np.abs(got["image"]).max() <= 1.0
            assert got["y_mask"].tolist() == [1] * 24
            prompts.add(got["prompt"].split()[0])
            shapes.add(got["image"].shape)
    assert prompts == {"caption", "a"}  # both captions are drawn
    if multi_scale:
        assert len(shapes) > 3
    else:
        assert shapes == {(256, 256, 3)}


@pytest.mark.parametrize("multi_scale", [False, True])
def test_alpha_layout_matches_the_jax_package(tmp_path, multi_scale):
    """partition/<json>, caption_feature_wmask/<dir>_<name>.npz and the VAE
    features under img_vae_features_256resolution/noflip (multi-scale:
    img_vae_fatures_256_multiscale/ms); the ratio cut at 4.0 drops one item.
    Feature mode, and image mode on the same tree."""
    root = str(tmp_path)
    meta = _write_images(root, seed=1)
    os.makedirs(os.path.join(root, "partition"))
    with open(os.path.join(root, "partition", "part0.json"), "w") as f:
        json.dump(meta, f)
    table = aspect_ratio_table(256)
    vae_dir = ("img_vae_fatures_256_multiscale/ms" if multi_scale
               else "img_vae_features_256resolution/noflip")
    for d in ("caption_feature_wmask", vae_dir):
        os.makedirs(os.path.join(root, d))
    rng = np.random.RandomState(2)
    for m in meta:
        joined = m["path"].replace("/", "_").replace(".png", "")
        h, w = (table[min(table, key=lambda r: abs(float(r) - m["ratio"]))]
                         if multi_scale else (256, 256))
        feat = rng.randn(2 * 4, int(h) // 8, int(w) // 8).astype(np.float16)
        np.save(os.path.join(root, vae_dir, joined + ".npy"), feat)
        np.savez(os.path.join(root, "caption_feature_wmask", joined + ".npz"),
                 caption_feature=rng.randn(1, 10, 16).astype(np.float16),
                 attention_mask=(np.arange(10) < 7).astype(np.int64)[None])
    for mode in (dict(load_vae_feat=True, load_t5_feat=True), {}):
        kw = dict(COMMON, image_list_json=["part0.json"], dialect="alpha",
                  **(mode or dict(load_vae_feat=False, load_t5_feat=False)))
        if multi_scale:
            port = PixArtMSDataset(root, aspect_ratio_type=256, **kw)
            jax_ds = JaxMSDataset(root, aspect_ratio_type=256, **kw)
        else:
            port, jax_ds = PixArtDataset(root, **kw), JaxDataset(root, **kw)
        assert len(port) == len(jax_ds) == len(meta) - 1  # 420 x 101 is past 4.0
        for i in range(len(port)):
            got = port.getdata(i)  # no retries: a missing file fails the test
            _assert_same(got, jax_ds.getdata(i))
            if mode:
                assert got["y"].shape == (24, 16) and got["y_mask"].sum() == 7


@pytest.mark.parametrize("size", [(301, 257), (97, 410), (256, 256)])
def test_transforms_match_the_jax_package(size):
    h, w = size
    pix = np.random.RandomState(h).randint(0, 256, (h, w, 3)).astype(np.uint8)
    img = Image.fromarray(pix)
    pairs = [(transforms.default_train(img, 128), jax_transforms.default_train(img, 128)),
             (transforms.multiscale_train(img, (96, 160)),
              jax_transforms.multiscale_train(img, (96, 160))),
             (transforms.to_normalized_array(img.convert("L")),
              jax_transforms.to_normalized_array(img.convert("L")))]
    for got, want in pairs:
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)
    assert transforms.resize_shorter(img, 64).size == jax_transforms.resize_shorter(img, 64).size
