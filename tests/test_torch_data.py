"""The port's feature datasets, bucket sampler and loader give the JAX
package's batches bit for bit, on a synthetic Sigma-dialect fixture with two
aspect buckets (written by `data.synthetic.write_feature_dataset`)."""

import numpy as np
import pytest

from pixart_sigma_tpu.data import AspectRatioBatchSampler as JaxSampler
from pixart_sigma_tpu.data import DataLoader as JaxLoader
from pixart_sigma_tpu.data import PixArtDataset as JaxDataset
from pixart_sigma_tpu.data import PixArtMSDataset as JaxMSDataset
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
    with pytest.raises(NotImplementedError, match="features"):
        PixArtDataset(root, **dict(COMMON, load_vae_feat=False))
