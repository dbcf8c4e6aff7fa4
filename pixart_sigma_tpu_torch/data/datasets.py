"""Feature datasets over the data_info.json layout of the Sigma dialect.

Port of pixart_sigma_tpu/data/datasets.py, feature mode only
(`load_vae_feat` and `load_t5_feat`) and the Sigma dialect only: the image
path needs the VAE and T5 encoders, which are not ported yet, and the alpha
layout waits for an alpha training slice; both raise. Items are numpy
dicts with channel-last arrays, {latents [H, W, C], y [L, C_cap], y_mask
[L], img_hw [2], aspect_ratio [1], prompt}. Every random draw is keyed on
(seed, epoch, index) with numpy and `random`, as in the JAX package, so both
packages give the same bits for the same files.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List

import numpy as np

from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table, get_closest_ratio


def _replace_img_ext(path: str, dst: str) -> str:
    for ext in (".png", ".jpg", ".webp", ".jpeg", ".JPEG", ".JPG"):
        path = path.replace(ext, dst)
    return path


class PixArtDataset:
    """Single-scale dataset: data_info.json at the root, caption_features_new/
    (or sharegpt4v_caption_features_new/ for the other caption, picked with
    probability 1 - real_prompt_ratio) and
    img_sdxl_vae_features_{res}resolution_new/."""

    def __init__(self, root: str, image_list_json="data_info.json", resolution: int = 256,
                 load_vae_feat: bool = False, load_t5_feat: bool = False,
                 max_length: int = 300, real_prompt_ratio: float = 1.0,
                 dialect: str = "sigma", seed: int = 0, **kwargs):
        if not (load_vae_feat and load_t5_feat):
            raise NotImplementedError(
                "the port reads precomputed features only (load_vae_feat and load_t5_feat); "
                "image and prompt mode need the VAE and T5 encoders (ROADMAP.md, Queue 1)")
        if dialect != "sigma":
            raise NotImplementedError(f"the {dialect!r} dataset layout is not ported yet")
        self.root = root
        self.resolution = resolution
        self.max_length = max_length
        self.real_prompt_ratio = real_prompt_ratio
        self.seed = seed
        self.epoch = 0
        self.rng = random.Random(seed)  # retry resampling only (stateful)
        jsons = image_list_json if isinstance(image_list_json, list) else [image_list_json]
        self.meta: List[Dict[str, Any]] = []
        for jf in jsons:
            with open(os.path.join(root, jf)) as f:
                meta = json.load(f)
            self.meta.extend([m for m in meta if m.get("ratio", 1.0) <= 4.5])

    def __len__(self) -> int:
        return len(self.meta)

    def set_epoch(self, epoch: int) -> None:
        """Fresh per-epoch randomness for the keyed draws below."""
        self.epoch = epoch

    def _vae_path(self, fname: str) -> str:
        return os.path.join(self.root, f"img_sdxl_vae_features_{self.resolution}resolution_new",
                            fname.replace(".png", ".npy"))

    def _paths(self, item: Dict[str, Any], real_prompt: bool):
        fname = item["path"].rsplit("/", 1)[-1]
        feat_dir = "caption_features_new" if real_prompt else "sharegpt4v_caption_features_new"
        return (os.path.join(self.root, feat_dir, fname.replace(".png", ".npz")),
                self._vae_path(fname))

    def _load_vae(self, path: str, index: int) -> np.ndarray:
        """[mean, std] .npy -> a posterior draw keyed on (seed, epoch, index),
        channel-last."""
        arr = np.load(path)  # [2C, h, w]
        mean, std = np.split(arr, 2, axis=0)
        z = np.random.default_rng((self.seed, self.epoch, index)).standard_normal(
            mean.shape, dtype=np.float32)
        return np.transpose(mean + std * z, (1, 2, 0)).astype(np.float32)

    def _load_txt(self, path: str):
        info = np.load(path)
        fea = np.asarray(info["caption_feature"], dtype=np.float32)  # [1, T, C]
        fea = fea[0] if fea.ndim == 3 else fea
        if "attention_mask" in info:
            mask = np.asarray(info["attention_mask"], dtype=np.int32).reshape(-1)
        else:
            mask = np.ones((fea.shape[0],), dtype=np.int32)
        L = self.max_length
        if fea.shape[0] < L:  # pad by repeating the last token, masked out
            fea = np.concatenate([fea, np.repeat(fea[-1:], L - fea.shape[0], axis=0)], axis=0)
            mask = np.concatenate([mask, np.zeros((L - mask.shape[0],), np.int32)], axis=0)
        return fea[:L], mask[:L]

    def _data_info(self, item) -> Dict[str, np.ndarray]:
        return {
            "img_hw": np.asarray([self.resolution, self.resolution], dtype=np.float32),
            "aspect_ratio": np.asarray([1.0], dtype=np.float32),
        }

    def getdata(self, index: int) -> Dict[str, Any]:
        item = self.meta[index]
        real_prompt = (random.Random(f"{self.seed}/{self.epoch}/{index}").random()
                       < self.real_prompt_ratio)
        txt_path, vae_path = self._paths(item, real_prompt)
        out: Dict[str, Any] = self._data_info(item)
        out["latents"] = self._load_vae(vae_path, index)
        out["y"], out["y_mask"] = self._load_txt(txt_path)
        out["prompt"] = (item.get("prompt", "") if real_prompt
                         else item.get("sharegpt4v", item.get("prompt", "")))
        return out

    def __getitem__(self, index: int) -> Dict[str, Any]:
        for _ in range(20):  # bad-data resampling, as upstream
            try:
                return self.getdata(index)
            except Exception as e:  # noqa: BLE001
                index = self.rng.randrange(len(self))
                last = e
        raise RuntimeError(f"Too many bad data: {last}")

    def get_data_info(self, idx: int) -> Dict[str, Any]:
        m = self.meta[idx]
        return {"height": m["height"], "width": m["width"]}


class PixArtMSDataset(PixArtDataset):
    """Multi-scale dataset: each item lands in its closest aspect-ratio bucket."""

    def __init__(self, *args, aspect_ratio_type: int = 1024, test_ratios: bool = False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.ratios = aspect_ratio_table(aspect_ratio_type, test=test_ratios)
        self.ratio_nums: Dict[float, int] = {float(k): 0 for k in self.ratios}
        for m in self.meta:
            _, key = get_closest_ratio(m["height"], m["width"], self.ratios)
            self.ratio_nums[key] += 1

    def _vae_path(self, fname: str) -> str:
        return os.path.join(self.root, f"img_sdxl_vae_features_{self.resolution}resolution_ms_new",
                            _replace_img_ext(fname, ".npy"))

    def _data_info(self, item):
        size, key = get_closest_ratio(item["height"], item["width"], self.ratios)
        return {"img_hw": np.asarray(size, dtype=np.float32),
                "aspect_ratio": np.asarray([key], dtype=np.float32)}
