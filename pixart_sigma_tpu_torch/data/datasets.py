"""Datasets over the data_info.json layout, in the Sigma and alpha dialects.

Port of pixart_sigma_tpu/data/datasets.py. Items are numpy dicts with
channel-last arrays: {latents [H, W, C] (load_vae_feat) or image [H, W, 3]
in [-1, 1] (image mode, for on-the-fly VAE encoding), y [L, C_cap]
(load_t5_feat), y_mask [L] (all ones in prompt mode), img_hw [2],
aspect_ratio [1], prompt}. Every random draw is keyed on (seed, epoch,
index) with numpy and `random`, as in the JAX package, so both packages
give the same bits for the same files.

- dialect "sigma": data_info.json at the root, caption_features_new/ (or
  sharegpt4v_caption_features_new/ for the other caption, picked with
  probability 1 - real_prompt_ratio), img_sdxl_vae_features_{res}resolution_new/
  (multi-scale: ..._ms_new/), ratios up to 4.5;
- dialect "alpha": partition/<json>, caption_feature_wmask/,
  img_vae_features_{res}resolution/noflip (multi-scale:
  img_vae_fatures_{res}_multiscale/ms, the upstream spelling), file names
  joined from the item's directory and name, ratios up to 4.0.
"""

from __future__ import annotations

import json
import os
import random
from typing import Any, Dict, List

import numpy as np

from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table, get_closest_ratio
from pixart_sigma_tpu_torch.data.transforms import default_train, multiscale_train, open_image


def _replace_img_ext(path: str, dst: str) -> str:
    for ext in (".png", ".jpg", ".webp", ".jpeg", ".JPEG", ".JPG"):
        path = path.replace(ext, dst)
    return path


class PixArtDataset:
    """Single-scale dataset (upstream InternalData / InternalDataSigma)."""

    def __init__(self, root: str, image_list_json="data_info.json", resolution: int = 256,
                 load_vae_feat: bool = False, load_t5_feat: bool = False,
                 max_length: int = 300, real_prompt_ratio: float = 1.0,
                 dialect: str = "sigma", seed: int = 0, **kwargs):
        self.root = root
        self.resolution = resolution
        self.load_vae_feat = load_vae_feat
        self.load_t5_feat = load_t5_feat
        self.max_length = max_length
        self.real_prompt_ratio = real_prompt_ratio
        self.dialect = dialect
        self.seed = seed
        self.epoch = 0
        self.rng = random.Random(seed)  # retry resampling only (stateful)
        jsons = image_list_json if isinstance(image_list_json, list) else [image_list_json]
        max_ratio = 4.5 if dialect == "sigma" else 4.0
        self.meta: List[Dict[str, Any]] = []
        for jf in jsons:
            path = (os.path.join(root, jf) if dialect == "sigma"
                    else os.path.join(root, "partition", jf))
            with open(path) as f:
                meta = json.load(f)
            self.meta.extend([m for m in meta if m.get("ratio", 1.0) <= max_ratio])

    def __len__(self) -> int:
        return len(self.meta)

    def set_epoch(self, epoch: int) -> None:
        """Fresh per-epoch randomness for the keyed draws below."""
        self.epoch = epoch

    def _paths(self, item: Dict[str, Any], real_prompt: bool):
        """(image, caption feature, VAE feature) paths of an item."""
        img = os.path.join(self.root.replace("InternData", "InternImgs"), item["path"])
        fname = item["path"].rsplit("/", 1)[-1]
        joined = "_".join(item["path"].rsplit("/", 1))
        if self.dialect == "sigma":
            feat_dir = "caption_features_new" if real_prompt else "sharegpt4v_caption_features_new"
            txt = os.path.join(self.root, feat_dir, fname.replace(".png", ".npz"))
            vae = os.path.join(self.root, f"img_sdxl_vae_features_{self.resolution}resolution_new",
                               fname.replace(".png", ".npy"))
        else:
            txt = os.path.join(self.root, "caption_feature_wmask",
                               _replace_img_ext(joined, ".npz"))
            vae = os.path.join(self.root, f"img_vae_features_{self.resolution}resolution/noflip",
                               _replace_img_ext(joined, ".npy"))
        return img, txt, vae

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

    def _transform_image(self, item: Dict[str, Any], img_path: str) -> np.ndarray:
        with open_image(img_path) as im:
            return default_train(im, self.resolution)

    def _data_info(self, item) -> Dict[str, np.ndarray]:
        return {
            "img_hw": np.asarray([self.resolution, self.resolution], dtype=np.float32),
            "aspect_ratio": np.asarray([1.0], dtype=np.float32),
        }

    def getdata(self, index: int) -> Dict[str, Any]:
        item = self.meta[index]
        real_prompt = (random.Random(f"{self.seed}/{self.epoch}/{index}").random()
                       < self.real_prompt_ratio)
        img_path, txt_path, vae_path = self._paths(item, real_prompt)
        out: Dict[str, Any] = self._data_info(item)
        if self.load_vae_feat:
            out["latents"] = self._load_vae(vae_path, index)
        else:
            out["image"] = self._transform_image(item, img_path)
        if self.load_t5_feat:
            out["y"], out["y_mask"] = self._load_txt(txt_path)
        else:
            out["y_mask"] = np.ones((self.max_length,), np.int32)
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
    """Multi-scale dataset: each item lands in its closest aspect-ratio
    bucket, and image mode resizes and crops to the bucket's size."""

    def __init__(self, *args, aspect_ratio_type: int = 1024, test_ratios: bool = False,
                 **kwargs):
        super().__init__(*args, **kwargs)
        self.ratios = aspect_ratio_table(aspect_ratio_type, test=test_ratios)
        self.ratio_nums: Dict[float, int] = {float(k): 0 for k in self.ratios}
        for m in self.meta:
            _, key = get_closest_ratio(m["height"], m["width"], self.ratios)
            self.ratio_nums[key] += 1

    def _vae_dir(self) -> str:
        if self.dialect == "sigma":
            return f"img_sdxl_vae_features_{self.resolution}resolution_ms_new"
        return f"img_vae_fatures_{self.resolution}_multiscale/ms"  # sic, upstream's name

    def _paths(self, item, real_prompt: bool):
        img, txt, _ = super()._paths(item, real_prompt)
        fname = item["path"].rsplit("/", 1)[-1]
        name = fname if self.dialect == "sigma" else "_".join(item["path"].rsplit("/", 1))
        return img, txt, os.path.join(self.root, self._vae_dir(), _replace_img_ext(name, ".npy"))

    def _transform_image(self, item, img_path):
        size, _ = get_closest_ratio(item["height"], item["width"], self.ratios)
        with open_image(img_path) as im:
            return multiscale_train(im, (int(size[0]), int(size[1])))

    def _data_info(self, item):
        size, key = get_closest_ratio(item["height"], item["width"], self.ratios)
        return {"img_hw": np.asarray(size, dtype=np.float32),
                "aspect_ratio": np.asarray([key], dtype=np.float32)}
