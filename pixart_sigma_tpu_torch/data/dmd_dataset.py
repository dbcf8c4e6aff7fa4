"""DMD distillation dataset: (fixed noise, teacher base latent, T5 features).

Port of pixart_sigma_tpu/data/dmd_dataset.py: triplets keyed by the item's
file stem, the init noise and the teacher's base latent as `.npy` (HWC or
CHW) and the caption features as `.npz`, as `tools.generate_dmd_data`
writes them.
"""

from __future__ import annotations

import json
import os
from typing import Any, Dict

import numpy as np


class DMDDataset:
    """Items: {init_noise [h,w,4], base_latent [h,w,4], y, y_mask, prompt}."""

    def __init__(
        self,
        root: str,
        image_list_json: str = "data_info.json",
        max_length: int = 120,
        noise_dir: str = "noise",
        base_latent_dir: str = "base_latents",
        caption_dir: str = "caption_features",
    ):
        self.root = root
        self.max_length = max_length
        self.noise_dir = noise_dir
        self.base_latent_dir = base_latent_dir
        self.caption_dir = caption_dir
        with open(os.path.join(root, image_list_json)) as f:
            self.meta = json.load(f)

    def __len__(self) -> int:
        return len(self.meta)

    def _chw_to_hwc(self, arr: np.ndarray) -> np.ndarray:
        # Accept torch-produced CHW pairs and native HWC ones. Checking only
        # the leading dim misreads small HWC grids (e.g. [8, 8, 4] from a
        # 64px teacher) as channel-first; when both ends look like channels,
        # channel-first iff the TRAILING dims form the square spatial grid.
        lead = arr.shape[0] in (4, 8)
        trail = arr.shape[2] in (4, 8)
        if lead and (not trail or arr.shape[1] == arr.shape[2]):
            return arr.transpose(1, 2, 0)
        return arr

    def __getitem__(self, index: int) -> Dict[str, Any]:
        m = self.meta[index]
        stem = m["path"].rsplit("/", 1)[-1].rsplit(".", 1)[0]
        noise = np.load(os.path.join(self.root, self.noise_dir, stem + ".npy"))
        base = np.load(
            os.path.join(self.root, self.base_latent_dir, stem + ".npy")
        )
        info = np.load(os.path.join(self.root, self.caption_dir, stem + ".npz"))
        fea = np.asarray(info["caption_feature"], np.float32)
        fea = fea[0] if fea.ndim == 3 else fea
        mask = (
            np.asarray(info["attention_mask"], np.int32).reshape(-1)
            if "attention_mask" in info
            else np.ones((fea.shape[0],), np.int32)
        )
        L = self.max_length
        if fea.shape[0] < L:
            fea = np.concatenate(
                [fea, np.repeat(fea[-1:], L - fea.shape[0], axis=0)], axis=0
            )
            mask = np.concatenate([mask, np.zeros((L - len(mask),), np.int32)])
        return {
            "init_noise": self._chw_to_hwc(noise).astype(np.float32),
            "base_latent": self._chw_to_hwc(base).astype(np.float32),
            "y": fea[:L],
            "y_mask": mask[:L],
            "prompt": m.get("prompt", ""),
        }

    def get_data_info(self, idx: int) -> Dict[str, Any]:
        m = self.meta[idx]
        return {"height": m.get("height", 512), "width": m.get("width", 512)}
