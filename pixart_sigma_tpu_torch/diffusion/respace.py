"""Timestep respacing: a diffusion over a subset of the training chain.

Port of pixart_sigma_tpu/diffusion/respace.py (`space_timesteps`,
`SpacedDiffusion`). Every entry point that takes the model (training
losses, `p_sample` and so `p_sample_loop`, `ddim_sample_loop`,
`ddim_reverse_sample_loop`) feeds it the original-chain timestep, not the
loop index. JAX's inversion loop does so only when given `timestep_map`;
upstream's wraps the model there too.
"""

from __future__ import annotations

from typing import Sequence, Union

import numpy as np
import torch

from pixart_sigma_tpu_torch.diffusion.gaussian import GaussianDiffusion
from pixart_sigma_tpu_torch.diffusion.schedules import ScheduleCoefficients


def space_timesteps(num_timesteps: int, section_counts: Union[str, Sequence[int]]) -> set:
    """Which original-chain timesteps to keep: per-section step counts (a list
    or a comma-separated string), or "ddimN" for DDIM's integer stride."""
    if isinstance(section_counts, str):
        if section_counts.startswith("ddim"):
            desired = int(section_counts[len("ddim"):])
            for stride in range(1, num_timesteps):
                if len(range(0, num_timesteps, stride)) == desired:
                    return set(range(0, num_timesteps, stride))
            raise ValueError(f"cannot create exactly {desired} steps with an integer stride")
        section_counts = [int(x) for x in section_counts.split(",")]
    size_per = num_timesteps // len(section_counts)
    extra = num_timesteps % len(section_counts)
    start_idx = 0
    all_steps = []
    for i, count in enumerate(section_counts):
        size = size_per + (1 if i < extra else 0)
        if size < count:
            raise ValueError(f"cannot divide section of {size} steps into {count}")
        frac_stride = 1.0 if count <= 1 else (size - 1) / (count - 1)
        cur = 0.0
        for _ in range(count):
            all_steps.append(start_idx + round(cur))
            cur += frac_stride
        start_idx += size
    return set(all_steps)


class SpacedDiffusion(GaussianDiffusion):
    """GaussianDiffusion over the kept timesteps; `timestep_map` turns indices
    on the short chain into original-chain timesteps for the model."""

    def __init__(self, coef, timestep_map: torch.Tensor, **kwargs):
        super().__init__(coef, **kwargs)
        self.timestep_map = timestep_map

    @classmethod
    def from_betas(cls, *, betas, use_timesteps, **kwargs) -> "SpacedDiffusion":
        betas = np.asarray(betas, dtype=np.float64)
        use = {int(t) for t in use_timesteps}
        new_betas, tmap, last = [], [], 1.0
        for i, a in enumerate(np.cumprod(1.0 - betas)):
            if i in use:
                new_betas.append(1.0 - a / last)
                last = a
                tmap.append(i)
        return cls(ScheduleCoefficients.create(np.array(new_betas)),
                   torch.tensor(tmap, dtype=torch.long), **kwargs)

    def to(self, device) -> "SpacedDiffusion":
        super().to(device)
        self.timestep_map = self.timestep_map.to(device)
        return self

    def map_t(self, t: torch.Tensor) -> torch.Tensor:
        """Short-chain indices -> original-chain timesteps."""
        return self.timestep_map.to(t.device)[t.long()]

    def _wrap(self, model_fn):
        return lambda x, t, **kw: model_fn(x, self.map_t(t), **kw)

    def training_losses(self, model_fn, *args, **kwargs):
        return super().training_losses(self._wrap(model_fn), *args, **kwargs)

    def p_sample(self, model_fn, *args, **kwargs):
        return super().p_sample(self._wrap(model_fn), *args, **kwargs)

    def ddim_sample_loop(self, model_fn, *args, **kwargs):
        return super().ddim_sample_loop(self._wrap(model_fn), *args, **kwargs)

    def ddim_reverse_sample_loop(self, model_fn, *args, **kwargs):
        return super().ddim_reverse_sample_loop(self._wrap(model_fn), *args, **kwargs)
