"""Windowed-attention helpers: window partition and unpartition, and the
decomposed relative-position bias of MViTv2.

Port of pixart_sigma_tpu/ops/windows.py (the upstream
diffusion/model/utils.py:74-183), for the windowed-attention experiments;
no released config uses them.
"""

from __future__ import annotations

from typing import Tuple

import torch
import torch.nn.functional as F


def window_partition(x: torch.Tensor, window_size: int):
    """[B, H, W, C] -> ([B * nW, ws, ws, C], (Hp, Wp)), zero-padded to whole
    windows."""
    B, H, W, C = x.shape
    pad_h = (window_size - H % window_size) % window_size
    pad_w = (window_size - W % window_size) % window_size
    if pad_h or pad_w:
        x = F.pad(x, (0, 0, 0, pad_w, 0, pad_h))
    Hp, Wp = H + pad_h, W + pad_w
    x = x.reshape(B, Hp // window_size, window_size, Wp // window_size, window_size, C)
    windows = x.permute(0, 1, 3, 2, 4, 5).reshape(-1, window_size, window_size, C)
    return windows, (Hp, Wp)


def window_unpartition(windows: torch.Tensor, window_size: int, pad_hw: Tuple[int, int],
                       hw: Tuple[int, int]) -> torch.Tensor:
    """The inverse of `window_partition`, the padding cropped."""
    Hp, Wp = pad_hw
    H, W = hw
    B = windows.shape[0] // (Hp * Wp // window_size // window_size)
    x = windows.reshape(B, Hp // window_size, Wp // window_size, window_size, window_size, -1)
    x = x.permute(0, 1, 3, 2, 4, 5).reshape(B, Hp, Wp, -1)
    return x[:, :H, :W]


def get_rel_pos(q_size: int, k_size: int, rel_pos: torch.Tensor) -> torch.Tensor:
    """A (L, C) relative-position table sliced to the (q, k) geometry, first
    resized along L to 2 max(q, k) - 1 rows when it differs: linear, with
    the filter widened when it shrinks, as `jax.image.resize(..., "linear")`
    (antialiased `F.interpolate`)."""
    max_rel_dist = int(2 * max(q_size, k_size) - 1)
    if rel_pos.shape[0] != max_rel_dist:
        rel_pos = F.interpolate(rel_pos[None, None].float(), size=(max_rel_dist, rel_pos.shape[1]),
                                mode="bilinear", align_corners=False,
                                antialias=True)[0, 0].to(rel_pos.dtype)
    q_coords = torch.arange(q_size, dtype=torch.float32)[:, None] * max(k_size / q_size, 1.0)
    k_coords = torch.arange(k_size, dtype=torch.float32)[None, :] * max(q_size / k_size, 1.0)
    rel = (q_coords - k_coords) + (k_size - 1) * max(q_size / k_size, 1.0)
    return rel_pos[rel.long().to(rel_pos.device)]


def add_decomposed_rel_pos(attn: torch.Tensor, q: torch.Tensor, rel_pos_h: torch.Tensor,
                           rel_pos_w: torch.Tensor, q_size: Tuple[int, int],
                           k_size: Tuple[int, int]) -> torch.Tensor:
    """The MViTv2 decomposed relative-position bias added to attention
    logits [B, q_h * q_w, k_h * k_w] of queries q [B, q_h * q_w, C]."""
    q_h, q_w = q_size
    k_h, k_w = k_size
    rh = get_rel_pos(q_h, k_h, rel_pos_h)
    rw = get_rel_pos(q_w, k_w, rel_pos_w)
    B, _, dim = q.shape
    r_q = q.reshape(B, q_h, q_w, dim)
    rel_h = torch.einsum("bhwc,hkc->bhwk", r_q, rh)
    rel_w = torch.einsum("bhwc,wkc->bhwk", r_q, rw)
    attn = attn.reshape(B, q_h, q_w, k_h, k_w) + rel_h[..., None] + rel_w[..., None, :]
    return attn.reshape(B, q_h * q_w, k_h * k_w)
