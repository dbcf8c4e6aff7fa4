"""2D sin-cos positional embeddings for the DiT latent grid.

Port of pixart_sigma_tpu/ops/pos_embed.py (host numpy, float64 math). The
first half of the embedding encodes the W coordinate and the second half the
H coordinate, like the upstream PixArt code.
"""

from __future__ import annotations

import functools

import numpy as np


def _sincos_1d(embed_dim: int, pos: np.ndarray) -> np.ndarray:
    """[M] positions -> [M, embed_dim] (sin | cos) embedding, float64."""
    assert embed_dim % 2 == 0
    omega = np.arange(embed_dim // 2, dtype=np.float64) / (embed_dim / 2.0)
    omega = 1.0 / 10000**omega
    out = np.einsum("m,d->md", pos.reshape(-1).astype(np.float64), omega)
    return np.concatenate([np.sin(out), np.cos(out)], axis=1)


@functools.lru_cache(maxsize=64)
def get_2d_sincos_pos_embed(
    embed_dim: int,
    grid_h: int,
    grid_w: int,
    pe_interpolation: float = 1.0,
    base_size: int = 16,
) -> np.ndarray:
    """[grid_h * grid_w, embed_dim] float32 pos-embed, row-major over (H, W)."""
    hs = np.arange(grid_h, dtype=np.float64) / (grid_h / base_size) / pe_interpolation
    ws = np.arange(grid_w, dtype=np.float64) / (grid_w / base_size) / pe_interpolation
    w_mesh, h_mesh = np.meshgrid(ws, hs)  # each [grid_h, grid_w]
    emb_w = _sincos_1d(embed_dim // 2, w_mesh)  # first half: w coordinate
    emb_h = _sincos_1d(embed_dim // 2, h_mesh)  # second half: h coordinate
    return np.concatenate([emb_w, emb_h], axis=1).astype(np.float32)
