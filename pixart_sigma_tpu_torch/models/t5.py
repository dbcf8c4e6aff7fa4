"""Offline text encoder: the deterministic hash embedding.

Port of `PseudoT5Embedder` (pixart_sigma_tpu/models/t5.py). The T5-XXL
encoder is not ported yet.
"""

from __future__ import annotations

import hashlib

import numpy as np
import torch


class PseudoT5Embedder:
    """Each word maps to a fixed unit-variance fp16 vector seeded by a stable
    hash, padded to model_max_length; the same features as the JAX package's
    embedder. Returns (y [B, L, dim] float32, mask [B, L] int32) on the CPU."""

    def __init__(self, dim: int = 64, model_max_length: int = 12):
        self.dim = dim
        self.model_max_length = model_max_length

    def get_text_embeddings(self, texts):
        B, L = len(texts), self.model_max_length
        y = np.zeros((B, L, self.dim), np.float32)
        mask = np.zeros((B, L), np.int32)
        for i, text in enumerate(texts):
            for j, word in enumerate(text.split()[:L]):
                seed = int.from_bytes(hashlib.sha256(word.encode()).digest()[:4], "little")
                y[i, j] = np.random.RandomState(seed).randn(self.dim).astype(np.float16)
                mask[i, j] = 1
        return torch.from_numpy(y), torch.from_numpy(mask)
