"""2K training through the port's Trainer on the CPU, at toy size.

The 2K config (configs/pixart_sigma_config/
PixArt_sigma_xl2_img2K_internalms_kvcompress.py: the 2048 bucket table, pe
interpolation 4, KV compression on the upper layers, grad checkpointing,
CAME, clip 0.01) with its model cut to depth 2, width 144, 2 heads and a
patch of 8 (so a 2048px bucket is 32x32 tokens on the CPU, not 128x128),
for 3 steps over a square bucket and a non-square one (the first step's LR
is 0, the second moves the zero-initialised final projection, the third
all); and the attention
kernels `choose_impl` picks at the full model's 2K shapes, the dispatch the
card's training step follows.
"""

import os

import numpy as np
import pytest
import torch

from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
from pixart_sigma_tpu_torch.ops.attention import choose_impl
from pixart_sigma_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
CONFIG_2K = os.path.join(
    ROOT, "configs/pixart_sigma_config/PixArt_sigma_xl2_img2K_internalms_kvcompress.py")


def test_trainer_runs_the_2k_table_on_the_cpu(tmp_path):
    write_feature_dataset(str(tmp_path / "data"), [(2048, 2048)] * 2 + [(1920, 2176)] * 4,
                          resolution=2048, caption_channels=32, max_length=300)
    cfg = read_config(CONFIG_2K)
    assert (cfg.image_size, cfg.aspect_ratio_type, cfg.pe_interpolation, cfg.train_batch_size,
            cfg.optimizer["type"], cfg.gradient_clip) == (2048, 2048, 4.0, 4, "came", 0.01)
    cfg.update(train_batch_size=2, data_root=str(tmp_path), num_workers=2, log_interval=1,
               save_model_epochs=10**6, lr_schedule_args=dict(num_warmup_steps=1),
               model_overrides=dict(depth=2, hidden_size=144, num_heads=2, patch_size=8,
                                    caption_channels=32, kv_compress_layers=(1,)))
    cfg.data = dict(cfg.data, root="data", load_vae_feat=True, load_t5_feat=True)
    trainer = Trainer(cfg, str(tmp_path / "work"), device="cpu")
    mc = trainer.model.cfg
    assert mc.input_size == 256 and mc.grad_checkpointing and mc.kv_compress_scale == 2
    before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
    state = trainer.train(max_steps=3)
    assert state.step == 3
    # the 2048 table's buckets: 2048x2048 and 1920x2176 (ratio 0.88)
    assert {h["hw"] for h in trainer.history} == {(256, 256), (240, 272)}
    assert all(np.isfinite(h["loss"]) and h["grad_norm"] > 0 for h in trainer.history)
    moved = sum(not torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())
    assert moved > 0.7 * len(before)


@pytest.mark.parametrize("hw,self_impl,compressed_impl", [
    ((256, 256), "flash", "onepass"),   # 16384 tokens, 4096 compressed keys
    ((240, 272), "flash", "onepass"),   # 16320 tokens (a tail of 64), 4080 compressed
    ((130, 132), "flash", "onepass"),   # 4290 tokens, just past the onepass gate
])
def test_choose_impl_at_the_2k_training_shapes(hw, self_impl, compressed_impl):
    """The full model's self-attention (head dim 72) with gradients, and the
    caption cross-attention (300 keys, masked)."""
    n = (hw[0] // 2) * (hw[1] // 2)
    m = (hw[0] // 4) * (hw[1] // 4)
    assert choose_impl(n, n, 72, False, needs_grad=True) == self_impl
    assert choose_impl(n, m, 72, False, needs_grad=True) == compressed_impl
    assert choose_impl(n, 300, 72, True, needs_grad=True) == "allheads"
