"""Resume round trips of the port's Trainer, on the CPU: a run stopped at a
checkpoint and resumed in a new Trainer must equal an uninterrupted run bit
for bit (parameters, EMA, resampler ring, losses and buckets). Kept apart
from tests/test_torch_trainer_features.py, whose other tests compare with
the JAX package, because these are the slowest trainer tests and a file
runs on one worker.
"""

import tests.torch_threads  # noqa: F401  (xdist workers share the cores)
import os

import pytest
import torch

from pixart_sigma_tpu_torch.config import read_config
from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
from pixart_sigma_tpu_torch.training.trainer import Trainer

ROOT = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
SIGMA_1024 = os.path.join(
    ROOT, "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_internalms_kvcompress.py")


def _features_config(data_root, **overrides):
    cfg = read_config(SIGMA_1024)
    cfg.update(image_size=256, aspect_ratio_type=256, train_batch_size=2, data_root=data_root,
               num_workers=2, log_interval=1, lr_schedule_args=dict(num_warmup_steps=1),
               save_model_steps=0, save_model_epochs=10**6,
               model_overrides=dict(depth=2, hidden_size=144, num_heads=2,
                                    caption_channels=32, kv_compress_layers=(1,)))
    cfg.data = dict(cfg.data, root="data", load_vae_feat=True, load_t5_feat=True)
    cfg.update(overrides)
    return cfg


FEATURES = dict(gradient_accumulation_steps=2, schedule_sampler="loss-second-moment",
                snr_gamma=5.0, snr_loss=True, balanced_sampler=True,
                optimizer=dict(type="lion", lr=1e-4, weight_decay=0.01, betas=(0.9, 0.99)),
                no_weight_decay_on=["bias", "norm", "y_embedding"])


@pytest.mark.parametrize("first", [2, 3])
def test_resume_round_trip_is_bit_exact(tmp_path, first):
    """4 micro-steps in one run against `first`, a checkpoint, a new Trainer
    with resume_from="latest" and the rest, with accumulation 2 (a checkpoint
    inside an accumulation window when first = 3), the resampler, Min-SNR,
    the snr objective, Lion with no_weight_decay_on and the balanced sampler."""
    write_feature_dataset(str(tmp_path / "data"), [(256, 256)] * 4 + [(272, 240)] * 4,
                          resolution=256, caption_channels=32)
    whole = Trainer(_features_config(str(tmp_path), **FEATURES), str(tmp_path / "whole"),
                    device="cpu")
    whole.train(max_steps=4)
    part = Trainer(_features_config(str(tmp_path), **FEATURES), str(tmp_path / "part"),
                   device="cpu")
    part.train(max_steps=first)
    part.save(part.state.step, 0)
    resumed = Trainer(_features_config(str(tmp_path), **FEATURES,
                                       resume_from=dict(checkpoint="latest")),
                      str(tmp_path / "part"), device="cpu")
    state = resumed.train(max_steps=4 - first)
    assert state.step == 4 and state.opt_step == 2
    assert [h["hw"] for h in part.history + resumed.history] == [h["hw"] for h in whole.history]
    for n, p in whole.model.named_parameters():
        assert torch.equal(p, dict(resumed.model.named_parameters())[n]), n
        assert torch.equal(whole.state.ema[n], state.ema[n]), n
    assert torch.equal(whole.schedule_sampler.history, resumed.schedule_sampler.history)
    assert [h["loss"] for h in whole.history[first:]] == [h["loss"] for h in resumed.history]


def test_resume_round_trip_with_stacked_came_is_bit_exact(tmp_path):
    """The config's CAME on the scan-stacked groups (its state kept stacked
    under each stack's first parameter): 4 steps in one run against 2, a
    checkpoint and 2 more in a resumed Trainer."""
    write_feature_dataset(str(tmp_path / "data"), [(256, 256)] * 4 + [(272, 240)] * 4,
                          resolution=256, caption_channels=32)
    # two scan groups of two layers: 0-1, and the KV-compressed 2-3
    arch = dict(model_overrides=dict(depth=4, hidden_size=144, num_heads=2,
                                     caption_channels=32, kv_compress_layers=(2, 3)))
    whole = Trainer(_features_config(str(tmp_path), **arch), str(tmp_path / "whole"),
                    device="cpu")
    assert whole.model.cfg.scan_blocks and whole.model.cfg.block_groups() == [(1, 2), (2, 2)]
    whole.train(max_steps=4)
    opt, params = whole.state.optimizer, dict(whole.model.named_parameters())
    # a stacked bias [2, D] is factored: one row per layer, and the second
    # layer keeps no state of its own
    assert opt.state[params["blocks.2.attn.qkv.bias"]]["row"].shape == (2,)
    assert not opt.state[params["blocks.3.attn.qkv.bias"]]
    part = Trainer(_features_config(str(tmp_path), **arch), str(tmp_path / "part"),
                   device="cpu")
    part.train(max_steps=2)
    part.save(part.state.step, 0)
    resumed = Trainer(_features_config(str(tmp_path), **arch,
                                       resume_from=dict(checkpoint="latest")),
                      str(tmp_path / "part"), device="cpu")
    state = resumed.train(max_steps=2)
    assert state.step == 4
    for n, p in whole.model.named_parameters():
        assert torch.equal(p, dict(resumed.model.named_parameters())[n]), n
        assert torch.equal(whole.state.ema[n], state.ema[n]), n
    assert [h["loss"] for h in whole.history[2:]] == [h["loss"] for h in resumed.history]
