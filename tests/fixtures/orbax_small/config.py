# A small model of the JAX trainer's 1024px KV-compression config, whose
# orbax checkpoint (checkpoints/step_2, written by tests/torch_orbax_fixture.py
# with the JAX package) the port's orbax reader is tested on: 3 blocks of
# width 32 (4 heads of 8), qk-norm, the KV-compression conv on block 2,
# 8 caption tokens of 32 channels, CAME behind a global-norm clip.
_base_ = ["../../../configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_internalms_kvcompress.py"]
image_size = 256
aspect_ratio_type = 256
mixed_precision = "fp32"
grad_checkpointing = False
model_max_length = 8
qk_norm = True
kv_compress_config = dict(sampling="conv", scale_factor=2, kv_compress_layer=[2])
model_overrides = dict(depth=3, hidden_size=32, num_heads=4, caption_channels=32)
train_batch_size = 2
optimizer = dict(type="came", lr=1e-3, weight_decay=0.0, betas=(0.9, 0.999, 0.9999),
                 eps=(1e-30, 1e-16))
lr_schedule = "constant"
lr_schedule_args = dict(num_warmup_steps=1)
auto_lr = None
gradient_clip = 1.0
ema_rate = 0.99
