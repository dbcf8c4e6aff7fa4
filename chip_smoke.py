#!/usr/bin/env python3
"""Drive the PyTorch port's 1024px, 2K and 4K sampling and 1024px, 2K and
512px training paths, with the trainer's features, the T5-XXL and SDXL-VAE
encoders, the turbo serving modes and the HTTP server, the training CLI,
the fine-tuning and distillation loops, the evaluation (bits/dim, FID,
LPIPS), the VAE trainer and the offline toy workflow, and the attention
kernels at every head dim up to 128, on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines:
1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: the four CUDA sources of pixart_sigma_tpu_torch/csrc with nvcc
   (sm_90a), in parallel, with ptxas register, spill and shared-memory use
   and each kernel's keys per tile, which the planted skipped tile, the
   extent fault and the spike inputs below follow;
3. kernels against their plain PyTorch versions at the path's shapes and at
   unaligned ones (bf16, seeded inputs; f32 at the unaligned ones), with the
   stated tolerance, and the same check applied to plain outputs with a
   planted fault, which it must reject: the onepass and allheads forward
   kernels (allheads also on a caption with no valid key and on one valid
   only on keys [256, 300), with the fault "extent one tile short": the tile
   holding each caption's last valid key skipped); the flash kernel at the
   2K path shape (compared on picked heads and query rows), in the 2048-key
   block regime with a ragged tail, and masked, each with "spike" inputs
   that make single key tiles visible, its lse and a gradient through its
   autograd Function; the headsmajor kernel (the allheads cases); then the
   onepass logsumexp and the two backward kernels (flash_bwd_dkv,
   flash_bwd_dq) at the training shapes (captions with no valid key and one
   valid only on keys [256, 300), with the fault "key extent one tile
   short"), and at the 2K training shapes (flash's backward at
   N = M = 16384, onepass's at N = 16384, M = 4096) on picked heads; the
   onepass and allheads forwards and the backward pair also at the 512px
   training shapes (B = 32, N = 1008; M = 1008 or a 300-key caption);
4. the 1024px sampling path through PixArtPipeline: PixArt-Sigma-XL-2 at full
   width and depth (28 blocks, 1152 wide, KV compression conv x2 on layers
   14-27), seeded random weights, pseudo-T5 captions padded to 300 tokens,
   20-step DPM-Solver++ with CFG 4.5 and hoisted caption K/V, SDXL-VAE decode
   to 1024px; then one 1152x896 call to latents (unaligned token counts), a
   256px trajectory held against the same model with plain attention, and
   the cross-attention forced to the headsmajor kernel
   (PIXART_CROSSATTN_IMPL=headsmajor): a 20-step trajectory and the 256px one;
5. 1024px times from CUDA events: each forward kernel (and the onepass
   launches that write the lse, and that take a key mask; allheads and
   headsmajor also at the 2K shape, B = 2, N = 16384, with the 2K
   trajectory's caption mask, and on a long caption, all 300 keys valid),
   its plain version, the library attention call
   (`scaled_dot_product_attention`, timed only) and the bound, each kernel
   and library call both queued behind a device sleep (device time) and
   host-paced (host time included); sampler and decode seconds per image,
   peak memory and a torch.profiler breakdown;
5b. every other sampler of PixArtPipeline on the same model, prompts and
   negative prompt (whose caption mask differs from the prompts', so iDDPM's
   [cond, uncond] batch under the [negative, prompt] masks runs) at the
   upstream CLI's step counts: DEIS 20, SDE-DPM-Solver++ 20, SA-Solver 25,
   iDDPM 100, LCM 4 and the one-NFE DMD generator; for each, the onepass and
   allheads launches against 28 per model call and no other attention
   kernel, finite non-constant latents, one decoded non-constant image,
   sampler and decode seconds per image (each the median of 3 calls after
   the checked one, which warms the sampler's shapes) and peak memory, and a 256px
   trajectory held against plain attention with the same seed (so the same
   noise); torch.profiler breakdowns of the iDDPM and SA-Solver trajectories
   (cut to TRACED_STEPS);
6. the 2K path: the model of configs/pixart_sigma_config/
   PixArt_sigma_xl2_img2K_internalms_kvcompress.py (input 256, pe
   interpolation 4, KV compression on layers 14-27) with seeded random
   weights, one prompt with CFG, 20 steps, tiled decode to 2048x2048 (25
   tiles); launches of each kernel against the count reckoned from the code,
   sampler and decode seconds, peak memory and a torch.profiler breakdown;
7. the 4K path: the same model through PixArtPipeline(base_resolution=2880)
   to 4096x4096 (a 512x512 latent, 65536 tokens), 2 steps, tiled decode (121
   tiles); launches, seconds per step of that first call and of a second,
   warm one, and decode seconds;
8. the flash kernel's times at the 2K and 4K shapes beside its plain version
   (on a subset of the rows), `scaled_dot_product_attention` and the bound;
9. the training path through the port's Trainer at the config's operating
   point (configs/pixart_sigma_config/
   PixArt_sigma_xl2_img1024_internalms_kvcompress.py: batch 4, CAME, clip
   0.01, EMA, grad checkpointing, bf16 compute over f32 weights) with seeded
   random weights, on a synthetic feature dataset written to a temporary
   directory (two aspect buckets); kernel launches against the count reckoned
   from the code, seconds per step and images per second per bucket, peak
   memory and a torch.profiler breakdown of one step;
10. one training step's gradients at 256px through the kernels, held against
   the same step through plain attention;
11. backward times at the 1024px and 2K training shapes: each backward
   kernel (device time and host-paced), its plain version, the backward of
   `scaled_dot_product_attention` (timed only) and the bound;
12. 2K training through the Trainer at full width and depth
   (configs/pixart_sigma_config/PixArt_sigma_xl2_img2K_internalms_kvcompress.py:
   B = 4, the 2048 bucket table, pe interpolation 4, grad checkpointing,
   CAME, clip 0.01) on synthetic features in the 2048x2048 and 1920x2176
   buckets (16320 tokens: key tails in flash, dkv and dq), 4 steps:
   launches against the reckoning (flash in layers 0-13, onepass in 14-27),
   s/step and img/s, peak memory and a torch.profiler breakdown;
13. the 2K gradient gate: one step's gradients through the kernels, flash's
   autograd Function inside the model, against plain attention, on a
   latent just past the onepass gate (4290 tokens) at depth 4, B = 2, over
   all parameters, the worst one, and each 128-row tile of the flash
   layers' q, k and v gradients, with two planted faults in flash's backward
   (dQ without its ln 2 chain factor; dQ of the tail query tile zeroed) that
   it must reject;
14. the trainer's features at 1024px, full width (`run_features`): gradient
   accumulation, the loss-second-moment sampler, Min-SNR, the snr
   objective, Lion, no_weight_decay_on, the balanced sampler and a resume
   round trip at depth 4; validation sampling with a VAE writing PNGs and
   each remat policy at depth 28; the masked toy config;
15. T5-XXL at full width (24 layers, d_model 4096, 64 heads of 64, d_ff
   10240, vocab 32128, 300 tokens) with seeded random weights in bf16 and a
   word-hash tokenizer defined here (no vocabulary file is reachable): held
   against the port's own f32 encoder with the same weights on the card,
   per caption over its valid tokens, with two planted faults (layer 0's
   position bias dropped; the key mask dropped); encode times for 2 prompts
   and for B = 32 captions, and the peak memory;
16. the SDXL-VAE encoder at full width (f32, TF32 off), seeded random
   weights: a 256px batch on the card against the host's CPU, with the
   planted fault "symmetric pad before the stride-2 convs"; encode times at
   512px, B = 32, and 1024px, B = 4;
17. phase 4's 1024px path with T5-XXL encoding the prompts and the negative
   prompt, to uint8 images: launches, T5 s/call, sampler and decode s/img,
   peak memory with T5-XXL resident;
18. configs/pixart_sigma_config/PixArt_sigma_xl2_img512_internalms.py
   through the Trainer at full width and depth (B = 32, CAME on the scan
   groups, clip 0.01, real_prompt_ratio 0.5) from PNG images read with PIL
   through PixArtMSDataset and their captions, encoded on the fly by the
   encoders of phases 15 and 16: 4 steps over the 512x512 bucket and the
   448x576 one (1008 tokens: a key-tile tail), launches against the
   reckoning, s/step, img/s, the split of a step between T5, VAE encode
   and the DiT step, peak memory and a torch.profiler breakdown;
19. the features round trip: the port's extract_features on phase 18's
   items, then one Trainer step from its files through PixArtMSDataset;
20. the turbo serving config (configs/pixart_sigma_config/
   PixArt_sigma_xl2_img1024_serving_turbo.py: int8 W8A8 linears, cache span
   7-21) at full width and depth with seeded random weights: each int8
   linear of a block on the card against its plain version on the CPU at
   the 1024px CFG batch's rows (quantized operands and int32 accumulators
   equal bit for bit, outputs gated, two planted faults), with its times
   beside the bf16 linear; 20-step DPM-Solver++ trajectories, exact, with
   the cache at interval 1 and on a schedule of every step (both equal to
   the exact latents bit for bit), at interval 2, at the adaptive threshold
   0.15, int8 alone and turbo (int8 + interval 2), each with its launches
   against the reckoning (28 per full model call, 14 per call that reuses
   the cache), their relative L2 to the exact latents and the planted fault
   "the cache stores out, not out - h"; sampler s/img, decode s/img and
   traces splitting the turbo trajectory's device time;
21. the port's HTTP server (pixart_sigma_tpu_torch.scripts.serve) in-process
   on a loopback port over phase 20's int8 model with block caching at
   interval 2: concurrent requests, batched PNGs against the same requests
   served alone, the planted fault "row latent from another seed", /healthz,
   429 past the queue depth, launches per call, per-request latencies, and
   img/s over a window of 16 same-signature requests at max batch 4;
22. the training CLI (pixart_sigma_tpu_torch.scripts.train, its main) at
   full width and depth on synthetic 1024px features: the 1024px
   KV-compress config for 3 steps from a `.pth`, and 2 steps, a checkpoint
   and `--resume-from latest` for 1, bit for bit against the 3; the 1024px
   config without KV compression from a `.pth` and from the diffusers
   `.safetensors` of the same weights, equal first-step losses; the 512px
   config in image mode with `--debug`, its VAE from a `.safetensors` and
   T5 from an HF directory (T5-XXL's width, cut to 2 layers);
23. LoRA (scripts.train_pixart_lora) on the KV-compress config, B = 4, rank
   4, 3 steps, then a DoRA step: zero-init adapters give the base output
   bit for bit, only the adapters move, the merged `.pth` gives the merged
   forward bit for bit;
24. DreamBooth (scripts.train_dreambooth_lora) on its config (1024px, 120
   tokens, prior preservation) from 4 instance and 4 class PNGs, 3 steps;
25. LCM (scripts.train_pixart_lcm) at the config's B = 12, 1024px, the
   teacher from a diffusers `.safetensors`, 3 steps, s/step, peak memory and
   a trace of one step;
26. DMD: tools.generate_dmd_data (8 triplets, 20 steps, 512px teacher,
   pseudo-T5), scripts.train_pixart_dmd on them (B = 4, bf16 teacher, 3
   steps), one_step_generate against the pipeline's one-step sampler; then
   one LoRA, LCM and DMD generator step at 256px and full width through the
   kernels against plain attention, each with a planted fault it must
   reject. Every one of these counts its kernel launches against the
   reckoning;
27. bits/dim: `calc_bpd_loop` over a 50-step spaced chain on the 1024px
   KV-compress config at full width (B = 2, pseudo-T5 captions; 50 x 28
   onepass and allheads launches); at 256px the bits/dim through the
   kernels against plain attention (fault: the decoder NLL at t = 0
   replaced by the KL) and one `IDDPM(use_kl=True)` step (SGD; fault: the
   bound not rescaled by T);
28. FID features: InceptionV3 (2048) with its fixed-seed random weights in
   f32, on the card against the host's CPU for 8 1024px images from phase 4
   and the same at 512px (fault: Mixed_7c pooling by average; the same run
   with TF32 on, the control, must read beyond the limit too, as in 29 and
   30); img/s at B = 32 on 1024px inputs, the resize included;
29. LPIPS (VGG16) on the card against the CPU at 512px, B = 4 pairs (fault:
   no channel unit-normalisation); one DMD generator step at 512px, B = 4,
   with the LPIPS regression of the SDXL-VAE-decoded x0 against phase 26's
   base latents; phase 26's 256px DMD gate again with the regression on;
30. `scripts.train_vae` with the sdxl preset at 256px, B = 8, on 64 PNGs
   (3 steps), its directory read back bit for bit; one small-preset step on
   the card against the CPU with the same eps (fault: eps of another image);
31. the offline toy workflow (docs/toy_workflow.md), cut in length:
   make_toy_dataset (512 images), train_vae (small, 200 steps),
   extract_features --vae-flax, the training CLI on
   configs/toy/pixart_toy_img128.py (150 steps at B = 64), inference --vae-flax (64
   samples, 20 steps), compute_fid (real vs real, vs the samples, vs
   uniform noise: the samples must score below the noise) and one prompt
   through the interface REPL on stdin; on the trained model, one training
   step at B = 64 and one CFG forward of 2 x 32 rows through the kernels
   against plain attention (fault: the padding of the last key tile left
   unmasked); the loader (threads, and `loader_processes`) and a held
   batch's step at the config's B = 256;
32. multi-rank training (parallel/): (a) the 1024px config at full width,
   cut to depth 8 (layers 4-7 compressed; the script's length), from
   features, B = 4, 3 steps each of the plain Trainer, then
   over one NCCL rank (`initialize_distributed`) DDP (bit for bit the
   plain run), FSDP2 and tensor parallelism (the parameters' and EMA's
   change against the plain run's; faults: the sharded parameters or
   their EMA left unchanged), the FSDP and tensor steps traced; (b) DDP on
   two gloo processes sharing the card (`chip_smoke.py --gloo-ddp-rank`),
   the masked toy config at 2 rows a rank against one process (fault: both
   ranks on rank 0's rows);
33. sequence parallelism on two gloo processes sharing the card
   (`chip_smoke.py --seq-rank`; gloo's all-gather, reduce-scatter and
   send/recv of CUDA tensors staged through host memory, the compute on the
   card): (a) `scripts.inference --seq-parallel 2` at 1024px, full width
   and depth, 4-step DPM-Solver++ with CFG, against the one-process CLI
   (fault: rank 1's shard one token row early); (b) seqshard (the flash
   kernel on a 8192-query shard against 16384 keys) and ring attention at
   the 2K shape against plain attention; (c) two Trainer steps over seq 2
   at full width, depth 2, against one process (fault: the gradients
   averaged over seq, not summed); (d) each rank's launches against the
   single-card reckoning at its shard;
34. every head dim up to 128 (run after phase 5b): (a) each of the six
   kernels at Dh = 1, 8, 18, 36, 64, 72, 80, 88, 96, 120 and 128 with
   H = 1152 / Dh heads at the 1024px shapes, masked and unmasked, bf16 and
   f32, held to its plain version on three picked heads under phase 3's
   limits (the backward pair after the onepass forward), with planted
   faults: a key tile skipped, K's columns [64, 128) dropped (width 128),
   the padded head dim's logit scale (a head dim off a multiple of 8), lse
   + 1 and a query tile skipped (backward); each kernel's time at Dh = 128
   and 96 beside its plain version, `sdpa` and the bound; (b) the 5-step
   1024px DPM-Solver++ trajectory of XL-2 at full width and depth with 9
   heads (Dh = 128, self-attention on flash) and 12 (Dh = 96) against plain
   attention on the card (fault: K's columns [64, 128) dropped in plain
   attention), launches against `forward_launches`; (c) one 1024px training
   step of the 9-head model at depth 4 (B = 2), its gradients per 128-row
   tile against plain attention (faults: dK's columns [64, 128) zeroed, dQ
   without its ln 2 factor);
35. the JAX trainer's orbax checkpoints, from the committed fixture
   tests/fixtures/orbax_small (written by the JAX package; its config.py is
   a 3-block, 32-wide model of the 1024px KV-compress config): (a) every
   zarr chunk of its OCDBT store decoded by the C++ decoder
   (csrc/zstd_decode.cpp, built by the host compiler with the kernels) and
   by the plain Python one, bit for bit equal to each other and to
   expected.json's SHA-256 digests, and the same check must reject a chunk
   with one flipped byte in a compressed block; (b) the C++ decoder's MB/s
   over the chunks repeated to >= 256 MB of output (a call per chunk, and
   the chunks joined into one buffer on one thread and on eight threads),
   the Python decoder's over one pass, and what they give for one f32 tree
   of PixArt-Sigma-XL-2 and for a CAME resume;
   (c) the model loaded through `load_checkpoint` on the card, its f32
   output against the JAX model's in expected.json (plain attention and the
   kernels), and a 4-step DPM-Solver++ sample through the kernels against
   plain attention, launches against `forward_launches`; (d) a Trainer
   resumed with resume_from="latest" in a work dir holding the fixture's
   checkpoints (step 2), then one step on the kernels: finite loss and
   gradient norm, launches against `step_launches`;
36. the seq axis with tensor parallelism, run after phase 33: four gloo
   processes sharing the card (`chip_smoke.py --seqtp-rank`) on a mesh of
   tensor 2 x seq 2 train phase 33c's model (full width, depth 2, layer 1
   compressed) for 2 steps at B = 2 from 1024px features, against phase
   33c's one-process run under its limits (faults, each on the
   tensor-sharded parameters alone: their gradients counted on both seq
   ranks in the clip's norm; tensor rank 1's fc1 shard read from rank 0's
   columns); each rank's launches against `step_launches` at its token
   shard; s/step beside one process's, and the staged transports per step.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, without a card or outside the repository, or if any phase fails.
"""

from __future__ import annotations

import contextlib
import hashlib
import json
import os
import shutil
import subprocess
import sys
import tempfile
import time

# H100 SXM published peaks (NVIDIA data sheet): dense bf16 tensor-core rate
# and HBM3 bandwidth
PEAK_BF16_FLOPS = 989e12
PEAK_BYTES = 3.35e12
# Kernel vs plain version, per batch element b (tests/test_torch_kernels_gpu.py
# holds the card tests to the same limits):
#   |err| <= ELEM_TOL * (|want| + rms_b(want))
#   ||err||_b / ||want||_b <= L2_TOL
# A sound kernel reads at most 0.035 and 3.4e-3 at the shapes below, a
# planted fault 0.26 and 5.8e-2 or more (PERF.md); the backward kernels read
# at most 0.038 and 1.7e-3, their faults 0.42 and 6.3e-2 or more.
ELEM_TOL = 2**-4
L2_TOL = 1e-2
# The onepass kernel's row logsumexp against its plain version: max |err| in
# log2 units. A sound kernel reads at most 2e-6, the planted fault lse + 1
# reads 1.
LSE_TOL = 2**-10
PATH_REL_TOL = 3e-2  # 256px trajectory, kernels vs plain attention, relative L2
# one training step's gradients at 256px, kernels vs plain attention, relative
# L2 over all parameters and of the worst parameter (readings 1.9e-3, 5.2e-3)
GRAD_REL_TOL = 2e-2
# the 2K gate's gradient of q, k and v in flash's layers, per image and
# 128-row tile, kernels vs plain attention, relative L2 (worst tile: sound
# 1.1e-2; planted faults 0.44 and 1.0)
GRAD_TILE_TOL = 5e-2
TRAIN_CONFIG = "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_internalms_kvcompress.py"
CONFIG_2K = "configs/pixart_sigma_config/PixArt_sigma_xl2_img2K_internalms_kvcompress.py"
STEPS_4K = 2
TRAIN_STEPS = 4
TRAIN_STEPS_2K = 4
# launches of one training step, counted by hand: every block launches dkv
# and dq twice (self and cross), allheads twice (forward and its recompute)
# and onepass once more for the cross backward; its self-attention forward
# and recompute run onepass at 1024px (4096 or 4080 keys) and in the 2K
# config's KV-compressed layers 14-27, flash in its layers 0-13
TRAIN_STEP_LAUNCHES = {"onepass": 84, "allheads": 56, "flash_bwd_dkv": 56, "flash_bwd_dq": 56,
                       "flash_forward": 0, "headsmajor": 0}
TRAIN_2K_STEP_LAUNCHES = {"onepass": 56, "allheads": 56, "flash_bwd_dkv": 56,
                          "flash_bwd_dq": 56, "flash_forward": 28, "headsmajor": 0}
MASKED_TOY_CONFIG = "configs/toy/pixart_toy_img128_masked.py"
# the samplers of phase 5b at the upstream CLI's step counts
# (scripts/inference.py: iddpm 100, sa-solver 25; dpm-solver, deis and
# sde-dpm-solver 20; the LCM and DMD apps 4 and 1)
SAMPLER_STEPS = {"deis": 20, "sde-dpm-solver": 20, "sa-solver": 25, "iddpm": 100,
                 "lcm": 4, "dmd": 1}
# the traced trajectories (phases 5b, 6 and 20) stop here: the profiler's
# processing on the host grows with the steps (44 s for iDDPM's 100 and
# SA-Solver's 25 on the card's host), the per-step shares do not; cut from
# 10 when phase 36 came
TRACED_STEPS = 5
SAMPLER_TIMED = 3  # warm calls per sampler whose median is its time
# T5-XXL in bf16 against its f32 copy on the card, per caption over its
# valid tokens, relative L2 (sound 1.8e-2; dropping layer 0's position bias
# 0.71, the key mask 1.37; PERF.md)
T5_REL_TOL = 0.1
# the SDXL-VAE encoder on the card against the host's CPU, f32 with TF32
# off, relative L2 of the mean and the log-variance (sound 5.1e-6; the
# symmetric-pad fault 0.87; PERF.md)
VAE_REL_TOL = 1e-3
CONFIG_512 = "configs/pixart_sigma_config/PixArt_sigma_xl2_img512_internalms.py"
TRAIN_512_BATCH = 32  # the config's batch, beside T5-XXL and the VAE
TRAIN_STEPS_512 = 4
# one 512px step (no KV compression; 1024 or 1008 keys): as at 1024px
TRAIN_512_STEP_LAUNCHES = TRAIN_STEP_LAUNCHES
# valid caption tokens of the 32 captions in phase 3's 512px training shapes
CAPTIONS_512 = (300, 120, 77, 41, 19, 5, 3, 0) * 4
TURBO_CONFIG = "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_serving_turbo.py"
PEAK_INT8_OPS = 1979e12  # dense int8 tensor-core rate (NVIDIA data sheet)
# the int8 linear on the card against its plain version on the CPU, at a
# block's shapes: the int32 accumulators must be equal bit for bit, and the
# bf16 outputs are gated per row (elementwise as ELEM_TOL, and relative L2)
INT8_ELEM_TOL = 2**-9
INT8_L2_TOL = 1e-4
# a cached 1024px trajectory's latents against the exact bf16 ones, relative
# L2. The exact model's interval-2 latents must lie within CACHE_L2_TOL, and
# the planted fault "the cache stores out, not out - h", planted in that same
# variant, beyond it: the limit sits between the two readings (PERF.md).
# The fault must also read at least CACHE_FAULT_RATIO times turbo's reading.
CACHE_L2_TOL = 7e-2
CACHE_FAULT_RATIO = 2.5
# phase 21: a batched request's PNG against the same request served alone,
# mean |difference| in uint8 levels; the planted fault (the row's latent
# drawn from another seed) must read at least 10x the limit
SERVE_PNG_TOL = 0.5
# phase 21's throughput window: this many same-signature turbo requests sent
# at once to the server at max batch 4, so the queue never runs dry
SERVE_WINDOW = 16


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3, queued: bool = True) -> float:
    """ms per call of fn, from CUDA events around `iters` calls. `queued`:
    the calls queue behind a device sleep of ~0.2 ms per call, so the
    reading is the device's time back to back and leaves out the wrapper's
    host time (argument checks, tensor-map encodes, the ctypes call), which
    would otherwise set the pace of a kernel shorter than it. Without
    `queued` the host enqueues the calls as they come, and the reading is
    the larger of the device time and the host time per call."""
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    if queued:
        torch.cuda._sleep(int(iters * 4e5))  # clock cycles, ~1.98 GHz
    start.record()
    for _ in range(iters):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / iters


def bound_ms(flops: float, nbytes: float) -> tuple[float, str]:
    t_ops, t_bytes = flops / PEAK_BF16_FLOPS, nbytes / PEAK_BYTES
    return max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"


class Cases:
    """Seeded bf16 inputs at the path's shapes (B = 2 prompts x CFG)."""

    def __init__(self, dev):
        import torch

        self.torch = torch
        self.dev = dev
        self.gen = torch.Generator(device=dev).manual_seed(0)

    def randn(self, *shape, dtype=None):
        t = self.torch
        return t.randn(shape, generator=self.gen, device=self.dev).to(dtype or t.bfloat16)

    def lengths_mask(self, lengths, M):
        """[B, M] key mask: an int L keeps keys [0, L), a pair (lo, hi) only
        keys [lo, hi) (a caption mask that is not a prefix)."""
        t = self.torch
        spans = [(0, x) if isinstance(x, int) else x for x in lengths]
        lo, hi = (t.tensor(col, device=self.dev)[:, None] for col in zip(*spans))
        keys = t.arange(M, device=self.dev)[None]
        return (keys >= lo) & (keys < hi)

    def onepass(self, B, N, M, H=16, Dh=72, dtype=None):
        """q/k/v as the model hands them over: q (and k/v when M == N) are
        column slices of one qkv output; compressed k/v are contiguous."""
        C = H * Dh
        qkv = self.randn(B, N, 3 * C, dtype=dtype)
        q, k, v = (x.unflatten(-1, (H, Dh)) for x in qkv.chunk(3, dim=-1))
        if M != N:
            k = self.randn(B, M, H, Dh, dtype=dtype)
            v = self.randn(B, M, H, Dh, dtype=dtype)
        return q, k, v

    def allheads(self, B, N, M, lengths, H=16, Dh=72, dtype=None):
        C = H * Dh
        q = self.randn(B, N, C, dtype=dtype)
        kv = self.randn(B, M, 2 * C, dtype=dtype)  # hoisted caption K/V
        return q, kv[..., :C], kv[..., C:], self.lengths_mask(lengths, M), H


def readings(got, want) -> tuple[float, float, float]:
    """(max |err|, worst elementwise reading err / (|want| + rms_b(want)),
    worst relative L2 error of a batch element); inf if got is not finite."""
    torch_ = sys.modules["torch"]
    g, w = got.float(), want.float()
    if not bool(torch_.isfinite(g).all()):
        return (float("inf"),) * 3
    dims = tuple(range(1, w.dim()))
    err = g - w
    rms = w.pow(2).mean(dims, keepdim=True).sqrt()
    # a batch element whose wanted output is all zeros (a bf16 gradient of a
    # caption with no valid key) reads 0 when the kernel gives zeros too
    elem = float((err.abs() / (w.abs() + rms).clamp_min(1e-30)).max())
    l2 = float((err.pow(2).sum(dims).sqrt() / w.pow(2).sum(dims).sqrt().clamp_min(1e-30)).max())
    return float(err.abs().max()), elem, l2


def passes(r) -> bool:
    return r[1] <= ELEM_TOL and r[2] <= L2_TOL


def planted_faults(q, k, v, mask, tile, n_heads=None, extent=False) -> dict:
    """The plain version's output with a fault planted: the second key tile
    [tile, 2 tile) skipped (`tile`: the kernel's keys per tile; planted when
    there are more than `tile` keys), the logits scaled by
    Dh_pad^-0.5 = 80^-0.5 instead of Dh^-0.5, and, with `extent`, the key
    extent one tile short: each batch element's tile that holds its last
    valid key skipped. q/k/v are [B, N, H, Dh], or the flat [B, N, C] layout
    when n_heads is set."""
    from pixart_sigma_tpu_torch.ops.flash_attention import attention_reference as ref

    torch_ = sys.modules["torch"]
    if n_heads:
        q, k, v = (x.unflatten(-1, (n_heads, -1)) for x in (q, k, v))
    B, M, _, Dh = k.shape
    with_mask = lambda keep: keep if mask is None else keep & mask
    out = {}
    if M > tile:
        keep = torch_.ones((B, M), dtype=torch_.bool, device=k.device)
        keep[:, tile:2 * tile] = False
        out[f"key tile [{tile}, {2 * tile}) skipped"] = ref(q, k, v, with_mask(keep))
    out["logit scale 80^-0.5"] = ref((q.float() * (Dh / 80) ** 0.5).to(q.dtype), k, v, mask)
    if extent:
        keep = torch_.ones((B, M), dtype=torch_.bool, device=k.device)
        for b in range(B):
            valid = mask[b].nonzero()
            if len(valid):
                t0 = int(valid[-1]) // tile * tile
                keep[b, t0:t0 + tile] = False
        out["extent one tile short"] = ref(q, k, v, with_mask(keep))
    return {n: o.flatten(2) if n_heads else o for n, o in out.items()}


def compare(name, got, want, faults) -> tuple[float, bool]:
    """Log the kernel's readings and those of each planted fault; True when the
    kernel passes and every fault fails."""
    r = readings(got, want)
    ok = passes(r)
    log(f"  {name}: max_abs_err={r[0]:.3e} elem={r[1]:.3e} (tol {ELEM_TOL:.3e}) "
        f"rel_l2={r[2]:.3e} (tol {L2_TOL:.0e}) {'ok' if ok else 'MISMATCH'}")
    for fault, out in faults.items():
        rf = readings(out, want)
        caught = not passes(rf)
        ok &= caught
        log(f"    planted fault, {fault}: elem={rf[1]:.3e} rel_l2={rf[2]:.3e} "
            f"{'rejected' if caught else 'NOT REJECTED'}")
    return r[0], ok


def check_lse(name, got, want) -> bool:
    """The kernel's lse against the plain one, and the fault lse + 1."""
    torch_ = sys.modules["torch"]
    err = float((got - want).abs().max()) if bool(torch_.isfinite(got).all()) else float("inf")
    fault = float(((want + 1) - want).abs().max())
    ok = err <= LSE_TOL < fault
    log(f"  {name} lse: max_abs_err={err:.3e} log2 units (tol {LSE_TOL:.3e}) "
        f"{'ok' if err <= LSE_TOL else 'MISMATCH'}; planted fault, lse + 1: {fault:.3e} "
        f"{'rejected' if fault > LSE_TOL else 'NOT REJECTED'}")
    return ok


def extent_short(fa, madd):
    """The mask bias with each caption's key extent one tile short: the
    backward kernels' key tile (BWD_KEY_TILE) that holds the last valid key
    set to -inf, so P = 0 there (a caption with no valid key is left as it
    is)."""
    torch_ = sys.modules["torch"]
    tile = fa.BWD_KEY_TILE
    out = madd.clone()
    for b in range(madd.shape[0]):
        valid = (madd[b] > fa.NEG_INF / 2).nonzero()
        if len(valid):
            t0 = int(valid[-1]) // tile * tile
            out[b, t0:t0 + tile] = float("-inf")
    return out.to(torch_.float32)


def check_backward(fa, cases, label, B, N, M, lengths, dtype, cross) -> tuple[dict, bool]:
    """The onepass output (masked when `cross`: the launch the allheads
    backward recomputes through) and lse, then dkv and dq, each against its
    plain version on the same inputs, and the same checks on plain outputs
    with planted faults: for the output those of `planted_faults`; for dkv
    and dq a query tile [64, 128) skipped in the dK/dV sweep (its P set to
    0), the lse off by one log2 unit and, with a key mask, the key extent one
    tile short (`extent_short`). Returns ({kernel: max |err|}, ok)."""
    torch_ = sys.modules["torch"]
    if cross:
        qf, kf, vf, mask, H = cases.allheads(B, N, M, lengths, dtype=dtype)
        q, k, v = (x.unflatten(-1, (H, -1)) for x in (qf, kf, vf))
    else:
        q, k, v = cases.onepass(B, N, M, dtype=dtype)
        mask = None
    madd = None if mask is None else fa.mask_bias(mask)
    do = cases.randn(*q.shape, dtype=dtype)
    # f32 inputs: the kernels multiply q, k, v and dO rounded to bf16, so the
    # plain version is given the same rounded values (ROADMAP Queue 3)
    pq, pk, pv, pdo = (x.to(torch_.bfloat16).to(dtype) for x in (q, k, v, do))
    out, lse = fa._onepass_forward(q, k, v, madd, with_lse=True)
    torch_.cuda.synchronize()
    out_want, lse_want = fa._plain_forward(pq, pk, pv, madd)
    errs = {}
    errs["onepass"], ok = compare(f"{label} onepass output", out, out_want,
                                  planted_faults(pq, pk, pv, mask, fa.KEY_TILE))
    ok &= check_lse(label, lse, lse_want)
    del out_want, lse_want
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    madd_b = None if madd is None else madd.to(dtype).float()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, madd_b, lse, delta)
    dq = fa.flash_bwd_dq(q, k, v, do, madd_b, lse, delta)
    torch_.cuda.synchronize()
    ref = lambda l, m=madd_b: fa.flash_backward_reference(pq, pk, pv, m, l, delta, pdo)
    want = ref(lse)
    skipped = lse.clone()
    skipped[:, :, 64:128] = float("inf")
    faults = {"query tile [64, 128) skipped": ref(skipped), "lse + 1": ref(lse + 1)}
    if madd_b is not None:
        faults["key extent one tile short"] = ref(lse, extent_short(fa, madd_b))
    for kname, got, idx in (("dkv", dk, 1), ("dkv", dv, 2), ("dq", dq, 0)):
        err, good = compare(f"{label} {kname} d{'qkv'[idx]}", got, want[idx],
                            {f: o[idx] for f, o in faults.items()})
        errs[kname] = max(errs.get(kname, 0.0), err)
        ok &= good
    return errs, ok


def backward_launch(fa, q, k, v, do, flash):
    """The forward's out and lse, then dkv and dq, as a training step runs
    them: the flash Function's (q pre-scaled, logit scale 1, chain factor
    ln 2, its key-block tail) or onepass's (scale Dh^-0.5 log2(e)). Returns
    (q as the kernels read it, lse, delta, scales, dq, dk, dv)."""
    torch_ = sys.modules["torch"]
    M = k.shape[1]
    if flash:
        q = fa._flash_scale_q(q)
        out, lse = fa._flash_forward(q, k, v, None, fa._flash_tail(M, None), with_lse=True)
        scales = (1.0, fa.LN2)
    else:
        out, lse = fa._onepass_forward(q, k, v, None, with_lse=True)
        scales = (None, None)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, None, lse, delta, *scales)
    dq = fa.flash_bwd_dq(q, k, v, do, None, lse, delta, *scales)
    torch_.cuda.synchronize()
    return q, lse, delta, scales, dq, dk, dv


def check_backward_long(fa, cases, label, N, M, flash, picks) -> tuple[dict, bool]:
    """dkv and dq at a 2K training shape (B = 4, H = 16, Dh = 72), launched
    whole (`backward_launch`) and held against the plain backward on picks
    (b, h, rows, keys): dQ of those query rows against all keys, dK and dV
    of those keys against all queries (the whole plain version would hold a
    [B, H, N, M] f32 tensor, 68 GB at N = M = 16384). Faults: query tile
    [64, 128) skipped and lse + 1. Returns ({kernel: max |err|}, ok)."""
    torch_ = sys.modules["torch"]
    B, H, Dh = 4, 16, 72
    q, k, v = cases.onepass(B, N, M)
    do = cases.randn(B, N, H, Dh)
    q, lse, delta, scales, dq, dk, dv = backward_launch(fa, q, k, v, do, flash)
    skipped = lse.clone()
    skipped[:, :, 64:128] = float("inf")
    lses = {"want": lse, "query tile [64, 128) skipped": skipped, "lse + 1": lse + 1}
    out = {name: {"dq": [], "dk": [], "dv": []} for name in lses}
    got = {"dq": [], "dk": [], "dv": []}
    every = slice(None)
    for b, h, rows, keys in picks:
        one = lambda x, span: x[b:b + 1, span, h:h + 1]
        stat = lambda x, span: x[b:b + 1, h:h + 1, span]
        got["dq"].append(one(dq, rows)[0])
        got["dk"].append(one(dk, keys)[0])
        got["dv"].append(one(dv, keys)[0])
        for name, l in lses.items():
            w = fa.flash_backward_reference(one(q, rows), one(k, every), one(v, every), None,
                                            stat(l, rows), stat(delta, rows), one(do, rows),
                                            *scales)
            out[name]["dq"].append(w[0][0])
            w = fa.flash_backward_reference(one(q, every), one(k, keys), one(v, keys), None,
                                            stat(l, every), stat(delta, every), one(do, every),
                                            *scales)
            out[name]["dk"].append(w[1][0])
            out[name]["dv"].append(w[2][0])
    errs, ok = {}, True
    for grad, kname in (("dk", "dkv"), ("dv", "dkv"), ("dq", "dq")):
        stack = lambda xs: torch_.stack(xs)
        err, good = compare(f"{label} {grad}", stack(got[grad]), stack(out["want"][grad]),
                            {f: stack(o[grad]) for f, o in out.items() if f != "want"})
        errs[kname] = max(errs.get(kname, 0.0), err)
        ok &= good
    return errs, ok


# ---- the long-sequence kernels (flash, headsmajor) against their plain versions


def add_spike(q, k, rows, keys, amp=1.1, seed=0) -> None:
    """In place: query rows `rows` and keys `keys` of every (batch, head) get
    amp * u_h for one random direction u_h per head, which raises their
    logits by ~8.5 amp^2 (natural units) over the rest, so those rows put
    most of their weight on those keys and a fault there shows."""
    torch_ = sys.modules["torch"]
    gen = torch_.Generator(device=q.device).manual_seed(seed)
    u = torch_.randn(q.shape[2], q.shape[3], generator=gen, device=q.device) * amp
    q[:, rows] += u.to(q.dtype)
    k[:, keys] += u.to(k.dtype)


def pick_rows(x, picks):
    """[S, n, 1, Dh] stack of x[b, rows, h] for (b, h, rows) in picks."""
    torch_ = sys.modules["torch"]
    return torch_.stack([x[b, rows, h : h + 1] for b, h, rows in picks])


def flash_plain(fa, qs, k, v, madd, s=None):
    """The plain flash function on pre-scaled q (or on logits s): (out, lse)."""
    s = fa._logits(qs, k, madd, scale=1.0) if s is None else s
    return fa._softmax_pv(s, v, fa._flash_tail(k.shape[1], None), qs.dtype)


def flash_plain_faults(fa, qs, k, v, madd, tile: int, tail0: int, width: int) -> dict:
    """The plain flash output of a [S, n, 1, Dh] subset with one fault
    planted in each: the kernel's key tile number `tile` (`width` keys)
    skipped, the online-softmax rescale dropped where that tile arrives
    (earlier keys keep the old max), the ragged tail keys [tail0, M) lost,
    and the logit scale 80^-0.5."""
    torch_ = sys.modules["torch"]
    M = k.shape[1]
    s = fa._logits(qs, k, madd, scale=1.0)
    keys = torch_.arange(M, device=qs.device)
    t0 = tile * width
    run = s[..., : M // width * width].unflatten(-1, (-1, width)).amax(-1).cummax(-1).values
    run = run.clamp_min(fa.NEG_INF)  # the running max starts from -1e30
    jump = (run[..., tile] - run[..., tile - 1])[..., None]
    logits = {
        f"key tile [{t0}, {t0 + width}) skipped":
            s.masked_fill((keys >= t0) & (keys < t0 + width), float("-inf")),
        "rescale dropped at that tile": s + torch_.where(keys < t0, jump, 0.0),
    }
    if tail0 < M:
        logits[f"ragged tail [{tail0}, {M}) lost"] = s.masked_fill(keys >= tail0, float("-inf"))
    out = {name: flash_plain(fa, qs, k, v, madd, x)[0] for name, x in logits.items()}
    scaled = (qs.float() * (qs.shape[-1] / 80) ** 0.5).to(qs.dtype)
    out["logit scale 80^-0.5"] = flash_plain(fa, scaled, k, v, madd)[0]
    return out


def check_flash(fa, cases, label, B, N, M, lengths, dtype, picks, tile, width,
                H=16, Dh=72):
    """flash_attention on the whole input (with the lse, as the training
    launch), held against its plain version on the (b, h, rows) picks, with
    the planted faults of `flash_plain_faults`. Query rows [0, 64) attend
    mainly to the kernel's key tile number `tile` (`width` keys); rows
    [64, 128) to the ragged tail, if any. Returns (max |err|, ok)."""
    torch_ = sys.modules["torch"]
    q, k, v = cases.onepass(B, N, M, H, Dh, dtype=dtype)
    tail0 = M // width * width
    add_spike(q, k, slice(0, 64), slice(tile * width, (tile + 1) * width))
    if tail0 < M:
        add_spike(q, k, slice(64, 128), slice(tail0, M), seed=1)
    mask = None if lengths is None else cases.lengths_mask(lengths, M)
    qs, madd = fa._flash_scale_q(q), fa._flash_madd(mask, dtype)
    out, lse = fa._flash_forward(qs, k, v, madd, fa._flash_tail(M, None), with_lse=True)
    torch_.cuda.synchronize()
    whole = [(b, h, slice(None)) for b, h, _ in picks]
    qp, kp, vp = pick_rows(qs, picks), pick_rows(k, whole), pick_rows(v, whole)
    mp = None if madd is None else torch_.stack([madd[b] for b, _, _ in picks])
    if dtype == torch_.float32:  # the kernel rounds them to bf16 (ROADMAP Queue 3)
        qp, kp, vp = (x.to(torch_.bfloat16).float() for x in (qp, kp, vp))
    want, lse_want = flash_plain(fa, qp, kp, vp, mp)
    got = pick_rows(out, picks)
    lse_got = torch_.stack([lse[b, h : h + 1, rows] for b, h, rows in picks])
    err, ok = compare(label, got, want,
                      flash_plain_faults(fa, qp, kp, vp, mp, tile, tail0, width))
    finite = torch_.isfinite(lse_want)
    ok &= bool(torch_.equal(finite, torch_.isfinite(lse_got)))
    ok &= check_lse(label, lse_got[finite], lse_want[finite])
    return err, ok


def check_flash_grad(fa, cases, B, N, M, lengths, H=16, Dh=72) -> tuple[dict, bool]:
    """A gradient through the flash autograd Function (bf16) against the plain
    backward on the kernel's own lse, with the faults of check_backward: a
    query tile skipped, and the lse off by one log2 unit."""
    torch_ = sys.modules["torch"]
    q, k, v = cases.onepass(B, N, M, H, Dh)
    mask = cases.lengths_mask(lengths, M)
    do = cases.randn(B, N, H, Dh)
    args = [x.detach().clone().requires_grad_() for x in (q, k, v)]
    counts = (fa.flash_attention.launches, fa.flash_bwd_dkv.launches, fa.flash_bwd_dq.launches)
    fa.flash_attention(*args, key_mask=mask).backward(do)
    torch_.cuda.synchronize()
    launched = (fa.flash_attention.launches - counts[0], fa.flash_bwd_dkv.launches - counts[1],
                fa.flash_bwd_dq.launches - counts[2])
    qs, madd, tail = fa._flash_scale_q(q), fa._flash_madd(mask, q.dtype), fa._flash_tail(M, None)
    out, lse = fa._flash_forward(qs, k, v, madd, tail, with_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    c = fa._flash_q_scale(Dh, q.dtype)

    def plain(l):
        dqs, dk, dv = fa.flash_backward_reference(qs, k, v, madd, l, delta, do, 1.0, fa.LN2)
        return dqs * c, dk, dv

    want = plain(lse)
    skipped = lse.clone()
    skipped[:, :, 64:128] = float("inf")
    faults = {"query tile [64, 128) skipped": plain(skipped), "lse + 1": plain(lse + 1)}
    label = f"flash grad B*H={B * H} N={N} M={M} valid={lengths}"
    log(f"  {label}: one backward launched flash/dkv/dq {launched} (expected (1, 1, 1))")
    ok = launched == (1, 1, 1)
    errs = {}
    for name, got, idx in (("dkv", args[1].grad, 1), ("dkv", args[2].grad, 2),
                           ("dq", args[0].grad, 0)):
        err, good = compare(f"{label} d{'qkv'[idx]}", got, want[idx],
                            {f: o[idx] for f, o in faults.items()})
        errs[name] = max(errs.get(name, 0.0), err)
        ok &= good
    return errs, ok


KERNEL_GROUPS = (  # kernel-name substrings -> the layer they belong to
    ("flash_fwd_kernel", "flash attention kernel"),
    ("headsmajor_kernel", "headsmajor attention kernel"),
    ("onepass_kernel", "onepass attention kernel"),
    ("allheads_kernel", "allheads attention kernel"),
    ("dkv_kernel", "flash backward dK/dV kernel"),
    ("dq_kernel", "flash backward dQ kernel"),
    ("conv", "convolutions (patch embed, KV compression; VAE, VGG)"),
    ("fprop", "convolutions (patch embed, KV compression; VAE, VGG)"),
    ("dgrad", "convolutions (patch embed, KV compression; VAE, VGG)"),
    ("wgrad", "convolutions (patch embed, KV compression; VAE, VGG)"),
    ("gemm", "matmuls (projections, MLP)"), ("nvjet", "matmuls (projections, MLP)"),
    ("xmma", "matmuls (projections, MLP)"), ("cutlass", "matmuls (projections, MLP)"),
    ("layer_norm", "layer norms"), ("norm", "layer norms"),
)


def trace(fn, what: str, card: str, host_ops: bool = True) -> None:
    """fn() under torch.profiler: device time by layer and the device's idle
    share of the wall time. host_ops=False records the device activity only,
    for long trajectories: with every host op recorded, a 100-step one takes
    over twice as long to tabulate."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    activities = [ProfilerActivity.CUDA] + ([ProfilerActivity.CPU] if host_ops else [])
    with profile(activities=activities) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # user annotations (the optimizer's "Optimizer.step#CAME.step" span) carry
    # the device time of the kernels inside them, which are counted anyway
    annotations = set() if not host_ops else {
        e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in prof.key_averages()
               if e.device_type == torch.autograd.DeviceType.CUDA
               and e.key not in annotations and not e.key.startswith("Optimizer.")]
    busy_us = sum(e.self_device_time_total for e in kernels)
    if busy_us == 0:
        log("[trace] the profiler recorded no device time")
        return
    groups: dict = {}
    for e in kernels:
        key = next((g for s, g in KERNEL_GROUPS if s in e.key.lower()), "elementwise and other")
        groups[key] = groups.get(key, 0.0) + e.self_device_time_total
    log(f"[trace] {card}: {what}, wall {wall:.4f} s, device busy "
        f"{busy_us / 1e6:.4f} s, idle share {1 - busy_us / 1e6 / wall:.3f}")
    for name, us in sorted(groups.items(), key=lambda kv: -kv[1]):
        log(f"  {name}: {us / 1e3:.2f} ms ({us / busy_us:.3f} of device time)")
    for e in sorted(kernels, key=lambda e: -e.self_device_time_total)[:10]:
        log(f"  kernel {e.key[:90]}: {e.self_device_time_total / 1e3:.2f} ms, {e.count} launches")


def set_attn_impl(model, impl: str) -> None:
    for mod in model.modules():
        if hasattr(mod, "attn_impl"):
            mod.attn_impl = impl



TRAIN_COUNTERS = {"onepass": "onepass_attention", "allheads": "crossattn_allheads",
                  "flash_bwd_dkv": "flash_bwd_dkv", "flash_bwd_dq": "flash_bwd_dq",
                  "flash_forward": "flash_attention", "headsmajor": "crossattn_headsmajor"}


def reset_train_counts(fa) -> None:
    for attr in TRAIN_COUNTERS.values():
        getattr(fa, attr).launches = 0


def train_counts(fa) -> dict:
    return {name: getattr(fa, attr).launches for name, attr in TRAIN_COUNTERS.items()}


def step_launches(mc, hw) -> dict:
    """Kernel launches of one training micro-step of model config `mc` on a
    latent of `hw`, reckoned from the kernels' gates as this script reads
    them, not from the port's dispatch: a block's self-attention runs flash
    past 4096 padded keys (128-key tiles) or at a head dim of 128, else
    onepass (`self_attention_kernel`); its cross-attention
    (at most 512 caption keys) allheads; a checkpointed block whose remat
    policy does not keep the attention outputs ("nothing", "dots",
    "dots_no_batch") runs both forwards again in the backward; each backward
    launches dkv and dq once, and the cross-attention's first recomputes out
    and lse with one onepass launch. Masked training runs the blocks on the
    kept tokens. headsmajor, forward-only, never runs in training."""
    h, w = hw[0] // mc.patch_size, hw[1] // mc.patch_size
    n = int(h * w * (1 - mc.mask_ratio)) if mc.mask_ratio > 0 else h * w
    if mc.model_max_length > 512:
        raise SystemExit(f"step_launches: {mc.model_max_length} caption keys exceed allheads")
    runs = 2 if mc.grad_checkpointing and mc.remat_policy in ("nothing", "dots",
                                                              "dots_no_batch") else 1
    out = dict.fromkeys(TRAIN_COUNTERS, 0)
    dh = mc.hidden_size // mc.num_heads
    for i in range(mc.depth):
        sr = mc.sr_ratio(i)
        keys = n if sr == 1 else (h // sr) * (w // sr)
        out[self_attention_kernel(keys, dh)] += runs
        out["allheads"] += runs
        out["onepass"] += 1
        out["flash_bwd_dkv"] += 2
        out["flash_bwd_dq"] += 2
    return out


def run_launches(mc, hws) -> dict:
    """step_launches summed over the latents of a run's micro-steps."""
    total = dict.fromkeys(TRAIN_COUNTERS, 0)
    for hw in hws:
        for k, v in step_launches(mc, hw).items():
            total[k] += v
    return total


def perturb_zero_leaves(model, gen) -> None:
    """Zero-initialised cross-attention projections and final linear would
    make a fresh model ignore its input."""
    import torch

    with torch.no_grad():
        for block in model.blocks:
            block.cross_attn.proj.weight.normal_(0.0, 0.02, generator=gen)
        model.final_layer.linear.weight.normal_(0.0, 0.02, generator=gen)


def run_training(dev, card, fa, config: str, sizes, resolution: int, steps: int, tag: str,
                 buckets: str, per_step: dict) -> dict:
    """The port's Trainer on `config` at its operating point on a synthetic
    feature dataset of images of `sizes` (its aspect buckets); the run's
    launches must be `steps` x `per_step`, the fixed counts of one step, and
    the reckoning of step_launches. Returns the kernel launches of the run."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
    from pixart_sigma_tpu_torch.training.train_step import train_step
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="pixart_train_")
    try:
        t0 = time.perf_counter()
        write_feature_dataset(os.path.join(tmp, "data"), sizes, resolution=resolution,
                              valid_tokens=(3, 19), seed=0)
        log(f"[{tag}] {config}: synthetic Sigma features for {len(sizes)} items in "
            f"{time.perf_counter() - t0:.1f} s: buckets {buckets}; 300-token captions with "
            "3-19 valid")
        cfg = read_config(config)
        cfg.data_root = tmp
        cfg.data = dict(cfg.data, root="data", load_vae_feat=True, load_t5_feat=True)
        cfg.update(log_interval=1, save_model_steps=0, save_model_epochs=10**9)
        trainer = Trainer(cfg, os.path.join(tmp, "work"), device=dev)
        mc = trainer.model.cfg
        log(f"[{tag}] PixArtMS_XL_2 depth {mc.depth} width {mc.hidden_size}, input "
            f"{mc.input_size}, pe interpolation {mc.pe_interpolation}, kv-compress "
            f"{mc.kv_compress_sampling} x{mc.kv_compress_scale} on layers "
            f"{mc.kv_compress_layers[0]}-{mc.kv_compress_layers[-1]}, batch "
            f"{cfg.train_batch_size}, grad checkpointing {mc.grad_checkpointing} "
            f"({mc.remat_policy}), f32 weights, {str(mc.dtype).split('.')[-1]} compute, CAME lr "
            f"{trainer._base_lr:.3g} (auto-scaled), clip {cfg.gradient_clip}, EMA "
            f"{cfg.ema_rate} with warmup")
        perturb_zero_leaves(trainer.model, torch.Generator(device=dev).manual_seed(0))
        before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        reset_train_counts(fa)
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        state = trainer.train(max_steps=steps)
        torch.cuda.synchronize()
        launches = train_counts(fa)
        peak = torch.cuda.max_memory_allocated() / 2**30
        expect = run_launches(mc, [h["hw"] for h in trainer.history])
        for h in trainer.history:
            log(f"[{tag}] step {h['step']}: latents {h['hw']}, loss {h['loss']:.5f} "
                f"(mse {h['mse']:.5f}, vb {h['vb']:.5f}), grad norm {h['grad_norm']:.4f}, "
                f"lr {h['lr']:.3e}, {h['seconds']:.4f} s")
        per_hw = {hw: step_launches(mc, hw) for hw in sorted({h["hw"] for h in trainer.history})}
        log(f"[{tag}] launches {launches}; reckoned {expect} ({steps} steps, per step "
            f"{per_hw}; fixed per step {per_step})")
        moved = sum(not torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())
        ema_moved = sum(not torch.equal(state.ema[n], before[n]) for n in before)
        log(f"[{tag}] parameters changed: {moved} of {len(before)}; EMA tensors changed: "
            f"{ema_moved}; peak memory {peak:.2f} GiB")
        if not all(np.isfinite(h["loss"]) for h in trainer.history):
            raise SystemExit(f"{tag}: training loss is not finite")
        fixed = {k: steps * v for k, v in per_step.items()}
        if state.step != steps or launches != expect or launches != fixed:
            raise SystemExit(f"{tag}: training ran {state.step} steps with launches {launches}, "
                             f"{steps} x {per_step} expected")
        if moved < len(before) // 2 or ema_moved < len(before) // 2:
            raise SystemExit(f"{tag}: training left the parameters or the EMA unchanged")
        for hw in sorted({h["hw"] for h in trainer.history}):
            secs = [h["seconds"] for h in trainer.history[1:] if h["hw"] == hw]
            if secs:
                mean = sum(secs) / len(secs)
                log(f"[time] {card}: {tag} step at latents {hw} (B = "
                    f"{cfg.train_batch_size}): {mean:.4f} s/step, "
                    f"{cfg.train_batch_size / mean:.3f} img/s (steps after the first: "
                    f"{', '.join(f'{x:.4f}' for x in secs)} s)")
        log(f"[time] {card}: {tag} peak memory {peak:.2f} GiB")
        batch = trainer.prepare_batch(next(iter(trainer.build_loader())))
        trace(lambda: train_step(state, trainer.diffusion, batch, generator=trainer.generator,
                                 grad_clip=cfg.gradient_clip),
              f"one {tag} step, latents {tuple(batch['latents'].shape[1:3])}, "
              f"B = {cfg.train_batch_size}", card)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def step_gradients(dev, fa, model_kw: dict, hw, lengths, t, drop, faults=None,
                   watch=()) -> tuple:
    """One training step's gradients (bf16 compute, f32 weights, seeded
    random weights and inputs) through the kernels and through plain
    attention (attn_impl="reference"), with the same t, noise and drops.
    Returns the readings, the kernel run's launches, the model config, and
    the readings with each planted fault of `faults`, {name: context manager
    factory}, in place while the kernels run. The readings are the relative
    L2 over all parameters, the worst parameter's (reading, name), and for
    the blocks of `watch` the worst (reading, where) of the gradient of the
    self-attention's q, k and v (the qkv projection's output), taken per
    image and per 128-row tile of tokens, so that one tile's fault shows."""
    import torch

    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2, init_weights
    from pixart_sigma_tpu_torch.training.train_step import compute_losses

    gen = torch.Generator(device=dev).manual_seed(3)
    model = PixArtMS_XL_2(device=dev, train=True, **model_kw)
    init_weights(model, gen)
    perturb_zero_leaves(model, gen)
    B = len(lengths)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    lengths = torch.tensor(lengths, device=dev)
    batch = {"latents": randn(B, *hw, 4), "y": randn(B, 300, 4096),
             "y_mask": (torch.arange(300, device=dev)[None] < lengths[:, None]).int()}
    t, drop = torch.tensor(t, device=dev), torch.tensor(drop, device=dev)
    noise = randn(B, *hw, 4)
    diffusion = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    qkv_grads = {}

    def capture(i):
        def hook(mod, inp, out):
            out.register_hook(lambda g: qkv_grads.__setitem__(i, g.detach().float()))
        return hook

    for i in watch:
        model.blocks[i].attn.qkv.register_forward_hook(capture(i))

    def grads(impl):
        set_attn_impl(model, impl)
        model.zero_grad(set_to_none=True)
        qkv_grads.clear()
        compute_losses(model, diffusion, batch, t, noise, force_drop_ids=drop)["loss"].backward()
        return ({n: p.grad.detach().clone() for n, p in model.named_parameters()},
                dict(qkv_grads))

    def tile_worst(got_qkv):
        worst = (0.0, "")
        for i in watch:
            got, ref = got_qkv[i].chunk(3, -1), want_qkv[i].chunk(3, -1)
            for name, g, r in zip("qkv", got, ref):
                for b in range(B):
                    for j in range(0, g.shape[1], 128):
                        rt = r[b, j:j + 128]
                        rel = float((g[b, j:j + 128] - rt).norm() / rt.norm().clamp_min(1e-30))
                        worst = max(worst, (rel, f"block {i} d{name} image {b} rows {j}-"
                                               f"{min(j + 128, g.shape[1]) - 1}"))
        return worst

    def readings(got):
        got, got_qkv = got
        diff = sum(float((got[n] - want[n]).pow(2).sum()) for n in want)
        norm = sum(float(want[n].pow(2).sum()) for n in want)
        worst = max((float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30)), n)
                    for n in want)
        return (diff / norm) ** 0.5, worst, tile_worst(got_qkv)

    want, want_qkv = grads("reference")
    reset_train_counts(fa)
    got = grads("auto")
    launches = train_counts(fa)
    sound = readings(got)
    del got
    faulty = {}
    for name, patch in (faults or {}).items():
        with patch():
            faulty[name] = readings(grads("auto"))
    return sound, launches, model.cfg, faulty


def gradient_check(dev, fa) -> None:
    """One training step's gradients at 256px (depth 4, KV compression on
    layers 2-3, B = 4) through the kernels against plain attention."""
    (rel, worst, _), _, _, _ = step_gradients(
        dev, fa, dict(input_size=32, pe_interpolation=0.5, depth=4, model_max_length=300,
                      kv_compress_sampling="conv", kv_compress_scale=2, kv_compress_layers=(2, 3)),
        (32, 32), (19, 12, 7, 3), (10, 250, 600, 999), (0, 0, 0, 1))
    log(f"[train] 256px step gradients, kernels vs plain attention: relative L2 {rel:.3e} over "
        f"all parameters, worst parameter {worst[1]} {worst[0]:.3e} (tol {GRAD_REL_TOL})")
    if not rel <= GRAD_REL_TOL or not worst[0] <= GRAD_REL_TOL:
        raise SystemExit("256px training gradients disagree with plain attention")


def output_fault(fa, attr: str, keys: int, edit):
    """A context manager factory planting `edit` on the output of the backward
    wrapper `attr` of `fa` (flash_bwd_dq or flash_bwd_dkv) in its launches over
    `keys` keys (the self-attention's; the cross-attention's pass as they
    are)."""
    @contextlib.contextmanager
    def patch():
        orig = getattr(fa, attr)

        def faulty(q, k, *args, **kwargs):
            got = orig(q, k, *args, **kwargs)
            return edit(got) if k.shape[1] == keys else got

        faulty.launches = 0  # the wrapper counts on the module's name
        setattr(fa, attr, faulty)
        try:
            yield
        finally:
            setattr(fa, attr, orig)
    return patch


def gradient_check_2k(dev, fa) -> dict:
    """The 2K gradient gate: one training step's gradients through the
    kernels, flash's autograd Function in the model, against plain
    attention. The 2K config's model (input 256, pe interpolation 4) cut to
    depth 4 with KV compression on layers 2-3, B = 2, a 130x132 latent: 65x66
    = 4290 tokens, past the onepass gate (4352 padded keys) and not a
    multiple of the 128-key tile, so layers 0-1 run flash (its 512-key block
    leaves a tail of 318 keys) and its backward over tail tiles, layers 2-3
    onepass over 32x33 = 1056 keys. Gated: the parameters' gradients
    (GRAD_REL_TOL over all and for the worst), and the gradient of q, k and
    v of the flash layers 0-1 per image and 128-row tile (GRAD_TILE_TOL).
    Two planted faults in flash's backward must each fail it: dQ without its
    ln 2 chain factor, and dQ of the last query tile (the 66 tail rows)
    zeroed. Returns the launches."""
    n = 65 * 66
    flash_dq_fault = lambda edit: output_fault(fa, "flash_bwd_dq", n, edit)

    def zero_tail(dq):
        dq[:, n - n % fa.BWD_KEY_TILE:] = 0
        return dq

    def fails(r) -> bool:
        rel, worst, tile = r
        return not (rel <= GRAD_REL_TOL and worst[0] <= GRAD_REL_TOL and tile[0] <= GRAD_TILE_TOL)

    hw = (130, 132)
    sound, launches, mc, faulty = step_gradients(
        dev, fa, dict(input_size=256, pe_interpolation=4.0, depth=4, model_max_length=300,
                      kv_compress_sampling="conv", kv_compress_scale=2, kv_compress_layers=(2, 3)),
        hw, (19, 3), (120, 731), (0, 1),
        {"dQ without the ln 2 chain factor": flash_dq_fault(lambda dq: dq / fa.LN2),
         "dQ of the tail query tile zeroed": flash_dq_fault(zero_tail)}, watch=(0, 1))
    expect = step_launches(mc, hw)
    log(f"[grad2k] 2K model, depth 4, B = 2, latents {hw} ({n} tokens, 1056 compressed): "
        f"launches {launches}, reckoned {expect}")
    for name, r in [("none (sound)", sound)] + list(faulty.items()):
        rel, worst, tile = r
        log(f"[grad2k] planted fault {name}: parameters relative L2 {rel:.3e} over all, worst "
            f"{worst[1]} {worst[0]:.3e} (tol {GRAD_REL_TOL}); q/k/v gradient of flash layers "
            f"0-1, worst tile {tile[1]} {tile[0]:.3e} (tol {GRAD_TILE_TOL}): "
            f"{'rejected' if fails(r) else 'passes'}")
    if launches != expect or launches["flash_forward"] == 0:
        raise SystemExit(f"2K gradient gate launches {launches}, reckoned {expect}")
    if fails(sound):
        raise SystemExit("2K training gradients disagree with plain attention")
    if not all(fails(r) for r in faulty.values()):
        raise SystemExit("the 2K gradient gate missed a planted fault")
    return launches


def features_config(data_root: str, config: str = TRAIN_CONFIG, **overrides):
    from pixart_sigma_tpu_torch.config import read_config

    cfg = read_config(config)
    cfg.data_root = data_root
    cfg.data = dict(cfg.data, root="data", load_vae_feat=True, load_t5_feat=True)
    cfg.update(log_interval=1, save_model_steps=0, save_model_epochs=10**9, num_epochs=10,
               lr_schedule_args=dict(num_warmup_steps=1))
    cfg.update(overrides)
    return cfg


def counted_train(fa, trainer, steps: int) -> tuple:
    """trainer.train(steps) with the kernel counts set to 0 just before and
    read just after: (launches, the run's history records, peak GiB)."""
    import torch

    first = len(trainer.history)
    reset_train_counts(fa)
    torch.cuda.reset_peak_memory_stats()
    torch.cuda.synchronize()
    trainer.train(max_steps=steps)
    torch.cuda.synchronize()
    return (train_counts(fa), trainer.history[first:],
            torch.cuda.max_memory_allocated() / 2**30)


def run_features(dev, card, fa) -> dict:
    """The trainer features at 1024px on the operating point's config
    (configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_internalms_kvcompress.py,
    B = 4, full width) on synthetic features in the 1024x1024 and 1088x960
    buckets:
    a. at depth 4 (KV compression on layers 2-3), so that a checkpoint stays
       small: gradient accumulation 2, the loss-second-moment sampler,
       snr_gamma 5, the snr objective, Lion (lr 1e-4 before auto-scaling,
       weight decay 0.01), no_weight_decay_on (biases, norms, tables) and the
       balanced sampler; 4 micro-steps in one run against 2, a checkpoint, a
       new Trainer with resume_from="latest" and 2 more, which must give the
       same parameters, EMA, resampler ring, losses and buckets bit for bit;
    b. at full depth (28 blocks): `visualize` with a random SDXL VAE (the
       validation sampler writes PNGs at step 2), then each remat policy for
       2 steps with its peak memory, s/step and launches;
    c. configs/toy/pixart_toy_img128_masked.py (mask_ratio 0.25, mask_loss_coef
       1; batch 4) for 2 steps.
    Every run's launches are held against the reckoning. Returns the
    phase's launches by run."""
    import dataclasses

    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
    from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    t_phase = time.perf_counter()
    out = {}

    def check(label, launches, expect):
        log(f"[features] {label}: launches {launches}, reckoned {expect}")
        if launches != expect:
            raise SystemExit(f"features: {label} launches {launches}, reckoned {expect}")
        out[label] = launches

    tmp = tempfile.mkdtemp(prefix="pixart_features_")
    try:
        write_feature_dataset(os.path.join(tmp, "data"), [(1024, 1024)] * 4 + [(1088, 960)] * 4,
                              resolution=1024, valid_tokens=(3, 19), seed=1)
        # ---- a. the features, and a resume round trip
        feats = dict(
            gradient_accumulation_steps=2, schedule_sampler="loss-second-moment",
            snr_gamma=5.0, snr_loss=True, balanced_sampler=True,
            optimizer=dict(type="lion", lr=1e-4, weight_decay=0.01, betas=(0.9, 0.99)),
            no_weight_decay_on=["bias", "norm", "y_embedding", "scale_shift_table"],
            model_overrides=dict(depth=4, kv_compress_layers=(2, 3)))

        def trainer(name, **kw):
            tr = Trainer(features_config(tmp, **feats, **kw), os.path.join(tmp, name), device=dev)
            perturb_zero_leaves(tr.model, torch.Generator(device=dev).manual_seed(0))
            return tr

        whole = trainer("whole")
        mc = whole.model.cfg
        launches, hist, peak = counted_train(fa, whole, 4)
        check("depth 4, 4 micro-steps with the features", launches,
              run_launches(mc, [h["hw"] for h in hist]))
        groups = whole.state.optimizer.param_groups
        log(f"[features] Lion, {len(groups[0]['params'])} parameters decayed and "
            f"{len(groups[1]['params'])} exempt by no_weight_decay_on; optimizer updates "
            f"{whole.state.opt_step} of {whole.state.step} micro-steps (accumulation 2); "
            f"resampler ring filled for {int((whole.schedule_sampler.counts > 0).sum())} "
            f"timesteps; peak memory {peak:.2f} GiB")
        for h in hist:
            log(f"[features] micro-step {h['step']}: latents {h['hw']}, loss {h['loss']:.5f} "
                f"(mse {h['mse']:.5f}, vb {h['vb']:.5f}), grad norm {h['grad_norm']:.4f}, "
                f"lr {h['lr']:.3e}, {h['seconds']:.4f} s")
        if not all(np.isfinite(h["loss"]) for h in hist) or whole.state.opt_step != 2:
            raise SystemExit("features: the run with the features failed")
        part = trainer("part")
        counted_train(fa, part, 2)
        t0 = time.perf_counter()
        path = part.save(part.state.step, 0)
        size = os.path.getsize(path) / 2**30
        save_s = time.perf_counter() - t0
        resumed = trainer("part", resume_from=dict(checkpoint="latest"))
        launches, hist_r, _ = counted_train(fa, resumed, 2)
        check("depth 4, 2 micro-steps after the resume", launches,
              run_launches(mc, [h["hw"] for h in hist_r]))
        with torch.no_grad():
            d_param = max(float((p - dict(resumed.model.named_parameters())[n]).abs().max())
                          for n, p in whole.model.named_parameters())
            d_ema = max(float((e - resumed.state.ema[n]).abs().max())
                        for n, e in whole.state.ema.items())
        ring = (torch.equal(whole.schedule_sampler.history, resumed.schedule_sampler.history)
                and torch.equal(whole.schedule_sampler.counts, resumed.schedule_sampler.counts))
        losses = ([h["loss"] for h in whole.history[2:]], [h["loss"] for h in hist_r])
        buckets = ([h["hw"] for h in whole.history], [h["hw"] for h in part.history + hist_r])
        log(f"[features] resume round trip: checkpoint {size:.2f} GiB in {save_s:.2f} s; "
            f"4 micro-steps in one run vs 2 + resume + 2: largest parameter difference "
            f"{d_param:.3e}, EMA {d_ema:.3e} (limit 0: both runs are bit for bit); resampler "
            f"ring {'equal' if ring else 'differs'}; losses after the resume {losses[0]} vs "
            f"{losses[1]}; buckets {buckets[1]}; step {resumed.state.step}, optimizer updates "
            f"{resumed.state.opt_step}")
        if (resumed.state.step != 4 or resumed.state.opt_step != 2 or d_param != 0 or d_ema != 0
                or not ring or losses[0] != losses[1] or buckets[0] != buckets[1]):
            raise SystemExit("features: the resumed run differs from the uninterrupted one")
        del whole, part, resumed
        torch.cuda.empty_cache()

        # ---- b. validation sampling, then the remat policies, full depth
        torch.cuda.manual_seed(1)
        vae = build_vae(VAEConfig.sdxl(), device=dev)
        work = os.path.join(tmp, "full")
        full = Trainer(features_config(tmp, visualize=True, eval_sampling_steps=2,
                                       deterministic_validation=True), work, device=dev, vae=vae)
        perturb_zero_leaves(full.model, torch.Generator(device=dev).manual_seed(0))
        mc = full.model.cfg
        t0 = time.perf_counter()
        launches, hist, _ = counted_train(fa, full, 2)
        expect = run_launches(mc, [h["hw"] for h in hist])
        for k in ("onepass", "allheads"):  # 14 CFG model calls of the validation sampler
            expect[k] += mc.depth * 14
        check(f"depth {mc.depth}, 2 steps and validation at step 2", launches, expect)
        pngs = sorted(f for f in os.listdir(work) if f.endswith(".png"))
        imgs = [_read_png_size(os.path.join(work, f)) for f in pngs]
        log(f"[features] validation (DPM-Solver++ 14 steps, order 2, CFG "
            f"{full.config.cfg_scale}, EMA weights, 2 captions) wrote {pngs} ({imgs}) in a "
            f"{time.perf_counter() - t0:.2f} s run of 2 steps")
        if len(pngs) != 2 or any(size != (1024, 1024) for size in imgs):
            raise SystemExit(f"features: validation wrote {pngs}")
        full.config.visualize = False
        for policy in ("nothing", "dots", "dots_no_batch", "save_attn", "everything"):
            full.model.cfg = dataclasses.replace(mc, remat_policy=policy)
            launches, hist, peak = counted_train(fa, full, 2)
            secs = [h["seconds"] for h in hist]
            check(f"remat_policy {policy}, 2 steps", launches,
                  run_launches(full.model.cfg, [h["hw"] for h in hist]))
            log(f"[time] {card}: remat_policy {policy}: peak memory {peak:.2f} GiB, "
                f"{sum(secs) / len(secs):.4f} s/step ({', '.join(f'{x:.4f}' for x in secs)}), "
                f"attention launches per step {step_launches(full.model.cfg, hist[0]['hw'])}")
            if not all(np.isfinite(h["loss"]) for h in hist):
                raise SystemExit(f"features: remat_policy {policy} loss is not finite")
        del full, vae
        torch.cuda.empty_cache()

        # ---- c. the masked toy config
        write_feature_dataset(os.path.join(tmp, "toy"), [(128, 128)] * 8, resolution=128,
                              multi_scale=False, caption_channels=64, max_length=12, seed=2)
        toy = features_config(tmp, config=MASKED_TOY_CONFIG, train_batch_size=4)
        toy.data = dict(toy.data, root="toy")
        masked = Trainer(toy, os.path.join(tmp, "masked"), device=dev)
        launches, hist, _ = counted_train(fa, masked, 2)
        mc = masked.model.cfg
        check(f"masked toy (mask_ratio {mc.mask_ratio}, {mc.depth} blocks of {mc.hidden_size}), "
              "2 steps", launches, run_launches(mc, [h["hw"] for h in hist]))
        log(f"[features] masked toy: losses {[round(h['loss'], 5) for h in hist]}, removed-patch "
            f"terms {[round(h['mae'], 5) for h in hist]}")
        if not all(np.isfinite(h["loss"]) and h["mae"] > 0 for h in hist):
            raise SystemExit("features: the masked toy run failed")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[features] phase {time.perf_counter() - t_phase:.1f} s")
    return out


def _read_png_size(path: str) -> tuple:
    """(height, width) from a PNG's IHDR chunk."""
    import struct

    with open(path, "rb") as f:
        head = f.read(24)
    w, h = struct.unpack(">II", head[16:24])
    return h, w


def backward_times(cases, fa, card, launches: dict, errs: dict) -> list:
    """Each backward kernel at the 1024px training shapes and at the 2K ones
    (flash's backward at N = M = 16384, onepass's at N = 16384, M = 4096):
    its time (device time, and host-paced: the wrapper's operand checks and
    tensor-map encodes included), its plain version's (which computes dq, dk
    and dv at once; at 2K on the first 512 query rows of one (batch, head)
    against all its keys), the backward of `scaled_dot_product_attention`
    on the same inputs (timed only; it also computes all three) and the
    bound. Returns the two JSON entries."""
    import torch
    import torch.nn.functional as F

    B, H, Dh = 4, 16, 72
    rows = {"flash_bwd_dkv": [], "flash_bwd_dq": []}
    for label, N, M, lengths, flash in (("self", 4096, 4096, None, False),
                                        ("self", 4096, 1024, None, False),
                                        ("cross", 4096, 300, (19, 12, 7, 3), False),
                                        ("self seq shard", 2048, 4096, None, False),
                                        ("cross seq shard", 2048, 300, (19, 12, 7, 3), False),
                                        ("flash 2K", 16384, 16384, None, True),
                                        ("onepass 2K", 16384, 4096, None, False)):
        if lengths is None:
            q, k, v = cases.onepass(B, N, M)
            mask = None
        else:
            qf, kf, vf, mask, _ = cases.allheads(B, N, M, lengths)
            q, k, v = (x.unflatten(-1, (H, Dh)) for x in (qf, kf, vf))
        do = cases.randn(B, N, H, Dh)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        am = None if mask is None else mask[:, None, None, :]
        out_t = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        do_t = do.transpose(1, 2).contiguous()
        big = N > 4096
        iters = 5 if big else 20
        sdpa = lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t, retain_graph=True)
        lib_ms = cuda_ms(sdpa, iters=iters)
        lib_paced_ms = cuda_ms(sdpa, iters=iters, queued=False)
        del qt, kt, vt, out_t, do_t
        if mask is None:
            q, lse, delta, scales, *_ = backward_launch(fa, q, k, v, do, flash)
            madd_b = None
        else:
            madd = fa.mask_bias(mask)
            out, lse = fa._onepass_forward(q, k, v, madd, with_lse=True)
            delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
            madd_b, scales = madd.to(q.dtype).float(), (None, None)
            del out
        args = (q, k, v, do, madd_b, lse, delta, *scales)
        sub = slice(0, 512) if big else slice(None)  # the plain version's query rows
        plain_args = ((q[:1, sub, :1], k[:1, :, :1], v[:1, :, :1], None, lse[:1, :1, sub],
                       delta[:1, :1, sub], do[:1, sub, :1], *scales) if big else
                      (q, k, v, madd_b, lse, delta, do, *scales))
        plain_ms = cuda_ms(lambda: fa.flash_backward_reference(*plain_args), iters=3, warmup=1)
        plain_rows = 512 if big else B * N
        valid = B * M if mask is None else int(mask.sum())
        io = 2.0 * (2 * B * N * H * Dh + 2 * valid * H * Dh) + 4.0 * 2 * B * H * N
        for name, products, out_bytes in (("flash_bwd_dkv", 4, 2.0 * 2 * valid * H * Dh),
                                          ("flash_bwd_dq", 3, 2.0 * B * N * H * Dh)):
            fn = getattr(fa, name)
            ms = cuda_ms(lambda: fn(*args), iters=iters)
            paced_ms = cuda_ms(lambda: fn(*args), iters=iters, queued=False)
            flops = products * 2.0 * H * N * valid * Dh
            b_ms, by = bound_ms(flops, io + out_bytes)
            log(f"[time] {card}: {name} {label} B*H={B * H} N={N} M={M}"
                f"{'' if mask is None else f' ({valid} valid keys of {B * M})'}: kernel "
                f"{ms:.4f} ms ({paced_ms:.4f} ms host-paced), plain (dq, dk, dv) "
                f"{plain_ms:.4f} ms{f' on {plain_rows} query rows of one head' if big else ''}, "
                f"sdpa backward (dq, dk, dv) {lib_ms:.4f} ms ({lib_paced_ms:.4f} ms host-paced), "
                f"bound {b_ms:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
                f"{(io + out_bytes) / 1e6:.1f} MB), share of bound {b_ms / ms:.3f}")
            rows[name].append(dict(N=N, M=M, valid_keys=valid, ms=ms, host_paced_ms=paced_ms,
                                   plain_ms=plain_ms, plain_query_rows=plain_rows,
                                   bound_ms=b_ms, bound_by=by, library_ms=lib_ms,
                                   library_host_paced_ms=lib_paced_ms))
        del q, k, v, do, lse, delta, args, plain_args
        torch.cuda.empty_cache()
    entries = []
    for name, line, key in (("flash_bwd_dkv", 282, "dkv"), ("flash_bwd_dq", 326, "dq")):
        head = rows[name][0]
        entries.append({
            "name": name, "route": "cuda",
            "source": "pixart_sigma_tpu_torch/csrc/flash_backward.cu",
            "replaces": f"pixart_sigma_tpu/ops/flash_attention.py:{line}",
            "launches": launches[name], "max_abs_err": max(errs[key]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": rows[name],
        })
    return entries


FORWARD_KERNELS = {"onepass": "onepass_attention", "allheads": "crossattn_allheads",
                   "flash": "flash_attention", "headsmajor": "crossattn_headsmajor"}


def reset_forward_counts(fa) -> None:
    for attr in FORWARD_KERNELS.values():
        getattr(fa, attr).launches = 0


def forward_counts(fa) -> dict:
    return {name: getattr(fa, attr).launches for name, attr in FORWARD_KERNELS.items()}


def hires_launches(depth: int, compressed: int, steps: int, compressed_is_flash: bool) -> dict:
    """Forward launches of a 2K/4K trajectory, reckoned from the code: one
    model call per step; each block runs one cross-attention (allheads) and
    one self-attention, flash over the full token count, and onepass or flash
    over the KV-compressed keys (onepass while they fit its 4096-key gate)."""
    full = depth - compressed
    return {"onepass": 0 if compressed_is_flash else compressed * steps,
            "allheads": depth * steps, "headsmajor": 0,
            "flash": (full + (compressed if compressed_is_flash else 0)) * steps}


def sampler_nfe(sampler: str, steps: int) -> int:
    """Model calls of one trajectory, reckoned from the code: DEIS, the SDE
    solver and SA-Solver (few_steps) call the model at the start and after
    every step but the last, iDDPM and LCM once per step, DMD once; the CFG
    batch is one call."""
    return 1 if sampler == "dmd" else steps


def median_s(fn, n: int = SAMPLER_TIMED) -> tuple[float, list]:
    """The median of n timed calls of fn, in seconds, and each reading."""
    import statistics

    import torch

    times = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        times.append(time.perf_counter() - t0)
    return statistics.median(times), times


def run_samplers(dev, card, fa, pipe, model, prompts, negative) -> dict:
    """Phase 5b: the other samplers through PixArtPipeline at 1024px, each
    against its launch count, then a 256px trajectory against plain
    attention. Returns the launches of each sampler's 1024px run."""
    import numpy as np
    import torch

    t_phase = time.perf_counter()
    log("[samplers] PixArtMS_XL_2 1024px as phase 4, 2 prompts, negative prompt "
        f"{negative!r}, CFG 4.5 where the sampler guides (LCM and DMD do not), seed 0")
    masks = pipe.encode_prompts(prompts)[1].sum(1).tolist(), \
        pipe.encode_prompts([negative])[1].sum(1).tolist()
    log(f"[samplers] valid caption tokens: prompts {masks[0]}, negative {masks[1]}")
    if masks[1][0] in masks[0]:
        raise SystemExit("the negative prompt's mask equals a prompt's: iDDPM's mask "
                         "pairing would not show")
    launches = {}
    for name, steps in SAMPLER_STEPS.items():
        call = dict(sampler=name, num_inference_steps=steps, guidance_scale=4.5,
                    negative_prompt=negative, seed=0)
        nfe = sampler_nfe(name, steps)
        torch.cuda.synchronize()
        torch.cuda.reset_peak_memory_stats()
        reset_forward_counts(fa)
        fa.flash_bwd_dkv.launches = fa.flash_bwd_dq.launches = 0
        t0 = time.perf_counter()
        lat = pipe(prompts, return_latents=True, **call)
        torch.cuda.synchronize()
        first = time.perf_counter() - t0
        counts = forward_counts(fa)
        # under the names of the kernel entries
        counts.update(flash_forward=counts.pop("flash"), flash_bwd_dkv=fa.flash_bwd_dkv.launches,
                      flash_bwd_dq=fa.flash_bwd_dq.launches)
        img = pipe._latents_to_images(torch.from_numpy(lat[:1]).to(dev))
        torch.cuda.synchronize()
        peak = torch.cuda.max_memory_allocated() / 2**30
        launches[name] = counts
        expect = {"onepass": 28 * nfe, "allheads": 28 * nfe, "headsmajor": 0,
                  "flash_forward": 0, "flash_bwd_dkv": 0, "flash_bwd_dq": 0}
        log(f"[samplers] {name} {steps} steps, {nfe} model calls: latents {tuple(lat.shape)}, "
            f"std {lat.std():.4f}; launches {counts} (expected {expect})")
        if lat.shape != (2, 128, 128, 4) or not np.isfinite(lat).all() or lat.std() == 0:
            raise SystemExit(f"{name} latents are wrong, not finite or constant")
        if counts != expect:
            raise SystemExit(f"{name} kernel launches {counts}, expected {expect}")
        check_images(img, 1024, name)
        # the run above warmed this sampler's shapes; the times are medians of
        # SAMPLER_TIMED calls after it
        run = median_s(lambda: pipe(prompts, return_latents=True, **call))
        decode = median_s(lambda: pipe._latents_to_images(torch.from_numpy(lat[:1]).to(dev)))
        log(f"[time] {card}: {name} sampler {run[0] / 2:.4f} s/img ({steps} steps, 2 images; "
            f"median of {SAMPLER_TIMED} warm calls, each {[round(v / 2, 4) for v in run[1]]}; "
            f"first call {first / 2:.4f}), decode {decode[0]:.4f} s/img (1 image; each "
            f"{[round(v, 4) for v in decode[1]]}), peak memory {peak:.2f} GiB")

        small = dict(call, height=256, width=256, return_latents=True)
        lat_k = pipe(prompts, **small)
        set_attn_impl(model, "reference")
        try:
            lat_r = pipe(prompts, **small)
        finally:
            set_attn_impl(model, "auto")
        rel = float(np.linalg.norm(lat_k - lat_r) / np.linalg.norm(lat_r))
        log(f"[samplers] {name} 256px {steps}-step trajectory, kernels vs plain attention: "
            f"relative L2 {rel:.3e} (tol {PATH_REL_TOL})")
        if not np.isfinite(lat_k).all() or rel > PATH_REL_TOL:
            raise SystemExit(f"{name} 256px trajectory disagrees with plain attention")
    t_trace = time.perf_counter()
    for name in ("iddpm", "sa-solver"):
        steps = min(SAMPLER_STEPS[name], TRACED_STEPS)
        trace(lambda: pipe(prompts, return_latents=True, sampler=name, num_inference_steps=steps,
                           guidance_scale=4.5, negative_prompt=negative, seed=0),
              f"1024px {name} trajectory ({steps} steps, 2 images; device activity only)",
              card, host_ops=False)
    t_end = time.perf_counter()
    log(f"[samplers] phase 5b: {t_end - t_phase:.1f} s, of which the two traces "
        f"{t_end - t_trace:.1f} s")
    return launches


def check_images(imgs, side: int, what: str) -> None:
    import numpy as np

    if imgs.shape != (1, side, side, 3) or imgs.dtype != np.uint8:
        raise SystemExit(f"{what} images: {imgs.shape} {imgs.dtype}")
    if imgs.min() == imgs.max() or imgs.std() == 0:
        raise SystemExit(f"{what} images are constant")


def run_hires(dev, card, fa, cases, t5, vae, prompt, negative, max_err) -> dict:
    """Phases 6-8: the 2K path (20 steps, tiled decode to 2048px), the 4K
    path (the 2880 bucket table's 4096px square, STEPS_4K steps), and the
    flash kernel's times. Returns its JSON entry."""
    import numpy as np
    import torch
    import torch.nn.functional as F

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.models.pixart import init_weights
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline

    cfg = read_config(CONFIG_2K)
    model = build_model_from_config(cfg, device=dev)
    gen = torch.Generator(device=dev).manual_seed(2)
    init_weights(model, gen)
    perturb_zero_leaves(model, gen)
    mc = model.cfg
    n_comp = len(mc.kv_compress_layers)
    log(f"[2k] {CONFIG_2K}: PixArtMS_XL_2 {mc.depth} blocks x {mc.hidden_size}, input "
        f"{mc.input_size}, pe_interpolation {mc.pe_interpolation}, kv-compress "
        f"{mc.kv_compress_sampling} x{mc.kv_compress_scale} on layers "
        f"{mc.kv_compress_layers[0]}-{mc.kv_compress_layers[-1]}, bf16, seeded random weights")
    call = dict(guidance_scale=4.5, negative_prompt=negative, seed=0, return_latents=True)

    def run(pipe, steps):
        reset_forward_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = pipe([prompt], num_inference_steps=steps, **call)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        imgs = pipe._latents_to_images(torch.from_numpy(lat).to(dev))
        torch.cuda.synchronize()
        return lat, imgs, forward_counts(fa), t1 - t0, time.perf_counter() - t1

    # ---- 6. 2K
    pipe = PixArtPipeline(model, t5=t5, vae=vae, base_resolution=2048, device=dev)
    pipe([prompt], num_inference_steps=2, **call)  # warm the 2K shapes
    pipe._latents_to_images(torch.zeros((1, 64, 64, 4), device=dev))  # and the tile's
    torch.cuda.reset_peak_memory_stats()
    lat, imgs, counts, t_sample, t_decode = run(pipe, 20)
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect = hires_launches(mc.depth, n_comp, 20, compressed_is_flash=False)
    log(f"[2k] 20 steps, CFG 4.5: latents {tuple(lat.shape)}, images {imgs.shape} {imgs.dtype} "
        f"(25 tiles of 64 latents, overlap 16); launches {counts}, reckoned {expect}")
    if not np.isfinite(lat).all():
        raise SystemExit("2K latents are not finite")
    check_images(imgs, 2048, "2K")
    if counts != expect:
        raise SystemExit(f"2K launches {counts} != {expect}")
    launches = counts["flash"]
    log(f"[time] {card}: 2K sampler {t_sample:.4f} s/img, tiled decode {t_decode:.4f} s/img "
        f"(1 image, CFG batch 2, 20 steps), peak memory {peak:.2f} GiB")
    trace(lambda: pipe([prompt], num_inference_steps=TRACED_STEPS, **call),
          f"2K {TRACED_STEPS}-step trajectory (1 image, CFG batch 2)", card)

    # ---- 7. 4K through the 2880 table
    # the 2K phase built and warmed every kernel and the decode's tile shape;
    # the first call at 4K still sets up its own shapes, so a second call
    # after it times warm steps
    pipe = PixArtPipeline(model, t5=t5, vae=vae, base_resolution=2880, device=dev)
    torch.cuda.reset_peak_memory_stats()
    lat, imgs, counts, t_sample, t_decode = run(pipe, STEPS_4K)
    torch.cuda.synchronize()
    t0 = time.perf_counter()
    pipe([prompt], num_inference_steps=STEPS_4K, **call)
    torch.cuda.synchronize()
    t_warm = (time.perf_counter() - t0) / STEPS_4K
    peak = torch.cuda.max_memory_allocated() / 2**30
    expect = hires_launches(mc.depth, n_comp, STEPS_4K, compressed_is_flash=True)
    log(f"[4k] base_resolution 2880, {STEPS_4K} steps: latents {tuple(lat.shape)} "
        f"({lat.shape[1] // 2}x{lat.shape[2] // 2} tokens), images {imgs.shape} {imgs.dtype} "
        f"(121 tiles); launches {counts}, reckoned {expect}")
    if lat.shape != (1, 512, 512, 4) or not np.isfinite(lat).all():
        raise SystemExit("4K latents are wrong or not finite")
    check_images(imgs, 4096, "4K")
    if counts != expect:
        raise SystemExit(f"4K launches {counts} != {expect}")
    log(f"[time] {card}: 4K sampler, warm: {t_warm:.4f} s/step (a second {STEPS_4K}-step "
        f"call); first call, cold: {t_sample / STEPS_4K:.4f} s/step ({STEPS_4K} steps, "
        f"{t_sample:.4f} s); tiled decode {t_decode:.4f} s/img, peak memory {peak:.2f} GiB")
    del pipe, model, lat, imgs
    torch.cuda.empty_cache()

    # ---- 8. the flash kernel's times at the path shapes
    B, H, Dh = 2, 16, 72
    rows = []
    # N = 8192, M = 16384: a rank's query shard of the 2K self-attention over
    # 2 seq ranks (phase 33)
    for N, M, iters in ((16384, 16384, 20), (8192, 16384, 20), (65536, 65536, 3),
                        (65536, 16384, 5)):
        q, k, v = cases.onepass(B, N, M)
        kern = lambda: fa.flash_attention(q, k, v)
        sub = 1024  # the plain version holds [H, rows, M] f32 logits
        plain = lambda: fa.flash_reference_with_lse(q[:1, :sub], k[:1], v[:1])
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        library = lambda: F.scaled_dot_product_attention(qt, kt, vt)
        ms = cuda_ms(kern, iters=iters, warmup=1)
        plain_ms = cuda_ms(plain, iters=3, warmup=1)
        lib_ms = cuda_ms(library, iters=iters, warmup=1)
        flops = 4.0 * B * H * N * M * Dh
        nbytes = 2.0 * (2 * B * N * H * Dh + 2 * B * M * H * Dh)
        b_ms, by = bound_ms(flops, nbytes)
        log(f"[time] {card}: flash B*H={B * H} N={N} M={M}: kernel {ms:.4f} ms, plain "
            f"{plain_ms:.4f} ms on {sub} of the {B * N} query rows (1 batch element, all heads), "
            f"sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; {flops / 1e12:.3f} TFLOP, "
            f"{nbytes / 1e6:.1f} MB), share of bound {b_ms / ms:.3f}")
        rows.append(dict(N=N, M=M, ms=ms, plain_ms=plain_ms, plain_rows=sub, bound_ms=b_ms,
                         bound_by=by, library_ms=lib_ms))
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    head = rows[0]
    return {
        "name": "flash_forward", "route": "cuda",
        "source": "pixart_sigma_tpu_torch/csrc/flash_forward.cu",
        "replaces": "pixart_sigma_tpu/ops/flash_attention.py:64",
        "launches": launches, "launches_4k": counts["flash"], "max_abs_err": max_err,
        "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
        "bound_by": head["bound_by"], "library_ms": head["library_ms"], "shapes": rows,
    }


# ------------------------------------------------------------------------
# phases 15-19: the T5-XXL and SDXL-VAE encoders, serving with T5-XXL,
# 512px training from images and captions, the features round trip


class WordHashTokenizer:
    """A tokenizer called as an HF one, for runs without a vocabulary file
    (none is reachable): each word's id in [2, vocab_size) from a stable
    hash, the EOS id 1 appended, padded with 0 to max_length, truncated
    before the EOS."""

    def __init__(self, vocab_size: int = 32128):
        self.vocab_size = vocab_size

    def __call__(self, texts, max_length, padding="max_length", truncation=True,
                 return_tensors="np"):
        import numpy as np

        ids = np.zeros((len(texts), max_length), np.int64)
        mask = np.zeros((len(texts), max_length), np.int64)
        for i, text in enumerate(texts):
            toks = [2 + int.from_bytes(hashlib.sha256(w.encode()).digest()[:4], "little")
                    % (self.vocab_size - 2) for w in text.split()]
            toks = toks[: max_length - 1] + [1]
            ids[i, : len(toks)] = toks
            mask[i, : len(toks)] = 1
        return {"input_ids": ids, "attention_mask": mask}


class Timed:
    """`inner` with its method `name` timed: each call, synchronised with the
    card before and after, appends its seconds to `seconds`."""

    def __init__(self, inner, name: str):
        self.inner, self.name, self.seconds = inner, name, []

    def __getattr__(self, attr):
        fn = getattr(self.inner, attr)
        if attr != self.name:
            return fn
        torch = sys.modules["torch"]

        def timed(*args, **kwargs):
            torch.cuda.synchronize()
            t0 = time.perf_counter()
            out = fn(*args, **kwargs)
            torch.cuda.synchronize()
            self.seconds.append(time.perf_counter() - t0)
            return out

        return timed


def synthetic_captions(n: int, seed: int) -> list:
    """n captions of 5-60 words (some past 300 tokens would need more)."""
    import numpy as np

    words = ("a photo of the red fox small cactus with happy face mountain sunset lake "
             "astronaut jungle oil painting city street at night old wooden boat").split()
    rng = np.random.default_rng(seed)
    return [" ".join(rng.choice(words, int(rng.integers(5, 61)))) for _ in range(n)]


def rel_l2(got, want) -> float:
    return float((got.float() - want.float()).norm() / want.float().norm())


def run_t5(dev, card):
    """Phase 15: T5-XXL at full width (24 layers, d_model 4096, 64 heads of
    64, d_ff 10240, vocab 32128, 300 tokens) with seeded random weights in
    bf16, held against the port's own f32 encoder with the same weights on
    the card, per caption over its valid tokens, with two planted faults;
    encode times. Returns the bf16 `T5Embedder`."""
    import torch

    from pixart_sigma_tpu_torch.models.t5 import T5Config, T5Embedder, build_t5, init_weights
    from pixart_sigma_tpu_torch.utils.prompt import clean_caption

    t0 = time.perf_counter()
    cfg = T5Config.xxl()
    enc = build_t5(cfg, device=dev)
    init_weights(enc, torch.Generator(device=dev).manual_seed(0))
    torch.cuda.synchronize()
    n = sum(p.numel() for p in enc.parameters())
    log(f"[t5] T5-XXL encoder: {cfg.num_layers} layers, d_model {cfg.d_model}, "
        f"{cfg.num_heads} heads of {cfg.d_kv}, d_ff {cfg.d_ff}, vocab {cfg.vocab_size}: "
        f"{n / 1e9:.3f} B parameters, {n * 2 / 2**30:.2f} GiB in bf16, seeded random weights "
        f"(HF's scales, the bias table N(0, 1)) in {time.perf_counter() - t0:.1f} s; "
        "word-hash tokenizer, 300 tokens")
    emb = T5Embedder(enc, WordHashTokenizer(cfg.vocab_size), 300)
    captions = ["a watercolor painting of a lighthouse on a cliff at dusk",
                "blurry, low quality",
                " ".join(synthetic_captions(1, 1)),
                " ".join(synthetic_captions(20, 2))]  # past 300 tokens: truncated
    tok = emb.tokenizer([clean_caption(c) for c in captions], 300)
    ids = torch.from_numpy(tok["input_ids"]).to(dev)
    mask = torch.from_numpy(tok["attention_mask"]).to(dev)
    valid = mask.bool()
    lengths = valid.sum(1).tolist()
    with torch.no_grad():
        got = enc(ids, mask)
        ref = build_t5(T5Config.xxl(dtype=torch.float32), device=dev,
                       param_dtype=torch.float32)
        ref.load_state_dict(enc.state_dict())
        want = ref(ids, mask)
        del ref
        torch.cuda.empty_cache()
        table = enc.encoder.block[0].layer[0].SelfAttention.relative_attention_bias.weight
        kept = table.clone()
        table.zero_()
        no_bias = enc(ids, mask)
        table.copy_(kept)
        no_mask = enc(ids, torch.ones_like(mask))

    def reading(out):
        return max(rel_l2(out[b][valid[b]], want[b][valid[b]]) for b in range(len(captions)))

    sound = reading(got)
    ok = bool(torch.isfinite(got).all()) and sound <= T5_REL_TOL
    log(f"[t5] bf16 vs f32 (same weights, on the card), captions of {lengths} valid tokens: "
        f"worst relative L2 over the valid tokens {sound:.3e} (tol {T5_REL_TOL}) "
        f"{'ok' if ok else 'MISMATCH'}")
    for fault, out in (("layer 0's position bias dropped", no_bias),
                       ("key mask dropped", no_mask)):
        r = reading(out)
        caught = r > T5_REL_TOL
        ok &= caught
        log(f"    planted fault, {fault}: {r:.3e} {'rejected' if caught else 'NOT REJECTED'}")
    if not ok:
        raise SystemExit("T5-XXL bf16 disagrees with f32, or the check missed a planted fault")
    prompts = captions[:2]
    batch32 = synthetic_captions(32, 3)
    y, m = emb.get_text_embeddings(prompts)
    log(f"[t5] get_text_embeddings: y {tuple(y.shape)} {y.dtype} on {y.device}, mask "
        f"{tuple(m.shape)} {m.dtype}")
    if y.device.type != dev.type or y.dtype != torch.bfloat16 or \
            y.shape != (2, 300, cfg.d_model):
        raise SystemExit(f"T5Embedder output is not bf16 [2, 300, {cfg.d_model}] on {dev}")
    s2, r2 = median_s(lambda: emb.get_text_embeddings(prompts))
    torch.cuda.reset_peak_memory_stats()
    s32, r32 = median_s(lambda: emb.get_text_embeddings(batch32))
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[time] {card}: T5-XXL encode (clean, tokenize, encode; median of 3): 2 prompts "
        f"{s2:.4f} s ({', '.join(f'{x:.4f}' for x in r2)}), B = 32 captions {s32:.4f} s "
        f"({', '.join(f'{x:.4f}' for x in r32)}); peak memory {peak:.2f} GiB")
    return emb


def symmetric_pad(vae) -> list:
    """Plant the fault "symmetric pad": each stride-2 downsampling conv of the
    encoder padded by 1 on every side instead of (0, 1) x (0, 1). Returns the
    patched modules (`del m.forward` restores each)."""
    F = sys.modules["torch"].nn.functional
    patched = []
    for block in vae.encoder.down_blocks:
        if hasattr(block, "downsamplers"):
            d = block.downsamplers[0]
            d.forward = (lambda c: lambda h: F.conv2d(h, c.weight, c.bias, stride=2,
                                                      padding=1))(d.conv)
            patched.append(d)
    return patched


def run_vae_encoder(dev, card):
    """Phase 16: the SDXL-VAE encoder at full width (f32, TF32 off) with
    seeded random weights: a 256px batch on the card against the same
    weights on the host's CPU, with a planted fault; encode times at 512px,
    B = 32, and 1024px, B = 4. Returns the VAE."""
    import torch

    from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae

    torch.cuda.manual_seed(2)
    vae = build_vae(VAEConfig.sdxl(), device=dev)
    host = build_vae(VAEConfig.sdxl(), device="cpu")
    host.load_state_dict({k: v.cpu() for k, v in vae.state_dict().items()})
    gen = torch.Generator().manual_seed(0)
    x = torch.rand((2, 256, 256, 3), generator=gen) * 2 - 1
    t0 = time.perf_counter()
    with torch.no_grad():
        mean_h, logvar_h = host.encode(x)
        t_host = time.perf_counter() - t0
        mean, logvar = vae.encode(x.to(dev))
        patched = symmetric_pad(vae)
        mean_f, logvar_f = vae.encode(x.to(dev))
        for m in patched:
            del m.forward
    reading = lambda m, lv: max(rel_l2(m.cpu(), mean_h), rel_l2(lv.cpu(), logvar_h))
    sound, fault = reading(mean, logvar), reading(mean_f, logvar_f)
    ok = sound <= VAE_REL_TOL < fault and mean.shape == (2, 32, 32, 4)
    log(f"[vae] SDXL-VAE encoder, seeded random weights, f32: 256px B = 2 on the card vs the "
        f"host's CPU ({t_host:.1f} s there): mean {tuple(mean.shape)}, worst relative L2 of "
        f"mean and logvar {sound:.3e} (tol {VAE_REL_TOL:.0e}) {'ok' if sound <= VAE_REL_TOL else 'MISMATCH'}; "
        f"planted fault, symmetric pad before the stride-2 convs: {fault:.3e} "
        f"{'rejected' if fault > VAE_REL_TOL else 'NOT REJECTED'}")
    if not ok:
        raise SystemExit("the VAE encoder disagrees with the CPU, or the check missed the fault")
    del host
    for B, side in ((32, 512), (4, 1024)):
        xs = torch.rand((B, side, side, 3), device=dev) * 2 - 1
        torch.cuda.reset_peak_memory_stats()
        with torch.no_grad():
            s, r = median_s(lambda: vae.encode(xs))
        peak = torch.cuda.max_memory_allocated() / 2**30
        log(f"[time] {card}: VAE encode {side}px B = {B} (median of 3): {s:.4f} s, "
            f"{s / B:.4f} s/img ({', '.join(f'{x:.4f}' for x in r)}); peak memory {peak:.2f} GiB")
        del xs
        torch.cuda.empty_cache()
    return vae


def run_serving_t5(dev, card, fa, emb, vae, prompts, negative) -> dict:
    """Phase 17: phase 4's 1024px path (PixArtMS-XL-2 kvcompress, 20-step
    DPM-Solver++, CFG 4.5, 2 prompts and a negative prompt) with T5-XXL
    encoding the prompts, to uint8 images. Returns the checked call's
    launches."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2, init_weights
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline

    model = PixArtMS_XL_2(input_size=128, pe_interpolation=2.0, model_max_length=300,
                          kv_compress_sampling="conv", kv_compress_scale=2,
                          kv_compress_layers=tuple(range(14, 28)), device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    init_weights(model, gen)
    perturb_zero_leaves(model, gen)
    t5 = Timed(emb, "get_text_embeddings")
    pipe = PixArtPipeline(model, t5=t5, vae=vae, device=dev)
    call = dict(num_inference_steps=20, guidance_scale=4.5, negative_prompt=negative, seed=0)
    expect = 28 * 20
    torch.cuda.reset_peak_memory_stats()
    for run in ("checked", "timed"):
        t5.seconds.clear()
        reset_forward_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = pipe(prompts, return_latents=True, **call)
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        imgs = pipe._latents_to_images(torch.from_numpy(lat).to(dev))
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        counts = forward_counts(fa)
        if run == "checked":
            launches = dict(counts)
            if (imgs.shape != (2, 1024, 1024, 3) or imgs.dtype != np.uint8
                    or any(im.std() == 0 for im in imgs) or not np.isfinite(lat).all()):
                raise SystemExit(f"1024px with T5-XXL: images {imgs.shape} {imgs.dtype}, "
                                 "constant or not finite")
            if (counts["onepass"], counts["allheads"]) != (expect, expect) or \
                    counts["flash"] or counts["headsmajor"]:
                raise SystemExit(f"1024px with T5-XXL: launches {counts}")
    peak = torch.cuda.max_memory_allocated() / 2**30
    t_t5 = sum(t5.seconds)
    log(f"[serve] 1024px with T5-XXL encoding the prompts and the negative prompt: images "
        f"{imgs.shape} {imgs.dtype}; launches {launches} (expected onepass and allheads "
        f"{expect})")
    log(f"[time] {card}: 1024px with T5-XXL: T5 {t_t5 / len(t5.seconds):.4f} s/call "
        f"({len(t5.seconds)} calls: {', '.join(f'{x:.4f}' for x in t5.seconds)}), sampler "
        f"{(t1 - t0 - t_t5) / 2:.4f} s/img, decode {(t2 - t1) / 2:.4f} s/img, call to images "
        f"{(t2 - t0) / 2:.4f} s/img (2 images); peak memory with T5-XXL resident {peak:.2f} GiB")
    return launches


def run_training_512(dev, card, fa, emb, vae) -> tuple:
    """Phases 18 and 19: the 512px multi-scale config through Trainer at
    full width and depth from PNG images and their captions, encoded on the
    fly by T5-XXL and the SDXL VAE; then extract_features on the same items
    and one Trainer step from its files. Returns the launches of both."""
    import json as json_

    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.data.aspect import aspect_ratio_table, get_closest_ratio
    from pixart_sigma_tpu_torch.data.datasets import PixArtMSDataset
    from pixart_sigma_tpu_torch.data.synthetic import write_image_dataset
    from pixart_sigma_tpu_torch.tools.extract_features import extract_caption_t5, extract_img_vae
    from pixart_sigma_tpu_torch.training.train_step import train_step
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="pixart_train512_")
    try:
        sizes = [(600, 600)] * TRAIN_512_BATCH + [(700, 900)] * TRAIN_512_BATCH
        t0 = time.perf_counter()
        root = write_image_dataset(os.path.join(tmp, "data"), sizes, seed=0)
        table = aspect_ratio_table(512)
        buckets = sorted({tuple(int(v) for v in get_closest_ratio(h, w, table)[0])
                          for h, w in sizes})
        log(f"[train512] {len(sizes)} PNG images written in {time.perf_counter() - t0:.1f} s "
            f"(600x600 and 700x900, read with PIL through PixArtMSDataset: PIL imports on "
            f"the card), buckets {buckets}: {[(h // 16) * (w // 16) for h, w in buckets]} "
            "tokens; captions of 4-40 words, real_prompt_ratio 0.5")
        cfg = read_config(CONFIG_512)
        cfg.data_root = tmp
        cfg.data = dict(cfg.data, root="data")
        cfg.update(log_interval=1, save_model_steps=0, save_model_epochs=10**9,
                   train_batch_size=TRAIN_512_BATCH)
        t5, tvae = Timed(emb, "get_text_embeddings"), Timed(vae, "encode")
        trainer = Trainer(cfg, os.path.join(tmp, "work"), device=dev, vae=tvae, t5=t5)
        mc = trainer.model.cfg
        log(f"[train512] {CONFIG_512}: PixArtMS_XL_2 depth {mc.depth} width {mc.hidden_size}, "
            f"input {mc.input_size}, kv-compress {mc.kv_compress_sampling or 'none'}, batch "
            f"{cfg.train_batch_size}, grad checkpointing {mc.grad_checkpointing} "
            f"({mc.remat_policy}), CAME on the scan-stacked groups {mc.block_groups()}, lr "
            f"{trainer._base_lr:.3g} (auto-scaled), clip {cfg.gradient_clip}, load_vae_feat "
            f"{cfg.data['load_vae_feat']}, load_t5_feat {cfg.data['load_t5_feat']}")
        perturb_zero_leaves(trainer.model, torch.Generator(device=dev).manual_seed(0))
        t0 = time.perf_counter()
        launches, hist, peak = counted_train(fa, trainer, TRAIN_STEPS_512)
        wall = time.perf_counter() - t0
        expect = run_launches(mc, [h["hw"] for h in hist])
        fixed = {k: TRAIN_STEPS_512 * v for k, v in TRAIN_512_STEP_LAUNCHES.items()}
        for i, h in enumerate(hist):
            total = h["seconds"] + t5.seconds[i] + tvae.seconds[i]
            log(f"[train512] step {h['step']}: latents {h['hw']}, loss {h['loss']:.5f}, grad "
                f"norm {h['grad_norm']:.4f}; T5 {t5.seconds[i]:.4f} s + VAE encode "
                f"{tvae.seconds[i]:.4f} s + DiT step {h['seconds']:.4f} s = {total:.4f} s")
        log(f"[train512] launches {launches}; reckoned {expect}; fixed per step "
            f"{TRAIN_512_STEP_LAUNCHES}; per step at each bucket "
            f"{ {hw: step_launches(mc, hw) for hw in sorted({h['hw'] for h in hist})} }")
        if not all(np.isfinite(h["loss"]) for h in hist) or len(hist) != TRAIN_STEPS_512:
            raise SystemExit("train512: loss not finite or steps missing")
        if launches != expect or launches != fixed:
            raise SystemExit(f"train512: launches {launches}, reckoned {expect}, fixed {fixed}")
        B = cfg.train_batch_size
        for hw in sorted({h["hw"] for h in hist}):
            idx = [i for i, h in enumerate(hist) if h["hw"] == hw and i > 0]
            if idx:
                parts = [sum(x[i] for i in idx) / len(idx) for x in
                         (t5.seconds, tvae.seconds, [h["seconds"] for h in hist])]
                step = sum(parts)
                log(f"[time] {card}: train512 step at latents {hw} (B = {B}, steps after the "
                    f"first): {step:.4f} s/step, {B / step:.3f} img/s; T5 {parts[0]:.4f} s "
                    f"({parts[0] / step:.3f}), VAE encode {parts[1]:.4f} s "
                    f"({parts[1] / step:.3f}), DiT step {parts[2]:.4f} s ({parts[2] / step:.3f})")
        log(f"[time] {card}: train512 {TRAIN_STEPS_512} steps in {wall:.2f} s wall (loader, "
            f"first step included); peak memory {peak:.2f} GiB with T5-XXL and the VAE resident")
        batch = next(iter(trainer.build_loader()))
        step = trainer.state.step
        trace(lambda: train_step(trainer.state, trainer.diffusion,
                                 trainer.prepare_batch(batch, step), generator=trainer.generator,
                                 grad_clip=cfg.gradient_clip),
              f"one train512 step from images and captions (T5-XXL, VAE encode, DiT step), "
              f"B = {B}", card)
        del trainer, batch
        torch.cuda.empty_cache()

        # ---- 19. the features round trip ----
        with open(os.path.join(root, "data_info.json")) as f:
            meta = json_.load(f)
        t0 = time.perf_counter()
        with torch.no_grad():
            cap_dir = extract_caption_t5(root, meta, emb, batch=32)
            vae_dir = extract_img_vae(root, meta, vae, 512, multi_scale=True, batch=32)
        torch.cuda.synchronize()
        n_cap, n_vae = len(os.listdir(cap_dir)), len(os.listdir(vae_dir))
        log(f"[features-rt] extract_features on the {len(meta)} items: {n_cap} caption files "
            f"in {os.path.basename(cap_dir)}/, {n_vae} VAE files in "
            f"{os.path.basename(vae_dir)}/, {time.perf_counter() - t0:.2f} s")
        ds = PixArtMSDataset(root, resolution=512, aspect_ratio_type=512, load_vae_feat=True,
                             load_t5_feat=True, max_length=300, seed=cfg.seed)
        item = ds.getdata(0)
        _, m0 = emb.get_text_embeddings([meta[0]["prompt"]])
        if (n_cap, n_vae) != (len(meta), len(meta)) or item["latents"].shape != (64, 64, 4) \
                or item["y"].shape != (300, emb.cfg.d_model) or \
                not np.array_equal(item["y_mask"], m0[0].cpu().numpy()):
            raise SystemExit("features round trip: files or a dataset item are wrong")
        cfg2 = read_config(CONFIG_512)
        cfg2.data_root = tmp
        # only the real prompt's features are extracted, as upstream's tool
        cfg2.data = dict(cfg2.data, root="data", load_vae_feat=True, load_t5_feat=True)
        cfg2.update(log_interval=1, save_model_steps=0, save_model_epochs=10**9,
                    real_prompt_ratio=1.0, train_batch_size=TRAIN_512_BATCH)
        trainer = Trainer(cfg2, os.path.join(tmp, "work2"), device=dev)
        launches_rt, hist_rt, _ = counted_train(fa, trainer, 1)
        expect_rt = run_launches(trainer.model.cfg, [h["hw"] for h in hist_rt])
        log(f"[features-rt] one Trainer step from the extracted files through "
            f"PixArtMSDataset: latents {hist_rt[0]['hw']}, loss {hist_rt[0]['loss']:.5f}, "
            f"{hist_rt[0]['seconds']:.4f} s; launches {launches_rt}, reckoned {expect_rt}")
        if not np.isfinite(hist_rt[0]["loss"]) or launches_rt != expect_rt:
            raise SystemExit("features round trip: the step failed")
        del trainer
        torch.cuda.empty_cache()
        return launches, launches_rt
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


# phases 20-21: the turbo serving modes (dynamic int8 W8A8 products, delta
# block caching) and the port's HTTP server


def int8_products(dev, card, block) -> None:
    """Phase 20a: each int8 linear of `block` (qkv, proj, q_linear, fc1, fc2)
    on the card against its plain version on the CPU, on seeded bf16 rows of
    the 1024px CFG batch (2 prompts x CFG x 4096 tokens): the quantized
    operands and the int32 accumulator must be equal bit for bit, the bf16
    outputs within INT8_ELEM_TOL and INT8_L2_TOL per row, and two planted
    faults (the weight's scales per input channel; the weight quantized from
    its bf16 cast) must be rejected. Then the times of the int8 linear, its
    quantize pass and `_int_mm` beside the bf16 linear it replaces. First,
    which operand layouts `_int_mm` takes, which `check_int_mm` must match."""
    import torch
    import torch.nn.functional as F

    from pixart_sigma_tpu_torch.ops import quant

    gen = torch.Generator(device=dev).manual_seed(20)
    # the operand layouts _int_mm takes on this card, against check_int_mm
    q = lambda *shape: torch.randint(-127, 128, shape, generator=gen, device=dev,
                                     dtype=torch.int8)
    for label, a, b in (("A row-major, B column-major", q(32, 64), q(40, 64).t()),
                        ("A row-major, B row-major", q(32, 64), q(64, 40)),
                        ("A column-major, B row-major", q(64, 32).t(), q(64, 40)),
                        ("A column-major, B column-major", q(64, 32).t(), q(40, 64).t())):
        try:
            taken = torch.equal(torch._int_mm(a, b).cpu(),
                                quant.int8_accumulate_reference(a.cpu(), b.cpu()))
        except RuntimeError as e:
            taken, why = False, str(e).splitlines()[0][:100]
        try:
            quant.check_int_mm(a, b)
            checked = True
        except ValueError:
            checked = False
        log(f"[int8] _int_mm {label}: {'taken, exact' if taken else 'refused: ' + why}; "
            f"check_int_mm {'passes' if checked else 'raises'}")
        if taken != checked:
            raise SystemExit("check_int_mm disagrees with what _int_mm takes on this card")
    M = 2 * 2 * 4096
    layers = {"qkv": block.attn.qkv, "proj": block.attn.proj,
              "q_linear": block.cross_attn.q_linear, "fc1": block.mlp.fc1, "fc2": block.mlp.fc2}
    for name, lin in layers.items():
        K, N = lin.in_features, lin.out_features
        x = torch.randn((M, K), generator=gen, device=dev).to(torch.bfloat16)
        w, b = lin.weight.detach(), lin.bias.detach()
        qx, sx = quant.quantize_rows(x)
        qw, sw = lin.quantized_weight()
        acc = quant.int8_accumulate(qx, qw)
        got = lin(x)
        torch.cuda.synchronize()
        x_c, w_c, b_c = x.cpu(), w.cpu(), b.cpu()
        qx_c, sx_c = quant.quantize_rows(x_c)
        qw_c, sw_c = quant.quantize_weight(w_c)
        same_q = all(torch.equal(a.cpu(), c) for a, c in ((qx, qx_c), (sx, sx_c), (qw, qw_c),
                                                         (sw, sw_c)))
        same_acc = torch.equal(acc.cpu(), quant.int8_accumulate_reference(qx_c, qw_c))
        want = quant.int8_matmul_quantized(x_c, qw_c, sw_c, b_c)
        # planted faults, on the card: per-input-channel weight scales
        # (dequantized correctly), and the weight's bf16 cast quantized
        q_in, s_in = quant.quantize_rows(w.t())  # [in, out]: a scale per input channel
        deq = (qx.float() * sx) * s_in.t()
        fault_in = (deq @ q_in.float() + b.float()).to(torch.bfloat16)
        qw_b, sw_b = quant.quantize_weight(w.bfloat16())
        fault_bf16 = quant.int8_matmul_quantized(x, qw_b, sw_b, b)
        r = readings(got.cpu(), want)
        faults = {"scales per input channel": readings(fault_in.cpu(), want),
                  "weight quantized from its bf16 cast": readings(fault_bf16.cpu(), want)}
        ok = same_q and same_acc and r[1] <= INT8_ELEM_TOL and r[2] <= INT8_L2_TOL
        caught = {f: fr[1] > INT8_ELEM_TOL or fr[2] > INT8_L2_TOL for f, fr in faults.items()}
        log(f"[int8] {name} x [{M}, {K}] @ W [{K}, {N}]: quantized operands equal to the CPU's "
            f"{same_q}, int32 accumulator equal {same_acc}; output max|err| {r[0]:.3e}, "
            f"elementwise {r[1]:.3e} (tol {INT8_ELEM_TOL:.3e}), relative L2 {r[2]:.3e} (tol "
            f"{INT8_L2_TOL:.0e}); planted faults: "
            + ", ".join(f"{f} elementwise {fr[1]:.3e} L2 {fr[2]:.3e} "
                        f"{'rejected' if caught[f] else 'MISSED'}" for f, fr in faults.items()))
        if not ok or not all(caught.values()):
            raise SystemExit(f"int8 {name}: the card disagrees with the CPU, or a planted fault "
                             "passed")
        w_bf16, b_bf16 = w.bfloat16(), b.bfloat16()
        ms = {"int8 linear": cuda_ms(lambda: lin(x)),
              "quantize rows": cuda_ms(lambda: quant.quantize_rows(x)),
              "_int_mm": cuda_ms(lambda: torch._int_mm(qx, qw)),
              "bf16 linear": cuda_ms(lambda: F.linear(x, w_bf16, b_bf16))}
        t_ops, t_bytes = 2.0 * M * K * N / PEAK_INT8_OPS, (M * K + K * N + 4 * M * N) / PEAK_BYTES
        b_int8, by_int8 = max(t_ops, t_bytes) * 1e3, "operations" if t_ops >= t_bytes else "bytes"
        b_bf16, by_bf16 = bound_ms(2.0 * M * K * N, 2.0 * (M * K + K * N + M * N))
        log(f"[time] {card}: {name} [{M}, {K}] x [{K}, {N}]: int8 linear {ms['int8 linear']:.4f} "
            f"ms (quantize rows {ms['quantize rows']:.4f}, _int_mm {ms['_int_mm']:.4f}, bound "
            f"{b_int8:.4f} by {by_int8}), bf16 linear {ms['bf16 linear']:.4f} ms (bound "
            f"{b_bf16:.4f} by {by_bf16})")
        del x, qx, acc, got, fault_in, fault_bf16


def trace_turbo(fn, what: str, card: str) -> None:
    """fn() under torch.profiler with the int8 path's pieces annotated
    (`record_function` around `quantize_rows` and the whole int8 linear).
    Each device kernel is assigned by its time on the device: inside an
    annotation's device-side range it belongs to that range (the product
    kernel of an int8 linear is `_int_mm`, its other kernels outside the
    quantize pass the f32 epilogue), else to the bf16 matmuls, the attention
    kernels or the rest, by name. Prints the split and the device's idle
    share of the wall time."""
    import bisect

    import torch
    from torch.profiler import ProfilerActivity, profile, record_function

    from pixart_sigma_tpu_torch.models import layers
    from pixart_sigma_tpu_torch.ops import quant

    quantize, linear = quant.quantize_rows, layers.int8_matmul_quantized
    names = ("turbo::quantize_rows", "turbo::int8_linear")

    def quantize_traced(*a, **k):
        with record_function(names[0]):
            return quantize(*a, **k)

    def linear_traced(*a, **k):
        with record_function(names[1]):
            return linear(*a, **k)

    quant.quantize_rows, layers.int8_matmul_quantized = quantize_traced, linear_traced
    try:
        torch.cuda.synchronize()
        with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
            t0 = time.perf_counter()
            fn()
            torch.cuda.synchronize()
            wall = time.perf_counter() - t0
    finally:
        quant.quantize_rows, layers.int8_matmul_quantized = quantize, linear
    events = prof.events()
    on_device = [e for e in events if e.device_type == torch.autograd.DeviceType.CUDA]
    annotations = {e.name for e in events if getattr(e, "is_user_annotation", False)}
    kernels = [e for e in on_device if e.name not in annotations]
    spans = {n: sorted((e.time_range.start, e.time_range.end) for e in on_device if e.name == n)
             for n in names}

    def inside(n, k):
        starts = spans[n]
        i = bisect.bisect_right(starts, (k.time_range.start, float("inf"))) - 1
        return i >= 0 and k.time_range.end <= starts[i][1]

    matmul = ("gemm", "nvjet", "xmma", "cutlass")
    split = dict.fromkeys(("_int_mm", "quantize passes", "int8 epilogue", "bf16 matmuls",
                           "attention kernels", "other"), 0.0)
    for k in kernels:
        us = k.time_range.end - k.time_range.start
        low = k.name.lower()
        if inside(names[0], k):
            split["quantize passes"] += us
        elif inside(names[1], k):
            split["_int_mm" if any(m in low for m in matmul) else "int8 epilogue"] += us
        elif any(m in low for m in matmul):
            split["bf16 matmuls"] += us
        elif "onepass_kernel" in k.name or "allheads_kernel" in k.name:
            split["attention kernels"] += us
        else:
            split["other"] += us
    busy = sum(split.values()) / 1e3
    if busy == 0:
        raise SystemExit("[trace] the profiler recorded no device time")
    annotated = all(spans[n] for n in names) or not split["_int_mm"]
    log(f"[trace] {card}: {what}, wall {wall:.4f} s, device busy {busy / 1e3:.4f} s, idle "
        f"share {1 - busy / 1e3 / wall:.3f}; annotation ranges on the device "
        f"{[len(spans[n]) for n in names]}")
    for name, us in split.items():
        log(f"  {name}: {us / 1e3:.2f} ms ({us / 1e3 / busy:.3f} of device time)"
            + ("" if annotated else " (annotations missing: not separated)"))
    top: dict = {}
    for k in kernels:
        top.setdefault(k.name, [0.0, 0])
        top[k.name][0] += k.time_range.end - k.time_range.start
        top[k.name][1] += 1
    for name, (us, n) in sorted(top.items(), key=lambda kv: -kv[1][0])[:8]:
        log(f"  kernel {name[:90]}: {us / 1e3:.2f} ms, {n} launches")


class CallLog:
    """Counts a model's calls that run the cached span (a first call, or one
    told to recompute) and those that reuse the cache."""

    def __init__(self, models):
        self.full = self.reused = 0
        self.handles = [m.register_forward_pre_hook(self._hook, with_kwargs=True)
                        for m in models]

    def _hook(self, module, args, kwargs):
        if kwargs.get("block_cache") is not None and kwargs.get("use_block_cache"):
            self.reused += 1
        else:
            self.full += 1

    def reset(self):
        self.full = self.reused = 0

    def remove(self):
        for h in self.handles:
            h.remove()


def cached_launches(depth: int, span: tuple, full: int, reused: int) -> int:
    """onepass (= allheads) launches of a trajectory: one per layer of a full
    model call, none in the cached span of a call that reuses the cache."""
    return depth * full + (depth - (span[1] - span[0])) * reused


def cache_fault(model):
    """Plant "the cache stores out, not out - h": the compute branch's new
    cache gets the span's input h added back. Returns the hook handles."""
    k1 = model.cfg.cache_span[0]
    seen = {}

    def grab(module, args):
        seen["h"] = args[0]

    def plant(module, args, kwargs, output):
        if kwargs.get("block_cache") is None or kwargs.get("use_block_cache"):
            return output
        out, cache = output
        return out, cache + seen["h"].to(cache.dtype)

    return [model.blocks[k1].register_forward_pre_hook(grab),
            model.register_forward_hook(plant, with_kwargs=True)]


def run_turbo(dev, card, fa, prompts, negative) -> tuple:
    """Phase 20: the turbo serving config (PixArtMS-XL-2 kvcompress at
    1024px, int8, cache span) at full width and depth: the int8 products
    against the CPU; 20-step DPM-Solver++ CFG 4.5 trajectories exact, with
    the cache at interval 1 and with a schedule of every step (both must equal
    the exact latents bit for bit), at interval 2, at the adaptive threshold
    0.15, int8 alone and turbo (int8 + interval 2), each with its launches
    against the reckoning; the planted cache fault; s/img and a trace.
    Returns (launches by variant, the int8 model, the VAE, the text encoder)."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.models.pixart import init_weights
    from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
    from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline

    t_phase = time.perf_counter()
    config = read_config(TURBO_CONFIG)
    quant_model = build_model_from_config(config, device=dev)
    gen = torch.Generator(device=dev).manual_seed(0)
    init_weights(quant_model, gen)
    perturb_zero_leaves(quant_model, gen)
    exact_model = build_model_from_config(config, device=dev, quant_int8=False)
    exact_model.load_state_dict(quant_model.state_dict())
    mc = quant_model.cfg
    log(f"[turbo] {TURBO_CONFIG}: PixArtMS_XL_2 1024px, {mc.depth} blocks x {mc.hidden_size}, "
        f"quant_int8 {mc.quant_int8} (f32 master weights of the int8 linears), cache_span "
        f"{mc.cache_span}, seeded random weights; the exact model is the same weights in bf16")
    int8_products(dev, card, quant_model.blocks[0])

    torch.cuda.manual_seed(1)
    vae = build_vae(VAEConfig.sdxl(), device=dev)
    t5 = PseudoT5Embedder(dim=4096, model_max_length=300)
    pipes = {"exact": PixArtPipeline(exact_model, t5=t5, vae=vae, device=dev),
             "int8": PixArtPipeline(quant_model, t5=t5, vae=vae, device=dev)}
    call = dict(num_inference_steps=20, guidance_scale=4.5, negative_prompt=negative, seed=0,
                return_latents=True)
    variants = {  # name -> (pipeline, kwargs, (full, reused) model calls reckoned)
        "exact": ("exact", {}, (20, 0)),
        "schedule of every step": ("exact", dict(block_cache_schedule=list(range(20))), (20, 0)),
        "interval 2": ("exact", dict(block_cache_interval=2), (10, 10)),
        "threshold 0.15": ("exact", dict(block_cache_threshold=0.15), None),
        "int8": ("int8", {}, (20, 0)),
        "turbo": ("int8", dict(block_cache_interval=2), (10, 10)),
    }
    calls = CallLog([exact_model, quant_model])
    lats, launches = {}, {}
    for name, (pipe, kw, reckoned) in variants.items():
        reset_forward_counts(fa)
        calls.reset()
        lats[name] = pipes[pipe](prompts, **call, **kw)
        counts = forward_counts(fa)
        full, reused = calls.full, calls.reused
        if reckoned is not None and (full, reused) != reckoned:
            raise SystemExit(f"[turbo] {name}: {full} full and {reused} cached model calls, "
                             f"reckoned {reckoned}")
        want = cached_launches(mc.depth, mc.cache_span, full, reused)
        launches[name] = counts
        log(f"[turbo] {name}: {full} full model calls, {reused} reusing the cache; launches "
            f"{counts} (reckoned onepass and allheads {want} each)")
        if (counts["onepass"], counts["allheads"]) != (want, want) or counts["flash"] \
                or counts["headsmajor"]:
            raise SystemExit(f"[turbo] {name}: launches {counts}, reckoned {want}")
        if not np.isfinite(lats[name]).all() or lats[name].shape != (2, 128, 128, 4):
            raise SystemExit(f"[turbo] {name}: latents not finite or of the wrong shape")
        if name == "threshold 0.15" and not 2 <= full <= 20:
            raise SystemExit(f"[turbo] threshold 0.15: {full} refreshes; the first and last "
                             "calls always refresh")
    calls.remove()

    # interval 1 through the cached builder itself (__call__ takes the cache
    # from interval 2 on), from the initial latents __call__ draws
    pe = pipes["exact"]
    with torch.no_grad():
        y, y_mask = pe.encode_prompts(prompts)
        null_y, null_mask = pe.encode_prompts([negative] * 2)
        x = torch.randn((2, 128, 128, 4), generator=torch.Generator(device=dev).manual_seed(0),
                        device=dev)
        ones = torch.ones((2, 2), device=dev), torch.ones((2, 1), device=dev)
        lats["interval 1"] = pe._build_dpm_cached(20, 4.5, 1)(
            x, y, null_y, torch.cat([null_mask, y_mask]), *ones, None).cpu().numpy()
    for name in ("interval 1", "schedule of every step"):
        equal = np.array_equal(lats[name], lats["exact"])
        log(f"[turbo] {name} equals the exact latents bit for bit: {equal}")
        if not equal:
            raise SystemExit(f"[turbo] {name} differs from the uncached trajectory")
    handles = cache_fault(exact_model)
    try:
        lats["fault: cache stores out"] = pe(prompts, **call, block_cache_interval=2)
    finally:
        for h in handles:
            h.remove()
    exact = lats["exact"].astype(np.float64)
    rel = {name: float(np.linalg.norm(lat - exact) / np.linalg.norm(exact))
           for name, lat in lats.items() if name != "exact"}
    log("[turbo] relative L2 of the latents to the exact bf16 ones: " + ", ".join(
        f"{k} {v:.4e}" for k, v in rel.items()))
    fault = rel["fault: cache stores out"]
    log(f"[turbo] interval 2 (exact model) {rel['interval 2']:.4e} against the limit "
        f"{CACHE_L2_TOL:.0e}; the fault planted in that variant {fault:.4e} must lie beyond it "
        f"and read {CACHE_FAULT_RATIO}x turbo's {rel['turbo']:.4e}")
    if not rel["interval 2"] <= CACHE_L2_TOL < fault:
        raise SystemExit(f"[turbo] interval 2 reads {rel['interval 2']:.3e} and the planted "
                         f"cache fault {fault:.3e}: the limit {CACHE_L2_TOL:.0e} must lie "
                         "between them")
    if not fault >= CACHE_FAULT_RATIO * rel["turbo"]:
        raise SystemExit(f"[turbo] the planted cache fault reads {fault:.3e}, not "
                         f"{CACHE_FAULT_RATIO}x turbo's {rel['turbo']:.3e}")
    imgs = pipes["int8"]._latents_to_images(torch.from_numpy(lats["turbo"][:1]).to(dev))
    check_images(imgs, 1024, "turbo")

    times = {}
    for name in ("exact", "int8", "interval 2", "turbo"):
        pipe, kw, _ = variants[name]
        run = median_s(lambda: pipes[pipe](prompts, **call, **kw))
        times[name] = run[0] / 2
        log(f"[time] {card}: {name} sampler {run[0] / 2:.4f} s/img (20 steps, 2 images; median "
            f"of {SAMPLER_TIMED} warm calls, each {[round(v / 2, 4) for v in run[1]]})")
    decode = median_s(lambda: pipes["int8"]._latents_to_images(
        torch.from_numpy(lats["turbo"]).to(dev)))
    log(f"[time] {card}: decode {decode[0] / 2:.4f} s/img (2 images; median of "
        f"{SAMPLER_TIMED}, each {[round(v / 2, 4) for v in decode[1]]})")
    for name in ("exact", "turbo"):
        pipe, kw, _ = variants[name]
        trace_turbo(lambda: pipes[pipe](prompts, **dict(call, num_inference_steps=TRACED_STEPS),
                                        **kw),
                    f"1024px {name} trajectory ({TRACED_STEPS} steps, 2 images)", card)
    log(f"[turbo] phase 20: {time.perf_counter() - t_phase:.1f} s")
    del pipes, exact_model
    return launches, quant_model, vae, t5


class CountedPipe:
    """A pipeline whose calls record their size, options and kernel launches
    (the batcher runs one call at a time on its thread)."""

    def __init__(self, pipe, fa):
        self.pipe, self.fa, self.calls = pipe, fa, []

    def __getattr__(self, name):
        return getattr(self.pipe, name)

    def __call__(self, prompts, **kw):
        torch = sys.modules["torch"]
        reset_forward_counts(self.fa)
        t0 = time.perf_counter()
        out = self.pipe(prompts, **kw)
        torch.cuda.synchronize()
        self.calls.append(dict(rows=len(prompts), secs=time.perf_counter() - t0,
                               sampler=kw["sampler"],
                               steps=kw["num_inference_steps"],
                               interval=kw.get("block_cache_interval", 0),
                               counts=forward_counts(self.fa)))
        return out


def http(url, payload=None):
    """(status, headers, parsed JSON body) of a GET or, with a payload, a POST."""
    import urllib.error
    import urllib.request

    data = None if payload is None else json.dumps(payload).encode()
    req = urllib.request.Request(url, data=data, headers={"Content-Type": "application/json"})
    try:
        with urllib.request.urlopen(req, timeout=600) as resp:
            return resp.status, dict(resp.headers), json.loads(resp.read())
    except urllib.error.HTTPError as e:
        return e.code, dict(e.headers), json.loads(e.read())


def png_array(b64: str):
    import base64
    import io

    import numpy as np
    from PIL import Image

    return np.asarray(Image.open(io.BytesIO(base64.b64decode(b64))))


def serve_window(url, card, pipe, subjects) -> None:
    """The server's throughput: SERVE_WINDOW requests of one signature (1024px,
    20 steps, turbo), each with its own seed, sent at once, so the batcher
    runs full batches back to back; img/s over the window from the first send
    to the last reply, and over the pipeline calls alone."""
    import threading

    reqs = [dict(prompt=subjects[i % len(subjects)], seed=100 + i, steps=20)
            for i in range(SERVE_WINDOW)]
    done = [None] * len(reqs)
    first_call = len(pipe.calls)

    def send(i):
        status, _, body = http(url + "/generate", reqs[i])
        done[i] = (status, body.get("batched_with"), time.perf_counter())

    threads = [threading.Thread(target=send, args=(i,)) for i in range(len(reqs))]
    t0 = time.perf_counter()
    for t in threads:
        t.start()
    for t in threads:
        t.join()
    if any(d[0] != 200 for d in done):
        raise SystemExit(f"[server] throughput window: statuses {[d[0] for d in done]}")
    span = max(d[2] for d in done) - t0
    calls = pipe.calls[first_call:]
    rows, secs = [c["rows"] for c in calls], [c["secs"] for c in calls]
    latency = sorted(d[2] - t0 for d in done)
    log(f"[time] {card}: server throughput {len(reqs) / span:.4f} img/s: {len(reqs)} requests "
        f"of one signature (1024px, 20 steps, turbo, max batch 4) sent at once, served in "
        f"{span:.3f} s by {len(calls)} pipeline calls of {rows} rows taking "
        f"{[round(v, 3) for v in secs]} s ({sum(rows) / sum(secs):.4f} img/s over the calls "
        f"alone); latency median {latency[len(latency) // 2]:.3f} s, max {latency[-1]:.3f} s")


def run_server(dev, card, fa, model, vae, t5) -> dict:
    """Phase 21: the port's HTTP server in-process on 127.0.0.1 (port 0) over
    the phase 20 int8 model with --turbo's block caching at interval 2:
    concurrent requests (4 of one signature with their own seeds, 1 with
    other steps, 1 SA-Solver, which runs without the cache), each batched
    request's PNG against the same request served alone, the planted fault
    (the row's latent drawn from another seed), /healthz, 429 with
    Retry-After under queue depth 2, launches per pipeline call against the
    reckoning, per-request latencies, and img/s over a window of
    SERVE_WINDOW same-signature requests (`serve_window`). Returns the
    launches."""
    import threading
    from http.server import ThreadingHTTPServer

    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline
    from pixart_sigma_tpu_torch.scripts import serve

    t_phase = time.perf_counter()
    pipe = CountedPipe(PixArtPipeline(model, t5=t5, vae=vae, device=dev), fa)
    y_null_row = model.y_embedder.y_embedding.detach().float()
    servers = []

    def start(queue_depth):
        batcher = serve.MicroBatcher(pipe, y_null_row=y_null_row, max_wait_ms=1000, max_batch=4,
                                     batch_sizes=(1, 2, 4), queue_depth=queue_depth,
                                     gen_kwargs={"block_cache_interval": 2})
        info = {"resolution": 1024, "model": "seeded random weights", "turbo": True}
        httpd = ThreadingHTTPServer(("127.0.0.1", 0), serve.make_handler(batcher, pipe, info))
        threading.Thread(target=httpd.serve_forever, daemon=True).start()
        servers.append((httpd, batcher))
        return f"http://127.0.0.1:{httpd.server_address[1]}"

    try:
        url = start(SERVE_WINDOW)
        status, _, health = http(url + "/healthz")
        log(f"[server] {url}: /healthz {status} {health}")
        if status != 200 or health.get("status") != "ok":
            raise SystemExit("[server] /healthz did not answer")
        subjects = ["a lighthouse on a cliff at dusk", "a red fox in the snow",
                    "a bowl of ramen, studio light", "an astronaut in a jungle, oil painting"]
        reqs = [dict(prompt=p, seed=11 + i, steps=20) for i, p in enumerate(subjects)]
        reqs += [dict(prompt="a small cactus with a happy face", seed=15, steps=10),
                 dict(prompt="an old wooden boat on a lake", seed=16, steps=20,
                      sampler="sa-solver")]
        replies, walls = [None] * len(reqs), [None] * len(reqs)

        def send(i):
            t0 = time.perf_counter()
            replies[i] = http(url + "/generate", reqs[i])
            walls[i] = (t0, time.perf_counter())

        threads = [threading.Thread(target=send, args=(i,)) for i in range(len(reqs))]
        for t in threads:
            t.start()
        for t in threads:
            t.join()
        for (status, _, body), req, w in zip(replies, reqs, walls):
            log(f"[time] {card}: server request {req}: {status}, batched_with "
                f"{body.get('batched_with')}, latency {w[1] - w[0]:.3f} s (6 concurrent "
                "requests of 3 signatures, served one signature after another)")
            if status != 200:
                raise SystemExit(f"[server] {req}: {status} {body}")
        batched = [png_array(body["images"][0]) for _, _, body in replies]
        for img, req in zip(batched, reqs):
            if img.shape != (1024, 1024, 3) or img.dtype != np.uint8 or img.std() == 0:
                raise SystemExit(f"[server] {req}: image {img.shape} {img.dtype}, or constant")
        if any(replies[i][2]["batched_with"] < 2 for i in range(4)):
            raise SystemExit("[server] the 4 requests of one signature were not batched")
        n_batched = len(pipe.calls)
        diffs = []
        for i in range(4):
            t0 = time.perf_counter()
            status, _, body = http(url + "/generate", reqs[i])
            solo = png_array(body["images"][0])
            diffs.append(float(np.abs(solo.astype(np.int16) - batched[i]).mean()))
            log(f"[server] request {i} served alone: {status}, batched_with "
                f"{body['batched_with']}, wall {time.perf_counter() - t0:.3f} s; PNG vs the "
                f"batched one: mean |diff| {diffs[-1]:.4f} levels, max "
                f"{int(np.abs(solo.astype(np.int16) - batched[i]).max())}")
        status, _, body = http(url + "/generate", dict(reqs[0], seed=reqs[1]["seed"]))
        fault = float(np.abs(png_array(body["images"][0]).astype(np.int16) - batched[0]).mean())
        log(f"[server] planted fault, request 0's row drawn from request 1's seed: mean |diff| "
            f"{fault:.4f} levels (tol {SERVE_PNG_TOL}, the fault must read 10x)")
        serve_window(url, card, pipe, subjects)
        launches = {"onepass": 0, "allheads": 0, "flash": 0, "headsmajor": 0}
        for c in pipe.calls:
            steps = c["steps"]
            if c["sampler"] == "dpm-solver":
                if c["interval"] != 2:
                    raise SystemExit(f"[server] a dpm-solver call without the cache: {c}")
                full = -(-steps // 2)
                want = cached_launches(model.cfg.depth, model.cfg.cache_span, full, steps - full)
            else:  # run exact under turbo: no cache for other samplers
                if c["interval"]:
                    raise SystemExit(f"[server] {c['sampler']} ran with the cache: {c}")
                want = model.cfg.depth * sampler_nfe(c["sampler"], steps)
            if (c["counts"]["onepass"], c["counts"]["allheads"]) != (want, want):
                raise SystemExit(f"[server] call {c}: launches, reckoned {want}")
            for k in launches:
                launches[k] += c["counts"][k]
        log(f"[server] pipeline calls: {[(c['rows'], c['sampler'], c['steps'], c['interval']) for c in pipe.calls]} "
            f"({n_batched} for the concurrent round); launches {launches}, as reckoned per call")
        busy_url = start(2)
        status, headers, body = http(busy_url + "/generate", dict(prompt=["a", "b", "c"]))
        log(f"[server] queue depth 2, a 3-prompt request: {status}, Retry-After "
            f"{headers.get('Retry-After')}, {body}")
        if status != 429 or headers.get("Retry-After") != "5":
            raise SystemExit("[server] no 429 with Retry-After past the queue depth")
        if max(diffs) > SERVE_PNG_TOL or fault < 10 * SERVE_PNG_TOL:
            raise SystemExit("[server] a batched request differs from its solo call, or the "
                             "planted fault passed")
    finally:
        for httpd, batcher in servers:
            httpd.shutdown()
            httpd.server_close()
            batcher.shutdown()
    log(f"[server] phase 21: {time.perf_counter() - t_phase:.1f} s")
    return launches


# ---------------------------------------------------------------------------
# phases 22-26: the training front end, checkpoint interop, fine-tuning and
# distillation (LoRA/DoRA, DreamBooth, LCM, DMD), through their entry points

CONFIG_1024 = "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_internalms.py"
DREAMBOOTH_CONFIG = "configs/pixart_alpha_config/PixArt_xl2_img1024_dreambooth.py"
LCM_CONFIG = "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_lcm.py"
DMD_CONFIG = "configs/pixart_app_config/PixArt_DMD_xl2_img512_internalms.py"
FT_STEPS = 3  # steps of each fine-tuning and distillation run
T5_CUT_LAYERS = 2  # T5-XXL's depth in the image-mode CLI run (full width)
DMD_SAMPLES, DMD_DATA_STEPS = 8, 20
# one step at 256px, full width, through the kernels against plain attention
# (SGD, so the update is the gradient): |loss_k - loss_r| / |loss_r| and the
# relative L2 of the trainable parameters' update; the planted faults (LoRA:
# the adapters' scale doubled; LCM: the target network run with the
# student's weights; DMD: real and fake scores swapped) must read above the
# limits (PERF.md)
GATE_LOSS_TOL = 1e-2
GATE_UPDATE_TOL = 5e-2
# DMD's one_step_generate against the pipeline's one-step "dmd" sampler on
# the same weights, captions and noise, relative L2 (the pipeline's
# alpha-bar is an f64 host scalar); the fault "noise rolled by one row"
DMD_ONE_STEP_TOL = 1e-4


def sync() -> None:
    sys.modules["torch"].cuda.synchronize()


def reset_peak() -> None:
    torch = sys.modules["torch"]
    torch.cuda.synchronize()
    torch.cuda.reset_peak_memory_stats()


def peak_gib() -> float:
    return sys.modules["torch"].cuda.max_memory_allocated() / 2**30


def check_launches(tag: str, got: dict, want: dict, some: bool = True) -> None:
    """The run's launches must equal the reckoning, and (`some`) be made."""
    log(f"[{tag}] launches {got}; reckoned {want}")
    if got != want or (some and not any(got.values())):
        raise SystemExit(f"{tag}: launches {got}, reckoned {want}")


def forward_launches(mc, hw, calls: int) -> dict:
    """Launches of `calls` no-grad model calls on a latent of `hw`: each
    block's self-attention (`self_attention_kernel`: onepass up to 4096
    padded keys below a head dim of 128, flash otherwise) and its caption
    cross-attention (allheads), once per call."""
    h, w = hw[0] // mc.patch_size, hw[1] // mc.patch_size
    out = dict.fromkeys(TRAIN_COUNTERS, 0)
    dh = mc.hidden_size // mc.num_heads
    for i in range(mc.depth):
        sr = mc.sr_ratio(i)
        keys = h * w if sr == 1 else (h // sr) * (w // sr)
        out[self_attention_kernel(keys, dh)] += calls
        out["allheads"] += calls
    return out


def add_launches(*parts) -> dict:
    total = dict.fromkeys(TRAIN_COUNTERS, 0)
    for part in parts:
        for k, v in part.items():
            total[k] += v
    return total


def times(values) -> str:
    return ", ".join(f"{x:.4f}" for x in values)


def write_config(path: str, base: str, **overrides) -> str:
    """A config file that inherits `base` (a repository path) and sets
    `overrides`, for the entry points that read a config file."""
    with open(path, "w") as f:
        f.write(f"_base_ = [{os.path.abspath(base)!r}]\n")
        for k, v in overrides.items():
            f.write(f"{k} = {v!r}\n")
    return path


def random_weights(dev, config_path: str, seed: int, pth: str = None, st: str = None) -> dict:
    """Seeded random weights of a config's model at full width, written as an
    upstream `.pth` and/or a diffusers `.safetensors`; returns them (CPU)."""
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.models.pixart import init_weights
    from pixart_sigma_tpu_torch.utils.checkpoint import (
        save_pth,
        save_safetensors,
        torch_to_diffusers_state_dict,
    )

    model = build_model_from_config(read_config(config_path), device=dev, train=True)
    gen = torch.Generator(device=dev).manual_seed(seed)
    init_weights(model, gen)
    perturb_zero_leaves(model, gen)
    sd = {k: v.detach().cpu() for k, v in model.state_dict().items()}
    del model
    if pth:
        save_pth(pth, sd)
    if st:
        save_safetensors(st, torch_to_diffusers_state_dict(sd))
    return sd


def write_t5_dir(dev, path: str, words) -> None:
    """T5-XXL's width with T5_CUT_LAYERS layers, seeded random weights in
    bf16, as an HF directory (`model.safetensors`), and a word-level
    `tokenizers` tokenizer over `words` (no SentencePiece model is
    reachable) that `T5Embedder.from_pretrained` reads."""
    import torch
    from tokenizers import Tokenizer, models, pre_tokenizers, processors

    from pixart_sigma_tpu_torch.models.t5 import T5Config, build_t5, init_weights
    from pixart_sigma_tpu_torch.utils.checkpoint import save_safetensors

    os.makedirs(path, exist_ok=True)
    enc = build_t5(T5Config.xxl(num_layers=T5_CUT_LAYERS), device=dev,
                   param_dtype=torch.bfloat16)
    init_weights(enc, torch.Generator(device=dev).manual_seed(15))
    save_safetensors(os.path.join(path, "model.safetensors"), enc.state_dict())
    del enc
    vocab = {"<pad>": 0, "</s>": 1, "<unk>": 2}
    for w in sorted(set(words)):
        vocab.setdefault(w, len(vocab))
    tok = Tokenizer(models.WordLevel(vocab, unk_token="<unk>"))
    tok.pre_tokenizer = pre_tokenizers.Whitespace()
    tok.post_processor = processors.TemplateProcessing(single="$A </s>",
                                                       special_tokens=[("</s>", 1)])
    tok.save(os.path.join(path, "tokenizer.json"))
    with open(os.path.join(path, "tokenizer_config.json"), "w") as f:
        json.dump({"tokenizer_class": "PreTrainedTokenizerFast", "pad_token": "<pad>",
                   "eos_token": "</s>", "unk_token": "<unk>", "model_max_length": 512}, f)


def counted(fa, fn):
    """fn() with the kernel counts set to 0 just before and read just after:
    (its result, launches, peak GiB, wall seconds)."""
    reset_train_counts(fa)
    reset_peak()
    t0 = time.perf_counter()
    out = fn()
    sync()
    return out, train_counts(fa), peak_gib(), time.perf_counter() - t0


def run_train_cli(dev, card, fa, tmp: str) -> dict:
    """Phase 22: `python -m pixart_sigma_tpu_torch.scripts.train` (its
    `main`) on the 1024px KV-compress config from features: 3 steps from a
    `.pth`; 2 steps, a checkpoint, and `--resume-from latest` for 1, bit for
    bit against the 3; `--load-from` a `.pth` and the diffusers
    `.safetensors` of the same weights on the 1024px config without KV
    compression (diffusers names carry no KV-compression conv), equal
    first-step losses; the 512px config in image mode with `--debug`, its
    VAE from a diffusers `.safetensors` and T5 from an HF directory. Returns
    the launches and the files the later phases reuse."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset, write_image_dataset
    from pixart_sigma_tpu_torch.models import t5 as t5_mod
    from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
    from pixart_sigma_tpu_torch.scripts import train as train_cli
    from pixart_sigma_tpu_torch.utils.checkpoint import save_safetensors

    t0 = time.perf_counter()
    write_feature_dataset(os.path.join(tmp, "data"), [(1024, 1024)] * 12, resolution=1024,
                          valid_tokens=(3, 19), seed=0)
    files = dict(data=tmp, kv_pth=os.path.join(tmp, "kv.pth"),
                 pth=os.path.join(tmp, "w1024.pth"), st=os.path.join(tmp, "w1024.safetensors"),
                 vae=os.path.join(tmp, "vae.safetensors"))
    random_weights(dev, TRAIN_CONFIG, 22, pth=files["kv_pth"])
    random_weights(dev, CONFIG_1024, 23, pth=files["pth"], st=files["st"])
    torch.cuda.manual_seed(24)
    save_safetensors(files["vae"], build_vae(VAEConfig.sdxl(), device=dev).state_dict())
    features = {"root": "data", "load_vae_feat": True, "load_t5_feat": True}
    common = dict(data_root=tmp, data=features, log_interval=1, save_model_steps=0,
                  save_model_epochs=10**9, num_workers=4)
    kv_cfg = write_config(os.path.join(tmp, "kv.py"), TRAIN_CONFIG, **common)
    cfg_1024 = write_config(os.path.join(tmp, "c1024.py"), CONFIG_1024, **common)
    log(f"[cli] features of 12 1024x1024 items, random weights of {TRAIN_CONFIG} (.pth) and "
        f"of {CONFIG_1024} (.pth and diffusers .safetensors), a random SDXL VAE "
        f"(.safetensors) written in {time.perf_counter() - t0:.1f} s")

    def cli(cfg, work, *extra):
        return train_cli.main([cfg, "--work-dir", os.path.join(tmp, work), "--data-root", tmp,
                               "--features", "--device", str(dev), *extra])

    whole, launches, peak, wall = counted(fa, lambda: cli(kv_cfg, "whole", "--load-from",
                                                          files["kv_pth"], "--max-steps", "3"))
    mc = whole.model.cfg
    hws = [h["hw"] for h in whole.history]
    check_launches("cli", launches, run_launches(mc, hws))
    log(f"[cli] {TRAIN_CONFIG} --load-from .pth, 3 steps: losses "
        f"{[round(h['loss'], 6) for h in whole.history]}, s/step {times(h['seconds'] for h in whole.history)}, "
        f"peak {peak:.2f} GiB, {wall:.1f} s with the model's load")
    part = cli(kv_cfg, "part", "--load-from", files["kv_pth"], "--max-steps", "2")
    t0 = time.perf_counter()
    part.save(part.state.step, 0)
    del part
    resumed = cli(kv_cfg, "part", "--resume-from", "latest", "--max-steps", "1")
    same = all(torch.equal(p, dict(resumed.model.named_parameters())[n]) and
               torch.equal(whole.state.ema[n], resumed.state.ema[n])
               for n, p in whole.model.named_parameters())
    same &= whole.history[2]["loss"] == resumed.history[0]["loss"] and resumed.state.step == 3
    log(f"[cli] 2 steps, a checkpoint, --resume-from latest for 1 ({time.perf_counter() - t0:.1f}"
        f" s with the save and load): step {resumed.state.step}, loss "
        f"{resumed.history[0]['loss']:.6f} against {whole.history[2]['loss']:.6f}; weights and "
        f"EMA bit for bit: {same}")
    if not same:
        raise SystemExit("cli: the resumed run differs from the uninterrupted one")
    del whole, resumed
    torch.cuda.empty_cache()

    from_pth = cli(cfg_1024, "pth", "--load-from", files["pth"], "--max-steps", "1")
    from_st = cli(cfg_1024, "st", "--load-from", files["st"], "--max-steps", "1")
    a, b = from_pth.history[0]["loss"], from_st.history[0]["loss"]
    log(f"[cli] {CONFIG_1024} first-step loss from the .pth {a:.8f}, from the diffusers "
        f".safetensors {b:.8f} (equal: {a == b}); the KV-compress config's diffusers file "
        "would lack the KV-compression conv, which load_checkpoint refuses")
    if a != b or not np.isfinite(a):
        raise SystemExit("cli: --load-from .pth and .safetensors disagree")
    del from_pth, from_st
    torch.cuda.empty_cache()

    # image mode: PNGs and captions, encoded on the fly by the CLI's encoders
    img = os.path.join(tmp, "img")
    write_image_dataset(os.path.join(img, "data"), [(512, 512)] * 4, seed=1)
    with open(os.path.join(img, "data", "data_info.json")) as f:
        words = " ".join(m["prompt"] + " " + m["sharegpt4v"] for m in json.load(f)).split()
    write_t5_dir(dev, os.path.join(tmp, "t5"), words)
    cfg_512 = write_config(os.path.join(tmp, "c512.py"), CONFIG_512, data_root=img,
                           data={"root": "data"}, vae_pretrained=files["vae"],
                           t5_pretrained=os.path.join(tmp, "t5"), save_model_steps=0,
                           save_model_epochs=10**9, num_workers=4)
    xxl = vars(t5_mod.T5Config)["xxl"]  # the CLI builds T5-XXL: cut its depth
    t5_mod.T5Config.xxl = classmethod(lambda cls, **kw: xxl.__func__(
        cls, **dict(kw, num_layers=T5_CUT_LAYERS)))
    try:
        run, launches_img, peak, wall = counted(fa, lambda: train_cli.main(
            [cfg_512, "--work-dir", os.path.join(tmp, "w512"), "--debug", "--max-steps", "2",
             "--device", str(dev)]))
    finally:
        t5_mod.T5Config.xxl = xxl
    check_launches("cli", launches_img, run_launches(run.model.cfg,
                                                     [h["hw"] for h in run.history]))
    enc = run.t5.encoder
    log(f"[cli] {CONFIG_512} image mode --debug (B = {run.config.train_batch_size}): VAE "
        f"{type(run.vae).__name__} from .safetensors, T5 from an HF directory (cut: "
        f"{len(enc.encoder.block)} of 24 layers at width {enc.cfg.d_model}, word-level "
        f"tokenizer), losses {[round(h['loss'], 6) for h in run.history]}, peak {peak:.2f} GiB")
    if not all(np.isfinite(h["loss"]) for h in run.history) or len(run.history) != 2:
        raise SystemExit("cli: image-mode run failed")
    del run
    torch.cuda.empty_cache()
    files["kv_cfg"], files["cfg_1024"] = kv_cfg, cfg_1024
    return dict(launches=add_launches(launches, launches_img), files=files)


def model_inputs(dev, mc, B: int, hw, seed: int, lengths=None):
    """Seeded latents [B, h, w, 4], t, captions [B, L, C] and their mask."""
    import torch

    gen = torch.Generator(device=dev).manual_seed(seed)
    x = torch.randn((B, hw[0], hw[1], 4), generator=gen, device=dev)
    y = torch.randn((B, mc.model_max_length, mc.caption_channels), generator=gen, device=dev)
    lengths = lengths or [mc.model_max_length] * B
    mask = (torch.arange(mc.model_max_length, device=dev)[None]
            < torch.tensor(lengths, device=dev)[:, None]).to(torch.int32)
    t = torch.linspace(50, 900, B, device=dev)
    return x, t, y, mask


def run_lora(dev, card, fa, files) -> dict:
    """Phase 23: `scripts.train_pixart_lora` on the 1024px KV-compress config
    (B = 4) from phase 22's `.pth` (diffusers names carry no KV-compression
    conv), rank 4, 3 steps, then 1 step with `--use-dora`. Gates: zero-init
    LoRA and DoRA give the base model's output bit for bit; only the
    adapters moved; the merged `.pth` through `load_pth` gives the merged
    forward bit for bit; launches per step equal `step_launches`."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.scripts import train_pixart_lora
    from pixart_sigma_tpu_torch.training import lora
    from pixart_sigma_tpu_torch.utils.checkpoint import load_pth

    total = dict.fromkeys(TRAIN_COUNTERS, 0)
    outs = {}
    for tag, extra, steps in (("lora", [], FT_STEPS), ("dora", ["--use-dora"], 1)):
        out, launches, peak, wall = counted(fa, lambda: train_pixart_lora.main(
            [files["kv_cfg"], "--base", files["kv_pth"], "--work-dir",
             os.path.join(files["data"], tag), "--rank", "4", "--max-steps", str(steps),
             "--device", str(dev), *extra]))
        mc = out["model"].cfg
        check_launches(tag, launches, {k: steps * v for k, v in
                                       step_launches(mc, (128, 128)).items()})
        total = add_launches(total, launches)
        n = lora.count_lora_params(out["lora"])
        log(f"[{tag}] rank 4, {len(out['lora'])} adapted modules, {n / 1e6:.2f}M adapter "
            f"parameters; losses {[round(x, 6) for x in out['losses']]}, s/step "
            f"{times(out['seconds'])} (B = 4, 1024x1024), peak {peak:.2f} GiB, {wall:.1f} s "
            "with the load and the merged export")
        if not all(np.isfinite(out["losses"])):
            raise SystemExit(f"{tag}: loss not finite")
        outs[tag] = out
    out = outs["lora"]
    model, base = out["model"], out["base"]
    loaded = torch.load(files["kv_pth"], map_location="cpu", weights_only=True)["state_dict"]
    unmoved = all(torch.equal(p.cpu(), loaded[n]) for n, p in model.named_parameters())
    moved = sum(int(e["b"].abs().sum() > 0) for e in out["lora"].values())
    x, t, y, mask = model_inputs(dev, model.cfg, 1, (128, 128), 23, [19])
    with torch.no_grad():
        want = model(x, t, y, mask)
        ident = {}
        for use_dora in (False, True):
            zero = lora.init_lora_params(base, model.cfg, 4, torch.Generator(
                device=dev).manual_seed(1), use_dora=use_dora)
            with lora.swapped_weights(model, lora.adapted_weights(lora.apply_lora(base, zero),
                                                                  zero)):
                ident["dora" if use_dora else "lora"] = torch.equal(model(x, t, y, mask), want)
        with lora.swapped_weights(model, lora.adapted_weights(lora.apply_lora(base, out["lora"]),
                                                              out["lora"])):
            merged_out = model(x, t, y, mask)
        fresh = load_pth(build_model_from_config(read_config(files["kv_cfg"]), device=dev,
                                                 train=True), out["merged_path"])
        from_file = fresh(x, t, y, mask)
    del fresh
    diff = rel_l2(merged_out, want)
    log(f"[lora] zero-init adapters give the base output bit for bit: {ident}; base weights "
        f"unmoved after 3 steps: {unmoved}; adapters with b moved: {moved} of "
        f"{len(out['lora'])}; merged forward vs base relative L2 {diff:.3e}; merged .pth "
        f"through load_pth equals the merged forward bit for bit: "
        f"{torch.equal(from_file, merged_out)}")
    if not (all(ident.values()) and unmoved and moved == len(out["lora"])
            and torch.equal(from_file, merged_out) and diff > 0):
        raise SystemExit("lora: a gate failed")
    del outs, out, model, base
    torch.cuda.empty_cache()
    return total


def run_dreambooth(dev, card, fa, files) -> dict:
    """Phase 24: `scripts.train_dreambooth_lora` on the DreamBooth config
    (1024px, 120 tokens, prior preservation: a batch of 2) from 4 instance
    and 4 class PNGs at 1024x1024 encoded by the random SDXL VAE, with
    `--prompt-embeds` (pseudo-T5 captions) and the base from a diffusers
    `.safetensors`, for 3 steps."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
    from pixart_sigma_tpu_torch.scripts import train_dreambooth_lora
    from pixart_sigma_tpu_torch.utils.png import write_png

    tmp = os.path.join(files["data"], "dreambooth")
    base = os.path.join(tmp, "base.safetensors")
    os.makedirs(tmp)
    t0 = time.perf_counter()
    random_weights(dev, DREAMBOOTH_CONFIG, 24, st=base)
    rng = np.random.default_rng(24)
    for sub in ("instance", "class"):
        os.makedirs(os.path.join(tmp, sub))
        yy, xx = np.mgrid[0:1024, 0:1024] / 1024.0
        for i in range(4):
            f = 2 + 6 * rng.random((2, 3))
            img = 127.5 + 100 * np.sin(f[0] * xx[..., None] * 6 + f[1] * yy[..., None] * 6)
            write_png(os.path.join(tmp, sub, f"{i}.png"), np.clip(img, 0, 255).astype(np.uint8))
    emb = PseudoT5Embedder(4096, 120)
    y, m = emb.get_text_embeddings(["a photo of sks dog", "a photo of a dog"])
    np.savez(os.path.join(tmp, "emb.npz"), y_instance=y[0].numpy(), mask_instance=m[0].numpy(),
             y_class=y[1].numpy(), mask_class=m[1].numpy())
    log(f"[dreambooth] 8 PNGs at 1024x1024, random weights of {DREAMBOOTH_CONFIG} "
        f"(.safetensors), pseudo-T5 prompt embeddings in {time.perf_counter() - t0:.1f} s")
    out, launches, peak, wall = counted(fa, lambda: train_dreambooth_lora.main(
        [DREAMBOOTH_CONFIG, "--base", base, "--work-dir", os.path.join(tmp, "work"),
         "--instance-dir", os.path.join(tmp, "instance"), "--class-dir",
         os.path.join(tmp, "class"), "--prompt-embeds", os.path.join(tmp, "emb.npz"),
         "--vae-path", files["vae"], "--rank", "4", "--max-steps", str(FT_STEPS),
         "--device", str(dev)]))
    mc = out["model"].cfg
    check_launches("dreambooth", launches, {k: FT_STEPS * v for k, v in
                                            step_launches(mc, (128, 128)).items()})
    ms = out["metrics"]
    log(f"[dreambooth] {FT_STEPS} steps, batch 2 ([instance; class]), 120-token captions: "
        + "; ".join(f"loss {h['loss']:.5f} = instance {h['instance']:.5f} + prior "
                    f"{h['prior']:.5f}" for h in ms)
        + f"; s/step {times(h['seconds'] for h in ms)}; peak {peak:.2f} GiB; {wall:.1f} s "
        "with the loads, the VAE encode and the merged export")
    ok = all(np.isfinite(h["loss"]) and abs(h["loss"] - h["instance"] - h["prior"])
             <= 1e-5 * abs(h["loss"]) for h in ms)
    if not ok or not any(e["b"].abs().sum() > 0 for e in out["lora"].values()):
        raise SystemExit("dreambooth: a gate failed")
    del out
    torch.cuda.empty_cache()
    return launches


def run_lcm(dev, card, fa, files) -> dict:
    """Phase 25: `scripts.train_pixart_lcm` on the LCM config at its B = 12
    (1024px, 4096 tokens, CAME, grad checkpointing), the teacher from phase
    22's diffusers `.safetensors`, for 3 steps: launches per step (the
    student's step, and three no-grad forwards: the teacher's conditional
    and unconditional and the target's), s/step, peak memory and a trace of
    one step."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.scripts import train_pixart_lcm
    from pixart_sigma_tpu_torch.scripts.finetune_common import device_batch, feature_loader
    from pixart_sigma_tpu_torch.training.lcm_trainer import make_lcm_train_step

    cfg_path = write_config(os.path.join(files["data"], "lcm.py"), LCM_CONFIG,
                            data_root=files["data"],
                            data={"root": "data", "load_vae_feat": True, "load_t5_feat": True},
                            log_interval=1,
                            save_model_steps=0, num_workers=4,
                            work_dir=os.path.join(files["data"], "lcm"))
    out, launches, peak, wall = counted(fa, lambda: train_pixart_lcm.main(
        [cfg_path, "--teacher", files["st"], "--max-steps", str(FT_STEPS), "--device", str(dev)]))
    state, teacher = out["state"], out["teacher"]
    mc = state.model.cfg
    per_step = add_launches(step_launches(mc, (128, 128)), forward_launches(mc, (128, 128), 3))
    check_launches("lcm", launches, {k: FT_STEPS * v for k, v in per_step.items()})
    hist = out["history"]
    cfg = read_config(cfg_path)
    log(f"[lcm] {LCM_CONFIG}: B = {cfg.train_batch_size}, 1024x1024, {cfg.loss_type} loss, "
        f"ema_decay {cfg.ema_decay}, cfg {cfg.cfg_scale}, {cfg.optimizer['type']}; losses "
        f"{[round(h['loss'], 6) for h in hist]}; per step {per_step}")
    log(f"[time] {card}: lcm step (B = {cfg.train_batch_size}, 1024x1024): "
        f"{times(h['seconds'] for h in hist)} s/step; peak memory {peak:.2f} GiB (student, "
        f"CAME, the EMA target and the bf16 teacher); {wall:.1f} s with the loads")
    if not all(np.isfinite(h["loss"]) for h in hist):
        raise SystemExit("lcm: loss not finite")
    step_fn = make_lcm_train_step(mc, IDDPM(timestep_respacing=[1000], learn_sigma=True),
                                  num_ddim_timesteps=cfg.num_ddim_timesteps,
                                  cfg_scale=cfg.cfg_scale, loss_type=cfg.loss_type,
                                  huber_c=cfg.huber_c, ema_decay=cfg.ema_decay)
    batch = device_batch(next(iter(feature_loader(cfg))), cfg, mc, dev)
    uncond = state.model.y_embedder.y_embedding.detach()[None].expand(
        batch["y"].shape).float()
    trace(lambda: step_fn(state, teacher, uncond, batch, grad_clip=cfg.gradient_clip),
          f"one lcm step, B = {cfg.train_batch_size}", card)
    del out, state, teacher, batch
    torch.cuda.empty_cache()
    return launches


def run_dmd(dev, card, fa, files) -> dict:
    """Phase 26: `tools.generate_dmd_data` with the 512px teacher of the DMD
    config (8 samples, 20 steps, `--pseudo-t5`), then
    `scripts.train_pixart_dmd` on those triplets (B = 4, bf16 teacher, CAME)
    for 3 generator and fake-score steps; one_step_generate against the
    pipeline's one-step "dmd" sampler on the same weights and noise."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline
    from pixart_sigma_tpu_torch.scripts import train_pixart_dmd
    from pixart_sigma_tpu_torch.tools import generate_dmd_data
    from pixart_sigma_tpu_torch.training.dmd import make_dmd_train_steps

    tmp = os.path.join(files["data"], "dmd")
    root = os.path.join(tmp, "InternData")
    os.makedirs(os.path.join(root, "caption_features"))
    teacher = os.path.join(tmp, "teacher.pth")
    random_weights(dev, DMD_CONFIG, 26, pth=teacher)
    prompts = synthetic_captions(DMD_SAMPLES, 26)
    with open(os.path.join(root, "data_info.json"), "w") as f:
        json.dump([{"path": f"part0/{i:06d}.png", "prompt": p, "ratio": 1.0,
                    "height": 512, "width": 512} for i, p in enumerate(prompts)], f)
    y, mask = PseudoT5Embedder(4096, 300).get_text_embeddings(prompts)
    for i in range(DMD_SAMPLES):  # the captions as a T5 feature run writes them
        n = int(mask[i].sum())
        np.savez(os.path.join(root, "caption_features", f"{i:06d}.npz"),
                 caption_feature=y[i:i + 1, :n].numpy(), attention_mask=mask[i:i + 1, :n].numpy())
    reset_forward_counts(fa)
    t0 = time.perf_counter()
    generate_dmd_data.main(["--data-root", root, "--config", DMD_CONFIG, "--model-path", teacher,
                            "--pseudo-t5", "4096", "--sample-nums", str(DMD_SAMPLES), "--batch",
                            str(DMD_SAMPLES), "--steps", str(DMD_DATA_STEPS), "--device", str(dev)])
    sync()
    gen_s = time.perf_counter() - t0
    data_counts = forward_counts(fa)
    log(f"[dmd] generate_dmd_data: {DMD_SAMPLES} triplets at 512px, {DMD_DATA_STEPS}-step "
        f"DPM-Solver++ with CFG (one batch), {gen_s:.1f} s with the teacher's load")
    base = np.load(os.path.join(root, "base_latents", "000000.npy"))
    if base.shape != (64, 64, 4) or not np.isfinite(base).all() or base.std() == 0:
        raise SystemExit("dmd: the teacher's base latent is wrong")
    # phase 29's DMD step regresses against these
    files["dmd_base_latents"] = np.stack([np.load(os.path.join(root, "base_latents",
                                                               f"{i:06d}.npy")) for i in range(4)])

    out, launches, peak, wall = counted(fa, lambda: train_pixart_dmd.main(
        ["--data-root", root, "--teacher", teacher, "--config", DMD_CONFIG, "--work-dir",
         os.path.join(tmp, "work"), "--batch-size", "4", "--teacher-dtype", "bfloat16",
         "--max-steps", str(FT_STEPS), "--save-steps", "1000", "--log-interval", "1",
         "--device", str(dev)]))
    gen_model, real, fake = out["generator"], out["real"], out["fake"]
    mc = gen_model.cfg
    fwd = forward_launches(mc, (64, 64), DMD_DATA_STEPS)  # one CFG model call per step
    check_launches("dmd data", data_counts, {"onepass": fwd["onepass"], "allheads":
                                             fwd["allheads"], "flash": fwd["flash_forward"],
                                             "headsmajor": 0})
    per_step = add_launches(step_launches(mc, (64, 64)), step_launches(mc, (64, 64)),
                            forward_launches(mc, (64, 64), 2))
    check_launches("dmd", launches, {k: FT_STEPS * v for k, v in per_step.items()})
    hist = out["history"]
    log(f"[dmd] {FT_STEPS} generator and fake-score steps (B = 4, 512px, bf16 teacher "
        f"{next(real.parameters()).dtype}, CAME): dm_loss "
        f"{[round(h['dm_loss'], 6) for h in hist]}, sg_loss "
        f"{[round(h['sg_loss'], 6) for h in hist]}; per step {per_step}")
    log(f"[time] {card}: dmd generator + fake-score step (B = 4, 512x512): "
        f"{times(h['seconds'] for h in hist)} s; peak memory {peak:.2f} GiB (two trained "
        f"XL-2 with CAME and the bf16 teacher); {wall:.1f} s with the loads")
    if not all(np.isfinite(h["dm_loss"]) and np.isfinite(h["sg_loss"]) for h in hist):
        raise SystemExit("dmd: loss not finite")

    diffusion = IDDPM(timestep_respacing=[1000], learn_sigma=True)
    _, _, one = make_dmd_train_steps(mc, diffusion, start_ts=400)
    noise = torch.randn((4, 64, 64, 4), generator=torch.Generator(device=dev).manual_seed(26),
                        device=dev)
    yb, mb = y[:4].to(dev), mask[:4].to(dev)
    pipe = PixArtPipeline(gen_model, base_resolution=512, device=dev)
    with torch.no_grad():
        x0 = one(gen_model, noise, yb, mb)
        x0_fault = one(gen_model, noise.roll(1, 0), yb, mb)
    want = torch.from_numpy(pipe(prompts[:4], sampler="dmd", y=yb, y_mask=mb, latents=noise,
                                 return_latents=True)).to(dev)
    err, err_fault = rel_l2(x0, want), rel_l2(x0_fault, want)
    log(f"[dmd] one_step_generate vs the pipeline's 'dmd' sampler, same weights, captions "
        f"and noise: relative L2 {err:.3e} (limit {DMD_ONE_STEP_TOL}); planted fault 'noise "
        f"rolled by one row' {err_fault:.3e}")
    if not err <= DMD_ONE_STEP_TOL < err_fault:
        raise SystemExit("dmd: one_step_generate disagrees with the pipeline, or the gate "
                         "missed its fault")
    gen_step, fake_step, _ = make_dmd_train_steps(
        mc, diffusion, start_ts=400, generator_optimizer=torch.optim.SGD(
            gen_model.parameters(), lr=0.0), fake_optimizer=torch.optim.SGD(
            fake.parameters(), lr=0.0))
    uncond = gen_model.y_embedder.y_embedding.detach()[None].expand(4, 300, 4096).float()
    batch = {"init_noise": noise, "y": yb, "y_mask": mb, "uncond_y": uncond}

    def dmd_step():
        _, x0s = gen_step(gen_model, real, fake, batch)
        fake_step(fake, x0s, batch)

    trace(dmd_step, "one dmd generator + fake-score step, B = 4 (SGD at lr 0)", card)
    del out, gen_model, real, fake, pipe
    torch.cuda.empty_cache()
    return launches


def gate_update(before: dict, after: dict):
    import torch

    return torch.cat([(after[n] - before[n]).detach().flatten().float() for n in before])


def run_finetune_gates(dev, card, fa) -> dict:
    """The kernels on the new paths: at 256px and full width (28 blocks x
    1152, KV compression on layers 14-27, grad checkpointing), one LoRA
    step, one LCM step and one DMD generator step, without and (phase 29)
    with the LPIPS regression of the decoded x0 (a random SDXL VAE and
    LPIPS), each run through the kernels and through plain attention with
    the same draws and an SGD update; the loss and the trainable parameters'
    update must agree within GATE_LOSS_TOL and GATE_UPDATE_TOL, and a
    planted fault per path must read beyond them. Returns the kernel runs'
    launches."""
    import torch

    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.models.lpips import build_lpips
    from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
    from pixart_sigma_tpu_torch.training import lora
    from pixart_sigma_tpu_torch.training.dmd import make_dmd_train_steps
    from pixart_sigma_tpu_torch.training.lcm_trainer import make_lcm_train_step
    from pixart_sigma_tpu_torch.training.train_state import TrainState

    nets = [xl2_256(dev, 30 + seed, train=True, grad_checkpointing=True) for seed in (0, 1, 2)]
    student, other, third = nets
    saved = [{n: p.detach().clone() for n, p in m.named_parameters()} for m in nets]
    diffusion = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)
    x, _, y, mask = model_inputs(dev, student.cfg, 2, (32, 32), 31, [300, 19])
    gen = torch.Generator(device=dev).manual_seed(32)
    t = torch.tensor([120, 333], device=dev)  # DMD draws t in [1, 400)
    noise = torch.randn(x.shape, generator=gen, device=dev)
    index = torch.tensor([7, 33], device=dev)
    uncond = student.y_embedder.y_embedding.detach()[None].expand(y.shape).float()
    batch = {"latents": x, "y": y, "y_mask": mask}
    readings, launches = {}, dict.fromkeys(TRAIN_COUNTERS, 0)

    def restore():
        with torch.no_grad():
            for m, sd in zip(nets, saved):
                for n, p in m.named_parameters():
                    p.copy_(sd[n])

    def with_impl(impl, fn):
        for m in nets:
            set_attn_impl(m, impl)
        try:
            reset_train_counts(fa)
            out = fn()
            sync()
            return out, train_counts(fa)
        finally:
            for m in nets:
                set_attn_impl(m, "auto")

    # LoRA: adapters with b moved off zero, so the merged weights differ from the base
    student.requires_grad_(False)
    base = {n: p.detach() for n, p in student.named_parameters()}
    ad0 = lora.init_lora_params(base, student.cfg, 4, torch.Generator(device=dev).manual_seed(33))
    with torch.no_grad():
        for e in ad0.values():
            e["b"].normal_(0.0, 0.02, generator=torch.Generator(device=dev).manual_seed(34))

    def lora_run(scale=1.0):
        ad = {m: {k: v.detach().clone().requires_grad_(True) for k, v in e.items()}
              for m, e in ad0.items()}
        opt = torch.optim.SGD(list(lora.lora_parameters(ad)), lr=1.0)
        loss = lora.make_lora_train_step(student, diffusion, base, opt, scale=scale)(
            ad, batch, t=t, noise=noise, force_drop_ids=torch.zeros(2, device=dev))
        after = {f"{m}.{k}": v.detach() for m, e in ad.items() for k, v in e.items()}
        before = {f"{m}.{k}": v for m, e in ad0.items() for k, v in e.items()}
        return loss, gate_update(before, after)

    def lcm_run(target=third):
        restore()
        student.requires_grad_(True)
        state = TrainState(student, torch.optim.SGD(student.parameters(), lr=1.0),
                           lambda s: 1.0, ema=True)
        state.ema = {n: p.detach().clone() for n, p in target.named_parameters()}
        step = make_lcm_train_step(student.cfg, diffusion)
        loss = step(state, other, uncond, batch, index=index, noise=noise)["loss"]
        after = {n: p.detach().clone() for n, p in student.named_parameters()}
        return loss, gate_update(saved[0], after)

    torch.cuda.manual_seed(29)
    vae = build_vae(VAEConfig.sdxl(), device=dev)
    lpips = build_lpips(dev, seed=29)
    base_latent = torch.randn(x.shape, generator=torch.Generator(device=dev).manual_seed(35),
                              device=dev)
    regression = dict(lpips_fn=lpips, decode_fn=lambda z: vae.decode(z / 0.13025))

    def dmd_run(swap=False, regress=False):
        restore()
        student.requires_grad_(True)
        g_step, _, _ = make_dmd_train_steps(
            student.cfg, diffusion, generator_optimizer=torch.optim.SGD(student.parameters(),
                                                                        lr=1.0),
            **(regression if regress else {}))
        real, fake = (third, other) if swap else (other, third)
        dbatch = {"init_noise": noise, "y": y, "y_mask": mask, "uncond_y": uncond,
                  "base_latent": base_latent}
        metrics, _ = g_step(student, real, fake, dbatch, t=t, noise=noise)
        if regress:
            log(f"[gates] dmd with the regression: dm_loss {metrics['dm_loss']:.6f}, lpips_loss "
                f"{metrics['lpips_loss']:.6f}")
        after = {n: p.detach().clone() for n, p in student.named_parameters()}
        return metrics["loss"], gate_update(saved[0], after)

    mc, hw = student.cfg, (32, 32)
    for tag, run, fault, fault_name, fwd in (
            ("lora", lora_run, lambda: lora_run(scale=2.0), "the adapters' scale doubled", 0),
            ("lcm", lcm_run, lambda: lcm_run(target=student),
             "the target network run with the student's weights", 3),
            ("dmd", dmd_run, lambda: dmd_run(swap=True), "real and fake scores swapped", 2),
            ("dmd_lpips", lambda: dmd_run(regress=True),
             lambda: dmd_run(swap=True, regress=True), "real and fake scores swapped", 2)):
        (loss_k, upd_k), got = with_impl("auto", run)
        (loss_r, upd_r), ref_counts = with_impl("reference", run)
        (loss_f, upd_f), _ = with_impl("auto", fault)
        launches = add_launches(launches, got)
        read = lambda l, u: (abs(l - loss_r) / abs(loss_r), rel_l2(u, upd_r))
        sound, bad = read(loss_k, upd_k), read(loss_f, upd_f)
        readings[tag] = dict(loss=sound[0], update=sound[1], fault_loss=bad[0],
                             fault_update=bad[1])
        log(f"[gates] {tag} step at 256px, full width, kernels vs plain attention: loss "
            f"{loss_k:.6f} vs {loss_r:.6f}, relative {sound[0]:.3e} (limit {GATE_LOSS_TOL}); "
            f"update relative L2 {sound[1]:.3e} (limit {GATE_UPDATE_TOL}); planted fault "
            f"'{fault_name}': loss {bad[0]:.3e}, update {bad[1]:.3e}")
        if not (sound[0] <= GATE_LOSS_TOL and sound[1] <= GATE_UPDATE_TOL):
            raise SystemExit(f"gates: the {tag} step through the kernels disagrees with plain "
                             "attention")
        if bad[0] <= GATE_LOSS_TOL and bad[1] <= GATE_UPDATE_TOL:
            raise SystemExit(f"gates: the {tag} gate missed its planted fault")
        check_launches(f"gates {tag}", got, add_launches(step_launches(mc, hw),
                                                         forward_launches(mc, hw, fwd)))
        check_launches(f"gates {tag} plain", ref_counts, dict.fromkeys(TRAIN_COUNTERS, 0),
                       some=False)
    del nets, student, other, third, saved, vae, lpips, regression
    torch.cuda.empty_cache()
    return launches


def run_finetuning(dev, card, fa) -> tuple:
    """Phases 22-26 and the gates, in one temporary directory; returns the
    launches of each and the first 4 of phase 26's base latents."""
    tmp = tempfile.mkdtemp(prefix="pixart_finetune_")
    try:
        t0 = time.perf_counter()
        cli = run_train_cli(dev, card, fa, tmp)
        out = {"cli": cli["launches"]}
        t = {"cli": time.perf_counter() - t0}
        for name, fn in (("lora", run_lora), ("dreambooth", run_dreambooth), ("lcm", run_lcm),
                         ("dmd", run_dmd)):
            t0 = time.perf_counter()
            out[name] = fn(dev, card, fa, cli["files"])
            t[name] = time.perf_counter() - t0
        t0 = time.perf_counter()
        out["gates"] = run_finetune_gates(dev, card, fa)
        t["gates"] = time.perf_counter() - t0
        log("[finetune] phase seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in t.items()))
        return out, cli["files"]["dmd_base_latents"]
    finally:
        shutil.rmtree(tmp, ignore_errors=True)



# ---------------------------------------------------------------------------
# phases 27-31: evaluation (bits/dim and the KL objective, FID features,
# LPIPS and DMD's regression), the VAE trainer and the offline toy workflow

BPD_STEPS = 50  # the spaced chain of phase 27's bits/dim
# phase 27's bits/dim at 256px, kernels vs plain attention with the same
# noise: per timestep, the relative L2 over the batch, the worst of the 50
# (PERF.md); the planted fault "decoder NLL at t = 0 replaced by the KL"
BPD_REL_TOL = 2e-2
# Phases 28-30 hold f32 work on the card (TF32 off) against the host's CPU,
# each limit between the sound reading and the same run with TF32 on, which
# must read beyond it as the planted fault must (readings in PERF.md).
# phase 28: InceptionV3 activations, relative L2 (sound 1.8e-6-2.1e-6, TF32
# 5.3e-4-5.8e-4); the planted fault "Mixed_7c pools by average"
FID_REL_TOL = 1e-5
# phase 29: LPIPS distances, relative L2 (sound 4.3e-8-1.1e-7, TF32
# 1.5e-5-5.4e-5); the planted fault "taps not unit-normalised over the
# channels"
LPIPS_REL_TOL = 1e-6
# phase 30: one small-preset VAE step (SGD, so the update is the gradient)
# with the same eps: the loss, relative (sound 1.1e-6, TF32 4.3e-5), and the
# update, relative L2 (2.6e-5, 1.0e-3); the planted fault "eps of another
# image"
VAE_LOSS_TOL, VAE_UPDATE_TOL = 1e-5, 2e-4
VAE_TRAIN_STEPS = 3
TOY_CONFIG = "configs/toy/pixart_toy_img128.py"
# phase 31's lengths, cut from docs/toy_workflow.md's (JAX: 2048 images, a
# 4000-step VAE, 2000 DiT steps at B = 256, 96 samples), and the DiT's batch:
# at the config's 256 the loader alone takes ~0.5 s a batch (its threads
# parse 512 small .npy/.npz files under the GIL), a held batch's train_step
# ~0.06 s (toy_loader_reading; PERF.md). The DiT's 150 steps (250 before
# phase 32 came) keep the script near 800 s on the card.
TOY_IMAGES, TOY_VAE_STEPS, TOY_DIT_STEPS, TOY_SAMPLES = 512, 200, 150, 64
TOY_DIT_BATCH = 64
TOY_SCALE = 0.3264  # the toy config's scale factor
# phase 31's kernels at its own shapes (Dh = 64, 64 tokens, 12 caption
# keys) on the trained toy model, against plain attention with the same
# draws: one training step (GATE_LOSS_TOL, GATE_UPDATE_TOL) and one CFG
# forward of the sampler's 2 x 32 rows, relative L2 (PERF.md); the planted
# fault "the padding of the last key tile left unmasked" (step: sound
# 8.6e-5-2.0e-4 and 3.1e-3-3.3e-3, fault 0.13-0.14 and 2.1-2.3; forward:
# sound 1.7e-3-1.8e-3, fault 1.4e-2-2.4e-2)
TOY_FWD_TOL = 5e-3


@contextlib.contextmanager
def tf32_on():
    """TF32 on for matmuls and cuDNN convolutions, the control of the f32
    gates of phases 28-30 (every phase runs with it off)."""
    torch = sys.modules["torch"]
    torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = True
    try:
        yield
    finally:
        torch.backends.cuda.matmul.allow_tf32 = torch.backends.cudnn.allow_tf32 = False


def xl2_256(dev, seed: int, **kw):
    """The 1024px KV-compress architecture at 256px (32x32 latents), full
    width and depth, seeded random weights."""
    import torch

    from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2, init_weights

    m = PixArtMS_XL_2(device=dev, input_size=32, pe_interpolation=0.5, model_max_length=300,
                      kv_compress_sampling="conv", kv_compress_scale=2,
                      kv_compress_layers=tuple(range(14, 28)), **kw)
    gen = torch.Generator(device=dev).manual_seed(seed)
    init_weights(m, gen)
    perturb_zero_leaves(m, gen)
    return m


def worst_column(got, want) -> float:
    """The largest relative L2 over the batch of any timestep column."""
    return float(((got - want).norm(dim=0) / want.norm(dim=0)).max())


def run_bpd(dev, card, fa) -> dict:
    """Phase 27: `calc_bpd_loop` over a 50-step `SpacedDiffusion` chain (its
    `timestep_map`) on the 1024px KV-compress config at full width, B = 2,
    pseudo-T5 captions; then, at 256px and full width, the bits/dim through
    the kernels against plain attention with the same noise (fault: the
    decoder NLL at t = 0 replaced by the KL) and one `IDDPM(use_kl=True)`
    training step (SGD) through the kernels against plain attention (fault:
    the loss not rescaled by T). Returns the launches."""
    import copy
    import math
    import types

    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.diffusion.gaussian import LossType
    from pixart_sigma_tpu_torch.diffusion.likelihood import mean_flat, normal_kl
    from pixart_sigma_tpu_torch.diffusion.noise import generator_noise
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.models.pixart import init_weights
    from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder

    t_phase = time.perf_counter()
    diffusion = IDDPM(timestep_respacing=str(BPD_STEPS)).to(dev)
    y, mask = PseudoT5Embedder(4096, 300).get_text_embeddings(synthetic_captions(2, 27))
    y, mask = y.to(dev), mask.to(dev)

    def bpd(model, x0, diff=diffusion):
        gen = torch.Generator(device=dev).manual_seed(27)
        fn = lambda x, t: model(x, t.float(), y, mask).float()
        with torch.no_grad():
            return diff.calc_bpd_loop(fn, x0, generator_noise(gen),
                                      timestep_map=diffusion.timestep_map)

    def data(hw):
        g = torch.Generator(device=dev).manual_seed(28)
        return torch.rand((2, *hw, 4), generator=g, device=dev) * 2 - 1

    model = build_model_from_config(read_config(TRAIN_CONFIG), device=dev)
    gen = torch.Generator(device=dev).manual_seed(27)
    init_weights(model, gen)
    perturb_zero_leaves(model, gen)
    mc = model.cfg
    out, launches, peak, wall = counted(fa, lambda: bpd(model, data((128, 128))))
    check_launches("bpd", launches, forward_launches(mc, (128, 128), BPD_STEPS))
    log(f"[bpd] {TRAIN_CONFIG}: calc_bpd_loop over {BPD_STEPS} of 1000 timesteps, B = 2 "
        f"latents 128x128x4 in [-1, 1]: total bits/dim {times(out['total_bpd'].tolist())}, "
        f"prior {times(out['prior_bpd'].tolist())}, t = 0 term "
        f"{times(out['vb'][:, -1].tolist())}")
    log(f"[time] {card}: bits/dim, {BPD_STEPS} model calls at B = 2, 1024px: {wall:.3f} s "
        f"({wall / BPD_STEPS * 1e3:.1f} ms per call); peak {peak:.2f} GiB")
    if not all(torch.isfinite(v).all() for v in out.values()):
        raise SystemExit("bpd: not finite")
    del model
    torch.cuda.empty_cache()

    # ---- the 256px gates
    net = xl2_256(dev, 40, train=True, grad_checkpointing=True)
    x0 = data((32, 32))

    def nll_as_kl(self, model_output, x_start, x_t, t, clip_denoised=False):
        true_mean, _, true_log_var = self.q_posterior_mean_variance(x_start, x_t, t)
        o = self.p_mean_variance(model_output, x_t, t, clip_denoised=clip_denoised)
        kl = normal_kl(true_mean, true_log_var, o["mean"], o["log_variance"])
        return {"output": mean_flat(kl) / math.log(2.0), "pred_xstart": o["pred_xstart"]}

    faulty = copy.copy(diffusion)
    faulty.vb_terms_bpd = types.MethodType(nll_as_kl, faulty)
    total = dict.fromkeys(TRAIN_COUNTERS, 0)
    got, launches, _, _ = counted(fa, lambda: bpd(net, x0))
    check_launches("bpd gate", launches, forward_launches(net.cfg, (32, 32), BPD_STEPS))
    total = add_launches(total, launches)
    bad = bpd(net, x0, faulty)
    set_attn_impl(net, "reference")
    try:
        want, plain, _, _ = counted(fa, lambda: bpd(net, x0))
    finally:
        set_attn_impl(net, "auto")
    check_launches("bpd gate plain", plain, dict.fromkeys(TRAIN_COUNTERS, 0), some=False)
    sound, fault = worst_column(got["vb"], want["vb"]), worst_column(bad["vb"], want["vb"])
    total_rel = float(((got["total_bpd"] - want["total_bpd"]).abs() / want["total_bpd"]).max())
    log(f"[bpd] 256px bits/dim, kernels vs plain attention: total {times(got['total_bpd'])} vs "
        f"{times(want['total_bpd'])} (relative {total_rel:.3e}); worst timestep's relative L2 "
        f"{sound:.3e} (limit {BPD_REL_TOL}); planted fault 'decoder NLL at t = 0 replaced by "
        f"the KL' {fault:.3e}")
    if not sound <= BPD_REL_TOL < fault:
        raise SystemExit("bpd: the bits/dim through the kernels disagree with plain attention, "
                         "or the gate missed its fault")

    # ---- one IDDPM(use_kl=True) training step (SGD)
    kl_diff = IDDPM(timestep_respacing=[1000], learn_sigma=True, use_kl=True).to(dev)
    plain_kl = copy.copy(kl_diff)
    plain_kl.loss_type = LossType.KL
    t = torch.tensor([0, 613], device=dev)
    noise = torch.randn(x0.shape, generator=torch.Generator(device=dev).manual_seed(41),
                        device=dev)
    saved = {n: p.detach().clone() for n, p in net.named_parameters()}

    def kl_step(diff=kl_diff):
        with torch.no_grad():
            for n, p in net.named_parameters():
                p.copy_(saved[n])
        opt = torch.optim.SGD(net.parameters(), lr=1.0)
        fn = lambda x, tt: net(x, tt, y, mask)  # no caption drops
        loss = diff.training_losses(fn, x0, t, noise)["loss"].mean()
        opt.zero_grad(set_to_none=True)
        loss.backward()
        opt.step()
        return float(loss.detach()), gate_update(saved, {n: p.detach() for n, p in
                                                         net.named_parameters()})

    (loss_k, upd_k), launches, _, _ = counted(fa, kl_step)
    check_launches("kl step", launches, step_launches(net.cfg, (32, 32)))
    total = add_launches(total, launches)
    set_attn_impl(net, "reference")
    try:
        (loss_r, upd_r), plain, _, _ = counted(fa, kl_step)
    finally:
        set_attn_impl(net, "auto")
    check_launches("kl step plain", plain, dict.fromkeys(TRAIN_COUNTERS, 0), some=False)
    loss_f, upd_f = kl_step(plain_kl)
    read = lambda l, u: (abs(l - loss_r) / abs(loss_r), rel_l2(u, upd_r))
    sound, bad = read(loss_k, upd_k), read(loss_f, upd_f)
    log(f"[gates] IDDPM(use_kl=True) step at 256px (t = 0 and 613), full width, kernels vs "
        f"plain attention: loss {loss_k:.6f} vs {loss_r:.6f}, relative {sound[0]:.3e} (limit "
        f"{GATE_LOSS_TOL}); update relative L2 {sound[1]:.3e} (limit {GATE_UPDATE_TOL}); "
        f"planted fault 'the bound not rescaled by T': loss {bad[0]:.3e}, update {bad[1]:.3e}")
    if not (sound[0] <= GATE_LOSS_TOL and sound[1] <= GATE_UPDATE_TOL):
        raise SystemExit("gates: the KL step through the kernels disagrees with plain attention")
    if bad[0] <= GATE_LOSS_TOL and bad[1] <= GATE_UPDATE_TOL:
        raise SystemExit("gates: the KL gate missed its planted fault")
    del net, saved
    torch.cuda.empty_cache()
    log(f"[bpd] phase 27: {time.perf_counter() - t_phase:.1f} s")
    return total


def eight_images(imgs):
    """Eight 1024px images from phase 4's two: each, flipped, and turned."""
    import numpy as np

    out = []
    for im in imgs:
        out += [im, im[:, ::-1], im[::-1], np.rot90(im)]
    return np.ascontiguousarray(np.stack(out)).astype(np.float32) / 255.0


def resized(batch, side: int):
    import numpy as np
    from PIL import Image

    return np.stack([np.asarray(Image.fromarray((im * 255).round().astype(np.uint8)).resize(
        (side, side), Image.BICUBIC), np.float32) / 255.0 for im in batch])


def run_fid_features(dev, card, images) -> None:
    """Phase 28: InceptionV3 (2048 features) with the fixed-seed random
    weights, f32 with TF32 off: activations of 8 1024px images (phase 4's)
    and of the same at 512px on the card against the same extractor on the
    host's CPU (fault: Mixed_7c pooling by average), then img/s at B = 32
    on 1024px inputs, the resize to 299 included."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.models.inception import (
        extract_activations,
        random_inception_params,
    )

    t_phase = time.perf_counter()
    net, host = random_inception_params(0, dev), random_inception_params(0, "cpu")
    for side, batch in ((1024, images), (512, resized(images, 512))):
        got = torch.from_numpy(extract_activations(net, batch, batch=8))
        want = torch.from_numpy(extract_activations(host, batch, batch=8))
        net.Mixed_7c.pool_mode = "avg"
        bad = torch.from_numpy(extract_activations(net, batch, batch=8))
        net.Mixed_7c.pool_mode = "max"
        with tf32_on():
            loose = torch.from_numpy(extract_activations(net, batch, batch=8))
        sound, fault, control = rel_l2(got, want), rel_l2(bad, want), rel_l2(loose, want)
        log(f"[fid] InceptionV3 activations of 8 {side}px images, card vs CPU: relative L2 "
            f"{sound:.3e} (limit {FID_REL_TOL}); planted fault 'Mixed_7c pools by average' "
            f"{fault:.3e}; control 'TF32 on' {control:.3e}; feature std across images "
            f"{float(want.std(0).mean()):.4f}")
        if not (torch.isfinite(got).all() and sound <= FID_REL_TOL < min(fault, control)):
            raise SystemExit("fid: the card's activations disagree with the CPU's, or the gate "
                             "missed its fault")
    x = torch.from_numpy(np.concatenate([images] * 4)).to(dev)
    with torch.no_grad():
        s, _ = median_s(lambda: net(x))
    log(f"[time] {card}: InceptionV3 at B = 32, 1024px inputs (antialiased resize to 299 "
        f"included), f32: {s:.4f} s, {32 / s:.1f} img/s")
    del net, host, x
    torch.cuda.empty_cache()
    log(f"[fid] phase 28: {time.perf_counter() - t_phase:.1f} s")


def run_lpips_dmd(dev, card, fa, images, base_latents) -> dict:
    """Phase 29: LPIPS (VGG16) on the card against the CPU at 512px, B = 4
    pairs (fault: no channel unit-normalisation); one DMD generator step at
    512px, B = 4, on the DMD config (three seeded XL-2), with the LPIPS
    regression of the decoded x0 (a random SDXL VAE) against phase 26's
    teacher base latents: lpips_loss, s/step, peak memory and launches."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.models.lpips import build_lpips
    from pixart_sigma_tpu_torch.models.pixart import init_weights
    from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
    from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
    from pixart_sigma_tpu_torch.training.dmd import make_dmd_train_steps

    t_phase = time.perf_counter()
    lp, host = build_lpips(dev), build_lpips("cpu")
    pairs = torch.from_numpy(resized(images, 512) * 2 - 1)
    a, b = pairs[:4], pairs[4:]

    def unnormalised(model, x0, x1):
        f0, f1 = model.vgg(x0), model.vgg(x1)
        return sum(getattr(model, f"lin{i}")((p - q) ** 2)[:, 0].mean(dim=(1, 2))
                   for i, (p, q) in enumerate(zip(f0, f1)))

    with torch.no_grad():
        got = lp(a.to(dev), b.to(dev)).cpu()
        want = host(a, b)
        bad = unnormalised(lp, a.to(dev), b.to(dev)).cpu()
        with tf32_on():
            loose = lp(a.to(dev), b.to(dev)).cpu()
        s, _ = median_s(lambda: lp(a.to(dev), b.to(dev)))
    sound, fault, control = rel_l2(got, want), rel_l2(bad, want), rel_l2(loose, want)
    log(f"[lpips] LPIPS (VGG16) at 512px, B = 4 pairs, card vs CPU: distances {times(got)}, "
        f"relative L2 {sound:.3e} (limit {LPIPS_REL_TOL}); planted fault 'taps not "
        f"unit-normalised' {fault:.3e}; control 'TF32 on' {control:.3e}")
    log(f"[time] {card}: LPIPS at 512px, B = 4 pairs, f32: {s:.4f} s")
    if not sound <= LPIPS_REL_TOL < min(fault, control):
        raise SystemExit("lpips: the card disagrees with the CPU, or the gate missed its fault")
    del host

    config = read_config(DMD_CONFIG)
    nets = []
    for seed in (50, 51, 52):
        m = build_model_from_config(config, device=dev, train=True)
        g = torch.Generator(device=dev).manual_seed(seed)
        init_weights(m, g)
        perturb_zero_leaves(m, g)
        nets.append(m)
    gen, real, fake = nets
    real.requires_grad_(False)
    fake.requires_grad_(False)
    mc = gen.cfg
    torch.cuda.manual_seed(53)
    vae = build_vae(VAEConfig.sdxl(), device=dev)
    step, _, _ = make_dmd_train_steps(
        mc, IDDPM(timestep_respacing=[1000], learn_sigma=True), start_ts=400,
        lpips_fn=lp, decode_fn=lambda z: vae.decode(z / config.scale_factor),
        generator_optimizer=torch.optim.SGD(gen.parameters(), lr=1e-5))
    y, mask = PseudoT5Embedder(4096, mc.model_max_length).get_text_embeddings(
        synthetic_captions(4, 29))
    batch = {"init_noise": torch.randn((4, 64, 64, 4), device=dev,
                                       generator=torch.Generator(device=dev).manual_seed(54)),
             "y": y.to(dev), "y_mask": mask.to(dev),
             "uncond_y": gen.y_embedder.y_embedding.detach()[None].expand(
                 4, *y.shape[1:]).float(),
             "base_latent": torch.from_numpy(np.asarray(base_latents[:4], np.float32)).to(dev)}
    gstep = torch.Generator(device=dev).manual_seed(55)
    runs = [counted(fa, lambda: step(gen, real, fake, batch, generator=gstep)) for _ in range(2)]
    per_step = add_launches(step_launches(mc, (64, 64)), forward_launches(mc, (64, 64), 2))
    total = dict.fromkeys(TRAIN_COUNTERS, 0)
    for (metrics, _), launches, peak, wall in runs:
        check_launches("dmd regression", launches, per_step)
        total = add_launches(total, launches)
        if not (np.isfinite(metrics["loss"]) and metrics["lpips_loss"] > 0):
            raise SystemExit("dmd regression: the loss is not finite or lpips_loss is 0")
    log(f"[dmd] generator step with the LPIPS regression ({DMD_CONFIG}, 512px, B = 4, base "
        f"latents from phase 26's teacher, regression on the first 2 decoded): "
        + "; ".join(f"dm_loss {r[0][0]['dm_loss']:.6f} lpips_loss {r[0][0]['lpips_loss']:.6f}"
                    for r in runs))
    log(f"[time] {card}: dmd generator step with the regression (B = 4, 512px, SGD): "
        f"{times(r[3] for r in runs)} s (first, second); peak {runs[1][2]:.2f} GiB")
    trace(lambda: step(gen, real, fake, batch, generator=gstep),
          "one dmd generator step with the LPIPS regression, B = 4 (SGD)", card)
    del nets, gen, real, fake, vae, lp, runs, batch
    torch.cuda.empty_cache()
    log(f"[lpips] phase 29: {time.perf_counter() - t_phase:.1f} s")
    return total


def run_vae_trainer(dev, card, tmp: str) -> None:
    """Phase 30: `scripts.train_vae` with the sdxl preset (full SDXL-VAE
    width) at 256px, B = 8, on 64 PNGs, for VAE_TRAIN_STEPS steps, the
    written directory read back by `load_flax_vae` bit for bit; one
    small-preset step (SGD) on the card against the CPU with the same eps
    (fault: eps of another image)."""
    import copy

    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.models.vae import (
        AutoencoderKL,
        VAEConfig,
        init_vae_weights,
        load_flax_vae,
    )
    from pixart_sigma_tpu_torch.scripts import train_vae
    from pixart_sigma_tpu_torch.tools import make_toy_dataset

    t_phase = time.perf_counter()
    data = os.path.join(tmp, "vae_data")
    make_toy_dataset.main(["--out", data, "--n", "64", "--size", "256", "--seed", "30"])
    imgs = os.path.join(data, "InternImgs")
    reset_peak()
    out = train_vae.main(["--data-root", imgs, "--out", os.path.join(tmp, "vae_sdxl"),
                          "--resolution", "256", "--preset", "sdxl", "--batch", "8",
                          "--steps", str(VAE_TRAIN_STEPS), "--log-interval", "1",
                          "--device", str(dev)])
    peak = peak_gib()
    sec = np.diff([0.0] + out["elapsed"])  # every step is logged, and its loss read
    log(f"[vae] scripts.train_vae --preset sdxl, 256px, B = 8, 64 PNGs: losses "
        f"{[round(h[1], 6) for h in out['history']]}")
    log(f"[time] {card}: VAE training step (sdxl preset, 256px, B = 8, f32, TF32 off): "
        f"{times(sec)} s/step, {8 / np.median(sec[1:]):.1f} img/s after the first; peak "
        f"{peak:.2f} GiB")
    back = load_flax_vae(os.path.join(tmp, "vae_sdxl"), device=dev).state_dict()
    same = all(torch.equal(back[k], v) for k, v in out["vae"].state_dict().items())
    log(f"[vae] the written directory read back by load_flax_vae, bit for bit: {same}")
    if not (same and all(np.isfinite(h[1]) for h in out["history"])):
        raise SystemExit("vae: the run failed or its directory does not read back")
    del out, back
    torch.cuda.empty_cache()

    cfg = VAEConfig(**train_vae.PRESETS["small"])
    host = init_vae_weights(AutoencoderKL(cfg), torch.Generator().manual_seed(31)).train()
    batch = torch.from_numpy(train_vae.load_images(train_vae.image_files(imgs)[:4], 128))
    eps = torch.randn((4, 16, 16, cfg.latent_channels), generator=torch.Generator().manual_seed(32))

    def one_step(vae, dev_, e):
        vae = vae.to(dev_)
        before = {n: p.detach().clone() for n, p in vae.named_parameters()}
        loss, _, _ = train_vae.make_train_step(vae, torch.optim.SGD(vae.parameters(), lr=1.0),
                                               1e-6)(batch.to(dev_), e.to(dev_))
        return float(loss), gate_update(before, {n: p.detach() for n, p in
                                                 vae.named_parameters()}).cpu()

    card_net = copy.deepcopy(host)
    loss_c, upd_c = one_step(host, "cpu", eps)
    loss_g, upd_g = one_step(copy.deepcopy(card_net), dev, eps)
    with tf32_on():
        loss_t, upd_t = one_step(copy.deepcopy(card_net), dev, eps)
    loss_f, upd_f = one_step(card_net, dev, eps.roll(1, 0))
    read = lambda l, u: (abs(l - loss_c) / abs(loss_c), rel_l2(u, upd_c))
    sound, bad, control = read(loss_g, upd_g), read(loss_f, upd_f), read(loss_t, upd_t)
    log(f"[vae] one small-preset step (SGD), 128px, B = 4, card vs CPU, the same eps: loss "
        f"{loss_g:.6f} vs {loss_c:.6f}, relative {sound[0]:.3e}; update relative L2 "
        f"{sound[1]:.3e} (limits {VAE_LOSS_TOL}, {VAE_UPDATE_TOL}); planted fault 'eps of "
        f"another image': loss {bad[0]:.3e}, update {bad[1]:.3e}; control 'TF32 on': loss "
        f"{control[0]:.3e}, update {control[1]:.3e}")
    if not (sound[0] <= VAE_LOSS_TOL and sound[1] <= VAE_UPDATE_TOL):
        raise SystemExit("vae: the card's step disagrees with the CPU's")
    for what, r in (("planted fault", bad), ("TF32 control", control)):
        if r[0] <= VAE_LOSS_TOL and r[1] <= VAE_UPDATE_TOL:
            raise SystemExit(f"vae: the gate missed its {what}")
    log(f"[vae] phase 30: {time.perf_counter() - t_phase:.1f} s")


def unmasked_tail(plain):
    """`plain` attention as a kernel that leaves the padding of its last
    128-key tile unmasked: K and V zero-padded to a multiple of 128 keys,
    and a caption's mask ignored."""
    import torch.nn.functional as F

    def attention(q, k, v, key_mask=None):
        pad = -k.shape[1] % 128
        return plain(q, F.pad(k, (0, 0, 0, 0, 0, pad)), F.pad(v, (0, 0, 0, 0, 0, pad)), None)

    return attention


def run_toy_gates(dev, fa, trainer) -> dict:
    """The kernels at phase 31's shapes on its trained model: one training
    step (SGD) on a loader batch of TOY_DIT_BATCH, and one CFG forward of 2
    x 32 rows (32 noised latents of that batch, their captions and the null
    caption, as the sampler's), of which the eps the sampler reads is held;
    each through the kernels and through plain attention with the same t
    and noise. The fault `unmasked_tail` in place of plain attention must
    read beyond the limits. Returns the kernel runs' launches."""
    import torch

    from pixart_sigma_tpu_torch.diffusion.dpm_solver import cfg_batch
    from pixart_sigma_tpu_torch.ops import attention as attn_mod
    from pixart_sigma_tpu_torch.training.train_state import TrainState
    from pixart_sigma_tpu_torch.training.train_step import train_step

    model, diffusion = trainer.model, trainer.diffusion
    mc, hw = model.cfg, (16, 16)
    loader = trainer.build_loader()
    loader.batch_sampler.set_epoch(0)
    batch = trainer.prepare_batch(next(iter(loader)), 0)
    x0, y, mask = batch["latents"], batch["y"], batch["y_mask"]
    gen = torch.Generator(device=dev).manual_seed(31)
    t = torch.randint(0, diffusion.num_timesteps, (x0.shape[0],), generator=gen, device=dev)
    noise = torch.randn(x0.shape, generator=gen, device=dev)
    saved = {n: p.detach().clone() for n, p in model.named_parameters()}
    n = 32
    x_in, y_in = cfg_batch(diffusion.q_sample(x0[:n], t[:n], noise[:n]), y[:n],
                           model.y_embedder.y_embedding.detach()[None].expand(n, *y.shape[1:]))
    t_in, mask_in = torch.cat([t[:n], t[:n]]).float(), torch.cat([mask[:n], mask[:n]])

    def step():
        with torch.no_grad():
            for name, p in model.named_parameters():
                p.copy_(saved[name])
        state = TrainState(model, torch.optim.SGD(model.parameters(), lr=1.0), lambda s: 1.0,
                           ema=False)
        loss = train_step(state, diffusion, batch, t=t, noise=noise,
                          force_drop_ids=torch.zeros(x0.shape[0], device=dev))["loss"]
        return loss, gate_update(saved, {name: p.detach() for name, p in
                                         model.named_parameters()})

    def forward():
        with torch.no_grad():
            return model(x_in, t_in, y_in, mask_in)[..., :mc.in_channels].float()  # eps

    def run(fn, impl, fault=False):
        plain = attn_mod.attention_reference
        set_attn_impl(model, impl)
        if fault:
            attn_mod.attention_reference = unmasked_tail(plain)
        try:
            return counted(fa, fn)
        finally:
            attn_mod.attention_reference = plain
            set_attn_impl(model, "auto")

    launches = dict.fromkeys(TRAIN_COUNTERS, 0)
    for tag, fn, want in (("step", step, step_launches(mc, hw)),
                          ("cfg forward", forward, forward_launches(mc, hw, 1))):
        got, counts, _, _ = run(fn, "auto")
        ref, plain_counts, _, _ = run(fn, "reference")
        bad, _, _, _ = run(fn, "reference", fault=True)
        check_launches(f"toy gate {tag}", counts, want)
        check_launches(f"toy gate {tag} plain", plain_counts, dict.fromkeys(TRAIN_COUNTERS, 0),
                       some=False)
        launches = add_launches(launches, counts)
        if tag == "step":
            read = lambda l, u: (abs(l - ref[0]) / abs(ref[0]), rel_l2(u, ref[1]))
            sound, fault = read(*got), read(*bad)
            log(f"[toy] gate: one training step (SGD), B = {x0.shape[0]}, 12 caption keys, "
                f"kernels vs plain attention: loss {got[0]:.6f} vs {ref[0]:.6f}, relative "
                f"{sound[0]:.3e} (limit {GATE_LOSS_TOL}); update relative L2 {sound[1]:.3e} "
                f"(limit {GATE_UPDATE_TOL}); planted fault 'the padding of the last key tile "
                f"left unmasked': loss {fault[0]:.3e}, update {fault[1]:.3e}")
            ok = sound[0] <= GATE_LOSS_TOL and sound[1] <= GATE_UPDATE_TOL
            caught = fault[0] > GATE_LOSS_TOL or fault[1] > GATE_UPDATE_TOL
        else:
            sound, fault = rel_l2(got, ref), rel_l2(bad, ref)
            log(f"[toy] gate: one CFG forward, 2 x {n} rows, kernels vs plain attention: "
                f"relative L2 {sound:.3e} (limit {TOY_FWD_TOL}); planted fault 'the padding "
                f"of the last key tile left unmasked' {fault:.3e}")
            ok, caught = bool(torch.isfinite(got).all()) and sound <= TOY_FWD_TOL, \
                fault > TOY_FWD_TOL
        if not ok:
            raise SystemExit(f"toy: the {tag} through the kernels disagrees with plain attention")
        if not caught:
            raise SystemExit(f"toy: the {tag} gate missed its planted fault")
    with torch.no_grad():
        for name, p in model.named_parameters():
            p.copy_(saved[name])
    return launches


def toy_loader_reading(card, trainer) -> None:
    """The toy config's B = 256 without the step: the loader alone over one
    epoch (2 batches of 256 feature items) with its worker threads, with
    one, and with as many spawned processes (`loader_processes`, start-up
    included), and train_step alone on a held batch, traced. (Phase 31
    trains at TOY_DIT_BATCH: PERF.md.)"""
    import numpy as np

    from pixart_sigma_tpu_torch.training.train_step import train_step

    trainer.config.train_batch_size = 256
    loader = trainer.build_loader()
    threads = loader.num_workers
    per_batch, after_first = {}, {}
    for key, workers, procs in ((threads, threads, False), (1, 1, False),
                                ("processes", threads, True)):
        loader.num_workers, loader.use_processes = workers, procs
        loader.batch_sampler.set_epoch(0)
        t0 = time.perf_counter()
        got, stamps = [], []
        for batch in loader:
            got.append(batch)
            stamps.append(time.perf_counter())
        per_batch[key] = (stamps[-1] - t0) / len(got)
        # the second batch's wait: the pool is up and the first is read
        after_first[key] = (stamps[-1] - stamps[0]) / max(1, len(got) - 1)
        if procs:
            same = all(np.array_equal(a[k], b[k]) for a, b in zip(batches, got)
                       for k in a if isinstance(a[k], np.ndarray))
            if len(got) != len(batches) or not same:
                raise SystemExit("toy loader: the process pool's batches differ from the "
                                 "threads'")
        else:
            batches = got
    loader.use_processes = False
    batch = trainer.prepare_batch(batches[0], 0)
    step = lambda: train_step(trainer.state, trainer.diffusion, batch,
                              generator=trainer.generator,
                              grad_clip=trainer.config.get("gradient_clip"))
    s, _ = median_s(step)
    log(f"[time] {card}: the toy loader alone at B = 256 (one epoch, {len(batches)} batches "
        f"of 256 feature items): {per_batch[threads]:.4f} s/batch with {threads} threads, "
        f"{per_batch[1]:.4f} with 1, {per_batch['processes']:.4f} with {threads} processes "
        f"(loader_processes, their start-up included; the same batches); after the first "
        f"batch {after_first[threads]:.4f}, {after_first[1]:.4f} and "
        f"{after_first['processes']:.4f} s/batch; train_step alone on a held batch: "
        f"{s:.4f} s")
    trace(step, "one toy train_step at B = 256 on a held batch", card)


def run_toy_workflow(dev, card, fa, tmp: str) -> dict:
    """Phase 31: docs/toy_workflow.md through the port's entry points, cut
    in length: make_toy_dataset, train_vae (small), extract_features
    --vae-flax, the training CLI on the toy config, inference --vae-flax
    --pseudo-t5 64 (20-step DPM-Solver++), compute_fid (two real splits,
    real vs samples, real vs uniform noise), one prompt through the
    interface REPL on stdin. The kernels are gated at the phase's shapes on
    the trained model (`run_toy_gates`), the config's B = 256 is read
    without the step (`toy_loader_reading`), and the samples' FID must be
    below the noise's."""
    import glob
    import io

    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.scripts import inference, interface
    from pixart_sigma_tpu_torch.scripts import train as train_cli
    from pixart_sigma_tpu_torch.scripts import train_vae
    from pixart_sigma_tpu_torch.tools import compute_fid, extract_features, make_toy_dataset
    from pixart_sigma_tpu_torch.utils.png import write_png

    t = {}
    root, vae_dir, run = (os.path.join(tmp, d) for d in ("toy", "toy_vae", "toy_run"))
    data = os.path.join(root, "InternData")
    t0 = time.perf_counter()
    make_toy_dataset.main(["--out", root, "--n", str(TOY_IMAGES), "--size", "128",
                           "--pseudo-t5", "--caption-dim", "64"])
    t["dataset"] = time.perf_counter() - t0

    t0 = time.perf_counter()
    vae_run = train_vae.main(["--data-root", os.path.join(root, "InternImgs"), "--out", vae_dir,
                              "--preset", "small", "--resolution", "128", "--steps",
                              str(TOY_VAE_STEPS), "--log-interval", "100", "--device", str(dev)])
    t["train_vae"] = time.perf_counter() - t0
    vae_losses = [h[1] for h in vae_run["history"]]
    del vae_run

    t0 = time.perf_counter()
    extract_features.main(["--root", data, "--vae-flax", vae_dir, "--resolution", "128",
                           "--batch", "64", "--device", str(dev)])
    t["extract_features"] = time.perf_counter() - t0

    cfg_path = write_config(os.path.join(tmp, "toy_cfg.py"), TOY_CONFIG, data_root=root,
                            vae_pretrained=vae_dir, save_model_steps=TOY_DIT_STEPS,
                            train_batch_size=TOY_DIT_BATCH,
                            save_model_epochs=10**9, log_interval=50,
                            lr_schedule_args={"num_warmup_steps": 30})
    t0 = time.perf_counter()
    trainer, launches_train, peak, _ = counted(fa, lambda: train_cli.main(
        [cfg_path, "--work-dir", run, "--max-steps", str(TOY_DIT_STEPS), "--device", str(dev)]))
    t["train"] = time.perf_counter() - t0
    mc = trainer.model.cfg
    hist = trainer.history
    check_launches("toy train", launches_train, run_launches(mc, [h["hw"] for h in hist]))
    ckpt = sorted(glob.glob(os.path.join(run, "checkpoints", "*.pth")))[-1]
    dit = (hist[0]["loss"], hist[-1]["loss"], np.median([h["seconds"] for h in hist[1:]]),
           sum(h["seconds"] for h in hist))
    t0 = time.perf_counter()
    launches_gates = run_toy_gates(dev, fa, trainer)
    t["gates"] = time.perf_counter() - t0
    t0 = time.perf_counter()
    toy_loader_reading(card, trainer)
    t["loader_b256"] = time.perf_counter() - t0
    del trainer
    torch.cuda.empty_cache()

    with open(os.path.join(data, "data_info.json")) as f:
        prompts = [m["prompt"] for m in json.load(f)][:TOY_SAMPLES]
    with open(os.path.join(tmp, "prompts.txt"), "w") as f:
        f.write("\n".join(prompts) + "\n")
    samples = os.path.join(tmp, "samples")
    common = ["--config", cfg_path, "--model-path", ckpt, "--vae-flax", vae_dir, "--pseudo-t5",
              "64", "--scale-factor", str(TOY_SCALE), "--device", str(dev)]
    t0 = time.perf_counter()
    _, launches_inf, _, _ = counted(fa, lambda: inference.main(
        common + ["--txt-file", os.path.join(tmp, "prompts.txt"), "--save-root", samples,
                  "--sampling-algo", "dpm-solver", "--steps", "20", "--bs", "32"]))
    t["inference"] = time.perf_counter() - t0
    check_launches("toy inference", launches_inf,
                   forward_launches(mc, (16, 16), 20 * -(-TOY_SAMPLES // 32)))

    # FID: two disjoint real splits, real vs the samples, real vs noise
    imgs = sorted(glob.glob(os.path.join(root, "InternImgs", "*.png")))
    splits = {}
    for name, part in (("real_a", imgs[:TOY_SAMPLES]), ("real_b", imgs[TOY_SAMPLES:
                                                                          2 * TOY_SAMPLES])):
        splits[name] = os.path.join(tmp, name)
        os.makedirs(splits[name])
        for p in part:
            os.symlink(p, os.path.join(splits[name], os.path.basename(p)))
    noise_dir = os.path.join(tmp, "noise")
    os.makedirs(noise_dir)
    rng = np.random.default_rng(31)
    for i in range(TOY_SAMPLES):
        write_png(os.path.join(noise_dir, f"{i:03d}.png"),
                  rng.integers(0, 256, (128, 128, 3)).astype(np.uint8))
    acts = os.path.join(tmp, "acts")
    t0 = time.perf_counter()
    fid = {"real_vs_real": compute_fid.main([splits["real_a"], splits["real_b"], "--save-acts",
                                             acts, "--batch", "64", "--device", str(dev)])}
    real = os.path.join(acts, "real_a_acts.npz")
    fid["real_vs_samples"] = compute_fid.main([real, samples, "--batch", "64",
                                               "--device", str(dev)])
    fid["real_vs_noise"] = compute_fid.main([real, noise_dir, "--batch", "64",
                                             "--device", str(dev)])
    t["fid"] = time.perf_counter() - t0

    stdin = sys.stdin
    sys.stdin = io.StringIO(prompts[0] + "\n")
    blocked = sys.modules.get("gradio", False)
    sys.modules["gradio"] = None  # the REPL, as on machines without gradio
    t0 = time.perf_counter()
    try:
        written, launches_repl, _, _ = counted(fa, lambda: interface.main(
            common + ["--save-root", os.path.join(tmp, "demo")]))
    finally:
        sys.stdin = stdin
        if blocked is False:
            del sys.modules["gradio"]
        else:
            sys.modules["gradio"] = blocked
    t["repl"] = time.perf_counter() - t0
    check_launches("toy repl", launches_repl, forward_launches(mc, (16, 16), 20))

    sample_files = sorted(os.listdir(samples))
    log(f"[toy] {TOY_IMAGES} images at 128px (pseudo-T5, 64 dims); VAE (small preset) "
        f"{TOY_VAE_STEPS} steps: loss {vae_losses[0]:.5f} -> {vae_losses[-1]:.5f}; DiT "
        f"({mc.depth} blocks x {mc.hidden_size}, B = {read_config(cfg_path).train_batch_size}) "
        f"{TOY_DIT_STEPS} steps: loss {dit[0]:.5f} -> {dit[1]:.5f}, {dit[2]:.4f} s/step "
        f"(median train_step), {dit[3]:.1f} s in train_step of the CLI's {t['train']:.1f} s "
        f"(the rest: the loader, the model's build, the checkpoint), peak {peak:.2f} GiB; "
        f"{len(sample_files)} samples; REPL wrote {written}")
    log(f"[toy] FID[random(seed=0)]: real vs real {fid['real_vs_real']:.4f}, real vs samples "
        f"{fid['real_vs_samples']:.4f}, real vs uniform noise {fid['real_vs_noise']:.4f}")
    log("[toy] stage seconds: " + ", ".join(f"{k} {v:.1f}" for k, v in t.items()))
    if len(sample_files) != TOY_SAMPLES or len(written) != 1:
        raise SystemExit("toy: the samples or the REPL's image are missing")
    if not fid["real_vs_samples"] < fid["real_vs_noise"]:
        raise SystemExit("toy: the samples' FID is not below the uniform noise's")
    return {"train": launches_train, "gates": launches_gates, "inference": launches_inf,
            "repl": launches_repl}


def run_evaluation(dev, card, fa, images, base_latents) -> dict:
    """Phases 27-31 (27 and 29 need no files; 30 and 31 in one temporary
    directory); returns the launches of each."""
    out = {"bpd": run_bpd(dev, card, fa)}
    run_fid_features(dev, card, images)
    out["dmd_lpips"] = run_lpips_dmd(dev, card, fa, images, base_latents)
    tmp = tempfile.mkdtemp(prefix="pixart_eval_")
    try:
        run_vae_trainer(dev, card, tmp)
        t0 = time.perf_counter()
        out.update({f"toy_{k}": v for k, v in run_toy_workflow(dev, card, fa, tmp).items()})
        log(f"[toy] phase 31: {time.perf_counter() - t0:.1f} s")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    return out


# ---------------------------------------------------------------------------
# phase 32: multi-rank training (parallel/), on the one card

PARALLEL_STEPS = 3
# phase 32a's model: the 1024px config at full width, cut from 28 blocks to
# 8 to keep the script near its length since phase 33 came (the checks are
# bit for bit whatever the depth; the full-depth s/step are in PERF.md)
PARALLEL_MODEL = dict(depth=8, kv_compress_layers=(4, 5, 6, 7))
# phase 32a: the sharded Trainers on one NCCL rank against the plain Trainer
# from the same weights and draws. Over one rank FSDP2's collectives are
# copies and DTensor's local products are the plain ones, so DDP, FSDP and
# tensor parallelism must each equal the plain run bit for bit: parameters,
# EMA and losses. Beside it is logged the relative L2 of the run's change of
# the parameters (and of the EMA), all tensors together, against the plain
# run's (the keys' bias left out: its gradient is rounding noise,
# `_key_bias_free`). Two planted faults on the sharded parameters must be
# rejected: one element of one of them a float32 ulp off (the least fault
# there is), and their EMA held in bfloat16 (a half-precision policy).
# phase 32b: DDP on 2 ranks sharing the card over gloo, the masked toy
# config (every zero-initialised projection perturbed) at a global batch
# of 4 against one process: the same reading over the parameters and the
# EMA; the planted fault "both ranks take rank 0's rows" must read beyond.
GLOO_TOL = 0.1


def _changes(tr) -> tuple:
    """({name: parameter}, {name: EMA}) of a Trainer on one rank, whole
    (a one-rank shard is the tensor) and detached on the card."""
    from pixart_sigma_tpu_torch.parallel.sharded import local, shard_dims

    named = dict(tr.model.named_parameters())
    if any(shard_dims(p) for p in named.values()):
        raise SystemExit("parallel: a one-rank shard is not the whole tensor")
    return ({n: local(p).detach().clone() for n, p in named.items()},
            {n: e.detach().clone() for n, e in tr.state.ema.items()})


def _key_bias_free(name: str, t, hidden: int):
    """`t` without the keys' bias in self- and cross-attention: softmax is
    invariant to a per-query shift of its logits, so their gradient is zero
    and what is computed is rounding noise, which CAME's and Adam's
    normalised updates turn into +-lr whatever its size."""
    if name.endswith("attn.qkv.bias"):
        return __import__("torch").cat([t[:hidden], t[2 * hidden:]])
    if name.endswith("cross_attn.kv_linear.bias"):
        return t[hidden:]
    return t


def _change_reading(got: dict, want: dict, init: dict, names, hidden: int) -> tuple:
    """How far the change from `init` of the tensors `got` is from that of
    `want` over `names`, the keys' bias left out: (relative L2 over all of
    them together, the worst single tensor's, its name). Tensors the
    reference leaves unchanged count in the first only."""
    num = den = 0.0
    worst = (0.0, None)
    for n in names:
        ref = _key_bias_free(n, want[n].float() - init[n].float(), hidden)
        err = float((_key_bias_free(n, got[n].float() - init[n].float(), hidden) - ref).norm())
        norm = float(ref.norm())
        num, den = num + err**2, den + norm**2
        if norm > 0 and err / norm >= worst[0]:
            worst = (err / norm, n)
    return (num**0.5 / max(den**0.5, 1e-30),) + worst


def _same_run(params: dict, ema: dict, hist: list, ref: dict) -> bool:
    """Parameters, EMA and losses of a run equal the reference's bit for bit."""
    import torch

    return (all(torch.equal(params[n], ref["params"][n]) for n in params)
            and all(torch.equal(ema[n], ref["ema"][n]) for n in ema)
            and [h["loss"] for h in hist] == [h["loss"] for h in ref["hist"]])


def _planted_faults(params: dict, ema: dict, sharded: list) -> dict:
    """{fault: (parameters, EMA)}: one element of the first sharded
    parameter a float32 ulp off; the sharded parameters' EMA rounded to
    bfloat16."""
    import torch

    n0 = sharded[0]
    ulp = params[n0].clone()
    flat = ulp.view(-1)
    flat[:1] = torch.nextafter(flat[:1], torch.full_like(flat[:1], float("inf")))
    half = {n: ema[n].to(torch.bfloat16).to(ema[n].dtype) for n in sharded}
    return {f"one ulp in {n0}": ({**params, n0: ulp}, ema),
            "the EMA of the sharded parameters in bf16": (params, {**ema, **half})}


def run_parallel_one_rank(dev, card, fa, tmp: str) -> dict:
    """32a: TRAIN_CONFIG (XL-2 1024px KV-compress) at full width and depth
    PARALLEL_MODEL, from features at B = 4: the plain Trainer, then after
    `initialize_distributed` over one NCCL rank DDP (mesh data = 1), FSDP
    (use_fsdp, the default fsdp_min_size: FSDP2's fully_shard per block and
    at the root) and tensor parallelism (use_tensor_parallel, tensor = 1:
    parallelize_module on the blocks' projections), 3 steps each from the
    same `.pth` and the same draws."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
    from pixart_sigma_tpu_torch.parallel.dist import initialize_distributed
    from pixart_sigma_tpu_torch.parallel.sharded import is_sharded
    from pixart_sigma_tpu_torch.training.train_step import train_step
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    write_feature_dataset(os.path.join(tmp, "data"), [(1024, 1024)] * 12, resolution=1024,
                          valid_tokens=(3, 19), seed=0)
    pth = os.path.join(tmp, "init.pth")
    config = write_config(os.path.join(tmp, "parallel.py"), TRAIN_CONFIG,
                          model_overrides=dict(PARALLEL_MODEL))
    init = {n: t.to(dev) for n, t in random_weights(dev, config, 5, pth=pth).items()}
    runs = (("plain", {}), ("ddp", dict(mesh=dict(data=1))),
            ("fsdp", dict(use_fsdp=True)),
            ("tensor", dict(use_tensor_parallel=True, mesh=dict(data=1, tensor=1))))
    out, ref = {}, None
    for tag, over in runs:
        if tag == "ddp":
            with contextlib.closing(__import__("socket").socket()) as s:
                s.bind(("localhost", 0))
                port = s.getsockname()[1]
            initialize_distributed(f"tcp://localhost:{port}", 1, 0, device=dev)
            log(f"[parallel] process group: NCCL, world 1, tcp://localhost:{port}")
        cfg = features_config(tmp, config=config, train_batch_size=4, load_from=pth, **over)
        tr = Trainer(cfg, os.path.join(tmp, tag), device=dev)
        sharded = [n for n, p in tr.model.named_parameters() if is_sharded(p)]
        launches, hist, peak = counted_train(fa, tr, PARALLEL_STEPS)
        params, ema = _changes(tr)
        secs = [h["seconds"] for h in hist[1:]]
        mc = tr.model.cfg
        expect = run_launches(mc, [h["hw"] for h in hist])
        # TRAIN_STEP_LAUNCHES per block (28 blocks, each alike in its launches)
        fixed = {k: PARALLEL_STEPS * v * mc.depth // 28 for k, v in TRAIN_STEP_LAUNCHES.items()}
        log(f"[parallel] {tag}: {len(sharded)} of {len(params)} parameters sharded "
            f"(DTensors); losses {[round(h['loss'], 6) for h in hist]}, grad norms "
            f"{[round(h['grad_norm'], 5) for h in hist]}; launches {launches} (reckoned "
            f"{expect})")
        log(f"[time] {card}: parallel {tag} step at latents {hist[0]['hw']} (B = 4, depth "
            f"{mc.depth}): {sum(secs) / len(secs):.4f} s/step (steps after the first: "
            f"{times(secs)} s), peak memory {peak:.2f} GiB")
        if launches != expect or launches != fixed:
            raise SystemExit(f"parallel {tag}: launches {launches}, {fixed} expected")
        if not all(np.isfinite(h["loss"]) for h in hist):
            raise SystemExit(f"parallel {tag}: the loss is not finite")
        if tag == "plain":
            ref = dict(hist=hist, params=params, ema=ema)
        else:
            same = _same_run(params, ema, hist, ref)
            log(f"[parallel] {tag} against plain: parameters, EMA and losses equal bit for "
                f"bit: {same}")
            if tag != "ddp":
                if not sharded:
                    raise SystemExit(f"parallel {tag}: no parameter is sharded")
                D = mc.hidden_size
                p_read = _change_reading(params, ref["params"], init, params, D)
                e_read = _change_reading(ema, ref["ema"], init, ema, D)
                log(f"[parallel] {tag} against plain: change of the parameters, relative L2 "
                    f"{p_read[0]:.3e} (worst tensor {p_read[1]:.3e}, {p_read[2]}), of the EMA "
                    f"{e_read[0]:.3e} (worst {e_read[1]:.3e}, {e_read[2]})")
                for fault, (fp, fe) in _planted_faults(params, ema, sharded).items():
                    caught = not _same_run(fp, fe, hist, ref)
                    reading = max(_change_reading(fp, ref["params"], init, params, D)[0],
                                  _change_reading(fe, ref["ema"], init, ema, D)[0])
                    log(f"[parallel] {tag}: planted fault '{fault}': relative L2 "
                        f"{reading:.3e}, rejected: {caught}")
                    if not caught:
                        raise SystemExit(f"parallel {tag}: the gate misses a planted fault")
            if not same:
                raise SystemExit(f"parallel {tag}: differs from the plain Trainer")
        if tag in ("fsdp", "tensor"):
            batch = tr.prepare_batch(next(iter(tr.build_loader())))
            trace(lambda: train_step(tr.state, tr.diffusion, batch, generator=tr.generator,
                                     grad_clip=cfg.gradient_clip),
                  f"one {tag} step on one rank, latents {tuple(batch['latents'].shape[1:3])}, "
                  "B = 4", card)
        out[tag] = launches
        del tr, params, ema
        torch.cuda.empty_cache()
    torch.distributed.destroy_process_group()
    return out


def gloo_ddp_worker(rank: int, spec_path: str) -> int:
    """One of phase 32b's two ranks (`chip_smoke.py --gloo-ddp-rank R SPEC`):
    gloo over the one card, the masked toy config at 2 rows a rank, then
    the same with the planted fault; rank 0 writes the results."""
    import torch
    import torch.distributed as dist

    from pixart_sigma_tpu_torch.ops import flash_attention as fa
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    with open(spec_path) as f:
        spec = json.load(f)
    dist.init_process_group("gloo", init_method=f"file://{spec['store']}", world_size=2,
                            rank=rank)
    results = {}
    for fault in (False, True):
        cfg = features_config(spec["root"], config=MASKED_TOY_CONFIG, train_batch_size=2,
                              mesh=dict(data=2), load_from=spec["load_from"])
        cfg.data = dict(cfg.data, root="toy")
        tr = Trainer(cfg, os.path.join(spec["root"], f"gloo_{fault}"), device=spec["device"])
        if fault:
            tr.batch_rank = 0  # planted: both ranks read (and draw for) rank 0's rows
        reset_train_counts(fa)
        tr.train(max_steps=PARALLEL_STEPS)
        params, ema = _changes(tr)
        results[fault] = dict(params={n: t.cpu() for n, t in params.items()},
                              ema={n: t.cpu() for n, t in ema.items()},
                              hist=[{k: v for k, v in h.items() if k != "hw"} for h in tr.history],
                              launches=train_counts(fa))
    if rank == 0:
        torch.save(results, spec["out"])
    dist.barrier()
    dist.destroy_process_group()
    return 0


def run_parallel_gloo(dev, card, fa, tmp: str) -> dict:
    """32b: two processes on the one card, DDP over gloo (NCCL refuses two
    ranks on one GPU), against the plain Trainer at the global batch."""
    import torch

    from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    write_feature_dataset(os.path.join(tmp, "toy"), [(128, 128)] * 8, resolution=128,
                          multi_scale=False, caption_channels=64, max_length=12, seed=2)
    pth = os.path.join(tmp, "toy_init.pth")
    random_weights(dev, MASKED_TOY_CONFIG, 7, pth=pth)  # every parameter in the gradient's path
    spec = dict(store=os.path.join(tmp, "store"), root=tmp, out=os.path.join(tmp, "gloo.pt"),
                device=str(dev), load_from=pth)
    spec_path = os.path.join(tmp, "gloo.json")
    with open(spec_path, "w") as f:
        json.dump(spec, f)
    t0 = time.perf_counter()
    procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--gloo-ddp-rank",
                               str(r), spec_path], stdout=subprocess.PIPE,
                              stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
    try:
        outs = [p.communicate(timeout=600)[0] for p in procs]
    finally:
        for p in procs:
            p.kill()
    wall = time.perf_counter() - t0
    for r, (p, text) in enumerate(zip(procs, outs)):
        if p.returncode:
            log(text[-4000:])
            raise SystemExit(f"parallel gloo: rank {r} exited {p.returncode}")
    got = torch.load(spec["out"], weights_only=False)
    cfg = features_config(tmp, config=MASKED_TOY_CONFIG, train_batch_size=4, load_from=pth)
    cfg.data = dict(cfg.data, root="toy")
    tr = Trainer(cfg, os.path.join(tmp, "gloo_one"), device=dev)
    init = {n: p.detach().cpu().clone() for n, p in tr.model.named_parameters()}
    tr.train(max_steps=PARALLEL_STEPS)
    want_p = {n: p.detach().cpu() for n, p in tr.model.named_parameters()}
    want_e = {n: e.detach().cpu() for n, e in tr.state.ema.items()}
    read = {}
    D = tr.model.cfg.hidden_size
    for fault in (False, True):
        r = got[fault]
        read[fault] = max(_change_reading(r["params"], want_p, init, init, D),
                          _change_reading(r["ema"], want_e, init, init, D))
    losses = [round(h["loss"], 6) for h in got[False]["hist"]]
    log(f"[parallel] gloo DDP, 2 ranks on one card, masked toy config ({tr.model.cfg.depth} "
        f"blocks of {tr.model.cfg.hidden_size}), 2 rows a rank: losses {losses}, one process "
        f"at B = 4 {[round(h['loss'], 6) for h in tr.history]}; rank 0's launches "
        f"{got[False]['launches']}")
    log(f"[parallel] gloo DDP against one process: change of the parameters or the EMA, "
        f"relative L2 {read[False][0]:.3e} (worst tensor {read[False][1]:.3e}, "
        f"{read[False][2]}), tol {GLOO_TOL}; planted fault 'both ranks take rank 0's rows' "
        f"{read[True][0]:.3e}")
    log(f"[time] {card}: parallel gloo: the two processes' wall time {wall:.1f} s (start-up, "
        "build of both Trainers, 2 x 3 steps; not a scaling figure)")
    if read[False][0] > GLOO_TOL or read[True][0] <= GLOO_TOL:
        raise SystemExit("parallel gloo: DDP differs from one process, or the gate misses "
                         "the planted fault")
    if not any(got[False]["launches"].values()):
        raise SystemExit("parallel gloo: the kernels did not run")
    return got[False]["launches"]


def run_parallel(dev, card, fa) -> dict:
    """Phase 32: 32a (one NCCL rank, full width) and 32b (two gloo ranks)."""
    import torch

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pixart_parallel_")
    try:
        out = run_parallel_one_rank(dev, card, fa, tmp)
        torch.cuda.empty_cache()
        out["gloo_rank0"] = run_parallel_gloo(dev, card, fa, tmp)
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[parallel] phase 32: {time.perf_counter() - t_phase:.1f} s")
    return out


# ---------------------------------------------------------------------------
# phase 33: sequence parallelism, two gloo ranks sharing the card

# (a) scripts.inference --seq-parallel 2 at 1024px (28 x 1152, KV compression
# on 14-27), 20-step DPM-Solver++, CFG 4.5, 2 prompts, against the
# one-process run from the same weights and seed: relative L2 of the
# latents, at most SEQ_SERVE_TOL (every sound run has read 0, bit for bit:
# each query row and product row meets the arithmetic it meets in one
# process), and the planted fault "rank 1's shard shifted by one token row"
# must read beyond (at SEQ_FAULT_STEPS, against as many steps in one
# process: gloo's staged transport costs seconds a model call). (b)
# seqshard (the flash kernel on the shard) and ring attention at the 2K
# shape, N = 16384 over 2 ranks, B*H = 16, against attention_reference on
# picked heads and rows, with the kernel gates. (c) two Trainer steps over
# seq 2 at full width, depth 2 (layer 1 compressed), B = 2 from 1024px
# features, against one process, each reading under its own limit: the
# relative difference of the gradients' global norm (before the clip) at
# each step, and the relative L2 of the last step's clipped gradients and
# of the parameters' change, all tensors together (the keys' bias left
# out). The planted fault "the seq sum's gradients scaled by
# SEQ_FAULT_SCALE" must fail a limit: it moves the norm by its scale, while
# the 0.01 clip and CAME leave the update as it was. (d) each rank's
# launches equal the single-card reckoning at its shard
# (`forward_launches`, `step_launches`).
SEQ_SERVE_TOL = 1e-6
# (the gradients' norm, the clipped gradients, the parameters' change):
# sound readings 1.8e-5, 2.3e-3, 2.7e-3 on the card; bf16 products summed
# over other splits round the gradients otherwise, their norm far less
SEQ_TRAIN_TOLS = (1e-3, 1e-2, 1e-2)
SEQ_FAULT_SCALE = 1.005
SEQ_TRAIN_MODEL = dict(depth=2, kv_compress_layers=(1,))
SEQ_FAULT_STEPS = 2
# phase 33a's trajectories, cut from 20 steps to 10 and then 4 (when phase
# 36 came): the 2-rank CLI is bound by gloo's host staging, which a slow
# host stretches; the check is bit for bit at any length
SEQ_CLI_STEPS = 4
SEQ_TRAIN_STEPS = 2  # the first at the schedule's LR 0 (JAX's warm-up rule)
SEQ_MESH = dict(data=1, seq=2)
SEQ_2K = 16384
SEQ_PICKS = ((0, slice(0, 512)), (9, slice(4000, 4512)), (15, slice(7680, 8192)))


# the shapes a seq rank hands each kernel (phase 3 checks them, phase 33 runs them)
SEQ_SHARD_SHAPES = {
    "onepass": "N = 2048 (4096 over 2 ranks) against M = 4096 and 1024 gathered keys",
    "allheads": "N = 2048 against M = 300 caption keys",
    "headsmajor": "N = 2048 against M = 300 (forced only)",
    "flash_forward": "N = 8192 (16384 over 2 ranks) against M = 16384 gathered keys",
    "flash_bwd_dkv": "N = 2048 against M = 4096 and 300 keys (the training shard)",
    "flash_bwd_dq": "N = 2048 against M = 4096 and 300 keys (the training shard)",
}


def seq_cli(root: str, pth: str, save: str, seq: bool, steps: int = SEQ_CLI_STEPS) -> list:
    argv = ["--config", TRAIN_CONFIG, "--model-path", pth, "--txt-file",
            os.path.join(root, "prompts.txt"), "--pseudo-t5", "4096", "--bs", "2",
            "--save-root", save, "--device", "cuda", "--steps", str(steps)]
    return argv + (["--seq-parallel", "2"] if seq else [])


def seq_latents(save: str, steps: int = SEQ_CLI_STEPS):
    import numpy as np

    return np.stack([np.load(os.path.join(save, f"{i:05d}_dpm-solver_{steps}.jpg.npy"))
                     for i in (0, 1)])


def seq_train_config(root: str, pth: str, mesh: dict = None):
    """Phase 33c's Trainer config (2 rows a batch rank), over `mesh` when
    given; tensor parallel when its tensor axis is above 1."""
    keys = {} if mesh is None else dict(mesh=mesh,
                                        use_tensor_parallel=mesh.get("tensor", 1) > 1)
    return features_config(root, train_batch_size=2, load_from=pth,
                           lr_schedule_args=dict(num_warmup_steps=0),
                           model_overrides=dict(SEQ_TRAIN_MODEL), **keys)


def _timed(fn, n: int = 3) -> list:
    import torch

    out = []
    for _ in range(n):
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        out.append(time.perf_counter() - t0)
    return out


def seq_rank_worker(rank: int, spec_path: str) -> int:
    """One of phase 33's two ranks (`chip_smoke.py --seq-rank R SPEC`): (a)
    the inference CLI under --seq-parallel 2, then with the planted fault on
    rank 1; (b) the 2K attention; (c) a Trainer step over seq 2, then with
    the planted fault. Rank 0 writes the results."""
    import torch

    from pixart_sigma_tpu_torch.ops import flash_attention as fa
    from pixart_sigma_tpu_torch.ops.attention import ring_attention, seq_sharded_attention
    from pixart_sigma_tpu_torch.parallel import dist as pdist
    from pixart_sigma_tpu_torch.parallel.mesh import SeqContext
    from pixart_sigma_tpu_torch.scripts import inference
    from pixart_sigma_tpu_torch.training import train_step
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    with open(spec_path) as f:
        spec = json.load(f)
    # gloo: NCCL refuses two ranks on one card; the CLI and the Trainer join this group
    pdist.initialize_distributed(f"tcp://127.0.0.1:{spec['port']}", 2, rank, device="cuda",
                                 backend="gloo", timeout=600)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    root, out = spec["root"], {}
    plain_shard, plain_sum = SeqContext.shard, train_step.sum_over_seq

    def shifted(self, x, dim=1):  # planted: this rank's tokens one latent row early
        if x.shape[dim] != spec["tokens"]:
            return plain_shard(self, x, dim)
        n = self.shard_len(x.shape[dim])
        return x.narrow(dim, self.rank * n - spec["row"], n)

    for fault in (False, True):  # (a)
        if fault and rank == 1:
            SeqContext.shard = shifted
        reset_train_counts(fa)
        pdist.TRANSPORTS.clear()
        steps = SEQ_FAULT_STEPS if fault else SEQ_CLI_STEPS
        seconds = _timed(lambda: inference.main(
            seq_cli(root, spec["pth"], os.path.join(root, f"seq_{fault}"), True, steps)), 1)[0]
        out["serve", fault] = dict(seconds=seconds, launches=train_counts(fa),
                                   transports=dict(pdist.TRANSPORTS))
        SeqContext.shard = plain_shard

    seq = SeqContext(torch.distributed.group.WORLD, 2, rank)  # (b)
    gen = torch.Generator(device="cuda").manual_seed(5)
    q, k, v = (torch.randn((1, SEQ_2K, 16, 72), generator=gen, device="cuda")
               .to(torch.bfloat16) for _ in range(3))
    ql, kl, vl = (seq.shard(x) for x in (q, k, v))
    reset_train_counts(fa)
    got = {"seqshard": seq_sharded_attention(ql, kl, vl, seq=seq)}
    launches = train_counts(fa)
    got["ring"] = ring_attention(ql, kl, vl, seq=seq)
    torch.cuda.synchronize()
    reads = {}
    for name, o in got.items():
        rs = []
        for h, rows in SEQ_PICKS:
            want = fa.attention_reference(ql[:, rows, h:h + 1], k[:, :, h:h + 1], v[:, :, h:h + 1])
            rs.append(readings(o[:, rows, h:h + 1], want))
        reads[name] = tuple(max(r[i] for r in rs) for i in range(3))
    del got
    times_ = {"seqshard": _timed(lambda: seq_sharded_attention(ql, kl, vl, seq=seq)),
              "ring": _timed(lambda: ring_attention(ql, kl, vl, seq=seq))}
    out["attention"] = dict(readings=reads, launches=launches, seconds=times_)
    del q, k, v, ql, kl, vl
    torch.cuda.empty_cache()

    def scaled_sum(state):  # planted: the seq sum's gradients a little too large
        plain_sum(state)
        for p in state.model.parameters():
            if p.grad is not None:
                p.grad.mul_(SEQ_FAULT_SCALE)

    for fault in (False, True):  # (c)
        if fault:
            train_step.sum_over_seq = scaled_sum
        tr = Trainer(seq_train_config(root, spec["pth_train"], SEQ_MESH),
                     os.path.join(root, f"train_{fault}"), device="cuda")
        reset_train_counts(fa)
        tr.train(max_steps=SEQ_TRAIN_STEPS)
        train_step.sum_over_seq = plain_sum
        named = list(tr.model.named_parameters())
        out["train", fault] = dict(launches=train_counts(fa),
                                   grads=_grads(tr.model),
                                   params={n: p.detach().float().cpu() for n, p in named},
                                   hist=[{k: v for k, v in h.items() if k != "hw"}
                                         for h in tr.history])
        del tr
        torch.cuda.empty_cache()
    if rank == 0:
        torch.save(out, spec["out"])
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def _rel(got: dict, want: dict, names, hidden: int, init: dict = None) -> float:
    """Relative L2 of `got` against `want` over `names` together (their
    change from `init` when given), the keys' bias left out."""
    import torch

    if init is None:
        init = {n: torch.zeros_like(want[n]) for n in names}
    return _change_reading(got, want, init, names, hidden)[0]


def _grads(model) -> dict:
    """{name: the parameter's gradient (zeros where none flowed), f32 on the
    host}."""
    import torch

    return {n: (torch.zeros_like(p) if p.grad is None else p.grad).detach().float().cpu()
            for n, p in model.named_parameters()}


def seq_train_reference(dev, tmp: str, pth_train: str, init: dict) -> dict:
    """Phase 33c's one-process run (SEQ_TRAIN_STEPS steps of
    `seq_train_config` from `pth_train`, whose weights are `init`, on the
    features under `tmp`), which phase 36 reads too: its history, its last
    step's clipped gradients and its parameters, whole on the host."""
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    tr = Trainer(seq_train_config(tmp, pth_train), os.path.join(tmp, "train_one"), device=dev)
    tr.train(max_steps=SEQ_TRAIN_STEPS)
    named = list(tr.model.named_parameters())
    out = dict(tmp=tmp, pth_train=pth_train, init=init, hist=list(tr.history),
               grads=_grads(tr.model), params={n: p.detach().float().cpu() for n, p in named},
               names=[n for n, _ in named], hidden=tr.model.cfg.hidden_size, mc=tr.model.cfg)
    del tr
    sys.modules["torch"].cuda.empty_cache()
    return out


def seq_train_files(dev, tmp: str) -> tuple:
    """Phase 33c's weights (`SEQ_TRAIN_MODEL`, seed 34, as a `.pth`) and
    features (4 items at 1024px) under `tmp`: (the .pth, its weights)."""
    from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset

    pth_train = os.path.join(tmp, "xl2_depth2.pth")
    cfg_train = write_config(os.path.join(tmp, "depth2.py"), TRAIN_CONFIG,
                             model_overrides=dict(SEQ_TRAIN_MODEL))
    init = random_weights(dev, cfg_train, 34, pth=pth_train)
    write_feature_dataset(os.path.join(tmp, "data"), [(1024, 1024)] * 4, resolution=1024,
                          seed=3)
    return pth_train, init


def free_port() -> int:
    import socket

    with socket.socket() as sock:
        sock.bind(("127.0.0.1", 0))
        return sock.getsockname()[1]


def run_seq_parallel(dev, card, fa) -> tuple:
    """Phase 33: two processes on the one card over gloo (NCCL refuses two
    ranks on one GPU), the compute on the card, gloo's transport of CUDA
    tensors for all-gather, reduce-scatter and send/recv staged through host
    memory (`parallel.dist`). Returns (its launches, 33c's one-process
    reference, whose `tmp` holds its files for phase 36, which removes
    it)."""
    import numpy as np

    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.scripts import inference

    t_phase = time.perf_counter()
    tmp = tempfile.mkdtemp(prefix="pixart_seq_")
    done = False
    try:
        with open(os.path.join(tmp, "prompts.txt"), "w") as f:
            f.write("a watercolor painting of a lighthouse on a cliff at dusk\n"
                    "a small robot reading a book in a sunlit library full of plants\n")
        pth = os.path.join(tmp, "xl2.pth")
        random_weights(dev, TRAIN_CONFIG, 33, pth=pth)
        pth_train, init = seq_train_files(dev, tmp)
        spec = dict(root=tmp, pth=pth, pth_train=pth_train, port=free_port(), tokens=64 * 64,
                    row=64, out=os.path.join(tmp, "seq.pt"))
        spec_path = os.path.join(tmp, "seq.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seq-rank",
                                   str(r), spec_path], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in (0, 1)]
        try:
            outs = [p.communicate(timeout=900)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        wall = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode:
                log(text[-6000:])
                raise SystemExit(f"seq parallel: rank {r} exited {p.returncode}")
        got = torch.load(spec["out"], weights_only=False)

        # (a) against one process from the same weights and seed
        reset_train_counts(fa)
        t_one = _timed(lambda: inference.main(seq_cli(tmp, pth, os.path.join(tmp, "one"),
                                                      False)), 1)[0]
        one_launches = train_counts(fa)
        inference.main(seq_cli(tmp, pth, os.path.join(tmp, "one_short"), False, SEQ_FAULT_STEPS))
        read = {}
        for fault, one, steps in ((False, "one", SEQ_CLI_STEPS),
                                  (True, "one_short", SEQ_FAULT_STEPS)):
            want = seq_latents(os.path.join(tmp, one), steps)
            got_ = seq_latents(os.path.join(tmp, f"seq_{fault}"), steps)
            read[fault] = float(np.linalg.norm(got_ - want) / np.linalg.norm(want))
        mc = build_model_from_config(read_config(TRAIN_CONFIG), device="meta").cfg
        per_rank = forward_launches(mc, (128, 128), SEQ_CLI_STEPS)
        serve = got["serve", False]
        log(f"[seq] (a) scripts.inference --seq-parallel 2, 1024px 28 x 1152, {SEQ_CLI_STEPS} "
            f"steps CFG 4.5, "
            f"2 prompts, 2 gloo ranks on the card: latents vs one process relative L2 "
            f"{read[False]:.3e} (tol {SEQ_SERVE_TOL}); planted fault 'rank 1's shard one token "
            f"row early' {read[True]:.3e} ({SEQ_FAULT_STEPS} steps); rank 0's launches {serve['launches']} (one process "
            f"{one_launches}); transports {serve['transports']}")
        log(f"[time] {card}: seq (a): the CLI's wall, model build and load included: 2 ranks "
            f"{serve['seconds']:.1f} s, one process {t_one:.1f} s")
        if not np.isfinite(want).all() or read[False] > SEQ_SERVE_TOL or \
                read[True] <= SEQ_SERVE_TOL:
            raise SystemExit("seq parallel (a): the sharded trajectory differs from one process, "
                             "or the gate misses the planted fault")
        check_launches("seq", serve["launches"], per_rank)
        if one_launches != per_rank:
            raise SystemExit(f"seq parallel (a): one process launched {one_launches}")

        # (b) the 2K attention
        att = got["attention"]
        for name, r in att["readings"].items():
            log(f"[seq] (b) {name} attention over 2 ranks, B*H=16 N=M={SEQ_2K}, rank 0's rows "
                f"on heads 0/9/15 vs attention_reference: max|err| {r[0]:.3e}, elementwise "
                f"{r[1]:.3e} (tol {ELEM_TOL}), relative L2 {r[2]:.3e} (tol {L2_TOL}); s per call "
                f"{times(att['seconds'][name])}")
        log(f"[seq] (b) seqshard's launches on rank 0 {att['launches']} (flash 1: queries "
            f"{SEQ_2K // 2} against {SEQ_2K} keys)")
        if not all(passes(r) for r in att["readings"].values()) or \
                att["launches"]["flash_forward"] != 1:
            raise SystemExit("seq parallel (b): 2K attention disagrees with its plain version")

        # (c) one Trainer step against one process
        ref = seq_train_reference(dev, tmp, pth_train, init)
        reads = {fault: seq_train_reading(got["train", fault], ref) for fault in (False, True)}
        want_steps = run_launches(ref["mc"], [(128, 128)] * SEQ_TRAIN_STEPS)
        sound = got["train", False]
        log(f"[seq] (c) {SEQ_TRAIN_STEPS} Trainer steps over seq 2, 1152 wide, depth 2 (layer 1 "
            f"compressed), B = 2 at 1024px, vs one process: the gradients' norm {reads[False][0]:.3e}, the clipped "
            f"gradients {reads[False][1]:.3e}, the parameters' change {reads[False][2]:.3e} (tols "
            f"{SEQ_TRAIN_TOLS}); planted fault 'the seq sum scaled by {SEQ_FAULT_SCALE}' "
            f"{', '.join(f'{x:.3e}' for x in reads[True])}; losses "
            f"{[round(h['loss'], 6) for h in sound['hist']]} vs "
            f"{[round(h['loss'], 6) for h in ref['hist']]}; grad norms "
            f"{[round(h['grad_norm'], 6) for h in sound['hist']]} vs "
            f"{[round(h['grad_norm'], 6) for h in ref['hist']]}")
        log(f"[time] {card}: seq (c): the step's seconds over 2 ranks "
            f"{times(h['seconds'] for h in sound['hist'])} s, one process "
            f"{times(h['seconds'] for h in ref['hist'])} s")
        if not seq_train_within(reads[False]) or seq_train_within(reads[True]):
            raise SystemExit("seq parallel (c): the sharded step differs from one process, or "
                             "the gate misses the planted fault")
        check_launches("seq", sound["launches"], want_steps)
        log(f"[time] {card}: seq: the two processes' wall {wall:.1f} s (start-up, (a) twice, "
            "(b), (c) twice)")
        done = True
    finally:
        if not done:
            shutil.rmtree(tmp, ignore_errors=True)
    log(f"[seq] phase 33: {time.perf_counter() - t_phase:.1f} s")
    return dict(serve=dict(serve["launches"]), train=dict(sound["launches"]),
                attention_2k=dict(att["launches"])), ref


def seq_train_reading(run: dict, ref: dict) -> tuple:
    """Phase 33c's readings of a sharded run against the one-process
    reference, the keys' bias left out: (the largest relative difference of
    the gradients' norm over the steps, the relative L2 of the last step's
    clipped gradients, that of the parameters' change)."""
    names, hidden = ref["names"], ref["hidden"]
    return (max(abs(a["grad_norm"] / b["grad_norm"] - 1) for a, b in zip(run["hist"], ref["hist"])),
            _rel(run["grads"], ref["grads"], names, hidden),
            _rel(run["params"], ref["params"], names, hidden, ref["init"]))


def seq_train_within(reading: tuple) -> bool:
    return all(x <= tol for x, tol in zip(reading, SEQ_TRAIN_TOLS))


# ---------------------------------------------------------------------------
# phase 36: the seq axis with tensor parallelism, four gloo ranks sharing the
# card. SEQ_TRAIN_STEPS Trainer steps over tensor 2 x seq 2 (each rank holds
# half of every block's projections and half of each image's tokens; the
# ranks of a tensor group share their token shard and run all heads) at
# phase 33c's model, weights, config and batch, against 33c's one-process
# run under 33c's limits (SEQ_TRAIN_TOLS; the keys' bias left out). The
# tensor layers' all-gathers go through parallel.dist, staged through host
# memory (DTensor's functional all-gather crashes the process on CUDA
# tensors over gloo, torch 2.11); DTensor's all-reduces run as they are. Two planted faults, each on
# the tensor-sharded parameters alone, must fail a limit. Each rank's
# launches must equal the single-card reckoning at its token shard
# (`step_launches`).
SEQ_TENSOR_MESH = dict(data=1, tensor=2, seq=2)
SEQ_TENSOR_FAULTS = ("the tensor-sharded gradients counted on both seq ranks in the clip's norm",
                     "tensor rank 1's fc1 shard read from rank 0's columns")


def seq_tensor_worker(rank: int, spec_path: str) -> int:
    """One of phase 36's four ranks (`chip_smoke.py --seqtp-rank R SPEC`):
    the Trainer over tensor 2 x seq 2, then with each planted fault. Every
    rank writes its launches, transports and history; rank 0 also the whole
    clipped gradients and parameters."""
    import torch

    from pixart_sigma_tpu_torch.ops import flash_attention as fa
    from pixart_sigma_tpu_torch.parallel import dist as pdist
    from pixart_sigma_tpu_torch.parallel.sharded import full_state, local, shard_dims, sharded_sum
    from pixart_sigma_tpu_torch.training import train_step
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    with open(spec_path) as f:
        spec = json.load(f)
    # gloo: NCCL refuses two ranks on one card
    pdist.initialize_distributed(f"tcp://127.0.0.1:{spec['port']}", 4, rank, device="cuda",
                                 backend="gloo", timeout=600)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    plain_norm = train_step.global_norm

    def counted_twice(params):  # planted: the sharded part summed over the seq pair too
        sharded = [(local(p.grad).float().square().sum(), shard_dims(p.grad)) for p in params
                   if p.grad is not None and shard_dims(p.grad)]
        return torch.sqrt(plain_norm(params) ** 2 + sharded_sum(sharded))

    def fc1_from_rank0(tr):  # planted: tensor rank 1 holds rank 0's fc1 columns
        if tr.mesh.get_local_rank("tensor") != 1:
            return
        whole = torch.load(spec["pth_train"], map_location="cpu", weights_only=True)["state_dict"]
        with torch.no_grad():
            for i, block in enumerate(tr.model.blocks):
                for kind in ("weight", "bias"):
                    shard = local(getattr(block.mlp.fc1, kind))
                    shard.copy_(whole[f"blocks.{i}.mlp.fc1.{kind}"][:shard.shape[0]])

    out = {}
    for i, fault in enumerate((None,) + SEQ_TENSOR_FAULTS):
        if fault == SEQ_TENSOR_FAULTS[0]:
            train_step.global_norm = counted_twice
        tr = Trainer(seq_train_config(spec["root"], spec["pth_train"], SEQ_TENSOR_MESH),
                     os.path.join(spec["root"], f"seqtp_{i}"), device="cuda")
        if fault == SEQ_TENSOR_FAULTS[1]:
            fc1_from_rank0(tr)
        reset_train_counts(fa)
        pdist.TRANSPORTS.clear()
        tr.train(max_steps=SEQ_TRAIN_STEPS)
        launches, transports = train_counts(fa), dict(pdist.TRANSPORTS)
        train_step.global_norm = plain_norm
        named = dict(tr.model.named_parameters())
        grads = full_state(((n, local(p.grad if p.grad is not None else torch.zeros_like(p)))
                            for n, p in named.items()), named)
        params = full_state(((n, local(p)) for n, p in named.items()), named)
        out[fault] = dict(launches=launches, transports=transports,
                          hist=[{k: v for k, v in h.items() if k != "hw"} for h in tr.history])
        if rank == 0:
            out[fault].update(grads={n: g.float() for n, g in grads.items()},
                              params={n: t.float() for n, t in params.items()})
        del tr, named, grads, params
        torch.cuda.empty_cache()
    torch.save(out, spec["out"].format(rank=rank))
    torch.distributed.barrier()
    torch.distributed.destroy_process_group()
    return 0


def run_seq_tensor(dev, card, fa, ref: dict = None) -> dict:
    """Phase 36: four processes on the one card over gloo, mesh tensor 2 x
    seq 2, against phase 33c's one-process reference `ref` (made here when
    not given); removes the reference's files."""
    import torch

    t_phase = time.perf_counter()
    if ref is None:
        tmp = tempfile.mkdtemp(prefix="pixart_seqtp_")
        ref = seq_train_reference(dev, tmp, *seq_train_files(dev, tmp))
    tmp = ref["tmp"]
    try:
        spec = dict(root=tmp, pth_train=ref["pth_train"], port=free_port(),
                    out=os.path.join(tmp, "seqtp_{rank}.pt"))
        spec_path = os.path.join(tmp, "seqtp.json")
        with open(spec_path, "w") as f:
            json.dump(spec, f)
        t0 = time.perf_counter()
        procs = [subprocess.Popen([sys.executable, os.path.abspath(__file__), "--seqtp-rank",
                                   str(r), spec_path], stdout=subprocess.PIPE,
                                  stderr=subprocess.STDOUT, text=True) for r in range(4)]
        try:
            outs = [p.communicate(timeout=600)[0] for p in procs]
        finally:
            for p in procs:
                p.kill()
        wall = time.perf_counter() - t0
        for r, (p, text) in enumerate(zip(procs, outs)):
            if p.returncode:
                log(text[-6000:])
                raise SystemExit(f"seq x tensor: rank {r} exited {p.returncode}")
        got = [torch.load(spec["out"].format(rank=r), weights_only=False) for r in range(4)]
        reads = {fault: seq_train_reading(got[0][fault], ref)
                 for fault in (None,) + SEQ_TENSOR_FAULTS}
        sound = got[0][None]
        log(f"[seqtp] {SEQ_TRAIN_STEPS} Trainer steps over tensor 2 x seq 2 (4 gloo ranks on the "
            f"card), 1152 wide, depth 2 (layer 1 compressed), B = 2 at 1024px, vs one process: "
            f"the gradients' norm {reads[None][0]:.3e}, the clipped gradients "
            f"{reads[None][1]:.3e}, the parameters' change {reads[None][2]:.3e} (tols "
            f"{SEQ_TRAIN_TOLS}); losses {[round(h['loss'], 6) for h in sound['hist']]} vs "
            f"{[round(h['loss'], 6) for h in ref['hist']]}; grad norms "
            f"{[round(h['grad_norm'], 6) for h in sound['hist']]} vs "
            f"{[round(h['grad_norm'], 6) for h in ref['hist']]}")
        for fault in SEQ_TENSOR_FAULTS:
            log(f"[seqtp] planted fault '{fault}': "
                f"{', '.join(f'{x:.3e}' for x in reads[fault])}")
        per_step = {k: v / SEQ_TRAIN_STEPS for k, v in sound["transports"].items()}
        log(f"[seqtp] rank 0's transports per step {per_step}")
        log(f"[time] {card}: seqtp: the step's seconds over tensor 2 x seq 2, rank 0 "
            f"{times(h['seconds'] for h in sound['hist'])} s, one process "
            f"{times(h['seconds'] for h in ref['hist'])} s; the four processes' wall "
            f"{wall:.1f} s (start-up, 3 Trainers of {SEQ_TRAIN_STEPS} steps)")
        if not seq_train_within(reads[None]) or any(seq_train_within(reads[f])
                                                     for f in SEQ_TENSOR_FAULTS):
            raise SystemExit("seq x tensor: the sharded step differs from one process, or the "
                             "gate misses a planted fault")
        want_steps = run_launches(ref["mc"], [(128, 128)] * SEQ_TRAIN_STEPS)
        for r in range(4):
            check_launches(f"seqtp rank {r}", got[r][None]["launches"], want_steps)
        native = [k for r in got for k in r[None]["transports"] if "staged" not in k]
        if native or not sound["transports"]:
            raise SystemExit(f"seq x tensor: parallel.dist's collectives of CUDA tensors over "
                             f"gloo not staged through host memory: {native}")
    finally:
        shutil.rmtree(tmp, ignore_errors=True)
    log(f"[seqtp] phase 36: {time.perf_counter() - t_phase:.1f} s")
    return dict(train=dict(sound["launches"]))


# ---------------------------------------------------------------------------
# Phase 34: every head dim up to 128. The kernels run a head dim at the padded
# width 64, 80 or 128 (csrc/hopper_common.cuh); one off a multiple of 8 is
# zero-padded by the wrapper, with the true head dim's softmax scale.

HEAD_DIMS = (1, 8, 18, 36, 64, 72, 80, 88, 96, 120, 128)
# (b): XL-2 at its published width of 1152 with 9 heads (Dh = 128: its
# self-attention runs flash, past the onepass gate) and with 12 (Dh = 96)
HEAD_DIM_MODELS = (9, 12)
# (b)'s limit, relative L2 of the 1024px latents through the kernels
# against plain attention on the card; the planted fault, K's columns
# [64, 128) dropped in every attention call of the plain run, must read
# above it (readings in PERF.md)
HEAD_DIM_PATH_TOL = 3e-2
# phase 34b's trajectories, cut from 20 steps to 10 and then 5 to keep the
# script well inside its time limit as phases 35 and 36 came
HEAD_DIM_PATH_STEPS = 5

# phase 35: the committed orbax fixture, and how much the decoder's rate is
# timed over (MB of output), and the limits of its model's f32 output
# against the JAX model's (relative L2): plain attention on the card runs
# f32 products (TF32 off); the kernels round f32 inputs to bf16 (ROADMAP
# Queue 3), whose sound readings elsewhere are at most 3.3e-3
ORBAX_FIXTURE = "tests/fixtures/orbax_small"
ORBAX_TIMED_BYTES = 256 * 2**20
ORBAX_PLAIN_TOL = 1e-4
ORBAX_KERNEL_TOL = L2_TOL
ORBAX_SAMPLE_STEPS = 4
HEAD_DIM_CAPTIONS = (300, (256, 300), 77, 3)  # phase 3's caption masks, one not a prefix


def heads_of(dh: int) -> int:
    """Heads that keep H * Dh near XL-2's 1152."""
    return max(1, round(1152 / dh))


def picked_heads(H: int) -> list:
    """The heads the plain versions are held to: first, middle and last."""
    return sorted({0, H // 2, H - 1})


def drop_columns(x):
    """x with its head-dim columns [64, 128) set to 0."""
    x = x.clone()
    x[..., 64:] = 0
    return x


def self_attention_kernel(keys: int, dh: int) -> str:
    """The kernel a block's self-attention runs, by the kernels' gates: onepass
    up to 4096 padded keys with a head dim below its 128-lane padding,
    flash otherwise."""
    return "flash_forward" if -(-keys // 128) * 128 > 4096 or dh % 128 == 0 else "onepass"


COLUMNS_FAULT = "K columns [64, 128) dropped"


def head_dim_faults(dh: int) -> list:
    """The faults planted at head dim dh besides the generic ones: K's
    columns [64, 128) dropped (width 128), and the logit scale of the padded
    head dim (a head dim off a multiple of 8)."""
    return ([COLUMNS_FAULT] if dh > 80 else []) + (
        [f"logit scale of the padded head dim {dh + (-dh % 8)}"] if dh % 8 else [])


def check_head_dim_forward(fa, cases, name, dh, B, N, M, lengths, dtype) -> tuple[float, bool]:
    """One forward kernel (`name`) at head dim dh, H = heads_of(dh), on every
    head, held to its plain version on the picked heads (q/k/v rounded to
    bf16 as the kernel reads them), and the planted faults: key tile
    [128, 256) skipped and those of `head_dim_faults`; onepass and flash
    also their lse."""
    torch_ = sys.modules["torch"]
    H = heads_of(dh)
    heads = picked_heads(H)
    if name in ("allheads", "headsmajor"):
        qf, kf, vf, mask, _ = cases.allheads(B, N, M, lengths, H, dh, dtype=dtype)
        q, k, v = (x.unflatten(-1, (H, dh)) for x in (qf, kf, vf))
    else:
        q, k, v = cases.onepass(B, N, M, H, dh, dtype=dtype)
        mask = None if lengths is None else cases.lengths_mask(lengths, M)
    lse = None
    if name == "onepass":
        out, lse = fa._onepass_forward(q, k, v, None if mask is None else fa.mask_bias(mask),
                                       with_lse=True)
    elif name == "flash":
        q = fa._flash_scale_q(q)  # the plain versions below take the pre-scaled q
        out, lse = fa._flash_forward(q, k, v, fa._flash_madd(mask, dtype),
                                     fa._flash_tail(M, None), with_lse=True)
    elif name == "allheads":
        out = fa.crossattn_allheads(qf, kf, vf, mask, H).unflatten(-1, (H, dh))
    else:
        out = fa.crossattn_headsmajor(q, k, v, mask)
    torch_.cuda.synchronize()
    pick = lambda x: x[:, :, heads]
    pq, pk, pv = (pick(x).to(torch_.bfloat16).to(dtype) for x in (q, k, v))

    def plain(q_, k_, keep=None):
        m = mask if keep is None else (keep if mask is None else keep & mask)
        if name == "onepass":
            return fa._plain_forward(q_, k_, pv, None if m is None else fa.mask_bias(m))
        if name == "flash":
            return flash_plain(fa, q_, k_, pv, fa._flash_madd(m, dtype))
        ref = fa.attention_reference if name == "allheads" else fa.headsmajor_reference
        return ref(q_, k_, pv, m), None

    want, lse_want = plain(pq, pk)
    faults = {}
    if M > 256:
        keep = torch_.ones((B, M), dtype=torch_.bool, device=q.device)
        keep[:, 128:256] = False
        faults["key tile [128, 256) skipped"] = plain(pq, pk, keep)[0]
    padded_scale = ((pq.float() * (dh / (dh + (-dh % 8))) ** 0.5).to(dtype), pk)
    for fault in head_dim_faults(dh):
        faults[fault] = plain(*((pq, drop_columns(pk)) if fault == COLUMNS_FAULT
                                else padded_scale))[0]
    label = (f"Dh={dh} {name} B={B} H={H} N={N} M={M}"
             f"{'' if lengths is None else f' valid={lengths}'}"
             f"{' f32' if dtype == torch_.float32 else ''}, heads {heads}")
    err, ok = compare(label, pick(out), want, faults)
    if lse is not None:
        got = lse[:, heads]
        finite = torch_.isfinite(lse_want)
        ok &= bool(torch_.equal(finite, torch_.isfinite(got)))
        ok &= check_lse(label, got[finite], lse_want[finite])
    return err, ok


def check_head_dim_backward(fa, cases, dh, B, N, M, lengths, dtype) -> tuple[dict, bool]:
    """The onepass forward with its lse, then dkv and dq, at head dim dh on
    every head, held to the plain backward on the picked heads, with its
    planted faults: query tile [64, 128) skipped, lse + 1, and those of
    `head_dim_faults` (the padded head dim's scale is the plain backward's
    logit scale and chain factor). Returns ({kernel: max |err|}, ok)."""
    torch_ = sys.modules["torch"]
    H = heads_of(dh)
    heads = picked_heads(H)
    if lengths is None:
        q, k, v = cases.onepass(B, N, M, H, dh, dtype=dtype)
        madd = None
    else:
        qf, kf, vf, mask, _ = cases.allheads(B, N, M, lengths, H, dh, dtype=dtype)
        q, k, v = (x.unflatten(-1, (H, dh)) for x in (qf, kf, vf))
        madd = fa.mask_bias(mask)
    do = cases.randn(B, N, H, dh, dtype=dtype)
    out, lse = fa._onepass_forward(q, k, v, madd, with_lse=True)
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    madd_b = None if madd is None else madd.to(dtype).float()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, madd_b, lse, delta)
    dq = fa.flash_bwd_dq(q, k, v, do, madd_b, lse, delta)
    torch_.cuda.synchronize()
    pick = lambda x: x[:, :, heads]
    pq, pk, pv, pdo = (pick(x).to(torch_.bfloat16).to(dtype) for x in (q, k, v, do))
    lse_p, delta_p = lse[:, heads], delta[:, heads]
    ref = lambda q_=pq, k_=pk, l=lse_p, scales=(None, None): fa.flash_backward_reference(
        q_, k_, pv, madd_b, l, delta_p, pdo, *scales)
    want = ref()
    skipped = lse_p.clone()
    skipped[:, :, 64:128] = float("inf")
    faults = {"query tile [64, 128) skipped": ref(l=skipped), "lse + 1": ref(l=lse_p + 1)}
    dp = dh + (-dh % 8)
    for fault in head_dim_faults(dh):
        faults[fault] = (ref(k_=drop_columns(pk)) if fault == COLUMNS_FAULT else
                         ref(scales=(dp**-0.5 * fa.LOG2E, dp**-0.5)))
    label = (f"Dh={dh} backward B={B} H={H} N={N} M={M}"
             f"{'' if lengths is None else f' valid={lengths}'}"
             f"{' f32' if dtype == torch_.float32 else ''}, heads {heads}")
    errs, ok = {}, True
    for kname, got, idx in (("dkv", dk, 1), ("dkv", dv, 2), ("dq", dq, 0)):
        err, good = compare(f"{label} d{'qkv'[idx]}", pick(got), want[idx],
                            {f: o[idx] for f, o in faults.items()})
        errs[kname] = max(errs.get(kname, 0.0), err)
        ok &= good
    return errs, ok


def head_dim_times(fa, cases, card, dh: int, mask_path) -> dict:
    """At head dim dh, H = 1152 / dh: each kernel's time at the 1024px shapes
    (onepass at N = M = 4096 and M = 1024, flash at N = M = 4096, allheads and
    headsmajor on the trajectory's captions, dkv and dq at N = M = 4096),
    its plain version's, `scaled_dot_product_attention`'s (forward, or its
    backward for dkv and dq; timed only) and the bound, which H * Dh = 1152
    makes the Dh = 72 rows' bound. Returns {kernel: [row]}."""
    import torch
    import torch.nn.functional as F

    H, B = 1152 // dh, 4
    rows = {}

    def row(name, N, M, valid, ms, plain_ms, lib_ms, flops, nbytes, extra=""):
        b_ms, by = bound_ms(flops, nbytes)
        log(f"[time] {card}: Dh={dh} {name} B={B} H={H} N={N} M={M}{extra}: kernel {ms:.4f} ms, "
            f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; "
            f"{flops / 1e9:.2f} GFLOP, {nbytes / 1e6:.1f} MB), share of bound {b_ms / ms:.3f}")
        rows.setdefault(name, []).append(dict(head_dim=dh, heads=H, B=B, N=N, M=M,
                                              valid_keys=valid, ms=ms, plain_ms=plain_ms,
                                              bound_ms=b_ms, bound_by=by, library_ms=lib_ms))

    for name, N, M, mask in (("onepass", 4096, 4096, None), ("onepass", 4096, 1024, None),
                             ("flash_forward", 4096, 4096, None),
                             ("allheads", 4096, 300, mask_path),
                             ("headsmajor", 4096, 300, mask_path)):
        if mask is None:
            q, k, v = cases.onepass(B, N, M, H, dh)
            valid = B * M
        else:
            qf, kf, vf, _, _ = cases.allheads(B, N, M, (M,) * B, H, dh)
            q, k, v = (x.unflatten(-1, (H, dh)) for x in (qf, kf, vf))
            valid = int(mask.sum())
        kern, plain = {
            "onepass": (lambda: fa.onepass_attention(q, k, v),
                        lambda: fa.attention_reference(q, k, v)),
            "flash_forward": (lambda: fa.flash_attention(q, k, v),
                              lambda: fa.flash_reference_with_lse(q, k, v)),
            "allheads": (lambda: fa.crossattn_allheads(qf, kf, vf, mask, H),
                         lambda: fa.attention_reference(q, k, v, mask)),
            "headsmajor": (lambda: fa.crossattn_headsmajor(q, k, v, mask),
                           lambda: fa.headsmajor_reference(q, k, v, mask)),
        }[name]
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        am = None if mask is None else mask[:, None, None, :]
        lib = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        ms, plain_ms, lib_ms = cuda_ms(kern), cuda_ms(plain, iters=3, warmup=1), cuda_ms(lib)
        row(name, N, M, valid, ms, plain_ms, lib_ms, 4.0 * H * N * valid * dh,
            2.0 * (2 * B * N * H * dh + 2 * valid * H * dh),
            "" if mask is None else f" ({valid} valid keys of {B * M})")
        del q, k, v, qt, kt, vt
        torch.cuda.empty_cache()
    N = M = 4096
    q, k, v = cases.onepass(B, N, M, H, dh)
    do = cases.randn(B, N, H, dh)
    qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
    out_t = F.scaled_dot_product_attention(qt, kt, vt)
    do_t = do.transpose(1, 2).contiguous()
    lib_ms = cuda_ms(lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t, retain_graph=True))
    del qt, kt, vt, out_t, do_t
    q, lse, delta, scales, *_ = backward_launch(fa, q, k, v, do, False)
    args = (q, k, v, do, None, lse, delta, *scales)
    plain_ms = cuda_ms(lambda: fa.flash_backward_reference(q, k, v, None, lse, delta, do),
                       iters=3, warmup=1)
    io = 2.0 * 4 * B * N * H * dh + 4.0 * 2 * B * H * N
    for name, products in (("flash_bwd_dkv", 4), ("flash_bwd_dq", 3)):
        fn = getattr(fa, name)
        row(name, N, M, B * M, cuda_ms(lambda: fn(*args)), plain_ms, lib_ms,
            products * 2.0 * H * N * B * M * dh, io + 2.0 * (2 if products == 4 else 1) * B * N * H * dh)
    del q, k, v, do, lse, delta, args
    torch.cuda.empty_cache()
    return rows


def head_dim_paths(dev, card, fa, t5, vae, prompts, negative) -> dict:
    """(b): the 1024px DPM-Solver++ trajectory (HEAD_DIM_PATH_STEPS) with CFG 4.5 of XL-2 at
    full width and depth (28 blocks of 1152, KV compression conv x2 on layers
    14-27, 300-token captions) with 9 and with 12 heads, seeded random
    weights (zero-initialised leaves perturbed), through the kernels against
    plain attention on the card; the launches against `forward_launches`,
    and the planted fault. Returns {heads: launches}."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2, init_weights
    from pixart_sigma_tpu_torch.ops import attention as attention_module
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline

    @contextlib.contextmanager
    def k_columns_dropped():
        orig = attention_module.attention_reference
        attention_module.attention_reference = (
            lambda q, k, v, key_mask=None: orig(q, drop_columns(k), v, key_mask))
        try:
            yield
        finally:
            attention_module.attention_reference = orig

    call = dict(num_inference_steps=HEAD_DIM_PATH_STEPS, guidance_scale=4.5,
                negative_prompt=negative, seed=0,
                return_latents=True)
    out = {}
    for heads in HEAD_DIM_MODELS:
        model = PixArtMS_XL_2(
            input_size=128, pe_interpolation=2.0, model_max_length=300,
            kv_compress_sampling="conv", kv_compress_scale=2,
            kv_compress_layers=tuple(range(14, 28)), num_heads=heads, device=dev)
        gen = torch.Generator(device=dev).manual_seed(0)
        init_weights(model, gen)
        perturb_zero_leaves(model, gen)
        pipe = PixArtPipeline(model, t5=t5, vae=vae, device=dev)
        dh = model.cfg.hidden_size // heads
        t0 = time.perf_counter()
        reset_train_counts(fa)
        lat_k = pipe(prompts, **call)
        counts = train_counts(fa)
        t1 = time.perf_counter()
        set_attn_impl(model, "reference")
        lat_r = pipe(prompts, **call)
        t2 = time.perf_counter()
        with k_columns_dropped():
            lat_f = pipe(prompts, **call)
        set_attn_impl(model, "auto")
        rel = float(np.linalg.norm(lat_k - lat_r) / np.linalg.norm(lat_r))
        rel_f = float(np.linalg.norm(lat_f - lat_r) / np.linalg.norm(lat_r))
        want = forward_launches(model.cfg, (128, 128), HEAD_DIM_PATH_STEPS)
        log(f"[heads] XL-2 1024px, 28 blocks x 1152, {heads} heads (Dh = {dh}), "
            f"{HEAD_DIM_PATH_STEPS} steps CFG 4.5: "
            f"latents {tuple(lat_k.shape)}, kernels vs plain attention on the card: relative L2 "
            f"{rel:.3e} (limit {HEAD_DIM_PATH_TOL}); planted fault, K columns [64, 128) dropped "
            f"in plain attention: {rel_f:.3e} "
            f"{'rejected' if rel_f > HEAD_DIM_PATH_TOL else 'NOT REJECTED'}; trajectory through "
            f"the kernels {t1 - t0:.2f} s, through plain attention {t2 - t1:.2f} s")
        check_launches("heads", counts, want)
        if not np.isfinite(lat_k).all() or lat_k.std() == 0 or lat_k.shape != (2, 128, 128, 4):
            raise SystemExit(f"{heads}-head trajectory latents are wrong or not finite")
        if not rel <= HEAD_DIM_PATH_TOL < rel_f:
            raise SystemExit(f"{heads}-head trajectory: the kernels disagree with plain "
                             "attention, or the gate misses the planted fault")
        out[heads] = counts
        del pipe, model
        torch.cuda.empty_cache()
    return out


def head_dim_gradients(dev, fa) -> dict:
    """(c): one 1024px training step of the 9-head (Dh = 128) model cut to
    depth 4 (KV compression on layers 2-3, B = 2, 4096 tokens, so layers 0-1
    run flash at width 128 and its backward), through the kernels against
    plain attention: the parameters' gradients (GRAD_REL_TOL over all and
    for the worst) and the gradient of q, k and v of layers 0-1 per image and
    128-row tile (GRAD_TILE_TOL). Planted faults in the flash backward:
    dK's columns [64, 128) zeroed, and dQ without its ln 2 chain factor.
    Returns the launches."""
    n = 64 * 64

    def fails(r) -> bool:
        rel, worst, tile = r
        return not (rel <= GRAD_REL_TOL and worst[0] <= GRAD_REL_TOL and tile[0] <= GRAD_TILE_TOL)

    def dk_columns(dkdv):
        dk, dv = dkdv
        return drop_columns(dk), dv

    hw = (128, 128)
    sound, launches, mc, faulty = step_gradients(
        dev, fa, dict(input_size=128, pe_interpolation=2.0, depth=4, num_heads=9,
                      model_max_length=300, kv_compress_sampling="conv", kv_compress_scale=2,
                      kv_compress_layers=(2, 3)),
        hw, (19, 3), (120, 731), (0, 1),
        {"dK columns [64, 128) zeroed": output_fault(fa, "flash_bwd_dkv", n, dk_columns),
         "dQ without the ln 2 chain factor": output_fault(fa, "flash_bwd_dq", n,
                                                          lambda dq: dq / fa.LN2)},
        watch=(0, 1))
    expect = step_launches(mc, hw)
    log(f"[heads] (c) 9-head model (Dh = 128), depth 4, B = 2, latents {hw} ({n} tokens, 1024 "
        f"compressed): launches {launches}, reckoned {expect}")
    for name, r in [("none (sound)", sound)] + list(faulty.items()):
        rel, worst, tile = r
        log(f"[heads] (c) planted fault {name}: parameters relative L2 {rel:.3e} over all, "
            f"worst {worst[1]} {worst[0]:.3e} (tol {GRAD_REL_TOL}); q/k/v gradient of layers "
            f"0-1, worst tile {tile[1]} {tile[0]:.3e} (tol {GRAD_TILE_TOL}): "
            f"{'rejected' if fails(r) else 'passes'}")
    if launches != expect or launches["flash_forward"] == 0:
        raise SystemExit(f"head-dim gradient gate launches {launches}, reckoned {expect}")
    if fails(sound):
        raise SystemExit("Dh = 128 training gradients disagree with plain attention")
    if not all(fails(r) for r in faulty.values()):
        raise SystemExit("the Dh = 128 gradient gate missed a planted fault")
    return launches


def run_head_dims(dev, card, fa, cases, t5, vae, prompts, negative, mask_path) -> dict:
    """Phase 34: (a) each kernel at every head dim of HEAD_DIMS against its
    plain version, with the planted faults; (b) the 9- and 12-head 1024px
    trajectories; (c) the 9-head training step's gradients; and the times
    at Dh = 128 and 96. Returns {"errs": {kernel: {dh: max |err|}},
    "launches": {heads: ...}, "train": launches, "times": {kernel: rows}}."""
    import torch

    t_phase = time.perf_counter()
    log(f"[heads] (a) every kernel at head dims {HEAD_DIMS}, H = 1152 / Dh heads, the 1024px "
        "shapes, bf16 and f32; the widths the kernels run them at: "
        f"{ {dh: fa.head_dim_width(dh + (-dh % 8)) for dh in HEAD_DIMS} }")
    errs = {name: {} for name in ("onepass", "flash_forward", "allheads", "headsmajor",
                                  "flash_bwd_dkv", "flash_bwd_dq")}
    ok = True
    bf16, f32 = torch.bfloat16, torch.float32
    for dh in HEAD_DIMS:
        for name, B, N, M, lengths, dtype in (
                ("onepass", 4, 4096, 4096, None, bf16),
                ("onepass", 4, 4096, 300, HEAD_DIM_CAPTIONS, bf16),
                ("onepass", 2, 1000, 1008, None, f32),
                ("flash", 4, 4096, 4096, None, bf16),
                ("flash", 2, 4096, 2500, (2500, 1100), bf16),
                ("flash", 2, 1000, 1300, None, f32),
                ("allheads", 4, 4096, 300, HEAD_DIM_CAPTIONS, bf16),
                ("allheads", 4, 1000, 77, (77, 40, 5, 1), f32),
                ("headsmajor", 4, 4096, 300, HEAD_DIM_CAPTIONS, bf16),
                ("headsmajor", 4, 1000, 77, (77, 40, 5, 1), f32)):
            err, good = check_head_dim_forward(fa, cases, name, dh, B, N, M, lengths, dtype)
            key = "flash_forward" if name == "flash" else name
            errs[key][dh] = max(errs[key].get(dh, 0.0), err)
            ok &= good
        for B, N, M, lengths, dtype in ((4, 4096, 4096, None, bf16),
                                        (4, 4096, 300, HEAD_DIM_CAPTIONS, bf16),
                                        (2, 1000, 300, (300, 40), f32)):
            bwd_errs, good = check_head_dim_backward(fa, cases, dh, B, N, M, lengths, dtype)
            for kname, err in bwd_errs.items():
                key = f"flash_bwd_{kname}"
                errs[key][dh] = max(errs[key].get(dh, 0.0), err)
            ok &= good
        torch.cuda.empty_cache()
    log(f"[heads] (a): {time.perf_counter() - t_phase:.1f} s")
    if not ok:
        raise SystemExit("a kernel disagrees with its plain version at some head dim, or the "
                         "check missed a planted fault")
    times_ = {}
    for dh in (128, 96):
        for name, rows in head_dim_times(fa, cases, card, dh, mask_path).items():
            times_.setdefault(name, []).extend(rows)
    t_b = time.perf_counter()
    launches = head_dim_paths(dev, card, fa, t5, vae, prompts, negative)
    log(f"[heads] (b): {time.perf_counter() - t_b:.1f} s")
    train = head_dim_gradients(dev, fa)
    torch.cuda.empty_cache()
    log(f"[heads] phase 34: {time.perf_counter() - t_phase:.1f} s")
    return dict(errs=errs, launches=launches, train=train, times=times_)


def orbax_chunk_ok(zstd, raw: bytes, want_sha: str) -> bool:
    """The check of phase 35a: the C++ and the Python decoder give the same
    bytes, whose SHA-256 is the fixture's digest; a decoder that refuses
    the frame fails it."""
    try:
        cpp = zstd.decompress_native(raw).tobytes()
        py = zstd.decompress(raw)
    except zstd.ZstdError:
        return False
    return cpp == py and hashlib.sha256(cpp).hexdigest() == want_sha


def first_compressed_block(raw: bytes) -> tuple:
    """(start, size) of the first compressed block of a one-frame zstd chunk,
    or None."""
    fhd = raw[4]
    pos = 5 + (0 if (fhd >> 5) & 1 else 1) + (0, 1, 2, 4)[fhd & 3]
    pos += (1 if (fhd >> 5) & 1 else 0, 2, 4, 8)[fhd >> 6]
    while pos + 3 <= len(raw):
        h = int.from_bytes(raw[pos:pos + 3], "little")
        kind, size = (h >> 1) & 3, h >> 3
        if kind == 2:
            return pos + 3, size
        pos += 3 + (1 if kind == 1 else size)
        if h & 1:
            return None
    return None


def run_orbax(dev, card, fa) -> dict:
    """Phase 35 (see the module docstring); returns the launches of its
    sample and of its resumed training step."""
    from concurrent.futures import ThreadPoolExecutor

    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
    from pixart_sigma_tpu_torch.models.builder import build_model_from_config
    from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline
    from pixart_sigma_tpu_torch.training.trainer import Trainer
    from pixart_sigma_tpu_torch.utils import zstd
    from pixart_sigma_tpu_torch.utils.checkpoint import load_checkpoint
    from pixart_sigma_tpu_torch.utils.ocdbt import OcdbtStore

    t_phase = time.perf_counter()
    config_path = os.path.join(ORBAX_FIXTURE, "config.py")
    step_dir = os.path.join(ORBAX_FIXTURE, "checkpoints", "step_2")
    with open(os.path.join(ORBAX_FIXTURE, "expected.json")) as f:
        expected = json.load(f)

    # (a) every chunk: C++ = Python = digest; a flipped byte must fail it
    store = OcdbtStore(step_dir)
    digest = {".".join(leaf["path"]): leaf["sha256"] for leaf in expected["leaves"]}
    chunks = {k: store.read(k) for k in store.keys() if not k.endswith("/.zarray")}
    if sorted(k.rsplit("/", 1)[0] for k in chunks) != sorted(digest):
        raise SystemExit("orbax: the fixture's chunks are not one per leaf of expected.json")
    bad = [k for k, raw in chunks.items() if not orbax_chunk_ok(zstd, raw, digest[
        k.rsplit("/", 1)[0]])]
    blocks = {k: first_compressed_block(raw) for k, raw in chunks.items()}
    faulty = max((k for k in chunks if blocks[k]), key=lambda k: blocks[k][1])
    raw = bytearray(chunks[faulty])
    start, size = blocks[faulty]
    raw[start + size // 2] ^= 0x10
    caught = not orbax_chunk_ok(zstd, bytes(raw), digest[faulty.rsplit("/", 1)[0]])
    out_bytes = sum(len(zstd.decompress_native(r)) for r in chunks.values())
    log(f"[orbax] phase 35a: {len(chunks)} chunks ({sum(map(len, chunks.values()))} B stored, "
        f"{out_bytes} B decoded; {sum(1 for b in blocks.values() if b)} with a compressed "
        f"block), C++ = Python = expected.json's SHA-256 on {len(chunks) - len(bad)}; planted "
        f"fault, one byte flipped in {faulty}'s compressed block of {size} B: "
        f"{'caught' if caught else 'NOT CAUGHT'}")
    if bad or not caught:
        raise SystemExit(f"orbax: chunks {bad[:4]} fail the decode check, or the planted fault "
                         "passes it")

    # (b) the decoders' rates; what they give for PixArt-Sigma-XL-2. The
    # fixture's chunks are small (2.2 KB decoded on average, where XL-2's run
    # to MBs), so a call per chunk also times the binding; the same chunks
    # joined into one buffer of back-to-back frames time the decoder alone
    raws = list(chunks.values())
    reps = -(-ORBAX_TIMED_BYTES // out_bytes)
    t0 = time.perf_counter()
    for _ in range(reps):
        for r in raws:
            zstd.decompress_native(r)
    per_chunk = reps * out_bytes / (time.perf_counter() - t0) / 1e6
    joined = b"".join(raws) * reps
    t0 = time.perf_counter()
    zstd.decompress_native(joined, reps * out_bytes)
    cpp_1 = reps * out_bytes / (time.perf_counter() - t0) / 1e6
    threads = 8
    share = b"".join(raws) * -(-reps // threads)
    t0 = time.perf_counter()
    with ThreadPoolExecutor(threads) as pool:
        list(pool.map(lambda _: zstd.decompress_native(share), range(threads)))
    cpp_8 = threads * (len(share) // len(b"".join(raws))) * out_bytes / (
        time.perf_counter() - t0) / 1e6
    del joined, share
    t0 = time.perf_counter()
    for r in raws:
        zstd.decompress(r)
    py_1 = out_bytes / (time.perf_counter() - t0) / 1e6
    xl2 = build_model_from_config(read_config(TRAIN_CONFIG), device="meta", train=True)
    n_params = sum(p.numel() for p in xl2.parameters())
    tree = 4 * n_params  # f32
    came = 3 * tree  # params, EMA, CAME's momentum (its factored statistics are small)
    log(f"[orbax] phase 35b: C++ decoder over the fixture's chunks ({reps} passes, "
        f"{reps * out_bytes / 2**20:.0f} MiB out): {per_chunk:.1f} MB/s a call per chunk, "
        f"{cpp_1:.1f} MB/s joined into one buffer on one thread, {cpp_8:.1f} MB/s on "
        f"{threads} threads (host: {os.cpu_count()} cores); Python {py_1:.3f} MB/s (one "
        f"pass); PixArt-Sigma-XL-2 ({n_params} parameters): one f32 tree "
        f"{tree / 1e9:.3f} GB -> {tree / 1e6 / cpp_1:.1f} s on one thread, "
        f"{tree / 1e6 / cpp_8:.1f} s on {threads}, {tree / 1e6 / py_1 / 60:.0f} min in "
        f"Python; a CAME resume (params, EMA, momentum: {came / 1e9:.2f} GB) "
        f"{came / 1e6 / cpp_8:.1f} s on {threads} threads; {card}")
    del xl2

    # (c) the model through load_checkpoint on the card: JAX's f32 output; a sample
    config = read_config(config_path)
    model = load_checkpoint(step_dir, build_model_from_config(config, device=dev))
    inp = {k: torch.tensor(v, device=dev) for k, v in expected["inputs"].items()}
    want = np.asarray(expected["output"], np.float32)
    outs = {}
    with torch.no_grad():
        for impl in ("reference", "auto"):
            set_attn_impl(model, impl)
            outs[impl] = model(inp["x"], inp["t"], inp["y"], inp["mask"]).float().cpu().numpy()
    rel = lambda a, b: float(np.linalg.norm(a - b) / np.linalg.norm(b))
    rel_plain, rel_kernel = rel(outs["reference"], want), rel(outs["auto"], want)
    pipe = PixArtPipeline(model, t5=PseudoT5Embedder(32, config.model_max_length), device=dev)
    call = dict(height=config.image_size, width=config.image_size,
                num_inference_steps=ORBAX_SAMPLE_STEPS, guidance_scale=4.5, seed=0,
                negative_prompt="blurry", return_latents=True)
    prompts = ["a cat on a mat", "a red circle"]
    lat_k, sample_launches, _, secs = counted(fa, lambda: pipe(prompts, **call))
    set_attn_impl(model, "reference")
    lat_r = pipe(prompts, **call)
    set_attn_impl(model, "auto")
    rel_sample = rel(lat_k, lat_r)
    side = config.image_size // 8
    log(f"[orbax] phase 35c: {config_path} ({model.cfg.depth} blocks x {model.cfg.hidden_size}, "
        f"{model.cfg.num_heads} heads) from {step_dir} on the card: f32 output vs the JAX "
        f"model's, relative L2 {rel_plain:.3e} with plain attention (limit {ORBAX_PLAIN_TOL}), "
        f"{rel_kernel:.3e} through the kernels (limit {ORBAX_KERNEL_TOL}); "
        f"{ORBAX_SAMPLE_STEPS}-step DPM-Solver++ CFG 4.5 at {config.image_size}px, kernels vs "
        f"plain attention {rel_sample:.3e} (limit {PATH_REL_TOL}), {secs:.2f} s")
    check_launches("orbax", sample_launches,
                   forward_launches(model.cfg, (side, side), ORBAX_SAMPLE_STEPS))
    if not (rel_plain <= ORBAX_PLAIN_TOL and rel_kernel <= ORBAX_KERNEL_TOL
            and rel_sample <= PATH_REL_TOL and np.isfinite(lat_k).all()
            and lat_k.shape == (2, side, side, 4)):
        raise SystemExit("orbax: the loaded model disagrees with the JAX model's output, or "
                         "its sample with plain attention")
    del pipe, model

    # (d) a Trainer resumed from the fixture with "latest", one step on the kernels
    with tempfile.TemporaryDirectory() as tmp:
        shutil.copytree(os.path.join(ORBAX_FIXTURE, "checkpoints"),
                        os.path.join(tmp, "work", "checkpoints"))
        data_root = os.path.join(tmp, "data")
        write_feature_dataset(os.path.join(data_root, config.data["root"]),
                              [(config.image_size, config.image_size)] * 4,
                              resolution=config.image_size, caption_channels=32,
                              max_length=config.model_max_length, valid_tokens=(3, 8))
        config.update(data_root=data_root, train_batch_size=2, num_workers=2, log_interval=1,
                      resume_from=dict(checkpoint="latest"))
        config.data = dict(config.data, load_vae_feat=True, load_t5_feat=True)
        trainer = Trainer(config, os.path.join(tmp, "work"), device=dev)
        trainer.build_state(config.num_epochs * 2)
        resumed = trainer.maybe_resume()
        _, step_counts, _, secs = counted(fa, lambda: trainer.train(max_steps=1))
        hist = trainer.history[-1]
        log(f"[orbax] phase 35d: resume_from='latest' in a work dir of the fixture's "
            f"checkpoints: step {resumed}; one step on the kernels to step "
            f"{trainer.state.step}: loss {hist['loss']:.4f}, grad norm {hist['grad_norm']:.4f}, "
            f"{secs:.2f} s")
        check_launches("orbax", step_counts, step_launches(trainer.model.cfg, (side, side)))
        if not (resumed == expected["step"] == 2 and trainer.state.step == 3
                and np.isfinite(hist["loss"]) and np.isfinite(hist["grad_norm"])):
            raise SystemExit("orbax: the resumed Trainer did not start at step 2 or its step is "
                             "not finite")
    log(f"[orbax] phase 35: {time.perf_counter() - t_phase:.1f} s")
    return {"sample": sample_launches, "resumed_step": step_counts}


def main() -> int:
    try:
        import torch
    except ImportError:
        print("chip_smoke: torch is not installed", file=sys.stderr)
        return 1
    if not torch.cuda.is_available():
        print("chip_smoke: no CUDA device", file=sys.stderr)
        return 1
    try:
        from pixart_sigma_tpu_torch.ops import _build
        from pixart_sigma_tpu_torch.ops import flash_attention as fa
    except ImportError as e:
        print(f"chip_smoke: run from the repository root ({e})", file=sys.stderr)
        return 1
    import torch.nn.functional as F

    from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2, init_weights
    from pixart_sigma_tpu_torch.models.t5 import PseudoT5Embedder
    from pixart_sigma_tpu_torch.ops.attention import CROSSATTN_ENV
    from pixart_sigma_tpu_torch.models.vae import VAEConfig, build_vae
    from pixart_sigma_tpu_torch.pipelines import PixArtPipeline

    t_start = time.perf_counter()
    dev = torch.device("cuda")

    # ---- 1. device -------------------------------------------------------
    card = card_line()
    kind = torch.cuda.get_device_name(0)
    count = torch.cuda.device_count()
    log(f"[device] {card}")
    log(f"[device] torch {torch.__version__} cuda {torch.version.cuda}: {kind}, count {count}")
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    log("[device] tf32 off for matmuls and cuDNN convolutions in every phase, "
        "comparisons and timed runs alike")

    # ---- 2. build --------------------------------------------------------
    t0 = time.perf_counter()
    logs = _build.build(_build.KERNELS + _build.HOST_SOURCES)
    if logs:
        log(f"[build] {len(logs)} sources in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a; "
            f"the zstd decoder of {_build.HOST_SOURCES} with the host C++ compiler)")
    else:
        log(f"[build] nothing to compile: libraries for these sources are in {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill", "C7514", "arning")):
                log(f"  {name}: {line.strip()}")
    bwd = _build.load("flash_backward")
    for width in fa.WIDTHS:
        log(f"  dynamic shared memory per block at width {width}: onepass "
            f"{_build.load('onepass_attention').onepass_attention_smem_bytes(width)} B, "
            f"allheads and headsmajor "
            f"{_build.load('cross_attention').cross_attention_smem_bytes(width)} B, dkv "
            f"{bwd.flash_bwd_dkv_smem_bytes(width)} B, dq {bwd.flash_bwd_dq_smem_bytes(width)} B, "
            f"flash {_build.load('flash_forward').flash_forward_smem_bytes(width)} B")
    # each checks its key tile and stages against the wrapper's
    fa._onepass_lib(), fa._flash_lib(), fa._cross_lib(), fa._backward_lib()
    log(f"  keys per tile: onepass and flash {fa.KEY_TILE} (a ring of {fa.KEY_STAGES} K/V "
        f"stages by width), allheads and headsmajor {fa.CROSS_KEY_TILE} (an extent of up to "
        f"{fa.CROSS_KEY_STAGES} tiles resident, longer ones streamed), dkv and dq "
        f"{fa.BWD_KEY_TILE} (dq's ring {fa.BWD_KEY_STAGES} stages); the planted skipped "
        "tile, the extent faults and the spike inputs follow them")

    # ---- 3. kernels against their plain versions ------------------------
    log("[kernels] seeded inputs at the path shapes (B = 2 prompts x CFG), bf16 "
        "unless marked f32; f32 inputs are rounded to bf16 for the tensor cores")
    cases = Cases(dev)
    errs = {"onepass": [], "allheads": []}
    all_ok = True
    # N = 2048: a sequence-parallel rank's query shard (4096 tokens over 2
    # ranks) against the whole keys, phase 33's launches
    for N, M, dtype in ((4096, 4096, torch.bfloat16), (4096, 1024, torch.bfloat16),
                        (2048, 4096, torch.bfloat16), (2048, 1024, torch.bfloat16),
                        (1000, 300, torch.bfloat16), (1000, 300, torch.float32)):
        q, k, v = cases.onepass(4, N, M, dtype=dtype)
        got = fa.onepass_attention(q, k, v)
        torch.cuda.synchronize()
        err, ok = compare(
            f"onepass B*H=64 N={N} M={M} Dh=72{' f32' if dtype == torch.float32 else ''}"
            f"{' (a seq shard)' if N == 2048 else ''}",
            got, fa.attention_reference(q, k, v), planted_faults(q, k, v, None, fa.KEY_TILE))
        errs["onepass"].append(err)
        all_ok &= ok
    # the 512px training shapes: B = 32, 32 x 32 = 1024 or 28 x 36 = 1008 tokens
    q, k, v = cases.onepass(32, 1008, 1008)
    got = fa.onepass_attention(q, k, v)
    torch.cuda.synchronize()
    err, ok = compare("onepass B*H=512 N=M=1008 Dh=72 (512px training)", got,
                      fa.attention_reference(q, k, v),
                      planted_faults(q, k, v, None, fa.KEY_TILE))
    errs["onepass"].append(err)
    all_ok &= ok
    del q, k, v, got
    # caption masks: prefixes of 300 keys or fewer, one with no valid key,
    # one valid only on keys [256, 300)
    cross_cases = ((4096, 300, (300, 120, 77, 1), torch.bfloat16),
                   (4096, 300, (300, 40, 5, 0), torch.bfloat16),
                   (4096, 300, (300, (256, 300), 77, 3), torch.bfloat16))
    for N, M, lengths, dtype in cross_cases + (
            (2048, 300, (300, 120, 77, 1), torch.bfloat16),  # a seq shard's queries
            (1000, 77, (77, 40, 5, 1), torch.bfloat16),
            (1000, 77, (77, 40, 5, 1), torch.float32),
            (1008, 300, CAPTIONS_512, torch.bfloat16)):
        q, k, v, mask, H = cases.allheads(len(lengths), N, M, lengths, dtype=dtype)
        got = fa.crossattn_allheads(q, k, v, mask, H)
        torch.cuda.synchronize()
        split = lambda x: x.unflatten(-1, (H, 72))
        want = fa.attention_reference(split(q), split(k), split(v), mask).flatten(2)
        err, ok = compare(
            f"allheads B={len(lengths)} N={N} M={M} C=1152 valid={lengths}"
            f"{' f32' if dtype == torch.float32 else ''}",
            got, want, planted_faults(q, k, v, mask, fa.CROSS_KEY_TILE, H, extent=True))
        errs["allheads"].append(err)
        all_ok &= ok
    del q, k, v, got, want
    log("[kernels] long sequences: flash_attention (the 2K/4K self-attention; launched "
        "whole, compared on picked (batch, head, query rows)) and crossattn_headsmajor")
    errs.update(flash_forward=[], headsmajor=[])
    halves = (slice(0, 512), slice(9000, 9512))
    # the spiked key tile is the kernel's tile holding key `spike`
    for label, B, N, M, lengths, dtype, picks, spike in (
        ("flash 2K path B*H=32 N=M=16384, heads 0/9/15, rows [0, 512) and [9000, 9512)",
         2, 16384, 16384, None, torch.bfloat16,
         [(b, h, r) for b in (0, 1) for h in (0, 9, 15) for r in halves], 6400),
        ("flash 2K seq shard B*H=16 N=8192 M=16384, heads 0/9/15, rows [0, 512) and "
         "[7000, 7512)", 1, 8192, 16384, None, torch.bfloat16,
         [(0, h, r) for h in (0, 9, 15) for r in (slice(0, 512), slice(7000, 7512))], 6400),
        ("flash B*H=32 N=1000 M=8200", 2, 1000, 8200, None, torch.bfloat16,
         [(b, h, slice(None)) for b in (0, 1) for h in range(16)], 3200),
        ("flash B*H=32 N=1000 M=8200 f32", 2, 1000, 8200, None, torch.float32,
         [(b, h, slice(None)) for b in (0, 1) for h in range(16)], 3200),
        ("flash masked B*H=48 N=9000 M=2500 valid=(2500, 1100, 0), heads 0/5/15", 3, 9000,
         2500, (2500, 1100, 0), torch.bfloat16,
         [(b, h, slice(None)) for b in range(3) for h in (0, 5, 15)], 640),
    ):
        err, ok = check_flash(fa, cases, label, B, N, M, lengths, dtype, picks,
                              spike // fa.KEY_TILE, fa.KEY_TILE)
        errs["flash_forward"].append(err)
        all_ok &= ok
        torch.cuda.empty_cache()
    grad_errs, ok = check_flash_grad(fa, cases, 2, 2048, 8200, (8200, 3000))
    errs["flash_forward"].append(max(grad_errs.values()))
    all_ok &= ok
    torch.cuda.empty_cache()
    for N, M, lengths, dtype in cross_cases + ((1000, 77, (77, 40, 5, 1), torch.float32),):
        q, k, v, mask, H = cases.allheads(4, N, M, lengths, dtype=dtype)
        q, k, v = (x.unflatten(-1, (H, 72)) for x in (q, k, v))
        got = fa.crossattn_headsmajor(q, k, v, mask)
        torch.cuda.synchronize()
        err, ok = compare(
            f"headsmajor B=4 N={N} M={M} H=16 valid={lengths}"
            f"{' f32' if dtype == torch.float32 else ''}",
            got, fa.headsmajor_reference(q, k, v, mask),
            planted_faults(q, k, v, mask, fa.CROSS_KEY_TILE, extent=True))
        errs["headsmajor"].append(err)
        all_ok &= ok
    del q, k, v, got
    log("[kernels] training: the onepass output and lse (key-masked for the cross cases), "
        "then flash_bwd_dkv and flash_bwd_dq, at the training shapes (B = 4, no CFG doubling)")
    errs.update(dkv=[], dq=[])
    for label, N, M, lengths, dtype, cross in (
        ("self B*H=64 N=4096 M=4096", 4096, 4096, None, torch.bfloat16, False),
        ("self B*H=64 N=4096 M=1024", 4096, 1024, None, torch.bfloat16, False),
        ("self B*H=64 N=2048 M=4096 (a seq shard)", 2048, 4096, None, torch.bfloat16, False),
        ("cross B*H=64 N=2048 M=300 valid=(300, 120, 19, 3) (a seq shard)", 2048, 300,
         (300, 120, 19, 3), torch.bfloat16, True),
        ("cross B*H=64 N=4096 M=300 valid=(300, 120, 19, 3)", 4096, 300, (300, 120, 19, 3),
         torch.bfloat16, True),
        ("cross B*H=64 N=4096 M=300 valid=(300, [256, 300), 77, 3)", 4096, 300,
         (300, (256, 300), 77, 3), torch.bfloat16, True),
        ("cross B*H=64 N=1000 M=300 valid=(300, 40, 5, 0)", 1000, 300, (300, 40, 5, 0),
         torch.bfloat16, True),
        ("cross B*H=64 N=1000 M=300 valid=(300, 40, 5, 0) f32", 1000, 300, (300, 40, 5, 0),
         torch.float32, True),
    ):
        bwd_errs, ok = check_backward(fa, cases, label, 4, N, M, lengths, dtype, cross)
        for name, err in bwd_errs.items():
            errs[name].append(err)
        all_ok &= ok
        torch.cuda.empty_cache()
    for label, N, M, lengths, cross in (
        ("self B*H=512 N=M=1008 (512px training)", 1008, 1008, None, False),
        ("cross B*H=512 N=1008 M=300 (512px training)", 1008, 300, CAPTIONS_512, True),
    ):
        bwd_errs, ok = check_backward(fa, cases, label, 32, N, M, lengths, torch.bfloat16, cross)
        for name, err in bwd_errs.items():
            errs[name].append(err)
        all_ok &= ok
        torch.cuda.empty_cache()
    log("[kernels] 2K training shapes: flash_bwd_dkv and flash_bwd_dq after the flash forward "
        "(B*H=64, N=M=16384) and after onepass (N=16384, M=4096), compared on picked heads")
    for label, N, M, flash in (("flash 2K B*H=64 N=M=16384", 16384, 16384, True),
                               ("onepass 2K B*H=64 N=16384 M=4096", 16384, 4096, False)):
        picks = [(0, 0, slice(0, 512), slice(0, 512)),
                 (1, 9, slice(9000, 9512), slice(M - 700, M - 188)),
                 (3, 15, slice(N - 512, N), slice(M // 2, M // 2 + 512))]
        bwd_errs, ok = check_backward_long(fa, cases, label, N, M, flash, picks)
        for name, err in bwd_errs.items():
            errs[name].append(err)
        all_ok &= ok
        torch.cuda.empty_cache()
    if not all_ok:
        raise SystemExit("a kernel disagrees with its plain version, or the check "
                         "missed a planted fault")

    # ---- 4. the main path ------------------------------------------------
    log("[path] PixArtMS_XL_2 1024px, 28 blocks x 1152, kv-compress conv x2 "
        "on layers 14-27, bf16, seeded random weights")
    model = PixArtMS_XL_2(
        input_size=128, pe_interpolation=2.0, model_max_length=300,
        kv_compress_sampling="conv", kv_compress_scale=2,
        kv_compress_layers=tuple(range(14, 28)), device=dev,
    )
    gen = torch.Generator(device=dev).manual_seed(0)
    init_weights(model, gen)
    perturb_zero_leaves(model, gen)
    torch.cuda.manual_seed(1)
    vae = build_vae(VAEConfig.sdxl(), device=dev)
    t5 = PseudoT5Embedder(dim=4096, model_max_length=300)
    pipe = PixArtPipeline(model, t5=t5, vae=vae, device=dev)
    prompts = [
        "a watercolor painting of a lighthouse on a cliff at dusk",
        "a small robot reading a book in a sunlit library full of plants, "
        "highly detailed, soft light, 35mm photograph",
    ]
    negative = "blurry, low quality"
    call = dict(num_inference_steps=20, guidance_scale=4.5, negative_prompt=negative, seed=0)

    def run_path(ps, decode=True, p=None, **kw):
        p = p or pipe
        reset_forward_counts(fa)
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = p(ps, return_latents=True, **dict(call, **kw))
        torch.cuda.synchronize()
        t1 = time.perf_counter()
        imgs = p._latents_to_images(torch.from_numpy(lat).to(dev)) if decode else None
        torch.cuda.synchronize()
        t2 = time.perf_counter()
        return lat, imgs, forward_counts(fa), t1 - t0, t2 - t1

    torch.cuda.reset_peak_memory_stats()
    lat, imgs, counts, _, _ = run_path(prompts)
    launches = dict(counts)
    images_1024 = imgs  # phases 28 and 29 read them
    counts = (counts["onepass"], counts["allheads"])
    expect = 28 * 20
    log(f"[path] 1024px: latents {tuple(lat.shape)} images {imgs.shape} {imgs.dtype}; "
        f"launches onepass={counts[0]} allheads={counts[1]} (expected {expect} each)")
    import numpy as np

    if not np.isfinite(lat).all():
        raise SystemExit("1024px latents are not finite")
    if imgs.shape != (2, 1024, 1024, 3) or imgs.dtype != np.uint8:
        raise SystemExit(f"1024px images: {imgs.shape} {imgs.dtype}")
    if imgs.min() == imgs.max() or any(im.std() == 0 for im in imgs):
        raise SystemExit("1024px images are constant")
    if counts != (expect, expect) or launches["flash"] or launches["headsmajor"]:
        raise SystemExit(f"kernel launches {launches}, expected onepass and allheads {expect}")

    # latents only: the tiled decode runs in the 2K and 4K phases
    lat_hw, _, counts_hw, _, _ = run_path(["a red fox in the snow --hw 1152:896"], decode=False)
    counts_hw = (counts_hw["onepass"], counts_hw["allheads"])
    log(f"[path] 1152x896: latents {tuple(lat_hw.shape)}; tokens 72x56 = 4032, "
        f"compressed 36x28 = 1008; launches onepass={counts_hw[0]} allheads={counts_hw[1]}")
    if lat_hw.shape != (1, 144, 112, 4) or not np.isfinite(lat_hw).all():
        raise SystemExit("1152x896 latents are wrong or not finite")
    if lat_hw.std() == 0 or counts_hw != (expect, expect):
        raise SystemExit(f"1152x896 call: constant latents or launches {counts_hw}")

    small = dict(height=256, width=256, return_latents=True, **call)
    lat_k = pipe(prompts, **small)
    set_attn_impl(model, "reference")
    lat_r = pipe(prompts, **small)
    set_attn_impl(model, "auto")
    rel = float(np.linalg.norm(lat_k - lat_r) / np.linalg.norm(lat_r))
    log(f"[path] 256px 20-step trajectory, kernels vs plain attention: relative L2 "
        f"{rel:.3e} (tol {PATH_REL_TOL})")
    if not np.isfinite(lat_k).all() or rel > PATH_REL_TOL:
        raise SystemExit("256px trajectory disagrees with plain attention")

    # the cross-attention forced to the headsmajor kernel, as JAX's override
    os.environ[CROSSATTN_ENV] = "headsmajor"
    try:
        lat_h, _, counts_h, _, _ = run_path(prompts, decode=False)
        reset_forward_counts(fa)
        lat_hk = pipe(prompts, **small)
        counts_hk = forward_counts(fa)
    finally:
        del os.environ[CROSSATTN_ENV]
    rel_h = float(np.linalg.norm(lat_hk - lat_r) / np.linalg.norm(lat_r))
    log(f"[path] {CROSSATTN_ENV}=headsmajor: 1024px 20-step latents {tuple(lat_h.shape)}, "
        f"launches {counts_h} (expected headsmajor {expect}, allheads 0, onepass {expect}); "
        f"256px trajectory, launches {counts_hk}, vs plain attention: relative L2 {rel_h:.3e} "
        f"(tol {PATH_REL_TOL})")
    launches["headsmajor"] = counts_h["headsmajor"]
    if not np.isfinite(lat_h).all() or lat_h.std() == 0:
        raise SystemExit("headsmajor trajectory latents are not finite or constant")
    if counts_h != {"onepass": expect, "allheads": 0, "headsmajor": expect, "flash": 0}:
        raise SystemExit(f"headsmajor trajectory launches {counts_h}")
    if counts_hk["headsmajor"] != expect or counts_hk["allheads"]:
        raise SystemExit(f"256px headsmajor trajectory launches {counts_hk}")
    if not np.isfinite(lat_hk).all() or rel_h > PATH_REL_TOL:
        raise SystemExit("256px headsmajor trajectory disagrees with plain attention")

    # ---- 5. times --------------------------------------------------------
    _, _, _, t_sample, t_decode = run_path(prompts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[time] {card}: sampler {t_sample / 2:.4f} s/img, decode {t_decode / 2:.4f} s/img "
        f"(2 images, 20 steps, CFG 4.5), peak memory {peak:.2f} GiB")
    trace(lambda: pipe(prompts, return_latents=True, **call),
          "1024px trajectory (2 images)", card)

    mask_path = torch.cat([t5.get_text_embeddings([negative] * 2)[1],
                           t5.get_text_embeddings(prompts)[1]]).to(dev).bool()
    # the 2K trajectory's CFG batch: one prompt and its negative
    mask_2k = torch.cat([t5.get_text_embeddings([negative])[1],
                         t5.get_text_embeddings(prompts[:1])[1]]).to(dev).bool()
    # a long caption: every one of the 300 keys valid, so the extent (three
    # tiles) streams through the two K/V stages for every query tile
    mask_long = torch.ones((4, 300), dtype=torch.bool, device=dev)
    cross_shapes = ((4, 4096, 300, mask_path), (2, 16384, 300, mask_2k),
                    (4, 4096, 300, mask_long), (4, 2048, 300, mask_path))
    entries = []
    for name, shapes in (
        ("onepass", ((4, 4096, 4096, None), (4, 4096, 1024, None), (4, 2048, 4096, None),
                     (4, 2048, 1024, None))),
        ("allheads", cross_shapes),
        ("headsmajor", cross_shapes),
    ):
        rows = []
        for B, N, M, mask in shapes:
            H, Dh = 16, 72
            if name == "onepass":
                q, k, v = cases.onepass(B, N, M)
                kern = lambda: fa.onepass_attention(q, k, v)
                plain = lambda: fa.attention_reference(q, k, v)
                valid = B * M  # keys each head's rows attend to, summed over batch
            else:
                qf, kf, vf, _, _ = cases.allheads(B, N, M, (M,) * B)
                split = lambda x: x.unflatten(-1, (H, Dh))
                q, k, v = split(qf), split(kf), split(vf)
                if name == "allheads":
                    kern = lambda: fa.crossattn_allheads(qf, kf, vf, mask, H)
                    plain = lambda: fa.attention_reference(q, k, v, mask)
                else:
                    kern = lambda: fa.crossattn_headsmajor(q, k, v, mask)
                    plain = lambda: fa.headsmajor_reference(q, k, v, mask)
                valid = int(mask.sum())
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            am = None if mask is None else mask[:, None, None, :]
            library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
            ms, plain_ms, lib_ms = cuda_ms(kern), cuda_ms(plain, iters=5), cuda_ms(library)
            # the same calls at the rate the host enqueues them
            paced_ms, lib_paced_ms = cuda_ms(kern, queued=False), cuda_ms(library, queued=False)
            lse_ms = masked_ms = None
            if name == "onepass":  # the training launch, which also writes the lse
                lse_ms = cuda_ms(lambda: fa._onepass_forward(q, k, v, None, with_lse=True))
                # the masked instantiation (the allheads backward recomputes
                # through it) on a mask that keeps every key
                keep = torch.zeros((B, M), device=dev)
                masked_ms = cuda_ms(lambda: fa._onepass_forward(q, k, v, keep, with_lse=True))
            # the bound counts the work this run's data needs: valid keys only
            flops = 4.0 * H * N * valid * Dh
            nbytes = 2.0 * (2 * B * N * H * Dh + 2 * valid * H * Dh)
            b_ms, by = bound_ms(flops, nbytes)
            extent = None
            if mask is not None:  # keys the kernel visits per batch element
                extent = fa.caption_key_extent(mask).tolist()
            shape = (f"B*H={B * H} N={N} M={M}" if name == "onepass"
                     else f"B={B} C={H * Dh} N={N} M={M} ({valid} valid keys of {B * M}; "
                          f"key extents {extent})")
            log(f"[time] {card}: {name} {shape}: kernel {ms:.4f} ms "
                f"({paced_ms:.4f} ms host-paced), plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms "
                f"({lib_paced_ms:.4f} ms host-paced), bound {b_ms:.4f} ms "
                f"({by}; {flops / 1e9:.2f} GFLOP over valid keys, "
                f"{4.0 * H * N * B * M * Dh / 1e9:.2f} GFLOP over all keys, "
                f"{nbytes / 1e6:.1f} MB), share of bound {b_ms / ms:.3f}"
                + ("" if lse_ms is None else f"; with the lse output {lse_ms:.4f} ms, "
                   f"and a key mask too {masked_ms:.4f} ms"))
            rows.append(dict(B=B, N=N, M=M, valid_keys=valid, key_extents=extent, ms=ms,
                             host_paced_ms=paced_ms, plain_ms=plain_ms, bound_ms=b_ms,
                             bound_by=by, library_ms=lib_ms, library_host_paced_ms=lib_paced_ms,
                             lse_ms=lse_ms, masked_ms=masked_ms))
            del q, k, v, qt, kt, vt
            torch.cuda.empty_cache()
        head = rows[0]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": "pixart_sigma_tpu_torch/csrc/"
                      + ("onepass_attention.cu" if name == "onepass" else "cross_attention.cu"),
            "replaces": "pixart_sigma_tpu/ops/flash_attention.py:"
                        + {"onepass": "179", "allheads": "587", "headsmajor": "646"}[name],
            "launches": launches[name],
            "max_abs_err": max(errs[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": rows,
        })

    # ---- 5b. the other samplers --------------------------------------------
    launches_samplers = run_samplers(dev, card, fa, pipe, model, prompts, negative)
    del pipe, model
    torch.cuda.empty_cache()

    # ---- 34. every head dim up to 128 ----------------------------------------
    head_dims = run_head_dims(dev, card, fa, cases, t5, vae, prompts, negative, mask_path)

    # ---- 6.-8. the 2K and 4K paths, the flash kernel's times ----------------
    entries.append(run_hires(dev, card, fa, cases, t5, vae, prompts[0], negative,
                             max(errs["flash_forward"])))
    del vae, t5
    torch.cuda.empty_cache()

    # ---- 9. the training path ---------------------------------------------
    launches_train = run_training(
        dev, card, fa, TRAIN_CONFIG, [(1024, 1024)] * 4 + [(1088, 960)] * 4, 1024, TRAIN_STEPS,
        "train", "1024x1024 (64x64 = 4096 tokens, 1024 after KV compression) and 1088x960 "
        "(68x60 = 4080 tokens, 1020 compressed)", TRAIN_STEP_LAUNCHES)
    for entry in entries:
        entry["launches_training"] = launches_train[entry["name"]]

    # ---- 10. gradients through the kernels against plain attention ----------
    gradient_check(dev, fa)

    # ---- 11. backward kernel times ------------------------------------------
    entries += backward_times(cases, fa, card, launches_train, errs)

    # ---- 12. 2K training through the Trainer ----------------------------------
    launches_2k = run_training(
        dev, card, fa, CONFIG_2K, [(2048, 2048)] * 4 + [(1920, 2176)] * 4, 2048, TRAIN_STEPS_2K,
        "train2k", "2048x2048 (128x128 = 16384 tokens, 4096 after KV compression) and 1920x2176 "
        "(120x136 = 16320 tokens, a tail of 64 keys; 60x68 = 4080 compressed)",
        TRAIN_2K_STEP_LAUNCHES)
    torch.cuda.empty_cache()

    # ---- 13. the 2K gradient gate: flash's autograd Function in the model ------
    launches_gate = gradient_check_2k(dev, fa)
    torch.cuda.empty_cache()

    # ---- 14. the trainer features --------------------------------------------
    launches_features = run_features(dev, card, fa)
    for entry in entries:
        name = entry["name"]
        entry["launches_training_2k"] = launches_2k[name]
        entry["launches_gradient_gate_2k"] = launches_gate[name]
        entry["launches_features"] = {run: c[name] for run, c in launches_features.items()}
    for entry in entries:
        entry["launches_samplers"] = {s: c[entry["name"]] for s, c in launches_samplers.items()}

    # ---- 15.-19. the T5-XXL and VAE encoders, serving with T5-XXL, 512px ------
    # training from images and captions, the features round trip
    emb = run_t5(dev, card)
    vae_enc = run_vae_encoder(dev, card)
    launches_serve = run_serving_t5(dev, card, fa, emb, vae_enc, prompts, negative)
    torch.cuda.empty_cache()
    launches_512, launches_rt = run_training_512(dev, card, fa, emb, vae_enc)
    del emb, vae_enc
    torch.cuda.empty_cache()
    for entry in entries:
        name = entry["name"]
        entry["launches_serving_t5"] = launches_serve.get(
            {"flash_forward": "flash"}.get(name, name), 0)
        entry["launches_training_512"] = launches_512[name]
        entry["launches_features_round_trip"] = launches_rt[name]

    # ---- 20.-21. the turbo serving modes and the port's HTTP server ----------
    launches_turbo, quant_model, vae_t, t5_t = run_turbo(dev, card, fa, prompts, negative)
    launches_server = run_server(dev, card, fa, quant_model, vae_t, t5_t)
    del quant_model, vae_t, t5_t
    torch.cuda.empty_cache()
    for entry in entries:
        name = {"flash_forward": "flash"}.get(entry["name"], entry["name"])
        entry["launches_turbo"] = {v: c.get(name, 0) for v, c in launches_turbo.items()}
        entry["launches_server"] = launches_server.get(name, 0)

    # ---- 22.-26. the training CLI, LoRA/DoRA, DreamBooth, LCM, DMD; gates -----
    launches_ft, base_latents = run_finetuning(dev, card, fa)
    for entry in entries:
        entry["launches_finetuning"] = {run: c[entry["name"]] for run, c in launches_ft.items()}

    # ---- 27.-31. bits/dim and the KL step, FID features, LPIPS and DMD's ------
    # regression, the VAE trainer, the offline toy workflow
    t0 = time.perf_counter()
    launches_eval = run_evaluation(dev, card, fa, eight_images(images_1024), base_latents)
    log(f"[evaluation] phases 27-31: {time.perf_counter() - t0:.1f} s")
    for entry in entries:
        entry["launches_evaluation"] = {run: c[entry["name"]] for run, c in launches_eval.items()}

    # ---- 32. multi-rank training: one NCCL rank at full width, two gloo ranks ----
    launches_parallel = run_parallel(dev, card, fa)
    for entry in entries:
        entry["launches_parallel"] = {run: c[entry["name"]]
                                      for run, c in launches_parallel.items()}

    # ---- 33. sequence parallelism: two gloo ranks sharing the card ----------
    torch.cuda.empty_cache()
    launches_seq, seq_reference = run_seq_parallel(dev, card, fa)
    for entry in entries:
        entry["launches_seq_parallel"] = {run: c[entry["name"]]
                                          for run, c in launches_seq.items()}
        entry["seq_shard_shapes"] = SEQ_SHARD_SHAPES[entry["name"]]

    # ---- 36. the seq axis with tensor parallelism: four gloo ranks on the card ----
    launches_seqtp = run_seq_tensor(dev, card, fa, seq_reference)
    for entry in entries:
        entry["launches_seq_tensor"] = {f"{run}, each of 4 ranks": c[entry["name"]]
                                        for run, c in launches_seqtp.items()}
    for entry in entries:
        name = entry["name"]
        entry["widths"] = list(fa.WIDTHS)
        entry["head_dims_max_abs_err"] = head_dims["errs"][name]
        entry["launches_head_dims"] = {f"{h} heads": c[name]
                                       for h, c in head_dims["launches"].items()}
        entry["launches_head_dims"]["9-head training step"] = head_dims["train"][name]
        entry["head_dim_shapes"] = head_dims["times"].get(name, [])

    # ---- 35. the JAX trainer's orbax checkpoints: decode, load, sample, resume ----
    launches_orbax = run_orbax(dev, card, fa)
    for entry in entries:
        entry["launches_orbax"] = {run: c[entry["name"]] for run, c in launches_orbax.items()}
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    if sys.argv[1:2] == ["--gloo-ddp-rank"]:  # phase 32b's ranks
        sys.exit(gloo_ddp_worker(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--seq-rank"]:  # phase 33's ranks
        sys.exit(seq_rank_worker(int(sys.argv[2]), sys.argv[3]))
    if sys.argv[1:2] == ["--seqtp-rank"]:  # phase 36's ranks
        sys.exit(seq_tensor_worker(int(sys.argv[2]), sys.argv[3]))
    sys.exit(main())
