#!/usr/bin/env python3
"""Drive the PyTorch port's 1024px sampling and training paths on one CUDA card.

Run from the root of the repository, with no arguments:

    python3 chip_smoke.py

Phases, each printing its own lines:
1. device: the card's name and power limit (nvidia-smi) and torch's view;
2. build: the three CUDA sources of pixart_sigma_tpu_torch/csrc with nvcc
   (sm_90a), in parallel, with ptxas register, spill and shared-memory use;
3. kernels against their plain PyTorch versions at the path's shapes and at
   unaligned ones (bf16, seeded inputs; f32 at the unaligned ones), with the
   stated tolerance, and the same check applied to plain outputs with a
   planted fault, which it must reject: the two forward kernels, then the
   onepass kernel's logsumexp output and the two backward kernels
   (flash_bwd_dkv, flash_bwd_dq) at the training shapes;
4. the sampling path through PixArtPipeline: PixArt-Sigma-XL-2 at full width
   and depth (28 blocks, 1152 wide, KV compression conv x2 on layers 14-27),
   seeded random weights, pseudo-T5 captions padded to 300 tokens, 20-step
   DPM-Solver++ with CFG 4.5 and hoisted caption K/V, SDXL-VAE decode to
   1024px; then one 1152x896 call to latents (unaligned token counts), and a
   256px trajectory held against the same model with plain attention;
5. sampling times from CUDA events: each forward kernel (and the onepass
   launch that writes the lse), its plain version, the library attention call
   (`scaled_dot_product_attention`, timed only) and the bound; sampler and
   decode seconds per image, peak memory and a torch.profiler breakdown;
6. the training path through the port's Trainer at the config's operating
   point (configs/pixart_sigma_config/
   PixArt_sigma_xl2_img1024_internalms_kvcompress.py: batch 4, CAME, clip
   0.01, EMA, grad checkpointing, bf16 compute over f32 weights) with seeded
   random weights, on a synthetic feature dataset written to a temporary
   directory (two aspect buckets); kernel launches against the count reckoned
   from the code, seconds per step and images per second per bucket, peak
   memory and a torch.profiler breakdown of one step;
7. one training step's gradients at 256px through the kernels, held against
   the same step through plain attention;
8. backward times: each backward kernel, its plain version, the backward of
   `scaled_dot_product_attention` (timed only) and the bound.

The line before the last is a JSON object with one entry per kernel; the
last line is {"ok": true, "device": {...}}. Exits non-zero, printing no
result, without a card or outside the repository, or if any phase fails.
"""

from __future__ import annotations

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
# at most 0.033 and 1.7e-3, their faults 0.45 and 0.125 or more.
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
TRAIN_CONFIG = "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_internalms_kvcompress.py"
TRAIN_STEPS = 4


def log(*parts) -> None:
    print(*parts, flush=True)


def card_line() -> str:
    out = subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader"],
        capture_output=True, text=True, check=True, timeout=60,
    )
    return out.stdout.strip().splitlines()[0]


def cuda_ms(fn, iters: int = 20, warmup: int = 3) -> float:
    import torch

    for _ in range(warmup):
        fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
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
        t = self.torch
        lens = t.tensor(lengths, device=self.dev)
        return t.arange(M, device=self.dev)[None] < lens[:, None]

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


def planted_faults(q, k, v, mask, n_heads=None) -> dict:
    """The plain version's output with a fault planted: key tile [64, 128)
    skipped, or the logits scaled by Dh_pad^-0.5 = 80^-0.5 instead of Dh^-0.5.
    q/k/v are [B, N, H, Dh], or the flat [B, N, C] layout when n_heads is set."""
    from pixart_sigma_tpu_torch.ops.flash_attention import attention_reference as ref

    torch_ = sys.modules["torch"]
    if n_heads:
        q, k, v = (x.unflatten(-1, (n_heads, -1)) for x in (q, k, v))
    B, M, _, Dh = k.shape
    keep = torch_.ones((B, M), dtype=torch_.bool, device=k.device)
    keep[:, 64:128] = False
    out = {
        "dropped key tile": ref(q, k, v, keep if mask is None else keep & mask),
        "logit scale 80^-0.5": ref((q.float() * (Dh / 80) ** 0.5).to(q.dtype), k, v, mask),
    }
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


def check_backward(fa, cases, label, B, N, M, lengths, dtype, cross) -> tuple[dict, bool]:
    """The onepass lse, then dkv and dq, each against its plain version on the
    same inputs, and the same checks on plain outputs with planted faults: a
    query tile [64, 128) skipped in the dK/dV sweep (its P set to 0), and the
    lse off by one log2 unit. Returns ({kernel: max |err|}, ok)."""
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
    ok = check_lse(label, lse, fa._plain_forward(pq, pk, pv, madd)[1])
    delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
    madd_b = None if madd is None else madd.to(dtype).float()
    dk, dv = fa.flash_bwd_dkv(q, k, v, do, madd_b, lse, delta)
    dq = fa.flash_bwd_dq(q, k, v, do, madd_b, lse, delta)
    torch_.cuda.synchronize()
    ref = lambda l: fa.flash_backward_reference(pq, pk, pv, madd_b, l, delta, pdo)
    want = ref(lse)
    skipped = lse.clone()
    skipped[:, :, 64:128] = float("inf")
    faults = {"query tile [64, 128) skipped": ref(skipped), "lse + 1": ref(lse + 1)}
    errs = {}
    for kname, got, idx in (("dkv", dk, 1), ("dkv", dv, 2), ("dq", dq, 0)):
        err, good = compare(f"{label} {kname} d{'qkv'[idx]}", got, want[idx],
                            {f: o[idx] for f, o in faults.items()})
        errs[kname] = max(errs.get(kname, 0.0), err)
        ok &= good
    return errs, ok


KERNEL_GROUPS = (  # kernel-name substrings -> the layer they belong to
    ("onepass_kernel", "onepass attention kernel"),
    ("allheads_kernel", "allheads attention kernel"),
    ("dkv_kernel", "flash backward dK/dV kernel"),
    ("dq_kernel", "flash backward dQ kernel"),
    ("conv", "convolutions (patch embed, KV compression)"),
    ("fprop", "convolutions (patch embed, KV compression)"),
    ("dgrad", "convolutions (patch embed, KV compression)"),
    ("wgrad", "convolutions (patch embed, KV compression)"),
    ("gemm", "matmuls (projections, MLP)"), ("nvjet", "matmuls (projections, MLP)"),
    ("xmma", "matmuls (projections, MLP)"), ("cutlass", "matmuls (projections, MLP)"),
    ("layer_norm", "layer norms"), ("norm", "layer norms"),
)


def trace(fn, what: str, card: str) -> None:
    """fn() under torch.profiler: device time by layer and the device's idle
    share of the wall time."""
    import torch
    from torch.profiler import ProfilerActivity, profile

    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        fn()
        torch.cuda.synchronize()
        wall = time.perf_counter() - t0
    # user annotations (the optimizer's "Optimizer.step#CAME.step" span) carry
    # the device time of the kernels inside them, which are counted anyway
    annotations = {e.name for e in prof.events() if getattr(e, "is_user_annotation", False)}
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



def attention_launches_per_step(depth: int) -> dict:
    """Kernel launches of one training step, reckoned from the code: each
    block is checkpointed, so its forward runs twice (once in the forward,
    once recomputed in the backward); each self-attention forward launches
    onepass and each cross-attention forward allheads; each backward launches
    dkv and dq once, and the cross-attention backward first recomputes out
    and lse with one onepass launch."""
    return {"onepass": 3 * depth, "allheads": 2 * depth,
            "flash_bwd_dkv": 2 * depth, "flash_bwd_dq": 2 * depth}


def perturb_zero_leaves(model, gen) -> None:
    """Zero-initialised cross-attention projections and final linear would
    make a fresh model ignore its input."""
    import torch

    with torch.no_grad():
        for block in model.blocks:
            block.cross_attn.proj.weight.normal_(0.0, 0.02, generator=gen)
        model.final_layer.linear.weight.normal_(0.0, 0.02, generator=gen)


def run_training(dev, card, fa) -> dict:
    """The port's Trainer at the 1024px operating point on a synthetic feature
    dataset; returns the kernel launches of the run."""
    import numpy as np
    import torch

    from pixart_sigma_tpu_torch.config import read_config
    from pixart_sigma_tpu_torch.data.synthetic import write_feature_dataset
    from pixart_sigma_tpu_torch.training.train_step import train_step
    from pixart_sigma_tpu_torch.training.trainer import Trainer

    tmp = tempfile.mkdtemp(prefix="pixart_train_")
    try:
        t0 = time.perf_counter()
        write_feature_dataset(os.path.join(tmp, "data"), [(1024, 1024)] * 4 + [(1088, 960)] * 4,
                              resolution=1024, valid_tokens=(3, 19), seed=0)
        log(f"[train] {TRAIN_CONFIG}: synthetic Sigma features for 8 items in "
            f"{time.perf_counter() - t0:.1f} s: buckets 1024x1024 (64x64 = 4096 tokens, "
            "1024 after KV compression) and 1088x960 (68x60 = 4080 tokens, 1020 compressed); "
            "300-token captions with 3-19 valid")
        cfg = read_config(TRAIN_CONFIG)
        cfg.data_root = tmp
        cfg.data = dict(cfg.data, root="data", load_vae_feat=True, load_t5_feat=True)
        cfg.update(log_interval=1, save_model_steps=0, save_model_epochs=10**9)
        trainer = Trainer(cfg, os.path.join(tmp, "work"), device=dev)
        mc = trainer.model.cfg
        log(f"[train] PixArtMS_XL_2 depth {mc.depth} width {mc.hidden_size}, kv-compress "
            f"{mc.kv_compress_sampling} x{mc.kv_compress_scale} on layers "
            f"{mc.kv_compress_layers[0]}-{mc.kv_compress_layers[-1]}, batch "
            f"{cfg.train_batch_size}, grad checkpointing {mc.grad_checkpointing}, f32 weights, "
            f"{str(mc.dtype).split('.')[-1]} compute, CAME lr {trainer._base_lr:.3g} "
            f"(auto-scaled), clip {cfg.gradient_clip}, EMA {cfg.ema_rate} with warmup")
        perturb_zero_leaves(trainer.model, torch.Generator(device=dev).manual_seed(0))
        before = {n: p.detach().clone() for n, p in trainer.model.named_parameters()}
        counters = {"onepass": fa.onepass_attention, "allheads": fa.crossattn_allheads,
                    "flash_bwd_dkv": fa.flash_bwd_dkv, "flash_bwd_dq": fa.flash_bwd_dq}
        for fn in counters.values():
            fn.launches = 0
        torch.cuda.reset_peak_memory_stats()
        torch.cuda.synchronize()
        state = trainer.train(max_steps=TRAIN_STEPS)
        torch.cuda.synchronize()
        launches = {name: fn.launches for name, fn in counters.items()}
        peak = torch.cuda.max_memory_allocated() / 2**30
        expect = {k: v * TRAIN_STEPS for k, v in attention_launches_per_step(mc.depth).items()}
        for h in trainer.history:
            log(f"[train] step {h['step']}: latents {h['hw']}, loss {h['loss']:.5f} "
                f"(mse {h['mse']:.5f}, vb {h['vb']:.5f}), grad norm {h['grad_norm']:.4f}, "
                f"lr {h['lr']:.3e}, {h['seconds']:.4f} s")
        log(f"[train] launches {launches}; reckoned {expect} "
            f"({TRAIN_STEPS} steps x {attention_launches_per_step(mc.depth)})")
        moved = sum(not torch.equal(p, before[n]) for n, p in trainer.model.named_parameters())
        ema_moved = sum(not torch.equal(state.ema[n], before[n]) for n in before)
        log(f"[train] parameters changed: {moved} of {len(before)}; EMA tensors changed: "
            f"{ema_moved}; peak memory {peak:.2f} GiB")
        if not all(np.isfinite(h["loss"]) for h in trainer.history):
            raise SystemExit("training loss is not finite")
        if state.step != TRAIN_STEPS or launches != expect:
            raise SystemExit(f"training ran {state.step} steps with launches {launches}")
        if moved < len(before) // 2 or ema_moved < len(before) // 2:
            raise SystemExit("training left the parameters or the EMA unchanged")
        for hw in sorted({h["hw"] for h in trainer.history}):
            secs = [h["seconds"] for h in trainer.history[1:] if h["hw"] == hw]
            if secs:
                mean = sum(secs) / len(secs)
                log(f"[time] {card}: training step at latents {hw} (B = "
                    f"{cfg.train_batch_size}): {mean:.4f} s/step, "
                    f"{cfg.train_batch_size / mean:.3f} img/s (steps after the first: "
                    f"{', '.join(f'{x:.4f}' for x in secs)} s)")
        log(f"[time] {card}: training peak memory {peak:.2f} GiB")
        batch = trainer.prepare_batch(next(iter(trainer.build_loader())))
        trace(lambda: train_step(state, trainer.diffusion, batch, generator=trainer.generator,
                                 grad_clip=cfg.gradient_clip),
              f"one 1024px training step, latents {tuple(batch['latents'].shape[1:3])}, "
              f"B = {cfg.train_batch_size}", card)
        return launches
    finally:
        shutil.rmtree(tmp, ignore_errors=True)


def gradient_check(dev) -> None:
    """One training step's gradients at 256px (depth 4, KV compression on
    layers 2-3, B = 4, bf16 compute) through the kernels and through plain
    attention (attn_impl="reference"), with the same t, noise and drops."""
    import torch

    from pixart_sigma_tpu_torch.diffusion.factory import IDDPM
    from pixart_sigma_tpu_torch.models.pixart import PixArtMS_XL_2, init_weights
    from pixart_sigma_tpu_torch.training.train_step import compute_losses

    gen = torch.Generator(device=dev).manual_seed(3)
    model = PixArtMS_XL_2(device=dev, train=True, input_size=32, pe_interpolation=0.5, depth=4,
                          model_max_length=300, kv_compress_sampling="conv",
                          kv_compress_scale=2, kv_compress_layers=(2, 3))
    init_weights(model, gen)
    perturb_zero_leaves(model, gen)
    randn = lambda *shape: torch.randn(shape, generator=gen, device=dev)
    lengths = torch.tensor([19, 12, 7, 3], device=dev)
    batch = {"latents": randn(4, 32, 32, 4), "y": randn(4, 300, 4096),
             "y_mask": (torch.arange(300, device=dev)[None] < lengths[:, None]).int()}
    t = torch.tensor([10, 250, 600, 999], device=dev)
    noise, drop = randn(4, 32, 32, 4), torch.tensor([0, 0, 0, 1], device=dev)
    diffusion = IDDPM(timestep_respacing=[1000], learn_sigma=True, rescale_learned_sigmas=True)

    def grads(impl):
        set_attn_impl(model, impl)
        model.zero_grad(set_to_none=True)
        compute_losses(model, diffusion, batch, t, noise, force_drop_ids=drop)["loss"].backward()
        return {n: p.grad.detach().clone() for n, p in model.named_parameters()}

    got, want = grads("auto"), grads("reference")
    diff = sum(float((got[n] - want[n]).pow(2).sum()) for n in want)
    norm = sum(float(want[n].pow(2).sum()) for n in want)
    rel = (diff / norm) ** 0.5
    worst = max((float((got[n] - want[n]).norm() / want[n].norm().clamp_min(1e-30)), n)
                for n in want)
    log(f"[train] 256px step gradients, kernels vs plain attention: relative L2 {rel:.3e} over "
        f"all parameters, worst parameter {worst[1]} {worst[0]:.3e} (tol {GRAD_REL_TOL})")
    if not rel <= GRAD_REL_TOL or not worst[0] <= GRAD_REL_TOL:
        raise SystemExit("256px training gradients disagree with plain attention")


def backward_times(cases, fa, card, launches: dict, errs: dict) -> list:
    """Each backward kernel at the training shapes: its time, its plain
    version's (which computes dq, dk and dv at once), the backward of
    `scaled_dot_product_attention` on the same inputs (timed only; it also
    computes all three) and the bound. Returns the two JSON entries."""
    import torch
    import torch.nn.functional as F

    B, H, Dh = 4, 16, 72
    rows = {"flash_bwd_dkv": [], "flash_bwd_dq": []}
    for label, N, M, lengths in (("self", 4096, 4096, None), ("self", 4096, 1024, None),
                                 ("cross", 4096, 300, (19, 12, 7, 3))):
        if lengths is None:
            q, k, v = cases.onepass(B, N, M)
            mask = None
        else:
            qf, kf, vf, mask, _ = cases.allheads(B, N, M, lengths)
            q, k, v = (x.unflatten(-1, (H, Dh)) for x in (qf, kf, vf))
        madd = None if mask is None else fa.mask_bias(mask)
        do = cases.randn(B, N, H, Dh)
        out, lse = fa._onepass_forward(q, k, v, madd, with_lse=True)
        delta = (do.float() * out.float()).sum(-1).transpose(1, 2).contiguous()
        madd_b = None if madd is None else madd.to(q.dtype).float()
        args = (q, k, v, do, madd_b, lse, delta)
        qt, kt, vt = (x.transpose(1, 2).contiguous().requires_grad_() for x in (q, k, v))
        am = None if mask is None else mask[:, None, None, :]
        out_t = F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
        do_t = do.transpose(1, 2).contiguous()
        lib_ms = cuda_ms(lambda: torch.autograd.grad(out_t, (qt, kt, vt), do_t,
                                                     retain_graph=True))
        plain_ms = cuda_ms(lambda: fa.flash_backward_reference(q, k, v, madd_b, lse, delta, do),
                           iters=3, warmup=1)
        valid = B * M if mask is None else int(mask.sum())
        io = 2.0 * (2 * B * N * H * Dh + 2 * valid * H * Dh) + 4.0 * 2 * B * H * N
        for name, products, out_bytes in (("flash_bwd_dkv", 4, 2.0 * 2 * valid * H * Dh),
                                          ("flash_bwd_dq", 3, 2.0 * B * N * H * Dh)):
            fn = getattr(fa, name)
            ms = cuda_ms(lambda: fn(*args))
            flops = products * 2.0 * H * N * valid * Dh
            b_ms, by = bound_ms(flops, io + out_bytes)
            log(f"[time] {card}: {name} {label} B*H={B * H} N={N} M={M}"
                f"{'' if mask is None else f' ({valid} valid keys of {B * M})'}: kernel "
                f"{ms:.4f} ms, plain (dq, dk, dv) {plain_ms:.4f} ms, sdpa backward (dq, dk, dv) "
                f"{lib_ms:.4f} ms, bound {b_ms:.4f} ms ({by}; {flops / 1e9:.2f} GFLOP, "
                f"{(io + out_bytes) / 1e6:.1f} MB), share of bound {b_ms / ms:.3f}")
            rows[name].append(dict(N=N, M=M, valid_keys=valid, ms=ms, plain_ms=plain_ms,
                                   bound_ms=b_ms, bound_by=by, library_ms=lib_ms))
        del q, k, v, do, out, lse, delta, qt, kt, vt, out_t
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
    logs = _build.build()
    if logs:
        log(f"[build] {len(logs)} kernels in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    else:
        log(f"[build] nothing to compile: libraries for these sources are in {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if "Compiling entry" in line or "Used" in line or "spill" in line:
                log(f"  {name}: {line.strip()}")
    smem_onepass = _build.load("onepass_attention").onepass_attention_smem_bytes()
    smem_allheads = _build.load("allheads_attention").allheads_attention_smem_bytes(300)
    bwd = _build.load("flash_backward")
    log(f"  dynamic shared memory per block: onepass {smem_onepass} B, "
        f"allheads {smem_allheads} B (M=300), dkv {bwd.flash_bwd_dkv_smem_bytes()} B, "
        f"dq {bwd.flash_bwd_dq_smem_bytes()} B")

    # ---- 3. kernels against their plain versions ------------------------
    log("[kernels] seeded inputs at the path shapes (B = 2 prompts x CFG), bf16 "
        "unless marked f32; f32 inputs are rounded to bf16 for the tensor cores")
    cases = Cases(dev)
    errs = {"onepass": [], "allheads": []}
    all_ok = True
    for N, M, dtype in ((4096, 4096, torch.bfloat16), (4096, 1024, torch.bfloat16),
                        (1000, 300, torch.bfloat16), (1000, 300, torch.float32)):
        q, k, v = cases.onepass(4, N, M, dtype=dtype)
        got = fa.onepass_attention(q, k, v)
        torch.cuda.synchronize()
        err, ok = compare(
            f"onepass B*H=64 N={N} M={M} Dh=72{' f32' if dtype == torch.float32 else ''}",
            got, fa.attention_reference(q, k, v), planted_faults(q, k, v, None))
        errs["onepass"].append(err)
        all_ok &= ok
    for N, M, lengths, dtype in ((4096, 300, (300, 120, 77, 1), torch.bfloat16),
                                 (1000, 77, (77, 40, 5, 1), torch.bfloat16),
                                 (1000, 77, (77, 40, 5, 1), torch.float32)):
        q, k, v, mask, H = cases.allheads(4, N, M, lengths, dtype=dtype)
        got = fa.crossattn_allheads(q, k, v, mask, H)
        torch.cuda.synchronize()
        split = lambda x: x.unflatten(-1, (H, 72))
        want = fa.attention_reference(split(q), split(k), split(v), mask).flatten(2)
        err, ok = compare(
            f"allheads B=4 N={N} M={M} C=1152 valid={lengths}"
            f"{' f32' if dtype == torch.float32 else ''}",
            got, want, planted_faults(q, k, v, mask, H))
        errs["allheads"].append(err)
        all_ok &= ok
    del q, k, v, got, want
    log("[kernels] training: the onepass lse, then flash_bwd_dkv and flash_bwd_dq, at "
        "the training shapes (B = 4, no CFG doubling)")
    errs.update(dkv=[], dq=[])
    for label, N, M, lengths, dtype, cross in (
        ("self B*H=64 N=4096 M=4096", 4096, 4096, None, torch.bfloat16, False),
        ("self B*H=64 N=4096 M=1024", 4096, 1024, None, torch.bfloat16, False),
        ("cross B*H=64 N=4096 M=300 valid=(300, 120, 19, 3)", 4096, 300, (300, 120, 19, 3),
         torch.bfloat16, True),
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

    def run_path(ps, decode=True):
        fa.onepass_attention.launches = 0
        fa.crossattn_allheads.launches = 0
        torch.cuda.synchronize()
        t0 = time.perf_counter()
        lat = pipe(ps, return_latents=True, **call)
        t1 = time.perf_counter()
        imgs = pipe._latents_to_images(torch.from_numpy(lat).to(dev)) if decode else None
        t2 = time.perf_counter()
        counts = (fa.onepass_attention.launches, fa.crossattn_allheads.launches)
        return lat, imgs, counts, t1 - t0, t2 - t1

    torch.cuda.reset_peak_memory_stats()
    lat, imgs, counts, _, _ = run_path(prompts)
    launches = {"onepass": counts[0], "allheads": counts[1]}
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
    if counts != (expect, expect):
        raise SystemExit(f"kernel launches {counts} != {(expect, expect)}")

    # latents only: beyond 128 latent rows the decode is the tiled one, not ported yet
    lat_hw, _, counts_hw, _, _ = run_path(["a red fox in the snow --hw 1152:896"], decode=False)
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

    # ---- 5. times --------------------------------------------------------
    _, _, _, t_sample, t_decode = run_path(prompts)
    peak = torch.cuda.max_memory_allocated() / 2**30
    log(f"[time] {card}: sampler {t_sample / 2:.4f} s/img, decode {t_decode / 2:.4f} s/img "
        f"(2 images, 20 steps, CFG 4.5), peak memory {peak:.2f} GiB")
    trace(lambda: pipe(prompts, return_latents=True, **call),
          "1024px trajectory (2 images)", card)

    mask_path = torch.cat([t5.get_text_embeddings([negative] * 2)[1],
                           t5.get_text_embeddings(prompts)[1]]).to(dev).bool()
    entries = []
    for name, shapes in (
        ("onepass", ((4096, 4096), (4096, 1024))),
        ("allheads", ((4096, 300),)),
    ):
        rows = []
        for N, M in shapes:
            H, Dh, B = 16, 72, 4
            if name == "onepass":
                q, k, v = cases.onepass(B, N, M)
                mask = None
                kern = lambda: fa.onepass_attention(q, k, v)
                plain = lambda: fa.attention_reference(q, k, v)
                valid = B * M  # keys each head's rows attend to, summed over batch
            else:
                qf, kf, vf, _, _ = cases.allheads(B, N, M, (M,) * B)
                mask = mask_path
                kern = lambda: fa.crossattn_allheads(qf, kf, vf, mask, H)
                split = lambda x: x.unflatten(-1, (H, Dh))
                q, k, v = split(qf), split(kf), split(vf)
                plain = lambda: fa.attention_reference(q, k, v, mask)
                valid = int(mask.sum())
            qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
            am = None if mask is None else mask[:, None, None, :]
            library = lambda: F.scaled_dot_product_attention(qt, kt, vt, attn_mask=am)
            ms, plain_ms, lib_ms = cuda_ms(kern), cuda_ms(plain, iters=5), cuda_ms(library)
            lse_ms = None
            if name == "onepass":  # the training launch, which also writes the lse
                lse_ms = cuda_ms(lambda: fa._onepass_forward(q, k, v, None, with_lse=True))
            # the bound counts the work this run's data needs: valid keys only
            flops = 4.0 * H * N * valid * Dh
            nbytes = 2.0 * (2 * B * N * H * Dh + 2 * valid * H * Dh)
            b_ms, by = bound_ms(flops, nbytes)
            shape = (f"B*H={B * H} N={N} M={M}" if name == "onepass"
                     else f"B={B} C={H * Dh} N={N} M={M} ({valid} valid keys of {B * M})")
            log(f"[time] {card}: {name} {shape}: kernel {ms:.4f} ms, "
                f"plain {plain_ms:.4f} ms, sdpa {lib_ms:.4f} ms, bound {b_ms:.4f} ms "
                f"({by}; {flops / 1e9:.2f} GFLOP over valid keys, "
                f"{4.0 * H * N * B * M * Dh / 1e9:.2f} GFLOP over all keys, "
                f"{nbytes / 1e6:.1f} MB), share of bound {b_ms / ms:.3f}"
                + ("" if lse_ms is None else f"; with the lse output {lse_ms:.4f} ms"))
            rows.append(dict(N=N, M=M, ms=ms, plain_ms=plain_ms, bound_ms=b_ms, bound_by=by,
                             library_ms=lib_ms, lse_ms=lse_ms))
        head = rows[0]
        entries.append({
            "name": name,
            "route": "cuda",
            "source": f"pixart_sigma_tpu_torch/csrc/{name}_attention.cu",
            "replaces": ("pixart_sigma_tpu/ops/flash_attention.py:179" if name == "onepass"
                         else "pixart_sigma_tpu/ops/flash_attention.py:587"),
            "launches": launches[name],
            "max_abs_err": max(errs[name]),
            "ms": head["ms"], "plain_ms": head["plain_ms"], "bound_ms": head["bound_ms"],
            "bound_by": head["bound_by"], "library_ms": head["library_ms"],
            "shapes": rows,
        })
    del pipe, model, vae, t5
    torch.cuda.empty_cache()

    # ---- 6. the training path ---------------------------------------------
    launches_train = run_training(dev, card, fa)
    for entry in entries:
        entry["launches_training"] = launches_train[entry["name"]]

    # ---- 7. gradients through the kernels against plain attention -----------
    gradient_check(dev)

    # ---- 8. backward kernel times -------------------------------------------
    entries += backward_times(cases, fa, card, launches_train, errs)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
