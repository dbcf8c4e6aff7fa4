#!/usr/bin/env python3
"""Drive the PyTorch port's 1024px, 2K and 4K sampling and 1024px training
paths on one CUDA card.

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
   N = M = 16384, onepass's at N = 16384, M = 4096) on picked heads;
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
TRAIN_CONFIG = "configs/pixart_sigma_config/PixArt_sigma_xl2_img1024_internalms_kvcompress.py"
CONFIG_2K = "configs/pixart_sigma_config/PixArt_sigma_xl2_img2K_internalms_kvcompress.py"
STEPS_4K = 2
TRAIN_STEPS = 4


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
    and lse with one onepass launch. The 1024px keys fit the onepass gate, so
    flash never runs, and headsmajor, forward-only, never does in training."""
    return {"onepass": 3 * depth, "allheads": 2 * depth,
            "flash_bwd_dkv": 2 * depth, "flash_bwd_dq": 2 * depth,
            "flash_forward": 0, "headsmajor": 0}


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
                    "flash_bwd_dkv": fa.flash_bwd_dkv, "flash_bwd_dq": fa.flash_bwd_dq,
                    "flash_forward": fa.flash_attention, "headsmajor": fa.crossattn_headsmajor}
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
    trace(lambda: pipe([prompt], num_inference_steps=20, **call),
          "2K 20-step trajectory (1 image, CFG batch 2)", card)

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
    for N, M, iters in ((16384, 16384, 20), (65536, 65536, 3), (65536, 16384, 5)):
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
    logs = _build.build()
    if logs:
        log(f"[build] {len(logs)} sources in {time.perf_counter() - t0:.2f} s (nvcc, sm_90a)")
    else:
        log(f"[build] nothing to compile: libraries for these sources are in {_build.BUILD_DIR}")
    for name, text in logs.items():
        for line in text.splitlines():
            if any(w in line for w in ("Compiling entry", "Used", "spill", "C7514", "arning")):
                log(f"  {name}: {line.strip()}")
    smem_onepass = _build.load("onepass_attention").onepass_attention_smem_bytes()
    smem_cross = _build.load("cross_attention").cross_attention_smem_bytes()
    bwd = _build.load("flash_backward")
    smem_flash = _build.load("flash_forward").flash_forward_smem_bytes()
    log(f"  dynamic shared memory per block: onepass {smem_onepass} B, "
        f"allheads and headsmajor {smem_cross} B, dkv {bwd.flash_bwd_dkv_smem_bytes()} B, "
        f"dq {bwd.flash_bwd_dq_smem_bytes()} B, flash {smem_flash} B")
    # each checks its key tile and stages against the wrapper's
    fa._onepass_lib(), fa._flash_lib(), fa._cross_lib(), fa._backward_lib()
    log(f"  keys per tile: onepass and flash {fa.KEY_TILE} (a ring of {fa.KEY_STAGES} K/V "
        f"stages), allheads and headsmajor {fa.CROSS_KEY_TILE} (an extent of up to "
        f"{fa.CROSS_KEY_STAGES} tiles resident, longer ones streamed), dkv and dq "
        f"{fa.BWD_KEY_TILE} (dq's ring {fa.BWD_KEY_STAGES} stages); the planted skipped "
        "tile, the extent faults and the spike inputs follow them")

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
            got, fa.attention_reference(q, k, v), planted_faults(q, k, v, None, fa.KEY_TILE))
        errs["onepass"].append(err)
        all_ok &= ok
    # caption masks: prefixes of 300 keys or fewer, one with no valid key,
    # one valid only on keys [256, 300)
    cross_cases = ((4096, 300, (300, 120, 77, 1), torch.bfloat16),
                   (4096, 300, (300, 40, 5, 0), torch.bfloat16),
                   (4096, 300, (300, (256, 300), 77, 3), torch.bfloat16))
    for N, M, lengths, dtype in cross_cases + (
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
                    (4, 4096, 300, mask_long))
    entries = []
    for name, shapes in (
        ("onepass", ((4, 4096, 4096, None), (4, 4096, 1024, None))),
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
    del pipe, model
    torch.cuda.empty_cache()

    # ---- 6.-8. the 2K and 4K paths, the flash kernel's times ----------------
    entries.append(run_hires(dev, card, fa, cases, t5, vae, prompts[0], negative,
                             max(errs["flash_forward"])))
    del vae, t5
    torch.cuda.empty_cache()

    # ---- 9. the training path ---------------------------------------------
    launches_train = run_training(dev, card, fa)
    for entry in entries:
        entry["launches_training"] = launches_train[entry["name"]]

    # ---- 10. gradients through the kernels against plain attention ----------
    gradient_check(dev)

    # ---- 11. backward kernel times ------------------------------------------
    entries += backward_times(cases, fa, card, launches_train, errs)
    log(f"[done] {time.perf_counter() - t_start:.1f} s")
    log(card)
    print(json.dumps({"kernels": entries}))
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": kind, "count": count}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
