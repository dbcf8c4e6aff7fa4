"""Width 256's attention forward on one card: the body in
`pixart_sigma_tpu_torch/csrc/` (B: P.V of tile j - 1 and S of tile j each in
a turn of its own) against the same sources with the two issued together,
as at the narrower widths (A: a copy under build/ with the width-256
branch of `consume` switched off). Prints each variant's ptxas registers
and spills for its width-256 kernels, holds B's onepass, flash, allheads
and headsmajor to their plain versions at Dh 144, 192 and 256
(`chip_smoke.check_head_dim_forward`), then times onepass (M = 4096 and
1024), flash and allheads at the 1024px shapes in turns A, B, B, A.

    python3 chip_ab_width256.py    # from the repository root, on the card
"""

import os
import re
import shutil
import sys
import time
from pathlib import Path

# the switch that turns B into A: width 256 takes the narrower widths' loop
IN_TURN = "        if constexpr (W == 256) {\n          // P.V of tile j - 1, then S"
OVERLAPPED = "        if constexpr (false) {\n          // P.V of tile j - 1, then S"
LIBS = ("onepass_attention", "flash_forward", "cross_attention")


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_width256: no CUDA device", file=sys.stderr)
        return 1
    import chip_smoke as cs
    from pixart_sigma_tpu_torch.ops import _build
    from pixart_sigma_tpu_torch.ops import flash_attention as fa

    csrc, build = _build.CSRC, _build.BUILD_DIR
    copy = build.parent / "ab_width256" / "csrc"
    shutil.rmtree(copy, ignore_errors=True)
    shutil.copytree(csrc, copy)
    body = (copy / "hopper_attention.cuh").read_text()
    if body.count(IN_TURN) != 1:
        print("chip_ab_width256: the width-256 branch was not found", file=sys.stderr)
        return 1
    (copy / "hopper_attention.cuh").write_text(body.replace(IN_TURN, OVERLAPPED))
    roots = {"A": (copy, copy.parent / "kernels"), "B": (csrc, build)}

    def use(variant):
        _build.CSRC, _build.BUILD_DIR = roots[variant]
        for f in (_build.load, fa._onepass_lib, fa._flash_lib, fa._cross_lib):
            f.cache_clear()

    card = cs.card_line()
    print(card, flush=True)
    for v in ("A", "B"):
        use(v)
        t0 = time.perf_counter()
        logs = _build.build(LIBS)
        print(f"[build {v}] {time.perf_counter() - t0:.1f} s", flush=True)
        for name, log in logs.items():
            fn = None
            for line in log.splitlines():
                m = re.search(r"Compiling entry function '(\S+)'", line)
                if m:
                    fn = m.group(1)
                elif fn and "Li256E" in fn and ("spill" in line or "Used" in line):
                    print(f"  {v} {fn[:48]}: {line.strip()[-70:]}", flush=True)
    torch.backends.cuda.matmul.allow_tf32 = False
    cases = cs.Cases(torch.device("cuda"))
    use("B")
    ok = True
    for dh in (144, 192, 256):
        for name, B, N, M, lengths, dtype in (
                ("onepass", 4, 4096, 4096, None, torch.bfloat16),
                ("onepass", 4, 4096, 300, cs.HEAD_DIM_CAPTIONS, torch.bfloat16),
                ("flash", 4, 4096, 4096, None, torch.bfloat16),
                ("allheads", 4, 4096, 300, cs.HEAD_DIM_CAPTIONS, torch.bfloat16),
                ("headsmajor", 4, 1000, 77, (77, 40, 5, 1), torch.float32)):
            ok &= cs.check_head_dim_forward(fa, cases, name, dh, B, N, M, lengths, dtype)[1]
    print(f"[ab] B against the plain versions: {'ok' if ok else 'FAILED'}", flush=True)
    mask = cases.lengths_mask((19, 12, 7, 3), 300)
    res = {}
    for dh in (144, 192, 256):
        H, B = 1152 // dh, 4
        q, k, v = cases.onepass(B, 4096, 4096, H, dh)
        qf, kf, vf, _, _ = cases.allheads(B, 4096, 300, (300,) * 4, H, dh)
        calls = {"onepass": lambda: fa.onepass_attention(q, k, v),
                 "onepass M=1024": lambda: fa.onepass_attention(q, k[:, :1024], v[:, :1024]),
                 "flash": lambda: fa.flash_attention(q, k, v),
                 "allheads": lambda: fa.crossattn_allheads(qf, kf, vf, mask, H)}
        for turn in ("A", "B", "B", "A"):
            use(turn)
            for name, fn in calls.items():
                res.setdefault((dh, name, turn), []).append(cs.cuda_ms(fn, iters=30))
    for (dh, name, turn), ms in sorted(res.items()):
        print(f"[ab] {card}: Dh={dh} H={1152 // dh} B=4 N=4096 {name} {turn}: "
              f"{' '.join(f'{x:.4f}' for x in ms)} ms", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
