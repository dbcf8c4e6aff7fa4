"""The onepass and flash forwards at head dims 129-256 on one card: the
sources in `pixart_sigma_tpu_torch/csrc/` against copies with one design
choice undone, and optionally against another tree's sources (`--parent
DIR`, e.g. the parent commit unpacked with `git archive` into a directory
that .gitignore lists). The variants, each a patched copy under
build/ab_forwards/:

- this:         the sources as they are;
- width256:     head dims 129-192 at width 256 (four atoms) instead of 192;
- overlap256:   at width 256 S of tile j and P.V of tile j - 1 issued
                together, as at width 192, instead of in turns;
- in_turn192:   at width 192 too, in turns of their own;
- inline_trap:  the consumers' mbarrier waits trap inline, which holds
                ptxas to the launch bound's 168 registers there;
- regs_240_24:  setmaxnreg's 240 / 24 split instead of 232 / 40.

Prints each variant's ptxas spills and wgmma serialization at widths 192
and 256, holds `this` to the plain versions (`chip_smoke.
check_head_dim_forward`), then times onepass (M = 4096 and 1024) and flash
at Dh 144, 192 and 256 (H = 1152 / Dh, B = 4, N = 4096) with every variant
in one order and then the reverse, beside `scaled_dot_product_attention`.
With `--parent` it first compares the SASS of every kernel that the two
trees share and the forwards' redesign is to leave as it was (allheads,
headsmajor, dkv, dq; onepass and flash below width 192), instruction for
instruction.

    python3 chip_ab_forwards.py [--parent DIR]   # from the repository root, on the card
"""

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
import time
from pathlib import Path

VARIANTS = {  # name -> [(source file, its text, the replacement)]
    "this": [],
    "width256": [("hopper_common.cuh", "dh <= 192 ? 192 : 256", "256")],
    "overlap256": [("hopper_attention.cuh", "constexpr bool kInTurn = W == 256;",
                    "constexpr bool kInTurn = kCross && W == 256;")],
    "in_turn192": [("hopper_attention.cuh", "constexpr bool kInTurn = W == 256;",
                    "constexpr bool kInTurn = W >= 192;")],
    "inline_trap": [("hopper_attention.cuh", "mbar_wait<!kSelfWide>(R::full", "mbar_wait(R::full"),
                    ("hopper_attention.cuh", "mbar_wait<!kSelfWide>(R::qfull",
                     "mbar_wait(R::qfull")],
    "regs_240_24": [("hopper_attention.cuh",
                     "kProducerRegs = kSelfWide ? 40 : 24, kConsumerRegs = kSelfWide ? 232 : 240",
                     "kProducerRegs = 24, kConsumerRegs = 240")],
}
LIBS = ("onepass_attention", "flash_forward")
HEAD_DIMS = (144, 192, 256)


def ptxas_summary(log: str) -> str:
    """Spilled bytes (stores + loads) of the width-192 and 256 kernels, and
    whether ptxas serialized their wgmma (C7512); m: masked, f: f32 out."""
    serialized = set(re.findall(r"C7512\).*?function '(\S+)'", log))
    out, fn = [], None
    for line in log.splitlines():
        m = re.search(r"Function properties for (\S+)", line)
        if m:
            fn = m.group(1)
            continue
        m = re.search(r"(\d+) bytes spill stores, (\d+) bytes spill loads", line)
        w = re.search(r"_kernel\w*Li(\d+)EEv", fn or "")
        if m and w and w.group(1) in ("192", "256"):
            tag = f"W{w.group(1)}{'m' if 'Lb1E' in fn else ''}{'f' if 'IfLb' in fn else ''}"
            out.append(f"{tag}:{int(m.group(1)) + int(m.group(2))}B"
                       f"{'/serialized' if fn in serialized else ''}")
        fn = None
    return " ".join(out)


def sass(cuobjdump: Path, cubin: Path) -> dict:
    """{kernel: its SASS instructions without addresses and encodings}."""
    text = subprocess.run([str(cuobjdump), "-sass", str(cubin)], capture_output=True,
                          text=True).stdout
    out = {}
    for f in re.split(r"\n\s*Function : ", text)[1:]:
        name, body = f.split("\n", 1)
        lines = (re.sub(r"/\*[0-9a-f]{4,}\*/", "", l).split(";")[0].strip()
                 for l in body.splitlines())
        out[name.strip()] = [l for l in lines if l and not l.startswith("/*")]
    return out


def same_code(_build, csrc: Path, parent: Path, root: Path) -> bool:
    """Whether every kernel of cross_attention, flash_backward and the
    forwards below width 192 compiles to the same SASS from both trees."""
    cubins, procs = {}, []
    for tree, src in (("this", csrc), ("parent", parent)):
        for lib in ("cross_attention", "flash_backward") + LIBS:
            cubins[tree, lib] = root / f"{tree}_{lib}.cubin"
            procs.append(subprocess.Popen(
                [_build._nvcc(), *_build.NVCC_FLAGS[:4], "-cubin", "-o",
                 str(cubins[tree, lib]), str(src / f"{lib}.cu")]))
    if any(p.wait() for p in procs):
        raise SystemExit("chip_ab_forwards: nvcc failed on a -cubin build")
    same, tool = True, Path(_build._nvcc()).parent / "cuobjdump"
    for lib in ("cross_attention", "flash_backward") + LIBS:
        ours, theirs = sass(tool, cubins["this", lib]), sass(tool, cubins["parent", lib])
        kept = {k: v for k, v in theirs.items()
                if lib not in LIBS or not re.search(r"Li256E", k)}
        differ = [k for k, v in kept.items() if ours.get(k) != v]
        print(f"[sass] {lib}: {len(kept) - len(differ)} of {len(kept)} kernels identical to "
              f"the parent's{'; DIFFER: ' + ', '.join(differ) if differ else ''}", flush=True)
        same &= not differ
    return same


def patched_copies(csrc: Path, root: Path) -> dict:
    """{variant: its csrc directory}, each VARIANTS patch applied to a copy."""
    shutil.rmtree(root, ignore_errors=True)
    out = {}
    for name, subs in VARIANTS.items():
        copy = root / name / "csrc"
        shutil.copytree(csrc, copy)
        for fname, old, new in subs:
            text = (copy / fname).read_text()
            if old not in text:
                raise SystemExit(f"chip_ab_forwards: {name}: {old!r} is not in {fname}")
            (copy / fname).write_text(text.replace(old, new))
        out[name] = copy
    return out


def build(fa, _build, csrcs: dict, root: Path) -> dict:
    """Every variant's two libraries, all nvcc started together; prints their
    ptxas summaries. Returns {variant: {library: ctypes handle}}."""
    argtypes = {"onepass_attention": [fa._P] * 6 + [fa._I] * 6 + [fa._L] * 12 + [fa._F, fa._P],
                "flash_forward": [fa._P] * 6 + [fa._I] * 7 + [fa._L] * 12 + [fa._F, fa._P]}
    t0 = time.perf_counter()
    procs = {}
    for name, csrc in csrcs.items():
        (root / name).mkdir(parents=True, exist_ok=True)
        for lib in LIBS:
            out = root / name / f"lib{lib}.so"
            cmd = [_build._nvcc(), *_build.NVCC_FLAGS, "-o", str(out), str(csrc / f"{lib}.cu")]
            procs[name, lib] = (out, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                                      stderr=subprocess.STDOUT, text=True))
    libs = {}
    for (name, lib), (out, proc) in procs.items():
        log, _ = proc.communicate()
        if proc.returncode:
            raise SystemExit(f"chip_ab_forwards: nvcc failed for {name} {lib}:\n{log}")
        print(f"[ptxas] {name} {lib}: {ptxas_summary(log)}", flush=True)
        handle = ctypes.CDLL(str(out))
        fn = getattr(handle, lib)
        fn.argtypes, fn.restype = argtypes[lib], fa._I
        libs.setdefault(name, {})[lib] = handle
    print(f"[build] {len(procs)} libraries in {time.perf_counter() - t0:.1f} s", flush=True)
    return libs


def main() -> int:
    import torch

    if not torch.cuda.is_available():
        print("chip_ab_forwards: no CUDA device", file=sys.stderr)
        return 1
    ap = argparse.ArgumentParser()
    ap.add_argument("--parent", type=Path, help="a tree whose pixart_sigma_tpu_torch/csrc/ to "
                                                "time beside these")
    ap.add_argument("--iters", type=int, default=30)
    ap.add_argument("--variants", nargs="+", default=list(VARIANTS), choices=list(VARIANTS))
    args = ap.parse_args()
    import torch.nn.functional as F

    import chip_smoke as cs
    from pixart_sigma_tpu_torch.ops import _build
    from pixart_sigma_tpu_torch.ops import flash_attention as fa

    root = _build.BUILD_DIR.parent / "ab_forwards"
    csrcs = {k: v for k, v in patched_copies(_build.CSRC, root).items()
             if k == "this" or k in args.variants}
    if args.parent:
        csrcs["parent"] = args.parent.resolve() / "pixart_sigma_tpu_torch" / "csrc"
    card = cs.card_line()
    print(card, flush=True)
    ok = same_code(_build, _build.CSRC, csrcs["parent"], root) if args.parent else True
    libs = build(fa, _build, csrcs, root)

    def use(name):  # the wrappers launch this variant's kernels
        fa._onepass_lib = lambda: libs[name]["onepass_attention"]
        fa._flash_lib = lambda: libs[name]["flash_forward"]

    torch.backends.cuda.matmul.allow_tf32 = False
    cases = cs.Cases(torch.device("cuda"))
    use("this")
    for dh in (136,) + HEAD_DIMS:
        for name, B, N, M, lengths, dtype in (
                ("onepass", 4, 4096, 4096, None, torch.bfloat16),
                ("onepass", 4, 4096, 300, cs.HEAD_DIM_CAPTIONS, torch.bfloat16),
                ("flash", 2, 4096, 2500, (2500, 1100), torch.bfloat16),
                ("flash", 2, 1000, 1300, None, torch.float32)):
            ok &= cs.check_head_dim_forward(fa, cases, name, dh, B, N, M, lengths, dtype)[1]
    print(f"[ab] this against the plain versions: {'ok' if ok else 'FAILED'}", flush=True)
    order = list(libs)
    res = {}
    for dh in HEAD_DIMS:
        H, B = 1152 // dh, 4
        q, k, v = cases.onepass(B, 4096, 4096, H, dh)
        k1, v1 = k[:, :1024].contiguous(), v[:, :1024].contiguous()
        qt, kt, vt = (x.transpose(1, 2).contiguous() for x in (q, k, v))
        kt1, vt1 = (x.transpose(1, 2).contiguous() for x in (k1, v1))
        calls = {"onepass M=4096": lambda: fa.onepass_attention(q, k, v),
                 "onepass M=1024": lambda: fa.onepass_attention(q, k1, v1),
                 "flash M=4096": lambda: fa.flash_attention(q, k, v)}
        sdpa = {"onepass M=4096": lambda: F.scaled_dot_product_attention(qt, kt, vt),
                "onepass M=1024": lambda: F.scaled_dot_product_attention(qt, kt1, vt1)}
        sdpa["flash M=4096"] = sdpa["onepass M=4096"]
        for turn in order + order[::-1]:
            use(turn)
            for label, fn in calls.items():
                res.setdefault((dh, label, turn), []).append(cs.cuda_ms(fn, iters=args.iters))
        for label, fn in sdpa.items():
            res[dh, label, "sdpa"] = [cs.cuda_ms(fn, iters=args.iters)]
        del q, k, v, k1, v1, qt, kt, vt, kt1, vt1
        torch.cuda.empty_cache()
    for dh in HEAD_DIMS:
        for label in ("onepass M=4096", "onepass M=1024", "flash M=4096"):
            this = min(res[dh, label, "this"])
            lib = res[dh, label, "sdpa"][0]
            for turn in order + ["sdpa"]:
                ms = res[dh, label, turn]
                print(f"[ab] {card}: Dh={dh} H={1152 // dh} B=4 N=4096 {label} {turn}: "
                      f"{' '.join(f'{x:.4f}' for x in ms)} ms (best / this's "
                      f"{min(ms) / this:.3f}, / sdpa's {min(ms) / lib:.3f})", flush=True)
    return 0 if ok else 1


if __name__ == "__main__":
    sys.exit(main())
