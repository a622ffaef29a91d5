"""Time variants of the bf16 attention kernels (K5, K6) side by side.

A development aid for ``csrc/fused_attention.cu``: each variant is the
source with a few text substitutions (a constant, a guard), built by its
own ``nvcc`` into ``build/attention_variants/`` and loaded with ctypes
beside the others, so that all are timed in one process on one card, in
turns.  Each is also held against the plain version.  Needs a card:

    python -m textreid_torch.tools.attention_variants

Prints the card's name and power limit, each variant's registers at the
ViT shape, and per shape and variant the forward and backward time (the
lesser of two rounds of 30 launches, CUDA events) and the error relative
to the plain version's largest magnitude.
"""

from __future__ import annotations

import ctypes
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build
from ..ops import attention as A

OUT = _build.BUILD_DIR.parent / "attention_variants"
SOURCE = _build.CSRC / "fused_attention.cu"
# (batch, seq, width, heads, causal): ViT-B/16 at 384x128; the served
# CLIP-text bucket
SHAPES = ((128, 193, 768, 12, False), (256, 100, 512, 8, True))
GROUP = "constexpr int kTileGroup = 4;"
VARIANTS = {  # name: [(text, replacement), ...]
    "as committed": [],
    # one guard per key tile: nothing overlaps across tiles
    "guard per tile": [(GROUP, GROUP.replace("4", "1"))],
    "groups of 2": [(GROUP, GROUP.replace("4", "2"))],
    "groups of 8": [(GROUP, GROUP.replace("4", "8"))],
    # the forward without its copy that drops the guards
    "forward always guarded": [("if (kt_hi == NKT)", "if (false)")],
    # the copies alone: what the loads cost (results are wrong by design)
    "loads only": [("rt < n_kt; rt += n_warps", "rt < 0; rt += n_warps"),
                   ("rt < n_kt; rt += WARPS", "rt < 0; rt += WARPS"),
                   ("kt < n_kt; kt += WARPS", "kt < 0; kt += WARPS")],
}
_P, _I, _F = ctypes.c_void_p, ctypes.c_int, ctypes.c_float


def _start_build(name: str, edits) -> tuple:
    text = SOURCE.read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name!r}: {old!r} is not in the source")
        text = text.replace(old, new)
    stem = name.replace(" ", "_")
    src, lib = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    src.write_text(text)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    lib.fused_attention_fwd.argtypes = list(
        _build.SIGNATURES["fused_attention_fwd"])
    lib.fused_attention_bwd.argtypes = list(
        _build.SIGNATURES["fused_attention_bwd"])
    return lib


def _ms(fn, reps: int = 30) -> float:
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def main() -> int:
    if not torch.cuda.is_available():
        print("attention_variants needs a card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    OUT.mkdir(parents=True, exist_ok=True)
    builds = {name: _start_build(name, edits)
              for name, edits in VARIANTS.items()}
    libs = {}
    for name, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-2000:]}")
            continue
        lines = log.splitlines()
        for at, line in enumerate(lines):
            # the ViT shape's instantiations
            if "Compiling" in line and "_mmaILi64ELi13" in line:
                kernel = "K6" if "bwd" in line else "K5"
                used = next(x for x in lines[at:] if "Used" in x)
                print(f"{name}: {kernel} {used.split(':', 1)[1].strip()}")
        libs[name] = _load(path)
    stream = torch.cuda.current_stream().cuda_stream
    for batch, seq, width, heads, causal in SHAPES:
        gen = torch.Generator(device="cuda").manual_seed(1)
        qkv = torch.randn(batch, seq, 3 * width, device="cuda",
                          generator=gen).bfloat16()
        g = torch.randn(batch, seq, width, device="cuda",
                        generator=gen).bfloat16()
        scale = float(width // heads) ** -0.5
        want = (A.fused_attention_plain(qkv, heads, causal).float(),
                A.fused_attention_bwd_plain(qkv, g, heads, causal).float())
        for name, lib in libs.items():
            out, dqkv = torch.zeros_like(g), torch.zeros_like(qkv)

            def fwd():
                return lib.fused_attention_fwd(
                    qkv.data_ptr(), out.data_ptr(), batch, seq, width, heads,
                    scale, int(causal), 1, stream)

            def bwd():
                return lib.fused_attention_bwd(
                    qkv.data_ptr(), g.data_ptr(), dqkv.data_ptr(), None,
                    batch, seq, width, heads, scale, int(causal), 1, stream)

            codes = (fwd(), bwd())
            torch.cuda.synchronize()
            errs = [((got.float() - ref).abs().max() / ref.abs().max()).item()
                    for got, ref in zip((out, dqkv), want)]
            times = [_ms(fwd), _ms(bwd), _ms(fwd), _ms(bwd)]
            print(f"B={batch} S={seq} W={width} causal={causal} {name}: "
                  f"K5 {min(times[0], times[2]):.4f} ms (error "
                  f"{errs[0]:.1e}), K6 {min(times[1], times[3]):.4f} ms "
                  f"(error {errs[1]:.1e}), launch codes {codes}", flush=True)
    return 0


if __name__ == "__main__":
    sys.exit(main())
