"""Time K7 (the fused int8 FFN) on its cluster tile against the 16-row
kernel it replaced, and variants of the cluster kernel, side by side.

A development aid for ``csrc/int8_mm.cu``: both kernels are in the port's
library (``int8_ffn`` and ``int8_ffn_rows16``), so one process times them in
turns (16-row, cluster, cluster, 16-row) on the same inputs at both towers'
FFN shapes, with CUDA events, and checks that the two agree bit for bit.
No path of the port calls the 16-row kernel.  With ``--variants`` it also
builds text-patched copies of ``csrc/int8_mm.cu`` (a constant, a loop
bound; the ones marked "wrong" skip work and are there for their times
alone), and ``--against``'s files of other checkouts, into
``build/int8_variants/`` and times each one's ``int8_ffn`` in turns.  Needs a card:

    python -m textreid_torch.tools.int8_variants [--variants
        [--against OTHER_CHECKOUT/textreid_torch/csrc/int8_mm.cu ...]]

Prints the card's name and power limit, the cluster tile (blocks a cluster,
rows a tile) at each shape, and per shape and output dtype both kernels'
times and the L2 bytes of the weights each reads (the blocks of a tile
read both weights once between them); then each variant's registers and
times.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build, int8_mm

# (name, rows, K, N): the CLIP text FFN at a batch of 256 x 100 tokens, the
# ViT-B/16 FFN at 128 x 193 tokens
SHAPES = (("CLIP text", 25600, 512, 2048), ("ViT-B/16", 24704, 768, 3072))
OUT = _build.BUILD_DIR.parent / "int8_variants"
TILES = "constexpr int kTileRows[2] = {64, 32};"
VARIANTS = {  # name: [(text, replacement), ...]
    "as committed": [],
    "32-row tiles": [(TILES, TILES.replace("64, 32", "32, 32"))],
    # the whole tile's rows on each of 8 warps (255 registers a thread)
    "8 warps": [("constexpr int kCWarps = 16;", "constexpr int kCWarps = 8;"),
                ("constexpr int kHalves = 2;", "constexpr int kHalves = 1;")],
    "4 chunks in flight": [
        ("#pragma unroll 2\n  for (int k = 0; k < depth; k += 64) {\n"
         "    uint4 b[NT];",
         "#pragma unroll 4\n  for (int k = 0; k < depth; k += 64) {\n"
         "    uint4 b[NT];")],
    # deliberately wrong, for the time alone
    "without the first product (wrong)": [
        ("for (int g = hw; g < s / 32; g += kHalfWarps) {",
         "for (int g = hw; g < 0; g += kHalfWarps) {")],
    "without the second product (wrong)": [
        ("  if (kh < ksplit)  // step 0", "  if (false)  // step 0"),
        ("    if (i + 1 < csize && kh < ksplit)", "    if (false)")],
    "without the GELU's exp and reciprocal (wrong)": [
        ("y = __fmul_rn(y, __frcp_rn(__fadd_rn(1.0f, expf(-u))));",
         "y = __fmul_rn(y, u);")],
    "without the input tile's copy (wrong)": [
        ("for (int i = threadIdx.x; i < R * chunks; i += kCThreads) {",
         "for (int i = threadIdx.x; i < 0; i += kCThreads) {")],
    "without the requant (wrong)": [
        ("for (int r = warp; r < R; r += kCWarps) {",
         "for (int r = warp; r < 0; r += kCWarps) {")],
    # the ring's partials read from the block's own stage, no barrier
    "without the ring's exchange (wrong)": [
        ("    cluster_arrive();\n", ""), ("    cluster_wait();\n", ""),
        ("cluster.map_shared_rank(stage, (c - i + csize) % csize)",
         "stage")],
}


def ffn_rows16(xq, w1_q, s_w1, b1, r_row, s_mid, w2_q, s_w2, b2,
               out_dtype=torch.float32) -> torch.Tensor:
    """K7 through the 16-row kernel that the cluster kernel replaced (one
    ``mma.sync`` row tile a block, the whole f32 middle in its shared
    memory), on card tensors as ``int8_mm.fused_int8_ffn`` takes them.
    For comparison only: it counts no launch, and the port does not call
    it."""
    lead, x2, r2 = int8_mm._rows(xq, r_row)
    rows, k = x2.shape
    dev = xq.device
    w1_t = int8_mm._kernel_weight("w1_q", w1_q, dev)
    w2_t = int8_mm._kernel_weight("w2_q", w2_q, dev)
    n, m_out = w1_t.shape[0], w2_t.shape[0]
    int8_mm._check_dims("int8_ffn_rows16", k, n, m_out)
    out = torch.empty(rows, m_out, dtype=out_dtype, device=dev)
    vectors = [v.contiguous() for v in (s_w1, b1, s_mid, s_w2, b2)]
    lib = _build.library()
    with torch.cuda.device(dev):
        err = lib.int8_ffn_rows16(
            x2.data_ptr(), w1_t.data_ptr(), vectors[0].data_ptr(),
            vectors[1].data_ptr(), r2.data_ptr(), vectors[2].data_ptr(),
            w2_t.data_ptr(), vectors[3].data_ptr(), vectors[4].data_ptr(),
            out.data_ptr(), rows, k, n, m_out,
            int(out_dtype == torch.bfloat16),
            torch.cuda.current_stream().cuda_stream)
    _build.check(err, "int8_ffn_rows16")
    return out.reshape(*lead, m_out)


def site(rows, k, n, seed=3):
    """A quantized FFN site on the card, weights held as the transpose of a
    contiguous ``[N, K]`` as the towers hold them."""
    g = torch.Generator(device="cuda").manual_seed(seed)

    def ints(*shape):
        return torch.randint(-127, 128, shape, device="cuda", generator=g,
                             dtype=torch.int8)

    def uniform(*shape):
        return torch.rand(*shape, device="cuda", generator=g)

    return [ints(rows, k), ints(n, k).t(), (uniform(n) + 0.1) * 1e-3,
            torch.randn(n, device="cuda", generator=g) * 0.05,
            (uniform(rows, 1) + 0.05) / 127.0, (uniform(n) + 0.05) / 127.0,
            ints(k, n).t(), (uniform(k) + 0.1) * 1e-3,
            torch.randn(k, device="cuda", generator=g) * 0.05]


def weight_bytes(rows, k, n, tile_rows):
    """L2 bytes of the weights a call reads: the blocks of a tile read both
    weights, ``2 K N`` bytes, once between them."""
    return -(-rows // tile_rows) * 2 * k * n


def _ms(fn, reps=10):
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


def compare(rows, k, n, out_dtype=torch.bfloat16):
    """(cluster ms, 16-row ms, equal) at one shape, timed in turns."""
    args = site(rows, k, n)
    new = lambda: int8_mm.fused_int8_ffn(*args, out_dtype=out_dtype)  # noqa
    old = lambda: ffn_rows16(*args, out_dtype=out_dtype)  # noqa
    equal = torch.equal(new(), old())
    o0, n0, n1, o1 = _ms(old), _ms(new), _ms(new), _ms(old)
    return (n0 + n1) / 2, (o0 + o1) / 2, equal


def _start_build(name: str, edits, source=None) -> tuple:
    text = (source or _build.CSRC / "int8_mm.cu").read_text()
    for old, new in edits:
        if old not in text:
            raise ValueError(f"variant {name!r}: {old!r} is not in the source")
        text = text.replace(old, new)
    OUT.mkdir(parents=True, exist_ok=True)
    stem = re.sub(r"\W+", "_", name)
    src, lib = OUT / f"{stem}.cu", OUT / f"{stem}.so"
    src.write_text(text)
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           str(src)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _variant_call(lib, args, out_dtype=torch.bfloat16):
    """``int8_ffn`` of a variant's library on the arguments of
    ``fused_int8_ffn``."""
    lead, x2, r2 = int8_mm._rows(args[0], args[4])
    rows, k = x2.shape
    w1_t, w2_t = args[1].t(), args[6].t()  # contiguous [N, K], [M, N]
    n, m_out = w1_t.shape[0], w2_t.shape[0]
    out = torch.empty(rows, m_out, dtype=out_dtype, device="cuda")
    ptrs = [x2, w1_t, args[2], args[3], r2, args[5], w2_t, args[7], args[8],
            out]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.int8_ffn(*(t.data_ptr() for t in ptrs), rows, k, n, m_out,
                           int(out_dtype == torch.bfloat16), stream)
        if err:
            raise RuntimeError(f"int8_ffn variant: cudaError_t {err}")
        return out
    return call


def variants(against=()) -> None:
    """Build every variant (and each ``int8_mm.cu`` of ``against``, as
    "against 1", ...), then time each one's ``int8_ffn`` in turns at both
    shapes (bf16 out)."""
    builds = {name: _start_build(name, edits)
              for name, edits in VARIANTS.items()}
    for at, source in enumerate(against, 1):
        builds[f"against {at}"] = _start_build(f"against {at}", [], source)
    libs = {}
    for name, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-2000:]}")
            continue
        for block in log.split("Compiling entry function")[1:]:
            kernel = re.search(r"ffn_cluster_kernelI13__nv_bfloat16Li(\d)",
                               block)
            used = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            if kernel and used:
                print(f"{name}: ffn_cluster_kernel bf16 {16 * int(kernel.group(1))}"
                      f" rows: {used.group(1)} registers, "
                      f"{spill.group(1) if spill else '?'} bytes spilled")
        lib = ctypes.CDLL(str(path))
        lib.int8_ffn.argtypes = list(_build.SIGNATURES["int8_ffn"])
        libs[name] = lib
    for name, rows, k, n in SHAPES:
        args = site(rows, k, n)
        calls = {v: _variant_call(lib, args) for v, lib in libs.items()}
        want = calls["as committed"]().clone()
        times = {v: [] for v in calls}
        for _ in range(2):  # every variant twice, in turns
            for v, call in calls.items():
                times[v].append(_ms(call))
        for v, call in calls.items():
            print(f"variant {v}: K7 {name} [{rows}, {k}] -> {n} -> {k} bf16 "
                  f"{min(times[v]):.4f} ms, output equal to the committed "
                  f"kernel's: {torch.equal(call(), want)}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", action="store_true",
                        help="also build and time the variants")
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="int8_mm.cu files of other checkouts, timed "
                             "with the variants")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("int8_variants needs a card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    for name, rows, k, n in SHAPES:
        blocks, tile = int8_mm.ffn_plan(k, n, k)
        for dtype in (torch.bfloat16, torch.float32):
            new_ms, old_ms, equal = compare(rows, k, n, dtype)
            print(f"K7 {name} [{rows}, {k}] -> {n} -> {k} "
                  f"{str(dtype).split('.')[1]}: cluster tile ({blocks} "
                  f"blocks x {tile} rows) {new_ms:.4f} ms, "
                  f"{weight_bytes(rows, k, n, tile) / 1e9:.2f} GB of "
                  f"weights; 16-row kernel {old_ms:.4f} ms, "
                  f"{weight_bytes(rows, k, n, 16) / 1e9:.2f} GB; outputs "
                  f"equal: {equal}", flush=True)
    if args.variants:
        variants(args.against)
    return 0


if __name__ == "__main__":
    sys.exit(main())
