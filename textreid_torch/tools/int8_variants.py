"""Time K7 (the fused int8 FFN) and K8 (the int8 matmul + requant) on
their cluster kernels against the 16-row kernels, and variants of K7, K8
or K9 (the fused requant), side by side.

A development aid for ``csrc/int8_mm.cu`` (K7's cluster tile and both
16-row kernels), ``csrc/int8_mm_sm90.cu`` (K8's cluster kernel, W
resident, ``wgmma``) and ``csrc/requant.cu`` (K9).  The four int8 matmul
kernels are in the port's library, so one process times each cluster
kernel in turns with its 16-row kernel (16-row, cluster, cluster, 16-row)
on the same inputs at both towers' shapes, with CUDA events, and checks
that the two agree bit for bit.  With ``--variants k7``, ``k8`` or ``k9``
it also builds text-patched copies of that kernel's source (a constant, a
loop bound, K9's design by C; the ones marked "wrong" skip work and are
there for their times alone), and ``--against``'s files of other
checkouts, into ``build/int8_variants/`` and times each one's entry point
in turns, three ways: as the host issues the launches, queued behind a
device sleep (the device's time, where the wrapper's host time is longer
than the kernel), and queued with L2 flushed before each launch.  Needs a
card:

    python -m textreid_torch.tools.int8_variants [--variants {k7,k8,k9}
        [--against OTHER_CHECKOUT/textreid_torch/csrc/FILE.cu ...]]

Prints the card's name and power limit; per shape K7's cluster tile
(blocks a cluster, rows a tile), both K7 kernels' times per output dtype
and the L2 bytes of the weights each reads (the blocks of a tile read both
weights once between them); K8's plan and both K8 kernels' times; then
each variant's registers, times and how far its output is from the
committed kernel's.
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
# ViT-B/16 FFN at 128 x 193 tokens, the text tower at one /search query
SHAPES = (("CLIP text", 25600, 512, 2048), ("ViT-B/16", 24704, 768, 3072),
          ("one query", 100, 512, 2048))
OUT = _build.BUILD_DIR.parent / "int8_variants"
TILES = "constexpr int kTileRows[2] = {64, 32};"
K7_VARIANTS = {  # name: [(text, replacement), ...]
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
K8_VARIANTS = {  # of csrc/int8_mm_sm90.cu
    "as committed": [],
    # one tile in flight a block
    "1 consumer warpgroup": [("constexpr int kConsumers = 2;",
                              "constexpr int kConsumers = 1;")],
    "4 stages at most": [("constexpr int kMaxStages = 8;",
                          "constexpr int kMaxStages = 4;")],
    # deliberately wrong, for the time alone
    "without the GELU's exp and reciprocal (wrong)": [
        ("const float d = __fadd_rn(1.0f, expf(-__fmul_rn(1.702f, y)));",
         "const float d = __fmul_rn(1.702f, y);"),
        ("y = __fmul_rn(y, rcp_rn(d));", "y = __fmul_rn(y, d);")],
    "without the second pass (wrong)": [
        ("if (kGelu) {  // the second pass",
         "if (false) {  // the second pass")],
    "without the input's copies (wrong)": [
        ("mbar_expect(bar, kStageBytes);", "mbar_arrive(bar);"),
        ("tma_load(wg_ring + s * kStageBytes, &a_map, bar, c * kChunk,\n"
         "                   (first + j * clusters) * kRows);", "")],
    "without the decode (wrong)": [
        ("for (int e = 0; e < kCols / 2; ++e) {\n        const int col = 8 * "
         "(e / 4) + 2 * quad + (e & 1);\n        bool slow;",
         "for (int e = 0; e < 0; ++e) {\n        const int col = 8 * "
         "(e / 4) + 2 * quad + (e & 1);\n        bool slow;")],
    # each block rounds with its own slice's row maxima
    "without the row-max exchange (wrong)": [
        ("if (wtid < csize && wtid != rank) {", "if (false) {"),
        ("(csize - 1) * kRows * 4", "0")],
    "without the stores (wrong)": [
        ("if (row_a < rows) *reinterpret_cast<uint2*>", "if (row_a < 0) "
         "*reinterpret_cast<uint2*>"),
        ("if (row_b < rows) *reinterpret_cast<uint2*>", "if (row_b < 0) "
         "*reinterpret_cast<uint2*>")],
}


K9_VARIANTS = {  # of csrc/requant.cu
    "as committed": [],
    # the kernel of every C before the register design
    "the staged design at every C": [("if (c > kRegisterC || c % kVec)",
                                      "if (true)")],
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


def matmul_rows16(xq, w_q, s_w, b, r_row, s_next, op="gelu"):
    """K8 through the 16-row kernel (``int8_matmul_requant_rows16``: one
    ``mma.sync`` row tile a block, the f32 middle in shared memory), on card
    tensors as ``int8_mm.fused_int8_matmul_requant`` takes them.  The port
    calls it only for the shapes ``int8_mm.matmul_plan`` gives it; here at
    any shape it takes, for comparison, counting no launch."""
    lead, x2, r2 = int8_mm._rows(xq, r_row)
    rows, k = x2.shape
    w_t = int8_mm._kernel_weight("w_q", w_q, xq.device)
    n = w_t.shape[0]
    int8_mm._check_dims("int8_matmul_requant_rows16", k, n)
    q, r = int8_mm._launch_matmul_requant(
        "int8_matmul_requant_rows16", x2, w_t, s_w, b, r2, s_next, op)
    return q.reshape(*lead, n), r.reshape(*lead, 1)


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


# device cycles of sleep a queued launch waits behind (~60 us at the H100's
# clock): time for the host to issue it
HOST_AHEAD_CYCLES = 120_000


def queued_ms(fn, reps=10):
    """Mean device time of ``fn`` over ``reps`` launches queued behind a
    device sleep while the host issues them, so that a kernel shorter than
    its wrapper's host time is timed on the device, not on the host."""
    fn()
    torch.cuda.synchronize()
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    torch.cuda._sleep(HOST_AHEAD_CYCLES * reps)
    start.record()
    for _ in range(reps):
        fn()
    end.record()
    end.synchronize()
    return start.elapsed_time(end) / reps


def cold_ms(fn, reps, scratch):
    """Mean device time of ``fn`` with a cold L2: before each launch
    ``scratch`` (more than the 50 MB L2) is written and the launch queued
    behind a device sleep; only ``fn``'s span is counted."""
    fn()
    torch.cuda.synchronize()
    spans = [(torch.cuda.Event(enable_timing=True),
              torch.cuda.Event(enable_timing=True)) for _ in range(reps)]
    for start, end in spans:
        scratch.fill_(1.0)
        torch.cuda._sleep(HOST_AHEAD_CYCLES)
        start.record()
        fn()
        end.record()
    torch.cuda.synchronize()
    return sum(start.elapsed_time(end) for start, end in spans) / reps


def compare(rows, k, n, out_dtype=torch.bfloat16):
    """K7: (cluster ms, 16-row ms, equal) at one shape, timed in turns."""
    args = site(rows, k, n)
    new = lambda: int8_mm.fused_int8_ffn(*args, out_dtype=out_dtype)  # noqa
    old = lambda: ffn_rows16(*args, out_dtype=out_dtype)  # noqa
    equal = torch.equal(new(), old())
    o0, n0, n1, o1 = _ms(old), _ms(new), _ms(new), _ms(old)
    return (n0 + n1) / 2, (o0 + o1) / 2, equal


def compare_k8(rows, k, n, op="gelu"):
    """K8: (cluster ms, 16-row ms, equal) at one shape, timed in turns."""
    args = site(rows, k, n)[:6]
    new = lambda: int8_mm.fused_int8_matmul_requant(*args, op=op)  # noqa
    old = lambda: matmul_rows16(*args, op=op)  # noqa
    equal = all(torch.equal(a, b) for a, b in zip(new(), old()))
    o0, n0, n1, o1 = _ms(old), _ms(new), _ms(new), _ms(old)
    return (n0 + n1) / 2, (o0 + o1) / 2, equal


def _start_build(name: str, edits, source: Path) -> tuple:
    text = source.read_text()
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


def _k7_call(lib, args, out_dtype=torch.bfloat16):
    """``int8_ffn`` of a variant's library on the arguments of
    ``fused_int8_ffn``; the call returns its output."""
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
        return (out,)
    return call


def _k8_call(lib, args):
    """``int8_matmul_requant`` (gelu) of a variant's library on the
    arguments of ``fused_int8_matmul_requant``; the call returns (q, r)."""
    lead, x2, r2 = int8_mm._rows(args[0], args[4])
    rows, k = x2.shape
    w_t = args[1].t()  # contiguous [N, K]
    n = w_t.shape[0]
    q = torch.empty(rows, n, dtype=torch.int8, device="cuda")
    r = torch.empty(rows, 1, device="cuda")
    ptrs = [x2, w_t, args[2], args[3], r2, args[5], q, r]
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.int8_matmul_requant(*(t.data_ptr() for t in ptrs), rows, k,
                                      n, 1, stream)
        if err:
            raise RuntimeError(f"int8_matmul_requant variant: cudaError_t "
                               f"{err}")
        return q, r
    return call


def requant_site(rows, k, n, seed=5):
    """K9's inputs at a LayerNorm site of width ``k``: bf16 ``x`` and the
    per-channel scales (``n`` is not used)."""
    g = torch.Generator(device="cuda").manual_seed(seed)
    x = torch.randn(rows, k, device="cuda", generator=g) * 1.5 + 0.2
    return [x.to(torch.bfloat16),
            (torch.rand(k, device="cuda", generator=g) + 0.05) / 127.0]


def _k9_call(lib, args):
    """``fused_requant`` (ln, bf16) of a variant's library on ``x, s``;
    the call returns (q, r)."""
    x, s = args
    rows, c = x.shape
    q = torch.empty(rows, c, dtype=torch.int8, device="cuda")
    r = torch.empty(rows, 1, device="cuda")
    stream = torch.cuda.current_stream().cuda_stream

    def call():
        err = lib.fused_requant(x.data_ptr(), s.data_ptr(), q.data_ptr(),
                                r.data_ptr(), rows, c, 1, 1e-5, 1, stream)
        if err:
            raise RuntimeError(f"fused_requant variant: cudaError_t {err}")
        return q, r
    return call


# kernel: (source, entry point, variants, the kernel whose registers are
# printed, its inputs at a shape, a call on those inputs)
KERNELS = {
    "k7": ("int8_mm.cu", "int8_ffn", K7_VARIANTS,
           r"ffn_cluster_kernelI13__nv_bfloat16Li(\d)", site, _k7_call),
    "k8": ("int8_mm_sm90.cu", "int8_matmul_requant", K8_VARIANTS,
           r"matmul_requant_sm90ILi(\d+)ELb1E", site, _k8_call),
    "k9": ("requant.cu", "fused_requant", K9_VARIANTS,
           r"((?:rows|staged)_kernelI13__nv_bfloat16(?:Li\d)?)",
           requant_site, _k9_call),
}


def _distance(got, want):
    """How far a variant's outputs are from the committed kernel's: "equal",
    or for each output that differs, the share of its elements that differ
    and by how much at most."""
    parts = []
    for i, (a, b) in enumerate(zip(got, want)):
        if not torch.equal(a, b):
            diff = (a.float() - b.float()).abs()
            parts.append(f"output {i}: {(diff > 0).float().mean().item():.3e}"
                         f" of the elements differ, by at most "
                         f"{diff.max().item():.3e}")
    return "; ".join(parts) or "equal"


def variants(kernel: str, against=()) -> None:
    """Build every variant of ``kernel``'s source (and each file of
    ``against``, as "against 1", ...), then time each one's entry point in
    turns at both shapes (K7: bf16 out; K8: gelu; K9: ln of bf16 rows of
    the towers' widths), as issued, queued and with L2 flushed."""
    source, entry, table, pattern, inputs, make_call = KERNELS[kernel]
    builds = {name: _start_build(name, edits, _build.CSRC / source)
              for name, edits in table.items()}
    for at, path in enumerate(against, 1):
        builds[f"against {at}"] = _start_build(f"against {at}", [], path)
    libs = {}
    for name, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-2000:]}")
            continue
        for block in log.split("Compiling entry function")[1:]:
            found = re.search(pattern, block)
            used = re.search(r"Used (\d+) registers", block)
            spill = re.search(r"(\d+) bytes spill stores", block)
            if found and used:
                print(f"{name}: {kernel} kernel <{found.group(1)}>: "
                      f"{used.group(1)} registers, "
                      f"{spill.group(1) if spill else '?'} bytes spilled")
        lib = ctypes.CDLL(str(path))
        getattr(lib, entry).argtypes = list(_build.SIGNATURES[entry])
        libs[name] = lib
    scratch = torch.empty(16 * 2**20, device="cuda")  # 64 MB
    ways = ("as issued", "queued", "L2 flushed")
    for name, rows, k, n in SHAPES:
        args = inputs(rows, k, n)
        calls = {v: make_call(lib, args) for v, lib in libs.items()}
        want = [t.clone() for t in calls["as committed"]()]
        times = {v: [] for v in calls}
        for _ in range(2):  # every variant twice, in turns
            for v, call in calls.items():
                print(f"timing {v} at {name}", flush=True)
                times[v].append((_ms(call), queued_ms(call),
                                 cold_ms(call, 10, scratch)))
        for v, call in calls.items():
            best = [min(each) for each in zip(*times[v])]
            print(f"variant {v}: {kernel} {name} [{rows}, {k}] x {n} "
                  + ", ".join(f"{way} {ms:.4f} ms"
                              for way, ms in zip(ways, best))
                  + f"; output against the committed kernel's: "
                  f"{_distance(call(), want)}", flush=True)


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--variants", choices=sorted(KERNELS),
                        help="also build and time this kernel's variants")
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="that kernel's source in other checkouts, "
                             "timed with the variants")
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
        plan = int8_mm.matmul_plan(k, n)
        for op in ("gelu", "none"):
            new_ms, old_ms, equal = compare_k8(rows, k, n, op)
            print(f"K8 {name} [{rows}, {k}] x {n} {op}: {plan} "
                  f"{new_ms:.4f} ms; 16-row kernel {old_ms:.4f} ms; outputs "
                  f"equal: {equal}", flush=True)
    if args.variants:
        variants(args.variants, args.against)
    return 0


if __name__ == "__main__":
    sys.exit(main())
