"""Time variants of the GRU kernels (K1: the fused bi-GRU forward and
backward; K3: the one-direction scan) side by side.

A development aid for ``csrc/bigru_resident.cu`` (K1's bf16 forward),
``csrc/bigru_resident_bwd.cu`` (K1's bf16 backward),
``csrc/bigru_pooled.cu``, ``csrc/bigru_pooled_bwd.cu`` (the streamed
kernels: f32, and bf16 for comparison), ``csrc/gru_scan_resident.cu``
(K3's bf16 forward) and ``csrc/gru_scan.cu`` (K3's streamed kernel): each
variant is those sources (with the headers
``gru_cell.cuh`` and ``gru_resident.cuh`` beside them) after a few text
substitutions, built by its
own ``nvcc`` into ``build/gru_variants/`` and loaded with ctypes beside the
others, so that all are timed in one process on one card, in turns.
``--against DIR ...`` adds the ``csrc`` directory of another checkout (for
example the parent commit unpacked with ``git archive``) as the variant
"against 1", and so on, each timed on the entry points it has.  Needs a
card:

    python -m textreid_torch.tools.gru_variants [--against DIR ...]

Prints the card's name and power limit, each variant's registers, and per
variant, bf16, H=512, T=105 (the variants marked "wrong" compute garbage
and are there for their times alone): the pooled-only forward at B=256, 128 and 64
(and the streamed kernel it replaced, kept for comparison, at B=256),
one dependent forward step (the slope from T=5 to T=105 at B=8), the
W-resident backward kernel and the streamed one it replaced in bf16
(``streamed_backward``), each alone at B=128 (the lesser of two rounds of
CUDA events) with its largest error against ``bigru_pooled_bwd_plain`` on
the same saved state, relative to the plain gradient's largest magnitude,
and each one's dependent step (the slope from T=55 to T=105 at B=8); then
K3,
the W-resident scan at B=256, 128 and 1 and the streamed one at B=256,
and each one's dependent step.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build, gru

OUT = _build.BUILD_DIR.parent / "gru_variants"
_MMA = "                mma_bf16(acc[mt][j], a_{}, bw[i][j]);\n"
_BWD_MMA = "                mma_bf16(acc[j], a_{}, bw[i][j]);\n"
VARIANTS = {  # name: [(text, replacement), ...]
    "as committed": [],
    "streamed backward 2 threads a unit": [("constexpr int kBwdParts = 4;",
                                            "constexpr int kBwdParts = 2;")],
    "forward and backward in 32-row groups": [
        ("const int options[2] = {32, 16};",
         "const int options[2] = {32, 32};")],
    # deliberately wrong, for the time alone: what a backward step spends
    # on its products, on the lo half of them, and on the exchange of the
    # partial sums
    "backward without products (wrong)": [(_BWD_MMA.format("hi"), ""),
                                          (_BWD_MMA.format("lo"), "")],
    "backward without lo products (wrong)": [(_BWD_MMA.format("lo"), "")],
    "backward without exchange (wrong)": [
        ("            sizeof(float) * (csize - 1) * R * kUnits));",
         "            0 * sizeof(float) * (csize - 1) * R * kUnits));"),
        ("            st_async_v4(peer_recv[p]",
         "            if (0) st_async_v4(peer_recv[p]")],
    # deliberately wrong, for the time alone: what a forward step spends on
    # its products, on the lo half of them, and on its copies
    "forward without products (wrong)": [(_MMA.format("hi"), ""),
                                         (_MMA.format("lo"), "")],
    "forward without lo products (wrong)": [(_MMA.format("lo"), "")],
    "forward without copies (wrong)": [
        ("mbar_arrive_expect(&bar[cur ^ 1], static_cast<uint32_t>(",
         "mbar_arrive_expect(&bar[cur ^ 1], 0u * static_cast<uint32_t>("),
        ("          copy_to_peer(mine,", "          if (0) copy_to_peer(mine,")],
}


def streamed_forward(xf: torch.Tensor, xb: torch.Tensor, w_f: torch.Tensor,
                     w_b: torch.Tensor, lengths: torch.Tensor) -> torch.Tensor:
    """K1's pooled ``[B, 2H]`` (before the zero-participation rule) through
    the streamed kernel of ``csrc/bigru_pooled.cu``, which the W-resident
    kernel replaced for bf16 on the main path (f32 still runs it there).
    For comparison only: it counts no launch, and the port does not call
    it."""
    batch, seq, three_h = xf.shape
    out = torch.empty(batch, 2 * (three_h // 3), dtype=xf.dtype,
                      device=xf.device)
    gru._launch("bigru_pooled_fwd_streamed", xf, xb, w_f, w_b, lengths, out,
                batch, seq, three_h // 3, int(xf.dtype == torch.bfloat16))
    return out


def streamed_backward(g: torch.Tensor, w_f: torch.Tensor, w_b: torch.Tensor,
                      lengths: torch.Tensor, hp: torch.Tensor,
                      gates: torch.Tensor, argmax: torch.Tensor) -> tuple:
    """K1's backward ``(dxf, dxb, dhg)`` (before the wrapper's dW product)
    through the streamed kernel of ``csrc/bigru_pooled_bwd.cu``, W
    transposed as its route did every call.  The W-resident kernel
    replaced it for bf16 on the main path (f32 still runs it there).  For
    comparison only: it counts no launch, and the port does not call it."""
    _, batch, seq, hidden = hp.shape
    dxf = torch.empty(batch, seq, 3 * hidden, dtype=g.dtype, device=g.device)
    dxb = torch.empty_like(dxf)
    dhg = torch.empty(2, batch, seq, 3 * hidden, device=g.device)
    gru._launch("bigru_pooled_bwd", g, w_f.t().contiguous(),
                w_b.t().contiguous(), lengths, hp, gates, argmax, dxf, dxb,
                dhg, batch, seq, hidden, int(g.dtype == torch.bfloat16))
    return dxf, dxb, dhg


def streamed_scan(x: torch.Tensor, w: torch.Tensor, h0: torch.Tensor,
                  reverse: bool = False) -> torch.Tensor:
    """K3's ``[B, T, H]`` through the streamed kernel of
    ``csrc/gru_scan.cu``, which the W-resident kernel replaced for bf16 on
    the main path (f32 still runs it there).  For comparison only: it
    counts no launch, and the port does not call it."""
    batch, seq, three_h = x.shape
    out = torch.empty(batch, seq, three_h // 3, dtype=x.dtype,
                      device=x.device)
    gru._launch("gru_scan_fwd", x, w, h0, out, batch, seq, three_h // 3,
                int(bool(reverse)), int(x.dtype == torch.bfloat16))
    return out


def _start_build(name: str, csrc: Path, edits) -> tuple:
    folder = OUT / name.replace(" ", "_")
    folder.mkdir(parents=True, exist_ok=True)
    texts = {src.name: src.read_text() for src in sorted(
        csrc.glob("*gru_*.cu*"))}
    for old, new in edits:
        hits = [key for key, text in texts.items() if old in text]
        if not hits:
            raise ValueError(f"variant {name!r}: {old!r} is not in the source")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    for key, text in texts.items():
        (folder / key).write_text(text)
    lib = folder / "lib.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           *(str(folder / key) for key in texts if key.endswith(".cu"))]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in ("bigru_pooled_fwd", "bigru_pooled_fwd_train",
                 "bigru_pooled_bwd", "bigru_resident_bwd",
                 "bigru_pooled_fwd_streamed",
                 "gru_scan_fwd", "gru_scan_fwd_resident"):
        if hasattr(lib, name):
            getattr(lib, name).argtypes = list(_build.SIGNATURES[name])
    return lib


def _ms(fn, reps: int = 20) -> float:
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


def _inputs(batch, seq, hidden=512, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = [(torch.randn(batch, seq, 3 * hidden, device="cuda", generator=gen)
          * 0.6).bfloat16() for _ in range(2)]
    w = [((torch.rand(hidden, 3 * hidden, device="cuda", generator=gen) * 2
           - 1) / hidden ** 0.5).bfloat16() for _ in range(2)]
    lengths = torch.randint(1, seq + 1, (batch,), device="cuda",
                            generator=gen, dtype=torch.int32)
    lengths[0] = seq
    return (*x, *w, lengths)


def _time(name: str, lib: ctypes.CDLL) -> None:
    stream = torch.cuda.current_stream().cuda_stream

    def ptr(t):
        return t.data_ptr()

    def fwd(args):
        out = torch.empty(args[0].shape[0], 1024, device="cuda",
                          dtype=torch.bfloat16)
        return lambda: lib.bigru_pooled_fwd(
            *map(ptr, args), ptr(out), args[0].shape[0], args[0].shape[1],
            512, 1, stream)

    line = [f"{name}:"]
    for batch in (256, 128, 64):
        call = fwd(_inputs(batch, 105))
        line.append(f"forward B={batch} {min(_ms(call), _ms(call)):.4f} ms")
    if hasattr(lib, "bigru_pooled_fwd_streamed"):
        args = _inputs(256, 105)
        out = torch.empty(256, 1024, device="cuda", dtype=torch.bfloat16)

        def streamed():
            return lib.bigru_pooled_fwd_streamed(
                *map(ptr, args), ptr(out), 256, 105, 512, 1, stream)

        line.append(f"streamed forward B=256 "
                    f"{min(_ms(streamed), _ms(streamed)):.4f} ms")
    slope = [min(_ms(c), _ms(c)) for c in (fwd(_inputs(8, 5)),
                                           fwd(_inputs(8, 105)))]
    line.append(f"step {(slope[1] - slope[0]) / 100 * 1e3:.2f} us")
    for entry, kind in (("bigru_resident_bwd", "W-resident"),
                        ("bigru_pooled_bwd", "streamed")):
        if not hasattr(lib, entry):
            continue
        bwd, err, code = _backward(lib, entry, 128, 105)
        line.append(f"{kind} backward B=128 {min(_ms(bwd), _ms(bwd)):.4f} "
                    f"ms (error {err:.1e}, launch code {code})")
        slope = [min(_ms(c), _ms(c)) for c in (
            _backward(lib, entry, 8, 55)[0], _backward(lib, entry, 8, 105)[0])]
        line.append(f"{kind} backward step "
                    f"{(slope[1] - slope[0]) / 50 * 1e3:.2f} us")
    _time_scan(lib, line)
    print(", ".join(line), flush=True)


def _backward(lib: ctypes.CDLL, entry: str, batch: int, seq: int) -> tuple:
    """A call of ``lib``'s K1 backward ``entry`` (bf16, H=512) on the plain
    training forward's state, its largest error against
    ``bigru_pooled_bwd_plain`` (dx, and dW through the wrapper's product)
    relative to the plain gradient's largest magnitude, and the first
    call's launch code: ``(call, error, code)``."""
    stream = torch.cuda.current_stream().cuda_stream
    args = _inputs(batch, seq, seed=4)
    _, *saved = gru.bigru_pooled_fwd_train_plain(*args)
    g = torch.randn(batch, 1024, device="cuda").bfloat16()
    dxf, dxb = (torch.empty_like(args[0]) for _ in range(2))
    dhg = torch.empty(2, batch, seq, 1536, device="cuda")
    if entry == "bigru_resident_bwd":
        w, extra = args[2:4], ()
    else:
        w, extra = [t.t().contiguous() for t in args[2:4]], (1,)
    fn = getattr(lib, entry)

    def call():
        return fn(g.data_ptr(), *(t.data_ptr() for t in w),
                  args[4].data_ptr(), *(t.data_ptr() for t in saved),
                  dxf.data_ptr(), dxb.data_ptr(), dhg.data_ptr(), batch, seq,
                  512, *extra, stream)

    code = call()
    torch.cuda.synchronize()
    want = gru.bigru_pooled_bwd_plain(g, args[2], args[3], args[4], *saved)
    dw = torch.bmm(saved[0].view(2, -1, 512).transpose(1, 2),
                   dhg.view(2, -1, 1536))
    got = (dxf, dxb, dw[0].bfloat16(), dw[1].bfloat16())
    err = max(((a.float() - b.float()).abs().max()
               / b.float().abs().max()).item() for a, b in zip(got, want))
    return call, err, code


def _scan_inputs(batch, seq, hidden=512, seed=1):
    gen = torch.Generator(device="cuda").manual_seed(seed)
    x = (torch.randn(batch, seq, 3 * hidden, device="cuda", generator=gen)
         * 0.6).bfloat16()
    w = ((torch.rand(hidden, 3 * hidden, device="cuda", generator=gen) * 2
          - 1) / hidden ** 0.5).bfloat16()
    h0 = (torch.randn(batch, hidden, device="cuda", generator=gen)
          * 0.5).bfloat16()
    return x, w, h0


def _time_scan(lib: ctypes.CDLL, line: list) -> None:
    """K3's entry points that ``lib`` has: the resident scan at B=256, 128
    and 1, the streamed one at B=256, and the step of each."""
    stream = torch.cuda.current_stream().cuda_stream

    def call(entry, batch, seq):
        x, w, h0 = _scan_inputs(batch, seq)
        out = torch.empty(batch, seq, 512, device="cuda",
                          dtype=torch.bfloat16)
        extra = () if entry == "gru_scan_fwd_resident" else (1,)
        fn = getattr(lib, entry)
        return lambda: fn(x.data_ptr(), w.data_ptr(), h0.data_ptr(),
                          out.data_ptr(), batch, seq, 512, 0, *extra, stream)

    for entry, batches in (("gru_scan_fwd_resident", (256, 128, 1)),
                           ("gru_scan_fwd", (256,))):
        if not hasattr(lib, entry):
            continue
        kind = "resident" if entry.endswith("resident") else "streamed"
        for batch in batches:
            fn = call(entry, batch, 105)
            line.append(f"K3 {kind} B={batch} "
                        f"{min(_ms(fn), _ms(fn)):.4f} ms")
        slope = [min(_ms(c), _ms(c)) for c in (call(entry, 8, 5),
                                               call(entry, 8, 105))]
        line.append(f"K3 {kind} step {(slope[1] - slope[0]) / 100 * 1e3:.2f} "
                    "us")


def main(argv=None) -> int:
    parser = argparse.ArgumentParser(description=__doc__.split("\n\n")[0])
    parser.add_argument("--against", type=Path, nargs="*", default=[],
                        help="csrc directories of other checkouts")
    args = parser.parse_args(argv)
    if not torch.cuda.is_available():
        print("gru_variants needs a card", file=sys.stderr)
        return 1
    print(subprocess.run(
        ["nvidia-smi", "--query-gpu=name,power.limit",
         "--format=csv,noheader"], capture_output=True,
        text=True).stdout.strip())
    sources = {name: (_build.CSRC, edits) for name, edits in VARIANTS.items()}
    for at, csrc in enumerate(args.against, 1):
        sources[f"against {at}"] = (csrc, [])
    builds = {name: _start_build(name, csrc, edits)
              for name, (csrc, edits) in sources.items()}
    libs = {}
    for name, (path, proc) in builds.items():
        log, _ = proc.communicate()
        if proc.returncode:
            print(f"{name}: nvcc failed\n{log[-2000:]}")
            continue
        for block in log.split("Compiling entry function")[1:]:
            kernel = re.search(
                r"((?:bi)?gru_\w*?kernel)(I13__nv_bfloat16|ILi\d(?:ELb\d)?)",
                block)
            used = re.search(r"Used (\d+) registers", block)
            if kernel and used:
                print(f"{name}: {kernel.group(1)} {kernel.group(2)}: "
                      f"{used.group(1)} registers")
        libs[name] = _load(path)
    for round_ in range(2):  # every variant twice, in turns
        for name, lib in libs.items():
            _time(f"round {round_ + 1} {name}", lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
