"""Time variants of the fused bi-GRU kernels (K1: forward, backward) side by
side.

A development aid for ``csrc/bigru_resident.cu`` (K1's bf16 forward),
``csrc/bigru_pooled.cu`` and ``csrc/bigru_pooled_bwd.cu``: each variant is
those sources (with ``gru_cell.cuh`` beside them) after a few text
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
one dependent forward step (the slope from T=5 to T=105 at B=8), and the
backward kernel alone at B=128 (the lesser of two rounds of CUDA events)
with its largest error against ``bigru_pooled_bwd_plain`` on the same
saved state, relative to the plain gradient's largest magnitude.
"""

from __future__ import annotations

import argparse
import ctypes
import re
import shutil
import subprocess
import sys
from pathlib import Path

import torch

from ..ops import _build, gru

OUT = _build.BUILD_DIR.parent / "gru_variants"
_MMA = "                mma_bf16(acc[mt][j], a_{}, bw[i][j]);\n"
VARIANTS = {  # name: [(text, replacement), ...]
    "as committed": [],
    "backward 2 threads a unit": [("constexpr int kBwdParts = 4;",
                                   "constexpr int kBwdParts = 2;")],
    "forward in 32-row groups": [("const int options[2] = {32, 16};",
                                  "const int options[2] = {32, 32};")],
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


def _start_build(name: str, csrc: Path, edits) -> tuple:
    folder = OUT / name.replace(" ", "_")
    folder.mkdir(parents=True, exist_ok=True)
    shutil.copy(csrc / "gru_cell.cuh", folder / "gru_cell.cuh")
    texts = {src.name: src.read_text() for src in sorted(
        csrc.glob("bigru_*.cu"))}
    for old, new in edits:
        hits = [key for key, text in texts.items() if old in text]
        if not hits:
            raise ValueError(f"variant {name!r}: {old!r} is not in the source")
        texts[hits[0]] = texts[hits[0]].replace(old, new)
    for key, text in texts.items():
        (folder / key).write_text(text)
    lib = folder / "lib.so"
    cmd = [_build.find_nvcc(), *_build.NVCC_FLAGS, "-shared", "-o", str(lib),
           *(str(folder / key) for key in texts)]
    return lib, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                 stderr=subprocess.STDOUT, text=True)


def _load(path: Path) -> ctypes.CDLL:
    lib = ctypes.CDLL(str(path))
    for name in ("bigru_pooled_fwd", "bigru_pooled_fwd_train",
                 "bigru_pooled_bwd", "bigru_pooled_fwd_streamed"):
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
    if hasattr(lib, "bigru_pooled_bwd"):
        args = _inputs(128, 105, seed=4)
        _, *saved = gru.bigru_pooled_fwd_train_plain(*args)
        g = torch.randn(128, 1024, device="cuda").bfloat16()
        wt = [w.t().contiguous() for w in args[2:4]]
        dxf, dxb = (torch.empty_like(args[0]) for _ in range(2))
        dhg = torch.empty(2, 128, 105, 1536, device="cuda")

        def bwd():
            return lib.bigru_pooled_bwd(
                ptr(g), *map(ptr, wt), ptr(args[4]), *map(ptr, saved),
                ptr(dxf), ptr(dxb), ptr(dhg), 128, 105, 512, 1, stream)

        code = bwd()
        torch.cuda.synchronize()
        want = gru.bigru_pooled_bwd_plain(g, args[2], args[3], args[4],
                                          *saved)
        hp = saved[0]
        dw = torch.bmm(hp.view(2, -1, 512).transpose(1, 2),
                       dhg.view(2, -1, 1536))
        got = (dxf, dxb, dw[0].bfloat16(), dw[1].bfloat16())
        err = max(((a.float() - b.float()).abs().max()
                   / b.float().abs().max()).item()
                  for a, b in zip(got, want))
        line.append(f"backward kernel B=128 {min(_ms(bwd), _ms(bwd)):.4f} ms "
                    f"(error {err:.1e}, launch code {code})")
    print(", ".join(line), flush=True)


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
                r"(bigru_\w*?kernel)(I13__nv_bfloat16|ILi\dELb\d)", block)
            used = re.search(r"Used (\d+) registers", block)
            if kernel and used:
                print(f"{name}: {kernel.group(1)} bf16: {used.group(1)} "
                      "registers")
        libs[name] = _load(path)
    for round_ in range(2):  # every variant twice, in turns
        for name, lib in libs.items():
            _time(f"round {round_ + 1} {name}", lib)
    return 0


if __name__ == "__main__":
    sys.exit(main())
