"""Build and load the port's hand-written CUDA kernels.

Every ``csrc/*.cu`` file is compiled by its own ``nvcc``, all started
together (shared device code is in ``csrc/*.cuh`` headers), and the objects are linked into ONE shared library with a plain
C interface, loaded with ``ctypes``.  No PyTorch header is included, so a
build takes seconds.  The library lands in
``build/textreid_torch/`` beside the package and is keyed on a hash of the
sources and flags, so a fresh checkout builds at first use and an edited
source rebuilds.  Nothing here runs at import time: the CPU tests import
every module without ``nvcc`` or a card.
"""

from __future__ import annotations

import ctypes
import functools
import hashlib
import os
import shutil
import subprocess
import tempfile
from pathlib import Path

CSRC = Path(__file__).resolve().parent.parent / "csrc"
BUILD_DIR = Path(__file__).resolve().parents[2] / "build" / "textreid_torch"
# -Xptxas -v: registers, shared memory and spills per kernel, kept in the
# build log that chip_smoke.py prints
NVCC_FLAGS = ("-gencode", "arch=compute_90a,code=sm_90a", "-std=c++17", "-O3",
              "-Xcompiler", "-fPIC", "-Xptxas", "-v")

_P = ctypes.c_void_p
_I = ctypes.c_int
_F = ctypes.c_float
# C signature of each kernel entry point: (argtypes); every one returns the
# cudaError_t of its launch as an int
SIGNATURES = {
    # xf, xb, w_f, w_b, lengths, out, B, T, H, is_bf16, stream
    "bigru_pooled_fwd": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _P),
    # xf, xb, w_f, w_b, lengths, out, hp, gates, argmax, B, T, H, is_bf16,
    # stream
    "bigru_pooled_fwd_train": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I,
                               _I, _I, _P),
    # the streamed kernel behind the first for f32 (its bf16 is kept for
    # comparison, off the main path): the same arguments
    "bigru_pooled_fwd_streamed": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                                  _P),
    # g, wt_f, wt_b, lengths, hp, gates, argmax, dxf, dxb, dhg, B, T, H,
    # is_bf16, stream
    "bigru_pooled_bwd": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I,
                         _I, _P),
    # q, g, vals, idx, part_vals, part_idx, Q, G, D, k, valid_gallery,
    # splits, round_bf16, stream
    "topk_similarity_f32": (_P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I, _I,
                            _I, _P),
    # x, w, h0, out, B, T, H, reverse, is_bf16, stream
    "gru_scan_fwd": (_P, _P, _P, _P, _I, _I, _I, _I, _I, _P),
    # q, g_int8, scales, vals, idx, part_vals, part_idx, Q, G, D, k,
    # valid_gallery, splits, stream
    "topk_similarity_int8": (_P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                             _I, _P),
    # qkv, out, B, S, W, heads, scale, causal, is_bf16, stream
    "fused_attention_fwd": (_P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    # qkv, g, dqkv, stats (f32 only, else null), B, S, W, heads, scale,
    # causal, is_bf16, stream
    "fused_attention_bwd": (_P, _P, _P, _P, _I, _I, _I, _I, _F, _I, _I, _P),
    # x, s, q, r, rows, C, op, eps, is_bf16, stream
    "fused_requant": (_P, _P, _P, _P, _I, _I, _I, _F, _I, _P),
    # xq, w_t, s_w, b, r_row, s_next, q, r, rows, K, N, gelu, stream
    "int8_matmul_requant": (_P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I,
                            _P),
    # xq, w1_t, s_w1, b1, r_row, s_mid, w2_t, s_w2, b2, out, rows, K, N, M,
    # out_bf16, stream
    "int8_ffn": (_P, _P, _P, _P, _P, _P, _P, _P, _P, _P, _I, _I, _I, _I, _I,
                 _P),
}


def find_nvcc() -> str:
    """``nvcc`` from PATH, then ``$CUDA_HOME/bin``, then the toolkit torch
    itself located."""
    found = shutil.which("nvcc")
    if found:
        return found
    homes = [os.environ.get("CUDA_HOME", "")]
    from torch.utils.cpp_extension import CUDA_HOME

    homes.append(CUDA_HOME or "")
    for home in homes:
        cand = os.path.join(home, "bin", "nvcc") if home else ""
        if cand and os.path.exists(cand):
            return cand
    raise RuntimeError(
        "nvcc not found (PATH, $CUDA_HOME/bin): the CUDA kernels of "
        "textreid_torch cannot be built")


def _sources():
    return sorted(CSRC.glob("*.cu"))


def source_hash() -> str:
    """Hash of the flags, the sources and the headers they include: an
    edited ``.cuh`` must not reuse a stale library."""
    h = hashlib.sha256(" ".join(NVCC_FLAGS).encode())
    for src in sorted(CSRC.glob("*.cu*")):
        h.update(src.name.encode())
        h.update(src.read_bytes())
    return h.hexdigest()[:16]


def _run(cmds: list) -> str:
    """Run the commands at once; their output, or raise with the first
    failure's stderr."""
    procs = [(cmd, subprocess.Popen(cmd, stdout=subprocess.PIPE,
                                    stderr=subprocess.PIPE, text=True))
             for cmd in cmds]
    logs, failed = [], None
    for cmd, proc in procs:
        out, err = proc.communicate()
        logs.append(out + err)
        if proc.returncode != 0 and failed is None:
            failed = (cmd, proc.returncode, err)
    if failed:
        cmd, code, err = failed
        raise RuntimeError(f"nvcc failed ({code}): {' '.join(cmd)}\n{err}")
    return "".join(logs)


def build() -> tuple[Path, str]:
    """Compile the library unless this source hash is already built.
    Returns ``(path, nvcc output)``; raises with nvcc's stderr on failure."""
    lib_path = BUILD_DIR / f"libtextreid_kernels_{source_hash()}.so"
    log_path = lib_path.with_suffix(".log")
    if lib_path.exists():
        return lib_path, log_path.read_text() if log_path.exists() else ""
    BUILD_DIR.mkdir(parents=True, exist_ok=True)
    nvcc = find_nvcc()
    with tempfile.TemporaryDirectory(dir=BUILD_DIR) as tmp:
        objs = [str(Path(tmp) / f"{src.stem}.o") for src in _sources()]
        log = _run([[nvcc, *NVCC_FLAGS, "-c", "-o", obj, str(src)]
                    for src, obj in zip(_sources(), objs)])
        tmp_lib = str(Path(tmp) / "lib.so")
        log += _run([[nvcc, "-shared", "-o", tmp_lib, *objs]])
        log_path.write_text(log)
        os.replace(tmp_lib, lib_path)  # atomic: a concurrent build never
        # sees half a library
    return lib_path, log


@functools.cache
def library() -> ctypes.CDLL:
    """The loaded kernel library, built on first call."""
    path, _ = build()
    lib = ctypes.CDLL(str(path))
    for name, argtypes in SIGNATURES.items():
        fn = getattr(lib, name)
        fn.argtypes = list(argtypes)
        fn.restype = ctypes.c_int
    # B, H, is_bf16, out: clusters of bigru_pooled_bwd the card holds at once
    lib.bigru_pooled_bwd_clusters.argtypes = [_I, _I, _I,
                                              ctypes.POINTER(_I)]
    lib.bigru_pooled_bwd_clusters.restype = ctypes.c_int
    # B, H, out: rows a cluster and clusters of K1's bf16 forward, and the
    # clusters of 32 and of 16 rows the card holds at once
    lib.bigru_resident_plan.argtypes = [_I, _I] + [ctypes.POINTER(_I)] * 4
    lib.bigru_resident_plan.restype = ctypes.c_int
    lib.textreid_error_string.argtypes = [ctypes.c_int]
    lib.textreid_error_string.restype = ctypes.c_char_p
    return lib


def check(err: int, name: str) -> None:
    """Raise on a non-zero cudaError_t returned by a launch."""
    if err != 0:
        text = library().textreid_error_string(err).decode()
        raise RuntimeError(
            f"CUDA kernel {name} failed to launch: cudaError_t {err} ({text})")
