"""The yardstick, frozen with the benchmark: the card's published peaks,
the roofline bound of a piece of work, the bytes and operations of the
port's own kernels (K1 forward and backward, K5, K6), and the train
step's kernel families.

Copied from ``textreid_torch/utils/profiling.py`` (``DEVICE_PEAKS``,
``bound_ms``, ``k1_forward_work``, ``k1_backward_work``,
``attention_work``, ``STEP_FAMILIES``, ``kernel_family``) so that a change
to the program cannot move what it is measured against;
``benchmark/tests/test_bench_yardstick.py`` holds the copies equal to the
originals at the cells' shapes."""

from __future__ import annotations

from typing import Dict, Optional, Sequence, Tuple

# dense peaks from NVIDIA's H100 SXM data sheet: bytes a second of device
# memory and operations a second by input type (f32 on the FP32 cores:
# TF32 stays off)
DEVICE_PEAKS = {
    "NVIDIA H100 80GB HBM3": {
        "bytes_s": 3.35e12,
        "ops_s": {"bfloat16": 989e12, "float32": 67e12, "int8": 1979e12}},
}

Families = Sequence[Tuple[str, Sequence[str]]]

# K1's backward before its forwards (the W-resident backward's name holds
# "bigru_resident" too); "convolutions" and "matrix products" take the
# kernels their aten calls launched (trace.py)
STEP_FAMILIES: Families = (
    ("K5", ("attention_fwd",)), ("K6", ("attention_bwd",)),
    ("K1 bwd", ("bigru_resident_bwd_kernel",)),
    ("K1 bwd streamed", ("bigru_pooled_bwd_kernel",)),
    ("K1 fwd", ("bigru_pooled", "bigru_resident")),
    ("convolutions", ()),
    ("BN", ("batch_norm", "batchnorm", "bn_fw", "bn_bw")),
    ("matrix products", ()))

PRODUCT_OPS = ("aten::mm", "aten::bmm", "aten::addmm", "aten::baddbmm")
CONV_OPS = ("aten::convolution", "aten::convolution_backward")
CALL_FAMILIES = {**{op: "matrix products" for op in PRODUCT_OPS},
                 **{op: "convolutions" for op in CONV_OPS}}


def kernel_family(name: str, families: Families = STEP_FAMILIES) -> str:
    """The first family one of whose keys ``name`` holds (lower case), else
    "other"; copies and memsets are "other"."""
    name = name.lower()
    if "memcpy" in name or "memset" in name:
        return "other"
    return next((fam for fam, keys in families
                 if any(k in name for k in keys)), "other")


def device_peaks(name: str) -> Optional[dict]:
    return DEVICE_PEAKS.get(name)


def bound_ms(n_bytes: float, n_ops, peaks: dict,
             dtype_name: Optional[str] = None) -> Tuple[float, str]:
    """(bound ms, what binds): the larger of bytes over the memory rate and
    operations over the peak rate; ``n_ops`` may be a {dtype: operations}
    dict, whose times at each rate add up."""
    by_bytes = n_bytes / peaks["bytes_s"] * 1e3
    if not isinstance(n_ops, dict):
        n_ops = {dtype_name: n_ops}
    by_ops = sum(n / peaks["ops_s"][name] for name, n in n_ops.items()) * 1e3
    return (by_bytes, "bytes") if by_bytes >= by_ops else (by_ops,
                                                            "operations")


def k1_forward_work(batch: int, seq: int, hidden: int,
                    train: bool = False, steps: Optional[int] = None
                    ) -> Tuple[int, Dict[str, int]]:
    """(bytes, {dtype: operations}) of K1's bf16 forward over both
    directions; the training forward also writes the f32 state its
    backward reads and the argmax.  ``steps``: the valid (row, step)
    pairs, whose recurrent products are all the function needs (the
    default, every pair of the padded grid, is the original's count)."""
    b, t, h = batch, seq, hidden
    n_bytes = 2 * (2 * b * t * 3 * h + 2 * h * 3 * h + b * 2 * h)
    if train:
        n_bytes += 4 * 2 * b * t * 5 * h + 4 * b * 2 * h
    pairs = b * t if steps is None else steps
    return n_bytes, {"bfloat16": 2 * pairs * 2 * h * 3 * h}


def k1_backward_work(batch: int, seq: int, hidden: int, steps: int,
                     dw: bool = True) -> Tuple[int, Dict[str, int]]:
    """(bytes, {dtype: operations}) of K1's bf16 backward over both
    directions, ``steps`` the valid (row, step) pairs; ``dw=False``: the
    kernel alone, which writes the f32 ``dhg`` that dW's product reads."""
    b, t, h = batch, seq, hidden
    n_bytes = (2 * b * 2 * h + 2 * 2 * 3 * h * h + 4 * b
               + 4 * 2 * b * t * 5 * h + 4 * b * 2 * h
               + 2 * 2 * b * t * 3 * h)
    serial = {"bfloat16": 2 * 2 * steps * 2 * 3 * h * h}
    if not dw:
        return n_bytes + 4 * 2 * b * t * 3 * h, serial
    return n_bytes + 2 * 2 * h * 3 * h, {
        "float32": 2 * steps * 2 * 3 * h * h, **serial}


def attention_work(batch: int, seq: int, width: int, heads: int,
                   backward: bool = False) -> Tuple[int, int]:
    """(bytes, operations) of K5 (``backward``: K6) in bf16."""
    matmul = 2 * batch * heads * seq * seq * (width // heads)
    if backward:
        return 2 * batch * seq * 7 * width, 5 * matmul
    return 2 * batch * seq * 4 * width, 2 * matmul
