"""The port's command-line tools on the CPU: the ICFG-PEDES converter byte
for byte against the repository's ``tools/convert_icfg.py``, the parity
gate against ``test_net``'s numbers, ``profile_step --summarize-only`` on a
trace ``torch.profiler`` writes here, the loader bench on a tiny split, and
every new entry point's refusal at its default ``--device cuda`` without a
card."""

import json
import logging
import os
import shutil
import sys

import numpy as np
import pytest
import torch

from tests.test_torch_isolation import person_search_logger  # noqa: F401
from textreid_torch import quickstart, test_net
from textreid_torch.config import get_default_cfg
from textreid_torch.data import make_synthetic_dataset
from textreid_torch.evaluation.metrics import evaluation
from textreid_torch.models import build_model
from textreid_torch.tools import (
    bench_loader,
    convert_icfg,
    export_torch,
    int8_ffn_ab,
    parity_eval,
    profile_step,
)
from textreid_torch.utils.profiling import bound_ms, k1_backward_work
from textreid_torch.utils.weight_convert import save_reference_checkpoint

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
sys.path.insert(0, REPO)

from tests.test_icfg import make_release  # noqa: E402
from tools import convert_icfg as repo_convert_icfg  # noqa: E402

torch.set_num_threads(2)


# -- tools/convert_icfg.py --------------------------------------------------

ICFG_CASES = {"flat": dict(layout="flat"),
              "by_split": dict(layout="by_split"),
              "captions_only": dict(with_processed_tokens=False),
              "min_count_max_length": dict(layout="flat")}


@pytest.mark.parametrize("case", sorted(ICFG_CASES))
def test_icfg_converter_writes_the_same_bytes(tmp_path, case, capsys):
    release = str(tmp_path / "ICFG-PEDES.json")
    make_release(release, num_ids=7, **ICFG_CASES[case])
    flags = (["--min-count", "3", "--max-length", "4"]
             if case == "min_count_max_length" else [])
    outputs = []
    for tool, name in ((repo_convert_icfg, "jax"), (convert_icfg, "port")):
        capsys.readouterr()
        assert tool.main([release, str(tmp_path / name)] + flags) == 0
        outputs.append(capsys.readouterr().out)
    assert outputs[0] == outputs[1]
    names = sorted(os.listdir(tmp_path / "jax" / "annotations"))
    assert names == sorted(os.listdir(tmp_path / "port" / "annotations"))
    assert {"train.json", "test.json", "vocab.json"} <= set(names)
    for name in names:
        assert ((tmp_path / "port" / "annotations" / name).read_bytes()
                == (tmp_path / "jax" / "annotations" / name).read_bytes())


# -- tools/parity_eval.py ---------------------------------------------------

TINY = """
MODEL:
  VISUAL_MODEL: "resnet18"
  TEXTUAL_MODEL: "bigru"
  NUM_CLASSES: 8
  GRU: {VOCABULARY_SIZE: 16, EMBEDDING_SIZE: 16, NUM_UNITS: 16}
  EMBEDDING: {EMBED_HEAD: "moco", FEATURE_SIZE: 32}
INPUT: {HEIGHT: 32, WIDTH: 16, MAX_TEXT_LENGTH: 12}
DATASETS:
  TEST: ("cuhkpedes_test", )
DATALOADER: {NUM_WORKERS: 2}
TEST: {IMS_PER_BATCH: 6}
"""


class GridLog(logging.Handler):
    """The eval grids ``PersonSearch.inference`` logs (the PersonSearch
    logger does not propagate to ``caplog`` once an entry point set it
    up)."""

    def __init__(self):
        super().__init__(logging.INFO)
        self.grids = []

    def emit(self, record):
        if record.getMessage().lstrip().startswith("topk"):
            self.grids.append(record.getMessage())

    def t2i(self):
        lines = [ln.split() for ln in self.grids[-1].strip().splitlines()]
        return [float(ln[1]) for ln in lines[1:]]


@pytest.fixture(scope="module")
def eval_workspace(tmp_path_factory):
    """(root, config path, checkpoint path): a synthetic test split, a
    tiny yaml and a seeded reference ``.pth``."""
    root = tmp_path_factory.mktemp("parity")
    make_synthetic_dataset(str(root / "datasets" / "cuhkpedes"),
                           num_identities=8, images_per_id=2,
                           image_size=(32, 16), vocab_size=16, max_tokens=10,
                           split="test", seed=1)
    (root / "configs" / "tiny").mkdir(parents=True)
    cfg_path = root / "configs" / "tiny" / "eval.yaml"
    cfg_path.write_text(TINY)
    cfg = get_default_cfg()
    cfg.merge_from_file(str(cfg_path))
    cfg.freeze()
    ckpt = str(root / "model.pth")
    save_reference_checkpoint(build_model(cfg, "cpu"), ckpt)
    return root, str(cfg_path), ckpt


def test_parity_gate_against_test_net(eval_workspace, tmp_path):
    """rc 0 at ``test_net``'s numbers, rc 1 twice the budget off them, and
    the npz it writes replayed by ``test_net --load-result`` to the same
    grid."""
    root, cfg_path, ckpt = eval_workspace
    common = ["--root", str(root), "--config-file", cfg_path,
              "--checkpoint-file", ckpt, "--device", "cpu"]
    log = GridLog()
    logging.getLogger("PersonSearch.inference").addHandler(log)
    try:
        test_net.main(common)
        want = log.t2i()
        expected = ",".join(f"{v:.2f}" for v in want)
        results = parity_eval.main(common + [
            "--expected", expected, "--output-folder", str(tmp_path)])
        got = parity_eval.t2i_row(results)
        np.testing.assert_allclose(got, want, atol=0.005)
        moved = ",".join(f"{v + 0.4:.2f}" for v in want)
        with pytest.raises(SystemExit) as exc:
            parity_eval.main(common + ["--expected", moved, "--budget",
                                       "0.2"])
        assert exc.value.code == 1
        # the npz in test_net's cache folder, replayed without encoding
        cache = os.path.join(str(root), "output", "tiny", "eval",
                             "inference", "cuhkpedes_test")
        os.makedirs(cache, exist_ok=True)
        shutil.copy(tmp_path / "inference_data.npz", cache)
        top1 = test_net.main(common + ["--load-result"])
        assert top1["cuhkpedes_test"] == pytest.approx(got[0], abs=1e-6)
        assert log.t2i() == want
    finally:
        logging.getLogger("PersonSearch.inference").removeHandler(log)
    with np.load(tmp_path / "inference_data.npz") as data:
        assert {"v_embed", "t_embed", "pids", "image_ids", "similarity",
                "image_pid", "text_pid"} <= set(data.files)
        again = evaluation(data["v_embed"], data["t_embed"], data["pids"],
                           data["pids"], data["image_ids"], rerank=True)
    assert parity_eval.t2i_row(again) == pytest.approx(got, abs=1e-9)


def test_parity_gate_rejects_a_malformed_expectation(eval_workspace):
    root, cfg_path, ckpt = eval_workspace
    with pytest.raises(ValueError, match="takes 4 numbers"):
        parity_eval.main(["--root", str(root), "--config-file", cfg_path,
                          "--checkpoint-file", ckpt, "--device", "cpu",
                          "--expected", "1,2,3"])


# -- tools/profile_step.py --------------------------------------------------

def _cpu_work():
    x = torch.randn(2, 3, 16, 16, requires_grad=True)
    w = torch.randn(4, 3, 3, 3, requires_grad=True)
    a = torch.randn(8, 6, requires_grad=True)
    b = torch.randn(6, 5)

    def fn():
        y = (torch.nn.functional.conv2d(x, w, padding=1, stride=2).sum()
             + (a @ b).sum() + torch.bmm(a[None], b[None]).sum())
        y.backward()
    return fn


def test_profile_step_summarizes_a_cpu_trace(tmp_path):
    """The trace of two calls: the counted operations a step equal what
    ``torch.profiler(with_flops=True)`` reports for the products and the
    forward convolution (plus the convolution's two backward products);
    no device time, so no share."""
    from torch.profiler import ProfilerActivity, profile

    fn = _cpu_work()
    out = str(tmp_path / "trace")
    profile_step.capture(fn, 2, out, {"device": "cpu"})
    with profile(activities=[ProfilerActivity.CPU], with_flops=True) as prof:
        fn()
    flops = {}
    for evt in prof.events():
        if evt.flops:
            flops[evt.name] = flops.get(evt.name, 0) + evt.flops
    js = str(tmp_path / "breakdown.json")
    got = profile_step.main(["--summarize-only", "--out", out,
                             "--json-out", js])
    assert json.load(open(js)) == json.loads(json.dumps(got))
    assert got["steps"] == 2 and got["ms_per_step"] == 0.0
    assert got["device"] == "cpu" and got["peaks"] is None
    ops = got["counted_ops"]
    assert ops["matrix products"]["float32"] == (
        flops["aten::mm"] + flops["aten::bmm"])
    assert ops["convolutions"]["float32"] == 3 * flops["aten::conv2d"]
    assert all(v["share"] is None for v in got["roofline"].values())


def test_profile_step_classifies_kernels_as_chip_smoke_does(tmp_path):
    """Kernel events (as a card's trace holds them) go to
    ``STEP_FAMILIES`` by name, but for those launched inside a counted
    call, which go to its family whatever their name (cuDNN's 1x1
    convolutions run in GEMM-named kernels); shares appear for a card in
    the peak table, K1's backward priced without dW's product."""
    out = str(tmp_path / "trace")
    profile_step.capture(_cpu_work(), 2, out, {
        "device": "NVIDIA H100 80GB HBM3", "variant": "", "batch": 4,
        "tokens": 8, "hidden": 32, "valid_steps": 20,
        "text_tower": "bigru"})
    with open(os.path.join(out, "trace.json")) as f:
        trace = json.load(f)
    kernels = [("void bigru_resident_fwd_train<32>", 40.0),
               ("void bigru_resident_bwd_kernel<32>", 30.0),
               ("void bigru_pooled_fwd_kernel", 10.0),
               ("sm90_xmma_gemm_bf16bf16_bf16f32", 100.0),
               ("cudnn_infer_ampere_scudnn_128x64_relu_xregs_large_nn_v1"
                "_fprop", 200.0),
               ("nvjet_tst_256x128_64x4_1x2_h_ssched_bz_coopA_TNT", 20.0),
               ("void cudnn::bn_fw_tr_1C11_kernel_NCHW", 50.0),
               ("void at::native::vectorized_elementwise_kernel", 5.0),
               ("void at::native::vectorized_elementwise_kernel", 7.0)]
    # the product kernel launched inside the first aten::mm call, the
    # convolution's and a GEMM-named one inside the first aten::convolution
    # (correlation ids)
    first = {}
    for e in trace["traceEvents"]:
        if e.get("name") in ("aten::mm", "aten::convolution"):
            first.setdefault(e["name"], e)
    inside = {3: first["aten::mm"], 4: first["aten::convolution"],
              5: first["aten::convolution"]}
    for i, (name, us) in enumerate(kernels):
        trace["traceEvents"].append({"ph": "X", "cat": "kernel", "name": name,
                                     "dur": us, "ts": 0, "pid": 0, "tid": 7,
                                     "args": {"correlation": 100 + i}})
        if i in inside:
            call = inside[i]
            trace["traceEvents"].append({
                "ph": "X", "cat": "cuda_runtime", "name": "cudaLaunchKernel",
                "ts": call["ts"] + call["dur"] / 2, "dur": 1.0,
                "pid": call["pid"], "tid": call["tid"],
                "args": {"correlation": 100 + i}})
    trace["traceEvents"].append({"ph": "X", "cat": "gpu_memcpy",
                                 "name": "Memcpy HtoD (Pageable -> Device)",
                                 "dur": 3.0, "ts": 0, "pid": 0, "tid": 7})
    with open(os.path.join(out, "trace.json"), "w") as f:
        json.dump(trace, f)
    got = profile_step.summarize(out)  # two steps: ms and calls a step
    fam = got["by_family_ms"]
    assert fam["K1 fwd"] == pytest.approx(0.025)
    assert fam["K1 bwd"] == pytest.approx(0.015)
    assert fam["matrix products"] == pytest.approx(0.050)
    assert fam["convolutions"] == pytest.approx(0.110)
    assert fam["BN"] == pytest.approx(0.025)
    assert fam["other"] == pytest.approx(0.0075)
    assert got["ms_per_step"] == pytest.approx(0.2325)
    assert got["launches_per_step"] == 4.5
    assert [k["name"] for k in got["top_kernels"][:2]] == [
        kernels[4][0], kernels[3][0]]
    assert got["top_kernels"][-1]["calls"] == 0.5
    elementwise = [k for k in got["top_kernels"]
                   if "elementwise" in k["name"]]
    assert elementwise[0]["calls"] == 1
    measured = {"matrix products": 0.050, "convolutions": 0.110,
                "K1 fwd": fam["K1 fwd"], "K1 bwd": fam["K1 bwd"]}
    for what, ms in measured.items():
        roof = got["roofline"][what]
        assert roof["measured_ms"] == pytest.approx(ms)
        assert roof["bound_ms"] > 0 and roof["share"] == pytest.approx(
            roof["bound_ms"] / ms)
    # the calls' bound: a step's counted operations at the f32 peak
    f32 = got["peaks"]["ops_s"]["float32"]
    for family in ("matrix products", "convolutions"):
        assert got["roofline"][family]["bound_ms"] == pytest.approx(
            got["counted_ops"][family]["float32"] / f32 * 1e3)
    assert got["roofline"]["K5"]["share"] is None
    # K1's backward: the kernel's bytes (it writes dhg), none of dW's f32
    # operations
    kernel_bytes, kernel_ops = k1_backward_work(4, 8, 32, 20, dw=False)
    assert set(kernel_ops) == {"bfloat16"}
    assert got["roofline"]["K1 bwd"]["bound_ms"] == pytest.approx(
        bound_ms(kernel_bytes, kernel_ops, got["peaks"])[0])


def test_k1_backward_work_with_and_without_dw():
    """The function's work (dW written, its f32 product) against the
    kernel's alone (the f32 ``dhg`` written instead, no f32 operations)."""
    b, t, h, steps = 4, 8, 32, 20
    fn_bytes, fn_ops = k1_backward_work(b, t, h, steps)
    kernel_bytes, kernel_ops = k1_backward_work(b, t, h, steps, dw=False)
    assert fn_ops == {"float32": 2 * steps * 2 * 3 * h * h,
                      "bfloat16": kernel_ops["bfloat16"]}
    assert kernel_bytes - fn_bytes == 4 * 2 * b * t * 3 * h - 2 * 2 * h * 3 * h


# -- tools/bench_loader.py ---------------------------------------------------

def test_bench_loader_on_a_tiny_split(tmp_path):
    out = str(tmp_path / "loader.json")
    got = bench_loader.main(["--ids", "8", "--imgs-per-id", "4", "--batch",
                             "8", "--epochs", "2", "--raw-height", "48",
                             "--raw-width", "16", "--height", "32",
                             "--width", "16", "--num-workers", "2",
                             "--step-ms", "80", "--output", out,
                             "--device", "cpu"])
    assert json.load(open(out)) == got
    rates = [got[k] for k in (
        "ours_steady_imgs_per_s_by_epoch", "ours_imgs_per_s_by_epoch",
        "first_batch_s_by_epoch", "ours_cached_steady_imgs_per_s_by_epoch",
        "ours_cached_imgs_per_s_by_epoch", "cached_first_batch_s_by_epoch")]
    assert [len(r) for r in rates] == [2] * 6
    assert min(min(r) for r in rates) > 0
    # 32 images in PK batches of 8: 4 batches, timed after the first
    assert got["batches_per_epoch"] == 4
    assert got["ours_cold_imgs_per_s"] == got[
        "ours_steady_imgs_per_s_by_epoch"][0]
    assert got["demand_imgs_per_s"] == pytest.approx(1600.0)
    assert got["cold_over_demand"] == pytest.approx(
        got["ours_cold_imgs_per_s"] / 1600.0)
    assert got["n_images"] == 32 and got["device"] == "cpu"


def test_bench_loader_needs_two_batches(tmp_path):
    """The rate is timed after the first batch: one batch an epoch is
    refused."""
    with pytest.raises(ValueError, match="after the first"):
        bench_loader.main(["--ids", "2", "--imgs-per-id", "4", "--batch",
                           "8", "--epochs", "1", "--raw-height", "48",
                           "--raw-width", "16", "--height", "32",
                           "--width", "16", "--num-workers", "1",
                           "--device", "cpu"])


# -- no card: every new entry point refuses its default device --------------

def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")


ENTRY_POINTS = {
    "export_torch": lambda cfg: export_torch.main(
        ["--config-file", cfg, "--checkpoint-file", "x.pth", "--output",
         "y.pth"]),
    "parity_eval": lambda cfg: parity_eval.main(
        ["--config-file", cfg, "--checkpoint-file", "x.pth"]),
    "profile_step": lambda cfg: profile_step.main(["--steps", "1"]),
    "bench_loader": lambda cfg: bench_loader.main(["--ids", "4"]),
    "int8_ffn_ab": lambda cfg: int8_ffn_ab.main([]),
    "quickstart": lambda cfg: quickstart.main([]),
}


@pytest.mark.parametrize("name", sorted(ENTRY_POINTS))
def test_entry_point_raises_without_a_card(name, tmp_path):
    _no_card()
    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("MODEL:\n  VISUAL_MODEL: resnet18\n")
    with pytest.raises(RuntimeError, match="is_available"):
        ENTRY_POINTS[name](str(cfg))
