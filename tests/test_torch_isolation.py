"""The port stands on torch alone, and nothing in it hides a missing card or
a missing kernel behind a CPU fallback."""

import logging
import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


@pytest.fixture(scope="module", autouse=True)
def person_search_logger():
    """The port's entry points call ``setup_logger("PersonSearch")``, which
    turns the process-wide logger's ``propagate`` off and adds handlers:
    after this file the logger is put back as it was, so that a later file
    in the same process (``caplog`` in ``tests/test_checkpoint_align.py``)
    still sees its records.  Files that call an entry point import this
    fixture."""
    logger = logging.getLogger("PersonSearch")
    saved = logger.propagate, logger.level, list(logger.handlers)
    yield
    for handler in logger.handlers:
        if handler not in saved[2]:
            handler.close()
    logger.handlers[:] = saved[2]
    logger.propagate = saved[0]
    logger.setLevel(saved[1])


def test_port_never_imports_jax():
    """Neither JAX nor anything of the JAX package ``textreid_tpu`` is
    loaded after importing every module of the port and ``chip_smoke``."""
    code = (
        "import pkgutil, importlib, sys\n"
        "import textreid_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    textreid_torch.__path__, 'textreid_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "assert len(names) >= 66, names\n"
        "for name in ('train_net', 'test_net', 'server', 'engine.steps',\n"
        "             'engine.trainer', 'engine.inference', 'solver.build',\n"
        "             'models.vit', 'ops.attention', 'ops.quant',\n"
        "             'ops.requant', 'ops.int8_mm', 'models.int8_vit',\n"
        "             'models.int8_text', 'models.text_transformer',\n"
        "             'evaluation.metrics', 'config.defaults', 'config.node',\n"
        "             'data.loader', 'data.datasets', 'engine.grad_cache',\n"
        "             'models.resnet', 'models.int8_tower',\n"
        "             'models.quant_tower', 'ops.int8_conv',\n"
        "             'utils.profiling', 'parallel', 'parallel.mesh',\n"
        "             'evaluation.retrieval', 'quickstart',\n"
        "             'tools.export_torch', 'tools.parity_eval',\n"
        "             'tools.profile_step', 'tools.bench_loader',\n"
        "             'tools.convert_icfg', 'tools.int8_ffn_ab'):\n"
        "    assert 'textreid_torch.' + name in names, name\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m == 'textreid_tpu' or m.startswith(\n"
        "             ('jax.', 'flax', 'optax', 'orbax', 'textreid_tpu.')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 66


def test_no_source_line_imports_the_jax_package():
    """The same, read off the sources: no import statement names
    ``textreid_tpu`` or ``jax`` (mentions in docstrings are fine)."""
    import re

    pattern = re.compile(
        r"^\s*(from|import)\s+(textreid_tpu|jax|flax|optax|orbax)\b")
    files = [os.path.join(REPO, "chip_smoke.py")]
    for folder, _, names in os.walk(os.path.join(REPO, "textreid_torch")):
        files += [os.path.join(folder, n) for n in names if n.endswith(".py")]
    assert len(files) >= 60
    hits = []
    for path in files:
        with open(path) as f:
            hits += [f"{path}:{i}" for i, line in enumerate(f, 1)
                     if pattern.match(line)]
    assert not hits, hits


def _no_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present; this checks the card-less case")


def test_require_cuda_raises_without_a_card():
    _no_card()
    from textreid_torch.utils.platform import require_cuda

    with pytest.raises(RuntimeError, match="cuda"):
        require_cuda("cuda")
    assert require_cuda("cpu") == torch.device("cpu")


def test_tools_raise_without_a_card(tmp_path):
    _no_card()
    from textreid_torch.tools import build_index, serve

    cfg = tmp_path / "cfg.yaml"
    cfg.write_text("MODEL:\n  VISUAL_MODEL: m_resnet50\n"
                   "  TEXTUAL_MODEL: bigru\n")
    with pytest.raises(RuntimeError, match="is_available"):
        build_index.main(["--config-file", str(cfg), "--checkpoint-file",
                          "x.pth", "--output", str(tmp_path / "g.idx")])
    with pytest.raises(RuntimeError, match="is_available"):
        serve.build_server(["--config-file", str(cfg), "--checkpoint-file",
                            "x.pth", "--index-file", "g.idx"])
    with pytest.raises(RuntimeError, match="is_available"):
        build_index.main(["--config-file", str(cfg), "--checkpoint-file",
                          "x.pth", "--output", str(tmp_path / "g.idx"),
                          "--quantize"])
    with pytest.raises(RuntimeError, match="is_available"):
        serve.build_server(["--config-file", str(cfg), "--checkpoint-file",
                            "x.pth", "--index-file", "g.idx", "--quantize"])


def test_kernel_paths_refuse_what_they_cannot_launch():
    """The CUDA-side entry points check their inputs and raise; they never
    hand a tensor to the plain version."""
    from textreid_torch.ops import attention, gru, ranking

    x = torch.zeros(2, 3, 96)
    w = torch.zeros(32, 96)
    lens = torch.ones(2, dtype=torch.int32)
    with pytest.raises(ValueError, match="must be on"):
        gru._bigru_pooled_cuda(x, x, w, w, lens)
    q = torch.zeros(3, 8)
    with pytest.raises(ValueError, match="must be on"):
        ranking._topk_cuda(q, q, 2, 0)
    with pytest.raises(ValueError, match="k <= 64"):
        ranking._topk_cuda(q, q, 65, 0)
    h0 = torch.zeros(2, 32)
    with pytest.raises(ValueError, match="must be on"):
        gru._gru_scan_cuda(x, w, h0, False)
    with pytest.raises(ValueError, match="must be on"):
        gru._GruScan.apply(x, w, h0, False)
    values = torch.zeros(3, 16, dtype=torch.int8)
    q16, scales = torch.zeros(3, 16), torch.ones(3)
    with pytest.raises(ValueError, match="must be on"):
        ranking._topk_quantized_cuda(q16, values, scales, 2, 0)
    with pytest.raises(ValueError, match="k <= 64"):
        ranking._topk_quantized_cuda(q16, values, scales, 65, 0)
    qkv = torch.zeros(2, 5, 3 * 128)
    with pytest.raises(ValueError, match="must be on"):
        attention._fused_attention_cuda(qkv, 2, False, None)
    with pytest.raises(ValueError, match="must be on"):
        attention._fused_attention_bwd_cuda(qkv, qkv[..., :128].contiguous(),
                                            2, False, None)
    with pytest.raises(ValueError, match="S <= 288"):
        attention._fused_attention_cuda(torch.zeros(1, 289, 3 * 64), 1,
                                        False, None)


def test_missing_nvcc_is_an_error(monkeypatch):
    from textreid_torch.ops import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "")
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()


def test_build_hash_covers_the_shared_headers(tmp_path, monkeypatch):
    """An edited ``.cuh`` must give another library name, or a stale
    ``.so`` would be loaded."""
    import shutil

    from textreid_torch.ops import _build

    assert (_build.CSRC / "gru_cell.cuh").exists()
    copy = tmp_path / "csrc"
    shutil.copytree(_build.CSRC, copy)
    monkeypatch.setattr(_build, "CSRC", copy)
    before = _build.source_hash()
    assert before == _build.source_hash()
    for header in ("gru_cell.cuh", "gru_resident.cuh"):
        with open(copy / header, "a") as f:
            f.write("// edited\n")
        assert _build.source_hash() != before
        before = _build.source_hash()
    assert sorted(p.name for p in _build._sources()) == [
        "batch_norm.cu", "bigru_pooled.cu", "bigru_pooled_bwd.cu", "bigru_resident.cu",
        "bigru_resident_bwd.cu", "fused_attention.cu", "gru_scan.cu", "gru_scan_resident.cu",
        "int8_conv.cu", "int8_mm.cu", "int8_mm_sm90.cu", "requant.cu",
        "topk_similarity.cu", "topk_tile8.cu"]
