"""The port stands on torch alone, and nothing in it hides a missing card or
a missing kernel behind a CPU fallback."""

import os
import subprocess
import sys

import pytest
import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def test_port_never_imports_jax():
    code = (
        "import pkgutil, importlib, sys\n"
        "import textreid_torch\n"
        "names = [m.name for m in pkgutil.walk_packages(\n"
        "    textreid_torch.__path__, 'textreid_torch.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "assert len(names) >= 15, names\n"
        "bad = sorted(m for m in sys.modules if m == 'jax' or\n"
        "             m.startswith(('jax.', 'flax', 'optax', 'orbax')))\n"
        "assert not bad, bad\n"
        "print(len(names))\n")
    env = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
    env["PYTHONPATH"] = REPO
    out = subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                         capture_output=True, text=True, timeout=120)
    assert out.returncode == 0, out.stderr
    assert int(out.stdout.strip()) >= 15


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


def test_kernel_paths_refuse_what_they_cannot_launch():
    """The CUDA-side entry points check their inputs and raise; they never
    hand a tensor to the plain version."""
    from textreid_torch.ops import gru, ranking

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


def test_missing_nvcc_is_an_error(monkeypatch):
    from textreid_torch.ops import _build

    monkeypatch.setenv("PATH", "")
    monkeypatch.setenv("CUDA_HOME", "")
    import torch.utils.cpp_extension as cpp

    monkeypatch.setattr(cpp, "CUDA_HOME", None)
    with pytest.raises(RuntimeError, match="nvcc not found"):
        _build.find_nvcc()
