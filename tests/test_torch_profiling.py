"""``textreid_torch/utils/profiling.py`` on the CPU: ``nan_check`` over a
module, a tensor and nested dicts; ``live_memory`` and ``profile_trace``
without a card (its spans: ``tests/test_torch_tracing.py``).
``device_time_by_family`` reads a trace of the card and runs on it
(``chip_smoke.py``'s profiles)."""

import json
import math

import pytest
import torch

from textreid_torch.utils import profiling


def test_nan_check_names_the_non_finite_tensors():
    layer = torch.nn.Linear(3, 2)
    profiling.nan_check(layer, "a finite layer")
    profiling.nan_check({"a": torch.ones(2), "b": [torch.zeros(1),
                                                  torch.arange(3)]})
    with torch.no_grad():
        layer.bias[1] = math.nan
    with pytest.raises(FloatingPointError, match=r"in the layer: \['bias'\]"):
        profiling.nan_check(layer, "the layer")
    tree = {"loss": torch.tensor(1.0), "grads": {"w": torch.tensor(
        [0.0, math.inf])}, "ids": torch.tensor([1, 2])}
    with pytest.raises(FloatingPointError, match=r"\['grads.w'\]"):
        profiling.nan_check(tree)


def test_live_memory_and_trace_without_a_card(tmp_path):
    if torch.cuda.is_available():
        pytest.skip("this machine has a card: the CPU-only contract")
    assert profiling.live_memory() == {}
    with profiling.profile_trace(str(tmp_path / "trace")):
        torch.ones(64, 64) @ torch.ones(64, 64)
    trace = json.loads((tmp_path / "trace" / "trace.json").read_text())
    assert any("mm" in e.get("name", "") for e in trace["traceEvents"])
