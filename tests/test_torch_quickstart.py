"""``python -m textreid_torch.quickstart`` on the CPU: the walk of the
repository's ``examples/quickstart.py`` (train with validation and
checkpoints, evaluate with re-ranking, search an index, answer one HTTP
``/search``), on the same config key for key."""

import importlib.util
import os

import pytest
import torch

from tests.test_torch_isolation import person_search_logger  # noqa: F401
from textreid_torch import quickstart

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))

torch.set_num_threads(2)


class _Built(Exception):
    """Raised by the stand-in ``build_model``, carrying the config."""


def _example_cfg(monkeypatch):
    """The config ``examples/quickstart.py`` builds, taken where it hands
    it to ``build_model`` (nothing before that is run: no dataset, no
    logger)."""
    import textreid_tpu.data
    import textreid_tpu.models
    import textreid_tpu.utils

    def build_model(cfg, **kwargs):
        raise _Built(cfg)

    monkeypatch.setattr(textreid_tpu.data, "make_synthetic_dataset",
                        lambda *a, **k: None)
    monkeypatch.setattr(textreid_tpu.utils, "setup_logger",
                        lambda *a, **k: None)
    monkeypatch.setattr(textreid_tpu.models, "build_model", build_model)
    spec = importlib.util.spec_from_file_location(
        "example_quickstart", os.path.join(REPO, "examples", "quickstart.py"))
    example = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(example)
    with pytest.raises(_Built) as built:
        example.main()
    return built.value.args[0]


def _flat(tree, prefix=""):
    out = {}
    for key, value in tree.items():
        name = f"{prefix}{key}"
        out.update(_flat(value, name + ".") if isinstance(value, dict)
                   else {name: value})
    return out


def test_config_equals_the_examples_key_for_key(monkeypatch):
    import yaml

    want = _example_cfg(monkeypatch)
    got = quickstart.quickstart_cfg(want.ROOT)
    want, got = (_flat(yaml.safe_load(c.dump())) for c in (want, got))
    assert sorted(got) == sorted(want)
    for key in want:
        assert got[key] == want[key], key


def test_quickstart_runs_on_the_cpu(tmp_path, capsys):
    out = quickstart.main(["--device", "cpu", "--root", str(tmp_path)])
    printed = capsys.readouterr().out
    assert printed.rstrip().endswith("quickstart OK")
    assert "t2i Rank-1 after 2 epochs" in printed
    assert 0.0 <= out["top1"] <= 100.0
    assert out["http_meta"] == out["matches"]
    assert len(out["matches"]) == 2 and all(len(m) == 3
                                             for m in out["matches"])
    # validation after each epoch kept best.pth; a checkpoint each epoch
    names = set(os.listdir(out["output_dir"]))
    assert {"best.pth", "epoch_1.pth", "epoch_2.pth"} <= names
