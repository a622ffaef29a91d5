"""The tolerant weights-only load: ``utils/checkpoint.py:align_state_dict``
against the JAX package's ``align_pytree`` on the same trees (nested dicts
there, flat ``state_dict`` keys here), and ``Checkpointer.load``'s fallback
to it, as the JAX ``Checkpointer.load`` falls back."""

import logging

import numpy as np
import pytest
import torch
from torch import nn

from textreid_tpu.utils.checkpoint import align_pytree
from textreid_torch.utils.checkpoint import Checkpointer, align_state_dict


def _full(shape, value):
    return np.full(shape, value, np.float32)


# the six cases of tests/test_checkpoint_align.py::TestAlignPytree:
# (target, loaded) as nested dicts
CASES = {
    "exact_match_passthrough": (
        {"visual": {"conv1": {"kernel": _full((2, 2), 0)}}},
        {"visual": {"conv1": {"kernel": _full((2, 2), 1)}}}),
    "renamed_parent_module": (
        {"visual": {"conv1": {"kernel": _full((2, 2), 0)}},
         "projection": _full((3,), 0)},
        {"backbone": {"conv1": {"kernel": _full((2, 2), 7)}},
         "projection": _full((3,), 2)}),
    "partial_checkpoint_keeps_init": (
        {"a": {"w": _full((2,), 0)}, "b": {"w2": _full((2,), 5)}},
        {"a": {"w": _full((2,), 1)}}),
    "shape_mismatch_keeps_init": (
        {"w": _full((2,), 0)}, {"w": _full((3,), 1)}),
    "deeper_loaded_path": (
        {"conv1": {"kernel": _full((2, 2), 0)}},
        {"module": {"conv1": {"kernel": _full((2, 2), 1)}}}),
    "longest_suffix_wins": (
        {"v": {"embed": {"kernel": _full((2,), 0)}},
         "t": {"embed": {"kernel": _full((2,), 0)}}},
        {"v": {"embed": {"kernel": _full((2,), 1)}},
         "t": {"embed": {"kernel": _full((2,), 2)}}}),
}


def _flat(tree, prefix=""):
    out = {}
    for k, v in tree.items():
        key = f"{prefix}.{k}" if prefix else k
        out.update(_flat(v, key) if isinstance(v, dict) else {key: v})
    return out


def _messages(caplog):
    msgs = [r.getMessage() for r in caplog.records
            if r.name == "PersonSearch.checkpoint"]
    caplog.clear()
    return msgs


@pytest.mark.parametrize("case", sorted(CASES))
def test_align_state_dict_matches_align_pytree(case, caplog):
    """The same values land on the same keys, with the same counts and the
    same warnings (paths joined by ``.`` instead of ``/``)."""
    target, loaded = CASES[case]
    with caplog.at_level(logging.WARNING, "PersonSearch.checkpoint"):
        want_stats = {}
        want = _flat(align_pytree(target, loaded, stats=want_stats,
                                  label="params"))
        want_msgs = [m.replace("/", ".") for m in _messages(caplog)]
        got_stats = {}
        got = align_state_dict(
            {k: torch.from_numpy(v) for k, v in _flat(target).items()},
            {k: torch.from_numpy(v) for k, v in _flat(loaded).items()},
            stats=got_stats, label="params")
        got_msgs = _messages(caplog)
    assert list(got) == list(_flat(target))
    assert sorted(got) == sorted(want)
    for key in want:
        np.testing.assert_array_equal(got[key].numpy(), want[key])
    assert got_stats == want_stats
    assert got_msgs == want_msgs


class Tower(nn.Module):
    def __init__(self, name):
        super().__init__()
        trunk = nn.Module()
        trunk.conv1 = nn.Conv2d(1, 2, 2, bias=False)
        trunk.bn1 = nn.BatchNorm2d(2)
        self.add_module(name, trunk)
        self.projection = nn.Linear(2, 3)


class State:
    def __init__(self, model, key_model=None):
        self.model, self.key_model = model, key_model


def _filled(module, value):
    with torch.no_grad():
        for t in module.state_dict().values():
            if t.is_floating_point():
                t.fill_(value)
    return module


def _save(tmp_path, name, model, key_model=None):
    payload = {"model": model.state_dict(), "meta": {"epoch": 1}}
    if key_model is not None:
        payload["key_model"] = key_model.state_dict()
    path = str(tmp_path / f"{name}.pth")
    torch.save(payload, path)
    return path


def test_load_is_strict_when_the_file_matches(tmp_path, caplog):
    path = _save(tmp_path, "same", _filled(Tower("visual"), 3.0),
                 _filled(Tower("visual"), 4.0))
    state = State(_filled(Tower("visual"), 0.0), _filled(Tower("visual"), 0.0))
    with caplog.at_level(logging.WARNING, "PersonSearch.checkpoint"):
        Checkpointer("").load(path, state)
    assert not [r for r in caplog.records if r.levelno >= logging.WARNING]
    assert float(state.model.visual.conv1.weight.detach().min()) == 3.0
    assert float(state.key_model.visual.conv1.weight.detach().min()) == 4.0


def test_load_aligns_a_renamed_module(tmp_path, caplog):
    """The ``TestCheckpointerTolerantLoad`` case: a tower saved as
    ``backbone`` loads into ``visual`` by suffix, with a warning that names
    the strict load's error; the key model too."""
    path = _save(tmp_path, "old", _filled(Tower("backbone"), 3.0),
                 _filled(Tower("backbone"), 5.0))
    state = State(_filled(Tower("visual"), 0.0), _filled(Tower("visual"), 0.0))
    with caplog.at_level(logging.WARNING, "PersonSearch.checkpoint"):
        Checkpointer("").load(path, state)
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Strict load failed (KeyError") for m in msgs)
    assert any("visual.conv1.weight loaded from backbone.conv1.weight" in m
               for m in msgs)
    assert not [r for r in caplog.records if r.levelno >= logging.ERROR]
    for key, value in state.model.state_dict().items():
        if value.is_floating_point():
            assert float(value.detach().min()) == float(value.detach().max()) == 3.0, key
    assert float(state.key_model.visual.bn1.running_var.min()) == 5.0


def test_load_aligns_a_shape_mismatch_and_keeps_the_rest(tmp_path, caplog):
    src = _filled(Tower("visual"), 2.0)
    src.projection = nn.Linear(2, 4)  # another class count
    path = _save(tmp_path, "classes", _filled(src, 2.0))
    state = State(_filled(Tower("visual"), 0.0))
    with caplog.at_level(logging.WARNING, "PersonSearch.checkpoint"):
        Checkpointer("").load(path, state)
    msgs = [r.getMessage() for r in caplog.records]
    assert any(m.startswith("Strict load failed (ValueError") for m in msgs)
    assert any("shapes differ" in m for m in msgs)
    assert float(state.model.visual.conv1.weight.detach().min()) == 2.0
    assert float(state.model.projection.weight.detach().abs().max()) == 0.0


def test_load_refuses_a_file_that_matches_nothing(tmp_path):
    other = nn.Module()
    other.head = nn.Linear(5, 7)
    path = _save(tmp_path, "other", other)
    state = State(_filled(Tower("visual"), 1.0))
    with pytest.raises(ValueError, match="matched 0/"):
        Checkpointer("").load(path, state)
    assert float(state.model.visual.conv1.weight.detach().min()) == 1.0


def test_load_logs_an_error_below_half(tmp_path, caplog):
    small = nn.Module()
    small.projection = nn.Linear(2, 3)
    path = _save(tmp_path, "small", _filled(small, 6.0))
    state = State(_filled(Tower("visual"), 0.0))
    with caplog.at_level(logging.WARNING, "PersonSearch.checkpoint"):
        Checkpointer("").load(path, state)
    assert any(r.levelno == logging.ERROR and "matched only 2/" in
               r.getMessage() for r in caplog.records)
    assert float(state.model.projection.weight.detach().min()) == 6.0


def test_a_missing_file_is_not_aligned(tmp_path):
    state = State(Tower("visual"))
    with pytest.raises(FileNotFoundError):
        Checkpointer("").load(str(tmp_path / "absent.pth"), state)
