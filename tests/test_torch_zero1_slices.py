"""ZeRO-1 optimizer-state sharding and the multi-slice mesh of the port
(``textreid_torch/parallel/mesh.py``, ``solver/build.py:Zero1Optimizer``)
against the JAX package on the CPU, on the flagship's narrow MoCo model of
``tests/test_torch_dp_step.py`` (ModifiedResNet width 8 with BatchNorm on
batch statistics + bi-GRU H=16, batch 8, K=16), from one JAX start.

* ZeRO-1, 2 gloo ranks, Adam, two steps (one launch): the parameters, key
  parameters, queues and the moments (gathered to the single-process
  layout) equal the 2-rank step's without it, bit for bit; each rank keeps
  half of the split leaves' moments; and the run is held against JAX's
  single-device step on the global batch by ``test_torch_dp_step.py``'s
  gates.
* Slices, 4 gloo ranks (one launch): the mesh of 2 slices x 2 lays the
  ranks out as JAX's ``make_mesh(num_slices=2)`` lays 4 devices out (the
  replica groups within a slice ``{0, 1}, {2, 3}`` and across ``{0, 2},
  {1, 3}``, ``tests/test_sharding.py``'s on 8 devices, scaled to the
  world); one SGD step on it lands within atol 1e-6 of the flat 4-rank
  mesh (``tests/test_sharding.py``'s bound); and ZeRO-1 on it splits the
  moments over the inner data axis only, bit-equal to the slice run
  without it under Adam.
"""

import numpy as np
import pytest
import torch

from textreid_tpu.parallel import make_mesh as jax_make_mesh
from textreid_tpu.parallel.mesh import DATA_AXIS as JAX_DATA
from textreid_tpu.parallel.mesh import SLICE_AXIS as JAX_SLICE
from textreid_torch.utils.weight_convert import train_state_from_jax

from test_torch_dp_step import _assert_ranks_agree, _cfg, _replay
from test_torch_tensor_parallel import quick_jax_start
from test_torch_train_gru2l import assert_two_steps, port_start
from test_torch_train_step import LR
from test_torch_train_step_bn import (
    RN_SPEC,
    _pieces,
    jax_model,
    make_batch,
    tiny_resnet,  # noqa: F401
)
from test_torch_train_step import frozen_table
from torch_dp_worker import launch

torch.set_num_threads(2)

MIN_ZERO1 = 64  # so that the narrow model's leaves split


def _run(cfg, jstate, batches, mesh, **extra):
    return {"cfg": cfg.to_dict(), "pieces": train_state_from_jax(
        _pieces(jstate)), "batches": batches, "mesh": mesh, **extra}


@pytest.fixture(scope="module")
def start(tmp_path_factory):
    """JAX's Adam start and step, and the port's cfgs for Adam and SGD
    (the runs take the start's weights and queues; each builds its own
    optimizer)."""
    root = tmp_path_factory.mktemp("start")
    cfg = _cfg(root)
    cfg.SOLVER.OPTIMIZER = "Adam"
    sgd = cfg.clone()
    sgd.SOLVER.OPTIMIZER = "SGD"
    batches = [make_batch(1), make_batch(2)]
    jstate, jstep = quick_jax_start(cfg, jax_model(cfg, frozen_table(root)),
                                    batches)
    return cfg, sgd, batches, jstate, jstep


@pytest.fixture(scope="module")
def zero_runs(start, tmp_path_factory):
    cfg, _, batches, jstate, jstep = start
    runs = {"dp": _run(cfg, jstate, batches, (0, 1, 1)),
            "zero": _run(cfg, jstate, batches, (0, 1, 1), zero=True,
                         min_zero1=MIN_ZERO1)}
    out = launch("mesh_runs", {"lr": LR, "rn_spec": RN_SPEC, "runs": runs},
                 tmp_path_factory.mktemp("zero1"), world=2)
    return cfg, batches, jstate, jstep, out


def _assert_bit_equal(a_steps, b_steps):
    for a, b in zip(a_steps, b_steps):
        assert a["metrics"] == b["metrics"]
        for which in ("model", "key_model"):
            for k, v in b["state"][which].items():
                assert torch.equal(a["state"][which][k], v), (which, k)
        for k in ("v_queue", "t_queue", "id_queue"):
            assert torch.equal(a["state"][k], b["state"][k]), k
        for i, slot in b["state"]["optimizer"]["state"].items():
            for k, v in slot.items():
                assert torch.equal(a["state"]["optimizer"]["state"][i][k],
                                   v), (i, k)


def test_zero1_is_bit_equal_to_data_parallelism(zero_runs):
    _, _, _, _, out = zero_runs
    for rank in out:
        zero, dp = rank["zero"], rank["dp"]
        assert zero["zero"] and not dp["zero"] and not zero["tp"]
        _assert_bit_equal(zero["steps"], dp["steps"])
        # the split leaves' moments: half on each rank
        assert zero["opt_bytes"] < 0.75 * dp["opt_bytes"]


def test_zero1_steps_match_jax_on_the_global_batch(zero_runs, tiny_resnet):
    cfg, batches, jstate, jstep, out = zero_runs
    records = [rank["zero"]["steps"] for rank in out]
    _assert_ranks_agree(records)
    tstate, _ = port_start(cfg, jstate)
    assert_two_steps(jstate, jstep, tstate, _replay(records[0]), batches)


@pytest.fixture(scope="module")
def slice_runs(start, tmp_path_factory):
    adam, sgd, batches, jstate, _ = start
    one = batches[:1]
    runs = {"flat": _run(sgd, jstate, one, (0, 1, 1)),
            "slices": _run(sgd, jstate, one, (0, 1, 2)),
            "slices_adam": _run(adam, jstate, one, (0, 1, 2)),
            "slices_zero": _run(adam, jstate, one, (0, 1, 2), zero=True,
                                min_zero1=MIN_ZERO1)}
    return launch("mesh_runs", {"lr": LR, "rn_spec": RN_SPEC, "runs": runs},
                  tmp_path_factory.mktemp("slices"), world=4)


def test_the_slices_are_jax_replica_groups(slice_runs):
    import jax

    mesh = jax_make_mesh(num_slices=2, devices=jax.devices()[:4])
    ids = np.vectorize(lambda d: d.id)(mesh.devices)
    assert mesh.axis_names[:2] == (JAX_SLICE, JAX_DATA)
    within = {tuple(ids[s, :, 0]) for s in range(2)}
    across = {tuple(ids[:, d, 0]) for d in range(2)}
    assert within == {(0, 1), (2, 3)} and across == {(0, 2), (1, 3)}
    for r, rank in enumerate(slice_runs):
        axes = rank["slices"]["axes"]
        assert axes["data"] in within and r in axes["data"]
        assert axes["slice"] in across and r in axes["slice"]
        assert axes["model"] == (r,)
        assert axes["batch"] == (0, 1, 2, 3)  # the batch over (slice, data)
        assert rank["slices"]["shard"] == (r, 4)
        assert rank["flat"]["axes"]["data"] == (0, 1, 2, 3)


def test_a_slice_step_lands_on_the_flat_mesh_step(slice_runs):
    for rank in slice_runs:
        flat, hier = rank["flat"]["steps"][0], rank["slices"]["steps"][0]
        assert hier["metrics"] == pytest.approx(flat["metrics"], rel=1e-6)
        for which in ("model", "key_model"):
            for k, v in flat["state"][which].items():
                np.testing.assert_allclose(hier["state"][which][k].numpy(),
                                           v.numpy(), atol=1e-6, rtol=0,
                                           err_msg=k)
        for k in ("v_queue", "t_queue"):
            np.testing.assert_allclose(hier["state"][k].numpy(),
                                       flat["state"][k].numpy(), atol=1e-6,
                                       rtol=0)


def test_zero1_on_slices_splits_over_the_inner_data_axis(slice_runs):
    for rank in slice_runs:
        zero, plain = rank["slices_zero"], rank["slices_adam"]
        assert zero["zero"]
        _assert_bit_equal(zero["steps"], plain["steps"])
        # a data group of 2 inside the slice: half of a split leaf a rank
        assert zero["opt_bytes"] < 0.75 * plain["opt_bytes"]
