"""The port's data-parallel mesh and collectives
(``textreid_torch/parallel/mesh.py``, ``models/common.py:batch_norm``).

``make_mesh`` against the JAX package's on the conftest's 8 virtual CPU
devices (shapes, with a model axis and several slices; the device layout;
the oversize refusal).  On 2 gloo ranks on the CPU
(``tests/torch_dp_worker.py``): the gather with gradient, forward and
backward, against one process summing the ranks' losses; training
BatchNorm on each rank's half of a batch against ``batch_norm`` on the
whole batch in one process, within 1e-5: the output, the input's
gradient, the scale's and bias's gradients (the ranks' own sums, added),
the running mean and the running (biased) variance.
"""

import numpy as np
import pytest
import torch

from textreid_tpu.parallel import make_mesh as jax_make_mesh
from textreid_tpu.parallel.mesh import DATA_AXIS as JAX_DATA
from textreid_tpu.parallel.mesh import MODEL_AXIS as JAX_MODEL
from textreid_tpu.parallel.mesh import SLICE_AXIS as JAX_SLICE
from textreid_tpu.parallel.mesh import data_shard_count as jax_shard_count
from textreid_tpu.parallel.mesh import local_batch_size as jax_local_batch
from textreid_torch.models.common import batch_norm
from textreid_torch.parallel import (
    DATA_AXIS,
    MODEL_AXIS,
    data_shard_count,
    local_batch_size,
    make_mesh,
)
from textreid_torch.parallel.mesh import SLICE_AXIS, is_distributed

from torch_dp_worker import launch

torch.set_num_threads(2)

DEVICES = [torch.device("cpu")] * 8


@pytest.mark.parametrize("num_data", [0, 1, 4, 8])
def test_data_meshes_match_jax(num_data):
    want = jax_make_mesh(num_data)
    got = make_mesh(num_data, devices=DEVICES)
    assert got.shape[DATA_AXIS] == want.shape[JAX_DATA]
    assert got.shape[MODEL_AXIS] == want.shape[JAX_MODEL] == 1
    assert data_shard_count(got) == len(got.devices) == want.shape[JAX_DATA]
    assert not got.distributed
    assert local_batch_size(128, got) == jax_local_batch(128, want)
    assert local_batch_size(128, None) == 128


@pytest.mark.parametrize("num_data,num_model", [(9, 1), (5, 2), (0, 9)])
def test_oversize_meshes_raise_as_in_jax(num_data, num_model):
    with pytest.raises(ValueError):
        jax_make_mesh(num_data, num_model)
    with pytest.raises(ValueError, match="only 8 devices"):
        make_mesh(num_data, num_model, devices=DEVICES)


def test_local_batch_must_divide():
    with pytest.raises(ValueError):
        jax_local_batch(10, jax_make_mesh(4))
    with pytest.raises(ValueError, match="not divisible"):
        local_batch_size(10, make_mesh(4, devices=DEVICES))


@pytest.mark.parametrize("args", [
    dict(num_data=4, num_model=2), dict(num_data=0, num_model=2),
    dict(num_slices=2), dict(num_data=2, num_model=2, num_slices=2)])
def test_model_and_slice_meshes_match_jax(args):
    """A model axis and several slices: the axes, their sizes, the data
    shards and the devices' places (``(slice, data, model)``, the model
    index fastest) are JAX's."""
    want = jax_make_mesh(**args)
    devices = [torch.device("cpu", i) for i in range(8)]
    got = make_mesh(**args, devices=devices)
    assert tuple(got.shape) == tuple(want.axis_names)
    assert got.shape == dict(want.shape)
    assert data_shard_count(got) == jax_shard_count(want)
    assert local_batch_size(64, got) == jax_local_batch(64, want)
    ids = [d.id for d in want.devices.reshape(-1)]
    assert [d.index for d in got.devices] == ids
    # a gallery shard a data index: its model index 0, slice 0
    first = want.devices[0] if SLICE_AXIS in got.shape else want.devices
    assert [d.index for d in got.shard_devices] == [
        d.id for d in first[:, 0]]
    assert (JAX_SLICE in want.axis_names) == (SLICE_AXIS in got.shape)


@pytest.mark.parametrize("args", [dict(num_data=0, num_slices=3),
                                  dict(num_data=5, num_slices=2)])
def test_slice_meshes_refuse_as_jax(args):
    with pytest.raises(ValueError) as want:
        jax_make_mesh(**args)
    with pytest.raises(ValueError) as got:
        make_mesh(**args, devices=DEVICES)
    assert str(got.value) == str(want.value)


def test_no_group_no_card_no_mesh():
    """Outside a group the default devices are this process's cards: none
    here, so the mesh raises as JAX's does with no device."""
    assert not is_distributed()
    if not torch.cuda.is_available():
        with pytest.raises(ValueError, match="only 0 devices"):
            make_mesh()


@pytest.fixture(scope="module")
def two_ranks(tmp_path_factory):
    rng = np.random.RandomState(0)
    bn_c = 5
    payload = {
        "x": rng.randn(6, 4).astype(np.float32),
        "w": rng.randn(2, 6, 4).astype(np.float32),
        # a mean well away from 0: the merge of the ranks' statistics must
        # not lose the variance to cancellation
        "bn_x": (rng.randn(4, bn_c, 3, 2) * 2 + 3).astype(np.float32),
        "bn_g": rng.randn(4, bn_c, 3, 2).astype(np.float32),
        "bn_weight": (rng.rand(bn_c) + 0.5).astype(np.float32),
        "bn_bias": (rng.randn(bn_c) * 0.1).astype(np.float32),
        "bn_running_mean": (rng.randn(bn_c) * 0.1).astype(np.float32),
        "bn_running_var": (rng.rand(bn_c) + 0.5).astype(np.float32),
    }
    out = launch("collectives", payload,
                 tmp_path_factory.mktemp("collectives"))
    return payload, out


def test_gather_with_gradient_on_two_ranks(two_ranks):
    p, out = two_ranks
    x = torch.from_numpy(p["x"]).requires_grad_(True)
    (x * torch.from_numpy(p["w"]).sum(0)).sum().backward()  # both losses
    for rank, got in enumerate(out):
        torch.testing.assert_close(got["gathered"], x.detach(), rtol=0,
                                   atol=0)
        torch.testing.assert_close(got["columns"], x.detach(), rtol=0,
                                   atol=0)
        torch.testing.assert_close(got["grad"], x.grad[rank * 3:rank * 3 + 3],
                                   rtol=1e-6, atol=1e-6)


def test_a_group_mesh_is_every_rank(two_ranks):
    """Inside a process group the data axis is the ranks:
    ``TPU.DATA_PARALLEL`` 0 gives every rank, a smaller count is refused
    (the port cannot leave a rank out), a larger one as JAX refuses it."""
    _, out = two_ranks
    for got in out:
        assert got["mesh"] == (2, True)
        assert len(got["refused"]) == 2
        assert "give 0 or the world size 2" in got["refused"][0]
        assert "only 2 ranks" in got["refused"][1]


def test_global_batch_norm_on_two_ranks(two_ranks):
    p, out = two_ranks
    bn = torch.nn.BatchNorm2d(p["bn_x"].shape[1], momentum=0.1).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(p["bn_" + name]))
    x = torch.from_numpy(p["bn_x"]).requires_grad_(True)
    y = batch_norm(x, bn)
    (y * torch.from_numpy(p["bn_g"])).sum().backward()
    tol = dict(rtol=1e-5, atol=1e-5)
    for rank, got in enumerate(out):
        rows = slice(rank * 2, rank * 2 + 2)
        torch.testing.assert_close(got["bn_out"], y.detach()[rows], **tol)
        torch.testing.assert_close(got["bn_dx"], x.grad[rows], **tol)
        torch.testing.assert_close(got["bn_mean"], bn.running_mean, **tol)
        torch.testing.assert_close(got["bn_var"], bn.running_var, **tol)
    torch.testing.assert_close(out[0]["bn_dw"] + out[1]["bn_dw"],
                               bn.weight.grad, **tol)
    torch.testing.assert_close(out[0]["bn_db"] + out[1]["bn_db"],
                               bn.bias.grad, **tol)
    # the biased variance, as flax's: not the unbiased one (n / (n - 1))
    biased = p["bn_x"].transpose(1, 0, 2, 3).reshape(5, -1).var(axis=1)
    np.testing.assert_allclose(
        out[0]["bn_var"].numpy(),
        0.9 * p["bn_running_var"] + 0.1 * biased, rtol=1e-5)


def test_a_rank_slices_its_rows_of_a_whole_global_batch(monkeypatch):
    """Without ``TPU.PROCESS_SHARD_DATA`` every rank's loader gives the
    whole global batch and the trainer keeps its data shard's rows
    (shard-major); a process-sharded loader's batch, and one shard, pass
    whole."""
    from textreid_torch.engine import trainer

    batch = {"pids": np.arange(8), "pixels": np.arange(16).reshape(8, 2)}

    class Loader:
        process_shard = None

    assert trainer.local_rows(batch, Loader()) is batch  # one rank
    monkeypatch.setattr(trainer, "data_size", lambda: 2)
    monkeypatch.setattr(trainer, "data_rank", lambda: 1)
    mine = trainer.local_rows(batch, Loader())
    np.testing.assert_array_equal(mine["pids"], [4, 5, 6, 7])
    np.testing.assert_array_equal(mine["pixels"], batch["pixels"][4:])
    sharded = Loader()
    sharded.process_shard = (1, 2)
    assert trainer.local_rows(batch, sharded) is batch
    with pytest.raises(ValueError, match="not divisible"):
        trainer.local_rows({"pids": np.arange(7)}, Loader())
