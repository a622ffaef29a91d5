"""The gradient-cache step and ``TPU.REMAT`` on a BatchNorm tower, against
the JAX package on the CPU in f32: ``tests/test_grad_cache.py``'s
``tiny_bn_model`` (ModifiedResNet width 16 + bi-GRU), batch 8, SGD at lr
1, carried into the port with ``train_state_from_jax`` (see
``tests/test_torch_grad_cache.py`` for the rules).

* MoCo accum 2 against JAX: loss dicts (rtol 1e-5), updates (UPDATE_RTOL;
  the trunk's at BN_TRUNK_RTOL), the key model, queues, ids and pointer,
  and both models' running statistics, advanced microbatch by microbatch
  (STATS_RTOL).
* ``TPU.REMAT`` on against off, single pass and accum 2: equal parameters
  after two steps, and the running statistics moved once a forward, not
  again in the recompute (within 1e-6 of each tensor's largest entry).
"""

import numpy as np
import pytest
import torch

from textreid_torch.engine import make_train_step
from textreid_torch.models import model as model_module
from textreid_torch.models.m_resnet import ModifiedResNet
from textreid_torch.utils.weight_convert import train_state_from_jax

from test_torch_grad_cache import (
    _assert_moco_state,
    _numpy,
    _params,
    assert_updates,
    jax_case,
    port_cfg,
    port_state,
    torch_batch,
)
from test_torch_train_step_bn import STATS_RTOL, _pieces, _split

torch.set_num_threads(2)

BN_SPEC = dict(layers=(1, 1, 1, 1), output_dim=32, heads=4, last_stride=1,
               input_resolution=(32, 16), width=16)
# the BatchNorm trunk's updates: its gradients pass through every
# BatchNorm's batch-statistics backward, whose f32 rounding the trunk
# amplifies (tests/test_torch_resnet.py measures it in the forward)
BN_TRUNK_RTOL = 1e-4


@pytest.fixture
def bn_tower(monkeypatch):
    """``build_model`` builds ``tiny_bn_model``'s ModifiedResNet."""
    monkeypatch.setattr(model_module, "build_m_resnet",
                        lambda cfg: ModifiedResNet(**BN_SPEC))


def test_batchnorm_tower_grad_cache_matches_jax(bn_tower):
    """MoCo accum 2 on the BatchNorm tower: each microbatch normalised on
    its own statistics, the running ones (query and key) advanced
    microbatch by microbatch, as JAX's scan carries them."""
    jstate, jstep, batch = jax_case("moco", 2, False, bn=True)
    start = train_state_from_jax(_pieces(jstate))
    tstate = port_state(port_cfg("moco", 2, bn=True), jstate)
    jstate, jmetrics = jstep(jstate, batch)
    tmetrics = make_train_step(port_cfg("moco", 2, bn=True))(
        tstate, torch_batch(batch))
    for name, v in jmetrics.items():
        np.testing.assert_allclose(float(tmetrics[name]), float(v),
                                   rtol=1e-5, err_msg=name)
    want = train_state_from_jax(_pieces(jstate))
    got = tstate.state_dict()
    assert_updates(_params(_numpy(got["model"])), _params(want["model"]),
                   _params(start["model"]), "BatchNorm tower against JAX",
                   trunk_rtol=BN_TRUNK_RTOL)
    _assert_moco_state(got, want, "BatchNorm tower against JAX")
    for which in ("model", "key_model"):
        _, got_stats = _split(_numpy(got[which]))
        _, want_stats = _split(want[which])
        _, start_stats = _split(start[which])
        assert len(want_stats) == 2 * (3 + 4 * 4)  # every BatchNorm
        for name, v in want_stats.items():
            assert not np.array_equal(v, start_stats[name]), name
            tol = STATS_RTOL[which]
            np.testing.assert_allclose(
                got_stats[name], v, rtol=tol, atol=tol * np.abs(v).max(),
                err_msg=f"{which} {name}")


@pytest.mark.parametrize("accum", [1, 2])
def test_remat_on_equals_off(bn_tower, accum):
    """``TPU.REMAT`` recomputes the image tower in the backward: two steps
    with it on and off give equal parameters, and the BatchNorm running
    statistics moved once a forward, not again in the recompute."""
    jstate, _, batch = jax_case("moco", accum, False, bn=True)
    states = []
    for remat in (False, True):
        cfg = port_cfg("moco", accum, bn=True)
        cfg.TPU.REMAT = remat
        state = port_state(cfg, jstate)
        step = make_train_step(cfg)
        for _ in range(2):
            step(state, torch_batch(batch))
        states.append(state.state_dict())
    off, on = states
    for which in ("model", "key_model"):
        for name, v in off[which].items():
            torch.testing.assert_close(on[which][name], v, rtol=0,
                                       atol=1e-6 * max(v.abs().max(), 1),
                                       msg=f"{which} {name}")


