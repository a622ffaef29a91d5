"""The port's data-parallel train steps on 2 gloo ranks on the CPU, against
the JAX package's single-device step on the global batch.

The flagship's narrow MoCo model of ``tests/test_torch_train_step_bn.py``
(the ModifiedResNet with BatchNorm on batch statistics, width 8, + the
bi-GRU H=16, batch 8, K=16) from one JAX init carried across with
``train_state_from_jax``; each rank takes its 4 rows of each of the two
batches (``tests/torch_dp_worker.py``).  The ranks' steps are held by the
gates of ``test_torch_train_step_bn.py`` (``test_torch_train_gru2l.py:
assert_two_steps``, replaying rank 0's recorded steps): the loss dicts
(rtol 1e-5, 5e-5), after step 2 the trunk by its update, every other
parameter at atol 1e-6, both models' BatchNorm running statistics (the
global batch's), the key model, the queues (atol 1e-5), ids and pointer;
and step 1's gradients (averaged over the ranks) against JAX's at its
tolerances.  Both ranks' states agree to 1e-6.

The simple head (``baseline_gru_cliprn50_ls_bs128.yaml`` at the same
width) the same way against JAX's ``simple_train_step``; the
gradient-cache step (``SOLVER.GRAD_ACCUM_STEPS 2``: each rank's 4 rows in
2 microbatches) once against the port's one-process gradient-cache step on
the global batch in microbatch-major order (``engine/grad_cache.py``).
"""

import numpy as np
import pytest
import torch

import jax
import jax.numpy as jnp

from textreid_torch.engine import make_train_step
from textreid_torch.utils.weight_convert import (
    state_dict_from_jax,
    train_state_from_jax,
)

from test_torch_train_gru2l import assert_two_steps, jax_start, port_start
from test_torch_train_simple import CLIP_YAML, jax_simple_model, simple_cfg
from test_torch_train_step import (
    BATCH,
    LR,
    NOISE_FLOOR,
    VOCAB,
    _torch_batch,
    frozen_table,
    jax_grads,
)
from test_torch_train_step_bn import (
    GRAD_ATOL,
    GRAD_RTOL_OF_MAX,
    RN_SPEC,
    _pieces,
    _split,
    jax_model,
    make_batch,
    tiny_cfg,
    tiny_resnet,  # noqa: F401
)
from textreid_tpu.models import BiGRUEncoder as JaxBiGRU
from textreid_tpu.models.m_resnet import ModifiedResNet as JaxModifiedResNet
from torch_dp_worker import launch

torch.set_num_threads(2)

WORLD = 2
# microbatch-major order of the global batch under 2 ranks x 2 microbatches
# of 2 rows: rank 0's rows 0-3, rank 1's rows 4-7
GRAD_CACHE_ORDER = [0, 1, 4, 5, 2, 3, 6, 7]


def _cfg(tmp_path, simple=False):
    cfg = simple_cfg(tmp_path, CLIP_YAML) if simple else tiny_cfg(tmp_path)
    cfg.SOLVER.IMS_PER_BATCH = BATCH
    return cfg


@pytest.fixture(scope="module")
def runs(tmp_path_factory):
    """JAX's starts, and every rank's records of the three runs."""
    root = tmp_path_factory.mktemp("dp_step")
    table = frozen_table(root)
    batches = [make_batch(1), make_batch(2)]
    moco_cfg, simple = _cfg(root), _cfg(root, simple=True)
    accum = _cfg(root)
    accum.SOLVER.GRAD_ACCUM_STEPS = 2
    moco = jax_start(moco_cfg, jax_model(moco_cfg, table), batches)
    simple_model = jax_simple_model(
        simple, JaxModifiedResNet(**RN_SPEC),
        JaxBiGRU(hidden_dim=16, vocab_size=VOCAB, embed_size=16,
                 use_onehot="clip_vit", frozen_table_init=lambda: table))
    simple_start = jax_start(simple, simple_model, batches)
    starts = {"moco": (moco_cfg, moco), "simple": (simple, simple_start),
              "grad_cache": (accum, moco)}
    payload = {"rn_spec": RN_SPEC, "lr": LR, "runs": {
        name: {"cfg": cfg.to_dict(),
               "pieces": train_state_from_jax(_pieces(start[0])),
               "batches": batches[:1] if name == "grad_cache" else batches}
        for name, (cfg, start) in starts.items()}}
    out = launch("steps", payload, root / "ranks", world=WORLD)
    return starts, batches, out, table


def _replay(records):
    """A step that installs a rank's recorded step in ``state``: its state
    after the step, its (averaged) gradients; returns its metrics."""
    records = iter(records)

    def step(state, batch):
        rec = next(records)
        state.load_state_dict(rec["state"])
        for name, p in state.model.named_parameters():
            p.grad = rec["grads"].get(name)
        return rec["metrics"]

    return step


def _assert_ranks_agree(records):
    for a, b in zip(*records):
        assert a["metrics"] == pytest.approx(b["metrics"], rel=1e-6)
        for which in ("model", "key_model"):
            for name, v in a["state"].get(which, {}).items():
                torch.testing.assert_close(v, b["state"][which][name],
                                           rtol=0, atol=1e-6)
        for name in ("v_queue", "t_queue", "id_queue"):
            if name in a["state"]:
                torch.testing.assert_close(a["state"][name],
                                           b["state"][name], rtol=0,
                                           atol=1e-6)
        assert a["state"].get("queue_ptr") == b["state"].get("queue_ptr")
        for name, g in a["grads"].items():
            torch.testing.assert_close(g, b["grads"][name], rtol=0,
                                       atol=1e-6)


def test_two_dp_moco_steps_match_jax_on_the_global_batch(runs, tiny_resnet):
    starts, batches, out, table = runs
    cfg, (jstate, jstep) = starts["moco"]
    records = [rank["moco"] for rank in out]
    _assert_ranks_agree(records)
    # step 1's gradients, averaged over the ranks, against JAX's
    want = _split(state_dict_from_jax({
        "params": jax.tree.map(np.asarray, jax_grads(
            jax_model(cfg, table), cfg, jstate,
            jax.tree.map(jnp.asarray, batches[0]))),
        "batch_stats": jax.tree.map(np.asarray, jstate.batch_stats)}))[0]
    got = records[0][0]["grads"]
    assert set(got) == {k for k in want
                        if not k.endswith("num_batches_tracked")}
    for name, g in got.items():
        top = np.abs(want[name]).max()
        np.testing.assert_allclose(
            g.numpy(), want[name], rtol=1e-4,
            atol=max(GRAD_ATOL, GRAD_RTOL_OF_MAX * top),
            err_msg=f"step-1 gradients: {name}")
    tstate, _ = port_start(cfg, jstate)
    _, got_state = assert_two_steps(jstate, jstep, tstate,
                                    _replay(records[0]), batches)
    # the key encoders' statistics moved, apart from the query model's
    name = "visual_model.layer2.0.bn2.running_var"
    assert not torch.equal(got_state["key_model"][name],
                           got_state["model"][name])


def test_dp_simple_step_matches_jax_on_the_global_batch(runs, tiny_resnet):
    starts, batches, out, _ = runs
    cfg, (jstate, jstep) = starts["simple"]
    records = [rank["simple"] for rank in out]
    _assert_ranks_agree(records)
    tstate, _ = port_start(cfg, jstate)
    assert tstate.key_model is None
    assert_two_steps(jstate, jstep, tstate, _replay(records[0]), batches)


def test_dp_grad_cache_step_matches_one_process(runs, tiny_resnet):
    """Each rank replays its 2 microbatches of 2 rows; the one-process
    step takes the global batch in microbatch-major order (global
    microbatch i is every rank's microbatch i)."""
    starts, batches, out, _ = runs
    cfg, (jstate, _) = starts["grad_cache"]
    records = [rank["grad_cache"] for rank in out]
    _assert_ranks_agree(records)
    tstate, _ = port_start(cfg, jstate)
    before = {n: p.detach().clone() for n, p in
              tstate.model.named_parameters()}
    batch = {k: v[GRAD_CACHE_ORDER] for k, v in batches[0].items()}
    want_metrics = make_train_step(cfg)(tstate, _torch_batch(batch))
    got = records[0][0]
    for name, v in want_metrics.items():
        np.testing.assert_allclose(got["metrics"][name], float(v),
                                   rtol=1e-5, err_msg=name)
    for name, p in tstate.model.named_parameters():
        top = p.grad.abs().max().item()
        torch.testing.assert_close(got["grads"][name], p.grad, rtol=1e-4,
                                   atol=max(GRAD_ATOL, GRAD_RTOL_OF_MAX * top))
    want = tstate.state_dict()
    decay = {id(p): g["weight_decay"] for g in tstate.optimizer.param_groups
             for p in g["params"]}
    for name, p in tstate.model.named_parameters():
        # Adam's first step is lr * sign(g + wd p): entries where that sum
        # is in the noise may step the other way
        noisy = (p.grad + decay[id(p)] * before[name]).abs() < NOISE_FLOOR
        a, b = got["state"]["model"][name], want["model"][name]
        torch.testing.assert_close(a[~noisy], b[~noisy], rtol=0, atol=1e-6)
        assert (a - b).abs().max() <= 2 * LR, name
        assert not torch.equal(b, before[name]) or p.grad.abs().max() == 0
    for which in ("model", "key_model"):
        got_rest, got_stats = _split(got["state"][which])
        want_rest, want_stats = _split(want[which])
        for name, v in want_stats.items():
            torch.testing.assert_close(got_stats[name], v, rtol=1e-4,
                                       atol=1e-4 * v.abs().max().item())
    for name in ("v_queue", "t_queue"):
        torch.testing.assert_close(got["state"][name], want[name], rtol=0,
                                   atol=1e-5)
    assert torch.equal(got["state"]["id_queue"], want["id_queue"])
    assert got["state"]["queue_ptr"] == want["queue_ptr"] == BATCH
