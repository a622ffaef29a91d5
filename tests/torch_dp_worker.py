"""The ranks of the port's data-parallel tests, and the launcher that runs
them: each rank is ``python tests/torch_dp_worker.py TASK IN.pt OUT_DIR``
with ``RANK``, ``WORLD_SIZE`` and ``LOCAL_RANK`` in its environment, in a
gloo group on the CPU formed at a ``file://`` store.  This module imports
torch and the port only: no rank loads JAX, and the environment it gets
carries no ``XLA_FLAGS``.

Tasks (``IN.pt`` holds the payload, a pickled dict; each rank writes
``OUT_DIR/rank<r>.pt``):

* ``collectives``: ``parallel/mesh.py:gather_rows`` forward and gradient
  and training ``models/common.py:batch_norm`` on the rank's rows;
* ``steps``: the data-parallel MoCo, simple and gradient-cache steps
  (``engine/steps.py``, ``engine/grad_cache.py``) on the rank's rows of
  each global batch, from a given state;
* ``main``: ``textreid_torch.<module>.main(argv)`` (``train_net`` or
  ``test_net``), optionally sending SIGTERM to itself at one iteration;
* ``mesh_runs``: train steps on a ``(slice, data, model)`` mesh
  (``parallel/mesh.py:make_mesh``, ``shard_state``: a model axis, ZeRO-1,
  slices) on the rank's data shard of each global batch, each recorded in
  the single-process layout; optionally a checkpoint written and resumed,
  an eval-mode encode, the placements and the mesh's groups;
* ``gallery``: ``evaluation/retrieval.py``'s sharded top-k over a
  process-group mesh, each rank holding its block of the gallery.

:func:`launch` starts the ranks, joins them within a timeout, kills every
rank on overrun and raises with their output.
"""

import os
import signal
import subprocess
import sys
import time

import torch

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))
GLOO_TIMEOUT_S = 60.0


def launch(task, payload, tmp_dir, world=2, timeout=240.0):
    """Run ``task`` on ``world`` ranks; returns each rank's output (a dict)
    in rank order.  Every rank is killed, and the test fails with their
    output, when one fails or the ranks overrun ``timeout`` seconds."""
    tmp_dir = str(tmp_dir)
    os.makedirs(tmp_dir, exist_ok=True)
    store = os.path.join(tmp_dir, "store")
    in_path = os.path.join(tmp_dir, f"{task}.in.pt")
    torch.save({**payload, "init_method": "file://" + store}, in_path)
    env = {k: v for k, v in os.environ.items()
           if not k.startswith(("XLA_", "JAX_", "PYTHONPATH"))}
    env.update(PYTHONPATH=REPO, WORLD_SIZE=str(world), OMP_NUM_THREADS="2")
    procs = []
    for rank in range(world):
        log = open(os.path.join(tmp_dir, f"rank{rank}.log"), "w")
        procs.append((subprocess.Popen(
            [sys.executable, os.path.abspath(__file__), task, in_path,
             tmp_dir], cwd=REPO, stdout=log, stderr=subprocess.STDOUT,
            env={**env, "RANK": str(rank), "LOCAL_RANK": str(rank)}), log))
    deadline = time.time() + timeout
    failed = None
    while failed is None and any(p.poll() is None for p, _ in procs):
        if time.time() > deadline:
            failed = f"ranks overran {timeout} s"
        elif any(p.poll() not in (None, 0) for p, _ in procs):
            failed = "a rank failed"
        else:
            time.sleep(0.1)
    if failed is None and any(p.returncode != 0 for p, _ in procs):
        failed = "a rank failed"
    for p, log in procs:
        if p.poll() is None:
            p.kill()
        p.wait()
        log.close()
    if failed is not None:
        logs = []
        for rank in range(world):
            with open(os.path.join(tmp_dir, f"rank{rank}.log")) as f:
                logs.append(f"--- rank {rank} (rc {procs[rank][0].returncode})"
                            f"\n{f.read()[-6000:]}")
        raise AssertionError(f"{task}: {failed}\n" + "\n".join(logs))
    return [torch.load(os.path.join(tmp_dir, f"rank{r}.pt"),
                       weights_only=False) for r in range(world)]


def _rows(batch, rank, world):
    n = next(iter(batch.values())).shape[0] // world
    return {k: v[rank * n:(rank + 1) * n] for k, v in batch.items()}


def _torch_batch(batch):
    out = {k: torch.from_numpy(v) for k, v in batch.items()}
    out["pids"] = out["pids"].long()
    return out


def task_collectives(p, rank, world):
    from textreid_torch.models.common import batch_norm
    from textreid_torch.parallel.mesh import gather_columns, gather_rows

    x = torch.from_numpy(p["x"]).requires_grad_(True)
    rows = x.shape[0] // world
    mine = x[rank * rows:(rank + 1) * rows].detach().requires_grad_(True)
    y = gather_rows(mine)
    # each rank its own loss: the sum over the ranks is one loss
    (y * torch.from_numpy(p["w"][rank])).sum().backward()
    a, b = gather_columns((mine[:, :2].detach(), mine[:, 2:].detach()),
                          grad=False)
    out = {"gathered": y.detach(), "grad": mine.grad,
           "columns": torch.cat([a, b], dim=1)}
    from textreid_torch.parallel import make_mesh

    mesh = make_mesh(0)
    out["mesh"] = (mesh.shape["data"], mesh.distributed)
    out["refused"] = []
    for num_data in (1, world + 1):
        try:
            make_mesh(num_data)
        except ValueError as e:
            out["refused"].append(str(e))

    bn = torch.nn.BatchNorm2d(p["bn_x"].shape[1], momentum=0.1).train()
    with torch.no_grad():
        for name in ("weight", "bias", "running_mean", "running_var"):
            getattr(bn, name).copy_(torch.from_numpy(p["bn_" + name]))
    bx = torch.from_numpy(p["bn_x"])
    rows = bx.shape[0] // world
    bx = bx[rank * rows:(rank + 1) * rows].clone().requires_grad_(True)
    g = torch.from_numpy(p["bn_g"])[rank * rows:(rank + 1) * rows]
    y = batch_norm(bx, bn)
    (y * g).sum().backward()
    out.update(bn_out=y.detach(), bn_dx=bx.grad, bn_dw=bn.weight.grad,
               bn_db=bn.bias.grad, bn_mean=bn.running_mean.clone(),
               bn_var=bn.running_var.clone())
    return out


def _state(p, cfg):
    from textreid_torch.engine import create_train_state
    from textreid_torch.models import build_model
    from textreid_torch.solver import make_optimizer, set_learning_rate

    model = build_model(cfg, "cpu", torch.float32, torch.float32, train=True)
    optimizer = make_optimizer(cfg, model)
    set_learning_rate(optimizer, p["lr"])
    state = create_train_state(cfg, model, optimizer,
                               cfg.SOLVER.IMS_PER_BATCH)
    state.load(p["pieces"])
    return state


def task_steps(p, rank, world):
    """For each run of ``p["runs"]`` (``{name: {"cfg": cfg.to_dict(),
    "pieces": the state, "batches": global batches}}``): every step's
    metrics, gradients (averaged) and state."""
    from textreid_torch.config import get_default_cfg
    from textreid_torch.engine import make_train_step
    from textreid_torch.models import model as model_module
    from textreid_torch.models.m_resnet import ModifiedResNet

    model_module.build_m_resnet = lambda cfg: ModifiedResNet(**p["rn_spec"])
    out = {}
    for name, run in p["runs"].items():
        cfg = get_default_cfg()
        cfg.merge_from_other(run["cfg"])
        state = _state({**p, "pieces": run["pieces"]}, cfg)
        step = make_train_step(cfg)
        records = []
        for batch in run["batches"]:
            metrics = step(state, _torch_batch(_rows(batch, rank, world)))
            records.append({
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": {n: q.grad.clone() for n, q in
                          state.model.named_parameters()
                          if q.grad is not None},
                "state": state.state_dict(), "step": state.step})
        out[name] = records
    return out


def _full_grads(state):
    """The query model's gradients in the single-process layout (a split
    leaf's parts gathered over the model group)."""
    from textreid_torch.parallel.mesh import MODEL_AXIS, axis, gather_split

    tp = state.sharding.tp if state.sharding is not None else {}
    return {n: gather_split(q.grad, tp[n], axis(MODEL_AXIS)) if n in tp
            else q.grad.clone() for n, q in state.model.named_parameters()
            if q.grad is not None}


def task_mesh_runs(p, rank, world):
    """For each run of ``p["runs"]`` (``{name: {"cfg", "pieces",
    "batches", "mesh": (num_data, num_model, num_slices), "zero": bool,
    optional "min_zero1", "checkpoint": path, "encode": batch}}``): every
    step's metrics, gradients and state (the single-process layout), the
    rank's shapes of the split leaves and its optimizer-state bytes; with
    ``checkpoint``, step 1's state written there and step 2 taken again
    after resuming from it; with ``encode``, ``encode_step`` of that batch
    in eval mode; and each mesh axis' ranks."""
    from textreid_torch.config import get_default_cfg
    from textreid_torch.engine import make_train_step
    from textreid_torch.engine.steps import encode_step
    from textreid_torch.models import model as model_module
    from textreid_torch.models.m_resnet import ModifiedResNet
    from textreid_torch.parallel import mesh as dp
    from textreid_torch.utils.checkpoint import Checkpointer

    if "rn_spec" in p:
        model_module.build_m_resnet = lambda cfg: ModifiedResNet(
            **p["rn_spec"])
    out = {}
    for name, run in p["runs"].items():
        cfg = get_default_cfg()
        cfg.merge_from_other(run["cfg"])
        state = _state({**p, "pieces": run["pieces"]}, cfg)
        num_data, num_model, num_slices = run["mesh"]
        mesh = dp.make_mesh(num_data, num_model, num_slices=num_slices)
        dp.shard_state(state, mesh, optimizer_sharding=run.get("zero", False),
                       min_zero1_elems=run.get("min_zero1",
                                               dp.MIN_ZERO1_ELEMS))
        step = make_train_step(cfg)
        shard = (dp.data_rank(), dp.data_size())
        record = {"axes": {a: dp.axis(a).ranks for a in (
                      dp.DATA_AXIS, dp.MODEL_AXIS, dp.SLICE_AXIS,
                      dp.BATCH_AXES)},
                  "shard": shard,
                  "shapes": {n: tuple(q.shape) for n, q in
                             state.model.named_parameters()},
                  "tp": dict(state.sharding.tp) if state.sharding else {},
                  "zero": dict(state.sharding.zero) if state.sharding
                  else {}, "steps": []}
        for i, batch in enumerate(run["batches"]):
            if i == 1 and run.get("checkpoint"):
                os.makedirs(os.path.dirname(run["checkpoint"]),
                            exist_ok=True)
                saver = Checkpointer(os.path.dirname(run["checkpoint"]))
                saver.save("step1", state)
                saver.wait()
                before = state.state_dict()
            metrics = step(state, _torch_batch(_rows(batch, *shard)))
            record["steps"].append({
                "metrics": {k: float(v) for k, v in metrics.items()},
                "grads": _full_grads(state), "state": state.state_dict()})
        record["opt_bytes"] = sum(
            v.numel() * v.element_size()
            for slot in state.optimizer.state.values()
            for v in slot.values()
            if isinstance(v, torch.Tensor) and v.dim() > 0)
        if run.get("checkpoint"):
            saver.resume(saver.path("step1"), state)
            record["resumed_equal"] = all(
                torch.equal(a, b) for a, b in zip(
                    state.state_dict()["model"].values(),
                    before["model"].values()))
            metrics = step(state, _torch_batch(_rows(run["batches"][1],
                                                     *shard)))
            record["resumed"] = {
                "metrics": {k: float(v) for k, v in metrics.items()},
                "state": state.state_dict()}
        if "encode" in run:
            state.model.eval()
            v, t = encode_step(state.model, {
                k: torch.from_numpy(run["encode"][k])
                for k in ("pixels", "token_ids", "lengths")})
            record["encode"] = (v.clone(), t.clone())
        out[name] = record
    return out


def task_gallery(p, rank, world):
    """``sharded_topk_retrieval`` and its int8 composition over the
    process-group mesh of every rank, each rank holding its block:
    ``{(quantize, k): (scores, rows)}`` on every rank."""
    from textreid_torch.evaluation.retrieval import (
        shard_rows,
        sharded_topk_retrieval,
        sharded_topk_retrieval_quantized,
    )
    from textreid_torch.ops.quant import QuantizedGallery, quantize_rows
    from textreid_torch.parallel import make_mesh

    mesh = make_mesh(0)
    gallery = torch.from_numpy(p["gallery"])
    queries = torch.from_numpy(p["queries"]) if rank == 0 else \
        torch.zeros(p["queries"].shape)  # broadcast from data rank 0
    quant = quantize_rows(gallery)
    mine = [QuantizedGallery(*parts) for parts in zip(
        shard_rows(mesh, quant.values), shard_rows(mesh, quant.scales))]
    out = {"shard": shard_rows(mesh, gallery)[0]}
    for k in p["ks"]:
        out[False, k] = sharded_topk_retrieval(mesh, queries, gallery, k=k)
        out[True, k] = sharded_topk_retrieval_quantized(mesh, queries, mine,
                                                        k=k)
    return out


def task_main(p, rank, world):
    """``textreid_torch.<p["module"]>.main(p["argv"] + the store)``; with
    ``p["sigterm"] = (rank, iteration)`` that rank sends itself SIGTERM
    when it starts that iteration's step."""
    import importlib

    from textreid_torch import engine

    sigterm = p.get("sigterm")
    if sigterm is not None and sigterm[0] == rank:
        make = engine.make_train_step

        def make_counting(cfg):
            step, calls = make(cfg), [0]

            def counted(state, batch):
                calls[0] += 1
                if calls[0] == sigterm[1]:
                    os.kill(os.getpid(), signal.SIGTERM)
                return step(state, batch)
            return counted

        engine.make_train_step = make_counting
    module = importlib.import_module(f"textreid_torch.{p['module']}")
    result = module.main(["--init-method", p["init_method"]] + p["argv"])
    if p["module"] == "train_net":
        state, meters = result
        return {"state": state.state_dict(), "step": state.step}
    return {"top1": result}


def main():
    task, in_path, out_dir = sys.argv[1:4]
    torch.set_num_threads(2)
    p = torch.load(in_path, weights_only=False)
    rank, world = int(os.environ["RANK"]), int(os.environ["WORLD_SIZE"])
    from textreid_torch.parallel import mesh

    mesh.TIMEOUT_S = GLOO_TIMEOUT_S
    if task != "main":
        mesh.init_process_group("cpu", p["init_method"])
    out = globals()[f"task_{task}"](p, rank, world)
    if task != "main":
        mesh.destroy_process_group()
    torch.save(out, os.path.join(out_dir, f"rank{rank}.pt"))
    loaded = sorted(m for m in sys.modules if m == "jax" or m.startswith(
        ("jax.", "textreid_tpu")))
    assert not loaded, loaded


if __name__ == "__main__":
    main()
