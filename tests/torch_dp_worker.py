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
  ``test_net``), optionally sending SIGTERM to itself at one iteration.

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
