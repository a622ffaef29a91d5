"""The ``train`` driver: the MoCo step that ``textreid_torch.engine.
make_train_step`` builds, driven closed-loop over a ring of batches held
on the card.

Set-up builds one train state from the run's weights and queues, takes
its first steps (the readings the correctness check compares: each
step's loss, step 1's gradients from Adam's first moment, each leaf's
change after the steps), warms up over the rest of the ring and hands
that same state to the window.  The window dispatches steps back to back
until ``--seconds`` have passed on the host's clock and ends when the card
has finished them: ``train_img_per_s`` is every row of every step over
that time."""

from __future__ import annotations

import time
from statistics import median

import torch

from benchmark.harness import flops, inputs, judge, trace
from benchmark.harness.program import launch_counts, load_weights, program_cfg
from benchmark.reference import model as reference


class TrainSide:
    """The program's train state, built from the run's inputs."""

    def __init__(self, run):
        import textreid_torch.engine as engine
        from textreid_torch.models import build_model
        from textreid_torch.solver import make_optimizer, set_learning_rate
        from textreid_torch.utils.platform import compute_dtype

        cfg = program_cfg(run.config)
        model = build_model(cfg, run.device, torch.float32,
                            compute_dtype(cfg, run.device), train=True)
        load_weights(model, run.weights())
        optimizer = make_optimizer(cfg, model)
        set_learning_rate(optimizer, run.lr)
        self.state = engine.create_train_state(
            cfg, model, optimizer, cfg.SOLVER.IMS_PER_BATCH)
        queues = inputs.make_queues(run.ref_cfg, run.seed, run.device)
        self.state.v_queue.copy_(queues["v"])
        self.state.t_queue.copy_(queues["t"])
        self.state.id_queue.copy_(queues["ids"])
        self.step = run.hooks.get("step", lambda s: s)(
            engine.make_train_step(cfg))

    def readings(self, ring, steps: int, weights_fn) -> dict:
        """The first ``steps`` steps, on ``ring[:steps]``, and what they
        leave: each step's loss, step 1's gradient norms (Adam's first
        moment over ``1 - beta1``), each leaf's change after them and the
        MoCo queues they leave, on the host."""
        state = self.state
        named = dict(state.model.named_parameters())
        loss, grad = [], {}
        for i in range(steps):
            loss.append(float(self.step(state, ring[i])["loss"]))
            if i == 0:
                for group in state.optimizer.param_groups:
                    for p in group["params"]:
                        moment = state.optimizer.state.get(p, {}).get(
                            "exp_avg")
                        if moment is not None:
                            grad[id(p)] = (moment / (1.0 - group["betas"][0])
                                           ).cpu()
                grad = {name: grad.get(id(p), torch.zeros(p.shape))
                        for name, p in named.items()}
        start = weights_fn()
        delta = {name: (p.detach() - start[name]).cpu()
                 for name, p in named.items()}
        del start
        queue = torch.cat([state.v_queue, state.t_queue]).cpu()
        return {"loss": loss, "grad": grad, "delta": delta, "queue": queue}


def reference_readings(run, ring, precision: str) -> dict:
    """The plain reference's first steps on the same inputs."""
    prev = (torch.backends.cuda.matmul.allow_tf32,
            torch.backends.cudnn.allow_tf32)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    try:
        return reference.train_steps(
            run.ref_cfg, run.weights(),
            inputs.make_queues(run.ref_cfg, run.seed, run.device),
            ring[:run.traffic["steps_read"]],
            reference.Precision(precision), run.lr)
    finally:
        (torch.backends.cuda.matmul.allow_tf32,
         torch.backends.cudnn.allow_tf32) = prev


def execute(run) -> dict:
    """Set-up, window, trace (``--trace 1``) and the comparison of one
    run; returns the result's pieces."""
    mix = run.traffic
    ring = inputs.train_ring(mix, run.ref_cfg, run.seed, run.device)
    side = TrainSide(run)
    program = side.readings(ring, mix["steps_read"], run.weights)
    n_ring = len(ring)
    for i in range(mix["steps_read"], mix["steps_read"] + mix["warmup_steps"]):
        side.step(side.state, ring[i % n_ring])
    run.synchronize()
    run.reset_peak()
    run.setup_s = time.perf_counter() - run.t0

    at = mix["steps_read"] + mix["warmup_steps"]
    before = launch_counts()
    steps, start = 0, time.perf_counter()
    deadline = start + run.seconds
    while True:
        side.step(side.state, ring[(at + steps) % n_ring])
        steps += 1
        if time.perf_counter() >= deadline:
            break
    run.synchronize()
    seconds = time.perf_counter() - start
    after = launch_counts()
    rows = run.ref_cfg["SOLVER"]["IMS_PER_BATCH"]
    run.window = {"seconds": seconds, "calls": steps,
                  "flops_per_call": flops.train_step(run.ref_cfg)}
    run.launches = {k: (after[k] - before[k]) / steps for k in before}
    e2e = {"train_img_per_s": steps * rows / seconds,
           "peak_mem_gib": run.peak_bytes() / 2 ** 30}

    if run.trace:
        calls = mix["traced_steps"]
        # per capture: one untraced step, then the traced ones
        run.traced_lengths = [ring[i % n_ring]["lengths"].cpu() for i in
                              range(at + steps + 1, at + steps + calls + 1)]
        for host in (False, True):
            order = iter(range(at + steps, at + steps + calls + 1))
            summary = trace.reduce(trace.capture(
                lambda: side.step(side.state, ring[next(order) % n_ring]),
                calls, host), calls)
            setattr(run, "call_summary" if host else "trace_summary",
                    summary)
        run.traced_calls = calls
    run.memory_peak = run.peak_bytes()

    del side
    run.release()
    want = reference_readings(run, ring, "float32")
    run.numbers = judge.train_numbers(program, want, run.left_out)
    gaps = judge.train_gaps(program, want)
    run.notes = [f"{what} gap, worst leaves: " + ", ".join(
        f"{n} {g:.3g}" for n, g in sorted(gaps[what].items(),
                                         key=lambda kv: -kv[1])[:3])
        for what in ("grad", "delta")]
    run.notes.append(f"losses {program['loss']} (reference {want['loss']})")
    return e2e


def _worst(gaps: dict, n: int = 3) -> list:
    return sorted(([k, v] for k, v in gaps.items()), key=lambda kv: -kv[1])[:n]


def readings(run, seed: int, control: bool, faults: bool, emit) -> None:
    """The program's numbers on ``seed`` without a window (the sound runs'
    lower readings); with ``control``, the reference's in float8
    (``reference.Precision("fp8")``); with ``faults``, each of
    ``FAULTS``'.  Each reading carries every leaf's gradient gap, for the
    look at the worst leaves."""
    ring = inputs.train_ring(run.traffic, run.ref_cfg, seed, run.device)
    steps = run.traffic["steps_read"]
    want = reference_readings(run, ring, "float32")

    def program(hooks):
        run.hooks = hooks
        side = TrainSide(run)
        got = side.readings(ring, steps, run.weights)
        del side
        run.release()
        return got

    def report(what, got):
        gaps = judge.train_gaps(got, want)
        emit({"seed": seed, "what": what,
              "numbers": judge.train_numbers(got, want, run.left_out),
              "loss": got["loss"], "ref_loss": want["loss"],
              "median_grad": median(gaps["grad"].values()),
              "median_update": median(gaps["delta"].values()),
              "worst_grad": _worst(gaps["grad"]),
              "worst_update": _worst(gaps["delta"]),
              "grad_gaps": gaps["grad"]})

    report("program", program({}))
    if control:
        report("control_fp8", reference_readings(run, ring, "fp8"))
    if faults:
        for name, hooks in FAULTS.items():
            report("fault_" + name, program(hooks))


# -- faults planted under the timed path ------------------------------------
# (each a ``hooks`` dict for ``runner.Run``, wrapping the program's train
# step; a one-card cell has no exchange between cards to leave out)

def _unchanged(step):
    """The step's update is lost: the parameters are put back."""
    def faulty(state, batch):
        before = [p.detach().clone() for p in state.model.parameters()]
        out = step(state, batch)
        with torch.no_grad():
            for p, b in zip(state.model.parameters(), before):
                p.copy_(b)
        return out
    return faulty


def _half_batch(step):
    """Half of the batch left out: the step sees its first half rows, and
    its means are taken over them."""
    def faulty(state, batch):
        half = batch["pids"].shape[0] // 2
        return step(state, {k: v[:half] for k, v in batch.items()})
    return faulty


def _update_doubled(step):
    """One leaf's update (the image tower's first convolution) applied
    twice."""
    def faulty(state, batch):
        p = state.model.visual_model.conv1.weight
        before = p.detach().clone()
        out = step(state, batch)
        with torch.no_grad():
            p.add_(p - before)
        return out
    return faulty


FAULTS = {"state_unchanged": {"step": _unchanged},
          "half_batch": {"step": _half_batch},
          "update_doubled": {"step": _update_doubled}}
