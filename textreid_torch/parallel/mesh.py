"""Data parallelism over ``torch.distributed`` (counterpart of
``textreid_tpu/parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` over every device and
writes its train step in *global-batch* semantics: the batch is sharded
over the ``data`` axis, the state is replicated, and XLA inserts the
collectives.  The port runs one process a card (``torchrun --nproc-per-node
N``, or one rank a card of a ``file://`` or ``tcp://`` store), and the step
issues the collectives itself, so that its result is the single-process
step on the global batch:

* the query embeddings are gathered with their gradient
  (:func:`gather_rows`: ``all_gather`` forward, ``all_reduce`` of the
  gradient and the own slice backward), the keys and ids without it, and
  the losses are computed over the global batch on every rank;
* the parameter gradients are all-reduced and *averaged*
  (:func:`all_reduce_grads`): every rank computes the same global loss, so
  the gather's backward sums ``world`` copies of each row's gradient and
  the average takes them back to one;
* training BatchNorm normalises with the global batch's statistics
  (``models/common.py:batch_norm``), and the bi-GRU's "batch" pool rule
  reads the global batch's longest caption (``models/gru.py``);
* :func:`replicate_state` broadcasts rank 0's parameters, buffers,
  optimizer state and queues, so the replicas start identical.

With one rank, or outside a group, none of these issues a collective.

:func:`make_mesh` keeps the JAX function's validation.  Inside a process
group the data axis is the ranks; outside one it is ``devices``, the cards
of this process (the JAX single-controller case, which a sharded serving
gallery uses, ``evaluation/retrieval.py``).  What the JAX mesh also
carries is not ported: the tensor-parallel ``model`` axis (``tp_spec``),
the multi-slice mesh (``_group_by_slice``) and ZeRO-1 optimizer-state
sharding (``zero1_spec``, ``shard_state``) raise ``NotImplementedError``
(:data:`NOT_PORTED`).
"""

from __future__ import annotations

import datetime
import os
from dataclasses import dataclass
from typing import Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"

NOT_PORTED = "ROADMAP Queue A item 11"

# the device collectives run on: the rank's card (NCCL needs one), or the
# CPU under gloo on the CPU; set by init_process_group
_COMM_DEVICE: Optional[torch.device] = None
# seconds a collective waits for the other ranks before it raises
TIMEOUT_S = 1800.0


@dataclass(frozen=True)
class Mesh:
    """The data axis: ``devices`` (one a shard, a card may repeat) when
    ``distributed`` is off, else the ranks of the process group, with
    ``devices`` this rank's card alone."""
    data: int
    devices: tuple
    distributed: bool = False

    @property
    def shape(self) -> dict:
        return {DATA_AXIS: self.data, MODEL_AXIS: 1}


# -- the process group ------------------------------------------------------

def launched_distributed() -> bool:
    """Whether the environment names a process group (``torchrun`` sets
    ``RANK`` and ``WORLD_SIZE``)."""
    return "RANK" in os.environ and "WORLD_SIZE" in os.environ


def init_process_group(device, init_method: Optional[str] = None,
                       backend: Optional[str] = None,
                       timeout_s: Optional[float] = None) -> torch.device:
    """Join the process group of ``RANK`` and ``WORLD_SIZE`` (the
    environment ``torchrun`` sets), at ``init_method`` (``env://``, which
    reads ``MASTER_ADDR`` and ``MASTER_PORT``, when None; the tests give a
    ``file://`` store).  NCCL for a card, gloo for ``--device cpu``
    (``backend`` overrides: two ranks on one card need gloo, NCCL refuses
    them).  A ``cuda`` device without an index becomes ``cuda:LOCAL_RANK``
    and is made current.  A collective waits ``timeout_s`` (default
    :data:`TIMEOUT_S`) for the other ranks, then raises.  Returns the rank's device.  Raises when the
    group does not form; nothing carries on alone."""
    global _COMM_DEVICE
    device = torch.device(device)
    rank = int(os.environ["RANK"])
    world = int(os.environ["WORLD_SIZE"])
    if device.type == "cuda":
        if device.index is None:
            device = torch.device("cuda", int(os.environ.get("LOCAL_RANK",
                                                             rank)))
        torch.cuda.set_device(device)
    if backend is None:
        backend = "nccl" if device.type == "cuda" else "gloo"
    dist.init_process_group(
        backend, init_method=init_method or "env://", rank=rank,
        world_size=world, timeout=datetime.timedelta(
            seconds=TIMEOUT_S if timeout_s is None else timeout_s))
    _COMM_DEVICE = device
    return device


def destroy_process_group() -> None:
    """The exit barrier (no rank tears the group down while another still
    talks to it), then the group's end."""
    if dist.is_available() and dist.is_initialized():
        barrier()
        dist.destroy_process_group()


def is_distributed() -> bool:
    """Inside a process group of more than one rank."""
    return (dist.is_available() and dist.is_initialized()
            and dist.get_world_size() > 1)


def rank() -> int:
    return dist.get_rank() if dist.is_available() and dist.is_initialized() \
        else 0


def world_size() -> int:
    return dist.get_world_size() if dist.is_available() and \
        dist.is_initialized() else 1


def barrier() -> None:
    if is_distributed():
        if dist.get_backend() == "nccl":
            dist.barrier(device_ids=[_COMM_DEVICE.index])
        else:
            dist.barrier()


def _comm(t: torch.Tensor) -> torch.Tensor:
    """``t`` where the backend can reduce it (NCCL: on the rank's card)."""
    if dist.get_backend() == "nccl" and not t.is_cuda:
        return t.to(_COMM_DEVICE)
    return t


def broadcast_object(obj, src: int = 0):
    """``obj`` of rank ``src`` on every rank (pickled); ``obj`` itself
    outside a group."""
    if not is_distributed():
        return obj
    box = [obj]
    dist.broadcast_object_list(box, src=src, device=_COMM_DEVICE if
                               dist.get_backend() == "nccl" else None)
    return box[0]


def all_gather_object(obj) -> list:
    """Every rank's ``obj``, in rank order (``[obj]`` outside a group)."""
    if not is_distributed():
        return [obj]
    out = [None] * dist.get_world_size()
    dist.all_gather_object(out, obj)
    return out


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (an all-reduce MAX)."""
    if not is_distributed():
        return flag
    t = _comm(torch.tensor([int(flag)], dtype=torch.int32))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


# -- the mesh ---------------------------------------------------------------

def make_mesh(num_data: int = 0, num_model: int = 1, devices=None,
              num_slices: int = 1) -> Mesh:
    """The data mesh (``num_data=0``: every rank, or every device).

    The JAX function's validation: ``num_data x num_model`` more than the
    ranks (devices) raises ``ValueError``.  Inside a process group the data
    axis is every rank, so ``num_data`` is 0 or the world size
    (``TPU.DATA_PARALLEL``); outside one ``devices`` defaults to this
    process's cards.  A model axis, several slices: ``NotImplementedError``
    (:data:`NOT_PORTED`)."""
    num_model = max(int(num_model), 1)
    if max(int(num_slices), 1) > 1:
        raise NotImplementedError(
            f"TPU.NUM_SLICES={num_slices}: the multi-slice (slice, data, "
            f"model) mesh is not ported ({NOT_PORTED})")
    distributed = dist.is_available() and dist.is_initialized()
    if distributed:
        pool = [None] * dist.get_world_size()
    else:
        pool = list(devices if devices is not None else (
            torch.device("cuda", i) for i in range(torch.cuda.device_count())))
    if num_data <= 0:
        num_data = len(pool) // num_model
    need = num_data * num_model
    if need == 0 or need > len(pool):
        raise ValueError(
            f"Requested a {num_data}x{num_model} (data x model) mesh but "
            f"only {len(pool)} {'ranks' if distributed else 'devices'} are "
            "visible")
    if num_model > 1:
        raise NotImplementedError(
            f"TPU.MODEL_PARALLEL={num_model}: FFN tensor parallelism "
            f"(tp_spec) is not ported ({NOT_PORTED})")
    if distributed:
        if num_data != len(pool):
            raise ValueError(
                f"TPU.DATA_PARALLEL={num_data}: the data axis is every rank "
                f"of the process group; give 0 or the world size "
                f"{len(pool)}")
        return Mesh(num_data, (_COMM_DEVICE,), True)
    return Mesh(num_data, tuple(torch.device(d) for d in pool[:num_data]))


def refuse_optimizer_sharding(cfg) -> None:
    if cfg.TPU.OPTIMIZER_SHARDING:
        raise NotImplementedError(
            "TPU.OPTIMIZER_SHARDING: ZeRO-1 optimizer-state sharding "
            f"(zero1_spec, shard_state) is not ported ({NOT_PORTED})")


def data_shard_count(mesh: Mesh) -> int:
    """Number of batch shards."""
    return mesh.shape[DATA_AXIS]


def local_batch_size(global_batch: int, mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return global_batch
    n = data_shard_count(mesh)
    if global_batch % n != 0:
        raise ValueError(
            f"Global batch {global_batch} not divisible by data-shard "
            f"count {n}")
    return global_batch // n


# -- collectives of the train step ------------------------------------------

def _gather(x: torch.Tensor) -> torch.Tensor:
    x = x.contiguous()
    parts = [torch.empty_like(x) for _ in range(dist.get_world_size())]
    dist.all_gather(parts, x)
    return torch.cat(parts)


class _GatherRows(torch.autograd.Function):
    """Rows of every rank, in rank order; the gradient is the sum over the
    ranks of the gradient of this rank's rows (an all-reduce, then the own
    slice: an all-reduce because gloo has no reduce-scatter)."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _gather(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad)
        start = dist.get_rank() * ctx.rows
        return grad[start:start + ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of ``x``, rank-major, differentiable (``x`` itself
    outside a group)."""
    if not is_distributed():
        return x
    return _GatherRows.apply(x)


def gather_columns(tensors: Sequence[torch.Tensor], grad: bool = True):
    """:func:`gather_rows` of each of ``tensors`` (``[n, d_i]``, one dtype)
    in one collective: concatenated along the columns, gathered, split."""
    tensors = tuple(tensors)
    if not is_distributed():
        return tensors
    widths = [t.shape[1] for t in tensors]
    joined = torch.cat(tensors, dim=1)
    out = gather_rows(joined) if grad else _gather(joined.detach())
    return tuple(out.split(widths, dim=1))


def gather_ids(ids: torch.Tensor) -> torch.Tensor:
    """Every rank's ``ids``, rank-major, without a gradient."""
    return _gather(ids) if is_distributed() else ids


def all_gather_stats(x: torch.Tensor) -> torch.Tensor:
    """``[world, *x.shape]``: every rank's ``x`` (no gradient)."""
    return _gather(x[None])


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The largest of every rank's ``x`` (a copy; ``x`` outside a
    group)."""
    if not is_distributed():
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX)
    return x


def all_reduce_sum_(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the ranks, in place; returns it."""
    if is_distributed():
        dist.all_reduce(x)
    return x


BUCKET_BYTES = 64 << 20


def all_reduce_grads(params, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Average the ``.grad`` of ``params`` over the ranks, in buckets of
    about ``bucket_bytes`` flattened per dtype (no-op outside a group)."""
    if not is_distributed():
        return
    world = dist.get_world_size()
    grads = [p.grad for p in params if p.grad is not None]
    buckets, sizes = {}, {}
    for g in grads:
        key = (g.dtype, g.device)
        if sizes.get(key, 0) + g.numel() * g.element_size() > bucket_bytes \
                and buckets.get(key):
            _reduce_bucket(buckets.pop(key), world)
            sizes[key] = 0
        buckets.setdefault(key, []).append(g)
        sizes[key] = sizes.get(key, 0) + g.numel() * g.element_size()
    for bucket in buckets.values():
        _reduce_bucket(bucket, world)


def _reduce_bucket(grads, world: int) -> None:
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat)
    flat.div_(world)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


def _broadcast_(t: torch.Tensor, src: int = 0) -> None:
    """Overwrite ``t`` with rank ``src``'s, in place."""
    on_comm = _comm(t)
    dist.broadcast(on_comm, src)
    if on_comm is not t:
        t.copy_(on_comm)


@torch.no_grad()
def replicate_state(state, src: int = 0) -> None:
    """Rank ``src``'s training state on every rank, in place: the query
    and key models' parameters and buffers, the optimizer's state, the
    queues, the pointer and the step (the counterpart of JAX's
    ``replicate_state``; no-op outside a group)."""
    if not is_distributed():
        return
    for model in (state.model, state.key_model):
        if model is None:
            continue
        for t in list(model.parameters()) + list(model.buffers()):
            _broadcast_(t.data, src)
    for group in state.optimizer.param_groups:
        for p in group["params"]:
            slots = state.optimizer.state.get(p, {})
            for name in sorted(slots):
                if isinstance(slots[name], torch.Tensor):
                    _broadcast_(slots[name], src)
    for name in ("v_queue", "t_queue", "id_queue"):
        if getattr(state, name) is not None:
            _broadcast_(getattr(state, name), src)
    counters = torch.tensor([state.step, state.queue_ptr], dtype=torch.long)
    _broadcast_(counters, src)
    state.step, state.queue_ptr = (int(v) for v in counters)
