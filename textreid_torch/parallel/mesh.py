"""The mesh over ``torch.distributed`` (counterpart of
``textreid_tpu/parallel/mesh.py``).

The JAX package builds one ``jax.sharding.Mesh`` over every device, with
a ``data`` axis, a ``model`` axis and, across slices, a ``slice`` axis,
and writes its train step in *global-batch* semantics: the batch is
sharded over the data axes, the state is placed by ``shard_state`` and XLA
inserts the collectives.  The port runs one process a card (``torchrun
--nproc-per-node N``, or one rank a card of a ``file://`` or ``tcp://``
store), and the step issues the collectives itself, so that its result is
the single-process step on the global batch.

The mesh (:func:`make_mesh`) lays the ranks out as JAX lays its devices
out, ``(slice, data, model)`` with the model index fastest, and makes one
``torch.distributed`` group for each line of each axis, in the same order
on every rank: the **data group** (the ranks of one slice with the same
model index), the **model group** (one slice, one data index) and the
**slice group** (one data and model index).  The batch is sharded over the
data axes, ``(slice, data)`` jointly (:func:`data_rank`,
:func:`data_size`): the ranks of one model group hold the same rows.

* The query embeddings are gathered over the data axes with their gradient
  (:func:`gather_rows`: ``all_gather`` forward, ``all_reduce`` of the
  gradient and the own slice backward), the keys and ids without it, and
  the losses are computed over the global batch on every rank.
* Training BatchNorm normalises with the global batch's statistics
  (``models/common.py:batch_norm``), and the bi-GRU's "batch" pool rule
  reads the global batch's longest caption (``models/gru.py``), both over
  the data axes.
* The parameter gradients are averaged over the data axes
  (:func:`all_reduce_grads`): within the data group, then across the slice
  group.  Every rank computes the same global loss, so the gather's
  backward sums the data shards' copies of each row's gradient and the
  average takes them back to one.
* The model axis carries Megatron's FFN split of every
  ``TransformerBlock`` (:func:`tp_spec`; Shoeybi et al. 2019): ``c_fc``
  keeps the rank's ``4W / m`` output features, ``c_proj`` the matching
  input features, and the block's FFN enters through :func:`to_model_parallel`
  (*f*: identity forward, the gradient all-reduced over the model group
  backward) and leaves through :func:`from_model_parallel` (*g*: the partial
  sums all-reduced forward, identity backward), ``c_proj``'s bias added
  once after it (``models/vit.py``).  Every rank of a model group then
  holds the same gradient for a replicated leaf, and a split leaf's
  gradient is its own part's: neither is reduced over the model group.
  Attention stays replicated, as in JAX (its module docstring gives why).
* ZeRO-1 (:func:`zero1_spec`; Rajbhandari et al. 2019): each rank of a
  data group keeps the optimizer's moments of its part of each leaf only,
  updates that part and the all-gather over the data group rebuilds the
  parameter (``solver/build.py:Zero1Optimizer``).  On a multi-slice mesh
  the part is over the inner data axis only, as JAX's.
* :func:`shard_state` broadcasts rank 0's state, then keeps each rank's
  shard; a checkpoint holds the single-process layout
  (:class:`StateSharding`: gathered to save, split again to load).

With one rank, or outside a group, none of these issues a collective.
Outside a group the mesh is a list of devices, this process's cards (the
JAX single-controller case, which a sharded serving gallery uses,
``evaluation/retrieval.py``).
"""

from __future__ import annotations

import datetime
import math
import os
import re
from dataclasses import dataclass, field
from typing import Dict, List, Optional, Sequence

import torch
import torch.distributed as dist

DATA_AXIS = "data"
MODEL_AXIS = "model"
SLICE_AXIS = "slice"
# the data axes jointly, (slice, data): the axis the batch is sharded over
BATCH_AXES = "batch"

# the device collectives run on: the rank's card (NCCL needs one), or the
# CPU under gloo on the CPU; set by init_process_group
_COMM_DEVICE: Optional[torch.device] = None
# the axes of the process-group mesh made last (make_mesh), by name
_AXES: Optional[Dict[str, "Axis"]] = None
# seconds a collective waits for the other ranks before it raises
TIMEOUT_S = 1800.0


@dataclass(frozen=True)
class Mesh:
    """``(slice, data, model)``: ``devices`` (every device of the mesh,
    slice-major, the model index fastest; a card may repeat) when
    ``distributed`` is off, else the ranks of the process group laid out
    the same way, with ``devices`` this rank's card alone (its axes:
    :func:`axis`)."""
    data: int
    devices: tuple
    distributed: bool = False
    model: int = 1
    slices: int = 1

    @property
    def shape(self) -> dict:
        shape = {DATA_AXIS: self.data, MODEL_AXIS: self.model}
        return {SLICE_AXIS: self.slices, **shape} if self.slices > 1 \
            else shape

    @property
    def shard_devices(self) -> tuple:
        """The device of each data shard (slice 0, model index 0): where
        a gallery sharded over ``data`` and replicated over the rest is
        held."""
        return self.devices[::self.model][:self.data]


@dataclass(frozen=True)
class Axis:
    """One line of a process-group mesh through this rank: the global
    ``ranks`` along it, in axis order, this rank's ``index`` and the group
    (``None``: the world's)."""
    ranks: tuple
    index: int
    group: object = field(default=None, compare=False, repr=False)

    @property
    def size(self) -> int:
        return len(self.ranks)


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
    global _COMM_DEVICE, _AXES
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
    _AXES = None
    return device


def destroy_process_group() -> None:
    """The exit barrier (no rank tears the group down while another still
    talks to it), then the group's end."""
    global _AXES
    if dist.is_available() and dist.is_initialized():
        barrier()
        dist.destroy_process_group()
    _AXES = None


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


def all_gather_object(obj, along: Optional["Axis"] = None) -> list:
    """Every rank's ``obj`` along the axis ``along`` (every rank when
    None), in its order (``[obj]`` outside a group)."""
    ax = along or _world_axis()
    if ax.size == 1:
        return [obj]
    out = [None] * ax.size
    dist.all_gather_object(out, obj, group=ax.group)
    return _in_axis_order(out, ax)


def any_rank(flag: bool) -> bool:
    """Whether ``flag`` is set on any rank (an all-reduce MAX)."""
    if not is_distributed():
        return flag
    t = _comm(torch.tensor([int(flag)], dtype=torch.int32))
    dist.all_reduce(t, op=dist.ReduceOp.MAX)
    return bool(t.item())


# -- the mesh ---------------------------------------------------------------

def _group_by_slice(items: list, slice_ids: Sequence, num_slices: int):
    """Order ``items`` so each slice's members are contiguous (JAX's
    ``_group_by_slice``): grouped by ``slice_ids`` when every item has one
    (torchrun's ``GROUP_RANK``: a slice is a node), the count matches and
    the slices are equal; otherwise contiguous blocks in the given order,
    which must split evenly."""
    if all(i is not None for i in slice_ids) and \
            len(set(slice_ids)) == num_slices:
        order = {s: k for k, s in enumerate(sorted(set(slice_ids)))}
        groups = [[] for _ in range(num_slices)]
        for item, i in zip(items, slice_ids):
            groups[order[i]].append(item)
        if len({len(g) for g in groups}) == 1:
            return [item for g in groups for item in g]
    if len(items) % num_slices != 0:
        raise ValueError(
            f"{len(items)} devices do not split into {num_slices} equal "
            "slices")
    return list(items)


def make_mesh(num_data: int = 0, num_model: int = 1, devices=None,
              num_slices: int = 1) -> Mesh:
    """The ``(slice, data, model)`` mesh (``num_data=0``: fill with every
    rank, or every device), with the JAX function's validation and
    messages: ``num_data x num_model`` more than the ranks (devices) of a
    slice raises ``ValueError``.  Several slices group the ranks by
    torchrun's ``GROUP_RANK`` (the devices: in contiguous blocks) first.

    Inside a process group the mesh must hold every rank (the port cannot
    leave one idle): ``num_data`` is 0 or the world size over the model
    axis and the slices; the axes' groups are made here, on every rank in
    the same order, and :func:`axis` returns them.  Outside one
    ``devices`` defaults to this process's cards."""
    global _AXES
    num_model = max(int(num_model), 1)
    num_slices = max(int(num_slices), 1)
    distributed = dist.is_available() and dist.is_initialized()
    if distributed:
        pool = list(range(dist.get_world_size()))
        slice_ids = all_gather_object(os.environ.get("GROUP_RANK")) \
            if num_slices > 1 else [None] * len(pool)
    else:
        pool = list(devices if devices is not None else (
            torch.device("cuda", i) for i in range(torch.cuda.device_count())))
        slice_ids = [None] * len(pool)
    what = "ranks" if distributed else "devices"
    if num_slices == 1:
        if num_data <= 0:
            num_data = len(pool) // num_model
        need = num_data * num_model
        if need == 0 or need > len(pool):
            raise ValueError(
                f"Requested a {num_data}x{num_model} (data x model) mesh but "
                f"only {len(pool)} {what} are visible")
        picked = pool[:need]
    else:
        pool = _group_by_slice(pool, slice_ids, num_slices)
        per_slice = len(pool) // num_slices
        if num_data <= 0:
            num_data = per_slice // num_model
        need = num_data * num_model
        if need == 0 or need > per_slice:
            raise ValueError(
                f"Requested {num_slices} x ({num_data}x{num_model}) (slice x "
                f"data x model) but each slice has only {per_slice} {what}")
        picked = [d for s in range(num_slices)
                  for d in pool[s * per_slice:s * per_slice + need]]
    if not distributed:
        return Mesh(num_data, tuple(torch.device(d) for d in picked),
                    model=num_model, slices=num_slices)
    if len(picked) != len(pool):
        per = len(pool) // (num_model * num_slices)
        raise ValueError(
            f"TPU.DATA_PARALLEL={num_data}: the data axis is every rank "
            f"of the process group; give 0 or the world size "
            f"{len(pool)}" + ("" if num_model * num_slices == 1 else
                              f" over the model axis and the slices, {per}"))
    _AXES = _make_axes(picked, num_slices, num_data, num_model)
    return Mesh(num_data, (_COMM_DEVICE,), True, num_model, num_slices)


def _make_axes(layout: list, slices: int, data: int, model: int) -> dict:
    """The groups of every line of every axis of the ``layout`` (global
    ranks, slice-major), made in one order on every rank; this rank's
    line of each."""
    def coords(k):
        return k // (data * model), (k // model) % data, k % model

    at = {c: r for c, r in ((coords(k), r) for k, r in enumerate(layout))}
    me = coords(layout.index(dist.get_rank()))
    lines = {  # axis: (the varying coordinates, the fixed ones of a line)
        DATA_AXIS: lambda s, d, m, i: (s, i, m),
        MODEL_AXIS: lambda s, d, m, i: (s, d, i),
        SLICE_AXIS: lambda s, d, m, i: (i, d, m),
        BATCH_AXES: lambda s, d, m, i: (i // data, i % data, m),
    }
    sizes = {DATA_AXIS: data, MODEL_AXIS: model, SLICE_AXIS: slices,
             BATCH_AXES: slices * data}
    world = dist.get_world_size()
    axes, made = {}, {}
    for name, line in lines.items():
        for s in range(slices):
            for d in range(data):
                for m in range(model):
                    ranks = tuple(at[line(s, d, m, i)]
                                  for i in range(sizes[name]))
                    if ranks in made or len(ranks) in (1, world):
                        continue
                    made[ranks] = dist.new_group(sorted(ranks))
        ranks = tuple(at[line(*me, i)] for i in range(sizes[name]))
        group = None if len(ranks) in (1, world) else made[ranks]
        axes[name] = Axis(ranks, ranks.index(dist.get_rank()), group)
    return axes


def _world_axis() -> Axis:
    return Axis(tuple(range(world_size())), rank())


def axis(name: str = BATCH_AXES) -> Axis:
    """This rank's line of the mesh's axis ``name`` (:data:`DATA_AXIS`,
    :data:`MODEL_AXIS`, :data:`SLICE_AXIS`, or :data:`BATCH_AXES`: the
    data axes jointly).  Before :func:`make_mesh`, or outside a group, the
    data axes are every rank and the others this rank alone."""
    if _AXES is not None:
        return _AXES[name]
    if name in (DATA_AXIS, BATCH_AXES):
        return _world_axis()
    return Axis((rank(),), 0)


def data_rank() -> int:
    """This rank's data shard: which rows of a global batch it holds."""
    return axis(BATCH_AXES).index


def data_size() -> int:
    """The number of data shards (slice x data) of the process group."""
    return axis(BATCH_AXES).size


def data_distributed() -> bool:
    """Whether the batch is sharded over more than one rank."""
    return data_size() > 1


def data_axes(mesh: Mesh) -> tuple:
    """Mesh axes the batch shards over: ``(slice, data)`` on a
    hierarchical mesh, ``(data,)`` on a flat one."""
    return (SLICE_AXIS, DATA_AXIS) if mesh.slices > 1 else (DATA_AXIS,)


def data_shard_count(mesh: Mesh) -> int:
    """Number of batch shards (product of the data-carrying axes)."""
    return math.prod(mesh.shape[a] for a in data_axes(mesh))


def local_batch_size(global_batch: int, mesh: Optional[Mesh]) -> int:
    if mesh is None:
        return global_batch
    n = data_shard_count(mesh)
    if global_batch % n != 0:
        raise ValueError(
            f"Global batch {global_batch} not divisible by data-shard "
            f"count {n}")
    return global_batch // n


# -- collectives along an axis ------------------------------------------------

def _in_axis_order(parts: list, ax: Axis) -> list:
    """A group's outputs (in the order of its sorted ranks) in the axis'
    order."""
    ranked = sorted(ax.ranks)
    return [parts[ranked.index(r)] for r in ax.ranks]


def all_gather_along(x: torch.Tensor, ax: Axis) -> List[torch.Tensor]:
    """Every rank's ``x`` along ``ax``, in its order."""
    x = x.contiguous()
    if ax.size == 1:
        return [x]
    parts = [torch.empty_like(x) for _ in range(ax.size)]
    dist.all_gather(parts, x, group=ax.group)
    return _in_axis_order(parts, ax)


def gather_split(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """The whole of a tensor split over ``ax`` along ``dim``."""
    return torch.cat(all_gather_along(x, ax), dim=dim)


def shard_of(x: torch.Tensor, dim: int, ax: Axis) -> torch.Tensor:
    """This rank's part of ``x`` split evenly over ``ax`` along ``dim`` (a
    view)."""
    if x.shape[dim] % ax.size:
        raise ValueError(f"dimension {dim} of a {tuple(x.shape)} tensor "
                         f"does not split over {ax.size} ranks")
    n = x.shape[dim] // ax.size
    return x.narrow(dim, ax.index * n, n)


def _gather(x: torch.Tensor) -> torch.Tensor:
    return torch.cat(all_gather_along(x, axis(BATCH_AXES)))


class _GatherRows(torch.autograd.Function):
    """Rows of every data shard, in shard order; the gradient is the sum
    over the shards of the gradient of this rank's rows (an all-reduce,
    then the own slice: an all-reduce because gloo has no
    reduce-scatter)."""

    @staticmethod
    def forward(ctx, x):
        ctx.rows = x.shape[0]
        return _gather(x)

    @staticmethod
    def backward(ctx, grad):
        ax = axis(BATCH_AXES)
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=ax.group)
        start = ax.index * ctx.rows
        return grad[start:start + ctx.rows]


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every data shard's rows of ``x``, shard-major, differentiable
    (``x`` itself with one shard)."""
    if not data_distributed():
        return x
    return _GatherRows.apply(x)


def gather_columns(tensors: Sequence[torch.Tensor], grad: bool = True):
    """:func:`gather_rows` of each of ``tensors`` (``[n, d_i]``, one dtype)
    in one collective: concatenated along the columns, gathered, split."""
    tensors = tuple(tensors)
    if not data_distributed():
        return tensors
    widths = [t.shape[1] for t in tensors]
    joined = torch.cat(tensors, dim=1)
    out = gather_rows(joined) if grad else _gather(joined.detach())
    return tuple(out.split(widths, dim=1))


def gather_ids(ids: torch.Tensor) -> torch.Tensor:
    """Every data shard's ``ids``, shard-major, without a gradient."""
    return _gather(ids) if data_distributed() else ids


def all_gather_stats(x: torch.Tensor) -> torch.Tensor:
    """``[shards, *x.shape]``: every data shard's ``x`` (no gradient)."""
    return _gather(x[None])


def global_max(x: torch.Tensor) -> torch.Tensor:
    """The largest of every data shard's ``x`` (a copy; ``x`` with one
    shard)."""
    if not data_distributed():
        return x
    x = x.clone()
    dist.all_reduce(x, op=dist.ReduceOp.MAX, group=axis(BATCH_AXES).group)
    return x


def all_reduce_sum_(x: torch.Tensor) -> torch.Tensor:
    """Sum ``x`` over the data shards, in place; returns it."""
    if data_distributed():
        dist.all_reduce(x, group=axis(BATCH_AXES).group)
    return x


BUCKET_BYTES = 64 << 20


def all_reduce_grads(params, bucket_bytes: int = BUCKET_BYTES) -> None:
    """Average the ``.grad`` of ``params`` over the data shards, in buckets
    of about ``bucket_bytes`` flattened per dtype: summed within the data
    group, then across the slice group, then divided (no-op with one
    shard).  Not over the model group: its ranks hold the same gradient of
    a replicated leaf, and each its own part of a split one."""
    n = data_size()
    if n == 1:
        return
    grads = [p.grad for p in params if p.grad is not None]
    buckets, sizes = {}, {}
    for g in grads:
        key = (g.dtype, g.device)
        if sizes.get(key, 0) + g.numel() * g.element_size() > bucket_bytes \
                and buckets.get(key):
            _reduce_bucket(buckets.pop(key), n)
            sizes[key] = 0
        buckets.setdefault(key, []).append(g)
        sizes[key] = sizes.get(key, 0) + g.numel() * g.element_size()
    for bucket in buckets.values():
        _reduce_bucket(bucket, n)


def _reduce_bucket(grads, n: int) -> None:
    flat = torch.cat([g.reshape(-1) for g in grads])
    for name in (DATA_AXIS, SLICE_AXIS):
        ax = axis(name)
        if ax.size > 1:
            dist.all_reduce(flat, group=ax.group)
    flat.div_(n)
    for g, part in zip(grads, flat.split([g.numel() for g in grads])):
        g.copy_(part.view_as(g))


# -- the model axis: Megatron's f and g -------------------------------------

class _ToModelParallel(torch.autograd.Function):
    """*f*: identity forward; the gradient all-reduced over the model
    group backward (each rank's FFN part contributes its share)."""

    @staticmethod
    def forward(ctx, x):
        return x.view_as(x)

    @staticmethod
    def backward(ctx, grad):
        grad = grad.contiguous().clone()
        dist.all_reduce(grad, group=axis(MODEL_AXIS).group)
        return grad


class _FromModelParallel(torch.autograd.Function):
    """*g*: the model group's partial sums all-reduced forward; identity
    backward."""

    @staticmethod
    def forward(ctx, x):
        x = x.contiguous().clone()
        dist.all_reduce(x, group=axis(MODEL_AXIS).group)
        return x

    @staticmethod
    def backward(ctx, grad):
        return grad


def to_model_parallel(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *f* at the entry of a split FFN."""
    return _ToModelParallel.apply(x)


def from_model_parallel(x: torch.Tensor) -> torch.Tensor:
    """Megatron's *g* at the exit of a split FFN."""
    return _FromModelParallel.apply(x)


# -- placements --------------------------------------------------------------

# Megatron's FFN split on the port's parameter names, inside a
# TransformerBlock (``...resblocks.<i>.``) only: CLIP's attention pool also
# names its output projection ``c_proj`` (models/m_resnet.py), and that
# per-sample matvec is not worth a split.  nn.Linear stores [out, in], the
# transpose of flax's kernel: c_fc splits its output features (dim 0 here,
# dim 1 of JAX's kernel), c_proj its input features (dim 1 here); c_proj's
# bias stays whole (added after the reduce).
_TP_RULE = re.compile(
    r"(?:^|\.)resblocks\.\d+\.mlp\.(c_fc\.weight|c_fc\.bias|c_proj\.weight)$")
_TP_DIMS = {"c_fc.weight": (2, 0), "c_fc.bias": (1, 0),
            "c_proj.weight": (2, 1)}

# ZeRO-1: leaves below this element count stay whole (sharding a
# BN-scale-sized tensor buys bytes nobody needs and costs a collective)
MIN_ZERO1_ELEMS = 8192


def tp_spec(name: str, shape: Sequence[int]) -> Optional[int]:
    """The dimension of the parameter ``name`` (of ``shape``) the model
    axis splits, or None for a replicated one (JAX's ``tp_spec`` on the
    port's layout)."""
    m = _TP_RULE.search(name)
    if m is None:
        return None
    ndim, dim = _TP_DIMS[m.group(1)]
    return dim if len(shape) == ndim else None


def jax_dim_order(model: torch.nn.Module, name: str) -> tuple:
    """The port's dimensions of parameter ``name`` in the order of the JAX
    leaf's (``utils/weight_convert.py``'s layout rules): flax's dense and
    GRU kernels ``[in, out]`` are the transpose of torch's ``[out, in]``,
    flax's conv ``[kh, kw, in, out]`` is torch's ``[out, in, kh, kw]``;
    anything else keeps its order."""
    owner_name, _, leaf = name.rpartition(".")
    owner = model.get_submodule(owner_name)
    ndim = getattr(owner, leaf).dim()
    if leaf == "weight" and isinstance(owner, torch.nn.Conv2d):
        return (2, 3, 1, 0)
    if ndim == 2 and ((leaf == "weight" and isinstance(owner, torch.nn.Linear))
                      or leaf == "in_proj_weight"
                      or re.fullmatch(r"weight_(ih|hh)_l\d+(_reverse)?",
                                      leaf)):
        return (1, 0)
    return tuple(range(ndim))


def zero1_spec(name: str, shape: Sequence[int], n: int,
               jax_order: Optional[Sequence[int]] = None,
               min_elems: int = MIN_ZERO1_ELEMS) -> Optional[int]:
    """The dimension of ``name``'s optimizer moments (the full ``shape``)
    that the ``n`` ranks of the data axis split under ZeRO-1, or None
    (JAX's ``zero1_spec``): starting from the tensor-parallel placement,
    the largest remaining dimension ``n`` divides, ties to the first in
    the JAX leaf's order (``jax_order``: :func:`jax_dim_order`).  Leaves
    under ``min_elems``, scalars and leaves with no such dimension stay
    whole."""
    shape = tuple(shape)
    if not shape or math.prod(shape) < min_elems or n <= 1:
        return None
    taken = tp_spec(name, shape)
    order = tuple(jax_order) if jax_order is not None else \
        tuple(range(len(shape)))
    for d in sorted(order, key=lambda d: -shape[d]):
        if d != taken and shape[d] % n == 0:
            return d
    return None


@dataclass
class StateSharding:
    """Where a sharded train state's leaves are split: ``tp`` (parameter
    name -> dimension over the model axis, in the query and key models
    and in the moments) and ``zero`` (name -> dimension of the moments,
    on the rank's model-axis shard, over the data axis).  A checkpoint
    holds the single-process layout: :meth:`gather` puts the parts back
    together, :meth:`split` takes a rank's parts again."""
    tp: Dict[str, int]
    zero: Dict[str, int]

    def gather(self, state) -> dict:
        """What ``TrainState.state_dict`` gives one process, on the CPU
        (every rank takes part; every rank gets it)."""
        from ..engine.state import _cpu_copy

        model_ax, data_ax = axis(MODEL_AXIS), axis(DATA_AXIS)
        out = {"model": self._whole(state.model.state_dict(), model_ax),
               "step": state.step}
        opt = state.optimizer.state_dict()
        names = optimizer_param_names(state)
        slots = {}
        for i, slot in opt["state"].items():
            name, slots[i] = names[i], {}
            for key, v in slot.items():
                if isinstance(v, torch.Tensor) and v.dim() > 0:
                    if name in self.zero:
                        v = gather_split(v, self.zero[name], data_ax)
                    if name in self.tp:
                        v = gather_split(v, self.tp[name], model_ax)
                slots[i][key] = v
        out["optimizer"] = {"state": slots,
                            "param_groups": opt["param_groups"]}
        if state.key_model is not None:
            out.update(key_model=self._whole(state.key_model.state_dict(),
                                             model_ax),
                       v_queue=state.v_queue, t_queue=state.t_queue,
                       id_queue=state.id_queue, queue_ptr=state.queue_ptr)
        return _cpu_copy(out)

    def _whole(self, sd: dict, ax: Axis) -> dict:
        return {k: gather_split(v, self.tp[k], ax) if k in self.tp else v
                for k, v in sd.items()}

    def split_model(self, sd: dict) -> dict:
        """A model state dict of the single-process layout -> this rank's
        (the split entries' parts; anything else as it is)."""
        ax = axis(MODEL_AXIS)
        return {k: shard_of(torch.as_tensor(v), self.tp[k], ax)
                if k in self.tp and torch.as_tensor(v).dim() else v
                for k, v in sd.items()}

    def split(self, state, sd: dict) -> dict:
        """A :meth:`gather`-layout state dict -> this rank's parts."""
        model_ax, data_ax = axis(MODEL_AXIS), axis(DATA_AXIS)
        out = dict(sd)
        out["model"] = self.split_model(sd["model"])
        if "key_model" in sd:
            out["key_model"] = self.split_model(sd["key_model"])
        names = optimizer_param_names(state)
        slots = {}
        for i, slot in sd["optimizer"]["state"].items():
            name, slots[i] = names[int(i)], {}
            for key, v in slot.items():
                if isinstance(v, torch.Tensor) and v.dim() > 0:
                    if name in self.tp:
                        v = shard_of(v, self.tp[name], model_ax)
                    if name in self.zero:
                        v = shard_of(v, self.zero[name], data_ax)
                    v = v.clone()
                slots[i][key] = v
        out["optimizer"] = {**sd["optimizer"], "state": slots}
        return out


def optimizer_param_names(state) -> list:
    """The query model's parameter names in the order the optimizer
    numbers them in its state dict."""
    names = {id(p): n for n, p in state.model.named_parameters()}
    params = getattr(state.optimizer, "params", None)
    if params is None:
        params = [p for g in state.optimizer.param_groups
                  for p in g["params"]]
    return [names[id(p)] for p in params]


def tensor_parallel_dims(model: torch.nn.Module,
                         num_model: int) -> Dict[str, int]:
    """``{name: dim}`` of ``model``'s parameters a model axis of
    ``num_model`` splits; raises JAX's ``ValueError`` when nothing matches
    (a model without transformer FFNs, e.g. the RN50 + bi-GRU flagship)."""
    dims = {n: d for n, p in model.named_parameters()
            if (d := tp_spec(n, p.shape)) is not None}
    if not dims:
        raise ValueError(
            f"TPU.MODEL_PARALLEL={num_model} "
            "but no state leaf matches a tensor-parallel rule (c_fc/c_proj "
            "transformer FFNs). Tensor parallelism applies to the "
            "ViT/full-CLIP family; use a pure data mesh for this model.")
    return dims


@torch.no_grad()
def shard_model(model: torch.nn.Module, dims: Dict[str, int]) -> None:
    """Keep this rank's model-axis part of each parameter of ``dims`` (the
    whole tensor is dropped) and switch the blocks whose FFN is split to
    the split forward (``TransformerBlock.tensor_parallel``)."""
    ax = axis(MODEL_AXIS)
    for name, p in model.named_parameters():
        if name in dims:
            p.data = shard_of(p.data, dims[name], ax).clone()
    for name, module in model.named_modules():
        if f"{name}.mlp.c_fc.weight" in dims:
            module.tensor_parallel = True


def shard_state(state, mesh: Mesh, optimizer_sharding: bool = False,
                min_zero1_elems: int = MIN_ZERO1_ELEMS):
    """Place a training state on the process-group ``mesh``, in place
    (JAX's ``shard_state``): rank 0's state on every rank
    (:func:`replicate_state`), then on a model axis each rank keeps its
    parts of the FFN leaves (:func:`tp_spec`) in both models and in any
    optimizer state already there, and with ``optimizer_sharding``
    (``TPU.OPTIMIZER_SHARDING``) the optimizer becomes ZeRO-1's over the
    data axis (:func:`zero1_spec`, ``solver/build.py:Zero1Optimizer``).
    Every rank builds and loads the whole state first, as one process
    would, so the ranks start from the one-process state.  Sets
    ``state.sharding`` (:class:`StateSharding`) when anything is split;
    returns ``state``.  A model axis over a model without transformer
    FFNs raises JAX's ``ValueError``."""
    from ..solver.build import Zero1Optimizer

    tp = tensor_parallel_dims(state.model, mesh.model) if mesh.model > 1 \
        else {}
    if not mesh.distributed:
        if tp or optimizer_sharding:
            raise ValueError(
                "a model axis or ZeRO-1 needs a process group (one rank a "
                "card, torchrun); this mesh is a list of devices")
        return state
    replicate_state(state)
    data_ax = axis(DATA_AXIS)
    zero = {}
    if optimizer_sharding and data_ax.size > 1:
        trained = {id(p) for g in state.optimizer.param_groups
                   for p in g["params"]}
        zero = {n: d for n, p in state.model.named_parameters()
                if id(p) in trained and (d := zero1_spec(
                    n, p.shape, data_ax.size,
                    jax_dim_order(state.model, n), min_zero1_elems))
                is not None}
    if not tp and not zero:
        return state
    if tp:
        model_ax = axis(MODEL_AXIS)
        params = dict(state.model.named_parameters())
        with torch.no_grad():
            for name, dim in tp.items():
                slot = state.optimizer.state.get(params[name], {})
                for key, v in slot.items():
                    if isinstance(v, torch.Tensor) and v.dim() > 0:
                        slot[key] = shard_of(v, dim, model_ax).clone()
        for model in (state.model, state.key_model):
            if model is not None:
                shard_model(model, tp)
    if zero:
        params = dict(state.model.named_parameters())
        state.optimizer = Zero1Optimizer(
            state.optimizer, {id(params[n]): d for n, d in zero.items()},
            data_ax)
    state.sharding = StateSharding(tp, zero)
    return state


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
