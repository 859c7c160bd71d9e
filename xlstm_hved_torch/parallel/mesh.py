"""Process groups, the mesh and the collectives of data parallelism
(counterpart of `xlstm_hved_tpu/parallel/mesh.py`).

The JAX package shards one jitted program over a device mesh and lets XLA
insert the collectives, so every reduction over the batch axis is taken over
the global batch. Here one process drives one device, the mesh is a
`torch.distributed` process group, and the collectives are explicit:

- `global_sums` adds the ranks' partial sums inside the losses, BatchNorm
  and PSNR before each ratio is taken (differentiable: its backward adds
  every rank's upstream gradient, the sum the global objective needs);
- `average_gradients` averages G's or D's gradients over the ranks, one
  all-reduce of a flat buffer, after each backward;
- `average_metrics` makes a step's scalar metrics the global ones;
- `sample_rows` draws noise at the global batch shape and keeps this rank's
  rows, as the sharded JAX draw does;
- `in_lockstep` stops every rank's loop at the first step some rank cannot
  take, so no collective waits for a rank that has run out of data.

A mesh is active inside `with mesh:` (JAX's `with mesh:`). With none
active, or a data axis of one rank, the reductions are the one-process code
itself and do no traffic. The collectives use only all_reduce and
broadcast, which gloo also takes on CUDA tensors; a gather is an all-reduce
of a zero-padded buffer.
"""
from __future__ import annotations

import dataclasses
import os
from typing import Dict, Iterable, Iterator, List, Mapping, Optional, Sequence, Tuple

import torch
import torch.distributed as dist


def backend_for(device) -> str:
    """NCCL for a CUDA device, gloo for the CPU."""
    return "nccl" if torch.device(device).type == "cuda" else "gloo"


def initialize_distributed(coordinator_address: Optional[str] = None,
                           num_processes: Optional[int] = None,
                           process_id: Optional[int] = None,
                           backend: Optional[str] = None) -> None:
    """Join the process group: `tcp://<coordinator_address>` with the given
    size and rank, or `env://` (torchrun's MASTER_ADDR, MASTER_PORT, RANK and
    WORLD_SIZE) when no address is given. `backend` defaults to NCCL, the
    card's. Idempotent. A failure raises (JAX's prints and carries on)."""
    if dist.is_initialized():
        return
    init_method = f"tcp://{coordinator_address}" if coordinator_address else "env://"
    dist.init_process_group(backend or "nccl", init_method=init_method,
                            world_size=-1 if num_processes is None else num_processes,
                            rank=-1 if process_id is None else process_id)


def rank_device(device="cuda") -> torch.device:
    """This rank's device: a bare "cuda" is `cuda:{LOCAL_RANK}`, an explicit
    `cuda:N` is kept; an index the host does not have raises, and so does a
    CUDA request with no card."""
    device = torch.device(device)
    if device.type != "cuda":
        return device
    if not torch.cuda.is_available():
        raise RuntimeError(f"device {device} requested but no CUDA device is available")
    index = device.index if device.index is not None else int(os.environ.get("LOCAL_RANK", 0))
    if not 0 <= index < torch.cuda.device_count():
        raise ValueError(f"cuda:{index} asked for (LOCAL_RANK {os.environ.get('LOCAL_RANK')}), "
                         f"but this host has {torch.cuda.device_count()} CUDA device(s)")
    return torch.device("cuda", index)


@dataclasses.dataclass
class Mesh:
    """The (data, seq) grid of ranks, rank = d * seq + s as JAX's mesh lays
    out its devices, and this rank's place and device in it. An axis's group
    is None when no process group is initialised (one process) or when the
    axis has one rank of several."""
    device: torch.device
    rank: int
    world: int
    data: int
    seq: int
    data_group: Optional[dist.ProcessGroup] = None
    seq_group: Optional[dist.ProcessGroup] = None

    @property
    def data_rank(self) -> int:
        return self.rank // self.seq

    @property
    def seq_rank(self) -> int:
        return self.rank % self.seq

    def __enter__(self) -> "Mesh":
        _ACTIVE.append(self)
        return self

    def __exit__(self, *exc) -> None:
        _ACTIVE.remove(self)


_ACTIVE: List[Mesh] = []


def active_mesh() -> Optional[Mesh]:
    """The innermost mesh entered with `with mesh:`, else None."""
    return _ACTIVE[-1] if _ACTIVE else None


def data_mesh() -> Optional[Mesh]:
    """The active mesh when its data axis spans more than one rank, else
    None: the test of every global-batch reduction."""
    mesh = active_mesh()
    return mesh if mesh is not None and mesh.data > 1 else None


def make_mesh(data: Optional[int] = None, seq: int = 1, device="cuda") -> Mesh:
    """The mesh over every rank of the process group (one rank when none is
    initialised), `data` (default all) by `seq`. `device` is resolved by
    `rank_device` and made the current CUDA device."""
    world = dist.get_world_size() if dist.is_initialized() else 1
    rank = dist.get_rank() if dist.is_initialized() else 0
    if data is None:
        data = world // seq
    if data * seq != world:
        raise ValueError(f"mesh {data}x{seq} needs {data * seq} ranks, the group has {world}")
    device = rank_device(device)
    if device.type == "cuda":
        torch.cuda.set_device(device)
    mesh = Mesh(device=device, rank=rank, world=world, data=data, seq=seq)
    if dist.is_initialized():
        # every rank creates every group, in the same order
        mesh.data_group = _axis_groups([[d * seq + s for d in range(data)] for s in range(seq)],
                                       rank, world)
        mesh.seq_group = _axis_groups([[d * seq + s for s in range(seq)] for d in range(data)],
                                      rank, world)
    return mesh


def _axis_groups(groups: Sequence[Sequence[int]], rank: int, world: int):
    """This rank's group along one axis: the world when the axis spans it
    (a world of one rank included), None when the axis has one rank of
    several (nothing to reduce over)."""
    if len(groups[0]) == world:
        return dist.group.WORLD
    if len(groups[0]) == 1:
        return None
    mine = None
    for ranks in groups:
        group = dist.new_group(list(ranks))
        if rank in ranks:
            mine = group
    return mine


def _host_device(group=None) -> torch.device:
    """Where a collective on host values runs: the current CUDA device for
    NCCL (it takes CUDA tensors only), the CPU for gloo."""
    if dist.get_backend(group) == "nccl":
        return torch.device("cuda", torch.cuda.current_device())
    return torch.device("cpu")


class _AllReduceSum(torch.autograd.Function):
    """Sum over the group; the backward sums the upstream gradients too, so
    each rank's input gets the gradient of the sum of every rank's loss."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        y = x.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(y, group=group)
        return y

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad, None


def _split_like(flat: torch.Tensor, tensors: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    out, at = [], 0
    for t in tensors:
        out.append(flat[at:at + t.numel()].view_as(t))
        at += t.numel()
    return out


def global_sums(*tensors: torch.Tensor) -> Tuple[torch.Tensor, ...]:
    """The tensors summed over the active data axis, in one all-reduce, with
    gradients; the tensors themselves when no data axis of more than one rank
    is active. They share one dtype and device."""
    mesh = data_mesh()
    if mesh is None:
        return tensors
    flat = torch.cat([t.reshape(-1) for t in tensors])
    return tuple(_split_like(_AllReduceSum.apply(flat, mesh.data_group), tensors))


def average_gradients(grads: Sequence[torch.Tensor]) -> List[torch.Tensor]:
    """The gradients averaged over the active data axis: one all-reduce of a
    flat buffer (run under any process group, a group of one rank included,
    as DistributedDataParallel does). With the backward of `global_sums`
    this is the gradient of the mean over ranks of each rank's loss, which
    is the one-process loss at the global batch: a batch mean is the mean of
    the ranks' equal-sized means, and a ratio of global sums is the same
    value on every rank."""
    mesh = active_mesh()
    if mesh is None or mesh.data_group is None:
        return list(grads)
    flat = torch.cat([g.reshape(-1) for g in grads])
    dist.all_reduce(flat, group=mesh.data_group)
    flat.div_(mesh.data)
    return _split_like(flat, grads)


def average_metrics(metrics: Mapping[str, torch.Tensor]) -> Dict[str, torch.Tensor]:
    """0-d metric tensors averaged over the active data axis, summed in
    fp64 (so a value that is already global comes back unchanged); the dict
    as it is without a data axis of more than one rank."""
    mesh = data_mesh()
    if mesh is None:
        return dict(metrics)
    keys = list(metrics)
    device = _host_device(mesh.data_group)
    stacked = torch.stack([metrics[k].detach().to(device, torch.float64) for k in keys])
    dist.all_reduce(stacked, group=mesh.data_group)
    stacked /= mesh.data
    return {k: stacked[i].to(metrics[k].device, metrics[k].dtype) for i, k in enumerate(keys)}


def sample_rows(draw, shape: Sequence[int]) -> torch.Tensor:
    """`draw(shape)` under one process; under a data axis of N ranks,
    `draw` at the global shape (N * shape[0], ...) and this rank's rows of
    it, so that N ranks draw what one process draws at the global batch."""
    mesh = data_mesh()
    if mesh is None:
        return draw(tuple(shape))
    b = shape[0]
    full = draw((mesh.data * b,) + tuple(shape[1:]))
    return full[mesh.data_rank * b:(mesh.data_rank + 1) * b]


def all_gather(x: torch.Tensor, group) -> torch.Tensor:
    """(ranks of `group`, *x.shape): every rank's x, stacked in rank order,
    with gradients (the backward of `global_sums`' kind: each slot's
    gradient summed over the ranks comes back to its owner)."""
    return _AllGather.apply(x, group)


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        ctx.rank = dist.get_rank(group)
        buf = x.new_zeros((dist.get_world_size(group),) + tuple(x.shape))
        buf[ctx.rank] = x
        dist.all_reduce(buf, group=group)
        return buf

    @staticmethod
    def backward(ctx, grad):
        grad = grad.clone(memory_format=torch.contiguous_format)
        dist.all_reduce(grad, group=ctx.group)
        return grad[ctx.rank], None


def shard_batch(mesh: Mesh, batch):
    """This rank's rows of a global batch (a tensor, or a tuple / list of
    them), on the mesh's device: the data axis splits the leading axis into
    equal, contiguous blocks in rank order."""
    if isinstance(batch, (tuple, list)):
        return type(batch)(shard_batch(mesh, x) for x in batch)
    n = batch.shape[0]
    if n % mesh.data:
        raise ValueError(f"global batch {n} does not split over {mesh.data} data ranks")
    b = n // mesh.data
    return batch[mesh.data_rank * b:(mesh.data_rank + 1) * b].to(mesh.device)


def _state_tensors(obj) -> List[torch.Tensor]:
    """Every tensor of a module, an optimizer or a TrainState, in a fixed
    order."""
    if isinstance(obj, torch.nn.Module):
        return list(obj.parameters()) + list(obj.buffers())
    if isinstance(obj, torch.optim.Optimizer):
        out = []
        for group in obj.param_groups:
            for p in group["params"]:
                state = obj.state.get(p, {})
                out += [state[k] for k in sorted(state) if torch.is_tensor(state[k])]
        return out
    return [t for part in (obj.model, obj.disc, obj.opt_g, obj.opt_d)
            for t in _state_tensors(part)]


@torch.no_grad()
def replicate(mesh: Mesh, state):
    """Broadcast every parameter, buffer and optimizer state tensor of a
    TrainState from rank 0, one broadcast per dtype and device; nothing to
    do on one rank. Returns the state."""
    if mesh.world > 1:
        buckets: Dict[Tuple, List[torch.Tensor]] = {}
        for t in _state_tensors(state):
            buckets.setdefault((t.device, t.dtype), []).append(t)
        host = _host_device()
        for (device, _), ts in buckets.items():
            flat = torch.cat([t.reshape(-1) for t in ts])
            if device.type == "cpu" and host.type == "cuda":
                flat = flat.to(host)
            dist.broadcast(flat, src=0)
            for t, v in zip(ts, _split_like(flat, ts)):
                t.copy_(v)
    return state


def in_lockstep(iterable: Iterable, mesh: Optional[Mesh]) -> Iterator:
    """Yield the items of this rank's iterable while every rank of the data
    axis has one: each step first agrees (an all-reduce MIN of "I have an
    item") that all can take it. A sharded loader can yield more batches on
    one rank than on another (a strided shard of a count that does not
    divide, an item that fails to load); the ranks then stop together at
    the shortest, where a collective would otherwise wait forever."""
    if mesh is None or mesh.data == 1:
        yield from iterable
        return
    it = iter(iterable)
    device = _host_device(mesh.data_group)
    try:
        while True:
            item = next(it, None)
            flag = torch.tensor([0 if item is None else 1], device=device)
            dist.all_reduce(flag, op=dist.ReduceOp.MIN, group=mesh.data_group)
            if int(flag.item()) == 0:
                return
            yield item
    finally:
        close = getattr(it, "close", None)
        if close is not None:
            close()


def allreduce_averages(avgs: Mapping) -> Dict[str, float]:
    """{key: global sum / max(global count, 1)} of a dict of RunningAverage
    accumulators: one all-reduce of a float64 (2, K) tensor of sums and
    counts, so every rank takes the same best-checkpoint decisions. On one
    process the local averages, with no traffic."""
    keys = sorted(avgs)
    if not dist.is_initialized() or dist.get_world_size() == 1:
        return {k: avgs[k].avg for k in keys}
    local = torch.tensor([[float(avgs[k].sum) for k in keys],
                          [float(avgs[k].count) for k in keys]],
                         dtype=torch.float64, device=_host_device())
    dist.all_reduce(local)
    sums, counts = local.cpu().tolist()
    return {k: sums[i] / max(counts[i], 1.0) for i, k in enumerate(keys)}
