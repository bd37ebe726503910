"""Data-parallel training over ``torch.distributed``: one process per GPU.

Counterpart of ``openseg3d_tpu/parallel/mesh.py``. The JAX package trains
data-parallel by SPMD over a 1-D mesh: a step on a batch sharded over N
devices computes what the same step on the whole batch computes on one
device. The port keeps that meaning, which a plain DDP wrap does not:
  * BatchNorm statistics are sums over the global batch
    (``models/norm.MaskedBatchNorm`` all-reduces them);
  * the loss is one loss over the global batch: each rank gathers the point,
    voxel and aux logits and their labels of every rank in rank order
    (``engine.compute_loss``), so OHEM's keep count and top-k and the Lovasz
    sort run over every valid point of the global batch;
  * the eval histogram and the eval loss are global.

The convention of the gradients. Every rank holds the same global loss. The
gathered logits' backward is local: it returns the rank's own slice of the
cotangent. The all-reduce's backward is a sum: it all-reduces the cotangent,
since each rank's graph sees a shared statistic only through its own rows.
Each rank's parameter gradients are then its share of the global gradient,
and ``reduce_gradients`` sums them across ranks in one flattened all-reduce:
DDP's mean of per-rank losses would need the loss multiplied by the world
size, and DDP's buffer broadcast would undo the non-finite guard's restore.

The backend is NCCL for a CUDA device and gloo for the CPU. Gloo's
all-gather does not take CUDA tensors in every torch version, so on that
pair (two ranks sharing one card in a test) the gather is an all-reduce of
a zero-padded buffer, which both backends take.

``process_shard_indices`` gives rank r slot r of each global batch
(``mesh.py:112-135``), so the ranks' rows in rank order are the JAX global
batch's rows in order.
"""

from __future__ import annotations

import os

import numpy as np
import torch
import torch.distributed as dist


def is_distributed() -> bool:
    return dist.is_available() and dist.is_initialized()


def rank() -> int:
    return dist.get_rank() if is_distributed() else 0


def world() -> int:
    return dist.get_world_size() if is_distributed() else 1


def backend() -> str | None:
    return dist.get_backend() if is_distributed() else None


def local_device(device_type: str = 'cuda') -> torch.device:
    """This rank's device: ``cuda:LOCAL_RANK`` (made current) for a GPU run,
    the CPU otherwise. A LOCAL_RANK with no card of its own raises: ranks
    never share a card quietly."""
    if device_type != 'cuda':
        return torch.device(device_type)
    if not torch.cuda.is_available():
        raise RuntimeError('no CUDA device: pass --device cpu to run on the CPU')
    local = int(os.environ.get('LOCAL_RANK', 0))
    if local >= torch.cuda.device_count():
        raise RuntimeError(f'LOCAL_RANK {local} has no card of its own: '
                           f'{torch.cuda.device_count()} visible')
    torch.cuda.set_device(local)
    return torch.device('cuda', local)


def init_distributed(device_type: str = 'cuda', backend: str | None = None,
                     init_method: str | None = None, rank: int | None = None,
                     world_size: int | None = None) -> tuple[int, int]:
    """Join the process group; returns (rank, world size).

    With no ``init_method``, the group is torchrun's: ``RANK``,
    ``WORLD_SIZE``, ``MASTER_ADDR`` and ``MASTER_PORT`` from the environment
    (``LOCAL_RANK`` picks the card, ``local_device``); with no such
    environment this is a no-op, as it is with a group already set up. The
    backend is NCCL for 'cuda' and gloo otherwise; ``backend``,
    ``init_method``, ``rank`` and ``world_size`` are given explicitly only by
    tests and by a run that puts two ranks on one card."""
    if is_distributed():
        return dist.get_rank(), dist.get_world_size()
    if init_method is None:
        if 'WORLD_SIZE' not in os.environ:
            return 0, 1
        init_method = 'env://'
    if backend is None:
        backend = 'nccl' if device_type == 'cuda' else 'gloo'
    kwargs = {}
    if rank is not None:
        kwargs.update(rank=rank, world_size=world_size)
    dist.init_process_group(backend, init_method=init_method, **kwargs)
    return dist.get_rank(), dist.get_world_size()


def destroy() -> None:
    """Leave the process group (the tools, for a group they set up)."""
    if is_distributed():
        dist.destroy_process_group()


def _gather(x: torch.Tensor) -> torch.Tensor:
    n = x.shape[0]
    if x.is_cuda and dist.get_backend() == 'gloo':
        buf = x.new_zeros((world() * n,) + tuple(x.shape[1:]))
        buf[rank() * n:(rank() + 1) * n] = x
        dist.all_reduce(buf)
        return buf
    parts = [torch.empty_like(x) for _ in range(world())]
    dist.all_gather(parts, x.contiguous())
    return torch.cat(parts)


class _AllReduceSum(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        y = x.contiguous().clone()
        dist.all_reduce(y)
        return y

    @staticmethod
    def backward(ctx, g):
        g = g.contiguous().clone()
        dist.all_reduce(g)
        return g


class _GatherRows(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x):
        ctx.rows = (rank() * x.shape[0], (rank() + 1) * x.shape[0])
        return _gather(x)

    @staticmethod
    def backward(ctx, g):
        return g[ctx.rows[0]:ctx.rows[1]]


def all_reduce_sum(x: torch.Tensor) -> torch.Tensor:
    """The sum of `x` over the ranks, differentiable (the backward sums the
    cotangent over the ranks); `x` itself with one process."""
    return _AllReduceSum.apply(x) if world() > 1 else x


def gather_rows(x: torch.Tensor) -> torch.Tensor:
    """Every rank's rows of `x`, concatenated in rank order (each rank gives
    the same number of rows); the backward returns this rank's own slice of
    the cotangent. `x` itself with one process."""
    return _GatherRows.apply(x) if world() > 1 else x


def reduce_gradients(params) -> None:
    """Sum the parameters' gradients over the ranks, in one flattened
    all-reduce. A parameter that no rank gave a gradient keeps none, as in
    one process."""
    if world() == 1:
        return
    params = list(params)
    grads = [p.grad if p.grad is not None else torch.zeros_like(p) for p in params]
    has = torch.tensor([p.grad is not None for p in params], dtype=grads[0].dtype,
                       device=grads[0].device)
    flat = torch.cat([g.reshape(-1) for g in grads] + [has])
    dist.all_reduce(flat)
    has = flat[-len(params):].cpu().tolist()
    offset = 0
    for p, h in zip(params, has):
        n = p.numel()
        p.grad = flat[offset:offset + n].view_as(p) if h else None
        offset += n


def _comm_device() -> torch.device:
    if backend() == 'nccl':
        return torch.device('cuda', torch.cuda.current_device())
    return torch.device('cpu')


def all_reduce_array(a: np.ndarray) -> np.ndarray:
    """The sum of a host array over the ranks (the IoU histogram)."""
    t = torch.tensor(np.asarray(a), device=_comm_device())
    dist.all_reduce(t)
    return t.cpu().numpy()


def broadcast_int(value: int, src: int = 0) -> int:
    """Rank `src`'s value on every rank."""
    t = torch.tensor([value], dtype=torch.int64, device=_comm_device())
    dist.broadcast(t, src)
    return int(t.item())


def barrier() -> None:
    if world() > 1:
        if backend() == 'nccl':
            dist.barrier(device_ids=[torch.cuda.current_device()])
        else:
            dist.barrier()


def process_shard_indices(n: int, shuffle_seed: int | None, epoch: int,
                          batch_size_global: int, world_size: int | None = None,
                          process_rank: int | None = None, return_valid: bool = False):
    """This process's sample indices (``mesh.py:112-135``): epoch+seed
    deterministic shuffle, padded to a multiple of the global batch by
    cycling from the front, then slot `process_rank` of every global batch (the
    DistributedSampler analog). World size and rank default to the process
    group's. With return_valid, also a bool array marking which slots are
    real samples (False = a padding duplicate), so that eval can keep
    recycled frames out of the IoU histogram."""
    world_size = world() if world_size is None else world_size
    process_rank = rank() if process_rank is None else process_rank
    idx = np.arange(n)
    if shuffle_seed is not None:
        rng = np.random.RandomState(shuffle_seed + epoch)
        rng.shuffle(idx)
    per_host_batch = batch_size_global // world_size
    total = int(np.ceil(n / batch_size_global)) * batch_size_global
    valid = np.concatenate([np.ones(n, bool), np.zeros(total - n, bool)])
    idx = np.resize(idx, total)
    sel = np.arange(total).reshape(-1, world_size, per_host_batch)[:, process_rank, :].reshape(-1)
    if return_valid:
        return idx[sel], valid[sel]
    return idx[sel]
