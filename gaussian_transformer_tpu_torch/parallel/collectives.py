"""Autograd-aware collectives over ``torch.distributed`` process groups: what
XLA placed for the JAX package's ``shard_map`` regions.

Inside a region every rank holds its own value, as a ``shard_map`` body
does, and the backward of each collective is its linear transpose, as
``shard_map(check_vma=False)`` transposes it:

  * ``all_gather`` (tiled on dim 0) <-> ``reduce_scatter`` with sum;
  * ``all_reduce`` (sum or mean) -> the same all-reduce (psum's transpose);
  * ``all_to_all`` -> the inverse all-to-all;
  * ``permute`` / ``ring_shift`` -> the inverse permutation (at world size 1
    the identity, as a one-device ``ppermute``).

The region's edges are explicit, as ``shard_map``'s in and out specs are:

  * ``replicated_slice``: a rank's rows of a tensor every rank holds alike
    (an input split over the group); backward: zero-pad and all-reduce, so
    every rank holds the whole tensor's gradient;
  * ``replicated_output``: a value every rank computed alike leaving the
    region (an output with no spec); backward: the cotangent over the group
    size.

Every call, forward or backward, records ``Collective(op, shapes, dtype,
bytes)`` of its output into the active ``recording()``, under the JAX op
names ``all-gather``, ``all-reduce``, ``reduce-scatter``,
``collective-permute`` and ``all-to-all``; ``parallel/audit.py`` reads that
record. A group of one rank still runs (and records) its collective.
"""

from __future__ import annotations

import contextlib
from typing import List, NamedTuple, Sequence

import torch
import torch.distributed as dist

DTYPE_NAMES = {torch.float64: "f64", torch.float32: "f32", torch.bfloat16: "bf16", torch.float16: "f16",
               torch.int64: "s64", torch.int32: "s32", torch.int16: "s16", torch.int8: "s8",
               torch.uint8: "u8", torch.bool: "pred"}


class Collective(NamedTuple):
    op: str  # JAX/HLO op name, e.g. "all-gather"
    shapes: tuple  # output shapes, one tuple of ints each
    dtype: str  # HLO element type, e.g. "f32"
    bytes: int  # total output bytes

    def shape_strings(self) -> tuple:
        return tuple(f"{self.dtype}[{','.join(map(str, s))}]" for s in self.shapes)


_RECORDERS: List[List[Collective]] = []


@contextlib.contextmanager
def recording():
    """Collect every collective issued inside the block (nested blocks each
    see their own and their inner blocks' calls)."""
    rec: List[Collective] = []
    _RECORDERS.append(rec)
    try:
        yield rec
    finally:
        _RECORDERS.remove(rec)


def _record(op: str, *outs: torch.Tensor) -> None:
    if not _RECORDERS:
        return
    c = Collective(op, tuple(tuple(t.shape) for t in outs), DTYPE_NAMES.get(outs[0].dtype, str(outs[0].dtype)),
                   sum(t.numel() * t.element_size() for t in outs))
    for rec in _RECORDERS:
        rec.append(c)


def size(group=None) -> int:
    return dist.get_world_size(group)


def rank(group=None) -> int:
    return dist.get_rank(group)


def _gather(x, group):
    x = x.contiguous()
    out = x.new_empty((size(group) * x.shape[0],) + tuple(x.shape[1:]))
    dist.all_gather_into_tensor(out, x, group=group)
    _record("all-gather", out)
    return out


def _scatter(x, group, op=dist.ReduceOp.SUM):
    n = size(group)
    if x.shape[0] % n:
        raise ValueError(f"reduce_scatter: dim 0 ({x.shape[0]}) does not split over {n} ranks")
    x = x.contiguous()
    out = x.new_empty((x.shape[0] // n,) + tuple(x.shape[1:]))
    dist.reduce_scatter_tensor(out, x, op=op, group=group)
    _record("reduce-scatter", out)
    return out


def _reduce(x, group, mean: bool = False, op=dist.ReduceOp.SUM):
    out = x.contiguous().clone()
    dist.all_reduce(out, op=dist.ReduceOp.AVG if mean and out.is_cuda else op, group=group)
    if mean and not out.is_cuda:
        out = out / size(group)  # gloo has no AVG
    _record("all-reduce", out)
    return out


def _to_all(x, group):
    x = x.contiguous()
    out = torch.empty_like(x)
    dist.all_to_all_single(out, x, group=group)
    _record("all-to-all", out)
    return out


def _permute(x, group, perm: Sequence[int]):
    """Send this rank's ``x`` to group rank ``perm[me]`` and receive from the
    rank that sends here."""
    n, me = size(group), rank(group)
    dst = perm[me]
    src = list(perm).index(me)
    out = torch.empty_like(x)
    if dst == me:
        out.copy_(x)
    else:
        x = x.contiguous()
        g = lambda r: dist.get_global_rank(group, r) if group is not None else r
        ops = [dist.P2POp(dist.isend, x, g(dst), group=group), dist.P2POp(dist.irecv, out, g(src), group=group)]
        for req in dist.batch_isend_irecv(ops):
            req.wait()
    _record("collective-permute", out)
    return out


class _AllGather(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _gather(x, group)

    @staticmethod
    def backward(ctx, g):
        return _scatter(g, ctx.group), None


class _ReduceScatter(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _scatter(x, group)

    @staticmethod
    def backward(ctx, g):
        return _gather(g, ctx.group), None


class _AllReduce(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, mean):
        ctx.group, ctx.mean = group, mean
        return _reduce(x, group, mean)

    @staticmethod
    def backward(ctx, g):
        return _reduce(g, ctx.group, ctx.mean), None, None


class _AllToAll(torch.autograd.Function):
    """all-to-all on dim 0 (chunk j goes to rank j); it is its own inverse."""

    @staticmethod
    def forward(ctx, x, group):
        ctx.group = group
        return _to_all(x, group)

    @staticmethod
    def backward(ctx, g):
        return _to_all(g, ctx.group), None


class _Permute(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, perm):
        ctx.group = group
        ctx.inverse = [list(perm).index(r) for r in range(len(perm))]
        return _permute(x, group, perm)

    @staticmethod
    def backward(ctx, g):
        return _permute(g, ctx.group, ctx.inverse), None, None


class _ReplicatedSlice(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group, start, stop):
        ctx.group, ctx.span, ctx.shape = group, (start, stop), x.shape
        return x[start:stop]

    @staticmethod
    def backward(ctx, g):
        full = g.new_zeros(ctx.shape)
        full[ctx.span[0]:ctx.span[1]] = g
        return _reduce(full, ctx.group, mean=False), None, None, None


class _ReplicatedOutput(torch.autograd.Function):
    @staticmethod
    def forward(ctx, x, group):
        ctx.n = size(group)
        return x.view_as(x)

    @staticmethod
    def backward(ctx, g):
        return g / ctx.n, None


def all_gather(x: torch.Tensor, group=None) -> torch.Tensor:
    """Every rank's ``x`` concatenated on dim 0 in rank order."""
    return _AllGather.apply(x, group)


def reduce_scatter(x: torch.Tensor, group=None) -> torch.Tensor:
    """The sum over ranks of ``x``, this rank's 1/n of dim 0."""
    return _ReduceScatter.apply(x, group)


def all_reduce(x: torch.Tensor, group=None, op: str = "sum") -> torch.Tensor:
    """The sum (``op="sum"``) or mean (``"mean"``) over ranks of ``x``."""
    if op not in ("sum", "mean"):
        raise ValueError(f"all_reduce op must be 'sum' or 'mean', got {op!r}")
    return _AllReduce.apply(x, group, op == "mean")


@torch.no_grad()
def all_reduce_tensors(tensors, group=None, op: str = "sum") -> List[torch.Tensor]:
    """The sum (``op="sum"``) or mean (``"mean"``) over ranks of each tensor,
    in one all-reduce of the flattened set (no gradient)."""
    flat = _reduce(torch.cat([t.flatten() for t in tensors]), group, mean=op == "mean")
    return [part.view_as(t) for t, part in zip(tensors, flat.split([t.numel() for t in tensors]))]


@torch.no_grad()
def reduce_max(x: torch.Tensor, group=None) -> torch.Tensor:
    """The elementwise max over ranks of ``x`` (no gradient)."""
    return _reduce(x, group, op=dist.ReduceOp.MAX)


def all_to_all(x: torch.Tensor, split_dim: int, concat_dim: int, group=None) -> torch.Tensor:
    """``jax.lax.all_to_all(tiled=True)``: ``x`` split in n pieces on
    ``split_dim``, piece j sent to rank j, the received pieces concatenated
    on ``concat_dim`` in rank order."""
    n = size(group)
    if x.shape[split_dim] % n:
        raise ValueError(f"all_to_all: dim {split_dim} ({x.shape[split_dim]}) does not split over {n} ranks")
    pieces = torch.stack(torch.chunk(x, n, dim=split_dim))  # [n, ...]: piece j goes to rank j
    got = _AllToAll.apply(pieces, group)  # [n, ...]: piece j came from rank j
    return torch.cat(torch.unbind(got), dim=concat_dim)


def permute(x: torch.Tensor, perm: Sequence[int], group=None) -> torch.Tensor:
    """``jax.lax.ppermute``: rank r's ``x`` goes to rank ``perm[r]``
    (``perm`` a permutation of the group's ranks)."""
    if sorted(perm) != list(range(size(group))):
        raise ValueError(f"{list(perm)} is not a permutation of {size(group)} ranks")
    return _Permute.apply(x, group, tuple(perm))


def ring_shift(x: torch.Tensor, shift: int = -1, group=None) -> torch.Tensor:
    """Rank r's ``x`` goes to rank r + shift (mod n): ``shift=-1`` receives
    from the right neighbour (r + 1), as the ring attention's rotation."""
    n = size(group)
    return permute(x, [(r + shift) % n for r in range(n)], group)


def replicated_slice(x: torch.Tensor, start: int, stop: int, group=None) -> torch.Tensor:
    """``x[start:stop]`` of a tensor every rank of ``group`` holds alike
    (each rank its own range); the gradient of ``x`` is the all-reduce of
    the ranks' zero-padded slice gradients."""
    return _ReplicatedSlice.apply(x, group, int(start), int(stop))


def replicated_output(x: torch.Tensor, group=None) -> torch.Tensor:
    """``x`` unchanged (every rank computed it alike); each rank's cotangent
    is divided by the group size, so the replicated result counts once."""
    return _ReplicatedOutput.apply(x, group)

