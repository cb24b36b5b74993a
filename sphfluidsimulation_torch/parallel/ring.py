"""The slab axis: the torch counterpart of the JAX mesh axis of the slab step.

The JAX slab step runs one program per device under ``jax.shard_map`` and
exchanges with ``lax.ppermute`` to the next and previous device of the mesh
axis, ``psum`` and ``pmax`` (``parallel/slab_pallas.py:121-124, :236-245``).
Here a shard's step is a Python generator that yields each exchange it
needs (``reply = yield ring.up(x)``) and gets the result back; a ring drives
the generators of the shards it holds:

- :class:`LocalRing` holds all D shards in one process, on one device. It
  advances every shard to its next exchange, then exchanges: every phase
  runs for all shards before the exchange that follows it. This is the
  counterpart of the JAX tests' virtual CPU mesh, and the way one card runs
  D = 2, 4 or 8 slabs.
- :class:`DistRing` holds one shard per process (its rank) over
  ``torch.distributed``: ``batch_isend_irecv`` to rank ± 1 and
  ``all_reduce`` for the sums and maxima. It is tested on the CPU with gloo.

``up(x)`` sends x to the next shard and returns what the previous one sent;
``down(x)`` the other way; the edge shards receive zeros, as ``ppermute``
gives edge devices. ``psum``, ``pmax`` and ``pmean`` return the sum, the
maximum and the mean over all shards (``lax.pmean`` is the sum over the
shard count). ``gather(x)`` returns every shard's x concatenated in shard
order along dim 0, ``lax.all_gather(x, axis, tiled=True)``: ``DistRing``
takes it from ``torch.distributed.all_gather``, which gloo and NCCL both
have. Every shard yields the same exchanges in the same order with tensors
of the same shape.
"""

from __future__ import annotations

from typing import Any, Callable, Generator, NamedTuple

import torch

# a shard's step: yields Exchange requests, returns its result
ShardStep = Generator["Exchange", torch.Tensor, Any]


class Exchange(NamedTuple):
    op: str            # "up", "down", "sum", "max", "mean" or "gather"
    x: torch.Tensor


class Ring:
    """The exchanges a shard's step may yield, and how a ring runs the
    steps of the shards it holds."""

    d: int             # shards along the slab axis

    @staticmethod
    def up(x: torch.Tensor) -> Exchange:
        return Exchange("up", x)

    @staticmethod
    def down(x: torch.Tensor) -> Exchange:
        return Exchange("down", x)

    @staticmethod
    def psum(x: torch.Tensor) -> Exchange:
        return Exchange("sum", x)

    @staticmethod
    def pmax(x: torch.Tensor) -> Exchange:
        return Exchange("max", x)

    @staticmethod
    def pmean(x: torch.Tensor) -> Exchange:
        return Exchange("mean", x)

    @staticmethod
    def gather(x: torch.Tensor) -> Exchange:
        return Exchange("gather", x)

    @property
    def indices(self) -> list[int]:
        """The shard indices held here, in order."""
        raise NotImplementedError

    def run(self, step: Callable[..., ShardStep],
            args: list[tuple]) -> list[Any]:
        """Runs ``step(index, *a)`` for each shard index held here, with
        ``a`` its entry of ``args``; returns their results in order."""
        raise NotImplementedError


class LocalRing(Ring):
    """D shards in one process: the exchanges are list shuffles."""

    def __init__(self, d: int):
        if d < 1:
            raise ValueError("a ring needs at least one shard")
        self.d = d

    @property
    def indices(self) -> list[int]:
        return list(range(self.d))

    def run(self, step, args):
        gens = [step(i, *a) for i, a in zip(self.indices, args, strict=True)]
        replies: list[torch.Tensor | None] = [None] * self.d
        while True:
            reqs, done = [], []
            for g, rep in zip(gens, replies):
                try:
                    reqs.append(g.send(rep))
                except StopIteration as stop:
                    done.append(stop.value)
            if done:
                if len(done) != self.d:
                    raise RuntimeError("the shards left their step out of "
                                       "step with each other")
                return done
            replies = self._exchange(reqs)

    def _exchange(self, reqs: list[Exchange]) -> list[torch.Tensor]:
        op = reqs[0].op
        if any(q.op != op for q in reqs):
            raise RuntimeError(f"shards disagree on the exchange: "
                               f"{[q.op for q in reqs]}")
        xs = [q.x for q in reqs]
        if op == "up":
            return [torch.zeros_like(xs[0])] + xs[:-1]
        if op == "down":
            return xs[1:] + [torch.zeros_like(xs[-1])]
        if op == "gather":
            return [torch.cat(xs)] * self.d
        total = xs[0]
        for x in xs[1:]:
            total = torch.maximum(total, x) if op == "max" else total + x
        return [total / self.d if op == "mean" else total] * self.d


class DistRing(Ring):
    """One shard per process over ``torch.distributed`` (rank = shard
    index). ``group`` None is the default process group, which the caller
    initialises."""

    def __init__(self, group=None):
        import torch.distributed as dist

        self._dist = dist
        self.group = group
        self.rank = dist.get_rank(group)
        self.d = dist.get_world_size(group)

    @property
    def indices(self) -> list[int]:
        return [self.rank]

    def run(self, step, args):
        (a,) = args
        gen = step(self.rank, *a)
        reply = None
        while True:
            try:
                req = gen.send(reply)
            except StopIteration as stop:
                return [stop.value]
            reply = self._exchange(req)

    def _exchange(self, req: Exchange) -> torch.Tensor:
        dist = self._dist
        # gloo and NCCL send bytes: carry bool as uint8
        x = req.x.to(torch.uint8) if req.x.dtype == torch.bool else req.x
        x = x.contiguous()
        if req.op in ("sum", "max", "mean"):
            out = x.clone()
            dist.all_reduce(out, dist.ReduceOp.MAX if req.op == "max"
                            else dist.ReduceOp.SUM, group=self.group)
            return out / self.d if req.op == "mean" else out
        if req.op == "gather":
            parts = [torch.empty_like(x) for _ in range(self.d)]
            dist.all_gather(parts, x, group=self.group)
            out = torch.cat(parts)
            return out.to(torch.bool) if req.x.dtype == torch.bool else out
        dst, src = ((self.rank + 1, self.rank - 1) if req.op == "up"
                    else (self.rank - 1, self.rank + 1))
        out = torch.zeros_like(x)
        ops = []
        if 0 <= dst < self.d:
            ops.append(dist.P2POp(dist.isend, x, self._peer(dst),
                                  self.group))
        if 0 <= src < self.d:
            ops.append(dist.P2POp(dist.irecv, out, self._peer(src),
                                  self.group))
        if ops:
            for w in dist.batch_isend_irecv(ops):
                w.wait()
        return out.to(torch.bool) if req.x.dtype == torch.bool else out

    def _peer(self, shard: int) -> int:
        """The global rank of shard ``shard`` of the group."""
        if self.group is None:
            return shard
        return self._dist.get_global_rank(self.group, shard)
