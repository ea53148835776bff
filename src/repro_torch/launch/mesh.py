"""Process groups of the pod round (counterpart of ``repro/launch/mesh.py``).

The reference lays the pod's clients on a ``jax.sharding.Mesh`` axis,
one client per device (``make_host_mesh``). The port runs one client per
rank of a ``torch.distributed`` process group instead:

* :func:`run_ranks` starts W ranks with the ``spawn`` start method (CUDA
  cannot be initialised before a fork), meets them through a ``file://``
  store in a temporary directory (no fixed port, so parallel test workers
  never collide), gives the collectives an explicit timeout, returns each
  rank's result in rank order and, when one rank raises, stops the others
  and raises its traceback;
* :func:`init_rank` joins a group as one rank, from :func:`run_ranks` or
  from ``torchrun``'s environment (``RANK``, ``WORLD_SIZE``);
* :class:`RankGroup` is one rank's view of the group: its rank, device
  and transport, and the two collectives the pod backends use, an
  all-gather and a ring hop.

The transport is explicit (:func:`resolve_dist_backend`): ``gloo`` on the
CPU; on the card ``nccl`` with one card a rank by default, refused with
fewer cards than ranks; or ``gloo`` on the card, where the ranks share
card 0 and every collective stages its tensors through host memory
(gloo takes no CUDA tensors for send and receive). The staging is a
named mode (:attr:`RankGroup.transport`), chosen by the caller, never a
fallback: the compute stays on the card.

The dry-run's meshes (:func:`make_production_mesh`,
:func:`make_host_mesh`, entered through :func:`fake_mesh`) are
``DeviceMesh`` layouts over a ``"fake"`` process group of rank 0: no
device and no peer exists, and DTensor's collectives return at once. The
layout is the reference's chip counts and axis names on H100 nodes:

* one pod: ``(data=32, model=8)``, 256 cards;
* two pods: ``(pod=2, data=32, model=8)``, 512 cards.

The ``model`` axis is one 8-card NVLink domain (a node), where the
reference's ``(16, 16)`` is a TPU v5e torus; ``data`` and ``pod`` cross
nodes.
"""
from __future__ import annotations

import contextlib
import datetime
import math
import os
import queue
import tempfile
import time
import traceback
from typing import Any, Callable, List

import torch
import torch.distributed as dist

from repro_torch import tracing
from repro_torch.utils import (
    PackedTree, pack_leaves, tree_leaves, tree_map, unpack_leaves)

DIST_BACKENDS = ("nccl", "gloo")
# a collective that waits longer than this fails instead of hanging
DEFAULT_TIMEOUT_S = 300.0


def resolve_dist_backend(device_type: str, requested, world_size: int
                         ) -> str:
    """The group's backend for ranks on ``device_type``: ``gloo`` on the
    CPU (``nccl`` raises), ``nccl`` by default on the card, where it needs
    a card a rank."""
    if device_type == "cpu":
        if requested not in (None, "gloo"):
            raise ValueError(f"--dist-backend {requested} needs CUDA "
                             "devices; ranks on the CPU use gloo")
        return "gloo"
    backend = requested or "nccl"
    if backend not in DIST_BACKENDS:
        raise ValueError(f"dist backend must be one of {DIST_BACKENDS}, "
                         f"got {backend!r}")
    if backend == "nccl":
        cards = torch.cuda.device_count()
        if cards < world_size:
            raise ValueError(
                f"nccl runs one rank a card: {world_size} ranks, {cards} "
                "card(s); pass --dist-backend gloo to share a card")
    return backend


def rank_device(device_type: str, rank: int) -> torch.device:
    """Rank ``rank``'s device: ``cpu``, or card ``rank % device_count``
    (card 0 for every rank on a one-card machine)."""
    if device_type == "cpu":
        return torch.device("cpu")
    return torch.device("cuda", rank % max(torch.cuda.device_count(), 1))


class RankGroup:
    """One rank of the pod's process group, on ``device``.

    ``staged`` (gloo with the rank on the card) copies every tensor a
    collective sends to host memory and every tensor it receives back to
    the card. With tracing on (:mod:`repro_torch.tracing`) each
    collective is a ``pod.exchange`` span, ``pod.exchange.calls`` counts
    them (a ring hop once, at its finish) and ``pod.bytes_staged`` the
    staged copies' bytes, both ways. The device is synchronised around a
    collective where the staging's host copies need it, and under nccl
    only while tracing is on, so that a span's host time holds the
    exchange and not queued compute.
    """

    def __init__(self, rank: int, world_size: int, device, backend: str):
        self.rank = int(rank)
        self.world_size = int(world_size)
        self.device = torch.device(device)
        self.backend = backend
        self.staged = backend == "gloo" and self.device.type == "cuda"

    @property
    def transport(self) -> str:
        """The transport's name, as the run's first line prints it."""
        if self.staged:
            return "gloo, staged through host memory"
        return self.backend

    def _sync(self) -> None:
        if self.device.type == "cuda" and (self.staged or tracing.enabled()):
            torch.cuda.synchronize(self.device)

    def _send(self, t: torch.Tensor) -> torch.Tensor:
        t = t.contiguous()
        if self.staged:
            tracing.count("pod.bytes_staged", t.numel() * t.element_size())
            return t.cpu()
        return t

    def _recv(self, t: torch.Tensor) -> torch.Tensor:
        if self.staged:
            tracing.count("pod.bytes_staged", t.numel() * t.element_size())
            return t.to(self.device)
        return t

    def all_gather(self, t: torch.Tensor) -> torch.Tensor:
        """Every rank's ``t`` concatenated along axis 0 in rank order:
        ``[W * t.shape[0], ...]``. Exact: no arithmetic touches the
        values."""
        self._sync()
        with tracing.span("pod.exchange"):
            x = self._send(t)
            if self.backend == "nccl":
                out = x.new_empty((self.world_size * x.shape[0],)
                                  + tuple(x.shape[1:]))
                dist.all_gather_into_tensor(out, x)
            else:
                parts = [torch.empty_like(x)
                         for _ in range(self.world_size)]
                dist.all_gather(parts, x)
                out = torch.cat(parts)
            out = self._recv(out)
            self._sync()
        tracing.count("pod.exchange.calls")
        return out

    def gather_tree(self, tree):
        """Every rank's param tree stacked on a leading ``[W]`` axis, one
        all-gather a dtype; each leaf contiguous (the kernels take no
        strided operand)."""
        leaves = tree_leaves(tree)
        plan, flats = pack_leaves(leaves)
        full = [self.all_gather(f[None]) for f in flats]      # [W, size]
        parts = iter(unpack_leaves(plan, full,
                                   [tuple(t.shape) for t in leaves],
                                   lead=(self.world_size,)))
        return tree_map(lambda _: next(parts).contiguous(), tree)

    def hop_start(self, packed: PackedTree):
        """Issue one ring hop of ``packed``: its buffers go to rank + 1
        and the buffers of rank - 1 come in. Returns the handle
        :meth:`hop_finish` waits on."""
        self._sync()
        with tracing.span("pod.exchange"):
            send = [self._send(f) for f in packed.flats]
            recv = [torch.empty_like(s) for s in send]
            nxt = (self.rank + 1) % self.world_size
            prev = (self.rank - 1) % self.world_size
            ops = ([dist.P2POp(dist.isend, s, nxt) for s in send]
                   + [dist.P2POp(dist.irecv, r, prev) for r in recv])
            works = dist.batch_isend_irecv(ops)
        return packed, send, recv, works

    def hop_finish(self, handle) -> PackedTree:
        """Wait for a hop: the tree that rank - 1 sent."""
        packed, _send, recv, works = handle
        with tracing.span("pod.exchange"):
            for w in works:
                w.wait()
            out = packed._replace(flats=[self._recv(r) for r in recv])
            self._sync()
        tracing.count("pod.exchange.calls")
        return out

    def barrier(self) -> None:
        dist.barrier()


def init_rank(rank: int, world_size: int, device_type: str, backend: str,
              init_method: str = "env://",
              timeout_s: float = DEFAULT_TIMEOUT_S) -> RankGroup:
    """Join the group as ``rank`` and return its :class:`RankGroup`. The
    rank's device goes through ``resolve_device`` (TF32 off, cuDNN
    deterministic, as every run of the port); on the card it becomes the
    current device before the group starts (nccl binds to it)."""
    from repro_torch.core.engine import resolve_device
    device = resolve_device(rank_device(device_type, rank))
    if device.type == "cuda":
        torch.cuda.set_device(device)
    dist.init_process_group(
        backend, init_method=init_method, rank=rank, world_size=world_size,
        timeout=datetime.timedelta(seconds=timeout_s))
    return RankGroup(rank, world_size, device, backend)


def _rank_entry(fn, rank, world_size, device_type, backend, init_method,
                timeout_s, threads, args, results) -> None:
    """A spawned rank: join, run ``fn(group, *args)``, report ``(rank,
    ok, result or traceback)`` and leave the group."""
    if threads:
        torch.set_num_threads(threads)
    try:
        group = init_rank(rank, world_size, device_type, backend,
                          init_method, timeout_s)
        try:
            out = fn(group, *args)
        finally:
            dist.destroy_process_group()
    except (Exception, SystemExit):    # the parent re-raises it
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)
    results.put((rank, True, out))


def run_ranks(fn: Callable, world_size: int, *args: Any,
              device_type: str = "cpu", backend: str = "gloo",
              timeout_s: float = DEFAULT_TIMEOUT_S, threads: int = 0,
              join_timeout_s: float = None) -> List[Any]:
    """Run ``fn(group, *args)`` on ``world_size`` spawned ranks and return
    their results in rank order. ``fn`` and ``args`` are pickled (a
    module-level function; results that pickle, such as numpy arrays).
    ``threads`` > 0 sets each rank's torch thread count. When a rank
    raises or dies, or the whole run outlasts ``join_timeout_s`` (None:
    no limit beyond the collectives' own ``timeout_s``), the other ranks
    are stopped and a ``RuntimeError`` carries every failure reported."""
    import multiprocessing as mp
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    deadline = (None if join_timeout_s is None
                else time.monotonic() + join_timeout_s)
    with tempfile.TemporaryDirectory(prefix="repro_torch_ranks_") as tmp:
        init_method = "file://" + os.path.join(tmp, "rendezvous")
        procs = [ctx.Process(
            target=_rank_entry,
            args=(fn, r, world_size, device_type, backend, init_method,
                  timeout_s, threads, args, results), daemon=True)
            for r in range(world_size)]
        for p in procs:
            p.start()
        done, failures = {}, {}
        try:
            while len(done) + len(failures) < world_size:
                try:
                    rank, ok, out = results.get(timeout=0.5)
                except queue.Empty:
                    if failures:
                        break       # the first failure's peers had time
                    dead = [r for r, p in enumerate(procs)
                            if p.exitcode not in (None, 0)]
                    if dead:
                        # a rank that died without reporting (a signal,
                        # or its start failed); one that reported is
                        # still in the queue
                        try:
                            rank, ok, out = results.get(timeout=2.0)
                        except queue.Empty:
                            failures[dead[0]] = (f"exited with code "
                                                 f"{procs[dead[0]].exitcode}")
                            break
                    elif (deadline is not None
                          and time.monotonic() > deadline):
                        waiting = sorted(set(range(world_size)) - set(done))
                        failures[waiting[0]] = (
                            f"ranks {waiting} did not finish within "
                            f"{join_timeout_s:.0f} s")
                        break
                    else:
                        continue
                if ok:
                    done[rank] = out
                else:
                    failures[rank] = out
        finally:
            for p in procs:
                if failures and p.is_alive():
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join(timeout=10)
    # every failure that arrived: the rank at fault and the peers it left
    # blocked in a collective
    if failures:
        raise RuntimeError("\n".join(f"rank {r} failed:\n{msg}"
                                      for r, msg in sorted(failures.items())))
    return [done[r] for r in range(world_size)]


# the dry-run's layouts: (shape, axis names), one pod and two
PRODUCTION_MESHES = {False: ((32, 8), ("data", "model")),
                     True: ((2, 32, 8), ("pod", "data", "model"))}


@contextlib.contextmanager
def fake_mesh(shape, axes):
    """A ``DeviceMesh`` of ``shape`` and ``axes`` on the ``cpu`` device
    over a ``"fake"`` process group of rank 0 and ``prod(shape)`` ranks.
    The group is made here only if none exists (one of that size must
    then), and destroyed on exit only if it was made here."""
    from torch.distributed.device_mesh import init_device_mesh
    from torch.testing._internal.distributed.fake_pg import FakeStore
    n = math.prod(shape)
    made = not dist.is_initialized()
    if made:
        dist.init_process_group("fake", store=FakeStore(), rank=0,
                                world_size=n)
    elif dist.get_world_size() != n:
        raise RuntimeError(f"a process group of {dist.get_world_size()} "
                           f"ranks exists; the mesh {shape} needs {n}")
    try:
        yield init_device_mesh("cpu", tuple(shape), mesh_dim_names=axes)
    finally:
        if made:
            dist.destroy_process_group()


def make_production_mesh(*, multi_pod: bool = False):
    """The production mesh (see the module's docstring) as a context
    manager: ``with make_production_mesh(multi_pod=True) as mesh``."""
    return fake_mesh(*PRODUCTION_MESHES[multi_pod])


def make_host_mesh(shape=(1, 1), axes=("data", "model")):
    """One card's mesh (by default; a tiny mesh for tests), as a context
    manager."""
    return fake_mesh(shape, axes)
