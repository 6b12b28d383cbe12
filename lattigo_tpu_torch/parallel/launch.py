"""A world of rank processes on one host.

:class:`World` spawns ``size`` processes (``torch.multiprocessing``, the
spawn start method: the parent may hold a CUDA context, which a forked
child cannot use), and they meet at a ``FileStore`` in a temporary
directory, so no port is opened.  ``World.run(fn, *args)`` runs
``fn(*args)`` on every rank and returns the ranks' results in rank order;
``fn`` must be importable by name (a module-level function of an
importable module), and its arguments and result picklable host values (no
CUDA tensors).  If any rank raises, or dies, the world is torn down and
``run`` raises with that rank's traceback.  Ranks write nothing to stdout.

``device_type=None`` means CUDA and raises, before any rank is spawned,
where there is no GPU (``device.resolve``); ``"cpu"`` gives CPU ranks.
On a CUDA world rank r runs on ``cuda:(r % device_count)``.  The backend is
the caller's choice and is never switched: ``"nccl"`` needs one card a rank
and raises otherwise; ``"gloo"`` stages CUDA tensors through the host.
"""

from __future__ import annotations

import datetime
import os
import queue
import tempfile
import time
import traceback

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from lattigo_tpu_torch import _build
from lattigo_tpu_torch import device as _device

TIMEOUT_S = 900  # a collective, or a whole run, that takes longer fails


def check_backend(size: int, backend: str, device_type: str) -> None:
    """Raises where ``backend`` cannot serve ``size`` ranks on ``device_type``."""
    if backend == "nccl":
        if device_type != "cuda":
            raise ValueError("the nccl backend needs CUDA devices")
        cards = torch.cuda.device_count()
        if size > cards:
            raise ValueError(f"the nccl backend takes one card a rank: {size} ranks, "
                             f"{cards} cards (gloo can share a card)")
    elif backend != "gloo":
        raise ValueError(f"unknown backend {backend!r}")


def _serve(rank, size, backend, device_type, store_path, tasks, results):
    torch.set_num_threads(1)  # ranks share the host's cores
    device_id = None
    if device_type == "cuda":
        device_id = torch.device("cuda", rank % torch.cuda.device_count())
        torch.cuda.set_device(device_id)
    store = dist.FileStore(store_path, size)
    dist.init_process_group(backend, store=store, rank=rank, world_size=size,
                            timeout=datetime.timedelta(seconds=TIMEOUT_S),
                            device_id=device_id if backend == "nccl" else None)
    try:
        while (task := tasks.get()) is not None:
            seq, fn, args = task
            results.put((rank, seq, None, fn(*args)))
    finally:
        dist.destroy_process_group()


def _rank_main(*args):
    """A rank's life: serve tasks until told to stop; any exception is sent
    to the parent (which tears the world down) and ends the rank."""
    rank, results = args[0], args[-1]
    try:
        _serve(*args)
    except BaseException:
        results.put((rank, None, traceback.format_exc(), None))
        raise


class World:
    """``size`` rank processes in one process group (see the module doc).
    On a CUDA world, build the kernels (``_build.build()``) before making
    it, so that the ranks do not each run ``nvcc``."""

    def __init__(self, size: int, backend: str = "gloo", device_type: str | None = None):
        if device_type is None:
            device_type = _device.resolve(None).type
        check_backend(size, backend, device_type)
        self.size, self.backend, self.device_type = size, backend, device_type
        ctx = mp.get_context("spawn")
        self._tmp = tempfile.TemporaryDirectory(prefix="lattigo-world-")
        store = os.path.join(self._tmp.name, "store")
        self._tasks = [ctx.Queue() for _ in range(size)]
        self._results = ctx.Queue()
        self._seq = 0
        self._procs = [
            ctx.Process(target=_rank_main, daemon=True,
                        args=(r, size, backend, device_type, store, self._tasks[r],
                              self._results))
            for r in range(size)
        ]
        for p in self._procs:
            p.start()

    def run(self, fn, *args) -> list:
        """``fn(*args)`` on every rank; the results in rank order."""
        if not self._procs:
            raise RuntimeError("the world is closed")
        self._seq += 1
        for q in self._tasks:
            q.put((self._seq, fn, args))
        outs: dict[int, object] = {}
        deadline = time.monotonic() + TIMEOUT_S
        while len(outs) < self.size:
            try:
                rank, seq, err, out = self._results.get(timeout=1.0)
            except queue.Empty:
                dead = [r for r, p in enumerate(self._procs)
                        if r not in outs and p.exitcode is not None]
                if dead or time.monotonic() > deadline:
                    codes = self.close(at_once=True)
                    what = (f"rank {dead[0]} exited with code {codes[dead[0]]}"
                            if dead else f"no result within {TIMEOUT_S} s")
                    raise RuntimeError(f"{fn.__name__} on a world of {self.size}: {what}")
                continue
            if err is not None:
                self.close(at_once=True)
                raise RuntimeError(f"{fn.__name__}: rank {rank} of {self.size} raised:\n{err}")
            outs[rank] = out
        return [outs[r] for r in range(self.size)]

    def close(self, at_once: bool = False) -> list:
        """Stops the ranks (``at_once``: kills them, as after a failure, when
        the others may wait in a collective) and removes the store; returns
        their exit codes.  Safe to call twice."""
        procs, self._procs = self._procs, []
        if not procs:
            return []
        for q, p in zip(self._tasks, procs):
            q.cancel_join_thread()
            if p.is_alive() and not at_once:
                q.put(None)
        deadline = time.monotonic() + (0 if at_once else 10)
        for p in procs:
            p.join(timeout=max(0.0, deadline - time.monotonic()))
        for p in procs:
            if p.is_alive():
                p.kill()
                p.join()
        for q in (*self._tasks, self._results):
            q.close()
        self._tmp.cleanup()
        return [p.exitcode for p in procs]

    def __enter__(self) -> "World":
        return self

    def __exit__(self, *exc) -> None:
        self.close()


def run(size: int, fn, *args, backend: str = "gloo", device_type: str | None = None) -> list:
    """``fn(*args)`` on every rank of a new world of ``size``; the results
    in rank order (see :class:`World`)."""
    with World(size, backend, device_type) as world:
        return world.run(fn, *args)


def traced(fn, *args):
    """``fn(*args)`` on a rank with its kernel launches counted from 0 and
    its transforms recorded: ``(result, launch counts, distinct transforms
    as (moduli, shape, limbs, inverse, route))``.  Run it with
    ``World.run(traced, fn, ...)``."""
    from lattigo_tpu_torch.ops import ring

    _build.reset_launch_counts()
    with ring.record_transforms() as calls:
        out = fn(*args)
    return out, _build.launch_counts(), ring.distinct_transforms(calls)
