"""Start ranks of one program and collect their results: the port's
counterpart of provisioning virtual devices for ``shard_map``.

JAX shards inside one process; PyTorch runs one process per rank, joined by
``torch.distributed``. :func:`run_ranks` spawns them (the ``spawn`` start
method: the caller may hold threads, as a process with JAX initialized
does, and ``fork`` would copy them), meets them at a ``FileStore`` in a
temporary directory (no TCP port to collide with another run), gives
``init_process_group`` an explicit timeout, and returns each rank's result
as numpy. A rank that raises or dies, or a run that outlasts the timeout,
fails the call instead of hanging it.

:func:`process_group` opens and closes a group in the calling process, for
one rank of a run started elsewhere, or a world of one (as
``chip_smoke.py`` opens its one-card NCCL group).
"""

from __future__ import annotations

import contextlib
import datetime
import multiprocessing as mp
import os
import queue as queue_mod
import tempfile
import time
import traceback
from typing import Callable, Optional

import torch
import torch.distributed as dist


@contextlib.contextmanager
def process_group(backend: str, world_size: int = 1, rank: int = 0, *,
                  store_dir: Optional[str] = None, timeout_s: float = 60.0):
    """Initialize the default process group for this rank, from a
    ``FileStore`` in ``store_dir`` (a fresh temporary directory when None,
    which serves a world of one), and destroy it on exit. With ``nccl`` the
    rank takes card ``rank % device_count``."""
    with contextlib.ExitStack() as stack:
        if store_dir is None:
            store_dir = stack.enter_context(tempfile.TemporaryDirectory())
        os.makedirs(store_dir, exist_ok=True)
        if backend == "nccl":
            torch.cuda.set_device(rank % torch.cuda.device_count())
        store = dist.FileStore(os.path.join(store_dir, "store"), world_size)
        dist.init_process_group(backend, store=store, rank=rank, world_size=world_size,
                                timeout=datetime.timedelta(seconds=timeout_s))
        try:
            yield
        finally:
            dist.destroy_process_group()


def to_numpy(out):
    """Tensors as numpy arrays, through dicts, lists and tuples."""
    if isinstance(out, torch.Tensor):
        return out.detach().cpu().numpy()
    if isinstance(out, dict):
        return {k: to_numpy(v) for k, v in out.items()}
    if isinstance(out, (list, tuple)):
        return type(out)(to_numpy(v) for v in out)
    return out


def _rank_main(fn, rank, world_size, backend, store_dir, timeout_s, args, results):
    torch.set_num_threads(1)
    try:
        with process_group(backend, world_size, rank, store_dir=store_dir,
                           timeout_s=timeout_s):
            out = to_numpy(fn(*args))
        results.put((rank, True, out))
    except BaseException:  # noqa: BLE001 - the parent reports it
        results.put((rank, False, traceback.format_exc()))
        raise SystemExit(1)


def run_ranks(fn: Callable, world_size: int, *, backend: str = "gloo",
              timeout_s: float = 60.0, args: tuple = (),
              store_dir: Optional[str] = None) -> list:
    """``fn(*args)`` on ``world_size`` spawned ranks joined in one default
    group; returns their results in rank order, tensors as numpy.

    ``fn`` must be importable by name from a module (the spawned ranks
    import it; keep that module light, as each rank imports it at start).
    ``timeout_s`` bounds the whole run and each collective: a rank that
    raises or dies, or a run past it, raises ``RuntimeError`` with what the
    ranks reported, after the others are stopped."""
    ctx = mp.get_context("spawn")
    results = ctx.Queue()
    with contextlib.ExitStack() as stack:
        if store_dir is None:
            store_dir = stack.enter_context(tempfile.TemporaryDirectory())
        procs = [ctx.Process(target=_rank_main, daemon=True,
                             args=(fn, r, world_size, backend, store_dir, timeout_s, args,
                                   results))
                 for r in range(world_size)]
        for p in procs:
            p.start()
        got, errors = {}, []

        def take(item):
            r, ok, out = item
            if ok:
                got[r] = out
            else:
                errors.append((r, out))

        deadline = time.monotonic() + timeout_s
        try:
            while len(got) < world_size and not errors:
                try:
                    take(results.get(timeout=0.2))
                    continue
                except queue_mod.Empty:
                    pass
                dead = [i for i, p in enumerate(procs) if i not in got and p.exitcode is not None]
                if dead:
                    time.sleep(0.5)  # its last result may still be in the pipe
                    while not results.empty():
                        take(results.get())
                    missing = [i for i in dead if i not in got]
                    if missing and not errors:
                        errors.append((missing[0], f"exited with code "
                                       f"{procs[missing[0]].exitcode} without a result"))
                elif time.monotonic() > deadline:
                    errors.append((-1, f"timed out after {timeout_s} s with ranks "
                                       f"{sorted(set(range(world_size)) - set(got))} running"))
            if errors:  # the other ranks' reports, which may name the cause
                time.sleep(0.5)
                while not results.empty():
                    take(results.get())
        finally:
            for p in procs:
                if p.is_alive() and errors:
                    p.terminate()
            for p in procs:
                p.join(timeout=10)
                if p.is_alive():
                    p.kill()
                    p.join()
            results.close()
        if errors:
            raise RuntimeError("\n".join(f"rank {r} of {world_size} failed:\n{msg}"
                                         for r, msg in sorted(errors)))
    return [got[r] for r in range(world_size)]

