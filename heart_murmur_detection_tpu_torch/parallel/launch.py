"""Start the ranks of a data-parallel or dp x tp run and return rank 0's
result.

    launch(fn, n, *args, backend=None, device="cuda", tp=1, **kwargs)

runs fn(mesh, *args, **kwargs) in n processes (the spawn start method,
rendezvous through a file store in a temporary directory), each with the
mesh of its rank (parallel/mesh.py: a DataParallelMesh, or with tp > 1 the
TensorParallelMesh of n / tp data ranks by tp model ranks), and returns
what rank 0's fn returned. fn must be importable by name (a module-level
function).
backend: "nccl" (the default on a card: one card a rank) or "gloo" (the
default on the CPU; on a card, gloo ranks share cards round robin). On the
CPU each rank runs one intra-op thread.

Inside a process group already set up by torchrun's environment (RANK,
WORLD_SIZE, MASTER_ADDR), launch runs fn in this process, as this rank, and
returns its result.

A rank that raises ends the run: the others get a short grace to finish or
fail on their own and are then terminated; the first failing rank's
exception is raised here, its traceback chained.
"""

from __future__ import annotations

import os
import pickle
import shutil
import tempfile
import time
import traceback
from multiprocessing.connection import wait

import torch
import torch.distributed as dist
import torch.multiprocessing as mp

from .mesh import (check_backend, data_parallel_mesh, default_backend, init_group, mesh_2d,
                   rank_device)

GRACE_S = 10.0  # after a rank fails, how long the others get to end on their own


class RankError(RuntimeError):
    """A rank's exception that did not survive pickling."""


def _in_torchrun() -> bool:
    return dist.is_initialized() or all(k in os.environ for k in ("RANK", "WORLD_SIZE",
                                                                   "MASTER_ADDR"))


def rank_mesh(n: int, tp: int, backend, device):
    """The mesh of this rank of an n-rank group: 1-D, or n / tp by tp."""
    if tp == 1:
        return data_parallel_mesh(n, backend, device)
    if n % tp:
        raise ValueError(f"{n} ranks do not divide into a tensor axis of {tp}")
    return mesh_2d(n // tp, tp, backend, device)


def _rank_main(rank, n, tp, backend, device, tmp, fn, args, kwargs):
    try:
        if torch.device(device).type == "cpu":
            torch.set_num_threads(1)
        init_group(backend, rank, n, f"file://{os.path.join(tmp, 'store')}",
                   rank_device(device, rank))
        out = fn(rank_mesh(n, tp, backend, device), *args, **kwargs)
        if rank == 0:
            part = os.path.join(tmp, "result.part")
            torch.save(out, part)
            os.replace(part, os.path.join(tmp, "result.pt"))
        dist.destroy_process_group()
    except BaseException as e:  # noqa: BLE001 — handed to the parent
        tb = traceback.format_exc()
        try:
            blob = pickle.dumps(e)
        except Exception:  # noqa: BLE001
            blob = pickle.dumps(RankError(f"{type(e).__name__}: {e}"))
        with open(os.path.join(tmp, f"error-{rank}.pkl"), "wb") as f:
            pickle.dump((blob, tb), f)
        raise SystemExit(1)


def launch(fn, n: int, *args, backend=None, device="cuda", tp: int = 1, **kwargs):
    """fn(mesh, *args, **kwargs) on n ranks (tp of them on each tensor
    axis) -> rank 0's result."""
    if _in_torchrun():
        return fn(rank_mesh(n, tp, backend, device), *args, **kwargs)
    device = torch.device(device)
    backend = backend or default_backend(device)
    check_backend(backend, n, device)
    if device.type == "cuda" and not torch.cuda.is_available():
        raise RuntimeError("device='cuda' but no CUDA card is available (pass device='cpu')")
    tmp = tempfile.mkdtemp(prefix="hmdt-ranks-")
    ctx = mp.get_context("spawn")
    procs = [ctx.Process(target=_rank_main, args=(r, n, tp, backend, str(device), tmp, fn,
                                                  args, kwargs))
             for r in range(n)]
    try:
        for p in procs:
            p.start()
        alive, deadline = list(procs), None
        while alive:
            timeout = None if deadline is None else max(deadline - time.time(), 0.0)
            wait([p.sentinel for p in alive], timeout)
            for p in [p for p in alive if p.exitcode is not None]:
                alive.remove(p)
                if p.exitcode != 0 and deadline is None:
                    deadline = time.time() + GRACE_S
            if deadline is not None and time.time() >= deadline:
                for p in alive:
                    p.terminate()
                for p in alive:
                    p.join()
                break
        errors = sorted(f for f in os.listdir(tmp) if f.startswith("error-"))
        if errors:
            with open(os.path.join(tmp, errors[0]), "rb") as f:
                blob, tb = pickle.load(f)
            raise pickle.loads(blob) from RankError(f"rank {errors[0][6:-4]}:\n{tb}")
        bad = [(i, p.exitcode) for i, p in enumerate(procs) if p.exitcode != 0]
        if bad:
            raise RankError(f"ranks ended without a result: (rank, exit code) {bad}")
        return torch.load(os.path.join(tmp, "result.pt"), map_location="cpu", weights_only=False)
    finally:
        for p in procs:
            if p.is_alive():
                p.terminate()
                p.join()
        shutil.rmtree(tmp, ignore_errors=True)
