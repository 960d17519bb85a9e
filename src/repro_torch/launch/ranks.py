"""Run one function on N ranks, each a process of its own, and collect
what each returns.

`spawn` starts ``world`` Python processes that join one
``torch.distributed`` process group (a ``FileStore`` in a temporary
directory: no port), call ``module:function(**kwargs)`` and write its
result, which must be picklable by ``torch.save``; each has the
environment ``torch.distributed.run`` gives a rank (``RANK``,
``LOCAL_RANK``, ``WORLD_SIZE``, ``LOCAL_WORLD_SIZE``). Each rank has a time
limit: the process group's timeout, so a collective that never
completes raises, and a bounded wait on every process, which kills them
all when it passes. The tests and ``chip_smoke.py`` put ranks on the CPU
or on one card this way, over gloo; ``python -m
torch.distributed.run`` launches the train driver's ranks instead.

  python -m repro_torch.launch.ranks MODULE:FUNCTION DIR RANK WORLD \\
      BACKEND TIMEOUT        (one rank; `spawn` runs it)
"""
from __future__ import annotations

import contextlib
import datetime
import importlib
import os
import subprocess
import sys
import tempfile
import time
from pathlib import Path

import torch
import torch.distributed as dist

SRC = Path(__file__).resolve().parents[2]


def spawn(target: str, world: int, kwargs: dict | None = None, *,
          backend: str = "gloo", timeout_s: float = 120.0,
          echo: bool = False) -> list:
    """``target`` ("module:function") on ranks 0..world-1; returns their
    results in rank order. Raises with the ranks' last lines of output
    if a rank fails, and TimeoutError (after killing every rank) if they
    have not all ended within ``timeout_s`` seconds. ``echo`` prints
    rank 0's output when it ends."""
    with tempfile.TemporaryDirectory(prefix="ranks-") as tmp, \
            contextlib.ExitStack() as files:
        torch.save(kwargs or {}, Path(tmp) / "kwargs.pt")
        env = dict(os.environ)
        env["PYTHONPATH"] = os.pathsep.join(
            [str(SRC), os.getcwd()] + [p for p in env.get(
                "PYTHONPATH", "").split(os.pathsep) if p])
        logs = [files.enter_context(open(Path(tmp) / f"rank{r}.log", "w+b"))
                for r in range(world)]
        procs = [subprocess.Popen(
            [sys.executable, "-m", "repro_torch.launch.ranks", target, tmp,
             str(r), str(world), backend, str(timeout_s)],
            env={**env, "RANK": str(r), "LOCAL_RANK": str(r),
                 "WORLD_SIZE": str(world), "LOCAL_WORLD_SIZE": str(world)},
            stdout=logs[r], stderr=subprocess.STDOUT)
            for r in range(world)]
        deadline = time.monotonic() + timeout_s
        try:
            for p in procs:
                p.wait(timeout=max(deadline - time.monotonic(), 0.1))
        except subprocess.TimeoutExpired:
            for p in procs:
                p.kill()
            for p in procs:
                p.wait()
            raise TimeoutError(f"{target} on {world} ranks did not end within "
                               f"{timeout_s} s:\n{_tails(logs)}") from None
        if echo:
            logs[0].seek(0)
            print(logs[0].read().decode(errors="replace"), end="", flush=True)
        failed = [r for r, p in enumerate(procs) if p.returncode]
        if failed:
            raise RuntimeError(f"{target} failed on ranks {failed}:\n"
                               f"{_tails(logs)}")
        return [torch.load(Path(tmp) / f"result{r}.pt", weights_only=False)
                for r in range(world)]


def _tails(logs, n: int = 4000) -> str:
    out = []
    for r, f in enumerate(logs):
        f.seek(0)
        out.append(f"--- rank {r}\n"
                   + f.read().decode(errors="replace")[-n:])
    return "\n".join(out)


def _main(argv) -> None:
    target, tmp, rank, world, backend, timeout_s = argv
    rank, world = int(rank), int(world)
    dist.init_process_group(
        backend, init_method=f"file://{Path(tmp) / 'store'}", rank=rank,
        world_size=world,
        timeout=datetime.timedelta(seconds=float(timeout_s)))
    try:
        module, name = target.split(":")
        fn = getattr(importlib.import_module(module), name)
        result = fn(**torch.load(Path(tmp) / "kwargs.pt", weights_only=False))
        torch.save(result, Path(tmp) / f"result{rank}.pt")
    finally:
        dist.destroy_process_group()


if __name__ == "__main__":
    _main(sys.argv[1:])
