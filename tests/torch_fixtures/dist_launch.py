"""Launch a gloo process group of CPU workers for the port's parallel tests.

Each rank is a fresh ``python`` process running
:mod:`dist_child`, which joins the group through
``sparkdl_tpu_torch.parallel.runner.initialize`` (read from
``SPARKDL_COORDINATOR`` / ``SPARKDL_NUM_PROCS`` / ``SPARKDL_PROC_ID``, with
``device="cpu"``: gloo), calls ``module:function(**kwargs)`` from this
directory and writes what it returns with ``torch.save``. The children
import torch and the port only, never JAX or a conftest. The coordinator's
port comes from binding port 0; output goes to files, never pipes (a full
pipe would stall a rank inside a collective); every wait has a deadline,
after which every rank is killed and the test fails with their logs.
Importable without JAX.
"""

import os
import signal
import socket
import subprocess
import sys
import time
from typing import Any, Dict, List, Optional

import torch

FIXTURES = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(os.path.dirname(FIXTURES))

#: each group's deadline: well inside the suite's limits
TIMEOUT_S = 120.0


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class Group:
    """``world`` ranks of ``target`` (``"module:function"`` of this
    directory) started together; :meth:`wait` joins them."""

    def __init__(self, world: int, target: str, kwargs: Optional[Dict[str, Any]],
                 workdir: str, name: str = "group", env: Optional[Dict[str, str]] = None):
        self.world = world
        self.workdir = workdir
        self.name = name
        os.makedirs(workdir, exist_ok=True)
        args_file = os.path.join(workdir, f"{name}_args.pt")
        torch.save(dict(kwargs or {}), args_file)
        port = free_port()
        base = {k: v for k, v in os.environ.items() if k != "PYTHONPATH"}
        base.update(env or {})
        base["PYTHONPATH"] = os.pathsep.join([FIXTURES, REPO])
        base["SPARKDL_COORDINATOR"] = f"127.0.0.1:{port}"
        base["SPARKDL_NUM_PROCS"] = str(world)
        base["OMP_NUM_THREADS"] = "1"
        self.outs = [os.path.join(workdir, f"{name}_rank{r}.pt") for r in range(world)]
        self.logs = [open(os.path.join(workdir, f"{name}_rank{r}.log"), "w+")
                     for r in range(world)]
        self.procs = []
        for r in range(world):
            env_r = dict(base, SPARKDL_PROC_ID=str(r))
            self.procs.append(subprocess.Popen(
                [sys.executable, os.path.join(FIXTURES, "dist_child.py"), target,
                 args_file, self.outs[r]],
                cwd=workdir, env=env_r, stdout=self.logs[r], stderr=subprocess.STDOUT))

    def log(self, rank: int) -> str:
        self.logs[rank].flush()
        self.logs[rank].seek(0)
        return self.logs[rank].read()

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.send_signal(signal.SIGKILL)
        for p in self.procs:
            p.wait()

    def wait(self, timeout_s: float = TIMEOUT_S) -> List[Any]:
        """Every rank's result; raises (after killing every rank) when one
        fails or the deadline passes."""
        deadline = time.monotonic() + timeout_s
        try:
            while any(p.poll() is None for p in self.procs):
                if time.monotonic() > deadline:
                    raise AssertionError(
                        f"{self.name}: the group did not end within {timeout_s:.0f} s\n"
                        + "\n".join(f"--- rank {r}:\n{self.log(r)[-3000:]}"
                                    for r in range(self.world)))
                if any(p.poll() not in (None, 0) for p in self.procs):
                    time.sleep(0.5)  # let the others write their logs
                    break
                time.sleep(0.05)
            bad = [r for r, p in enumerate(self.procs) if p.poll() != 0]
            if bad:
                raise AssertionError(
                    f"{self.name}: rank(s) {bad} failed\n"
                    + "\n".join(f"--- rank {r} (exit {self.procs[r].poll()}):\n"
                                f"{self.log(r)[-4000:]}" for r in range(self.world)))
            return [torch.load(out, weights_only=False) for out in self.outs]
        finally:
            self.kill()
            for lg in self.logs:
                lg.close()


def run_group(world: int, target: str, workdir: str, timeout_s: float = TIMEOUT_S,
              **kwargs) -> List[Any]:
    """Start ``world`` ranks of ``target(**kwargs)`` and return each rank's
    result, in rank order."""
    return Group(world, target, kwargs, workdir, name=target.replace(":", "_")).wait(timeout_s)
