"""A gloo world of CPU processes for the port's data-parallel tests: the
ranks run ``torch_parallel_ranks.py``, started at once and read on demand,
with a join timeout after which every rank is killed."""

import os
import socket
import subprocess
import sys
import time

import torch

HERE = os.path.dirname(os.path.abspath(__file__))
RANKS = os.path.join(HERE, "torch_parallel_ranks.py")


def free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


class World:
    """Start ``world`` ranks running the check ``groups`` on ``inputs``
    (saved to ``workdir/inputs.pt``); :meth:`results` waits for them."""

    def __init__(self, workdir: str, inputs, groups, world: int = 2,
                 timeout_s: float = 500.0):
        self.workdir = workdir
        self.world = world
        self.timeout_s = timeout_s
        torch.save(inputs, os.path.join(workdir, "inputs.pt"))
        env = dict(os.environ, OMP_NUM_THREADS="1")
        port = free_port()
        self.logs = [os.path.join(workdir, f"rank{r}.log")
                     for r in range(world)]
        self.procs = []
        for r, log in enumerate(self.logs):
            with open(log, "w") as f:
                self.procs.append(subprocess.Popen(
                    [sys.executable, RANKS, str(port), str(r), str(world),
                     workdir, *groups], stdout=f, stderr=subprocess.STDOUT,
                    env=env, cwd=os.path.dirname(HERE)))
        self._results = None
        self._failure = None

    def _log(self, r: int) -> str:
        with open(self.logs[r]) as f:
            return f.read()[-4000:]

    def results(self):
        """Every rank's results, in rank order; raises (every time) if a
        rank failed or the world did not finish within the timeout."""
        if self._failure is not None:
            raise AssertionError(self._failure)
        if self._results is None:
            deadline = time.monotonic() + self.timeout_s
            try:
                for p in self.procs:
                    p.wait(timeout=max(1.0, deadline - time.monotonic()))
            except subprocess.TimeoutExpired:
                self.kill()
                self._failure = (f"the world did not finish in "
                                 f"{self.timeout_s} s:\n" + "\n".join(
                                     self._log(r) for r in range(self.world)))
                raise AssertionError(self._failure)
            bad = [r for r, p in enumerate(self.procs) if p.returncode]
            if bad:
                self._failure = "\n".join(
                    f"rank {r} exited {self.procs[r].returncode}:\n"
                    f"{self._log(r)}" for r in bad)
                raise AssertionError(self._failure)
            self._results = [
                torch.load(os.path.join(self.workdir, f"rank{r}.pt"),
                           weights_only=False) for r in range(self.world)]
        return self._results

    def kill(self) -> None:
        for p in self.procs:
            if p.poll() is None:
                p.kill()
            p.wait()
