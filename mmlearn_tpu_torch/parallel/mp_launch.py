"""Local multi-process launch, counterpart of :mod:`mmlearn_tpu.parallel.mp_launch`.

Starts N processes on this host with the environment that
``torch.distributed.init_process_group(init_method="env://")`` reads
(``MASTER_ADDR``, ``MASTER_PORT``, ``RANK``, ``WORLD_SIZE``, ``LOCAL_RANK``),
drains each one's merged output from launch on a thread of its own, waits
with one shared deadline, kills every straggler, and raises with the tail of
the output of a worker that failed or timed out. The tests' multi-process
runs and ``chip_smoke.py``'s parallel phase go through it.
"""

from __future__ import annotations

import os
import socket
import subprocess
import threading
import time
from typing import Mapping, Optional, Sequence


def free_port() -> int:
    """An OS-assigned free TCP port on localhost (the rendezvous address)."""
    with socket.socket() as s:
        s.bind(("localhost", 0))
        return s.getsockname()[1]


def worker_env(rank: int, world_size: int, port: int,
               base: Optional[Mapping[str, str]] = None) -> dict[str, str]:
    """``base`` (the caller's environment by default) with the variables of
    rank ``rank`` of ``world_size`` processes meeting at ``localhost:port``."""
    env = dict(os.environ if base is None else base)
    env.update(MASTER_ADDR="localhost", MASTER_PORT=str(port), RANK=str(rank),
               WORLD_SIZE=str(world_size), LOCAL_RANK=str(rank))
    return env


def run_workers(
    cmds: Sequence[Sequence[str]],
    *,
    env: Optional[Mapping[str, str]] = None,
    cwd: Optional[str] = None,
    timeout: float = 600,
    tail: int = 40,
    port: Optional[int] = None,
) -> list[str]:
    """Run ``cmds[r]`` as rank ``r`` of ``len(cmds)`` processes, all started
    before any is waited on (they rendezvous with each other); return each
    one's merged stdout and stderr.

    ``env`` is the base environment of every worker (the caller's by
    default); :func:`worker_env` adds the rendezvous variables, at ``port``
    (a free one by default). ``timeout`` is one deadline for the group. A
    worker that passes it or exits non-zero raises ``RuntimeError`` with the
    last ``tail`` lines of its output; the others are killed first.
    """
    port = free_port() if port is None else int(port)
    procs = [
        subprocess.Popen(list(cmd), stdout=subprocess.PIPE, stderr=subprocess.STDOUT, text=True,
                         env=worker_env(rank, len(cmds), port, env), cwd=cwd)
        for rank, cmd in enumerate(cmds)
    ]
    outputs = [""] * len(procs)

    def drain(i: int, p: subprocess.Popen) -> None:
        outputs[i] = p.stdout.read() or ""  # type: ignore[union-attr]

    threads = [threading.Thread(target=drain, args=(i, p), daemon=True)
               for i, p in enumerate(procs)]
    for t in threads:
        t.start()
    deadline = time.monotonic() + timeout
    timed_out: Optional[int] = None
    failed: Optional[int] = None
    try:
        pending = set(range(len(procs)))
        while pending and timed_out is None and failed is None:
            for i in sorted(pending):
                rc = procs[i].poll()
                if rc is not None:
                    pending.discard(i)
                    if rc != 0:
                        failed = i  # the others would wait on it at their next collective
                        break
            if time.monotonic() > deadline and pending:
                timed_out = min(pending)
            elif pending:
                time.sleep(0.05)
    finally:
        for p in procs:
            if p.poll() is None:
                p.kill()
        for p in procs:
            p.wait()
        for t in threads:  # EOF after the kill ends each drain
            t.join(timeout=30)
    if timed_out is not None:
        snippet = "\n".join(outputs[timed_out].splitlines()[-tail:])
        raise RuntimeError(f"worker {timed_out}/{len(procs)} timed out after {timeout}s:\n"
                           f"{snippet}")
    for i, (p, out) in enumerate(zip(procs, outputs)):
        if p.returncode != 0 and (failed is None or i == failed):
            snippet = "\n".join(out.splitlines()[-tail:])
            raise RuntimeError(f"worker {i}/{len(procs)} failed (rc={p.returncode}):\n{snippet}")
    return outputs
