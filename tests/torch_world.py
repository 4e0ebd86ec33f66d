"""Gloo worlds of the port for the distributed tests.

``run_world(size, target, workdir, **kwargs)`` starts `size` fresh
interpreters (``torch_world_worker.py``), each a rank of one gloo group
that meets through a ``FileStore`` file under `workdir` (no port, so
pytest-xdist workers cannot collide), builds the CPU mesh and calls
``target`` ("module:function", a module of the port or of tests/ that
imports no jax) as ``function(mesh, **kwargs)``.  Every rank's return
value comes back, pickled, in rank order.  A world that has not ended
within `timeout` seconds is killed, every rank of it."""

import os
import pickle
import subprocess
import sys
import time

TESTS = os.path.dirname(os.path.abspath(__file__))
REPO = os.path.dirname(TESTS)
WORKER = os.path.join(TESTS, "torch_world_worker.py")


def run_world(size: int, target: str, workdir, timeout: float = 120.0,
              **kwargs) -> list:
    workdir = os.path.join(str(workdir), f"world{size}-{target.replace(':', '.')}")
    os.makedirs(workdir, exist_ok=True)
    with open(os.path.join(workdir, "kwargs.pkl"), "wb") as f:
        pickle.dump(kwargs, f)
    env = dict(os.environ)
    env["PYTHONPATH"] = os.pathsep.join(
        [REPO, TESTS] + ([env["PYTHONPATH"]] if env.get("PYTHONPATH") else []))
    env["OMP_NUM_THREADS"] = "1"
    logs = [open(os.path.join(workdir, f"rank{r}.log"), "w+")
            for r in range(size)]
    procs = [subprocess.Popen(
        [sys.executable, WORKER, target, str(r), str(size), workdir],
        stdout=logs[r], stderr=subprocess.STDOUT, env=env, cwd=workdir)
        for r in range(size)]
    deadline = time.monotonic() + timeout
    try:
        for p in procs:
            p.wait(timeout=max(deadline - time.monotonic(), 0.1))
    except subprocess.TimeoutExpired:
        pass
    finally:
        killed = [p for p in procs if p.poll() is None]
        for p in killed:
            p.kill()
        for p in procs:
            p.wait()
    tails = []
    for r, log in enumerate(logs):
        log.seek(0)
        tails.append(f"--- rank {r} ---\n" + log.read()[-3000:])
        log.close()
    if killed or any(p.returncode != 0 for p in procs):
        raise RuntimeError(
            f"gloo world of {size} running {target} "
            + (f"cut after {timeout:.0f} s" if killed else "failed")
            + ":\n" + "\n".join(tails))
    out = []
    for r in range(size):
        with open(os.path.join(workdir, f"rank{r}.pkl"), "rb") as f:
            out.append(pickle.load(f))
    return out
