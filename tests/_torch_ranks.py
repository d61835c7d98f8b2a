"""Run jobs of the port on several gloo ranks on the CPU.

``run_ranks(jobs, world, payload)`` starts ``world`` fresh processes of
this file with ``torch.distributed.run``'s environment (``RANK``,
``WORLD_SIZE``, ``MASTER_ADDR`` / ``MASTER_PORT`` on localhost,
``LOCAL_RANK``), one intra-op thread each; every rank joins the group
through the port's ``parallel.process_group("cpu")`` (gloo), runs each
named job (a function of ``tests/_torch_rank_jobs.py``) on
``payload[job]`` and pickles its results;
the caller gets one ``{job: result}`` a rank. The processes import torch
and the port only: the tests compute the JAX references themselves.
"""

from __future__ import annotations

import os
import pickle
import socket
import subprocess
import sys
import tempfile

REPO = os.path.dirname(os.path.dirname(os.path.abspath(__file__)))


def _free_port() -> int:
    with socket.socket() as s:
        s.bind(("127.0.0.1", 0))
        return s.getsockname()[1]


def run_ranks(jobs, world: int, payload: dict | None = None,
              timeout: float = 240.0) -> list[dict]:
    """Each rank's ``{job: result}``; raises with a failing rank's
    stderr."""
    port = _free_port()
    with tempfile.TemporaryDirectory() as tmp:
        src = os.path.join(tmp, "payload.pkl")
        with open(src, "wb") as f:
            pickle.dump({"jobs": list(jobs), "payload": payload or {},
                         "tmp": tmp}, f)
        procs = []
        for rank in range(world):
            env = {**os.environ, "RANK": str(rank),
                   "WORLD_SIZE": str(world), "LOCAL_RANK": str(rank),
                   "LOCAL_WORLD_SIZE": str(world),
                   "MASTER_ADDR": "127.0.0.1", "MASTER_PORT": str(port),
                   "OMP_NUM_THREADS": "1"}
            out = os.path.join(tmp, f"rank{rank}.pkl")
            procs.append(subprocess.Popen(
                [sys.executable, os.path.abspath(__file__), src, out],
                cwd=REPO, env=env, stdout=subprocess.PIPE,
                stderr=subprocess.PIPE, text=True))
        errors = []
        for rank, p in enumerate(procs):
            try:
                _, err = p.communicate(timeout=timeout)
            except subprocess.TimeoutExpired:
                for q in procs:
                    q.kill()
                raise
            if p.returncode:
                errors.append(f"rank {rank} exited {p.returncode}:\n"
                              f"{err[-3000:]}")
        if errors:
            raise AssertionError("\n".join(errors))
        results = []
        for rank in range(world):
            with open(os.path.join(tmp, f"rank{rank}.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results


def _main(src: str, out: str) -> None:
    sys.path.insert(0, REPO)
    sys.path.insert(0, os.path.dirname(os.path.abspath(__file__)))
    import torch

    torch.set_num_threads(1)
    import _torch_rank_jobs as jobs
    from improving_face_recognition_performance_using_triplet_loss_tpu_torch.parallel import (
        process_group,
    )

    with open(src, "rb") as f:
        spec = pickle.load(f)
    results = {}
    with process_group("cpu"):
        for name in spec["jobs"]:
            payload = spec["payload"].get(name)
            results[name] = getattr(jobs, name)(
                {"tmp": spec["tmp"], **(payload or {})})
    with open(out, "wb") as f:
        pickle.dump(results, f)


if __name__ == "__main__":
    _main(sys.argv[1], sys.argv[2])
