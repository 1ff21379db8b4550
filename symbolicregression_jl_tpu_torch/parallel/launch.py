"""Run a function on N ranks, each a process of its own in one
``torch.distributed`` group (the dryrun, the sharded bench cells and the
tests use it).

``run_ranks("package.module:function", n, kwargs=...)`` starts ``n``
processes (``python -m symbolicregression_jl_tpu_torch.parallel.launch
SPEC RANK``) that join one group through a ``file://`` store in a scratch
directory (no port), call the function with the same keyword arguments,
and pickle what it returns. The parent waits for all of them under one
deadline: a rank that fails or hangs kills the others and raises, with
the ranks' last output. Returns the ranks' results in rank order.
"""

from __future__ import annotations

import os
import pickle
import shutil
import subprocess
import sys
import tempfile
import time
import traceback
from typing import Any, Dict, List, Optional, Sequence

__all__ = ["run_ranks", "RankFailure"]


class RankFailure(RuntimeError):
    """A rank exited non-zero, or the ranks outlived their deadline."""


def _package_root() -> str:
    return os.path.dirname(os.path.dirname(os.path.dirname(os.path.abspath(__file__))))


def _tail(path: str, n: int = 3000) -> str:
    try:
        with open(path, errors="replace") as f:
            return f.read()[-n:]
    except OSError:
        return ""


def run_ranks(target: str, nranks: int, *, kwargs: Optional[Dict[str, Any]] = None,
              backend: str = "gloo", timeout_s: float = 120.0,
              workdir: Optional[str] = None, sys_path: Sequence[str] = (),
              env: Optional[Dict[str, str]] = None, logs: Optional[List[str]] = None
              ) -> List[Any]:
    """``target`` ("module:function") on ``nranks`` ranks of one group of
    ``backend``; ``timeout_s`` bounds the whole run (and each collective).
    ``logs``, when given, receives each rank's stdout and stderr."""
    own = workdir is None
    work = tempfile.mkdtemp(prefix="sr_ranks_") if own else workdir
    os.makedirs(work, exist_ok=True)
    spec_path = os.path.join(work, "spec.pkl")
    store = os.path.join(work, "store")
    if os.path.exists(store):
        os.remove(store)
    with open(spec_path, "wb") as f:
        pickle.dump({"target": target, "kwargs": dict(kwargs or {}), "world": int(nranks),
                     "backend": backend, "store": "file://" + store,
                     "timeout_s": float(timeout_s), "sys_path": list(sys_path)}, f)
    child_env = dict(os.environ if env is None else env)
    child_env["PYTHONPATH"] = os.pathsep.join(
        p for p in [_package_root(), *sys_path, child_env.get("PYTHONPATH", "")] if p)
    procs = []
    try:
        for r in range(nranks):
            out = open(os.path.join(work, f"rank{r}.out"), "w")
            err = open(os.path.join(work, f"rank{r}.err"), "w")
            procs.append((subprocess.Popen(
                [sys.executable, "-m", "symbolicregression_jl_tpu_torch.parallel.launch",
                 spec_path, str(r)], stdout=out, stderr=err, env=child_env), out, err))
        deadline = time.monotonic() + float(timeout_s) + 30.0
        failed = None
        while any(p.poll() is None for p, _, _ in procs):
            bad = [r for r, (p, _, _) in enumerate(procs) if p.poll() not in (None, 0)]
            if bad or time.monotonic() > deadline:
                failed = bad or "deadline"
                break
            time.sleep(0.05)
        if failed is None:
            bad = [r for r, (p, _, _) in enumerate(procs) if p.returncode != 0]
            failed = bad or None
        for p, out, err in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
            out.close()
            err.close()
        if logs is not None:
            for r in range(nranks):
                logs.append(_tail(os.path.join(work, f"rank{r}.out"), 20000)
                            + _tail(os.path.join(work, f"rank{r}.err"), 20000))
        if failed is not None:
            what = (f"ranks outlived their {timeout_s:.0f} s deadline" if failed == "deadline"
                    else f"rank(s) {failed} failed")
            detail = "\n".join(f"--- rank {r} (exit {p.returncode}) ---\n"
                               f"{_tail(os.path.join(work, f'rank{r}.err'))}"
                               for r, (p, _, _) in enumerate(procs))
            raise RankFailure(f"{target} on {nranks} ranks: {what}\n{detail}")
        results = []
        for r in range(nranks):
            with open(os.path.join(work, f"rank{r}.result.pkl"), "rb") as f:
                results.append(pickle.load(f))
        return results
    finally:
        for p, _, _ in procs:
            if p.poll() is None:
                p.kill()
                p.wait()
        if own:
            shutil.rmtree(work, ignore_errors=True)


def _child(spec_path: str, rank: int) -> int:
    with open(spec_path, "rb") as f:
        spec = pickle.load(f)
    for p in spec["sys_path"]:
        if p not in sys.path:
            sys.path.insert(0, p)
    from . import multihost

    try:
        multihost.initialize_multihost(
            num_processes=spec["world"], process_id=rank, init_method=spec["store"],
            backend=spec["backend"], timeout_s=spec["timeout_s"],
            local_device_ids=[rank] if spec["backend"] == "nccl" else None)
        mod_name, fn_name = spec["target"].split(":")
        import importlib

        fn = getattr(importlib.import_module(mod_name), fn_name)
        result = fn(**spec["kwargs"])
        with open(os.path.join(os.path.dirname(spec_path), f"rank{rank}.result.pkl"),
                  "wb") as f:
            pickle.dump(result, f)
    except BaseException:  # noqa: BLE001 - reported through the exit code
        traceback.print_exc()
        sys.stderr.flush()
        return 1
    finally:
        multihost.shutdown()
    return 0


if __name__ == "__main__":
    sys.exit(_child(sys.argv[1], int(sys.argv[2])))
