"""Rolling, discoverable, corruption-tolerant checkpoints.

Port of ``symbolicregression_jl_tpu/shield/checkpoints.py`` for one
process. ``api/checkpoint.py`` owns the file format; this module owns the
policy around it:

- :class:`RollingCheckpointer` keeps the last K checkpoints
  (``search_state.pkl``, ``.1``, ``.2``, ...), rotating before each write,
  so a torn write or a corrupt newest file never strands the run.
- :func:`load_newest_valid` walks candidates newest first and skips, with
  a warning, files that raise ``CheckpointCorruptError``.
- :func:`discover_resume_path` finds, for ``equation_search(resume="auto")``,
  the newest run directory under the output base that holds a checkpoint.
"""

from __future__ import annotations

import os
import warnings
from typing import List, Optional, Tuple

from ..api.checkpoint import CheckpointCorruptError, load_search_state, save_search_state

__all__ = ["RollingCheckpointer", "rolled_paths", "load_newest_valid", "discover_resume_path"]

CHECKPOINT_BASENAME = "search_state.pkl"


def rolled_paths(base: str, keep: int) -> List[str]:
    """Newest-first candidate paths of a rolling set of size ``keep``."""
    return [base] + [f"{base}.{n}" for n in range(1, keep)]


class RollingCheckpointer:
    """Writes ``base`` and keeps the previous ``keep - 1`` generations.
    Rotation happens before the write, so if the process dies mid-write
    ``base.1`` still holds the complete previous state."""

    def __init__(self, base: str, keep: int = 3) -> None:
        self.base = base
        self.keep = max(int(keep), 1)

    def _rotate(self) -> None:
        if self.keep == 1:
            return
        slots = rolled_paths(self.base, self.keep)
        if os.path.exists(slots[-1]):
            os.remove(slots[-1])
        for n in range(self.keep - 2, -1, -1):
            if os.path.exists(slots[n]):
                os.replace(slots[n], slots[n + 1])

    def save(self, state) -> str:
        self._rotate()
        save_search_state(self.base, state)
        return self.base

    def candidates(self) -> List[str]:
        """Newest-first checkpoint slots that exist on disk."""
        return [p for p in rolled_paths(self.base, self.keep) if os.path.exists(p)]


def load_newest_valid(paths: List[str], options, device=None,
                      corrupt_log: Optional[List[Tuple[str, str]]] = None) -> Tuple[object, str]:
    """Load the first checkpoint in ``paths`` (newest first) that passes
    its digest check and unpickles, its tensors on ``device``. Corrupt
    candidates are skipped with a warning and, where ``corrupt_log`` is
    given, recorded in it as ``(path, error)``. Raises the last
    CheckpointCorruptError when every candidate is bad, FileNotFoundError
    when none exists. Returns ``(state, path)``."""
    last_error: Optional[Exception] = None
    tried = 0
    for p in paths:
        if not os.path.exists(p):
            continue
        tried += 1
        try:
            return load_search_state(p, options, device=device), p
        except CheckpointCorruptError as e:
            last_error = e
            if corrupt_log is not None:
                corrupt_log.append((p, str(e)))
            warnings.warn(f"checkpoint {p} is corrupt ({e}); falling back to the previous "
                          "rolling checkpoint", stacklevel=2)
    if tried == 0:
        raise FileNotFoundError(f"no checkpoint found among candidates: {paths}")
    raise CheckpointCorruptError(
        f"all {tried} checkpoint candidate(s) are corrupt; last error: {last_error}")


def discover_resume_path(base_dir: str, keep: int = 8) -> Optional[List[str]]:
    """Newest-first checkpoint candidates under ``base_dir``: a checkpoint
    file, a run directory holding ``search_state.pkl``, or an output base
    whose run directories are scanned newest first (by the modification
    time of their newest checkpoint). None where nothing is there."""
    if not os.path.isdir(base_dir):
        return rolled_paths(base_dir, keep) if os.path.exists(base_dir) else None

    def run_candidates(d: str) -> List[str]:
        return [p for p in rolled_paths(os.path.join(d, CHECKPOINT_BASENAME), keep)
                if os.path.exists(p)]

    direct = run_candidates(base_dir)
    if direct:
        return direct
    try:
        entries = os.listdir(base_dir)
    except OSError:
        return None
    runs = []
    for name in entries:
        d = os.path.join(base_dir, name)
        if os.path.isdir(d):
            cands = run_candidates(d)
            if cands:
                runs.append((os.path.getmtime(cands[0]), cands))
    if not runs:
        return None
    runs.sort(key=lambda t: -t[0])
    return runs[0][1]
