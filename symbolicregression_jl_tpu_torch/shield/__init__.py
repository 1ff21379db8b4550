"""graftshield (port of ``shield/``): so far the rolling checkpoints and
their resume discovery. Signals, the watchdog, the degrade ladder and
quarantine come with the robustness slice (ROADMAP.md queue 1 item 6)."""

from .checkpoints import (RollingCheckpointer, discover_resume_path, load_newest_valid,
                          rolled_paths)

__all__ = ["RollingCheckpointer", "discover_resume_path", "load_newest_valid", "rolled_paths"]
