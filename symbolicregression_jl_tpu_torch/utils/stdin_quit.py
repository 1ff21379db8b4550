"""Interactive quit: watch stdin for 'q' (or ctrl-d) during a search.

A copy of the JAX package's ``utils/stdin_quit.py``: the analogue of the
reference's StdinReader/watch_stream/check_for_user_quit
(src/SearchUtils.jl:336-385): a
daemon thread reads the input stream; the host loop polls ``quit`` at each
budget check (between cycle chunks and at iteration boundaries) and ends the search gracefully, keeping all results
produced so far.
"""

from __future__ import annotations

import sys
import threading
import weakref
from typing import Optional, TextIO

__all__ = ["StdinQuitWatcher"]


def _watch_loop(watcher_ref) -> None:
    """Thread body holding only a weakref: when the owning search frame
    dies (return OR exception), the watcher is collected and the thread
    exits at the next poll — no stdin-consuming thread can outlive its
    search."""
    while True:
        w = watcher_ref()
        if w is None or w.quit or w._stopped:
            return
        try:
            if not w._readable(0.2):
                continue
            ch = w.stream.read(1)
            if w._stopped:
                return
            if ch == "" or ch.lower() == "q":  # EOF (ctrl-d) or quit
                w.quit = True
                return
        except (ValueError, OSError):  # stream closed mid-search
            return
        finally:
            del w  # don't pin the watcher across the poll sleep


class StdinQuitWatcher:
    """Reads characters off ``stream`` on a daemon thread; sets ``quit``
    when a 'q' (or end-of-stream ctrl-d) arrives.

    Only engages when the stream is an interactive TTY (tests and batch
    jobs are unaffected) unless ``force=True`` (used with injected
    streams in tests).
    """

    @classmethod
    def disabled(cls) -> "StdinQuitWatcher":
        """A watcher that never engages and never touches ``sys.stdin``
        — the headless/server form (``Options(interactive_quit=False)``
        or a non-TTY stdin). No thread, no termios, ``check()`` is
        always False; a long-lived multi-tenant server must not spawn a
        stdin-consuming thread (or flip terminal modes) per request."""
        w = cls.__new__(cls)
        w.stream = None
        w.quit = False
        w._stopped = True
        w._thread = None
        w._saved_termios = None
        w.active = False
        return w

    def __init__(self, stream: Optional[TextIO] = None, force: bool = False):
        self.stream = stream if stream is not None else sys.stdin
        self.quit = False
        self._stopped = False
        self._thread: Optional[threading.Thread] = None
        self._saved_termios = None
        try:
            interactive = force or self.stream.isatty()
        except (AttributeError, ValueError):
            interactive = False
        self.active = bool(interactive)
        if self.active:
            self._enter_cbreak()
            self._thread = threading.Thread(
                target=_watch_loop, args=(weakref.ref(self),), daemon=True
            )
            self._thread.start()

    def _enter_cbreak(self) -> None:
        """Disable line buffering on a real TTY so a bare 'q' registers
        without Enter (the reference switches its terminal to raw mode,
        src/SearchUtils.jl:342-349); restored by stop(). Injected test
        streams and pipes have no termios and are left alone."""
        try:
            import termios
            import tty

            fd = self.stream.fileno()
            if not self.stream.isatty():
                return
            self._saved_termios = (fd, termios.tcgetattr(fd))
            tty.setcbreak(fd)
        except Exception:  # no tty/termios: stay line-buffered
            self._saved_termios = None

    def _restore_tty(self) -> None:
        if self._saved_termios is None:
            return
        fd, attrs = self._saved_termios
        self._saved_termios = None
        try:
            import termios

            termios.tcsetattr(fd, termios.TCSADRAIN, attrs)
        except Exception:
            pass

    def _readable(self, timeout: float) -> bool:
        """Poll the stream for input so the thread can exit on stop();
        streams without a selectable fd (StringIO) are always readable."""
        import select

        try:
            fd = self.stream.fileno()
        except (AttributeError, OSError, ValueError):
            return True
        try:
            r, _, _ = select.select([fd], [], [], timeout)
        except (OSError, ValueError):
            return False
        return bool(r)

    def stop(self) -> None:
        """End the watcher thread (called when the search finishes —
        otherwise a stale thread would keep consuming stdin characters
        meant for a later search) and restore the terminal mode."""
        self._stopped = True
        self._restore_tty()

    def __del__(self):  # backstop for exception paths
        self._stopped = True
        self._restore_tty()

    def check(self) -> bool:
        """True when the user asked to quit (check_for_user_quit,
        src/SearchUtils.jl:372-377)."""
        return self.active and self.quit
