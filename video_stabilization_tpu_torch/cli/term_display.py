"""OpenCV-free interactive preview: ANSI truecolor terminal rendering.

Port of ``video_stabilization_tpu/cli/term_display.py`` (its own copy).
The reference displays through OpenCV HighGUI (cv::imshow/cv::waitKey,
src/main_utils.cpp:300-325,486-487); this backend needs no OpenCV, like
the native Y4M reader: frames render as Unicode half-blocks (``▀`` with the
24-bit foreground color carrying the top pixel and the background color the
bottom pixel — 2 pixels per character cell), and the keyboard is polled
non-blocking from a raw-mode stdin, so the app's mode keys (X/F/O/L/T/R/G)
and simulator movement keys work exactly as with the HighGUI backend.

Pure stdlib (termios/select/shutil); no cv2, no SDL, no X server.  The frame
-> escape-string renderer is a standalone function so tests can check it
without a TTY.
"""

from __future__ import annotations

import os
import shutil
import sys
from typing import Optional

import numpy as np

ESC = "\x1b"
_ALT_SCREEN_ON = f"{ESC}[?1049h{ESC}[?25l"     # alt buffer + hide cursor
_ALT_SCREEN_OFF = f"{ESC}[?1049l{ESC}[?25h"
_HOME = f"{ESC}[H"
_RESET = f"{ESC}[0m"


def _fit(h: int, w: int, max_h: int, max_w: int) -> tuple[int, int]:
    """Largest (th, tw) <= (max_h, max_w) preserving aspect; terminal cells
    hold 2 vertical pixels, handled by the caller."""
    scale = min(max_h / h, max_w / w, 1.0)
    return max(2, int(h * scale)) & ~1, max(2, int(w * scale))


def _nearest(frame: np.ndarray, th: int, tw: int) -> np.ndarray:
    h, w = frame.shape[:2]
    ys = (np.arange(th) * (h / th)).astype(np.int64)
    xs = (np.arange(tw) * (w / tw)).astype(np.int64)
    return frame[ys][:, xs]


def render_ansi(frame_bgr: np.ndarray, max_cols: int, max_rows: int,
                title: str = "") -> str:
    """BGR uint8 (H, W, 3) -> ANSI half-block string of at most
    ``max_rows`` text rows x ``max_cols`` columns (one row consumed by the
    title when given)."""
    rows_px = 2 * (max_rows - (1 if title else 0))
    th, tw = _fit(frame_bgr.shape[0], frame_bgr.shape[1], rows_px, max_cols)
    img = _nearest(np.asarray(frame_bgr, np.uint8), th, tw)
    rgb = img[..., ::-1].astype(np.int32)               # BGR -> RGB
    top, bot = rgb[0::2], rgb[1::2]                     # (th/2, tw, 3)
    out = []
    if title:
        out.append(f"{_RESET}{title[:max_cols]}{ESC}[K")
    for r in range(top.shape[0]):
        line = []
        prev_fg = prev_bg = None
        for c in range(tw):
            fg, bg = tuple(top[r, c]), tuple(bot[r, c])
            codes = []
            if fg != prev_fg:
                codes.append(f"38;2;{fg[0]};{fg[1]};{fg[2]}")
                prev_fg = fg
            if bg != prev_bg:
                codes.append(f"48;2;{bg[0]};{bg[1]};{bg[2]}")
                prev_bg = bg
            line.append((f"{ESC}[{';'.join(codes)}m" if codes else "") + "▀")
        out.append("".join(line) + f"{_RESET}{ESC}[K")
    return "\n".join(out)


def render_side_by_side(frames: list[tuple[str, np.ndarray]],
                        term_cols: int, term_rows: int) -> str:
    """Render labeled frames left-to-right, splitting the terminal width."""
    n = len(frames)
    col_w = (term_cols - (n - 1)) // n
    blocks = [render_ansi(f, col_w, term_rows, title=t).split("\n")
              for t, f in frames]
    height = max(len(b) for b in blocks)
    lines = []
    for i in range(height):
        parts = [b[i] if i < len(b) else " " * col_w for b in blocks]
        lines.append(" ".join(parts))
    return _HOME + "\n".join(lines)


class TerminalDisplay:
    """imshow/waitKey-alike over a raw-mode TTY.

    ``show(named_frames)`` draws all windows side by side; ``poll_key()``
    returns one pending keypress (lowercase str) or None; ESC returns
    ``"\\x1b"``.  Context-manage it (or call close()) to restore the
    terminal.
    """

    def __init__(self, out=None):
        self.out = out if out is not None else sys.stdout
        self._fd: Optional[int] = None
        self._saved = None
        if self._is_tty():
            import termios
            import tty

            self._fd = sys.stdin.fileno()
            self._saved = termios.tcgetattr(self._fd)
            tty.setcbreak(self._fd)
            self.out.write(_ALT_SCREEN_ON)
            self.out.flush()

    @staticmethod
    def _is_tty() -> bool:
        try:
            return sys.stdin.isatty() and sys.stdout.isatty()
        except Exception:
            return False

    def show(self, named_frames: list[tuple[str, np.ndarray]]) -> None:
        size = shutil.get_terminal_size((120, 40))
        self.out.write(render_side_by_side(named_frames, size.columns,
                                           size.lines - 1))
        self.out.flush()

    def poll_key(self) -> Optional[str]:
        if self._fd is None:
            return None
        import select

        r, _, _ = select.select([sys.stdin], [], [], 0)
        if not r:
            return None
        ch = os.read(self._fd, 1).decode(errors="ignore")
        return ch if ch else None

    def close(self) -> None:
        if self._fd is not None and self._saved is not None:
            import termios

            self.out.write(_ALT_SCREEN_OFF + _RESET)
            self.out.flush()
            termios.tcsetattr(self._fd, termios.TCSADRAIN, self._saved)
            self._fd = None

    def __enter__(self):
        return self

    def __exit__(self, *exc):
        self.close()

    def __del__(self):
        try:
            self.close()
        except Exception:
            pass
