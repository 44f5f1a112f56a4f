"""The load generator of served files: a child process that feeds S Y4M
streams into named pipes and reads the stabilized streams back.

    python3 portbench/traffic/pipes.py   (its parent writes to its stdin)

Standard input: one JSON line (the pipes' paths, the Y4M header, the bytes
of a frame's planes, the streams, the frames of footage per stream, the
window's seconds, the frames per stream that end set-up, the frames per
stream to keep), then every stream's footage frames, (S, L, frame_bytes)
bytes.  Each input pipe gets the header, then footage frames replayed
forward then backward, as fast as the server reads them.  Each output
frame is time-stamped (``time.monotonic()``) when its last byte arrives.
Set-up ends when ``first_out`` frames have come out of every output; the
window is the ``seconds`` after that; then the inputs close, the server
ends at the end of its shortest stream, and every output is read to its
end.  Standard output: one JSON line (the window's start, each stream's
frames written and read, their time stamps), then each stream's last
``keep`` frames read, oldest first.  It imports neither torch nor the
program, and writes nothing but the pipes.
"""

from __future__ import annotations

import json
import subprocess
import sys
import threading
import time

FRAME = b"FRAME\n"


def pingpong(i: int, n: int) -> int:
    period = 2 * n - 2
    r = i % period
    return r if r < n else period - r


def _write_all(f, mv) -> None:
    while mv:
        mv = mv[f.write(mv):]


def start(spec: dict, footage) -> subprocess.Popen:
    """Start the child and hand it ``spec`` and the footage's bytes (a
    buffer of (S, L, frame_bytes) bytes); returns once it has them all."""
    child = subprocess.Popen([sys.executable, __file__], stdin=subprocess.PIPE,
                             stdout=subprocess.PIPE)
    child.stdin.write(json.dumps(spec).encode() + b"\n")
    child.stdin.write(memoryview(footage).cast("B"))
    child.stdin.close()
    return child


def collect(child: subprocess.Popen, keep: int, frame_bytes: int, timeout: float = 120.0):
    """The child's report (its JSON line) and each stream's kept frames'
    bytes, once the server has ended; raises if the child failed."""
    report = json.loads(child.stdout.readline())
    kept = [child.stdout.read(min(n, keep) * frame_bytes) for n in report["read"]]
    if child.wait(timeout=timeout) != 0 or report["errors"] or report["t_start"] is None:
        raise RuntimeError(f"pipes: exit {child.returncode}, {report['errors']}, "
                           f"window start {report['t_start']}")
    return report, kept


def main() -> int:
    spec = json.loads(sys.stdin.buffer.readline())
    s_n, n_foot, nbytes = spec["streams"], spec["footage_frames"], spec["frame_bytes"]
    footage = memoryview(sys.stdin.buffer.read(s_n * n_foot * nbytes))
    if len(footage) != s_n * n_foot * nbytes:
        raise SystemExit("pipes: short footage on stdin")
    keep = spec["keep"]
    stop = threading.Event()
    ready = threading.Condition()
    written = [0] * s_n
    read = [0] * s_n
    stamps = [[] for _ in range(s_n)]
    kept = [bytearray(keep * nbytes) for _ in range(s_n)]
    errors = []

    def feed(s: int) -> None:
        try:
            with open(spec["inputs"][s], "wb", buffering=0) as f:
                _write_all(f, memoryview(spec["header"].encode()))
                while not stop.is_set():
                    off = (s * n_foot + pingpong(written[s], n_foot)) * nbytes
                    _write_all(f, memoryview(FRAME))
                    _write_all(f, footage[off:off + nbytes])
                    written[s] += 1
        except BrokenPipeError:
            pass                # the server closed its end: its shortest stream ended
        except OSError as e:
            errors.append(f"input {s}: {e!r}")

    def drain(s: int) -> None:
        try:
            with open(spec["outputs"][s], "rb", buffering=1 << 22) as f:
                f.readline()                            # the Y4M header
                while True:
                    if f.read(len(FRAME)) != FRAME:
                        break
                    slot = memoryview(kept[s])[(read[s] % keep) * nbytes:][:nbytes]
                    if f.readinto(slot) != nbytes:
                        break
                    stamps[s].append(time.monotonic())
                    with ready:
                        read[s] += 1
                        ready.notify_all()
        except OSError as e:
            errors.append(f"output {s}: {e!r}")

    threads = [threading.Thread(target=fn, args=(s,), daemon=True)
               for fn in (drain, feed) for s in range(s_n)]
    for t in threads:
        t.start()
    with ready:
        ready.wait_for(lambda: min(read) >= spec["first_out"] or errors
                       or not any(t.is_alive() for t in threads[:s_n]))
    t_start = max(st[spec["first_out"] - 1] for st in stamps) if min(read) >= \
        spec["first_out"] else None
    if t_start is not None:
        time.sleep(max(0.0, t_start + spec["seconds"] - time.monotonic()))
    stop.set()
    for t in threads:
        t.join()
    out = sys.stdout.buffer
    out.write(json.dumps({"t_start": t_start, "written": written, "read": read,
                          "stamps": stamps, "errors": errors}).encode() + b"\n")
    for s in range(s_n):
        n = min(read[s], keep)
        first = (read[s] - n) % keep
        ring = memoryview(kept[s])
        out.write(ring[first * nbytes:(first + n) * nbytes] if first + n <= keep else
                  bytes(ring[first * nbytes:]) + bytes(ring[:(first + n - keep) * nbytes]))
    out.flush()
    return 0


if __name__ == "__main__":
    sys.exit(main())
