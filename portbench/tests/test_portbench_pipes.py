"""The load generator of served files against a stub server that echoes
every input frame to its output, as ``serve_files`` reads and writes
them: whole chunks, stream by stream, stopping at the shortest stream."""

import os
import threading

import numpy as np

from portbench.traffic import pipes

HEADER = "YUV4MPEG2 W4 H2 F30:1 Ip A1:1 C420jpeg\n"
NBYTES = 12             # a 4x2 C420 frame


def stub_server(inputs, outputs, chunk, stop_after=None):
    """Open every input then every output in order (as serve_files does);
    echo whole chunks until one stream ends."""
    ins = [open(p, "rb") for p in inputs]
    for f in ins:
        f.readline()
    outs = [open(p, "wb") for p in outputs]
    for f in outs:
        f.write(HEADER.encode())
    served = 0
    while stop_after is None or served < stop_after:
        block = []
        for f in ins:
            frames = []
            for _ in range(chunk):
                if f.read(6) != b"FRAME\n":
                    break
                data = f.read(NBYTES)
                if len(data) < NBYTES:
                    break
                frames.append(data)
            block.append(frames)
        if any(len(b) < chunk for b in block):
            break
        for f, frames in zip(outs, block):
            for data in frames:
                f.write(b"FRAME\n" + data)
            f.flush()
        served += chunk
    for f in ins + outs:
        f.close()
    return served


def test_feeder_and_reader_against_a_stub(tmp_path):
    s_n, n_foot, keep, chunk = 3, 5, 4, 2
    footage = np.arange(s_n * n_foot * NBYTES, dtype=np.uint8).reshape(s_n, n_foot, NBYTES)
    inputs = [str(tmp_path / f"in{s}") for s in range(s_n)]
    outputs = [str(tmp_path / f"out{s}") for s in range(s_n)]
    for p in inputs + outputs:
        os.mkfifo(p)
    child = pipes.start({"inputs": inputs, "outputs": outputs, "streams": s_n,
                         "footage_frames": n_foot, "frame_bytes": NBYTES, "seconds": 0.5,
                         "header": HEADER, "first_out": chunk, "keep": keep}, footage)
    result = {}
    server = threading.Thread(target=lambda: result.update(
        served=stub_server(inputs, outputs, chunk)))
    server.start()
    report, kept = pipes.collect(child, keep, NBYTES, timeout=60)
    server.join(timeout=60)
    assert not server.is_alive()
    served = result["served"]
    assert served >= chunk and served % chunk == 0
    assert report["read"] == [served] * s_n
    assert all(w >= served for w in report["written"])
    for s in range(s_n):
        stamps = report["stamps"][s]
        assert len(stamps) == served and stamps == sorted(stamps)
        assert report["t_start"] >= stamps[chunk - 1]
        want = b"".join(footage[s, pipes.pingpong(j, n_foot)].tobytes()
                        for j in range(served - keep, served))
        assert kept[s] == want
