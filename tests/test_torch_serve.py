"""The port's serving harness (serve.py) against the JAX package's, and
against the port's own in-memory path.

Mirrors tests/test_parallel.py's TestServeHarness and TestServeModeNames at
``tiny_config()``'s size, on C420 Y4M files of the port's simulator
footage.  One JAX function is compiled: the JAX ``serve_files``' sharded
offline chunk, K = 2.  Tolerances: the port's files equal its in-memory
path bit for bit (the writers only encode what came out); against JAX's
files, at most 2% of the pixels differ per frame, as tests/test_offline.py's
``_assert_frames_close`` allows, by at most ``ROUND_TRIP_LEVELS``: where the
stabilized frames differ by the one level that ``_assert_frames_close``
allows, the files' C420 encode and the reader's decode carry it into up to
three (a one-level change of Y and of U moves B by up to 1 + 1.773 levels).
The inputs already differ by one level on a few pixels there: JAX's
compiled decode rounds its fused multiply-adds (ROADMAP Queue 3).
"""

import dataclasses
import os
from pathlib import Path

import numpy as np
import pytest
import torch

from video_stabilization_tpu import serve as jserve
from video_stabilization_tpu_torch import serve
from video_stabilization_tpu_torch.config import StabilizationMode, config_from_fields
from video_stabilization_tpu_torch.io import VideoWriter
from video_stabilization_tpu_torch.io.native import NativeY4MReader
from video_stabilization_tpu_torch.io.video import encode_y4m_planes
from video_stabilization_tpu_torch.ops.image import yuv_flat_to_bgr
from video_stabilization_tpu_torch.parallel import Sharded, unshard
from video_stabilization_tpu_torch.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)
from test_parallel import FH, FW, tiny_config
from torch_threads import one_torch_thread  # noqa: F401

N_STREAMS, N_FRAMES, CHUNK = 2, 6, 2
ROUND_TRIP_LEVELS = 3    # one level before a C420 encode and decode
MAX_DIFFER = 0.02        # share of pixels that may differ (tests/test_offline.py)


def quiet(*_):
    pass


@pytest.fixture(scope="module")
def clips(tmp_path_factory):
    """Two C420 Y4M files of six shaky 120x160 frames each (one trajectory
    seed per stream, one texture)."""
    tmp = tmp_path_factory.mktemp("serve_in")
    tex = torch.from_numpy(make_default_texture(np.random.default_rng(0), 128))
    paths = []
    for s in range(N_STREAMS):
        rng = np.random.default_rng(20 + s)
        traj = shake_trajectory(rng.standard_normal((N_FRAMES, 3)),
                                rng.standard_normal(N_FRAMES), DEFAULT_APP_PARAMS,
                                pos_amplitude=0.003, roll_amplitude=0.3)
        path = str(tmp / f"in{s}.y4m")
        wr = VideoWriter(path, 30.0, (FH, FW), subsampling="420")
        for i in range(N_FRAMES):
            wr.write(render_frame(tex, traj[i], FH, FW).numpy())
        wr.close()
        paths.append(path)
    return paths


def read_frames(path):
    r = NativeY4MReader(path)
    frames = []
    while (f := r.read()) is not None:
        frames.append(f)
    r.close()
    return frames


def raw_frames(path):
    r = NativeY4MReader(path)
    frames = []
    while (raw := r.read_yuv()) is not None:
        frames.append(raw.tobytes())
    r.close()
    return frames


def decoded_footage(paths):
    """(S, T, H, W, 3) u8: the files decoded by the port, as the serving
    loop decodes them."""
    out = []
    for p in paths:
        r = NativeY4MReader(p)
        out.append(yuv_flat_to_bgr(torch.from_numpy(r.read_yuv_block(N_FRAMES)), FH, FW, True))
        r.close()
    return torch.stack(out)


def port_serve(paths, out_dir, mode="smoothing", devices=("cpu",), **kw):
    return serve.serve_files(paths, str(out_dir), mode, chunk=CHUNK,
                             config=config_from_fields(tiny_config()), devices=devices,
                             log=quiet, **kw)


def test_serve_files_matches_in_memory(clips, tmp_path):
    """Native block ingest -> stream-batched chunks -> writers equals the
    in-memory path on the same decoded footage, through one C420 encode,
    byte for byte; every output is marked valid and written."""
    done, _ = port_serve(clips, tmp_path)
    assert done == N_FRAMES
    run = serve.last_run
    assert run["chunks"] == N_FRAMES // CHUNK and run["streams"] == N_STREAMS
    assert run["event_waits"] == 0          # no events on the CPU
    cfg = dataclasses.replace(config_from_fields(tiny_config()), frame_height=FH,
                              frame_width=FW)
    outs, valid, carry = serve.stabilize_streams_sharded(decoded_footage(clips), cfg, ["cpu"],
                                                         chunk=CHUNK)
    assert outs.shape == (N_STREAMS, N_FRAMES, FH, FW, 3) and int(carry.n[0]) == N_FRAMES
    for s, p in enumerate(clips):
        got = raw_frames(str(tmp_path / f"stabilized_{os.path.basename(p)}"))
        want = outs[s][valid[s]].numpy()
        assert len(got) == len(want) == N_FRAMES
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == encode_y4m_planes(w, True), f"stream {s} frame {i}"


SERVE_STAGES = ("y4m_read", "serve_enqueue", "slot0", "serve_wait", "y4m_encode", "y4m_write")


def test_serve_files_stage_ranges_and_counters(clips, tmp_path, monkeypatch):
    """Under the profiler, ``serve_files`` opens ``y4m_read`` once per
    ``read_yuv_block`` call, ``serve_enqueue`` (and the mesh's ``slot0``)
    once per chunk, ``y4m_encode`` once per slot and chunk in the enqueue,
    ``serve_wait`` once per drain, and ``y4m_write`` once per written frame,
    only while ``stage_profile.enabled`` is set; ``last_run`` counts the
    frames encoded on the slot's device and each writer's frames, and its
    write seconds are the pipe writes' alone (no host encode)."""
    from video_stabilization_tpu_torch.utils import stage_profile

    reads = []
    read = NativeY4MReader.read_yuv_block

    def counted(self, *args, **kw):
        reads.append(1)
        return read(self, *args, **kw)

    monkeypatch.setattr(NativeY4MReader, "read_yuv_block", counted)
    seen = {}
    for on in (False, True):
        reads.clear()
        stage_profile.enabled = on
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                done, _ = port_serve(clips, tmp_path / str(on))
        finally:
            stage_profile.enabled = False
        seen[on] = {e.key[6:]: e.count for e in prof.key_averages()
                    if e.key[6:] in SERVE_STAGES and e.key.startswith("stage:")}
    assert seen[False] == {}
    run = serve.last_run
    chunks = N_FRAMES // CHUNK
    # a read round per chunk, and the round that meets the end of the files
    assert len(reads) == N_STREAMS * (chunks + 1)
    assert done == N_FRAMES and run["chunks"] == chunks
    assert seen[True] == {"y4m_read": len(reads), "serve_enqueue": chunks, "slot0": chunks,
                          "serve_wait": chunks, "y4m_encode": chunks,
                          "y4m_write": N_STREAMS * N_FRAMES}
    assert run["written"] == [N_FRAMES] * N_STREAMS         # every output is valid
    assert run["device_encoded"] == N_STREAMS * N_FRAMES
    assert run["encode_s"] == 0.0 and 0 < run["pipe_write_s"]
    assert run["encode_s"] + run["pipe_write_s"] <= run["write_s"]


def test_serve_files_logs_the_run_split(clips, tmp_path):
    """The closing log line gives the host seconds of read, enqueue, wait,
    encode and pipe write, the frames encoded on the device and the frames
    written per stream."""
    lines = []
    serve.serve_files(clips, str(tmp_path), "smoothing", chunk=CHUNK,
                      config=config_from_fields(tiny_config()), devices=["cpu"],
                      log=lines.append)
    run = serve.last_run
    for part, key in (("read", "read_s"), ("enqueue", "queue_s"), ("wait", "wait_s"),
                      ("encode", "encode_s"), ("pipe write", "pipe_write_s")):
        assert f" {part} {run[key]:.2f}" in lines[-1], part
    assert f"frames encoded on the device {N_STREAMS * N_FRAMES};" in lines[-1]
    assert lines[-1].endswith(f"frames written per stream {[N_FRAMES] * N_STREAMS}")


@pytest.fixture(scope="module")
def jax_served(clips, tmp_path_factory):
    """The JAX package's serve_files on the same files (its decode, its
    stream-sharded offline chunk)."""
    out = tmp_path_factory.mktemp("serve_jax")
    done, _ = jserve.serve_files(clips, str(out), "smoothing", chunk=CHUNK,
                                 config=tiny_config(), log=quiet)
    assert done == N_FRAMES
    return out


def test_serve_files_matches_jax(clips, jax_served, tmp_path):
    """Per stream and frame, the port's stabilized file against JAX's: at
    most 2% of the pixels differ, by at most ``ROUND_TRIP_LEVELS``."""
    port_serve(clips, tmp_path)
    for p in clips:
        name = f"stabilized_{os.path.basename(p)}"
        got, want = read_frames(str(tmp_path / name)), read_frames(str(jax_served / name))
        assert len(got) == len(want) == N_FRAMES
        for i, (g, w) in enumerate(zip(got, want)):
            diff = np.abs(g.astype(np.int16) - w.astype(np.int16))
            assert diff.max() <= ROUND_TRIP_LEVELS, f"{name} frame {i}: max {diff.max()}"
            assert (diff > 0).mean() <= MAX_DIFFER, f"{name} frame {i}: {(diff > 0).mean()}"


@pytest.mark.parametrize("mode", ["smoothing", "GLOBAL_SMOOTHING", "accumulated-lock",
                                  StabilizationMode.TRANSLATION_LOCK])
def test_serve_files_accepts_cli_and_enum_spellings(clips, mode):
    """CLI spellings, enum member names and the enum itself all resolve."""
    done, _ = serve.serve_files(clips[:1], None, mode, chunk=1, max_frames=3,
                                config=config_from_fields(tiny_config()), devices=["cpu"],
                                log=quiet)
    assert done == 3


def test_serve_output_skipped_without_output_dir(clips, tmp_path):
    done, _ = serve.serve_files(clips, None, "smoothing", chunk=CHUNK, max_frames=2,
                                config=config_from_fields(tiny_config()), devices=["cpu"],
                                log=quiet)
    assert done == 2 and serve.last_run["chunks"] == 1


def test_serve_refuses_mixed_streams(clips, tmp_path):
    path = str(tmp_path / "odd.y4m")
    wr = VideoWriter(path, 30.0, (FH, FW), subsampling="444")
    wr.write(np.zeros((FH, FW, 3), np.uint8))
    wr.close()
    with pytest.raises(ValueError, match="share frame size and chroma"):
        port_serve([clips[0], path], tmp_path / "out")


@pytest.mark.parametrize("n_devices,n_streams", [(8, 8), (8, 6), (4, 7), (3, 9), (1, 5)])
def test_pick_serving_devices_matches_jax(n_devices, n_streams):
    devices = list(range(n_devices))
    assert serve.pick_serving_devices(devices, n_streams) == \
        jserve.pick_serving_devices(devices, n_streams)


def test_serve_files_over_two_slots_matches_in_memory(clips, tmp_path):
    """``serve_files`` over a mesh of two "cpu" slots, one stream each: the
    files equal the in-memory ``stabilize_streams_sharded`` on the same mesh
    byte for byte, and the one-slot run's files; ``last_run`` names the
    mesh and splits the device times per slot."""
    two = ["cpu", "cpu"]
    done, _ = port_serve(clips, tmp_path / "two", devices=two)
    assert done == N_FRAMES
    run = serve.last_run
    assert run["devices"] == two and run["event_waits"] == 0
    assert [len(run[k]) for k in ("h2d_ms", "compute_ms", "d2h_ms")] == [2, 2, 2]
    port_serve(clips, tmp_path / "one")
    cfg = dataclasses.replace(config_from_fields(tiny_config()), frame_height=FH,
                              frame_width=FW)
    outs, valid, carry = serve.stabilize_streams_sharded(decoded_footage(clips), cfg, two,
                                                         chunk=CHUNK)
    assert isinstance(outs, Sharded) and len(carry.parts) == 2
    outs, valid = unshard(outs), unshard(valid)
    for s, p in enumerate(clips):
        name = f"stabilized_{os.path.basename(p)}"
        got = raw_frames(str(tmp_path / "two" / name))
        assert got == raw_frames(str(tmp_path / "one" / name)), name
        want = outs[s][valid[s]].numpy()
        assert len(got) == len(want) == N_FRAMES
        for i, (g, w) in enumerate(zip(got, want)):
            assert g == encode_y4m_planes(w, True), f"stream {s} frame {i}"


def test_in_memory_path_checks():
    cfg = dataclasses.replace(config_from_fields(tiny_config()), static_mode=None)
    footage = torch.zeros((1, 4, FH, FW, 3), dtype=torch.uint8)
    with pytest.raises(ValueError, match="static_mode"):
        serve.stabilize_streams_sharded(footage, cfg, ["cpu"], chunk=2)
    with pytest.raises(ValueError, match="multiple of chunk"):
        serve.stabilize_streams_sharded(footage, config_from_fields(tiny_config()), ["cpu"],
                                        chunk=3)


def test_serve_main_simulator(tmp_path):
    """``--simulator N``: N streams rendered into a temporary directory,
    served, written, and the rendered inputs removed at the end."""
    out = tmp_path / "out"
    assert serve.main(["--simulator", "2", "--frames", "4", "--sim-size", "160x120",
                       "--past-window", "0.1", "--future-window", "0.05", "--chunk", "2",
                       "--working-height", "100", "--output-dir", str(out)],
                      device="cpu") == 0
    assert sorted(os.listdir(out)) == ["stabilized_stream0.y4m", "stabilized_stream1.y4m"]
    assert len(read_frames(str(out / "stabilized_stream1.y4m"))) == 4
    assert "inputs" not in serve.last_run
    assert serve.main(["--simulator", "1", "--frames", "2", "--sim-size", "160x120",
                       "--chunk", "2", "--working-height", "100"], device="cpu",
                      keep_inputs=True) == 0
    inputs = serve.last_run["inputs"]
    assert len(inputs) == 1 and Path(inputs[0]).exists()
    assert serve.last_run["devices"] == ["cpu"]
    NativeY4MReader(inputs[0]).close()
    for p in inputs:
        os.unlink(p)
    os.rmdir(os.path.dirname(inputs[0]))


@pytest.mark.parametrize("mode", ["smoothing", "accumulated"])
def test_serve_main_over_a_mesh(tmp_path, mode):
    """``main`` serves over the mesh it is given: two streams over two
    "cpu" slots, in a mode given in the serve CLI's spelling."""
    out = tmp_path / "out"
    assert serve.main(["--simulator", "2", "--frames", "2", "--sim-size", "160x120",
                       "--chunk", "2", "--working-height", "100", "--output-dir", str(out),
                       "--mode", mode], device=["cpu", "cpu"]) == 0
    assert serve.last_run["devices"] == ["cpu", "cpu"] and serve.last_run["frames"] == 2
    assert len(read_frames(str(out / "stabilized_stream1.y4m"))) == 2
