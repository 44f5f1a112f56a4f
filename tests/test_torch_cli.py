"""The port's command-line application (cli/args.py, cli/term_display.py,
cli/app.py) and step factories (engine/stabilizer.py::make_step_fn,
make_scan_fn), against the JAX package's and against the port's own
``Stabilizer``.

Mirrors tests/test_io_cli.py's TestArgs, TestHeadlessApp and
TestTerminalDisplay, and tests/test_offline.py's
``test_scan_still_matches_step_after_fold_in_keys``.  No JAX app is run:
the argument parser and the terminal renderer are compared with JAX's
directly, and the port's headless app with the port's ``Stabilizer`` on the
same simulator frames.
"""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import numpy as np
import pytest
import torch

from video_stabilization_tpu.cli import args as jargs
from video_stabilization_tpu.cli import term_display as jterm
from video_stabilization_tpu_torch.cli import app
from video_stabilization_tpu_torch.cli import args as targs
from video_stabilization_tpu_torch.cli import term_display as tterm
from video_stabilization_tpu_torch.config import StabilizationMode, StabilizerConfig
from video_stabilization_tpu_torch.engine import (
    Stabilizer, init_carry, make_scan_fn, make_step_fn)
from video_stabilization_tpu_torch.io import SimulatorSource
from video_stabilization_tpu_torch.io.native import NativeY4MReader
from video_stabilization_tpu_torch.io.video import encode_y4m_planes
from video_stabilization_tpu_torch.utils import prng
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]
# a short app run: 720x1280 simulator frames at working height 180, window
# 6 + 1 + 3 (0.2 s and 0.1 s at 30 fps)
APP_ARGS = ["--simulator", "--no-display", "--past-window", "0.2", "--future-window", "0.1",
            "--working-height", "180"]
FUTURE = 3

ARGVS = [
    ["--simulator"],
    ["--file", "/tmp/x.mp4", "--working-height", "720"],
    ["--camera", "2", "--mode", "orb-lock", "--output", "o.y4m", "--max-frames", "5",
     "--no-display"],
    ["--simulator", "--display-backend", "term", "--reference-compat", "--motion-model",
     "affine", "--checkpoint", "c.npz", "--resume", "r.npz", "--stats", "--trail",
     "--debug-features", "--texture", "t.png", "--past-window", "0.5",
     "--future-window", "0"],
    ["--simulator", "--mode", "sift-lock", "--past-window", "0.03", "--future-window", "0"],
]
BAD_ARGVS = [
    [],
    ["--simulator", "--camera", "0"],
    ["--simulator", "--past-window", "0.0", "--future-window", "0.0"],
    ["--simulator", "--working-height", "90"],
    ["--simulator", "--working-height", "2161"],
    ["--simulator", "--past-window", "-1"],
    ["--simulator", "--mode", "wobble"],
    ["--simulator", "--frobnicate"],
]


@pytest.mark.parametrize("argv", ARGVS)
def test_parse_args_matches_jax(argv):
    got, want = targs.parse_args(argv), jargs.parse_args(argv)
    assert [f.name for f in dataclasses.fields(got)] == \
        [f.name for f in dataclasses.fields(want)]
    assert dataclasses.asdict(got) == dataclasses.asdict(want)


@pytest.mark.parametrize("argv", BAD_ARGVS)
def test_parse_args_errors_match_jax(argv, capsys):
    """The same argv is refused with the same exit code and message."""
    messages = []
    for parse in (targs.parse_args, jargs.parse_args):
        with pytest.raises(SystemExit) as exc:
            parse(argv)
        err = capsys.readouterr().err
        messages.append((exc.value.code, err.strip().splitlines()[-1].split("error: ", 1)[1]))
    assert messages[0] == messages[1]
    assert messages[0][0] == 2


def test_mode_names_and_flags_match_jax():
    assert targs.MODE_NAMES == jargs.MODE_NAMES
    assert targs.MIN_STABILIZER_WINDOW_SECONDS == jargs.MIN_STABILIZER_WINDOW_SECONDS

    def flags(parser):
        return sorted((a.option_strings[0] if a.option_strings else a.dest, a.default)
                      for a in parser._actions)

    assert flags(targs.build_parser()) == flags(jargs.build_parser())


def test_app_keys_match_jax():
    from video_stabilization_tpu.cli import app as japp

    assert {k: int(v) for k, v in app.MODE_KEYS.items()} == \
        {k: int(v) for k, v in japp.MODE_KEYS.items()}
    assert app.SIM_KEYS == japp.SIM_KEYS


def test_render_ansi_matches_jax():
    rng = np.random.default_rng(0)
    img = rng.integers(0, 256, (64, 96, 3), dtype=np.uint8)
    img[:, :48] = (255, 0, 0)
    for cols, rows, title in ((48, 17, "t"), (200, 60, ""), (31, 9, "a long title " * 4)):
        got = tterm.render_ansi(img, max_cols=cols, max_rows=rows, title=title)
        assert got == jterm.render_ansi(img, max_cols=cols, max_rows=rows, title=title)
    lines = tterm.render_ansi(img, max_cols=48, max_rows=17, title="t").split("\n")
    assert lines[0].startswith("\x1b[0mt") and "38;2;0;0;255" in lines[1]


def test_render_side_by_side_matches_jax():
    rng = np.random.default_rng(1)
    frames = [("original", rng.integers(0, 256, (40, 60, 3), dtype=np.uint8)),
              ("stabilized", rng.integers(0, 256, (32, 32, 3), dtype=np.uint8))]
    got = tterm.render_side_by_side(frames, 100, 20)
    assert got == jterm.render_side_by_side(frames, 100, 20)
    assert got.startswith("\x1b[H")


def test_terminal_display_without_a_tty():
    import io

    d = tterm.TerminalDisplay(out=io.StringIO())
    assert d.poll_key() is None
    d.close()


def y4m_frames(path):
    r = NativeY4MReader(path)
    frames = []
    while (raw := r.read_yuv()) is not None:
        frames.append(raw.tobytes())
    r.close()
    return frames


def test_headless_app_matches_stabilizer(tmp_path):
    """The app's written frames are the port ``Stabilizer``'s outputs on the
    same simulator frames, after the ``future`` frames of the sync buffer."""
    out = str(tmp_path / "out.y4m")
    assert app.main(APP_ARGS + ["--max-frames", "12", "--output", out], device="cpu") == 0
    assert app.last_run["frames"] == 12 and app.last_run["written"] == 12 - FUTURE
    got = y4m_frames(out)
    assert len(got) == 12 - FUTURE

    src = SimulatorSource(device="cpu")
    cfg = StabilizerConfig(past_frames=6, future_frames=FUTURE, working_height=180,
                           frame_height=720, frame_width=1280)
    stab = Stabilizer(cfg, device="cpu")
    want = [stab.stabilize_frame(src.read_tensor()).numpy() for _ in range(12)][FUTURE:]
    for i, (g, w) in enumerate(zip(got, want)):
        assert g == encode_y4m_planes(w, False), f"frame {i}"


def test_checkpoint_resume_through_the_app(tmp_path, capsys):
    """--checkpoint saves the carry at exit; --resume restores it and the
    frame counter goes on (8 -> 16); the file names its leaves."""
    ckpt = str(tmp_path / "state.npz")
    assert app.main(APP_ARGS + ["--max-frames", "8", "--checkpoint", ckpt], device="cpu") == 0
    assert os.path.exists(ckpt)
    assert app.main(APP_ARGS + ["--max-frames", "8", "--checkpoint", ckpt, "--resume", ckpt],
                    device="cpu") == 0
    assert "(frame counter 8)" in capsys.readouterr().out
    assert app.last_run["frame_counter"] == 16
    data = np.load(ckpt)
    counters = [int(data[k]) for k in data.files
                if k != "__meta__" and data[k].shape == () and data[k].dtype == np.int32]
    assert 16 in counters


def test_stats_flag_headless(capsys):
    """--stats prints the printTimings-style stage timings at startup."""
    assert app.main(APP_ARGS + ["--max-frames", "4", "--stats"], device="cpu") == 0
    out = capsys.readouterr().out
    for name in ("goodFeaturesToTrack", "calcOpticalFlowPyrLK", "estimateAffinePartial2D",
                 "warpPerspective"):
        assert name in out


def test_profile_stages_taxonomy():
    """The in-loop taxonomy of --stats: stage times of a few steps, in the
    reference's labels."""
    from video_stabilization_tpu_torch.engine import stabilize_step
    from video_stabilization_tpu_torch.utils.stage_profile import (
        format_taxonomy, profile_stages)

    cfg = StabilizerConfig(past_frames=2, future_frames=1, working_height=100,
                           frame_height=120, frame_width=160)
    carry = init_carry(cfg, 0, prng.key(0), "cpu")
    frame = torch.from_numpy(np.random.default_rng(0).integers(0, 256, (120, 160, 3),
                                                               dtype=np.uint8))

    def run():
        c = carry
        for _ in range(2):
            c, _ = stabilize_step(c, frame, cfg, 0)

    stage_ms = profile_stages(run, "cpu", n_calls=2)
    for name in ("gray_pyramid", "lk", "fit", "smoothing", "warp", "gftt", "total", "other"):
        assert stage_ms[name] >= 0.0, name
    line = format_taxonomy(stage_ms)
    assert "goodFeaturesToTrack" in line and "warpPerspective" in line and "total" in line


@pytest.mark.parametrize("extra", [["--trail"], ["--motion-model", "affine"],
                                   ["--reference-compat"]],
                         ids=["trail", "motion_model_affine", "reference_compat"])
def test_app_refuses_what_is_not_ported(tmp_path, extra):
    """Once refused (ROADMAP Queue 1 items 13 and 14), each flag now runs:
    6 frames written after the sync buffer.  ``--motion-model`` and
    ``--reference-compat`` write the port ``Stabilizer``'s outputs of that
    configuration on the same simulator frames; ``--trail`` writes its
    composite instead, which differs from them."""
    out = str(tmp_path / "out.y4m")
    n = 6 + FUTURE
    assert app.main(APP_ARGS + ["--max-frames", str(n), "--output", out] + extra,
                    device="cpu") == 0
    assert app.last_run["written"] == 6
    got = y4m_frames(out)
    assert len(got) == 6

    src = SimulatorSource(device="cpu")
    cfg = StabilizerConfig(past_frames=6, future_frames=FUTURE, working_height=180,
                           frame_height=720, frame_width=1280,
                           reference_compat="--reference-compat" in extra)
    if "--motion-model" in extra:
        cfg = dataclasses.replace(cfg, ransac=dataclasses.replace(cfg.ransac,
                                                                  motion_model="affine"))
    stab = Stabilizer(cfg, device="cpu")
    want = [stab.stabilize_frame(src.read_tensor()).numpy() for _ in range(n)][FUTURE:]
    same = [g == encode_y4m_planes(w, False) for g, w in zip(got, want)]
    if "--trail" in extra:
        assert not any(same)
    else:
        assert all(same)


def test_app_refuses_cuda_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        app.main(APP_ARGS + ["--max-frames", "2"])


def test_module_entry_points():
    """Importing ``cli.__main__`` runs nothing; ``python -m ... --help``
    prints the usage."""
    code = ("import video_stabilization_tpu_torch.cli.__main__\n"
            "import video_stabilization_tpu_torch.serve\n"
            "print('imported')")
    proc = subprocess.run([sys.executable, "-c", code], cwd=REPO, capture_output=True,
                          text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "imported"
    proc = subprocess.run([sys.executable, "-m", "video_stabilization_tpu_torch.cli", "--help"],
                          cwd=REPO, capture_output=True, text=True, timeout=120)
    assert proc.returncode == 0, proc.stderr
    assert "--simulator" in proc.stdout and "--checkpoint" in proc.stdout


# --- step factories ----------------------------------------------------------

def clip(n, h=120, w=160, seed=0):
    """(n, h, w, 3) shaky simulator frames from the port's simulator."""
    from video_stabilization_tpu_torch.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)

    rng = np.random.default_rng(seed)
    tex = torch.from_numpy(make_default_texture(rng, 128))
    traj = shake_trajectory(rng.standard_normal((n, 3)), rng.standard_normal(n),
                            DEFAULT_APP_PARAMS, pos_amplitude=0.004, roll_amplitude=0.3)
    return torch.stack([render_frame(tex, traj[i], h, w) for i in range(n)])


def factory_config(**kw):
    return StabilizerConfig(past_frames=4, future_frames=2, working_height=100,
                            frame_height=120, frame_width=160, **kw)


def test_step_fn_matches_stabilizer():
    """``make_step_fn``'s step equals ``Stabilizer.stabilize_frame`` bit for
    bit, the carry included; one callable per configuration."""
    cfg = factory_config()
    frames = clip(6)
    step = make_step_fn(cfg)
    assert make_step_fn(cfg) is step
    carry = init_carry(cfg, int(StabilizationMode.ACCUMULATED_FULL_LOCK), prng.key(3), "cpu")
    stab = Stabilizer(cfg, StabilizationMode.ACCUMULATED_FULL_LOCK, seed=3, device="cpu")
    for f in frames:
        carry, (out, valid) = step(carry, f)
        assert torch.equal(out, stab.stabilize_frame(f)) and bool(valid)
    for name in ("last_h", "accum_h", "transforms", "corners_prev", "n"):
        assert torch.equal(getattr(carry, name), getattr(stab.carry, name)), name


@pytest.mark.parametrize("static", [None, StabilizationMode.GLOBAL_SMOOTHING])
def test_step_fn_mode_from_carry_or_static_mode(static):
    """Without ``static_mode`` the step runs the carry's mode (one read of
    ``carry.mode``); with it, the static mode whatever the carry says."""
    cfg = factory_config(static_mode=None if static is None else int(static))
    carry = init_carry(cfg, int(StabilizationMode.ROTATION_LOCK), prng.key(0), "cpu")
    carry, _ = make_step_fn(cfg)(carry, clip(1)[0])
    assert bool(carry.accum_active) == (static is None)


def test_scan_still_matches_step_after_fold_in_keys():
    """The scan over a clip is bit-identical to the per-frame path (the
    keys are ``fold_in`` of the frame counter in both)."""
    cfg = factory_config()
    frames = clip(8, seed=1)
    stab = Stabilizer(cfg, StabilizationMode.GLOBAL_SMOOTHING, seed=7, device="cpu")
    outs_s = torch.stack([stab.stabilize_frame(f) for f in frames])
    scan = make_scan_fn(cfg)
    carry = init_carry(cfg, int(StabilizationMode.GLOBAL_SMOOTHING), prng.key(7), "cpu")
    carry, (outs, valid) = scan(carry, frames.numpy())
    assert torch.equal(outs, outs_s)
    assert valid.shape == (8,) and bool(valid.all())
    assert int(carry.n) == 8 and torch.equal(carry.last_h, stab.carry.last_h)
