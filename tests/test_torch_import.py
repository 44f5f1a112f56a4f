"""The port's import and device boundaries: no JAX, no implicit device, no
build at import, and the configurations it once refused, which run now."""

import dataclasses
import os
import subprocess
import sys
from pathlib import Path

import pytest
import torch

from video_stabilization_tpu_torch.config import (
    ECCConfig, GFTTConfig, LKConfig, RansacConfig, StabilizationMode, StabilizerConfig)
from video_stabilization_tpu_torch.engine import Stabilizer
from torch_threads import one_torch_thread  # noqa: F401

REPO = Path(__file__).resolve().parents[1]


def run_python(code: str, env_extra=None) -> subprocess.CompletedProcess:
    env = dict(os.environ, **(env_extra or {}))
    return subprocess.run([sys.executable, "-c", code], cwd=REPO, env=env,
                          capture_output=True, text=True, timeout=120)


def test_port_imports_without_jax():
    """Every module of the port, and chip_smoke.py, load neither JAX nor any
    module of the JAX package; the walk imports ``cli.__main__`` too, which
    must not run the app."""
    proc = run_python(
        "import importlib, pkgutil, sys\n"
        "import video_stabilization_tpu_torch as pkg\n"
        "names = [m.name for m in pkgutil.walk_packages(pkg.__path__, pkg.__name__ + '.')]\n"
        "for name in names:\n"
        "    importlib.import_module(name)\n"
        "import chip_smoke\n"
        "bad = sorted(m for m in sys.modules if m.startswith('jax')\n"
        "             or m == 'video_stabilization_tpu'\n"
        "             or m.startswith('video_stabilization_tpu.'))\n"
        "assert not bad, bad\n"
        "assert 'video_stabilization_tpu_torch.ops.fast' in names, names\n"
        "assert 'video_stabilization_tpu_torch.engine.lock' in names, names\n"
        "assert 'video_stabilization_tpu_torch.engine.offline' in names, names\n"
        "assert 'video_stabilization_tpu_torch.parallel.streams' in names, names\n"
        "for mod in ('io', 'io.native', 'io.video', 'cli', 'cli.app', 'cli.args',\n"
        "            'cli.term_display', 'cli.__main__', 'serve', 'utils.timing'):\n"
        "    assert 'video_stabilization_tpu_torch.' + mod in names, (mod, names)\n"
        "print('ok')")
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def test_kernel_module_imports_without_nvcc_or_gpu():
    """Import and the CPU warp and FAST need no toolkit and build nothing."""
    proc = run_python(
        "import torch\n"
        "from video_stabilization_tpu_torch.ops import affine_warp as aw\n"
        "out = aw.warp_affine(torch.rand(8, 9, 3), torch.eye(3), 2.0)\n"
        "assert out.shape == (8, 9, 3) and aw._lib is None and aw.launches == 0\n"
        "from video_stabilization_tpu_torch.ops import fast\n"
        "score, _ = fast.fast_score(torch.rand(16, 20) * 255, 20.0)\n"
        "assert score.shape == (16, 20) and fast._lib is None and fast.launches == 0\n"
        "maps = fast.fast_levels([torch.rand(16, 20) * 255, torch.rand(9, 12)], 20.0, 3)\n"
        "assert [m.shape for m in maps] == [(16, 20), (9, 12)] and fast.launches == 0\n"
        "print('ok')",
        env_extra={"PATH": "/nonexistent", "CUDA_HOME": "/nonexistent"})
    assert proc.returncode == 0, proc.stderr
    assert proc.stdout.strip() == "ok"


def small_cfg(**kw):
    return StabilizerConfig(frame_height=120, frame_width=160, working_height=100,
                            past_frames=2, future_frames=1, **kw)


def test_cuda_device_raises_without_a_card():
    if torch.cuda.is_available():
        pytest.skip("a CUDA card is present: this checks the refusal without one")
    with pytest.raises(RuntimeError, match="CUDA"):
        Stabilizer(small_cfg(), device="cuda")


def test_device_is_explicit():
    """The card by default: with none, asking for it raises naming CUDA; the
    CPU only when the caller names it."""
    if torch.cuda.is_available():
        assert Stabilizer(small_cfg()).device.type == "cuda"
    else:
        with pytest.raises(RuntimeError, match="CUDA"):
            Stabilizer(small_cfg())
    assert Stabilizer(small_cfg(), device="cpu").device.type == "cpu"


@pytest.mark.parametrize("mode", [StabilizationMode.ORB_FULL_LOCK,
                                  StabilizationMode.SIFT_FULL_LOCK])
def test_registration_locks_capture_and_clear(mode):
    """Both registration locks run: the first frame captures the reference,
    and a mode switch clears it."""
    import numpy as np

    ref_of = "orb_ref" if mode == StabilizationMode.ORB_FULL_LOCK else "sift_ref"
    stab = Stabilizer(small_cfg(), mode, device="cpu")
    stab.stabilize_frame(np.full((120, 160, 3), 7, np.uint8))
    assert bool(getattr(stab.carry, ref_of).is_set)
    stab.set_stabilization_mode(StabilizationMode.GLOBAL_SMOOTHING)
    stab.set_stabilization_mode(mode)
    assert not bool(getattr(stab.carry, ref_of).is_set)


def test_ecc_enabled_orb_lock_runs():
    """ECC refinement is no longer refused: an ECC-enabled ORB lock runs,
    captures its reference and stays finite."""
    import numpy as np

    stab = Stabilizer(small_cfg(ecc=ECCConfig(enabled=True, max_iters=3)),
                      StabilizationMode.ORB_FULL_LOCK, device="cpu")
    for v in (0, 9):
        out = stab.stabilize_frame(np.full((120, 160, 3), v, np.uint8))
    assert out.shape == (120, 160, 3)
    assert bool(stab.carry.orb_ref.is_set)
    assert torch.isfinite(stab.carry.last_h).all()


@pytest.fixture(scope="module")
def clip():
    """Four shaky 240x320 frames from the port's simulator."""
    import numpy as np

    from video_stabilization_tpu_torch.sim import (
        DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)

    rng = np.random.default_rng(2)
    tex = torch.from_numpy(make_default_texture(rng, 256))
    traj = shake_trajectory(rng.standard_normal((4, 3)), rng.standard_normal(4),
                            DEFAULT_APP_PARAMS, pos_amplitude=0.004, roll_amplitude=0.3)
    return [render_frame(tex, traj[i], 240, 320).numpy() for i in range(4)]


def run_cfg(**kw):
    """240x320 at working height 120: an integer downscale, as the
    referee's exact gray requires."""
    kw.setdefault("gftt", GFTTConfig(max_features=128))
    return StabilizerConfig(frame_height=240, frame_width=320, working_height=120,
                            past_frames=2, future_frames=1, **kw)


def run_frames(stab, clip):
    outs = [stab.stabilize_frame(f) for f in clip]
    for out in outs:
        assert out.shape == (240, 320, 3) and out.dtype == torch.uint8
    assert int(stab.carry.n) == len(clip)
    assert torch.isfinite(stab.carry.last_h).all()
    assert int(stab.carry.last_inliers) >= 10       # the motion fit found its inliers
    return outs


@pytest.mark.parametrize("kw", [
    dict(ransac=RansacConfig(motion_model="homography")),
    dict(ransac=RansacConfig(method="cv2exact")),
    dict(reference_compat=True),
], ids=["homography", "cv2exact_ransac", "reference_compat"])
def test_unported_configs_refused(clip, kw):
    """Once refused (ROADMAP Queue 1 items 13 and 14), each of these
    configurations now runs: four frames on the CPU, outputs of the frame's
    shape, a finite transform fit on its inliers.  The host estimator of
    ``ransac.method="cv2exact"`` reads once per frame; the homography model
    never counts an envelope violation (its output warp has none)."""
    stab = Stabilizer(run_cfg(**kw), device="cpu")
    run_frames(stab, clip)
    if "ransac" in kw and kw["ransac"].method == "cv2exact":
        assert stab.host_reads == len(clip)
    else:
        assert stab.host_reads == 0
    if "ransac" in kw and kw["ransac"].motion_model == "homography":
        assert int(stab.carry.envelope_violations) == 0


def test_cv2exact_ransac_refuses_non_rigid_models():
    """The one refusal left of these, the JAX package's own: the cv2exact
    host estimator fits the rigid model only."""
    with pytest.raises(ValueError, match="rigid"):
        Stabilizer(run_cfg(ransac=RansacConfig(method="cv2exact", motion_model="affine")),
                   device="cpu")


@pytest.mark.parametrize("kw", [dict(lk=LKConfig(method="sweep")),
                                dict(gftt=GFTTConfig(max_features=128,
                                                     selection="cv2exact"))],
                         ids=["sweep_lk", "cv2exact_gftt"])
def test_unported_stages_refused_at_first_frame(clip, kw):
    """Once refused at the first frame (ROADMAP Queue 1 item 14), the sweep
    tracker and cv2's exact corner list now run four frames; the exact
    list keeps cv2's minimum distance between any two corners."""
    stab = Stabilizer(run_cfg(**kw), device="cpu")
    run_frames(stab, clip)
    if "gftt" in kw:
        pts = stab.carry.corners_prev[stab.carry.corners_mask]
        d = torch.cdist(pts, pts) + torch.eye(len(pts)) * 1e9
        assert len(pts) > 20 and float(d.min()) >= 10.0 * 120 / 720 - 1e-6


def test_static_mode_is_honoured():
    cfg = dataclasses.replace(small_cfg(), static_mode=int(StabilizationMode.ROTATION_LOCK))
    stab = Stabilizer(cfg, device="cpu")
    import numpy as np

    out = stab.stabilize_frame(np.full((120, 160, 3), 7, np.uint8))
    assert out.shape == (120, 160, 3)
    assert bool(stab.carry.accum_active)      # the accumulated branch ran
