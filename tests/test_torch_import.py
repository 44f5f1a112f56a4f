"""The port's import and device boundaries: no JAX, no implicit device, no
build at import, the configurations it refuses, and those it runs now."""

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


@pytest.mark.parametrize("kw,match", [
    (dict(ransac=RansacConfig(motion_model="homography")), "item 13"),
    (dict(ransac=RansacConfig(method="cv2exact")), "item 14"),
    (dict(reference_compat=True), "item 14"),
])
def test_unported_configs_refused(kw, match):
    with pytest.raises(NotImplementedError, match=match):
        Stabilizer(small_cfg(**kw), device="cpu")


@pytest.mark.parametrize("kw", [dict(lk=LKConfig(method="sweep")),
                                dict(gftt=GFTTConfig(selection="cv2exact"))])
def test_unported_stages_refused_at_first_frame(kw):
    import numpy as np

    stab = Stabilizer(small_cfg(**kw), device="cpu")
    with pytest.raises(NotImplementedError, match="item 14"):
        stab.stabilize_frame(np.zeros((120, 160, 3), np.uint8))


def test_static_mode_is_honoured():
    cfg = dataclasses.replace(small_cfg(), static_mode=int(StabilizationMode.ROTATION_LOCK))
    stab = Stabilizer(cfg, device="cpu")
    import numpy as np

    out = stab.stabilize_frame(np.full((120, 160, 3), 7, np.uint8))
    assert out.shape == (120, 160, 3)
    assert bool(stab.carry.accum_active)      # the accumulated branch ran
