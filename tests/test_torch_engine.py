"""PyTorch port vs the JAX package: smoothing, the whole per-frame step, and
state carried across between the two packages.

Footage is tests/test_engine.py's small-config clip rendered by the JAX
simulator; both packages consume the same uint8 frames.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.config import ECCConfig, StabilizationMode
from video_stabilization_tpu.engine import Stabilizer as JStabilizer
from video_stabilization_tpu.engine import make_step_fn
from video_stabilization_tpu.engine import smoothing_homography as j_smoothing
from video_stabilization_tpu.engine.checkpoint import save_carry
from video_stabilization_tpu.sim import (
    DEFAULT_APP_PARAMS, make_default_texture, render_frame, shake_trajectory)
from video_stabilization_tpu_torch.config import config_from_fields
from video_stabilization_tpu_torch.engine import (
    Stabilizer as TStabilizer, carry_from_numpy, carry_to_numpy, smoothing_homography,
    stabilize_step)
from test_engine import (
    FH, FW, np_reference_smoothing, random_rigid_transforms, small_config)
from torch_threads import one_torch_thread  # noqa: F401

N_FRAMES = 20
N_ORB_FRAMES = 16
LAST_H_DRIFT = 0.05     # px, working resolution
LOCK_MATCHES = 2        # |Δ| of the lock's good-match count
MEAN_U8 = 0.5           # mean |Δ| of output frames, u8 levels
WITHIN_1 = 0.99         # share of output pixels within 1 level


@pytest.fixture(scope="module")
def footage():
    tex = make_default_texture(jax.random.key(0), size=256)
    traj = shake_trajectory(jax.random.key(5), 30, DEFAULT_APP_PARAMS,
                            pos_amplitude=0.004, roll_amplitude=0.3)
    return np.array(jax.vmap(lambda p: render_frame(tex, p, FH, FW))(traj))


def jax_carry_arrays(carry) -> dict:
    """The JAX carry's leaves as {pytree path: numpy array} (key as words)."""
    flat, _ = jax.tree_util.tree_flatten_with_path(carry)
    out = {}
    for path, leaf in flat:
        name = jax.tree_util.keystr(path)
        if "key" in str(leaf.dtype):
            leaf = jax.random.key_data(leaf)
        out[name] = np.array(leaf)
    return out


def corner_drift(ha, hb, cfg):
    wh, ww = cfg.working_size
    c = np.array([[0, 0, 1], [ww, 0, 1], [ww, wh, 1], [0, wh, 1]], float).T
    pa, pb = ha @ c, hb @ c
    return np.abs(pa[:2] / pa[2] - pb[:2] / pb[2]).mean()


def assert_step_agrees(jcarry, jout, tcarry, tout, cfg, where=""):
    drift = corner_drift(np.asarray(jcarry.last_h, float), tcarry.last_h.double().numpy(), cfg)
    assert drift <= LAST_H_DRIFT, f"{where}: last_h drift {drift}"
    d = np.abs(np.asarray(jout).astype(np.int32) - tout.numpy().astype(np.int32))
    assert d.mean() <= MEAN_U8, f"{where}: mean |out| {d.mean()}"
    assert (d <= 1).mean() >= WITHIN_1, f"{where}: within 1 level {(d <= 1).mean()}"
    assert int(jcarry.n) == int(tcarry.n)
    np.testing.assert_array_equal(np.asarray(jcarry.tvalid), tcarry.tvalid.numpy())
    assert int(jcarry.envelope_violations) == int(tcarry.envelope_violations)


@pytest.mark.parametrize("compat", [False, True])
@pytest.mark.parametrize("p,n", [(4, 9), (0, 9), (8, 9), (3, 5), (0, 1), (6, 12)])
def test_smoothing_homography(rng, compat, p, n):
    wm1 = 12
    ts = random_rigid_transforms(rng, n)
    arr = np.broadcast_to(np.eye(3, dtype=np.float32), (wm1, 3, 3)).copy()
    arr[wm1 - n:] = ts
    tvalid = np.zeros(wm1, bool)
    tvalid[wm1 - n:] = True
    q_jax = np.asarray(j_smoothing(jnp.asarray(arr), jnp.asarray(tvalid), jnp.asarray(p),
                                   jnp.asarray(n), reference_compat=compat))
    q = smoothing_homography(torch.from_numpy(arr), torch.from_numpy(tvalid),
                             torch.tensor(p), torch.tensor(n), reference_compat=compat)
    np.testing.assert_allclose(q.numpy(), q_jax, atol=1e-5)
    np.testing.assert_allclose(q.numpy(), np_reference_smoothing(ts, p, compat), atol=1e-5)


SCENARIOS = {
    "smoothing": [(0, StabilizationMode.GLOBAL_SMOOTHING)],
    "accumulated": [(0, StabilizationMode.ACCUMULATED_FULL_LOCK)],
    "translation_after_switch": [(0, StabilizationMode.GLOBAL_SMOOTHING),
                                 (10, StabilizationMode.TRANSLATION_LOCK)],
    "rotation_after_switch": [(0, StabilizationMode.GLOBAL_SMOOTHING),
                              (10, StabilizationMode.ROTATION_LOCK)],
}


@pytest.mark.parametrize("scenario", list(SCENARIOS))
def test_whole_slice_matches_jax(footage, scenario):
    """Frame by frame, both packages' Stabilizer on the same clip."""
    cfg = small_config()
    plan = SCENARIOS[scenario]
    js = JStabilizer(cfg, plan[0][1])
    ts = TStabilizer(config_from_fields(cfg), plan[0][1], device="cpu")
    for i, frame in enumerate(footage[:N_FRAMES]):
        for at, mode in plan[1:]:
            if i == at:
                js.set_stabilization_mode(mode)
                ts.set_stabilization_mode(mode)
        jout = js.stabilize_frame(frame)
        tout = ts.stabilize_frame(frame)
        assert_step_agrees(js.carry, jout, ts.carry, tout, cfg, f"{scenario} frame {i}")
    assert bool(js.carry.accum_active) == bool(ts.carry.accum_active)


ORB, SIFT = StabilizationMode.ORB_FULL_LOCK, StabilizationMode.SIFT_FULL_LOCK


def ecc_config():
    """The one ECC-enabled configuration of these tests (the JAX step
    compiles anew for it): SIFT_FULL_LOCK pinned, so the JAX step traces the
    SIFT branch only, and ECC with 10 iterations."""
    return dataclasses.replace(small_config(), ecc=ECCConfig(enabled=True, max_iters=10),
                               static_mode=int(SIFT))


ORB_SCENARIOS = {
    "orb": [(0, ORB)],
    "orb_recapture": [(0, StabilizationMode.GLOBAL_SMOOTHING), (3, ORB),
                      (8, StabilizationMode.GLOBAL_SMOOTHING), (10, ORB)],
}
SIFT_SCENARIOS = {
    "sift": (small_config, [(0, SIFT)]),
    "sift_recapture": (small_config, [(0, StabilizationMode.GLOBAL_SMOOTHING), (3, SIFT),
                                      (8, StabilizationMode.GLOBAL_SMOOTHING), (10, SIFT)]),
    "sift_ecc": (ecc_config, [(0, SIFT)]),
}


def run_lock_scenario(footage, cfg, plan, ref_of: str, scenario: str) -> None:
    """Both packages' Stabilizer frame by frame through ``plan``'s mode
    switches: each step agrees, both hold the same reference state, and the
    lock's good-match counts agree within LOCK_MATCHES."""
    js = JStabilizer(cfg, plan[0][1])
    ts = TStabilizer(config_from_fields(cfg), plan[0][1], device="cpu")
    captured = 0
    for i, frame in enumerate(footage[:N_ORB_FRAMES]):
        for at, mode in plan[1:]:
            if i == at:
                js.set_stabilization_mode(mode)
                ts.set_stabilization_mode(mode)
        jout = js.stabilize_frame(frame)
        tout = ts.stabilize_frame(frame)
        where = f"{scenario} frame {i}"
        assert_step_agrees(js.carry, jout, ts.carry, tout, cfg, where)
        is_set = bool(getattr(ts.carry, ref_of).is_set)
        assert bool(getattr(js.carry, ref_of).is_set) == is_set, where
        captured += is_set
        dm = abs(int(js.carry.last_lock_matches) - int(ts.carry.last_lock_matches))
        assert dm <= LOCK_MATCHES, f"{where}: lock matches differ by {dm}"
    assert captured >= N_ORB_FRAMES // 2
    assert int(ts.carry.last_lock_matches) >= cfg.ransac.min_points


@pytest.mark.parametrize("scenario", list(ORB_SCENARIOS))
def test_orb_slice_matches_jax(footage, scenario):
    """The ORB registration lock, frame by frame in both packages, through
    mode switches that clear and recapture the reference."""
    run_lock_scenario(footage, small_config(), ORB_SCENARIOS[scenario], "orb_ref", scenario)


@pytest.mark.parametrize("scenario", list(SIFT_SCENARIOS))
def test_sift_slice_matches_jax(footage, scenario):
    """The SIFT registration lock, alone and refined by ECC, frame by frame
    in both packages, through mode switches that clear and recapture the
    reference.  SIFT holds the ORB slice's LOCK_MATCHES (measured: equal
    match counts on every frame of all three scenarios)."""
    make_cfg, plan = SIFT_SCENARIOS[scenario]
    run_lock_scenario(footage, make_cfg(), plan, "sift_ref", scenario)


@pytest.mark.parametrize("mode", [StabilizationMode.GLOBAL_SMOOTHING,
                                  StabilizationMode.ACCUMULATED_FULL_LOCK, ORB, SIFT])
def test_state_carried_across(footage, mode):
    """JAX carry after 8 frames -> carry_from_numpy -> one step in each
    package: isolates per-step divergence from accumulated divergence.  In
    the registration locks the carry holds a captured reference, which must
    come back unchanged through carry_to_numpy."""
    cfg = small_config()
    js = JStabilizer(cfg, mode)
    for frame in footage[:8]:
        js.stabilize_frame(frame)
    arrays = jax_carry_arrays(js.carry)
    tcarry = carry_from_numpy(arrays, "cpu")
    jcarry, (jout, _) = make_step_fn(cfg)(js.carry, jnp.asarray(footage[8]))
    tcarry, (tout, _) = stabilize_step(tcarry, torch.from_numpy(footage[8].copy()),
                                       config_from_fields(cfg), int(mode))
    assert_step_agrees(jcarry, jout, tcarry, tout, cfg, "carried step")
    assert int(jcarry.last_lock_matches) == int(tcarry.last_lock_matches)
    back = carry_to_numpy(tcarry)
    for name, arr in jax_carry_arrays(jcarry).items():
        if name.startswith((".orb_ref", ".sift_ref")):
            np.testing.assert_array_equal(back[name], arr, err_msg=name)
    assert bool(back[".orb_ref.is_set"]) == (mode == ORB)
    assert bool(back[".sift_ref.is_set"]) == (mode == SIFT)


def test_save_carry_layout_loads(footage, tmp_path):
    """An npz written by the JAX package's save_carry loads into the port."""
    import json

    cfg = small_config()
    js = JStabilizer(cfg)
    for frame in footage[:3]:
        js.stabilize_frame(frame)
    path = tmp_path / "carry.npz"
    save_carry(str(path), js.carry)
    data = np.load(path)
    meta = json.loads(bytes(data["__meta__"]).decode())
    arrays = {m["name"]: data[f"leaf_{i}"] for i, m in enumerate(meta)}
    tcarry = carry_from_numpy(arrays, "cpu")
    back = carry_to_numpy(tcarry)
    want = jax_carry_arrays(js.carry)
    assert set(back) == set(want)
    for name, arr in want.items():
        assert back[name].dtype == arr.dtype, name
        np.testing.assert_array_equal(back[name], arr, err_msg=name)


def test_carry_to_numpy_round_trip(footage):
    cfg = small_config()
    ts = TStabilizer(config_from_fields(cfg), StabilizationMode.ACCUMULATED_FULL_LOCK, seed=11,
                     device="cpu")
    for frame in footage[:4]:
        ts.stabilize_frame(frame)
    arrays = carry_to_numpy(ts.carry)
    again = carry_to_numpy(carry_from_numpy(arrays, "cpu"))
    assert set(again) == set(arrays)
    for name in arrays:
        np.testing.assert_array_equal(again[name], arrays[name], err_msg=name)
    np.testing.assert_array_equal(arrays[".key"], np.array([0, 11], np.uint32))


def test_first_frame_passthrough(footage):
    ts = TStabilizer(config_from_fields(small_config()), device="cpu")
    np.testing.assert_array_equal(ts.stabilize_frame(footage[0]).numpy(), footage[0])


def test_stabilize_clip_matches_per_frame(footage):
    cfg = config_from_fields(small_config(past=4, future=2))
    a = TStabilizer(cfg, seed=7, device="cpu")
    b = TStabilizer(cfg, seed=7, device="cpu")
    outs = a.stabilize_clip(footage[:6])
    for i, frame in enumerate(footage[:6]):
        np.testing.assert_array_equal(outs[i].numpy(), b.stabilize_frame(frame).numpy())
    assert int(a.carry.n) == 6


# dense LK's phases, inside the body's ``lk``
LK_STAGES = {"lk_sweep", "lk_levels", "lk_level0", "lk_gate"}
STAGES = {"gray_pyramid", "lk", "fit", "smoothing", "lock", "lock_detect", "lock_register",
          "nearest_downscale", "preprocess", "match", "lock_ransac", "rotation_split",
          "warp", "gftt", "input_h2d", "step"} | LK_STAGES
LOCK_STAGES = {ORB: {"orb_detect"},
               SIFT: {"sift_detect", "sift_scale_space", "ecc"}}
# the offline chunk's stages (once per chunk) and the lock's own (per frame)
OFFLINE_STAGES = {"gray_pyramid", "gftt", "lk", "fit", "smoothing", "lock", "lock_detect",
                  "lock_register", "rotation_split", "warp"} | LK_STAGES
OFFLINE_LOCK_STAGES = {"nearest_downscale", "preprocess", "orb_detect", "match",
                       "lock_ransac"}


@pytest.mark.parametrize("mode", [ORB, SIFT, "offline_orb"])
def test_stage_ranges_only_while_profiling(footage, mode):
    """The step's stage ranges reach the profiler only while
    ``stage_profile.enabled`` is set, and then every stage shows once per
    frame of the registration lock (SIFT with ECC); in an offline ORB chunk
    of two frames the chunk's stages show once and the lock's twice."""
    from video_stabilization_tpu_torch.engine import init_carry, offline_chunk_step
    from video_stabilization_tpu_torch.utils import prng, stage_profile

    chunked = mode == "offline_orb"
    if chunked:
        mode = ORB
    cfg = small_config()
    if mode == SIFT:    # two ECC iterations keep the profiled run short
        cfg = dataclasses.replace(cfg, ecc=ECCConfig(enabled=True, max_iters=2))
    tcfg = config_from_fields(dataclasses.replace(cfg, static_mode=int(mode)))
    ts = TStabilizer(config_from_fields(cfg), mode, device="cpu")
    carry = init_carry(tcfg, int(mode), prng.key(0), "cpu")
    seen = {}
    for on in (False, True):
        stage_profile.enabled = on
        try:
            with torch.profiler.profile(
                    activities=[torch.profiler.ProfilerActivity.CPU]) as prof:
                if chunked:
                    carry, _ = offline_chunk_step(carry, torch.from_numpy(footage[:2]), tcfg)
                else:
                    for frame in footage[:2]:
                        ts.stabilize_frame(frame)
        finally:
            stage_profile.enabled = False
        seen[on] = {e.key[6:]: e.count for e in prof.key_averages()
                    if e.key.startswith("stage:")}
    assert seen[False] == {}
    if chunked:
        want = {**{name: 1 for name in OFFLINE_STAGES},
                **{name: 2 for name in OFFLINE_LOCK_STAGES}}
    else:
        want = {name: 2 for name in STAGES | LOCK_STAGES[mode]}
    assert seen[True] == want


@pytest.mark.parametrize("mode", [ORB, SIFT])
def test_capture_frame_is_identity_with_ecc(footage, mode):
    """With ECC on, the register side also runs on a capture frame, against
    the empty reference's zero image; ``torch.where`` keeps the capture
    values: the lock is the identity and nothing in the carry is NaN."""
    cfg = config_from_fields(dataclasses.replace(ecc_config(), static_mode=None))
    ts = TStabilizer(cfg, mode, device="cpu")
    eye = torch.eye(3)
    for i, frame in enumerate(footage[:3]):
        if i == 2:       # clear and capture again mid-stream
            ts.set_stabilization_mode(mode)
        ts.stabilize_frame(frame)
        if i in (0, 2):
            assert torch.equal(ts.carry.lock_prev_h, eye), i
            assert torch.equal(ts.carry.last_h, eye), i
            assert int(ts.carry.last_lock_matches) == 0
        for name, arr in carry_to_numpy(ts.carry).items():
            if arr.dtype.kind == "f":
                assert not np.isnan(arr).any(), (i, name)
