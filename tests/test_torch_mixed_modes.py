"""The port's batched step, its scan and its sharded step with no pinned
mode (streams in mixed modes in one batch) against the JAX package's
dynamic-mode sharded step, and against the port's own body run in each
stream's mode.

One JAX function is compiled, once: ``make_sharded_step_fn`` of
``tiny_config()`` with ``static_mode=None`` on the 8-device CPU mesh
(tests/conftest.py), whose vmap runs every lock branch for every stream.
Eight streams of :func:`render_streams` take the modes ``MODES``, which
cover all six; a second run from the carry after ``SWITCH_AT`` frames
switches stream 0 to SIFT_FULL_LOCK.

Bounds against JAX: tests/test_torch_sharded.py's (PERF.md §2's offline
bound per frame, equal inlier counts, the final ``last_h`` within
``LAST_H_DRIFT``) for the streams in GLOBAL_SMOOTHING, the accumulated,
translation and rotation locks; the ORB and SIFT streams take their
single-mode parity test's (tests/test_torch_engine.py
``run_lock_scenario``: the step's drift and output bounds each frame,
lock matches within ``LOCK_MATCHES``, the same reference captured).
Against the port's body in each stream's own mode: bit for bit.
"""

import dataclasses

import jax
import jax.numpy as jnp
import numpy as np
import pytest
import torch

from video_stabilization_tpu.parallel import init_batched_carry as j_init_batched_carry
from video_stabilization_tpu.parallel import make_sharded_step_fn as j_make_sharded_step_fn
from video_stabilization_tpu.parallel import make_stream_mesh as j_make_stream_mesh
from video_stabilization_tpu.parallel.streams import shard_carry as j_shard_carry
from video_stabilization_tpu_torch.config import StabilizationMode, config_from_fields
from video_stabilization_tpu_torch.engine import map_carry, offline_batched_chunk_step
from video_stabilization_tpu_torch.parallel import (
    Sharded, make_batched_scan_fn, make_batched_step_fn, make_sharded_step_fn,
    make_stream_mesh, shard_carry, unshard)
from test_parallel import tiny_config
from test_torch_engine import LAST_H_DRIFT, LOCK_MATCHES, MEAN_U8, WITHIN_1, corner_drift
from test_torch_offline import assert_frames_close_gather
from test_torch_parallel import SHARDED_STREAMS, SLOTS, carries_equal, port_carry, render_streams
from torch_threads import one_torch_thread  # noqa: F401

M = StabilizationMode
MODES = [0, 1, 2, 3, 4, 5, 0, 4]      # stream s's mode: all six
N_FRAMES, SEED = 6, 2
# the later runs (the scan, the sharded forms, the mode switch) start from
# the one-slot run's carry before this frame, with the locks active
SWITCH_AT, SWITCHED, SWITCH_TO = 4, 0, int(M.SIFT_FULL_LOCK)
REGISTERING = (int(M.ORB_FULL_LOCK), int(M.SIFT_FULL_LOCK))


def dynamic_config():
    return dataclasses.replace(tiny_config(), static_mode=None)


@pytest.fixture(scope="module")
def frames():
    """(T, S, H, W, 3) u8: eight streams of ``N_FRAMES`` frames."""
    return render_streams(SHARDED_STREAMS, N_FRAMES)


def record(carry, out) -> dict:
    """What a call is held to: outputs and the per-stream telemetry."""
    return {"out": np.asarray(out), "inliers": np.asarray(carry.last_inliers),
            "last_h": np.asarray(carry.last_h, np.float64),
            "matches": np.asarray(carry.last_lock_matches),
            "orb_set": np.asarray(carry.orb_ref.is_set),
            "sift_set": np.asarray(carry.sift_ref.is_set),
            "n": np.asarray(carry.n), "accum_h": np.asarray(carry.accum_h),
            "accum_active": np.asarray(carry.accum_active),
            "lock_prev_h": np.asarray(carry.lock_prev_h)}


def carry_numpy(carry):
    return map_carry(lambda x: x.numpy(), carry)


@pytest.fixture(scope="module")
def jax_run(frames):
    """JAX's dynamic-mode sharded step, compiled once: the records of the
    calls in ``MODES``, then of the calls from the carry after
    ``SWITCH_AT`` frames with stream ``SWITCHED`` in ``SWITCH_TO``."""
    cfg = dynamic_config()
    mesh = j_make_stream_mesh()
    assert len(mesh.devices) == SHARDED_STREAMS
    with pytest.warns(UserWarning, match="static_mode is None"):
        fn = j_make_sharded_step_fn(cfg, mesh)
    carry = j_init_batched_carry(cfg, SHARDED_STREAMS, 0, jax.random.key(SEED))
    carry = j_shard_carry(carry._replace(mode=jnp.asarray(MODES, jnp.int32)), mesh)
    calls, at_switch = [], None
    for t in range(N_FRAMES):
        if t == SWITCH_AT:          # a copy: the step donates its carry
            at_switch = jax.tree.map(lambda x: x.copy(), carry)
        carry, (out, _) = fn(carry, jnp.asarray(frames[t]))
        calls.append(record(carry, out))
    carry = at_switch._replace(mode=at_switch.mode.at[SWITCHED].set(SWITCH_TO))
    switched = []
    for t in range(SWITCH_AT, N_FRAMES):
        carry, (out, _) = fn(carry, jnp.asarray(frames[t]))
        switched.append(record(carry, out))
    return calls, switched


def mixed_carry(modes=MODES):
    carry = port_carry(tiny_config(), SHARDED_STREAMS, 0, SEED)
    return dataclasses.replace(carry, mode=torch.tensor(modes, dtype=torch.int32))


def check_against_jax(port_calls, jax_calls, modes):
    """Each call of the port against JAX's, stream by stream: the offline
    bound, or for an ORB or SIFT stream its parity test's bounds; equal
    inlier counts and frame counters; the last ``last_h`` within
    ``LAST_H_DRIFT`` on every stream.  A record without telemetry (the
    scan's frames before its last) is held on its outputs alone."""
    cfg = tiny_config()
    for i, (tc, jc) in enumerate(zip(port_calls, jax_calls)):
        assert tc["out"].shape == jc["out"].shape
        for s, mode in enumerate(modes):
            where = f"call {i} stream {s} (mode {mode})"
            if mode not in REGISTERING:
                assert_frames_close_gather(tc["out"][s], jc["out"][s])
                continue
            d = np.abs(jc["out"][s].astype(np.int32) - tc["out"][s].astype(np.int32))
            assert d.mean() <= MEAN_U8, f"{where}: mean |out| {d.mean()}"
            assert (d <= 1).mean() >= WITHIN_1, f"{where}: within 1 {(d <= 1).mean()}"
            if "last_h" in tc:
                drift = corner_drift(jc["last_h"][s], tc["last_h"][s], cfg)
                assert drift <= LAST_H_DRIFT, f"{where}: last_h drift {drift}"
                dm = abs(int(jc["matches"][s]) - int(tc["matches"][s]))
                assert dm <= LOCK_MATCHES, f"{where}: lock matches differ by {dm}"
                for ref in ("orb_set", "sift_set"):
                    assert bool(jc[ref][s]) == bool(tc[ref][s]), f"{where}: {ref}"
        if "last_h" in tc:
            np.testing.assert_array_equal(tc["inliers"], jc["inliers"], err_msg=f"call {i}")
            np.testing.assert_array_equal(tc["n"], jc["n"])
            np.testing.assert_array_equal(tc["matches"][[m not in REGISTERING for m in modes]],
                                          0)
    for s in range(len(modes)):
        drift = corner_drift(jax_calls[-1]["last_h"][s], port_calls[-1]["last_h"][s], cfg)
        assert drift <= LAST_H_DRIFT, f"stream {s}: last_h drift {drift}"


def run_port(form, frames, carry, t0=0, keep_at=None):
    """The port's form ("batched", "scan" or a slot count) from ``carry``
    over frames ``t0..``: the record of every call (the scan's: outputs,
    and the carry after its last frame), the final carry, and a copy of the
    carry before frame ``keep_at``."""
    cfg = config_from_fields(dynamic_config())
    if form == "scan":
        carry, (outs, valid) = make_batched_scan_fn(cfg)(carry, torch.from_numpy(frames[t0:]))
        assert bool(valid.all()) and outs.shape[:2] == (len(frames) - t0, SHARDED_STREAMS)
        calls = [{"out": o.numpy()} for o in outs]
        calls[-1] = record(carry_numpy(carry), outs[-1].numpy())
        return calls, carry, None
    if form == "batched":
        step = make_batched_step_fn(cfg)
    else:
        mesh = make_stream_mesh(["cpu"] * form)
        step = make_sharded_step_fn(cfg, mesh)
        carry = shard_carry(carry, mesh)
    calls, kept = [], None
    for t in range(t0, len(frames)):
        if t == keep_at:
            kept = map_carry(torch.clone, unshard(carry))
        carry, (out, valid) = step(carry, torch.from_numpy(frames[t]))
        assert bool(unshard(valid).all())
        if form != "batched":
            assert isinstance(carry, Sharded) and len(carry.parts) == form
            assert all(p.frames.device == torch.device("cpu") for p in carry.parts)
        calls.append(record(carry_numpy(unshard(carry)), unshard(out).numpy()))
    return calls, unshard(carry), kept


@pytest.fixture(scope="module")
def port_batched(frames):
    """The port's one-slot batched step over the six frames in ``MODES``."""
    return run_port("batched", frames, mixed_carry(), keep_at=SWITCH_AT)


@pytest.mark.parametrize("form", ["batched", "scan"] + SLOTS)
def test_mixed_modes_match_jax(frames, jax_run, port_batched, form):
    """Streams in all six modes through the port's batched step (one
    slot, from the first frame), and from its carry before frame
    ``SWITCH_AT`` through its scan (one mode read for the frames) and its
    sharded step on 2, 4 and 8 "cpu" slots, against JAX's dynamic-mode
    sharded step; each form equals the one-slot step bit for bit."""
    if form == "batched":
        t0, (calls, carry, _) = 0, port_batched
    else:
        t0 = SWITCH_AT
        calls, carry, _ = run_port(form, frames, map_carry(torch.clone, port_batched[2]), t0)
    check_against_jax(calls, jax_run[0][t0:], MODES)
    assert carry.mode.tolist() == MODES
    assert carries_equal(carry, port_batched[1])
    for a, b in zip(calls, port_batched[0][t0:]):
        np.testing.assert_array_equal(a["out"], b["out"])


def test_mode_switch_between_calls_matches_jax(frames, jax_run, port_batched):
    """Stream 0's ``carry.mode`` set to SIFT_FULL_LOCK after four frames:
    the next calls read it and run its registration lock from there, as
    JAX's step does from the same carry."""
    carry = map_carry(torch.clone, port_batched[2])
    carry.mode[SWITCHED] = SWITCH_TO
    calls, carry, _ = run_port("batched", frames, carry, t0=SWITCH_AT)
    modes = list(MODES)
    modes[SWITCHED] = SWITCH_TO
    check_against_jax(calls, jax_run[1], modes)
    assert bool(carry.sift_ref.is_set[SWITCHED]) and not bool(carry.accum_active[SWITCHED])


def test_each_stream_is_its_own_modes_run(frames, port_batched):
    """Bit for bit, every stream of the mixed batch equals the body run in
    that stream's mode (one run per mode, with the mixed call's warp
    arguments, on a copy of the mixed start carry's streams in that mode:
    on the CPU a sub-batch rounds as the whole batch does): outputs and
    lock state, frame by frame over the first ``SWITCH_AT`` frames."""
    cfg = config_from_fields(dynamic_config())
    start = mixed_carry()
    runs = {}
    for m in sorted(set(MODES)):
        idx = np.array([s for s, ms in enumerate(MODES) if ms == m])
        runs[m] = (idx, map_carry(lambda x: x[torch.from_numpy(idx)].clone(), start))
    for t in range(SWITCH_AT):
        mixed = port_batched[0][t]
        for m, (idx, carry) in runs.items():
            carry, (out, _) = offline_batched_chunk_step(
                carry, torch.from_numpy(frames[t, idx])[:, None], cfg, form="batched_mixed",
                modes=[m] * len(idx))
            runs[m] = (idx, carry)
            where = f"frame {t} mode {m}"
            np.testing.assert_array_equal(out[:, 0].numpy(), mixed["out"][idx], err_msg=where)
            for name in ("last_h", "accum_h", "accum_active", "lock_prev_h"):
                np.testing.assert_array_equal(getattr(carry, name).numpy(), mixed[name][idx],
                                              err_msg=f"{where}: {name}")
            np.testing.assert_array_equal(carry.last_lock_matches.numpy(),
                                          mixed["matches"][idx], err_msg=where)


@pytest.mark.parametrize("mode", [m for m in M if m != M.SIFT_FULL_LOCK])
def test_uniform_batch_equals_static_step(frames, mode):
    """A batch whose streams are all in one mode, with no static mode,
    equals the static-mode batched step bit for bit (outputs and carry)
    while no warp leaves the envelope: the two differ only in the output
    warp's projective fallback, which the bounded modes drop when pinned.
    (SIFT_FULL_LOCK takes ~3.6 s per stream and frame at this size on one
    CPU thread; its registration path is the ORB case's, and
    :func:`test_each_stream_is_its_own_modes_run` holds it bit for bit.)"""
    dyn = make_batched_step_fn(config_from_fields(dynamic_config()))
    pinned = make_batched_step_fn(config_from_fields(
        dataclasses.replace(tiny_config(), static_mode=int(mode))))
    a = port_carry(tiny_config(), 2, mode, SEED)
    b = port_carry(tiny_config(), 2, mode, SEED)
    for t in range(3):
        f = torch.from_numpy(frames[t, :2])
        a, (out_a, _) = dyn(a, f)
        b, (out_b, _) = pinned(b, f)
        assert torch.equal(out_a, out_b), f"frame {t}"
    assert b.envelope_violations.tolist() == [0, 0]
    assert carries_equal(a, b)


@pytest.mark.parametrize("n", [2, 8])
def test_dryrun_multichip_counterpart(n):
    """``__graft_entry__.dryrun_multichip`` on the port: its tiny config
    with no static mode, one stream per slot on ``n`` "cpu" slots, two
    sharded steps of zero frames; the outputs keep the frames' shape, the
    carry stays on its slots, every stream counts two frames."""
    from __graft_entry__ import _tiny_config

    cfg = config_from_fields(_tiny_config())
    assert cfg.static_mode is None
    mesh = make_stream_mesh(["cpu"] * n)
    carry = shard_carry(port_carry(_tiny_config(), n, M.GLOBAL_SMOOTHING, 0), mesh)
    step = make_sharded_step_fn(cfg, mesh)
    frames = torch.zeros((n, cfg.frame_height, cfg.frame_width, 3), dtype=torch.uint8)
    for _ in range(2):
        carry, (outputs, valid) = step(carry, frames)
        assert isinstance(carry, Sharded) and len(carry.parts) == n
        assert all(p.frames.device == d for p, d in zip(carry.parts, mesh))
        assert unshard(outputs).shape == frames.shape and bool(unshard(valid).all())
    assert unshard(carry).n.tolist() == [2] * n
