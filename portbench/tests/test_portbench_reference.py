"""The frozen copies held to the program at a small size on the CPU, where
the program runs its plain versions: the footage generator, the Y4M
encoding and decoding, and the reference pipeline (streaming step and
stream-batched chunk, from step 0 and from a later step)."""

import dataclasses

import numpy as np
import pytest
import torch

from portbench import reference
from portbench.reference import config as rc
from portbench.reference import image as ref_image
from portbench.reference.y4m import encode_y4m_planes
from portbench.traffic import footage, sim
from video_stabilization_tpu_torch import config as pc
from video_stabilization_tpu_torch import sim as port_sim
from video_stabilization_tpu_torch.engine import Stabilizer
from video_stabilization_tpu_torch.io.video import encode_y4m_planes as port_encode
from video_stabilization_tpu_torch.ops.image import yuv_flat_to_bgr
from video_stabilization_tpu_torch.parallel import init_sharded_carry, make_sharded_offline_fn
from video_stabilization_tpu_torch.utils import prng

KW = dict(frame_height=120, frame_width=160, working_height=96, past_frames=6, future_frames=3)
TRAFFIC = dict(footage_frames=8, texture_size=512, trajectory_seed_offset=5,
               pos_amplitude=0.004, roll_amplitude=0.3, smoothness=0.8)
SEED = 2**31 + 99


@pytest.fixture(scope="module")
def foot():
    return footage.render_streams(TRAFFIC, 120, 160, 2, SEED, "cpu")


def test_footage_equals_the_programs_simulator(foot):
    tex = port_sim.make_default_texture(np.random.default_rng(SEED), 512)
    assert np.array_equal(tex, sim.make_default_texture(np.random.default_rng(SEED), 512))
    rng = np.random.default_rng(5 + SEED + 1)
    traj = port_sim.shake_trajectory(rng.standard_normal((8, 3)), rng.standard_normal(8),
                                     port_sim.DEFAULT_APP_PARAMS, pos_amplitude=0.004,
                                     roll_amplitude=0.3)
    want = torch.stack([port_sim.render_frame(torch.from_numpy(tex), traj[i], 120, 160)
                        for i in range(8)])
    assert torch.equal(foot[1], want)


def test_pingpong_replays_without_a_jump():
    seq = footage.pingpong_indices(0, 12, 4)
    assert seq == [0, 1, 2, 3, 2, 1, 0, 1, 2, 3, 2, 1]
    assert all(abs(a - b) == 1 for a, b in zip(seq, seq[1:]))


def test_y4m_round_trip_equals_the_programs(foot):
    frame = foot[0, 3].numpy()
    assert encode_y4m_planes(frame, True) == port_encode(frame, True)
    planes = footage.encode_c420(foot[0])
    assert torch.equal(ref_image.yuv_flat_to_bgr(planes, 120, 160, True),
                       yuv_flat_to_bgr(planes, 120, 160, True))


def test_streaming_reference_equals_the_program_from_any_start(foot):
    cfg = pc.StabilizerConfig(**KW, gftt=pc.GFTTConfig(max_features=130))
    rcfg = rc.StabilizerConfig(**KW, gftt=rc.GFTTConfig(max_features=130))
    stab = Stabilizer(cfg, pc.StabilizationMode.GLOBAL_SMOOTHING, seed=7, device="cpu")
    prog = torch.stack([stab.stabilize_frame(foot[0, footage.pingpong(j, 8)].numpy())
                        for j in range(24)])

    def frame_at(j):
        return foot[0, footage.pingpong(j, 8)]

    for first in (0, 14):   # 14 > the window (10): the reference starts at step 5
        ref = reference.streaming_outputs(rcfg, 0, frame_at, reference.prng.key(7), first, 24,
                                          "cpu")
        assert torch.equal(prog[first:], ref)


def test_chunk_reference_equals_the_program_from_any_start(foot):
    cfg = pc.StabilizerConfig(**KW, gftt=pc.GFTTConfig(max_features=130), static_mode=0)
    rcfg = rc.StabilizerConfig(**KW, gftt=rc.GFTTConfig(max_features=130))
    carry = init_sharded_carry(cfg, 2, 0, prng.key(9), ["cpu"])
    fn = make_sharded_offline_fn(cfg, ["cpu"])
    outs = []
    for c in range(0, 28, 4):
        carry, (out, _) = fn(carry, foot[:, footage.pingpong_indices(c, 4, 8)])
        outs.append(out)
    prog = torch.cat(outs, 1)

    def frames_at(steps):
        return foot[:, [footage.pingpong(j, 8) for j in steps]]

    for first in (2, 21):   # from step 0, and from step 12
        ref = reference.chunk_outputs(rcfg, 0, frames_at, reference.prng.key(9), 2, 4,
                                      first, 28, "cpu")
        assert torch.equal(prog[:, first:], ref)


def test_start_steps():
    assert reference.start_step(10, 106) == 0
    assert reference.start_step(500, 106) == 395
    assert reference.start_step(500, 106, 8) == 392


def test_bytes_off_and_the_refused_configs():
    a = torch.zeros((2, 4, 4, 3), dtype=torch.uint8)
    b = a.clone()
    b[1, 0, 0, 0] = 1
    b[1, 0, 1, 0] = 2
    assert reference.bytes_off(a, b, 3) == 2 / 48
    assert reference.bytes_off(a.flatten(1), b.flatten(1), 1) == 2 / 48
    rcfg = rc.StabilizerConfig(**KW)
    with pytest.raises(ValueError):
        reference.streaming_outputs(rcfg, 1, None, None, 0, 1, "cpu")
    with pytest.raises(ValueError):
        reference.streaming_outputs(
            dataclasses.replace(rcfg, ransac=rc.RansacConfig(motion_model="affine")), 0, None,
            None, 0, 1, "cpu")
