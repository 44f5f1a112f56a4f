"""The port's copy of the configuration against the JAX package's: the same
classes, fields and defaults, and ``config_from_fields`` carrying a
configuration across."""

import dataclasses

import pytest

import video_stabilization_tpu.config as jcfg
import video_stabilization_tpu_torch.config as tcfg
from test_engine import small_config
from torch_threads import one_torch_thread  # noqa: F401

CLASSES = ["GFTTConfig", "LKConfig", "RansacConfig", "ORBConfig", "SIFTConfig",
           "ECCConfig", "PreprocessConfig", "StabilizerConfig"]


@pytest.mark.parametrize("name", CLASSES)
def test_defaults_match_jax(name):
    jcls, tcls = getattr(jcfg, name), getattr(tcfg, name)
    jf = [(f.name, f.default) for f in dataclasses.fields(jcls)]
    tf = [(f.name, f.default) for f in dataclasses.fields(tcls)]
    assert [n for n, _ in tf] == [n for n, _ in jf]
    for (n, jd), (_, td) in zip(jf, tf):
        if dataclasses.is_dataclass(jd):
            assert dataclasses.asdict(td) == dataclasses.asdict(jd), n
        else:
            assert td == jd and type(td) is type(jd), n


def test_modes_match_jax():
    assert ({m.name: m.value for m in tcfg.StabilizationMode}
            == {m.name: m.value for m in jcfg.StabilizationMode})


def test_input_modes_match_jax():
    assert ({m.name: m.value for m in tcfg.InputMode}
            == {m.name: m.value for m in jcfg.InputMode})


def test_default_config_matches_jax():
    assert tcfg.DEFAULT_CONFIG == tcfg.StabilizerConfig()
    assert dataclasses.asdict(tcfg.DEFAULT_CONFIG) == dataclasses.asdict(jcfg.DEFAULT_CONFIG)


def test_arc_len_matches_jax():
    from video_stabilization_tpu.ops.fast import ARC_LEN as J_ARC_LEN
    from video_stabilization_tpu_torch.ops.fast import ARC_LEN

    assert ARC_LEN == J_ARC_LEN == 9


@pytest.mark.parametrize("make", [
    small_config,
    lambda: jcfg.StabilizerConfig(),
    lambda: dataclasses.replace(small_config(past=4, future=2),
                                static_mode=jcfg.StabilizationMode.ORB_FULL_LOCK),
])
def test_config_from_fields(make):
    jc = make()
    tc = tcfg.config_from_fields(jc)
    assert isinstance(tc, tcfg.StabilizerConfig)
    assert isinstance(tc.orb, tcfg.ORBConfig)
    assert dataclasses.asdict(tc) == dataclasses.asdict(jc)
    assert (tc.working_size, tc.total_window) == (jc.working_size, jc.total_window)
    assert tc == tcfg.config_from_fields(tc)
