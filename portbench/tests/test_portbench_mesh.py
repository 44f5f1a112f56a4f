"""The four-card cell ``cfg5x4.chunk`` on the CPU over ``["cpu"] * 4``: the
per-card reducer of a traced slice, the per-slot reference against the
program's sharded chunk, the cell's readers with and without the
program's mesh counters, and faults of single slots that come out not
correct."""

import pytest
import torch

from portbench import harness, mesh_trace
from portbench.tests.conftest import cpu_context
from portbench.tests.test_portbench_imports import loaded_after
from video_stabilization_tpu_torch import parallel
from video_stabilization_tpu_torch.parallel import streams as port_streams

CELL = "cfg5x4.chunk"


def outcome_with(layer):
    return harness.Outcome(frames=1, window_s=1.0, setup_s=1.0, attempted=1, failed=0,
                           checks={}, memory_peak_bytes=0, layer=layer)


def read(name, layer):
    return harness.load_metric(name).read(outcome_with(layer), harness.find_cell(CELL))


def test_card_idle_shares_of_a_busy_and_an_idle_card():
    """Card 0 busy over the whole slice (overlapping intervals, one begun
    before it and one ended after it), card 2 busy 1 of 10 units, card 1
    with no operation: each card's own share, and the metric their mean."""
    intervals = [(0, -5.0, 4.0), (0, 3.0, 8.0), (0, 7.5, 12.0), (2, 2.0, 3.0),
                 (2, 11.0, 20.0), (3, 0.0, 10.0)]
    shares = mesh_trace.card_idle_shares(intervals, [0, 1, 2], 0.0, 10.0)
    assert shares == pytest.approx({0: 0.0, 1: 1.0, 2: 0.9})
    assert read("mesh.card_idle_share", {"card_idle": shares}) == pytest.approx(1.9 / 3)


def test_enqueue_reader():
    dispatch = {"calls": 4, "dispatch_s": 0.02, "enqueue_s": [0.004] * 4}
    assert read("mesh.enqueue_ms", {"mesh_dispatch": dispatch}) == pytest.approx(5.0)


@pytest.mark.parametrize("name", ["mesh.enqueue_ms", "mesh.card_idle_share"])
def test_readers_find_nothing_without_the_programs_record(name):
    """A program without the counters, a run on the CPU (no card traced),
    an untraced run or no calls: nothing to read, and no error."""
    for layer in ({}, {"mesh_dispatch": None, "card_idle": {}},
                  {"mesh_dispatch": {"calls": 0, "dispatch_s": 0.0, "enqueue_s": []}}):
        assert read(name, layer) is None


def test_the_cell_loads_no_jax_and_the_reference_nothing_of_the_program():
    names = loaded_after(["portbench.drivers.mesh_chunk", "portbench.mesh_trace"])
    assert not names & set(harness.FORBIDDEN_MODULES)
    names = loaded_after(["portbench.reference.slots"])
    assert not names & (set(harness.FORBIDDEN_MODULES) | {"video_stabilization_tpu_torch"})


def test_the_slot_reference_equals_the_sharded_chunk():
    """The program's sharded chunk over four "cpu" slots, 32 streams from
    step 0, against the reference of each slot's 8 streams as one batch
    with the slot's key rows, started fresh 2 chunks before the steps
    compared (the window is 10): equal bit for bit."""
    from video_stabilization_tpu_torch import config as port_config
    from video_stabilization_tpu_torch.utils import prng

    ctx = cpu_context(harness.find_cell(CELL))
    driver = harness.load_driver("mesh_chunk")
    mesh = driver.mesh_of(ctx)
    assert len(mesh) == 4
    foot = driver.footage(ctx, mesh)
    k, n_calls, first = 4, 5, 12
    cfg = harness.stabilizer_config(ctx, port_config, static=True)
    carry = parallel.init_sharded_carry(cfg, 32, int(cfg.static_mode),
                                        prng.key(harness.key_seed(ctx.seed)), mesh)
    fn = parallel.make_sharded_offline_fn(cfg, mesh)
    n = foot[0].shape[1]
    outs = []
    for c in range(n_calls):
        idx = torch.tensor([driver.pingpong(j, n) for j in range(c * k, (c + 1) * k)])
        carry, (out, valid) = fn(carry, parallel.Sharded(tuple(p.index_select(1, idx)
                                                               for p in foot)))
        assert bool(parallel.unshard(valid).all())
        outs.append(parallel.unshard(out))
    got = torch.cat(outs, 1)[:, first:]
    want = driver.reference_outputs(ctx, foot, first, n_calls * k - first)
    assert want.shape == got.shape == (32, 8, 120, 160, 3)
    assert torch.equal(got, want)


def run_cell(**kw):
    cell = harness.find_cell(CELL)
    outcome = harness.load_driver(cell.params["driver"]).run(cpu_context(cell, **kw))
    return outcome, harness.result_line(cell, outcome, kw.get("trace", False),
                                        {"platform": "cpu"})


def test_traced_run_reads_the_counters():
    """A traced run reads ``mesh.enqueue_ms`` from the program's counters
    over the window: at least the sum of the slots' enqueues.  No card, so
    no card idle share."""
    outcome, line = run_cell(trace=True)
    assert line["correct"] is True, line["checks"]
    assert "mesh.card_idle_share" not in line["metrics"]
    dispatch = outcome.layer["mesh_dispatch"]
    assert dispatch["calls"] == outcome.frames // (32 * 4) and len(dispatch["enqueue_s"]) == 4
    assert line["metrics"]["mesh.enqueue_ms"]["value"] >= \
        1e3 * sum(dispatch["enqueue_s"]) / dispatch["calls"] > 0


def test_a_program_without_the_counters_runs_correct(monkeypatch):
    """On a program without ``parallel.streams.mesh_counters`` (an older
    port) the run stays correct and has nothing for ``mesh.enqueue_ms``."""
    monkeypatch.delattr(port_streams, "reset_mesh_counters")
    outcome, line = run_cell()
    assert line["correct"] is True, line["checks"]
    assert outcome.layer["mesh_dispatch"] is None
    assert harness.load_metric("mesh.enqueue_ms").read(outcome, harness.find_cell(CELL)) is None


def _broken(fault):
    make = parallel.make_sharded_offline_fn

    def make_broken(config, mesh):
        fn = make(config, mesh)

        def call(carry, frames):
            new, (out, valid) = fn(carry, frames)
            outs = list(out.parts)
            if fault == "slot_state_unchanged":
                new = parallel.Sharded(new.parts[:1] + carry.parts[1:2] + new.parts[2:])
            elif fault == "slot_answer_altered":
                outs[2] = outs[2].clone()
                outs[2][..., :8, :8, :] = 255 - outs[2][..., :8, :8, :]
            elif fault == "slots_swapped":
                outs[0], outs[1] = outs[1], outs[0]
            return new, (parallel.Sharded(tuple(outs)), valid)
        return call
    return make_broken


@pytest.mark.parametrize("fault", ["slot_state_unchanged", "slot_answer_altered",
                                   "slots_swapped"])
def test_a_broken_slot_comes_out_not_correct(fault, monkeypatch):
    monkeypatch.setattr(parallel, "make_sharded_offline_fn", _broken(fault))
    outcome, line = run_cell()
    assert line["correct"] is False
    assert outcome.checks["out_bytes_off"]["value"] > outcome.checks["out_bytes_off"]["limit"]
