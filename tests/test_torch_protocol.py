"""The port's schedules against the JAX package's.

Every builder (``constant``, ``linear``, ``piecewise``, ``quench``,
``field_cooling``, ``temperature_ladder``) gives the same float32 knots in
both packages, and the port's host rows are bitwise the reference engine's
``_host_sched_rows`` over a grid of times that crosses every knot, the
clamped ends and a quench's discontinuity - the values each step of a
schedule-driven run sees.  Also ``pad_schedule`` (bitwise-neutral),
``stack_schedules`` / ``SlotSchedules`` on per-slot clocks, and the knot
checks.
"""
import numpy as np
import pytest

from repro.ensemble import protocol as jp
from repro.md.engine import _host_sched_rows
from repro_torch.ensemble import protocol as tp
from torch_one_thread import one_torch_thread  # noqa: F401

BUILDERS = {
    "constant_T": lambda p: p.constant(300.0),
    "constant_B": lambda p: p.constant([0.0, 0.1, 0.2]),
    "linear": lambda p: p.linear(0.01, 0.05, 400.0, 80.0),
    "linear_B": lambda p: p.linear(0.0, 0.03, [0.0, 0.0, 0.0],
                                   [0.1, -0.2, 0.7]),
    "piecewise": lambda p: p.piecewise([0.0, 0.013, 0.031, 0.07],
                                       [300.0, 291.7, 120.3, 10.0]),
    "quench": lambda p: p.quench(0.021, 350.0, 12.5),
    "cooling_T": lambda p: p.field_cooling(300.0, 100.0, 0.2, t_hold=0.02,
                                           t_ramp=0.04)[0],
    "cooling_B": lambda p: p.field_cooling(300.0, 100.0, 0.2, t_hold=0.02,
                                           t_ramp=0.04)[1],
    "cooling_Bvec": lambda p: p.field_cooling(
        250.0, 5.0, [0.05, 0.0, 0.3], t_hold=0.011, t_ramp=0.037,
        t_final=0.02)[1],
    "cooling_final": lambda p: p.field_cooling(
        250.0, 5.0, 0.3, t_hold=0.011, t_ramp=0.037, t_final=0.02)[0],
}
# step times of a run at dt = 1 fs, the way the engine forms them
# (float32 step * dt + float32 arange * dt), past every knot
DT = np.float32(1e-3)
TIMES = np.float32(3) * DT + np.arange(150, dtype=np.float32) * DT


@pytest.mark.parametrize("name", sorted(BUILDERS))
def test_knots_and_rows_bitwise(name):
    ref, port = BUILDERS[name](jp), BUILDERS[name](tp)
    for a, b in ((ref.times, port.times), (ref.values, port.values)):
        a = np.asarray(a)
        assert b.dtype == np.float32 and a.shape == b.shape
        np.testing.assert_array_equal(a, b)
    want = _host_sched_rows(ref, TIMES)
    got = tp.host_rows(port, TIMES)
    assert got.dtype == want.dtype == np.float32
    np.testing.assert_array_equal(got, want)
    # Schedule.at is the same host evaluation, scalars included
    np.testing.assert_array_equal(port.at(TIMES), want)
    np.testing.assert_array_equal(port.at(TIMES[17]), want[17])


def test_quench_is_a_step():
    q = tp.quench(0.021, 350.0, 12.5)
    t = np.asarray([0.0, 0.0209, 0.021, 0.0211, 5.0], np.float32)
    np.testing.assert_array_equal(q.at(t), [350.0, 350.0, 12.5, 12.5, 12.5])


def test_temperature_ladder_matches():
    for args in ((50.0, 400.0, 6), (80.0, 80.0, 1), (10.0, 20.0, 2)):
        want = np.asarray(jp.temperature_ladder(*args))
        got = tp.temperature_ladder(*args)
        assert got.dtype == np.float32
        np.testing.assert_array_equal(got, want)


def test_pad_schedule_is_bitwise_neutral():
    s = tp.piecewise([0.0, 0.013, 0.031], [300.0, 291.7, 120.3])
    p = tp.pad_schedule(s, 7)
    assert p.times.shape == (7,) and p.values.shape == (7,)
    np.testing.assert_array_equal(tp.host_rows(p, TIMES),
                                  tp.host_rows(s, TIMES))
    ref = jp.pad_schedule(jp.piecewise([0.0, 0.013, 0.031],
                                       [300.0, 291.7, 120.3]), 7)
    np.testing.assert_array_equal(np.asarray(ref.times), p.times)
    assert tp.pad_schedule(s, 3) is s
    with pytest.raises(ValueError, match="knots"):
        tp.pad_schedule(s, 2)


@pytest.mark.parametrize("vec", [False, True])
def test_stack_schedules_per_slot_clocks(vec):
    if vec:
        mk = [lambda p: p.constant([0.0, 0.0, 0.5]),
              lambda p: p.piecewise([0.0, 0.02, 0.03], [[0.0, 0.0, 0.0],
                                                        [0.0, 0.3, 0.1],
                                                        [0.2, 0.3, 0.1]]),
              lambda p: p.field_cooling(1.0, 1.0, 0.2, t_hold=0.01,
                                        t_ramp=0.01)[1]]
    else:
        mk = [lambda p: p.constant(300.0),
              lambda p: p.quench(0.011, 200.0, 20.0),
              lambda p: p.field_cooling(300.0, 100.0, 0.2, t_hold=0.01,
                                        t_ramp=0.03)[0]]
    port = tp.stack_schedules([f(tp) for f in mk])
    ref = jp.stack_schedules([f(jp) for f in mk])
    np.testing.assert_array_equal(np.asarray(ref.times), port.times)
    np.testing.assert_array_equal(np.asarray(ref.values), port.values)
    assert port.times.shape == (3, max(len(f(tp).times) for f in mk))
    # each slot on its own clock: (n, R) times
    clocks = TIMES[:, None] + np.asarray([0.0, 0.007, 0.019], np.float32)
    want = _host_sched_rows(ref, clocks)
    np.testing.assert_array_equal(tp.host_rows(port, clocks), want)
    # SlotSchedules.at: one clock, or one per slot
    for r, f in enumerate(mk):
        np.testing.assert_array_equal(port.at(TIMES[40])[r],
                                      f(tp).at(TIMES[40]))
    np.testing.assert_array_equal(port.at(clocks[40]), want[40])


def test_knot_checks():
    with pytest.raises(ValueError, match="non-decreasing"):
        tp.piecewise([0.0, 0.2, 0.1], [1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match=">= 2 knots"):
        tp.piecewise([0.0], [1.0])
    with pytest.raises(ValueError, match="mismatch"):
        tp.piecewise([0.0, 1.0], [1.0, 2.0, 3.0])
    with pytest.raises(ValueError, match="at least one"):
        tp.stack_schedules([])
    assert tp.field_cooling(1.0, 1.0, 0.2, t_hold=0.1,
                            t_ramp=0.2)[0].t_end == pytest.approx(0.300001)
