"""The span readers (``harness/spans.py`` and the six metrics that read the
engine's ``repro.*`` host spans) on hand-built traces, and on the card that
the engine's ``repro.sync`` ranges hold every synchronizing call torch
reports on the flat plan's main path."""
import collections
import traceback
import warnings

import pytest
import torch

from perfbench.harness import manifest, spans
from perfbench.harness.trace import DeviceOp, Trace

MS = 1_000_000      # ns


def kernel(start_ms: float, dur_ms: float) -> DeviceOp:
    return DeviceOp("k", int(start_ms * MS), int(dur_ms * MS), "kernel",
                    frozenset())


def span(name: str, start_ms: float, end_ms: float) -> tuple:
    return (int(start_ms * MS), int(end_ms * MS), name)


def layered_trace() -> Trace:
    """A 100-ms window of two steps.  Idle gaps: 0-5 (no span), 20-24
    (skin test, inside its sync), 30-36 (integrate), 40-41 (refresh), 50-52
    (force), 60-68 (rebuild, inside a sync), 75-80 (chunk, after the
    steps), 95-100 (no span)."""
    ops = [kernel(5, 15), kernel(24, 6), kernel(36, 4), kernel(41, 9),
           kernel(52, 8), kernel(68, 7), kernel(80, 15)]
    host = [span("repro.run", 6, 94), span("repro.chunk", 7, 93),
            span("repro.step", 8, 45), span("repro.skin_test", 19, 26),
            span("repro.sync", 21, 25), span("aten::item", 21, 25),
            span("repro.integrate", 27, 44), span("aten::mul", 31, 32),
            span("repro.refresh", 39, 42), span("repro.step", 46, 74),
            span("repro.force", 47, 55), span("repro.rebuild", 56, 72),
            span("repro.sync", 62, 66), span("repro.readback", 85, 90),
            span("repro.sync", 86, 89)]
    counts = collections.Counter(n for _, _, n in host
                                 if n.startswith("repro."))
    return Trace(0, 100 * MS, ops, dict(counts), host)


def ctx(tr: Trace, steps: int = 2) -> dict:
    return {"trace": tr, "window": {"steps": steps}}


def read(metric: str, c: dict):
    return manifest.reader(metric)[0](c)


def test_a_gap_belongs_to_the_innermost_layer_span():
    idle = spans.idle_by_span(layered_trace())
    want = {spans.NO_SPAN: 10.0, "repro.skin_test": 4.0,
            "repro.integrate": 6.0, "repro.refresh": 1.0,
            "repro.force": 2.0, "repro.rebuild": 8.0, "repro.chunk": 5.0}
    assert set(idle) == set(want)
    for name, ms in want.items():
        assert idle[name] == pytest.approx(ms / 1e3)
    # aten ops and repro.sync are no layers: their gaps go to the span
    # around them
    assert "repro.sync" not in idle and "aten::item" not in idle


def test_the_six_readers_on_a_layered_trace():
    c = ctx(layered_trace())
    assert read("host_syncs_per_step", c) == pytest.approx(3 / 2)
    assert read("sync_wait_ms_per_step", c) == pytest.approx((4 + 4 + 3) / 2)
    assert read("loop_idle_ms_per_step", c) == pytest.approx((4 + 5) / 2)
    assert read("rebuild_idle_ms_per_step", c) == pytest.approx(8 / 2)
    assert read("integrate_idle_ms_per_step", c) == pytest.approx(7 / 2)
    assert read("force_idle_ms_per_step", c) == pytest.approx(2 / 2)
    # the four layers and the gaps under no span make up all the idle
    tr = layered_trace()
    layers = sum(read(m, c) for m in (
        "loop_idle_ms_per_step", "rebuild_idle_ms_per_step",
        "integrate_idle_ms_per_step", "force_idle_ms_per_step"))
    total = 1e3 * (tr.window_s - tr.busy_s()) / 2
    assert layers + 1e3 * spans.idle_by_span(tr)[spans.NO_SPAN] / 2 == \
        pytest.approx(total)


def test_nested_spans_of_one_start_resolve_to_the_inner():
    ops = [kernel(0, 10), kernel(20, 10)]
    host = [span("repro.step", 10, 20), span("repro.integrate", 10, 19)]
    tr = Trace(0, 30 * MS, ops, {"repro.step": 1, "repro.integrate": 1},
               host)
    assert spans.idle_by_span(tr) == {"repro.integrate": pytest.approx(0.01)}


@pytest.mark.parametrize("metric", [
    "host_syncs_per_step", "sync_wait_ms_per_step", "loop_idle_ms_per_step",
    "rebuild_idle_ms_per_step", "integrate_idle_ms_per_step",
    "force_idle_ms_per_step"])
def test_nothing_to_read_gives_none(metric):
    tr = layered_trace()
    assert read(metric, {"trace": None, "window": {"steps": 2}}) is None
    # no kernels: a run on the CPU
    no_kernels = Trace(tr.window_start, tr.window_end, [], tr.range_counts,
                       tr.host)
    assert read(metric, ctx(no_kernels)) is None
    # kernels, and no step spans: a program that opens none
    old = [h for h in tr.host if h[2] in ("repro.integrate", "repro.force",
                                          "repro.rebuild", "aten::mul")]
    counts = collections.Counter(n for _, _, n in old)
    assert read(metric, ctx(Trace(tr.window_start, tr.window_end, tr.ops,
                                  dict(counts), old))) is None


# --- on the card ------------------------------------------------------------

CARD_CELLS = (16, 16, 16)
CARD_SEED = 2_900_000_017


def _flat_engine(cells, seed: int, device):
    """The benchmark's flat engine (``fege-prod-262k``'s configuration and
    mix) on a box of ``cells`` unit cells."""
    from perfbench.harness import inputs, program
    cell = manifest.cell("fege-prod-262k")
    config, traffic = cell["config"], cell["traffic"]
    model, plan = manifest.model(config), manifest.plan(traffic["plan"])
    if device.type == "cuda":
        from repro_torch import _build
        _build.build(list(model.KERNELS))
    w = model.weights(config, seed, device)
    inp = inputs.state(config, traffic, cells, seed, device)
    return program.build(config, model, plan, w, inp, seed, 0, device)


def _where(stack) -> str:
    """The innermost frames of the port and the harness in a stack."""
    own = [f for f in stack if "repro_torch" in f.filename
           or "perfbench" in f.filename]
    return " <- ".join(f"{f.filename.rsplit('/', 1)[-1]}:{f.lineno} {f.name}"
                       for f in reversed(own[-4:]))


def syncs_seen(eng, gen, steps: int, chunk: int) -> list:
    """Run the engine with torch reporting every synchronizing CUDA call:
    for each, ``(the repro.sync range it ran in or None, where)``."""
    from repro_torch.telemetry.profiling import HOST_SYNCS
    seen, running = [], [False]

    def hook(message, category, filename, lineno, file=None, line=None):
        if running[0] and "synchronizing" in str(message):
            seen.append((HOST_SYNCS.count if HOST_SYNCS.open else None,
                         _where(traceback.extract_stack()[:-1])))

    with warnings.catch_warnings():
        warnings.simplefilter("always")
        warnings.showwarning = hook
        torch.cuda.set_sync_debug_mode("warn")
        running[0] = True
        try:
            eng.run(steps, gen, chunk=chunk)
        finally:
            running[0] = False
            torch.cuda.set_sync_debug_mode("default")
    return seen


@pytest.mark.card
def test_every_sync_on_the_card_is_a_counted_span():
    """On a 16^3 B20 box (32,768 atoms) over chunks with rebuilds, torch's
    synchronizing calls are the engine's ``repro.sync`` ranges one for one:
    none outside a range, one in each, as many as the counter's delta."""
    if not torch.cuda.is_available():
        pytest.skip("no CUDA card here")
    from repro_torch.telemetry import HostSyncCounter
    dev = torch.device("cuda", 0)
    eng, gen = _flat_engine(CARD_CELLS, CARD_SEED, dev)
    eng.run(20, gen, chunk=20)                       # warm every shape
    torch.cuda.synchronize()
    counter = HostSyncCounter()
    mark, r0 = counter.mark(), eng.n_rebuilds
    seen = syncs_seen(eng, gen, 200, 20)
    counted = counter.since(mark)
    outside = collections.Counter(w for scope, w in seen if scope is None)
    print(f"{len(seen)} synchronizing calls, {counted} repro.sync ranges, "
          f"{eng.n_rebuilds - r0} rebuilds over 200 steps")
    assert eng.n_rebuilds > r0
    assert not outside, "synchronizing calls outside repro.sync:\n" + \
        "\n".join(f"{n} x {w}" for w, n in outside.most_common())
    assert sorted(scope for scope, _ in seen) == \
        list(range(mark + 1, mark + counted + 1))
