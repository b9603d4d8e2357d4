"""The port's ``paddle.profiler`` (``paddle_tpu_torch/profiler``) against the
JAX package's: a port of tests/test_profiler.py (scheduler states and
validation, RecordEvent outside a profiler, the chrome export handler, the
summary with its self column, the load round trip with a merged trace's
``DeviceOp`` and unknown categories (:271-296), the timer and ``step_info``,
the tuple scheduler), the same schedules and summaries from both packages,
and the port's own device and dispatch sides: a 2-layer port LLaMA training
step under the ``Profiler`` whose trace holds the dispatch's ``op::`` spans,
torch.profiler's events put on the host clock (driven here with CPU events,
as the card's CUDA events are in ``chip_smoke.py`` phase 18), and
``ProfilerTarget.GPU`` raising without a card.
"""
import io
import json
import os
import time
from contextlib import redirect_stdout

import numpy as np
import pytest
import torch

import paddle_tpu.profiler as jprof
import paddle_tpu_torch as T
import paddle_tpu_torch.profiler as profiler
from paddle_tpu_torch.device import _CURRENT
from paddle_tpu_torch.ops import _apply
from paddle_tpu_torch.profiler import (
    Profiler, ProfilerState, ProfilerTarget, RecordEvent, SortedKeys, benchmark,
    export_chrome_tracing, make_scheduler)
from paddle_tpu_torch.profiler.profiler import (
    HostEvent, ProfilerResult, TracerEventType, collect_device_events)

CPU = [ProfilerTarget.CPU]


@pytest.fixture(autouse=True)
def _on_cpu():
    before = _CURRENT[0]
    T.set_device("cpu")
    yield
    _CURRENT[0] = before
    assert _apply._PROFILER[0] is None  # every window closed


def test_public_names_match_jax():
    assert profiler.__all__ == jprof.__all__
    for name in profiler.__all__:
        assert hasattr(profiler, name)
    assert [s.name for s in ProfilerState] == [s.name for s in jprof.ProfilerState]
    assert [s.name for s in ProfilerTarget] == [s.name for s in jprof.ProfilerTarget]
    assert [s.name for s in SortedKeys] == [s.name for s in jprof.SortedKeys]
    assert [s.name for s in TracerEventType] == [
        s.name for s in jprof.profiler.TracerEventType]


def test_make_scheduler_states():
    sch = make_scheduler(closed=1, ready=1, record=2, repeat=1, skip_first=1)
    assert [sch(i) for i in range(7)] == [
        ProfilerState.CLOSED,            # skip_first
        ProfilerState.CLOSED,            # closed
        ProfilerState.READY,             # ready
        ProfilerState.RECORD,            # record
        ProfilerState.RECORD_AND_RETURN,  # last record step
        ProfilerState.CLOSED,            # repeat exhausted
        ProfilerState.CLOSED,
    ]


@pytest.mark.parametrize("kw", [
    dict(closed=0, ready=0, record=1), dict(closed=2, ready=1, record=3, repeat=2),
    dict(closed=1, ready=2, record=1, repeat=0, skip_first=3)])
def test_schedules_match_jax(kw):
    mine, ref = make_scheduler(**kw), jprof.make_scheduler(**kw)
    assert [mine(i).name for i in range(24)] == [ref(i).name for i in range(24)]


@pytest.mark.parametrize("kw", [dict(closed=1, ready=0, record=0), dict(closed=-1, ready=0,
                                                                         record=1)])
def test_make_scheduler_validates(kw):
    with pytest.raises(ValueError):
        make_scheduler(**kw)
    with pytest.raises(ValueError):
        jprof.make_scheduler(**kw)


def test_tuple_scheduler():
    p = Profiler(targets=CPU, scheduler=(1, 3))
    got = [p._scheduler(i) for i in range(4)]
    assert got[1] in (ProfilerState.RECORD, ProfilerState.RECORD_AND_RETURN)
    assert got[2] == ProfilerState.RECORD_AND_RETURN
    assert got[3] == ProfilerState.CLOSED
    ref = jprof.Profiler(targets=[jprof.ProfilerTarget.CPU], scheduler=(1, 3))
    assert [s.name for s in got] == [ref._scheduler(i).name for i in range(4)]
    for bad in ((3, 3), (-1, 2)):
        with pytest.raises(ValueError):
            Profiler(targets=CPU, scheduler=bad)
    with pytest.raises(TypeError):
        Profiler(targets=CPU, scheduler=3)


def test_profiler_records_train_step_and_exports(tmp_path):
    traces = []

    def on_ready(prof):
        prof.export(str(tmp_path / f"trace_{prof.step_num}.json"))
        traces.append(prof.step_num)

    model = T.nn.Linear(8, 4, device="cpu")
    opt = T.optimizer.SGD(learning_rate=0.1, parameters=model.parameters())
    sch = make_scheduler(closed=0, ready=1, record=2, repeat=1)
    with Profiler(targets=CPU, scheduler=sch, on_trace_ready=on_ready) as p:
        for _ in range(4):
            with RecordEvent("fwd_bwd"):
                x = T.randn([2, 8])
                loss = T.mean(model(x))
                loss.backward()
            with RecordEvent("optimizer"):
                opt.step()
                opt.clear_grad()
            p.step(num_samples=2)
    assert traces == [2]  # handed off as step 2 (RECORD_AND_RETURN) ends
    doc = json.loads((tmp_path / "trace_2.json").read_text())
    names = {e["name"] for e in doc["traceEvents"] if e.get("ph") == "X"}
    assert "fwd_bwd" in names and "optimizer" in names
    assert {"ProfileStep#1", "ProfileStep#2"} <= names and "ProfileStep#0" not in names
    assert {"op::linear", "op::mean"} <= names  # the dispatch's spans


def test_record_event_outside_profiler_is_noop():
    with RecordEvent("orphan"):
        pass
    ev = RecordEvent("never")
    ev.end()  # end without begin: nothing
    assert profiler.profiler._collector.events == []


def test_record_event_as_decorator():
    @RecordEvent("decorated")
    def work():
        return 3

    with Profiler(targets=CPU) as p:
        assert work() == 3
        p.step()
    assert [e.name for e in p._last_result.events if e.name == "decorated"] == ["decorated"]


@pytest.mark.parametrize("handler,suffix", [(export_chrome_tracing, ".paddle_trace.json"),
                                            (profiler.export_protobuf,
                                             ".paddle_trace.pb.json")])
def test_export_handlers(tmp_path, handler, suffix):
    d = str(tmp_path / "logs")
    with Profiler(targets=CPU, on_trace_ready=handler(d, worker_name="w0")) as p:
        with RecordEvent("span"):
            pass
        p.step()
    files = os.listdir(d)
    assert files and all(f.startswith("w0") and f.endswith(suffix) for f in files)
    with pytest.raises(ValueError):
        p.export(str(tmp_path / "x"), format="xml")
    with pytest.raises(RuntimeError, match="no finished profile"):
        Profiler(targets=CPU).export(str(tmp_path / "y.json"))


def test_summary_prints(capsys):
    with Profiler(targets=CPU) as p:
        with RecordEvent("alpha"):
            pass
        p.step()
    p.summary(sorted_by=SortedKeys.CPUTotal)
    out = capsys.readouterr().out
    assert "alpha" in out and "Calls" in out
    assert "Device Op Summary" not in out  # no device events recorded
    Profiler(targets=CPU).summary()  # nothing recorded: prints nothing
    assert capsys.readouterr().out == ""


def test_event_tree_self_time():
    from paddle_tpu_torch.profiler.profiler_statistic import (
        _walk, build_event_tree, gather_tree_stats)

    with Profiler(targets=CPU) as p:
        with RecordEvent("outer"):
            with RecordEvent("inner"):
                time.sleep(0.02)
            time.sleep(0.005)
        p.step()
    res = p._last_result
    nodes = list(_walk(build_event_tree(res.events)))
    outer = [n for n in nodes if n.event.name == "outer"]
    assert outer and outer[0].children[0].event.name == "inner"
    stats, selfs = gather_tree_stats(res.events)
    # outer's self time is its total less inner's, whatever the host's load
    assert selfs["outer"] == stats["outer"].total_ns - stats["inner"].total_ns
    assert stats["inner"].total_ns >= 20e6 and selfs["outer"] >= 5e6
    assert selfs["inner"] == stats["inner"].total_ns


def test_summary_has_overview_and_self_column(capsys):
    with Profiler(targets=CPU) as p:
        with RecordEvent("top"):
            with RecordEvent("nested"):
                pass
        p.step()
    p.summary()
    out = capsys.readouterr().out
    assert "Overview Summary" in out
    assert "Self(" in out and "nested" in out


def _events(mod):
    """The same host spans as each package's HostEvent."""
    E = mod.profiler.HostEvent
    tt = mod.profiler.TracerEventType
    return [E("step", tt.ProfileStep, 0, 1_000_000, 1, 0),
            E("op::matmul", tt.Operator, 100_000, 400_000, 1, 0),
            E("op::add", tt.Operator, 450_000, 500_000, 1, 0),
            E("user", tt.PythonUserDefined, 600_000, 900_000, 1, 0),
            E("op::add", tt.Operator, 650_000, 700_000, 1, 0),
            E("other_thread", tt.Dataloader, 0, 2_000_000, 2, 0)]


@pytest.mark.parametrize("key", ["CPUTotal", "CPUAvg", "CPUMax", "CPUMin", "GPUTotal"])
@pytest.mark.parametrize("unit", ["ms", "us"])
def test_summary_text_equals_jax(key, unit):
    from paddle_tpu.profiler.profiler_statistic import _build_summary as jbuild
    from paddle_tpu_torch.profiler.profiler_statistic import _build_summary as tbuild

    j = jbuild(jprof.ProfilerResult(_events(jprof), (0, 1), None),
               sorted_by=jprof.SortedKeys[key], time_unit=unit)
    t = tbuild(ProfilerResult(_events(profiler), (0, 1)), sorted_by=SortedKeys[key],
               time_unit=unit)
    assert t == j
    with pytest.raises(ValueError):
        tbuild(ProfilerResult(_events(profiler), (0, 1)), time_unit="h")


def test_load_profiler_result_roundtrip(tmp_path):
    path = str(tmp_path / "t.json")
    with Profiler(targets=CPU) as p:
        with RecordEvent("roundtrip"):
            pass
        p.step()
    p.export(path)
    res = profiler.load_profiler_result(path)
    assert any(e.name == "roundtrip" for e in res.events)
    # the microsecond floats of the trace give the nanoseconds back to within
    # a rounding, as the JAX loader reads them
    saved = sorted((e.name, e.start_ns, e.end_ns) for e in p._last_result.events)
    got = sorted((e.name, e.start_ns, e.end_ns) for e in res.events)
    assert [n for n, _, _ in got] == [n for n, _, _ in saved]
    assert all(abs(a[1] - b[1]) <= 2 and abs(a[2] - b[2]) <= 2 for a, b in zip(got, saved))
    ref = jprof.load_profiler_result(path).events
    assert sorted((e.name, e.event_type.name, e.start_ns, e.end_ns, e.step) for e in ref) == \
        sorted((e.name, e.event_type.name, e.start_ns, e.end_ns, e.step) for e in res.events)


def test_load_profiler_result_skips_merged_device_events(tmp_path):
    out = str(tmp_path / "merged_roundtrip.json")
    doc = {"traceEvents": [
        {"name": "span", "cat": "PythonUserDefined", "ph": "X",
         "ts": 10.0, "dur": 5.0, "pid": 1, "tid": 1, "args": {"step": 0}},
        {"name": "fa_fwd_wgmma", "cat": "DeviceOp", "ph": "X",
         "ts": 11.0, "dur": 2.0, "pid": 900000, "tid": 1, "args": {}},
        {"name": "serving.step", "cat": "TraceSpan", "ph": "X",
         "ts": 11.0, "dur": 2.0, "pid": 1, "tid": 1, "args": {}},
        {"name": "mystery", "cat": "SomeFutureCat", "ph": "X",
         "ts": 12.0, "dur": 1.0, "pid": 1, "tid": 1, "args": {}},
        {"name": "process_name", "ph": "M", "pid": 1, "tid": 0, "args": {}},
    ]}
    with open(out, "w") as f:
        json.dump(doc, f)
    res = profiler.load_profiler_result(out)
    assert sorted(e.name for e in res.events) == ["mystery", "span"]
    mystery = [e for e in res.events if e.name == "mystery"][0]
    assert mystery.event_type is TracerEventType.UserDefined
    assert res.device_events() == [] and res.device_op_stats() == []


def test_timer_benchmark_and_step_info():
    bm = benchmark()
    bm.begin()
    for _ in range(3):
        bm.before_reader()
        bm.after_reader()
        bm.step(num_samples=4)
    info = bm.step_info("samples")
    assert "batch_cost" in info and "ips" in info and "samples/s" in info
    bm.end()
    assert bm.step_info() == ""  # averages reset by the last call
    with redirect_stdout(io.StringIO()) as buf:
        bm.summary()
    assert "Perf Summary" in buf.getvalue() and "ips" in buf.getvalue()


def test_timer_event_matches_jax():
    from paddle_tpu.profiler.timer import Event as JEvent
    from paddle_tpu_torch.profiler.timer import Event as TEvent

    j, t = JEvent(), TEvent()
    for i in range(14):
        for ev in (j, t):
            ev.record_reader(0.001 * (i + 1))
            ev.record_batch(0.01 * (i + 1), num_samples=8)
    assert t.get_summary() == j.get_summary()
    assert (t.reader_average(), t.batch_average(), t.speed_average()) == (
        j.reader_average(), j.batch_average(), j.speed_average())


def test_profiler_step_info_and_timer_only():
    with Profiler(targets=CPU) as p:
        p.step(num_samples=8)
        assert isinstance(p.step_info(), str)
    with Profiler(targets=CPU, timer_only=True) as p:
        p.step(num_samples=8)
        assert _apply._PROFILER[0] is None
    assert p.step_num == 1 and p._last_result is None


def test_get_profiler_from_config(tmp_path):
    cfg = tmp_path / "cfg.json"
    cfg.write_text(json.dumps({"targets": ["CPU"], "scheduler": [1, 3], "timer_only": False}))
    p = profiler.get_profiler(str(cfg))
    assert p.targets == CPU and p._scheduler(2) == ProfilerState.RECORD_AND_RETURN
    cfg.write_text(json.dumps({"scheduler": {"closed": 1, "ready": 0, "record": 1}}))
    assert profiler.get_profiler(str(cfg))._scheduler(1) == ProfilerState.RECORD_AND_RETURN


@pytest.mark.parametrize("target", [ProfilerTarget.GPU, ProfilerTarget.TPU,
                                    ProfilerTarget.CUSTOM_DEVICE])
def test_device_target_raises_without_a_card(monkeypatch, target):
    monkeypatch.setattr(torch.cuda, "is_available", lambda: False)
    with pytest.raises(RuntimeError, match="needs a CUDA card"):
        Profiler(targets=[ProfilerTarget.CPU, target])
    assert Profiler().targets == CPU  # the default asks only for what there is


def test_dispatch_span_only_inside_a_record_window():
    x = T.ones([3])
    sch = make_scheduler(closed=1, ready=1, record=1, repeat=1)
    with Profiler(targets=CPU, scheduler=sch) as p:
        for _ in range(4):
            assert (_apply._PROFILER[0] is not None) == (
                p.current_state is ProfilerState.RECORD_AND_RETURN)
            T.add(x, x)
            p.step()
    ops = [e for e in p._last_result.events if e.name.startswith("op::")]
    assert [e.name for e in ops] == ["op::add"]
    assert ops[0].event_type is TracerEventType.Operator and ops[0].step == 2


def test_compiled_function_under_the_profiler():
    """A compiled function traced with the profiler off runs with it on
    (Dynamo recompiles on the dispatch's slot; no graph break, no span from
    traced code)."""
    from paddle_tpu_torch.jit.sot import CountingBackend

    backend = CountingBackend("aot_eager")
    fn = torch.compile(lambda a: T.multiply(T.add(a, a), a), backend=backend, fullgraph=True)
    x = torch.arange(4.0)
    ref = fn(x)
    with Profiler(targets=CPU) as p:
        got = fn(x)
        p.step()
    torch._dynamo.reset()
    assert torch.equal(got, ref) and backend.graphs <= 2
    assert not [e for e in p._last_result.events if e.name.startswith("op::")]


def test_llama_train_step_trace_holds_dispatch_spans(tmp_path):
    """A 2-layer port LLaMA training step under the Profiler: the chrome
    trace holds the dispatch's op:: spans inside the step's span, nested
    spans count their self time, and it loads back."""
    from paddle_tpu_torch.models import LlamaConfig, LlamaForCausalLM

    cfg = LlamaConfig(vocab_size=64, hidden_size=32, intermediate_size=64,
                      num_hidden_layers=2, num_attention_heads=4, num_key_value_heads=2,
                      max_position_embeddings=32, recompute=True)
    model = LlamaForCausalLM(cfg, device="cpu", seed=0)
    model.train()
    opt = T.optimizer.AdamW(learning_rate=1e-3, parameters=model.parameters())
    ids = torch.from_numpy(np.random.RandomState(0).randint(0, 64, (2, 8)))
    results = []
    with Profiler(targets=CPU, scheduler=(1, 2),
                  on_trace_ready=lambda prof: results.append(prof._last_result)) as p:
        for _ in range(3):
            with RecordEvent("train_step"):
                loss, _ = model(ids, labels=ids)
                loss.backward()
                opt.step()
                opt.clear_grad()
            p.step(num_samples=16)
    assert len(results) == 1
    res = results[0]
    path = str(tmp_path / "llama.json")
    res.save(path)
    doc = json.loads(open(path).read())
    spans = [e for e in doc["traceEvents"] if e.get("ph") == "X"]
    ops = {e["name"] for e in spans if e["name"].startswith("op::")}
    assert {"op::embedding_op", "op::rms_norm", "op::linear", "op::flash_attention",
            "op::cross_entropy"} <= ops
    step = [e for e in spans if e["name"] == "train_step"][0]
    for e in spans:
        if e["name"].startswith("op::"):
            assert step["ts"] <= e["ts"] and e["ts"] + e["dur"] <= step["ts"] + step["dur"] + 1
    loaded = profiler.load_profiler_result(path)
    assert {e.name for e in loaded.events} == {e.name for e in res.events}
    with redirect_stdout(io.StringIO()) as buf:
        p.summary()
    assert "op::linear" in buf.getvalue()


def test_device_events_on_the_host_clock():
    """The merge path of the device side, driven with a CPU trace: the
    window's marker ties torch.profiler's clock to perf_counter_ns, the
    events land inside the host window, the per-kernel table adds up, and
    the chrome trace puts them under a pid of their own."""
    from torch.autograd import DeviceType
    from torch.profiler import ProfilerActivity, profile, record_function

    from paddle_tpu_torch.profiler.profiler import _ANCHOR, chrome_events, device_op_stats

    with profile(activities=[ProfilerActivity.CPU]) as prof:
        t0 = time.perf_counter_ns()
        with record_function(_ANCHOR):
            t1 = time.perf_counter_ns()
        a = torch.randn(64, 64)
        for _ in range(3):
            a = torch.mm(a, a).tanh()
        t2 = time.perf_counter_ns()
    evs, lost = collect_device_events(prof.events(), (t0 + t1) // 2,
                                      device_types=(DeviceType.CPU,))
    assert lost == 0  # a CPU trace has no kernel launches
    mm = [e for e in evs if e["name"] == "aten::mm"]
    assert len(mm) == 3 and all(e["plane"].startswith("cpu:") for e in mm)
    for e in mm:
        assert t0 - 1e6 <= e["start_ns"] and e["start_ns"] + e["dur_ns"] <= t2 + 1e6
    rows = device_op_stats(evs)
    mm_row = [r for r in rows if r["name"] == "aten::mm"][0]
    assert mm_row["calls"] == 3 and mm_row["min_ns"] <= mm_row["avg_ns"] <= mm_row["max_ns"]
    assert abs(sum(r["ratio"] for r in rows) - 1.0) < 1e-9
    assert [r["total_ns"] for r in rows] == sorted((r["total_ns"] for r in rows), reverse=True)
    host = HostEvent("host", TracerEventType.UserDefined, t0, t2, 1, 0)
    res = ProfilerResult([host], (0, 1), evs)
    from paddle_tpu_torch.profiler.profiler_statistic import _build_summary

    assert "Device Op Summary" in _build_summary(res)
    dev = [e for e in chrome_events(evs) if e.get("ph") == "X"]
    assert {e["cat"] for e in dev} == {"DeviceOp"} and {e["pid"] for e in dev} == {900000}
    assert "no device record" not in _build_summary(res)
    res.lost_device_records = 2
    assert "2 kernel launches have no device record" in _build_summary(res)
    with pytest.raises(RuntimeError, match="marker"):
        collect_device_events([e for e in prof.events() if e.name != _ANCHOR], 0,
                              device_types=(DeviceType.CPU,))


def test_primer_dropped_and_lost_launches_counted():
    """A window's device events start at its marker: the primer launched
    before it is dropped; a launch after the marker whose kernel has no
    record is counted."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from paddle_tpu_torch.profiler.profiler import _ANCHOR, _lost_launches

    def ev(name, id_, kind, start_us, end_us):
        return NS(name=name, id=id_, device_type=kind, device_index=0, device_resource_id=7,
                  time_range=NS(start=start_us, end=end_us,
                                elapsed_us=lambda s=start_us, e=end_us: e - s))

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [ev("cudaLaunchKernel", 9, cpu, 1.0, 2.0),        # the primer, before
              ev("primer", 9, cuda, 2.0, 3.0),                  # the marker
              ev("cudaLaunchKernel", 8, cpu, 4.0, 5.0),        # lost, before the marker
              ev(_ANCHOR, 1, cpu, 10.0, 11.0),
              ev("cudaLaunchKernel", 2, cpu, 100.0, 103.0),
              ev("fa_fwd_wgmma", 2, cuda, 110.0, 130.0),
              ev("cuLaunchKernel", 3, cpu, 120.0, 121.0),
              ev("triton_poi", 3, cuda, 130.0, 135.0),
              ev("cudaLaunchKernel", 4, cpu, 140.0, 141.0),    # no device record
              ev("cudaMemcpyAsync", 5, cpu, 150.0, 151.0)]     # not a kernel launch
    assert _lost_launches(events, (cuda,), 0.0) == 2
    assert _lost_launches(events, (cuda,), 10.0) == 1
    out, lost = collect_device_events(events, 1_000_000)
    assert lost == 1
    # the anchor at 10 us is host time 1 ms
    assert [(e["name"], e["start_ns"], e["dur_ns"]) for e in out] == [
        ("fa_fwd_wgmma", 1_000_000 + 100_000, 20_000.0),
        ("triton_poi", 1_000_000 + 120_000, 5_000.0)]
    assert out[0]["plane"] == "cuda:0" and out[0]["line"] == "stream 7"


def test_tail_after_end_marker_dropped_and_not_counted():
    """A window closes with an end marker and a tail of tiny kernels: the
    tail's records are dropped like the primer's, and a tail launch with no
    record is not counted as lost; a window's own launch still is."""
    from types import SimpleNamespace as NS

    from torch.autograd import DeviceType

    from paddle_tpu_torch.profiler.profiler import _ANCHOR, _END_ANCHOR, _lost_launches

    def ev(name, id_, kind, start_us, end_us):
        return NS(name=name, id=id_, device_type=kind, device_index=0, device_resource_id=7,
                  time_range=NS(start=start_us, end=end_us,
                                elapsed_us=lambda s=start_us, e=end_us: e - s))

    cpu, cuda = DeviceType.CPU, DeviceType.CUDA
    events = [ev("cudaLaunchKernel", 9, cpu, 1.0, 2.0),        # the primer
              ev("primer", 9, cuda, 2.0, 3.0),
              ev(_ANCHOR, 1, cpu, 10.0, 11.0),
              ev("cuLaunchKernel", 2, cpu, 100.0, 101.0),
              ev("triton_poi", 2, cuda, 105.0, 110.0),
              ev("cudaLaunchKernel", 3, cpu, 120.0, 121.0),    # no device record
              ev(_END_ANCHOR, 4, cpu, 200.0, 201.0),
              ev("cudaLaunchKernel", 5, cpu, 210.0, 211.0),    # the tail, recorded
              ev("tail", 5, cuda, 212.0, 213.0),
              ev("cudaLaunchKernel", 6, cpu, 220.0, 221.0)]    # the tail, no record
    assert _lost_launches(events, (cuda,), 10.0) == 2
    assert _lost_launches(events, (cuda,), 10.0, 200.0) == 1
    out, lost = collect_device_events(events, 1_000_000)
    assert lost == 1
    assert [e["name"] for e in out] == ["triton_poi"]
