#!/usr/bin/env python3
"""Which kernel launches a torch.profiler session keeps no device record of,
as the process ages, and whether the port's profiler windows lose any.

    python3 tools/profiler_record_loss.py            # about 5 minutes, one card

The process first ages: a loop of bf16 4096^2 matmuls, a CUDA graph replay,
an Inductor-compiled rope table (``cos``/``sin`` of a 2048 x 128 angle grid,
two kernels, the call ``chip_smoke.py`` phase 18 (b) profiles) and 200 tiny
kernels, until 60, 150 and 240 s have passed. At each age it opens raw
``torch.profiler`` sessions of four designs, three times each: ``primer``
tiny kernels and a synchronize, a 0.2 s pause, the rope call, then ``tail``
tiny kernels: (primer, tail) in (256, 0), (256, 256), (0, 256), (0, 0). A
session's launches are matched to its device records by correlation id, and
the launches without one are counted per group (primer, work, tail; the
work is the call's own launches). Then it opens 10 windows of the port's
``paddle_tpu_torch.profiler.Profiler`` with the GPU target around the same
pause and rope call, and counts the windows whose device events are not the
call's two kernels or that report ``lost_device_records``. Prints one JSON line a session and a summary line.
"""
from __future__ import annotations

import json
import os
import sys
import time

import torch
from torch.autograd import DeviceType
from torch.profiler import ProfilerActivity, profile

sys.path.insert(0, os.path.dirname(os.path.dirname(os.path.abspath(__file__))))

T0 = time.perf_counter()
DESIGNS = ((256, 0), (256, 256), (0, 256), (0, 0))


@torch.compile
def rope(s, d):
    inv = 1.0 / (10000.0 ** (torch.arange(0, d, 2, device="cuda").float() / d))
    f = torch.outer(torch.arange(s, device="cuda").float(), inv)
    e = torch.cat([f, f], -1)
    return e.cos(), e.sin()


def work():
    rope(2048, 128)


_ONE = []  # the tiny kernels' buffer, made once so that tiny(n) launches n kernels


def tiny(n):
    for _ in range(n):
        _ONE[0].add_(1)
    torch.cuda.synchronize()


def session(primer, tail):
    with profile(activities=[ProfilerActivity.CPU, ProfilerActivity.CUDA]) as p:
        tiny(primer)
        time.sleep(0.2)
        work()
        torch.cuda.synchronize()
        tiny(tail)
    ev = p.events()
    dev = {e.id for e in ev if e.device_type == DeviceType.CUDA}
    launches = sorted((e for e in ev if e.device_type != DeviceType.CUDA
                       and "LaunchKernel" in e.name), key=lambda e: e.time_range.start)
    lost = [i for i, e in enumerate(launches) if e.id not in dev]
    n_work = len(launches) - primer - tail
    return dict(primer=sum(i < primer for i in lost),
                work=sum(primer <= i < primer + n_work for i in lost),
                tail=sum(i >= primer + n_work for i in lost), work_launches=n_work)


def port_window(P):
    with P.Profiler(targets=[P.ProfilerTarget.CPU, P.ProfilerTarget.GPU]) as prof:
        time.sleep(0.2)
        work()
    res = prof._last_result
    return len(res.device_events()), res.lost_device_records


def age(until_s):
    a = torch.randn(4096, 4096, device="cuda", dtype=torch.bfloat16)
    y = torch.empty_like(a)
    g = torch.cuda.CUDAGraph()
    s = torch.cuda.Stream()
    with torch.cuda.stream(s):
        y.copy_(a @ a)
        torch.cuda.synchronize()
        with torch.cuda.graph(g):
            y.copy_(a @ a)
    while time.perf_counter() - T0 < until_s:
        for _ in range(10):
            a @ a
        g.replay()
        work()
        tiny(200)


def main():
    if not torch.cuda.is_available():
        sys.exit("needs a CUDA card")
    from paddle_tpu_torch import profiler as P

    _ONE.append(torch.zeros(1, device="cuda"))
    work()
    torch.cuda.synchronize()
    summary = {f"{p}/{t}": dict(sessions=0, lost_work=0, lost_primer=0, lost_tail=0,
                                most_lost_tail=0)
               for p, t in DESIGNS}
    for until in (60, 150, 240):
        age(until)
        for _ in range(3):
            for primer, tail in DESIGNS:
                r = session(primer, tail)
                row = summary[f"{primer}/{tail}"]
                row["sessions"] += 1
                row["lost_work"] += r["work"] > 0
                row["lost_primer"] += r["primer"]
                row["lost_tail"] += r["tail"]
                row["most_lost_tail"] = max(row["most_lost_tail"], r["tail"])
                print(json.dumps(dict(age_s=round(time.perf_counter() - T0, 1), primer=primer,
                                      tail=tail, lost=r)), flush=True)
    windows = [port_window(P) for _ in range(10)]
    print(json.dumps(dict(raw_sessions=summary, port_windows=len(windows),
                          port_windows_short=sum(n != 2 or lost for n, lost in windows),
                          card=torch.cuda.get_device_name(0))), flush=True)


if __name__ == "__main__":
    main()
