"""CUDA timing helpers shared by ``chip_smoke.py``, the measurement
scripts and the card tests: CUDA-event times of back-to-back calls, device
times from CUDA-graph replays, and the device operations a call issues.
Each needs a CUDA device; the callables must not synchronise."""

from __future__ import annotations

import pathlib
import re
import statistics
import tempfile

import torch


def cuda_ms(fns: dict, reps: int = 11, calls: int = 10) -> dict:
    """Median CUDA-event ms per call of each callable.  A sample is
    ``calls`` back-to-back calls between two events, so the host queues
    launches ahead of the card; versions run in turns after a warm-up, so
    the ones compared share the card's state."""
    for fn in fns.values():
        fn()
    torch.cuda.synchronize()
    times = {k: [] for k in fns}
    for r in range(reps):
        order = list(fns) if r % 2 == 0 else list(reversed(fns))
        for k in order:
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            for _ in range(calls):
                fns[k]()
            e.record()
            e.synchronize()
            times[k].append(s.elapsed_time(e) / calls)
    return {k: statistics.median(v) for k, v in times.items()}


def graph_ms(fns: dict, reps: int = 7, calls: int = 10) -> dict:
    """Device time of one call of each callable: ``calls`` calls captured
    in a CUDA graph, the graph's replays timed with CUDA events (median of
    ``reps``), so the host work of a kernel's wrapper, which can outlast
    the kernel, is not counted."""
    out = {}
    cur = torch.cuda.current_stream()
    for k, fn in fns.items():
        side = torch.cuda.Stream()
        side.wait_stream(cur)
        with torch.cuda.stream(side):
            fn()                          # warm-up outside the capture
        cur.wait_stream(side)
        g = torch.cuda.CUDAGraph()
        with torch.cuda.graph(g):
            for _ in range(calls):
                fn()
        g.replay()
        torch.cuda.synchronize()
        times = []
        for _ in range(reps):
            s = torch.cuda.Event(enable_timing=True)
            e = torch.cuda.Event(enable_timing=True)
            s.record()
            g.replay()
            e.record()
            e.synchronize()
            times.append(s.elapsed_time(e) / calls)
        out[k] = statistics.median(times)
        del g
    return out


def graph_ops(fn, calls: int = 3) -> float:
    """Device operations (kernels, memsets, copies) one call of ``fn``
    issues: the nodes of a CUDA graph that captured ``calls`` calls,
    counted in its DOT dump."""
    fn()
    torch.cuda.synchronize()
    g = torch.cuda.CUDAGraph(keep_graph=True)
    g.enable_debug_mode()
    with torch.cuda.graph(g):
        for _ in range(calls):
            fn()
    with tempfile.TemporaryDirectory() as td:
        dot = pathlib.Path(td) / "graph.dot"
        g.debug_dump(str(dot))
        text = dot.read_text()
    nodes = set(re.findall(r"graph_\d+_node_\d+", text))
    if not nodes:
        raise AssertionError(f"no graph nodes in the DOT dump: {text[:500]}")
    return len(nodes) / calls
