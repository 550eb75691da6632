"""The experiments' two timers, on the card (counterpart of ``timeit`` in
scripts/exp_flash_exp2.py:107 and ``chained_time`` in
scripts/exp_flash_floor.py:129 and scripts/exp_flash_pipelined.py:136).

- ``timeit``: one warm-up call, then ``iters`` calls between two CUDA
  events (the reference ends its timing with a host read-back).
- ``chained_time``: the reference chains ``n_chain`` dependent calls,
  ``out = f(out, k, v) + 1e-3``, inside one jit and runs the chain
  ``iters`` times. Here the chain is captured once as a CUDA graph
  (``graph_time``) and replayed ``iters`` times, so the time per call
  carries no host dispatch.

Both return seconds per call and raise unless the inputs are on a CUDA
device: a time taken on the CPU is not a device time.
"""

from __future__ import annotations

from typing import Callable

import torch


def _on_card(tensors) -> None:
    if not torch.cuda.is_available() or any(t.device.type != "cuda"
                                            for t in tensors):
        raise RuntimeError("the experiments' timers measure CUDA devices "
                           "only")


def _events_seconds(run: Callable[[], object], iters: int) -> float:
    start = torch.cuda.Event(enable_timing=True)
    end = torch.cuda.Event(enable_timing=True)
    start.record()
    for _ in range(iters):
        run()
    end.record()
    torch.cuda.synchronize()
    return start.elapsed_time(end) / 1e3 / iters


def timeit(f: Callable, *args: torch.Tensor, iters: int = 50) -> float:
    """Seconds per call of f(*args): one warm-up call, then ``iters``."""
    _on_card(args)
    f(*args)
    torch.cuda.synchronize()
    return _events_seconds(lambda: f(*args), iters)


def chained_time(f: Callable, q: torch.Tensor, k: torch.Tensor,
                 v: torch.Tensor, n_chain: int = 10, iters: int = 10) -> float:
    """Seconds per call of f inside a chain of ``n_chain`` dependent calls
    (``out = f(out, k, v) + 1e-3``, from out = q), captured as one CUDA
    graph and replayed ``iters`` times after one warm-up replay."""
    _on_card((q, k, v))

    def chain():
        out = q
        for _ in range(n_chain):
            out = f(out, k, v) + 1e-3
        return out

    return graph_time(chain, iters) / n_chain


def graph_time(run: Callable[[], object], iters: int = 10) -> float:
    """Seconds per replay of run(), captured once as a CUDA graph (after a
    warm-up call off the capturing stream) and replayed ``iters`` times
    after one warm-up replay: the device's time with no host dispatch."""
    side = torch.cuda.Stream()
    side.wait_stream(torch.cuda.current_stream())
    with torch.cuda.stream(side):  # warm up off the capturing stream
        run()
    torch.cuda.current_stream().wait_stream(side)
    graph = torch.cuda.CUDAGraph()
    with torch.cuda.graph(graph):
        run()
    graph.replay()
    torch.cuda.synchronize()
    return _events_seconds(graph.replay, iters)
