"""The device trace of one unit of the window (an epoch or a batch).

``torch.profiler`` records the device's activity alone (host events of a
whole epoch take the profiler tens of seconds to gather). The first kernel of
the trace is a marker the benchmark launches on an idle device right after a
synchronise, which ties device time to the host clock, so each idle gap can
be named by the span the host was in (the trainer's own ``time/*`` spans,
or the sampler's steps as the benchmark times them). A trace is discarded when
the number of LayerNorm kernels it holds differs from the program's own
launch counter over the same unit: a long process's profiler can drop
records, and a short trace would read the rooflines too high."""

from __future__ import annotations

import contextlib
import time
from typing import Dict, List, Tuple

import torch


def norm_launches() -> int:
    """The program's count of its LayerNorm kernel launches."""
    from adv_grpo_torch.ops import fused_norms

    return int(fused_norms.modulated_layer_norm.launches + fused_norms.layer_norm.launches)


class Tracer:
    """``with tracer.unit(): ...`` traces one unit; ``summary(...)`` reads it."""

    def __init__(self, device, groups: List[dict]):
        self.device = device
        self.groups = groups
        self.prof = None
        self.host_t0 = self.host_t1 = None
        self.norms = 0

    @contextlib.contextmanager
    def unit(self):
        from torch.profiler import ProfilerActivity, profile

        marker = torch.zeros(1, device=self.device)
        torch.cuda.synchronize(self.device)
        n0 = norm_launches()
        with profile(activities=[ProfilerActivity.CUDA]) as prof:
            torch.cuda.synchronize(self.device)
            self.host_t0 = time.perf_counter()
            marker.add_(1.0)
            yield
            torch.cuda.synchronize(self.device)
            self.host_t1 = time.perf_counter()
        self.norms = norm_launches() - n0
        self.prof = prof

    def group_of(self, name: str) -> str:
        for g in self.groups:
            if any(p in name for p in g["patterns"]):
                return g["group"]
        return "other"

    def summary(self, spans: List[Tuple[str, float, float]]) -> dict:
        """{busy_s, window_s, group_s, kernels, device_ops, idle_gaps} of the
        traced unit, from the marker to the synchronise that ends it (the
        profiler's own start and stop left out), or {"discarded": why} when
        the trace is incomplete."""
        unit_t0, unit_t1 = self.host_t0, self.host_t1
        from torch.autograd import DeviceType

        kr = self.prof.profiler.kineto_results
        ev = sorted((e.start_ns(), e.duration_ns(), e.name()) for e in kr.events()
                    if e.device_type() == DeviceType.CUDA and e.duration_ns() > 0)
        if len(ev) < 2:
            return {"discarded": f"{len(ev)} device events in the trace"}
        t0_dev = ev[0][0]  # the marker
        ev = ev[1:]
        seen_norms = sum(1 for _, _, n in ev if "layer_norm_kernel<" in n and "at::native" not in n)
        if seen_norms != self.norms:
            return {"discarded": f"{seen_norms} LayerNorm kernels in the trace, the program "
                                 f"launched {self.norms}"}

        def host(t_ns):  # device ns -> host perf_counter seconds
            return self.host_t0 + (t_ns - t0_dev) * 1e-9

        group_s: Dict[str, float] = {}
        by_name: Dict[str, float] = {}
        busy, gaps = 0.0, []
        cur_s, cur_e = None, None
        for s, d, n in ev:
            g = self.group_of(n)
            group_s[g] = group_s.get(g, 0.0) + d * 1e-9
            by_name[n] = by_name.get(n, 0.0) + d * 1e-9
            if cur_e is None or s > cur_e:
                if cur_e is not None:
                    busy += (cur_e - cur_s) * 1e-9
                    gaps.append((host(cur_e), host(s), n))
                cur_s, cur_e = s, s + d
            else:
                cur_e = max(cur_e, s + d)
        busy += (cur_e - cur_s) * 1e-9
        gaps.insert(0, (unit_t0, host(ev[0][0]), ev[0][2]))
        gaps.append((host(cur_e), unit_t1, "the end of the unit"))
        window_s = unit_t1 - unit_t0

        def label(g0, g1, nxt):
            mid = 0.5 * (g0 + g1)
            inside = [nm for nm, a, b in spans if a <= mid <= b]
            where = inside[-1] if inside else "outside the spans"
            return f"{where}: before {nxt[:60]}"

        idle = sorted(((label(a, b, n), b - a) for a, b, n in gaps if b > a),
                      key=lambda x: -x[1])[:10]
        ops = sorted(by_name.items(), key=lambda x: -x[1])[:10]
        return {"busy_s": busy, "window_s": window_s, "group_s": group_s,
                "kernels": len(ev), "device_ops": [[n[:80], s] for n, s in ops],
                "idle_gaps": [[n, s] for n, s in idle]}
