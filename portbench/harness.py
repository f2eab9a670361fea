"""One run of one cell: set-up, the measured window, the traced reading,
and the comparison with the plain reference that decides `correct`.

Everything particular to a configuration, a traffic mix or a metric is
found by name: `BENCHMARK.json` names the cell's configuration file
(which names its reference module under `reference/`) and its traffic
mix (`traffic/<mix>.json`, data that names its kind); the kind's
generator `kinds/<kind>.py` makes the pool and serves a request; each
metric is read by `e2e_metrics/<name>.py` or `layer_metrics/<name>.py`,
whose `read(run)` returns the value or None.  The program is reached
only through `mrcnn3d_torch.entry` (`build`, and the entry the kind
calls), the forward hooks of the modules the reference names, the
`mark` hook, and the kernels' launch counters and wrappers.
"""
from __future__ import annotations

import bisect
import importlib
import importlib.util
import json
import os
import statistics
import subprocess
import time
import traceback

import torch

from . import flops, roofline, weights
from .reference import nn as rnn

HERE = os.path.dirname(os.path.abspath(__file__))
DTYPES = {"bfloat16": torch.bfloat16, "float32": torch.float32}
# requests compared with the reference: the window's first and two more
# drawn from the seed among its first CHECK_AMONG
CHECKED = 3
CHECK_AMONG = 40
WARMUP = 3
# a --trace 1 run profiles the window's first TRACED requests with the
# device's activity alone (busy and idle, the kernels' device time),
# then GAPS_TRACED more with the host's operations too, for the labels
# of the idle gaps in the breakdown
TRACED = 32
GAPS_TRACED = 2
K1_KERNELS = ("nms3d_mask_kernel", "nms3d_scan_kernel")
K2_KERNELS = ("roi_align3d_kernel", "roi_align3d_direct_kernel")


def load_json(path):
    with open(path) as f:
        return json.load(f)


def load_module(path, name):
    spec = importlib.util.spec_from_file_location(name, path)
    mod = importlib.util.module_from_spec(spec)
    spec.loader.exec_module(mod)
    return mod


class Cell:
    """A cell of BENCHMARK.json with its configuration, mix, reference
    module and metrics."""

    def __init__(self, bench, name, root="."):
        cells = {w["name"]: w for w in bench["workloads"]}
        if name not in cells:
            raise KeyError(f"no workload {name!r}; the workloads are "
                           f"{sorted(cells)}")
        self.spec = cells[name]
        self.name = name
        configs = {c["name"]: c for c in bench["configs"]}
        self.config = load_json(os.path.join(
            root, configs[self.spec["config"]]["file"]))
        # the detector's configuration, mmdet-style, as both sides read it
        self.cfg = self.config["program"]
        self.mix = load_json(os.path.join(HERE, "traffic",
                                          self.spec["traffic"] + ".json"))
        self.kind = load_module(os.path.join(HERE, "kinds",
                                             self.mix["kind"] + ".py"),
                                f"portbench_kind_{self.mix['kind']}")
        self.reference = importlib.import_module(
            f"portbench.reference.{self.config['reference']}")
        self.end_to_end = [m for m in bench["end_to_end"] if self._has(m)]
        reported = {m["name"] for m in self.end_to_end}
        self.per_layer = [m for m in bench["per_layer"]
                          if self._has(m, m["moves"] in reported)]

    def _has(self, metric, default=True):
        if "workloads" in metric:
            return self.name in metric["workloads"]
        return default


def reader(kind, name):
    return load_module(os.path.join(HERE, kind, name + ".py"),
                       f"portbench_{kind}_{name}").read


def program_config(config):
    """The program's config object from the configuration's blocks."""
    from mrcnn3d_torch.utils.config import ConfigDict

    return ConfigDict.wrap(config)


class Capture:
    """Forward hooks on the program's modules that the reference reads:
    while armed, each call's output is kept, in call order."""

    def __init__(self, model, names):
        self.armed = False
        self.names = names
        self.calls = {n: [] for n in names}
        self.handles = [model.get_submodule(n).register_forward_hook(
            self._hook(n)) for n in names]

    def _hook(self, name):
        def hook(mod, inp, out):
            if self.armed:
                self.calls[name].append(out)
        return hook

    def take(self):
        calls, self.calls = self.calls, {n: [] for n in self.names}
        return calls


class StageTimer:
    """The `mark` hook: a CUDA event at each stage boundary."""

    def __init__(self):
        self.events = [("start", self._event())]

    @staticmethod
    def _event():
        ev = torch.cuda.Event(enable_timing=True)
        ev.record()
        return ev

    def __call__(self, name):
        self.events.append((name, self._event()))

    def stages_ms(self):
        """Per request: backbone_fpn (each scale's backbone and FPN, from
        the mark before it), proposals (each scale's RPN to its
        proposals), heads (the rest of the request: bbox, refinement or
        cascade, semantic, NMS, masks)."""
        out = dict(backbone_fpn=0.0, proposals=0.0)
        for (_, prev), (name, ev) in zip(self.events, self.events[1:]):
            key = name.rsplit("_", 1)[0]
            if key in out:
                out[key] += prev.elapsed_time(ev)
        total = self.events[0][1].elapsed_time(self.events[-1][1])
        out["heads"] = total - out["backbone_fpn"] - out["proposals"]
        return out


class LaunchRecorder:
    """Within the block, each K1 and K2 launch's arguments, kept light
    (counts; rois, levels and valid flags; level shapes), by wrapping
    the wrappers the program calls."""

    def __enter__(self):
        from mrcnn3d_torch.ops import nms3d, roi_align3d

        self.k1, self.k2 = [], []
        self._saved = [(nms3d, "greedy_scan_cuda", nms3d.greedy_scan_cuda),
                       (roi_align3d, "roi_align_3d_cuda",
                        roi_align3d.roi_align_3d_cuda)]
        k1_fn, k2_fn = (s[2] for s in self._saved)

        def k1(sboxes, svalid, counts, iou_thr):
            self.k1.append(list(counts))
            return k1_fn(sboxes, svalid, counts, iou_thr)

        def k2(feats_cl, rois, levels, valid, *geometry):
            self.k2.append(([tuple(f.shape) for f in feats_cl],
                            feats_cl[0].element_size(), rois, levels, valid,
                            geometry))
            return k2_fn(feats_cl, rois, levels, valid, *geometry)

        nms3d.greedy_scan_cuda = k1
        roi_align3d.roi_align_3d_cuda = k2
        return self

    def __exit__(self, *exc):
        for mod, attr, fn in self._saved:
            setattr(mod, attr, fn)
        return False

    def bounds_s(self):
        k1 = sum(roofline.bound_s(*roofline.k1_work(c)) for c in self.k1)
        k2 = sum(roofline.bound_s(*roofline.k2_work(*a[:5], *a[5]))
                 for a in self.k2)
        return k1, k2


def launch_counts():
    from mrcnn3d_torch.ops import nms3d, roi_align3d

    return nms3d.launches, roi_align3d.launches


def sync(device):
    if device.type == "cuda":
        torch.cuda.synchronize(device)


def build_reference(cell, state, device, round_operand=None):
    """The reference on `device` in float32, with the run's weights."""
    with torch.device("meta"):
        model = cell.reference.Detector(cell.cfg)
    model = model.to_empty(device=device)
    model.load_state_dict({k: v.float() for k, v in state.items()})
    if round_operand is not None:
        rnn.set_operand_rounding(model, round_operand)
    return model.eval()


def make_state(cell, seed, device):
    with torch.device("meta"):
        shapes = cell.reference.Detector(cell.cfg)
    return weights.make_weights(shapes, seed, device,
                                DTYPES[cell.config["dtype"]])


class Run:
    """A cell's program, built once; `load(seed)` gives it a seed's
    weights and pool, `window(seconds)` serves the mix, `check()`
    compares the checked requests with the reference."""

    def __init__(self, cell, device):
        from mrcnn3d_torch.entry import build

        self.cell = cell
        self.device = torch.device(device)
        self.det = build(program_config(cell.cfg), device=self.device,
                         dtype=DTYPES[cell.config["dtype"]])
        self.capture = Capture(self.det.model,
                               list(cell.reference.capture(cell.cfg)))
        self.host = None

    def load(self, seed):
        self.seed = seed
        self.state = make_state(self.cell, seed, self.device)
        self.det.model.load_state_dict(self.state)
        self.pool = self.cell.kind.make_pool(
            self.cell.mix, self.cell.config, seed, self.device,
            DTYPES[self.cell.config["dtype"]])
        gen = torch.Generator().manual_seed(seed + 2)
        extra = (torch.randperm(CHECK_AMONG - 1, generator=gen)[:CHECKED - 1]
                 + 1).tolist()
        self.check_at = sorted({0, *extra})

    def request(self, item, mark=None):
        """One request of the cell's kind: its outputs on the host, in
        pinned buffers that the next request reuses (copied once the
        device has them)."""
        out = self.cell.kind.request(self.det, item, mark)
        if mark is not None:
            mark("end")
        if self.device.type != "cuda":
            return out
        if self.host is None:
            self.host = {k: torch.empty(v.shape, dtype=v.dtype,
                                        pin_memory=True)
                         for k, v in out.items()}
        for k, v in out.items():
            self.host[k].copy_(v, non_blocking=True)
        torch.cuda.current_stream(self.device).synchronize()
        return self.host

    def warm_up(self):
        for i in range(WARMUP):
            self.request(self.pool[i % len(self.pool)])
        sync(self.device)

    def window(self, seconds, trace=False):
        """The closed loop for `seconds`: every request that starts
        before the deadline completes.  With `trace`, every request
        records the stage events; the window's first TRACED requests run
        under the profiler with the device's activity alone (started
        before the window), their K1 and K2 launches recorded, and the
        GAPS_TRACED after them under the profiler with the host's
        operations too.  Returns the window's record."""
        order = self.cell.kind.order(self.cell.mix, self.seed)
        rec = dict(latency_s=[], failed=0, errors=[], checked=[],
                   stages=[], after_profile=None)
        recorder = prof = None
        if trace:
            recorder = LaunchRecorder().__enter__()
            prof = _profiler(torch.profiler.ProfilerActivity.CUDA)
        if self.device.type == "cuda":
            torch.cuda.reset_peak_memory_stats(self.device)
        launches0 = launch_counts()
        i = 0
        t_start = time.perf_counter()
        deadline = t_start + seconds
        t_end = t_start
        while time.perf_counter() < deadline:
            idx = next(order)
            timer = StageTimer() if trace else None
            self.capture.armed = i in self.check_at
            t0 = time.perf_counter()
            try:
                out = self.request(self.pool[idx], mark=timer)
            except Exception:  # a failed request counts, the loop goes on
                rec["failed"] += 1
                rec["errors"].append(traceback.format_exc(limit=4))
                out = None
            t_end = time.perf_counter()
            rec["latency_s"].append(t_end - t0)
            if timer is not None and out is not None:
                rec["stages"].append(timer)
            if self.capture.armed and out is not None:
                host = {k: v.clone() for k, v in out.items()}
                rec["checked"].append((idx, host, self.capture.take()))
            self.capture.armed = False
            i += 1
            if prof is not None and i == TRACED:
                _stop_profile(rec, prof, recorder, t_start)
                prof = _profiler(torch.profiler.ProfilerActivity.CPU,
                                 torch.profiler.ProfilerActivity.CUDA)
            elif prof is not None and i == TRACED + GAPS_TRACED:
                prof.stop()
                rec["gaps_profile"], prof = prof, None
                rec["after_profile"] = (i, time.perf_counter())
        if prof is not None and "profile" not in rec:
            _stop_profile(rec, prof, recorder, t_start)
        elif prof is not None:
            prof.stop()
            rec["gaps_profile"] = prof
        sync(self.device)
        rec["window_s"] = t_end - t_start
        rec["attempted"] = i
        if rec["after_profile"] is not None:
            n0, t0 = rec["after_profile"]
            rec["after_profile"] = (i - n0 - rec["failed"], t_end - t0)
        after = launch_counts()
        rec["launches_per_volume"] = [(b - a) / max(i, 1)
                                      for a, b in zip(launches0, after)]
        rec["memory_peak_bytes"] = (
            torch.cuda.max_memory_allocated(self.device)
            if self.device.type == "cuda" else 0)
        return rec

    def free(self, keep=()):
        """Drop the program and every pool entry but `keep`."""
        pool = {i: self.pool[i] for i in keep}
        del self.det, self.capture, self.pool
        if self.device.type == "cuda":
            torch.cuda.empty_cache()
        return pool


def _profiler(*activities):
    prof = torch.profiler.profile(activities=list(activities))
    prof.start()
    return prof


def _stop_profile(rec, prof, recorder, t_start):
    rec["traced_window_s"] = time.perf_counter() - t_start
    prof.stop()
    recorder.__exit__(None, None, None)
    rec["profile"], rec["launches"] = prof, recorder


class CaptureMismatch(Exception):
    """A module the check reads was not called as the reference expects."""


def check_captured(cell, cap):
    """Raise CaptureMismatch unless each module the reference reads was
    called as many times in the request as `reference.capture` says: a
    change that batches, fuses or bypasses a module's forward (a CUDA
    graph replay) has to bring the reference module along."""
    want = cell.reference.capture(cell.cfg)
    for name, n in want.items():
        got = len(cap.get(name, ()))
        if got != n:
            raise CaptureMismatch(
                f"the check reads the program's module {name!r}: "
                f"{n} call(s) a request expected, {got} captured; adapt "
                f"portbench/reference/{cell.reference.__name__.split('.')[-1]}"
                f".py (capture, check) to the program's new structure")


def reference_check(cell, state, checked, device):
    """Each checked request's numbers against the float32 reference (the
    worst over the requests), and the diagnostics.  `checked`: (batch,
    outputs, captured calls) triples."""
    for _, _, cap in checked:
        check_captured(cell, cap)
    torch.backends.cuda.matmul.allow_tf32 = False
    torch.backends.cudnn.allow_tf32 = False
    ref = build_reference(cell, state, device)
    worst, diag = {}, []
    for batch, out, cap in checked:
        out = {k: v.to(device) for k, v in out.items()}
        anchors = cell.reference.anchors(ref, cell.cfg, batch, device)
        nums, d = cell.reference.check(ref, batch, cell.cfg, anchors,
                                       out, cap)
        for k, v in nums.items():
            worst[k] = max(worst.get(k, 0.0), v)
        diag.append(d)
    return worst, diag


def control_outputs(cell, state, batch, device):
    """The control: the reference in the program's place, its operands
    rounded to float8 e4m3 (the precision below the configuration's
    bfloat16).  Returns (outputs, captured calls)."""
    model = build_reference(cell, state, device, rnn.fp8)
    anchors = cell.reference.anchors(model, cell.cfg, batch, device)
    return cell.reference.infer(model, batch, cell.cfg, anchors)


def judge(nums, limits, failed, compared):
    """`correct`, and the list of (name, value, limit) it rests on."""
    checks = [(k, nums.get(k, float("nan")), limits[k]) for k in limits]
    ok = (failed == 0 and compared > 0 and set(nums) == set(limits)
          and all(v <= lim for _, v, lim in checks))
    return ok, checks


def power_limit():
    try:
        proc = subprocess.run(
            ["nvidia-smi", "--query-gpu=name,power.limit",
             "--format=csv,noheader"], capture_output=True, text=True,
            timeout=30, check=True)
    except (OSError, subprocess.SubprocessError):
        return None
    return proc.stdout.strip().splitlines()[0]


def _device_spans(prof):
    """The profile's events: (device spans, host spans), each (start us,
    end us, name), sorted."""
    dev_type = torch.autograd.DeviceType.CUDA
    dev, host = [], []
    for e in prof.events():
        span = (e.time_range.start, e.time_range.end, e.name)
        (dev if e.device_type == dev_type else host).append(span)
    return sorted(dev), sorted(host)


def _busy(spans):
    """Busy microseconds (the union of the spans), each name's summed
    microseconds, and the idle gaps between the spans."""
    busy, end, by_name, gaps = 0.0, spans[0][0], {}, []
    for s, e, name in spans:
        if s > end:
            gaps.append((end, s))
        busy += max(0.0, e - max(s, end))
        end = max(end, e)
        by_name[name] = by_name.get(name, 0.0) + (e - s)
    return busy, by_name, gaps


def reduce_profile(prof, top=10):
    """From the device-only profile: device busy seconds (the union of
    the device's activity), device seconds of K1's and K2's kernels, and
    the operations that took most device time."""
    spans, _ = _device_spans(prof)
    if not spans:
        return None
    busy, by_name, _ = _busy(spans)

    def kernels_s(names):
        return sum(t for n, t in by_name.items()
                   if any(f"::{k}(" in n or f"::{k}<" in n or n.startswith(k)
                          for k in names)) / 1e6

    rank = sorted(by_name.items(), key=lambda kv: -kv[1])[:top]
    return dict(
        busy_s=busy / 1e6, k1_s=kernels_s(K1_KERNELS),
        k2_s=kernels_s(K2_KERNELS),
        device_ops=[[n[:96], t / 1e6] for n, t in rank])


def idle_gaps(prof, top=10):
    """From the profile with the host's operations: the longest idle gaps
    of the device, summed by the host operation that was running through
    each (the innermost one open at its middle)."""
    spans, host = _device_spans(prof)
    if not spans:
        return None
    gaps = _busy(spans)[2]
    starts = [h[0] for h in host]
    by_gap = {}
    for g0, g1 in sorted(gaps, key=lambda g: g[0] - g[1])[:200]:
        mid = (g0 + g1) / 2
        j = bisect.bisect_right(starts, mid) - 1
        label = "host"
        for k in range(j, max(j - 5000, -1), -1):
            if host[k][1] >= mid:
                label = host[k][2]
                break
        by_gap[label] = by_gap.get(label, 0.0) + (g1 - g0) / 1e6
    return [[n[:96], t] for n, t in
            sorted(by_gap.items(), key=lambda kv: -kv[1])[:top]]


def run_cell(cell, seed, seconds, trace, device, t_process):
    """One run as the command runs it; returns (result, info lines).
    `t_process`: perf_counter at the process's start (set-up counts from
    there)."""
    run = Run(cell, device)
    run.load(seed)
    run.warm_up()
    setup_s = time.perf_counter() - t_process
    rec = run.window(seconds, trace)
    volumes_done = len(rec["latency_s"]) - rec["failed"]
    shapes = {k: tuple(v.shape[2:]) for k, v in run.pool[0].items()}
    pool = run.free(keep={idx for idx, _, _ in rec["checked"]})
    checked = [(pool[idx], out, cap) for idx, out, cap in rec["checked"]]
    try:
        nums, diag = reference_check(cell, run.state, checked, run.device)
    except CaptureMismatch as e:
        nums, diag = {}, [dict(fault=str(e))]
    correct, checks = judge(nums, cell.config["limits"], rec["failed"],
                            len(checked))
    dev = run.device
    device_rec = dict(
        platform="gpu" if dev.type == "cuda" else dev.type,
        kind=(torch.cuda.get_device_name(dev) if dev.type == "cuda"
              else "cpu"),
        count=1, memory_peak_bytes=int(rec["memory_peak_bytes"]),
        power=power_limit() if dev.type == "cuda" else None)
    data = dict(seconds=seconds, setup_s=setup_s, volumes=volumes_done,
                window_s=rec["window_s"], latency_s=rec["latency_s"],
                memory_peak_bytes=rec["memory_peak_bytes"])
    result = dict(correct=correct, attempted=rec["attempted"],
                  failed=rec["failed"], metrics={}, device=device_rec)
    if trace:
        data.update(trace_record(cell, rec, shapes))
        if data.get("profile"):
            device_rec["busy_s"] = data["profile"]["busy_s"]
            device_rec["window_s"] = data["traced_window_s"]
            result["breakdown"] = dict(
                device_ops=data["profile"]["device_ops"],
                idle_gaps=data["idle_gaps"] or [])
    metrics = cell.per_layer if trace else cell.end_to_end
    kind = "layer_metrics" if trace else "e2e_metrics"
    for m in metrics:
        value = reader(kind, m["name"])(data)
        if value is not None:
            result["metrics"][m["name"]] = dict(value=value, unit=m["unit"])
    result["checks"] = {k: dict(value=v, limit=lim) for k, v, lim in checks}
    lat = sorted(rec["latency_s"])
    info = dict(workload=cell.name, seed=seed, trace=int(trace),
                latency_ms={q: lat[min(len(lat) - 1, int(q * len(lat)))] * 1e3
                            for q in (0.0, 0.05, 0.5, 0.95)} if lat else {},
                launches_per_volume=dict(zip(
                    ("nms3d", "roi_align3d"), rec["launches_per_volume"])),
                compared_requests=[i for i in run.check_at
                                   if i < rec["attempted"]],
                diagnostics=diag, errors=rec["errors"][:2])
    return result, info


def trace_record(cell, rec, shapes):
    """What the per-layer readers read from a traced run."""
    out = dict(stage_ms=None, profile=None)
    if rec["stages"]:
        per = [t.stages_ms() for t in rec["stages"]]
        out["stage_ms"] = {k: statistics.fmean(p[k] for p in per)
                           for k in per[0]}
    if "profile" in rec:
        out["profile"] = reduce_profile(rec["profile"])
        out["traced_window_s"] = rec["traced_window_s"]
        out["k1_bound_s"], out["k2_bound_s"] = rec["launches"].bounds_s()
        out["idle_gaps"] = (idle_gaps(rec["gaps_profile"])
                            if "gaps_profile" in rec else None)
    out["flops_per_volume"] = flops.request_flops(cell.reference, cell.cfg,
                                                  shapes)
    # the window after the profiler stopped: the rate step_mfu reads
    out["unprofiled"] = rec["after_profile"]
    return out
