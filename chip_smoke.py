#!/usr/bin/env python3
"""Smoke test of the PyTorch/CUDA port on one NVIDIA GPU.

Run from the repository root with no arguments:

    python3 chip_smoke.py

Phases (any failure exits non-zero; nothing is caught and passed over):

1. probe — the card's name and power limit, CUDA and nvcc versions; build
   the hand-written kernels from ``src/repro_torch/csrc`` and time the build;
2. kernels — every kernel wrapper against its plain PyTorch version on the
   card, at the main path's widths and at edge shapes;
3. main path — ``repro_torch.fl.experiment.run_experiment("image_recognition",
   "echopfl", num_clients=20, max_time=1500, seed=0)`` on the card and, only
   if that run makes no merge, the same run with ``hm=1.0``; launch counts
   are zeroed just before and read just after, and every kernel must launch;
   host time is summed per layer;
4. agreement — a small ``har`` run on the card against the same run on the
   CPU, where every wrapper takes its plain version;
5. timing — each kernel, its plain version and (where one exists) a single
   PyTorch call computing the same function, at the shape the main path
   called it with most, beside the least time the card could take: device
   time per call from a ``torch.profiler`` trace (``ms``, ``plain_ms``,
   ``library_ms``) and the per-call time of back-to-back calls between CUDA
   events, host overhead included (``call_ms`` and its two siblings);
6. profile — a short main-path run under ``torch.profiler``: device busy
   time, the device's idle share and the kernels that take the time.

The last lines are one JSON object with the kernel table, the card's name
and power limit, and ``{"ok": true, "device": {...}}``. Without CUDA, or
outside a checkout of the repository, it exits non-zero and prints no result.
"""
from __future__ import annotations

import json
import statistics
import subprocess
import sys
import time
from collections import Counter
from pathlib import Path

import torch

ROOT = Path(__file__).resolve().parent
DEVICE = "cuda"
HBM_BYTES_PER_S = 3.35e12  # H100 SXM device memory
FP32_FLOPS_PER_S = 67e12  # H100 SXM fp32 outside the tensor cores

KERNELS = {  # wrapper name -> (CUDA source, the TPU kernel's pallas_call it replaces)
    "l1_distance": ("src/repro_torch/csrc/l1.cu", "src/repro/kernels/l1_distance.py:51"),
    "l1_distance_pairwise": ("src/repro_torch/csrc/l1.cu", "src/repro/kernels/l1_pairwise.py:57"),
    "assign_and_lerp": ("src/repro_torch/csrc/assign_lerp.cu", "src/repro/kernels/assign_lerp.py:63"),
    "chi2_feedback": ("src/repro_torch/csrc/chi2.cu", "src/repro/kernels/chi2_feedback.py:50"),
    "chi2_feedback_segmented": ("src/repro_torch/csrc/chi2.cu", "src/repro/kernels/chi2_feedback.py:111"),
    "merge_attention": ("src/repro_torch/csrc/merge.cu", "src/repro/kernels/merge_attention.py:68"),
}
# the kernels' entry functions in src/repro_torch/csrc, as the profiler names them
PORT_KERNEL_NAMES = ("l1_rows_kernel", "select_lerp_kernel", "chi2_rows_kernel", "segment_sum_kernel",
                     "merge_max_kernel", "merge_blend_kernel")


def check(cond: bool, msg: str) -> None:
    if not cond:
        raise AssertionError(msg)


def sh(*cmd: str) -> str:
    return subprocess.run(cmd, capture_output=True, text=True, timeout=120).stdout.strip()


def gen(seed: int):
    return torch.Generator(device=DEVICE).manual_seed(seed)


def randn(g, *shape):
    return torch.randn(shape, generator=g, device=DEVICE, dtype=torch.float32)


def sync():
    if DEVICE == "cuda":
        torch.cuda.synchronize()


# ------------------------------------------------------------------ phase 1
def probe():
    from repro_torch.kernels import _build

    smi = sh("nvidia-smi", "--query-gpu=name,power.limit", "--format=csv,noheader")
    print(f"card: {smi}")
    print(f"torch {torch.__version__}, CUDA {torch.version.cuda}, device {torch.cuda.get_device_name(0)}")
    print("nvcc: " + sh(_build.nvcc(), "--version").splitlines()[-1])
    t0 = time.perf_counter()
    _build.library()
    built = _build.build_seconds
    print(f"kernel build: {time.perf_counter() - t0:.2f} s"
          + ("" if built is not None else " (loaded an existing build)"))
    return smi


# ------------------------------------------------------------------ phase 2
def kernel_phase():
    from repro_torch.kernels import assign_lerp, chi2, l1, merge, ops

    n_checked = 0
    widths = (25418, 4550, 4099)  # image_recognition, har, and N % 4 != 0
    for n in widths:
        g = gen(n)
        for c in (1, 2, 5, 8):
            cs = randn(g, c, n)
            for m in (1, 8, 64):
                xs = randn(g, m, n)
                got, want = ops.l1_distance_pairwise(xs, cs), l1.l1_distance_pairwise_plain(xs, cs)
                torch.testing.assert_close(got, want, rtol=1e-5, atol=0)
                n_checked += 1
            u = randn(g, n)
            torch.testing.assert_close(ops.l1_distance(u, cs), l1.l1_distance_plain(u, cs), rtol=1e-5, atol=0)
            for beta in (0.25, 0.3):
                d, i, b = ops.assign_and_lerp(u, cs, beta)
                dp, ip, bp = assign_lerp.assign_and_lerp_plain(u, cs, beta)
                torch.testing.assert_close(d, dp, rtol=1e-5, atol=0)
                check(int(i) == int(ip) == int(torch.argmin(d.cpu())), f"argmin n={n} c={c}")
                check(torch.equal(b, bp), f"blend not bitwise n={n} c={c} beta={beta}")
                n_checked += 1
        # tie: rows 1 and 3 equal and nearest (same alignment class) -> index 1
        cs = randn(g, 5, n) + 5.0
        u = randn(g, n)
        cs[1] = u + 0.5
        cs[3] = u + 0.5
        d, i, b = ops.assign_and_lerp(u, cs, 0.25)
        check(int(i) == 1 and float(d[1]) == float(d[3]), f"tie n={n}: idx {int(i)}")
        check(torch.equal(b, assign_lerp.blend_plain(cs[1], u, 0.25)), "tie blend")
        vm, va, vt = randn(g, n), randn(g, n), randn(g, n)
        torch.testing.assert_close(ops.merge_attention(vm, va, vt),
                                   merge.merge_attention_plain(vm, va, vt)[0], rtol=1e-6, atol=1e-7)
        n_checked += 1
    g = gen(7)
    for m in (1, 8, 64, 300):
        for j in (6, 10):
            fp = torch.rand((m, j), generator=g, device=DEVICE) * 100
            ft = torch.rand((m, j), generator=g, device=DEVICE) * 100 + 1.0
            ss = torch.softmax(randn(g, m, j), dim=-1)
            torch.testing.assert_close(ops.chi2_feedback(fp, ft, ss), chi2.chi2_feedback_plain(fp, ft, ss),
                                       rtol=1e-5, atol=1e-6)
            for s in (1, 4, 8):
                seg = torch.randint(-1, s, (m,), generator=g, device=DEVICE, dtype=torch.int32)
                runs = [ops.chi2_feedback_segmented(fp, ft, ss, seg, s) for _ in range(3)]
                gp, sp = chi2.chi2_feedback_segmented_plain(fp, ft, ss, seg, s)
                torch.testing.assert_close(runs[0][0], gp, rtol=1e-5, atol=1e-6)
                torch.testing.assert_close(runs[0][1], sp, rtol=1e-5, atol=1e-5)
                check(all(torch.equal(r[1], runs[0][1]) and torch.equal(r[0], runs[0][0]) for r in runs),
                      "segment sums differ across repeats")
                n_checked += 1
    sync()
    print(f"kernel phase: {n_checked} checks passed (L1/chi2 rtol 1e-5, blend bitwise, "
          "idx equal, merge rtol 1e-6 atol 1e-7, segment sums bitwise across repeats)")


# ------------------------------------------------------------------ phase 3
def _record_shapes(ops):
    """Wrap the ops entry points the protocol calls so the main path's
    argument shapes are logged (the wrapped functions still count)."""
    shapes: dict[str, Counter] = {name: Counter() for name in KERNELS}
    originals = {}

    def wrap(name, fn, key):
        def rec(*args, **kw):
            shapes[name][key(*args, **kw)] += 1
            return fn(*args, **kw)
        originals[name] = fn
        setattr(ops, name, rec)

    wrap("l1_distance_pairwise", ops.l1_distance_pairwise, lambda x, c: (x.shape[0], c.shape[0], x.shape[1]))
    wrap("assign_and_lerp", ops.assign_and_lerp, lambda u, c, b: (c.shape[0], c.shape[1]))
    wrap("chi2_feedback", ops.chi2_feedback, lambda fp, ft, ss: tuple(fp.shape))
    wrap("chi2_feedback_segmented", ops.chi2_feedback_segmented,
         lambda fp, ft, ss, seg, num_segments: (fp.shape[0], fp.shape[1], num_segments))
    wrap("merge_attention", ops.merge_attention, lambda vm, va, vt: (vm.shape[0],))

    def restore():
        for name, fn in originals.items():
            setattr(ops, name, fn)
        shapes["l1_distance"] = Counter({(1, c, n): k for (c, n), k in shapes["assign_and_lerp"].items()})

    return shapes, restore


def _host_timers():
    """Wrap the main path's layers with host-clock timers (seconds summed
    per layer; nested layers are reported inside their parent). An
    upload's first host sync is ``assign``'s read of the distances, so
    device work still queued from the layers before it is charged there."""
    from repro_torch.core import server as server_mod
    from repro_torch.core.broadcast import BroadcastPredictor
    from repro_torch.core.clustering import DynamicClustering
    from repro_torch.fl.fleet import ClientFleet
    from repro_torch.fl.simulator import Simulator

    spent: Counter = Counter()
    originals = []

    def wrap(owner, attr, bucket):
        fn = getattr(owner, attr)

        def timed(*a, **kw):
            t = time.perf_counter()
            try:
                return fn(*a, **kw)
            finally:
                spent[bucket] += time.perf_counter() - t
        originals.append((owner, attr, fn))
        setattr(owner, attr, timed)

    wrap(server_mod, "pretrain_rnn", "setup: pretrain_rnn")
    wrap(ClientFleet, "train_client", "client: train_client")
    wrap(Simulator, "_evaluate", "client: evaluate_fleet")
    wrap(Simulator, "_set_model", "client: install downlink")
    wrap(server_mod.EchoPFLServer, "handle_upload", "server: handle_upload")
    wrap(DynamicClustering, "assign", "server:   assign (reads the distances)")
    wrap(BroadcastPredictor, "learn", "server:   predictor learn")
    wrap(BroadcastPredictor, "decide", "server:   predictor decide")
    wrap(server_mod.EchoPFLServer, "_refine", "server:   _refine")

    def restore():
        for owner, attr, fn in reversed(originals):
            setattr(owner, attr, fn)

    return spent, restore


def main_path():
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.kernels import ops

    shapes, restore = _record_shapes(ops)
    spent, restore_timers = _host_timers()
    sync()
    ops.reset_launch_counts()
    runs = []
    t0 = time.perf_counter()
    for kw in ({}, {"hm": 1.0}):
        t1 = time.perf_counter()
        _, _, strat, rep = run_experiment("image_recognition", "echopfl", num_clients=20,
                                          max_time=1500, seed=0, device=DEVICE, **kw)
        sync()
        runs.append((kw, strat, rep, time.perf_counter() - t1))
        if strat.clustering.merges > 0:
            break  # a merge happened: merge_attention ran, no second run needed
    wall = time.perf_counter() - t0
    counts = ops.launch_counts()
    restore_timers()
    restore()
    for bucket in sorted(spent):
        print(f"  host time {bucket:<40} {spent[bucket]:8.3f} s ({100 * spent[bucket] / wall:5.1f}%)")
    for kw, strat, rep, secs in runs:
        kinds = Counter(e["kind"] for e in strat.events)
        st = strat.stats()
        print(f"main path {kw or 'default'}: uploads {rep.extra['uploads']}, up {rep.up_events} events / "
              f"{rep.up_bytes} B, down {rep.down_events} events / {rep.down_bytes} B, events {dict(kinds)}, "
              f"clusters {st['clusters']}, merges {st['merges']}, final_acc {rep.final_acc:.4f}, "
              f"wall {secs:.2f} s")
        check(rep.extra["uploads"] > 100, "main path made too few uploads")
        check(0.0 <= rep.final_acc <= 1.0 and all(0.0 <= a <= 1.0 for _, a in rep.curve), "accuracy range")
        for c in strat.clustering.clusters.values():
            v = c.center_vec
            check(v.shape == (25418,) and v.device.type == DEVICE and bool(torch.isfinite(v).all()),
                  "centers must be finite (25418,) rows on the card")
    check(runs[-1][1].clustering.merges > 0, "no run merged: merge_attention never ran")
    check(runs[0][2].final_acc > 0.5, f"default run did not learn: final_acc {runs[0][2].final_acc}")
    uploads = sum(rep.extra["uploads"] for _, _, rep, _ in runs)
    print(f"main path wall time {wall:.2f} s, {uploads} uploads, {uploads / wall:.2f} uploads/s; "
          f"launches {json.dumps(counts)}")
    for name in KERNELS:
        check(counts[name] > 0, f"kernel {name} never launched on the main path")
    rnn = {k: v.cpu().numpy() for k, v in runs[0][1]._rnn_init.items()}  # pretrained broadcast RNN
    return counts, shapes, wall, rnn


# ------------------------------------------------------------------ phase 4
def agreement():
    from repro_torch.configs.paper_tasks import PAPER_TASKS
    from repro_torch.core.broadcast import pretrain_rnn
    from repro_torch.fl.experiment import run_experiment
    from repro_torch.models.mlp import init_mlp

    init = init_mlp(PAPER_TASKS["har"], torch.Generator().manual_seed(0))
    rnn = pretrain_rnn(0, device="cpu")
    out = {}
    for dev in ("cpu", DEVICE):
        _, _, strat, rep = run_experiment("har", "echopfl", num_clients=8, max_time=900, seed=0,
                                          device=dev, init_params=[{k: v.numpy() for k, v in l.items()} for l in init],
                                          rnn_params={k: v.numpy() for k, v in rnn.items()})
        out[dev] = (strat, rep)
    (sc, rc), (sg, rg) = out["cpu"], out[DEVICE]
    for name in ("up_events", "down_events", "up_bytes", "down_bytes"):
        check(getattr(rc, name) == getattr(rg, name), f"agreement: {name} {getattr(rc, name)} != {getattr(rg, name)}")
    check(sc.events == sg.events, "agreement: server event sequences differ")
    check(sc.clustering.assignment == sg.clustering.assignment, "agreement: assignments differ")
    gap = max(abs(a - b) for (_, a), (_, b) in zip(rc.curve, rg.curve))
    check(gap <= 0.02, f"agreement: accuracy curves differ by {gap}")
    print(f"agreement (har, 8 clients, 900 s, card vs CPU plain versions): ledger and "
          f"{len(sg.events)} events identical, accuracy gap {gap:.4f}")


# ------------------------------------------------------------------ phase 5
def call_ms(fn, iters: int = 200, reps: int = 5) -> float:
    """Per-call time of back-to-back calls between two CUDA events: what a
    caller pays per call, the host's launch overhead included."""
    for _ in range(3):
        fn()
    torch.cuda.synchronize()
    per = []
    for _ in range(reps):
        start, end = torch.cuda.Event(enable_timing=True), torch.cuda.Event(enable_timing=True)
        start.record()
        for _ in range(iters):
            fn()
        end.record()
        end.synchronize()
        per.append(start.elapsed_time(end) / iters)
    return statistics.median(per)


def _device_events(prof):
    from torch.autograd import DeviceType

    return [e for e in prof.events() if e.device_type == DeviceType.CUDA]


def _device_us(prof) -> Counter:
    """Device time (us) by kernel name in a profiler trace."""
    per: Counter = Counter()
    for e in _device_events(prof):
        per[e.name] += e.time_range.elapsed_us()
    return per


def device_ms(fn, iters: int = 100) -> float:
    """Device time per call: the summed durations of the kernels one call
    launches, from a ``torch.profiler`` trace (host overhead excluded)."""
    from torch.profiler import ProfilerActivity, profile

    fn()
    torch.cuda.synchronize()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        for _ in range(iters):
            fn()
        torch.cuda.synchronize()
    total = sum(_device_us(prof).values())
    check(total > 0, "the profiler saw no device time")
    return total / iters / 1e3


def bound(nbytes: float, flops: float) -> tuple[float, str]:
    t_bytes, t_ops = nbytes / HBM_BYTES_PER_S, flops / FP32_FLOPS_PER_S
    return max(t_bytes, t_ops) * 1e3, ("bytes" if t_bytes >= t_ops else "operations")


def timing(counts, shapes):
    from repro_torch.kernels import assign_lerp, chi2, l1, merge, ops

    g = gen(11)
    rows = []
    for name, (source, replaces) in KERNELS.items():
        shape = shapes[name].most_common(1)[0][0]
        lib = None
        if name in ("l1_distance", "l1_distance_pairwise"):
            m, c, n = shape
            xs, cs = randn(g, m, n), randn(g, c, n)
            if name == "l1_distance":
                u = xs[0].contiguous()
                fn, plain = (lambda: ops.l1_distance(u, cs)), (lambda: l1.l1_distance_plain(u, cs))
                lib = lambda: torch.cdist(u[None], cs, p=1)  # noqa: E731
            else:
                fn, plain = (lambda: ops.l1_distance_pairwise(xs, cs)), (lambda: l1.l1_distance_pairwise_plain(xs, cs))
                lib = lambda: torch.cdist(xs, cs, p=1)  # noqa: E731
            nbytes, flops = 4 * (m * n + c * n + m * c), 3 * m * c * n
            err = (fn() - plain()).abs().max().item()
        elif name == "assign_and_lerp":
            c, n = shape
            u, cs = randn(g, n), randn(g, c, n)
            fn, plain = (lambda: ops.assign_and_lerp(u, cs, 0.25)), (lambda: assign_lerp.assign_and_lerp_plain(u, cs, 0.25))
            nbytes, flops = 4 * (n + c * n + c + 1 + n), 3 * c * n + c + 3 * n
            a, b = fn(), plain()
            err = max((a[0] - b[0]).abs().max().item(), (a[2] - b[2]).abs().max().item())
        elif name in ("chi2_feedback", "chi2_feedback_segmented"):
            m, j = shape[:2]
            fp = torch.rand((m, j), generator=g, device=DEVICE) * 30
            ft = torch.rand((m, j), generator=g, device=DEVICE) * 30 + 1.0
            ss = torch.softmax(randn(g, m, j), dim=-1)
            nbytes, flops = 4 * (3 * m * j + m), 9 * m * j
            if name == "chi2_feedback":
                fn, plain = (lambda: ops.chi2_feedback(fp, ft, ss)), (lambda: chi2.chi2_feedback_plain(fp, ft, ss))
                err = (fn() - plain()).abs().max().item()
            else:
                s = shape[2]
                seg = torch.arange(m, device=DEVICE, dtype=torch.int32) % s
                fn = lambda: ops.chi2_feedback_segmented(fp, ft, ss, seg, s)  # noqa: E731
                plain = lambda: chi2.chi2_feedback_segmented_plain(fp, ft, ss, seg, s)  # noqa: E731
                nbytes += 4 * (m + s)
                flops += m
                a, b = fn(), plain()
                err = max((a[0] - b[0]).abs().max().item(), (a[1] - b[1]).abs().max().item())
        else:  # merge_attention
            (n,) = shape
            vm, va, vt = randn(g, n), randn(g, n), randn(g, n)
            fn, plain = (lambda: ops.merge_attention(vm, va, vt)), (lambda: merge.merge_attention_plain(vm, va, vt))
            nbytes, flops = 4 * 4 * n, 10 * n
            err = (fn() - plain()[0]).abs().max().item()
        bound_ms, bound_by = bound(nbytes, flops)
        row = {
            "name": name, "route": "cuda", "source": source, "replaces": replaces,
            "launches": counts[name], "max_abs_err": err,
            "ms": device_ms(fn), "plain_ms": device_ms(plain), "bound_ms": bound_ms, "bound_by": bound_by,
            "library_ms": None if lib is None else device_ms(lib),
            "call_ms": call_ms(fn), "plain_call_ms": call_ms(plain),
            "library_call_ms": None if lib is None else call_ms(lib),
            "shape": list(shape),
        }
        rows.append(row)
        print(f"timing {name} at {tuple(shape)}: device time kernel {row['ms']:.5f} ms, plain "
              f"{row['plain_ms']:.5f} ms, library " + ("n/a" if lib is None else f"{row['library_ms']:.5f} ms")
              + f"; bound {bound_ms:.6f} ms ({bound_by}); per call kernel {row['call_ms']:.4f} ms, plain "
              f"{row['plain_call_ms']:.4f} ms, library "
              + ("n/a" if lib is None else f"{row['library_call_ms']:.4f} ms")
              + f"; max_abs_err {err:.3g}")
    return rows


# ------------------------------------------------------------------ phase 6
def profile_main_path(rnn_params: dict):
    """The main path's steady state under ``torch.profiler`` (CUDA activity
    only): a 300 s image_recognition run, the broadcast RNN handed over so
    that pretraining stays outside the window. Device busy time is the sum
    of kernel durations (one stream, so they do not overlap); the idle
    share is the rest of the window's host wall time."""
    from torch.profiler import ProfilerActivity, profile

    from repro_torch.fl.experiment import run_experiment

    sync()
    with profile(activities=[ProfilerActivity.CUDA]) as prof:
        t0 = time.perf_counter()
        _, _, strat, rep = run_experiment("image_recognition", "echopfl", num_clients=20, max_time=300,
                                          seed=0, device=DEVICE, rnn_params=rnn_params)
        sync()
        wall = time.perf_counter() - t0
    per = _device_us(prof)
    busy = sum(per.values()) / 1e6
    check(busy > 0, "the profiler saw no device time on the main path")
    ours = sum(v for k, v in per.items() if any(n in k for n in PORT_KERNEL_NAMES)) / 1e6
    n_kernels = len(_device_events(prof))
    print(f"profile (image_recognition, 20 clients, 300 s, {rep.extra['uploads']} uploads): wall {wall:.3f} s "
          f"under the profiler, device busy {busy:.4f} s, idle share {1 - busy / wall:.4f}, "
          f"{n_kernels} kernels; the port's CUDA kernels {ours:.5f} s ({100 * ours / busy:.2f}% of busy)")
    for name, us in per.most_common(12):
        print(f"  device time {us / 1e3:10.3f} ms ({100 * us / 1e6 / busy:5.1f}%)  {name[:110]}")


def main() -> int:
    if not torch.cuda.is_available():
        print("chip_smoke: CUDA is not available; this script needs an NVIDIA GPU", file=sys.stderr)
        return 2
    sys.path.insert(0, str(ROOT / "src"))
    from repro_torch.common.device import resolve_device

    resolve_device("cuda")  # TF32 off, fp32 throughout
    t0 = time.perf_counter()
    smi = probe()
    kernel_phase()
    counts, shapes, _, rnn_params = main_path()
    agreement()
    rows = timing(counts, shapes)
    profile_main_path(rnn_params)
    print(f"total {time.perf_counter() - t0:.1f} s")
    print(json.dumps({"kernels": rows}))
    print(f"card: {smi}")
    print(json.dumps({"ok": True, "device": {"platform": "gpu", "kind": torch.cuda.get_device_name(0),
                                             "count": torch.cuda.device_count()}}))
    return 0


if __name__ == "__main__":
    sys.exit(main())
