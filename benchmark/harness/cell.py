"""One run of one cell: set-up, the measured window, the traced stretch,
the correctness check and the metrics, as one result dict."""

from __future__ import annotations

import gc
import subprocess
import sys
import time
import types

from benchmark.harness import judge as judge_mod
from benchmark.harness import loop as loop_mod
from benchmark.harness import spec as spec_mod
from benchmark.harness import trace as trace_mod
from benchmark.harness import traffic as traffic_mod
from benchmark.harness.program import Program, state_tensors


def power_line() -> str:
    """The card's name and power limit, as nvidia-smi reports them."""
    try:
        out = subprocess.run(["nvidia-smi", "--query-gpu=name,power.limit",
                              "--format=csv,noheader"], capture_output=True, text=True,
                             timeout=30)
    except (OSError, subprocess.SubprocessError):
        return "nvidia-smi unavailable"
    return out.stdout.strip().splitlines()[0] if out.stdout.strip() else "nvidia-smi: no output"


def run(c: dict, bench: dict, seed: int, seconds: float, trace: bool, device,
        t_start: float, log=lambda s: print(s, file=sys.stderr), control=None) -> dict:
    """Run cell `c` (spec.cell) once. Returns the result line's dict, the
    check lines for standard error and the judged frames' rows
    (judge.Judge.readings). With `control` (a dtype), the reference
    computed in that precision is also judged in the program's place."""
    import torch

    config, params = c["config"], c["traffic"]
    render = dict(config["render"], **params.get("render", {}))
    out_w, out_h = int(render["out_w"]), int(render["out_h"])
    dt = float(params["dt"])
    scene = spec_mod.scene_generator(config["scene"]["kind"]).build(config["scene"]["params"])
    traffic = traffic_mod.Traffic(params, scene, out_w, out_h, seed)
    render["rng_salt"] = traffic.rng_salt

    prog = Program(scene, config["scene"]["build"], render, out_w, out_h, traffic.pose(0),
                   device)
    loop = loop_mod.Loop(prog, traffic, dt, int(params["judge_frames"]),
                         traffic_mod.seed_rng(seed, 1))
    warm = loop.warm_up(int(params["warmup_frames"]))
    cuda = torch.device(device).type == "cuda"
    if cuda:
        torch.cuda.synchronize()
    setup_s = time.perf_counter() - t_start
    in_w, in_h = prog.internal_size
    n_tris = prog.n_tris

    loop.sync_updates = trace
    window = loop.window(seconds)
    loop.sync_updates = False
    profile, profiled = None, []
    if trace:
        frames = int(params["profile_frames"])
        prof, profiled = loop.profiled(frames)
        profile = trace_mod.read(prof, frames)
    if cuda:
        torch.cuda.synchronize()
        peak = int(torch.cuda.max_memory_allocated(device))
    else:
        peak = 0
    log(f"set-up {setup_s:.4f} s; window {len(window.done)} frames presented of "
        f"{window.issued} issued; internal {in_w}x{in_h}; {n_tris} triangles; "
        f"memory peak {peak} B")

    # the program's state goes before the reference runs, but for the
    # states of the judged frames
    steps = loop.kept + profiled
    loop.inflight = None
    loop.prog = None
    del prog
    gc.collect()
    if cuda:
        torch.cuda.empty_cache()
        torch.cuda.reset_peak_memory_stats(device)
    t_j = time.perf_counter()
    j = judge_mod.Judge(scene, traffic, render, out_w, out_h, dt, device)
    jc = None if control is None else judge_mod.Judge(scene, traffic, render, out_w, out_h,
                                                      dt, device, round_to=control)
    rows = j.readings(warm, steps, state_tensors, jc)
    for r in rows:
        log(f"judged frame {r['k']} (counter {r['counter']}"
            f"{', chain' if r['chain'] else ''}): "
            + ", ".join(f"{k} {v!r}" for k, v in r["program"].items()))
    ref_peak = int(torch.cuda.max_memory_allocated(device)) if cuda else 0
    log(f"reference: {len(rows)} frames in {time.perf_counter() - t_j:.4f} s; "
        f"memory peak {ref_peak} B")

    limits = params["checks"]
    named = [judge_mod.numbers(r) for r in rows]
    numbers = judge_mod.worst(named)
    failed = sum(any(r[k] > limits[k] for k in r if k in limits) for r in named)
    correct = failed == 0 and all(k in numbers for k in limits)

    lanes = [j.lanes[s.k] for s in profiled]
    ctx = types.SimpleNamespace(
        setup_s=setup_s, window=window, profile=profile, in_w=in_w, in_h=in_h,
        n_tris=n_tris, kernel_classes=spec_mod.kernel_classes(),
        live_lanes=tuple(map(sum, zip(*lanes))) if lanes else None)
    metrics = {}
    for m in spec_mod.metrics_of(bench, c["name"], trace):
        value = spec_mod.metric_reader(m["name"]).read(ctx)
        if value is not None:
            metrics[m["name"]] = {"value": float(value), "unit": m["unit"]}
    dev = {"platform": "gpu" if cuda else str(device),
           "kind": torch.cuda.get_device_name(0) if cuda else str(device),
           "count": int(c["entry"]["chips"]), "memory_peak_bytes": peak}
    line = {"correct": bool(correct), "attempted": window.issued, "failed": failed,
            "metrics": metrics, "device": dev}
    if profile is not None:
        dev["busy_s"] = profile.busy_us() * 1e-6
        dev["window_s"] = profile.window_us * 1e-6
        line["breakdown"] = profile.breakdown()
    checks = {k: {"value": numbers.get(k), "limit": limits[k]} for k in limits}
    line["checks"] = checks
    log(f"card: {power_line() if cuda else device}")
    check_lines = [f"check {k}: {v['value']!r} (limit {v['limit']!r})" for k, v in checks.items()]
    return dict(line=line, check_lines=check_lines, rows=rows)
