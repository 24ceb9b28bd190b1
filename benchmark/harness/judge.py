"""Whether what the timed path produced is right: the program's frames
against the reference's (`benchmark/reference`), at the timed size.

Two kinds of judged frame, both rendered and presented by the program:
- The warm-up frames, as a chain: the reference renders them in order from
  an empty state, carrying its own state from frame to frame, so a chain
  of steps is checked with nothing taken from the program but its frames.
- Window frames (a seeded sample) and, in a traced run, the profiled
  frames, each as one step: the reference renders it from the state the
  program carried into it, so a fault in any frame of the window can show.

The reference gets the same inputs as the program: the scene's vertices,
the camera and the previous camera, the renderer's frame counter and
noise key, the sun. Each judged frame is compared in its presented pixels
and in the state it hands on: the reservoirs, the TAA history and the
progressive accumulation.

Numbers, each the worst over its frames; chain frames give the `chain_`
ones:
- `frame_bad_pct`: share of the presented pixels with a channel more than
  `LEVELS` steps of 255 away from the reference's.
- `state_bad_pct`: the largest of three shares: pixels whose handed-on
  reservoir differs (a count or light kind, or a float beyond
  `RTOL` * |value| + `ATOL`), output pixels whose TAA history or its
  object id differs (as above), low-res pixels whose accumulation differs.
"""

from __future__ import annotations

import math
import random

import numpy as np
import torch

from benchmark.reference import frame as ref
from benchmark.reference import ops as rops

LEVELS = 2
RTOL, ATOL = 1e-4, 1e-5
NOISE_SEED = 0x5EED  # the renderer's noise-key stream


def noise_key(counter: int, lock_noise: int) -> int:
    """The renderer's noise key of its `counter`-th frame."""
    if lock_noise == 0:
        return 0
    rng = random.Random(NOISE_SEED)
    key = 0
    for _ in range(counter + 1):
        key = rng.getrandbits(32) | 1
    return key


def sun_dir(render: dict, counter: int, dt: float) -> np.ndarray:
    az = float(render["sun_azimuth"])
    for _ in range(counter + 1):
        az = rops.advance_sun_azimuth(az, float(render["sun_speed_rad_per_sec"]), dt)
    return rops.sun_direction(az, float(render["sun_elevation"]))


def to_state(t: dict, swap: bool) -> ref.State:
    res = lambda d: ref.Res(**d)
    a, b = res(t["res_prev"]), res(t["res_cur"])
    if swap:
        a, b = b, a
    return ref.State(res_prev=a, res_cur=b, taa_color=t["taa_color"], taa_obj=t["taa_obj"],
                     taa_valid=t["taa_valid"], accum=t["accum"], accum_count=t["accum_count"])


def _channels(p: torch.Tensor) -> torch.Tensor:
    p = p.to(torch.int64)
    return torch.stack([(p >> 16) & 255, (p >> 8) & 255, p & 255], dim=-1)


def pixels_off(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    """Per pixel: a channel of packed a and b more than LEVELS apart."""
    return ((_channels(a) - _channels(b)).abs() > LEVELS).any(dim=-1)


def _far(a: torch.Tensor, b: torch.Tensor) -> torch.Tensor:
    bad = (a - b).abs() > RTOL * torch.maximum(a.abs(), b.abs()) + ATOL
    bad = bad | (torch.isnan(a) != torch.isnan(b))
    return bad.reshape(bad.shape[0], -1).any(dim=1)


def compare(got_frame, got_state: dict, want_frame, want: ref.State) -> dict:
    """The numbers of one judged frame (percentages)."""
    dev = want_frame.device
    pct = lambda m: 100.0 * float(m.to(torch.float32).mean())
    res_bad = torch.zeros_like(want.res_cur.m, dtype=torch.bool)
    for k in ref.RES_FIELDS:
        g, w = got_state["res_cur"][k].to(dev), getattr(want.res_cur, k)
        res_bad |= (g != w) if k in ("m", "light_id") else _far(g.float(), w)
    hist_bad = (pixels_off(got_state["taa_color"].to(dev), want.taa_color)
                | (got_state["taa_obj"].to(dev) != want.taa_obj))
    accum_bad = _far(got_state["accum"].to(dev), want.accum)
    if got_state["accum_count"] != want.accum_count:
        accum_bad = torch.ones_like(accum_bad)
    return {"frame_bad_pct": pct(pixels_off(got_frame.to(dev), want_frame)),
            "state_bad_pct": max(pct(res_bad), pct(hist_bad), pct(accum_bad))}


def advance(st: ref.State) -> ref.State:
    """The state the next frame starts from: the reservoirs swapped."""
    return to_state(ref_state_tensors(st), swap=True)


class Judge:
    """Renders reference frames for one cell and compares them."""

    def __init__(self, spec: dict, traffic, render: dict, out_w: int, out_h: int,
                 dt: float, device, round_to=None):
        self.spec, self.traffic, self.render = spec, traffic, render
        self.out_w, self.out_h, self.dt, self.device = out_w, out_h, dt, device
        self.round_to = round_to
        self.s = dict(render, rng_salt=traffic.rng_salt)
        self._scene = None  # the reference scene of a static scene, built once
        self.lanes: dict[int, tuple[int, int]] = {}  # k -> live (closest, any-hit) lanes

    def scene(self, k: int) -> ref.Scene:
        pos = self.traffic.positions(k)
        if pos is None and self._scene is not None:
            return self._scene
        spec = self.spec if pos is None else dict(
            self.spec, mesh=dict(self.spec["mesh"], positions=pos))
        sc = ref.make_scene(spec, self.device, self.round_to)
        if pos is None:
            self._scene = sc
        return sc

    def frame(self, k: int, counter: int, state: ref.State):
        """The reference's frame k and the state it hands on."""
        cam = rops.look_at(*self.traffic.pose(k))
        prev = rops.look_at(*self.traffic.pose(max(k - 1, 0)))
        moved = k == 0 or rops.camera_moved(cam, prev)
        tr = ref.Tracer(self.scene(k), self.round_to)
        with torch.no_grad():
            out = ref.render_frame(
                self.s, tr, cam, prev, state, counter,
                noise_key(counter, int(self.render["rng_lock_noise"])),
                sun_dir(self.render, counter, self.dt), moved, self.out_w, self.out_h,
                lowp_color=self.round_to)
        self.lanes[k] = (tr.closest_lanes, tr.anyhit_lanes)
        return out

    def empty_state(self) -> ref.State:
        in_w, in_h = ref.internal_resolution(self.s, self.out_w, self.out_h)
        return ref.State.empty(in_w * in_h, self.out_w * self.out_h, self.device)

    def chain(self, samples) -> list:
        """(frame, state) of each of `samples` (consecutive frames from the
        first), the reference carrying its own state from an empty one."""
        st, out = self.empty_state(), []
        for s in samples:
            f, post = self.frame(s.k, s.counter, st)
            out.append((f, post))
            st = advance(post)
        return out

    def readings(self, chain, steps, state_tensors, control=None) -> list[dict]:
        """One row per judged frame: the chain of `chain` Samples, then each
        of `steps` from the state the program carried into it. A row holds
        the program's numbers and, with a `control` Judge in the program's
        place (its own chain, the same start states), the control's."""
        rows = []
        want = self.chain(chain)
        alt = control.chain(chain) if control is not None else None
        for i, (s, w) in enumerate(zip(chain, want)):
            row = dict(k=s.k, counter=s.counter, chain=True,
                       program=compare(s.presented, state_tensors(s.post), *w))
            if alt is not None:
                row["control"] = compare(alt[i][0], ref_state_tensors(alt[i][1]), *w)
            rows.append(row)
        del want, alt
        for s in steps:
            pre = to_state(state_tensors(s.pre), swap=True)
            w = self.frame(s.k, s.counter, pre)
            row = dict(k=s.k, counter=s.counter, chain=False,
                       program=compare(s.presented, state_tensors(s.post), *w))
            if control is not None:
                got = control.frame(s.k, s.counter, pre)
                row["control"] = compare(got[0], ref_state_tensors(got[1]), *w)
            rows.append(row)
        return rows


def numbers(row: dict, side: str = "program") -> dict:
    """A row's numbers by their check names (`chain_` for chain frames)."""
    return {("chain_" if row["chain"] else "") + k: v for k, v in row[side].items()}


def worst(readings: list[dict]) -> dict:
    out: dict[str, float] = {}
    for r in readings:
        for k, v in r.items():
            out[k] = max(out.get(k, -math.inf), v)
    return out


def ref_state_tensors(st: ref.State) -> dict:
    """A reference State in the form `compare` reads a program's state."""
    res = lambda r: {k: getattr(r, k) for k in ref.RES_FIELDS}
    return dict(res_prev=res(st.res_prev), res_cur=res(st.res_cur), taa_color=st.taa_color,
                taa_obj=st.taa_obj, taa_valid=st.taa_valid, accum=st.accum,
                accum_count=st.accum_count)
