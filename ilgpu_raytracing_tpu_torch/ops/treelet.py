"""Treelet-binned closest-hit traversal: the orchestration of the treelet
rounds K7 (ops/cuda/treelet.py) and K8 (ops/cuda/streamtreelet.py), the
port of the JAX package's ops/treelet.py.

Scheme (one sort, then rounds without re-sorting), as in the JAX package:
1. slab phase: the entry t of every ray into every treelet's box, (N, T);
2. rays counting-sort once by their nearest treelet (K3 with T+1 bins, dead
   and uncovered lanes in the tail bin);
3. visit rounds in sorted order: each pending lane picks its nearest
   unvisited treelet with entry t below its running t_best, each packet of
   tile_rows * 128 consecutive lanes ORs its lanes' picks into an i32 want
   mask, and one K7/K8 round walks each lane through its packet's mask with
   t_max = its running t_best. Every masked treelet is then marked visited
   for every pending lane of the packet. The packet is a parameter of the
   result, not a hardware tile: it decides the masks and the round count;
4. a lane resolves when no unvisited treelet's entry t beats its t_best;
   the packed (t, pp) record is restored to the caller's lane order.

The JAX package loops with `lax.while_loop`; here it is a Python loop whose
condition reads one bool back from the device per round (at most T = 32
rounds). The (t, pp) record moves through the sort as separate f32 and i32
gathers.
"""

from __future__ import annotations

import torch

from ilgpu_raytracing_tpu_torch.ops.cuda import stream as stream_mod
from ilgpu_raytracing_tpu_torch.ops.cuda import streamtreelet as stl
from ilgpu_raytracing_tpu_torch.ops.cuda import treelet as tl
from ilgpu_raytracing_tpu_torch.ops.cuda import wide
from ilgpu_raytracing_tpu_torch.ops.intersect import T_EPS
from ilgpu_raytracing_tpu_torch.ops.sort import _perm_from_key

_INF = float("inf")


def _slab_tlo_tables(meta, inst_spans, t_bounds, o, d, t_cap):
    """(N, T) conservative entry t of each ray into each treelet's
    object-space box; +inf where the slab misses or the lane is inactive
    (t_cap == 0): lo clamped to T_EPS, accepted when hi >= lo and
    lo <= t_cap."""
    n = o.shape[0]
    cols = []
    for mi, start, end in inst_spans:
        w2o = meta[mi][2]
        if wide._is_identity(w2o):
            oo, dd = o, d
        else:
            m = torch.tensor(w2o, dtype=torch.float32, device=o.device).reshape(3, 4)
            oo = o @ m[:, 0:3].T + m[:, 3]
            dd = d @ m[:, 0:3].T
        inv = 1.0 / torch.where(dd != 0.0, dd, torch.full_like(dd, 1e-8))
        b = t_bounds[start:end]
        lo = torch.full((n, end - start), T_EPS, dtype=torch.float32, device=o.device)
        hi = torch.full_like(lo, _INF)
        for ax in range(3):
            t1 = (b[None, :, ax] - oo[:, None, ax]) * inv[:, None, ax]
            t2 = (b[None, :, 3 + ax] - oo[:, None, ax]) * inv[:, None, ax]
            lo = torch.maximum(lo, torch.minimum(t1, t2))
            hi = torch.minimum(hi, torch.maximum(t1, t2))
        ok = (hi >= lo) & (lo <= t_cap[:, None])
        cols.append(torch.where(ok, lo, torch.full_like(lo, _INF)))
    return torch.cat(cols, dim=1)


def _as_i32(x):
    """int64 bit patterns of 32-bit masks as int32 (bit 31 = sign)."""
    return torch.where(x >= 2 ** 31, x - 2 ** 32, x).to(torch.int32)


def _packet_masks(bits, tile_rows: int, n_treelets: int):
    """OR of the lanes' i32 bit masks over each packet of tile_rows * 128
    consecutive lanes (the tail packet padded with zeros): (packets,) i32."""
    tile = tile_rows * tl.LANES
    n = bits.shape[0]
    g = -(-n // tile)
    padded = torch.zeros((g * tile,), dtype=torch.int64, device=bits.device)
    padded[:n] = bits.to(torch.int64) & 0xFFFFFFFF
    padded = padded.reshape(g, tile)
    mask = torch.zeros((g,), dtype=torch.int64, device=bits.device)
    for k in range(n_treelets):
        mask |= ((padded >> k) & 1).amax(dim=1) << k
    return _as_i32(mask)


def _nearest_sort(meta, spans, bounds, o, d, t_max, n_treelets):
    """Sort key = nearest treelet by slab entry (T for lanes that enter
    none); returns (perm, pos, per-lane slab table in caller order)."""
    t_lo = _slab_tlo_tables(meta, spans, bounds, o, d, t_max)
    key = torch.where(torch.isfinite(t_lo.amin(dim=1)),
                      torch.argmin(t_lo, dim=1).to(torch.int32), n_treelets)
    perm, pos = _perm_from_key(key, n_treelets + 1)
    return perm.long(), pos.long(), t_lo


def _rounds(meta, spans, bounds, n_treelets, run_round, cleanup, o, d, t_max,
            tile_rows, max_rounds, with_rounds, cleanup_after):
    """The visit rounds of trace_closest_treelet(_stream)_packed."""
    n = o.shape[0]
    perm, pos, _ = _nearest_sort(meta, spans, bounds, o, d, t_max, n_treelets)
    o_s, d_s, tm_s = o[perm], d[perm], t_max[perm]
    # sorted-domain slab (recomputed rather than gathered through perm)
    t_lo = _slab_tlo_tables(meta, spans, bounds, o_s, d_s, tm_s)
    r_cap = n_treelets if max_rounds is None else min(max_rounds, n_treelets)
    if cleanup_after is not None:
        r_cap = min(r_cap, cleanup_after)
    karange = torch.arange(n_treelets, device=o.device)
    t_best = tm_s.clone()
    pp_s = torch.full((n,), -1, dtype=torch.int32, device=o.device)
    it = 0
    # one device->host read per round for the loop condition, <= T rounds
    while it < r_cap and bool((t_lo.amin(dim=1) < t_best).any()):
        cand = torch.where(t_lo < t_best[:, None], t_lo, torch.full_like(t_lo, _INF))
        cmin = cand.amin(dim=1)
        tid = torch.argmin(cand, dim=1)
        pending = cmin < t_best
        bit = torch.where(pending, torch.ones_like(tid) << tid, torch.zeros_like(tid))
        mask = _packet_masks(bit, tile_rows, n_treelets)
        t_r, pp_r = run_round(mask, o_s, d_s,
                              torch.where(pending, t_best, torch.zeros_like(t_best)))
        improved = pp_r >= 0
        t_best = torch.where(improved, t_r, t_best)
        pp_s = torch.where(improved, pp_r, pp_s)
        # every masked treelet completed for every pending lane of the packet
        lane_mask = tl.lane_masks(mask, n, tile_rows)
        vis = ((lane_mask[:, None] >> karange[None, :]) & 1) != 0
        t_lo = torch.where(vis & pending[:, None], torch.full_like(t_lo, _INF), t_lo)
        it += 1
    if cleanup_after is not None and max_rounds is None:
        pend = t_lo.amin(dim=1) < t_best
        t_c, pp_c = cleanup(o_s, d_s, torch.where(pend, t_best, torch.zeros_like(t_best)))
        improved = pp_c >= 0
        t_best = torch.where(improved, t_c, t_best)
        pp_s = torch.where(improved, pp_c, pp_s)
    t_out, pp_out = t_best[pos], pp_s[pos]
    if with_rounds:
        return t_out, pp_out, it
    return t_out, pp_out


def _check_t(n_treelets: int) -> None:
    if n_treelets > tl.MAX_TREELETS:
        raise ValueError(f"{n_treelets} treelets: the want mask is one i32 "
                         f"(prepare with <= {tl.MAX_TREELETS})")


def trace_closest_treelet_single(ts: tl.TreeletScene, o, d, active=None, t_max=None,
                                 tile_rows: int = tl.TILE_ROWS):
    """Single-dispatch treelet trace: every lane's want mask carries all
    treelets whose slab entry beats its t_max, packets OR them, and one K7
    round walks each packet through its mask. Packed (t, pp) in the
    caller's lane order."""
    _check_t(ts.n_treelets)
    t_max = wide._lane_t_max(o, t_max, active)
    n_t = ts.n_treelets
    perm, pos, t_lo_u = _nearest_sort(ts.wscene.meta, ts.inst_spans, ts.t_bounds,
                                      o, d, t_max, n_t)
    karange = torch.arange(n_t, device=o.device)
    bits = (torch.isfinite(t_lo_u).long() << karange[None, :]).sum(dim=1)
    mask = _packet_masks(bits[perm], tile_rows, n_t)
    t_r, pp_r = tl.run_treelet_trace(ts, mask, o[perm], d[perm], t_max[perm], tile_rows)
    return t_r[pos], pp_r[pos]


def trace_closest_treelet_packed(ts: tl.TreeletScene, o, d, active=None, t_max=None,
                                 tile_rows: int = tl.TILE_ROWS,
                                 max_rounds: int | None = None,
                                 with_rounds: bool = False,
                                 cleanup_after: int | None = None):
    """Packed (t, pp) closest trace via K7 treelet rounds, in the caller's
    lane order; miss / inactive semantics as trace_closest_wide_packed.

    `cleanup_after=k` runs k rounds, then resolves the pending lanes with
    one K1 dispatch at t_max = their running t_best (exact either way).
    `max_rounds` caps the rounds (diagnostic: results are incomplete when
    it fires); `with_rounds` also returns the number of rounds run."""
    _check_t(ts.n_treelets)
    t_max = wide._lane_t_max(o, t_max, active)
    return _rounds(
        ts.wscene.meta, ts.inst_spans, ts.t_bounds, ts.n_treelets,
        lambda mask, oo, dd, tm: tl.run_treelet_trace(ts, mask, oo, dd, tm, tile_rows),
        lambda oo, dd, tm: wide.trace_closest_wide_packed(ts.wscene, oo, dd, t_max=tm),
        o, d, t_max, tile_rows, max_rounds, with_rounds, cleanup_after)


def trace_closest_treelet_stream_packed(sts: stl.StreamTreeletScene, o, d, active=None,
                                        t_max=None, tile_rows: int | None = None,
                                        max_rounds: int | None = None,
                                        with_rounds: bool = False,
                                        cleanup_after: int | None = None):
    """The rounds of trace_closest_treelet_packed over a streaming scene
    (K8 rounds; the cleanup dispatch is K4). Packed (t, pp) with the 23-bit
    prim record, in the caller's lane order."""
    _check_t(sts.n_treelets)
    tile_rows = stl.TILE_ROWS if tile_rows is None else tile_rows
    t_max = wide._lane_t_max(o, t_max, active)
    s = sts.sscene
    return _rounds(
        s.meta, sts.inst_spans, sts.t_bounds, sts.n_treelets,
        lambda mask, oo, dd, tm: stl.run_treelet_stream_trace(sts, mask, oo, dd, tm,
                                                             tile_rows),
        lambda oo, dd, tm: stream_mod.trace_closest_stream_packed(s, oo, dd, t_max=tm),
        o, d, t_max, tile_rows, max_rounds, with_rounds, cleanup_after)


def trace_closest_treelet_stream(sts: stl.StreamTreeletScene, o, d, active=None,
                                 t_max=None, tile_rows: int | None = None):
    """HitRecord stream treelet trace (rounds + the K4 decode epilogue)."""
    t, pp = trace_closest_treelet_stream_packed(sts, o, d, active=active, t_max=t_max,
                                                tile_rows=tile_rows)
    return stream_mod.decode_stream_hits(sts.sscene, o, d, t, pp)


def trace_closest_treelet(ts: tl.TreeletScene, o, d, active=None, t_max=None,
                          tile_rows: int = tl.TILE_ROWS):
    """HitRecord closest trace (treelet rounds + the K1 decode epilogue)."""
    t, pp = trace_closest_treelet_packed(ts, o, d, active=active, t_max=t_max,
                                         tile_rows=tile_rows)
    return wide.decode_wide_hits(ts.wscene, o, d, t, pp)
