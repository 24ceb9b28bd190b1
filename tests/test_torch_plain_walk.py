"""The plain BLAS walk's leaf fold (ops/traverse._blas_walk) against a
per-slot loop, exactly.

`_blas_walk` tests every slot of the hit leaves in one (lanes, leaf_max)
batch and folds it: the closest hit takes the first slot holding the
leaf's least t (`torch.min` returns the first index of a tie), kept where
it beats the lane's best with a strict `<`; any-hit ORs the slots. The
reference here, `_slot_loop_walk`, tests the slots one at a time in slot
order, which is the kernels' order. Every plain version of K1/K2/K4-K8
walks through `_blas_walk`, so the fold must equal the loop bit for bit.

The scenes force what the fold has to get right: every triangle (and
sphere) is present twice, so every hit is an exact t tie between two
primitives of one leaf; leaves hold fewer primitives than `leaf_max`, and
the slots past a leaf's count hold another instance's primitives; and
one scene carries an alpha mask with texels inside the any-hit band, so
slots drop out of the fold by the closest-hit rule or by the band.
"""

import numpy as np
import pytest
import torch

from ilgpu_raytracing_tpu_torch.models.materials import Material
from ilgpu_raytracing_tpu_torch.models.scene import SceneBuilder, translation_affine
from ilgpu_raytracing_tpu_torch.ops import traverse
from ilgpu_raytracing_tpu_torch.ops.intersect import T_EPS, T_INF, intersect_aabb
from ilgpu_raytracing_tpu_torch.ops.traverse import KIND_TRI
from ilgpu_raytracing_tpu_torch.utils import vec

torch.set_num_threads(1)


def _slot_loop_walk(scene, o_obj, d_obj, start_cur, t_max0, kind, any_hit):
    """`_blas_walk`'s contract, one leaf slot at a time in slot order."""
    n = o_obj.shape[0]
    inv_obj = vec.inv_dir(d_obj)
    alpha = scene.has_alpha and kind == KIND_TRI
    if any_hit:
        state = [torch.zeros((n,), dtype=torch.bool)]
    else:
        state = [torch.minimum(torch.full((n,), T_INF), t_max0),
                 torch.full((n,), -1, dtype=torch.int32), torch.zeros((n,)),
                 torch.zeros((n,))]
    out = [s.clone() for s in state]
    lanes = torch.nonzero(start_cur >= 0).squeeze(1)
    cur = start_cur[lanes]
    o, d, inv, tlim = o_obj[lanes], d_obj[lanes], inv_obj[lanes], t_max0[lanes]
    live = [s[lanes] for s in state]
    while lanes.numel() > 0:
        ifl = scene.blas_ifields[cur]
        left, first, count, skip = ifl[:, 0], ifl[:, 1], ifl[:, 2], ifl[:, 3]
        hit_box = intersect_aabb(o, inv, scene.blas_bmin[cur], scene.blas_bmax[cur],
                                 T_EPS, tlim if any_hit else live[0])
        is_leaf = count > 0
        sub = torch.nonzero(hit_box & is_leaf).squeeze(1)
        if sub.numel() > 0:
            so, sd, sfirst, scount = o[sub], d[sub], first[sub], count[sub]
            acc = [s[sub] for s in live]
            for i in range(scene.blas_leaf_max):
                prim, ok, t, bu, bv = traverse._leaf_test(scene, kind, sfirst + i, so, sd)
                if alpha:
                    ok = ok & traverse._tri_alpha_pass(scene, prim, bu, bv,
                                                       closest=not any_hit)
                valid = (i < scount) & ok & (t > T_EPS)
                if any_hit:
                    acc[0] = acc[0] | (valid & (t < tlim[sub]))
                else:
                    accept = valid & (t < acc[0])
                    acc = [torch.where(accept, v, a) for a, v in zip(acc, (t, prim, bu, bv))]
            for s, a in zip(live, acc):
                s[sub] = a
        nxt = torch.where(hit_box, torch.where(is_leaf, skip, left), skip)
        if any_hit:
            nxt = torch.where(live[0], torch.full_like(nxt, -1), nxt)
        done = nxt < 0
        for s_out, s in zip(out, live):
            s_out[lanes[done]] = s[done]
        keep = ~done
        lanes, cur = lanes[keep], nxt[keep]
        o, d, inv, tlim = o[keep], d[keep], inv[keep], tlim[keep]
        live = [s[keep] for s in live]
    if any_hit:
        return out[0]
    t_obj, prim, bu, bv = out
    return torch.where(prim >= 0, t_obj, torch.full_like(t_obj, T_INF)), prim, bu, bv


def _scene(kind, rs):
    """Two instances of different random primitives, each primitive present
    twice (ids 2k and 2k + 1), leaf 8."""
    b = SceneBuilder(blas_leaf_size=8)
    if kind == "alpha":
        mask = np.repeat(rs.randint(0, 256, (8, 8, 1)), 4, axis=2).astype(np.uint8)
        b.add_material(Material())
        b.add_material(Material(alpha_tex=b.add_texture_rgba(mask), alpha_cutoff=0.5))
    for shift in (-0.4, 0.4):
        o2w = translation_affine((shift, 0.0, 0.0))
        if kind == "spheres":
            c = rs.uniform(-1.0, 1.0, (21, 3))
            r = rs.uniform(0.05, 0.25, 21)
            b.add_sphere_instance([b.add_sphere(c[i // 2], r[i // 2]) for i in range(42)],
                                  o2w)
            continue
        t = 45
        pos = rs.uniform(-1.0, 1.0, (3 * t, 3)).astype(np.float32)
        pos[1::3] = pos[0::3] + rs.uniform(-0.5, 0.5, (t, 3))
        pos[2::3] = pos[0::3] + rs.uniform(-0.5, 0.5, (t, 3))
        idx = np.repeat(np.arange(3 * t, dtype=np.int32).reshape(t, 3), 2, axis=0)
        uvs = mat = None
        if kind == "alpha":
            uvs = np.repeat(rs.uniform(0.0, 1.0, (t, 3, 2)).astype(np.float32), 2, axis=0)
            mat = np.repeat((rs.rand(t) < 0.7).astype(np.int32), 2)
        b.add_mesh_instance(pos, idx, tri_uvs=uvs, tri_mat=mat, object_to_world=o2w)
    return b.commit("cpu")


def _rays(rs, n=6000):
    o = rs.uniform(-1.6, 1.6, (n, 3)).astype(np.float32)
    aim = rs.uniform(-0.8, 0.8, (n, 3)).astype(np.float32)
    d = aim - o
    d /= np.linalg.norm(d, axis=1, keepdims=True)
    return torch.as_tensor(o), torch.as_tensor(d)


@pytest.mark.parametrize("kind", ["triangles", "alpha", "spheres"])
def test_leaf_fold_equals_the_slot_loop(kind, monkeypatch):
    rs = np.random.RandomState({"triangles": 3, "alpha": 5, "spheres": 9}[kind])
    scene = _scene(kind, rs)
    assert scene.has_alpha == (kind == "alpha")
    counts = scene.blas_ifields[:, 2]
    leaves = counts[counts > 0]
    assert int(leaves.min()) < scene.blas_leaf_max == 8
    o, d = _rays(rs)
    t_max = torch.as_tensor(rs.uniform(0.2, 3.0, o.shape[0]).astype(np.float32))
    active = torch.as_tensor(rs.rand(o.shape[0]) < 0.9)

    with torch.inference_mode():
        fold = (traverse.trace_closest(scene, o, d, active),
                traverse.shadow_occlusion(scene, o, d, t_max, active))
        monkeypatch.setattr(traverse, "_blas_walk", _slot_loop_walk)
        loop = (traverse.trace_closest(scene, o, d, active),
                traverse.shadow_occlusion(scene, o, d, t_max, active))

    # every hit is an exact t tie of twins; most twins share a leaf, where
    # the fold must pick the same slot as the loop
    prim_idx = scene.sphere_prim_idx if kind == "spheres" else scene.tri_prim_idx
    leaf_of = torch.full((prim_idx.shape[0],), -1, dtype=torch.int64)
    for node in torch.nonzero(counts > 0).squeeze(1).tolist():
        first, count = scene.blas_ifields[node, 1:3].tolist()
        leaf_of[prim_idx[first:first + count].long()] = node
    prim = loop[0].prim.long()
    hit = prim >= 0
    assert int(hit.sum()) > 400
    assert int((leaf_of[prim[hit]] == leaf_of[prim[hit] ^ 1]).sum()) > 300
    for f in ("t", "kind", "prim", "inst", "bu", "bv"):
        assert torch.equal(getattr(fold[0], f), getattr(loop[0], f)), f
    occ = loop[1]
    assert 100 < int(occ.sum()) < int(active.sum()) - 100
    assert torch.equal(fold[1], occ)
