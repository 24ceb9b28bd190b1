// The two walks of the 8-wide BVH, shared by all six 8-wide kernels and
// templated on how a node is read (the `Nodes` reader):
// - closest_walk: K1 and K7 over the exact-box record (wide_nodes.cuh), K4
//   and K8 over the quantized record (stream_nodes.cuh);
// - anyhit_walk: K2 over the exact-box record, K5 over the quantized one.
// Built for the H100 (measurements in PERF.md):
// - a node is one packed record, read with 16-byte loads;
// - the stack holds node groups (Ylitie, Karras & Laine, HPG 2017): one
//   entry per level, node << 8 | a mask of the children still to visit,
//   so a thread needs at most (wide depth - 1) entries, held in the block's
//   dynamic shared memory (entry e of a thread at stack[e * THREADS]). The
//   host proves the depth; a deeper walk fails a device-side assert;
// - a lane visits nodes until it holds hit leaves, then tests one leaf, so
//   the lanes of a warp test leaves together (the while-while loop of Aila
//   & Laine, HPG 2009, without a warp vote) where a walk that tests each
//   node's leaves inside its child loop idles the lanes that met none.
//
// A reader `Nodes` has
//   const float* tri, * sph;  // leaf rows, 8 slots each
//   template <bool COUNT> void visit_ranked(int node, int octant, const Ray&,
//       float t_b, unsigned& order, int4& c0, int4& c1, unsigned& inner,
//       unsigned& leaves, Work&) const;  // hit children by octant rank
//   template <bool COUNT> void visit_slots(int node, const Ray&, float t_b,
//       int4& c0, int4& c1, unsigned& inner, unsigned& leaves, Work&) const;
//   unsigned order(int node, int octant) const;  // 4 bits a rank
//   bool box_hit(int node, int c, const Ray&, float t_b) const;
//   int child(int node, int c) const;  // >= 0 inner, -1 empty, <= -2 leaf
//   template <bool ANY_HIT, bool COUNT> bool test_leaf(int child, const
//       float* rows, bool is_tri, const Ray&, int inst_bits, float t_limit,
//       float& t_best, int& pp, Work&) const;
// where a visit tests every non-empty child's box against t_b and counts
// it (COUNT), and c0 / c1 are the node's eight child words.
//
// Exactness of the closest walk. A tie in t goes to the primitive tested
// first (t < t_best), so the walk keeps the order of the plain walk
// (ops/cuda/treelet.plain_walk): children in the rank order of the ray's
// octant, every hit leaf of a node before its inner children, each inner
// child's subtree before the next, a leaf's rows and slots in order. A
// node's children are all tested against the t_best of its visit; a pending
// leaf and a popped inner child are tested again against the t_best that
// earlier leaves tightened, and skipped when they no longer pass. Slab
// tests against a staler t_best only add visits, and a box skipped against
// a tighter one holds no primitive below t_best, so t and pp equal the
// plain walk's bit for bit. The counting variant counts each child box
// once, at its node's visit: a re-test is this design's own cost, not work
// the function needs.
//
// The any-hit walk pays for no order: occlusion is the OR over every
// primitive of "t lies in (T_EPS, t_max)", which no order changes. It
// visits children in slot order, reads no order word, and returns at the
// first accepting primitive.
#pragma once

#include "trace_common.cuh"

namespace trace {

__device__ __forceinline__ int ray_octant(const Ray& r) {
  return (r.dx > 0.0f ? 4 : 0) + (r.dy > 0.0f ? 2 : 0) + (r.dz > 0.0f ? 1 : 0);
}

// Tightens t_best / pp over the BLAS under `root`. `stack` is this thread's
// column of the block's shared stack; a walk that would need more than
// depth_cap entries fails an assert.
template <bool COUNT, class Nodes>
__device__ void closest_walk(const Nodes& nd, const Ray& r, int root, bool is_tri,
                             int inst_bits, float& t_best, int& pp, int depth_cap,
                             int* stack, Work& work) {
  const float* __restrict__ rows = is_tri ? nd.tri : nd.sph;
  const int octant = ray_octant(r);
  int sp = 0;
  int node = root;      // the next node to visit; -1 when none is left
  int lnode = 0;        // the node whose hit leaf children are pending
  unsigned lorder = 0;  // its order word
  unsigned leaves = 0;  // those children, a bit per rank
  for (;;) {
    // visit nodes until this lane has leaves to test or has none left
    while (node >= 0 && leaves == 0) {
      unsigned order, inner = 0;
      int4 c0, c1;
      nd.template visit_ranked<COUNT>(node, octant, r, t_best, order, c0, c1, inner,
                                      leaves, work);
      if (leaves != 0) {
        lnode = node;
        lorder = order;
      }
      if (inner != 0) {  // descend into the nearest hit inner child
        const int rank = __ffs(static_cast<int>(inner)) - 1;
        inner &= inner - 1u;
        if (inner != 0) {
          if (sp >= depth_cap) {  // the host's bound (the wide depth) was wrong
            assert(false && "8-wide closest walk: node-group stack overflow");
            return;
          }
          stack[sp++ * THREADS] = (node << 8) | static_cast<int>(inner);
        }
        node = word_of(c0, c1, (order >> (rank * 4)) & 7);
        continue;
      }
      // the next inner child of the deepest pending group
      node = -1;
      while (sp > 0) {
        const int e = stack[--sp * THREADS];
        unsigned mask = static_cast<unsigned>(e) & 255u;
        const int rank = __ffs(static_cast<int>(mask)) - 1;
        mask &= mask - 1u;
        if (mask != 0) stack[sp++ * THREADS] = (e & ~255) | static_cast<int>(mask);
        const int parent = e >> 8;
        const int c = (nd.order(parent, octant) >> (rank * 4)) & 7;
        if (!nd.box_hit(parent, c, r, t_best)) continue;
        node = nd.child(parent, c);
        break;
      }
    }
    if (leaves == 0) return;  // no node and no leaf left
    // test the nearest pending leaf, then visit again
    const int rank = __ffs(static_cast<int>(leaves)) - 1;
    leaves &= leaves - 1u;
    const int c = (lorder >> (rank * 4)) & 7;
    if (!nd.box_hit(lnode, c, r, t_best)) continue;
    nd.template test_leaf<false, COUNT>(nd.child(lnode, c), rows, is_tri, r, inst_bits,
                                        t_best, t_best, pp, work);
  }
}

// True when some primitive of the BLAS under `root` accepts t in (T_EPS,
// t_limit). Stack and depth_cap as closest_walk's.
template <bool COUNT, class Nodes>
__device__ bool anyhit_walk(const Nodes& nd, const Ray& r, int root, bool is_tri,
                            float t_limit, int depth_cap, int* stack, Work& work) {
  const float* __restrict__ rows = is_tri ? nd.tri : nd.sph;
  float t_unused = t_limit;
  int pp_unused = -1;
  int sp = 0;
  int node = root;      // the next node to visit; -1 when none is left
  int lnode = 0;        // the node whose hit leaf children are pending
  unsigned leaves = 0;  // those children, a bit per slot
  for (;;) {
    // visit nodes until this lane has leaves to test or has none left
    while (node >= 0 && leaves == 0) {
      unsigned inner = 0;
      int4 c0, c1;
      nd.template visit_slots<COUNT>(node, r, t_limit, c0, c1, inner, leaves, work);
      if (leaves != 0) lnode = node;
      if (inner != 0) {  // descend into the first hit inner child
        const int c = __ffs(static_cast<int>(inner)) - 1;
        inner &= inner - 1u;
        if (inner != 0) {
          if (sp >= depth_cap) {  // the host's bound (the wide depth) was wrong
            assert(false && "8-wide any-hit walk: node-group stack overflow");
            return false;
          }
          stack[sp++ * THREADS] = (node << 8) | static_cast<int>(inner);
        }
        node = word_of(c0, c1, c);
      } else if (sp > 0) {  // the next inner child of the deepest pending group
        const int e = stack[--sp * THREADS];
        unsigned mask = static_cast<unsigned>(e) & 255u;
        const int c = __ffs(static_cast<int>(mask)) - 1;
        mask &= mask - 1u;
        if (mask != 0) stack[sp++ * THREADS] = (e & ~255) | static_cast<int>(mask);
        node = nd.child(e >> 8, c);
      } else {
        node = -1;
      }
    }
    if (leaves == 0) return false;  // no node and no leaf left
    // test one pending leaf, the first in slot order, then visit again
    const int c = __ffs(static_cast<int>(leaves)) - 1;
    leaves &= leaves - 1u;
    if (nd.template test_leaf<true, COUNT>(nd.child(lnode, c), rows, is_tri, r, 0,
                                           t_limit, t_unused, pp_unused, work)) {
      return true;
    }
  }
}

// The walker of trace_kernel and treelet_kernel (trace_common.cuh) over a
// reader: the closest walk, or with ANY_HIT the any-hit walk, on a
// node-group stack of depth_cap entries a thread.
template <class Nodes>
struct NodeGroupWalker {
  Nodes nd;
  int depth_cap;  // the host's bound on the wide depth

  size_t smem_bytes() const {
    return sizeof(int) * THREADS * (depth_cap > 0 ? depth_cap : 1);
  }

  template <bool ANY_HIT, bool COUNT>
  __device__ void walk(const Ray& r, int root, bool is_tri, int inst_bits,
                       float t_limit, float& t_best, int& pp, bool& occ, Work& work,
                       int* stack) const {
    if constexpr (ANY_HIT) {
      occ = anyhit_walk<COUNT>(nd, r, root, is_tri, t_limit, depth_cap, stack, work);
    } else {
      closest_walk<COUNT>(nd, r, root, is_tri, inst_bits, t_best, pp, depth_cap, stack,
                          work);
    }
  }
};

}  // namespace trace
