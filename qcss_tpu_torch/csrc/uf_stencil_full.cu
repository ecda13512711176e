// Stencil union-find decode: one warp per shot, several shots per block,
// driven by lists of the vertices that can change (CUDA C++, sm_90a).
//
// Replaces: qcss_tpu/decode/device_uf_pallas.py make_full_kernel (its
//   pallas_call, driven by decode_stencil_pallas_full). Plain version:
//   qcss_tpu_torch/decode/device_uf.py _stencil_plain. Both return the
//   same packed labels, activity and chunk values, bit for bit.
//
// What it computes, per shot: delta-stepped growth over O stencil offsets
//   and KB boundary slots; label propagation to a fixpoint on packed
//   int32 words (comp << L | lanes), Jacobi sweeps so every sweep reads
//   the previous sweep's labels; cluster parity; activity. Rounds stop
//   when no cluster is active or nothing grew. Label lanes that did not
//   fit in the packed word (NC chunks of up to 30 bits) come out as one
//   forest-path word per vertex and chunk.
//
// What bounds it on this card: not device memory. A shot reads V detector
//   words and writes (2 + NC)V; the graph's tables are shared by every
//   shot. The work is integer control flow whose size depends on the
//   data: at d=11 a shot has ~10-20 defects, and only ~2-4% of its
//   vertices ever touch a saturated edge, so a sweep over the whole graph
//   (V x (2O + KB) neighbour reads and block barriers) is mostly wasted.
//   Over the live vertices a shot is a chain of dependent shared-memory
//   steps and warp syncs: its latency, times the shots a warp takes, with
//   as many warps an SM as shared memory allows, sets the time.
//
// Design:
//   * one warp per shot. Sweeps synchronise with __syncwarp, reductions
//     are __reduce_min_sync / __any_sync: no block barrier after the
//     tables are staged. Blocks are persistent: each warp walks shots
//     warp, warp + (warps in the grid), ... and leaves its state clean
//     after each shot, so only what the shot touched is reset. A warp
//     loads the next shot's detector words while it decodes the current
//     one. Shared memory sets the occupancy (one block of ~11 warps an
//     SM at d=11), so the per-shot state is kept small;
//   * the graph's tables are staged once per block in shared memory (when
//     they fit beside one shot; else read from device memory), one word
//     per edge and boundary slot holding its presence, weight and label
//     bits, so an edge costs one load. Narrow words (weights up to 255,
//     L <= 23) are `(wt + 1) << L | obs`, 0 for no edge, with one byte of
//     support per edge; wide words are int2 {obs, wt or -1}. The wrapper
//     picks the form from the graph. Chunk tables stay in device memory:
//     only an adoption reads them;
//   * per shot, `sat[v]` holds bit 2o (edge to v + d_o saturated), bit
//     2o+1 (edge to v - d_o saturated) and bit 2O+k (boundary slot k), so
//     a vertex's candidates are the set bits of one word, visited in the
//     reference's tie-break order: o=0 down, o=0 up, ..., then the slots;
//   * live-vertex lists, 16-bit, up to V entries each, so they cannot
//     overflow: the members (the defects first, then every vertex with a
//     saturated edge or slot; only members are ever active or change
//     label) and the frontier. Lists are built from bit sets by one warp
//     prefix over their words (ascending vertex order), so duplicates
//     collapse into one bit;
//   * growth visits the members that are active; an edge with both ends
//     active is grown from its low end. Elsewhere the increment is 0 and
//     nothing changes. A first pass finds the growable edges and the
//     slack, a second grows them; newly saturated edges mark both ends
//     for the first sweep, and a new slot marks the hub;
//   * a sweep visits only the frontier: the vertices joined by a saturated
//     edge or slot to a vertex that changed in the previous sweep, every
//     slot holder when the hub changed, and the hub when a slot holder
//     changed. A vertex none of whose candidates changed cannot adopt, so
//     the Jacobi sweeps' result is unchanged. New labels go to `nxt` and
//     are copied into `cur` after the whole frontier was read;
//   * cluster parity is an atomicXor into a per-root bit set over the
//     defect list; activity is computed over the members (a vertex is
//     active iff its root's parity is odd and its root is not the hub's);
//     every other vertex has act 0 and label v << L;
//   * spilled lanes travel with the labels: on adoption a vertex copies
//     its parent's chunk words XOR the edge's chunk bits; the hub takes
//     them from the first slot that offers its minimum and, within it,
//     the smallest vertex. A vertex takes its final root only from a
//     neighbour that already holds it, so the words equal the forest-path
//     XORs the TPU kernel spreads after the last round.

#include <cuda_runtime.h>

#include <algorithm>
#include <cstdint>

#include "uf_stencil_common.cuh"

namespace {

using namespace qcss;

// detector words a lane loads at once: one round trip up to V = 768
constexpr int kLoadWords = 24;

// Byte offsets of one shot's state in shared memory.
struct ShotLayout {
  size_t cur, nxt, sat, ccur, cnxt, sup, mbits, mark, cnt, mem, fr, act;
  size_t bytes;
};

__host__ __device__ inline ShotLayout shot_layout(int V, int O, int KB,
                                                  int NC, int sup_bytes) {
  const size_t v = (size_t)V;
  const size_t nw = (size_t)(V + 31) / 32;
  ShotLayout s;
  size_t o = 0;
  s.cur = o;   o = align16(o + 4 * v);                    // [V] labels
  s.nxt = o;   o = align16(o + 4 * v);                    // [V] next sweep
  s.sat = o;   o = align16(o + 4 * v);                    // [V] sat bits
  s.ccur = o;  o = align16(o + 4 * (size_t)NC * v);       // [NC, V]
  s.cnxt = o;  o = align16(o + 4 * (size_t)NC * v);       // [NC, V]
  s.sup = o;   o = align16(o + (size_t)sup_bytes * (O + KB) * v);
  s.mbits = o; o = align16(o + 4 * nw);                   // member bits
  s.mark = o;  o = align16(o + 4 * nw);                   // frontier bits
  s.cnt = o;   o = align16(o + 4 * nw);                   // parity bits
  s.mem = o;   o = align16(o + 2 * v);                    // member list
  s.fr = o;    o = align16(o + 2 * v);                    // frontier list
  s.act = o;   o = align16(o + v);                        // [V] 0/1
  s.bytes = o;
  return s;
}

// Loads words [g, g + 32 * kLoadWords) of a shot's detector row (0 past
// the hub, V - 1, whose column is ignored, or past the batch).
__device__ __forceinline__ void fetch_defects(const int* __restrict__ defect,
                                              long long shot, long long B,
                                              int V, int g,
                                              int (&x)[kLoadWords]) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int j = 0; j < kLoadWords; ++j) {
    const int v = g + 32 * j + lane;
    x[j] = (shot < B && v < V - 1) ? defect[shot * V + v] : 0;
  }
}

// Appends the defects among fetched words [g, g + 32 * kLoadWords) to the
// member list, ascending, with their member bits and activity.
__device__ __forceinline__ void take_defects(const int (&x)[kLoadWords],
                                             int g, int V, unsigned* mbits,
                                             uint16_t* mem,
                                             unsigned char* act, int* nm) {
  const int lane = threadIdx.x & 31;
  const unsigned lt = (1u << lane) - 1u;
#pragma unroll
  for (int j = 0; j < kLoadWords; ++j) {
    const int v = g + 32 * j + lane;
    const bool dv = x[j] & 1;
    const unsigned m = __ballot_sync(kFull, dv);
    if (lane == 0 && g + 32 * j < V) mbits[(g >> 5) + j] = m;
    if (dv) {
      mem[*nm + __popc(m & lt)] = (uint16_t)v;
      act[v] = 1;
    }
    *nm += __popc(m);
  }
}

// 128 registers a thread: no spills in any instance (left to itself,
// ptxas holds the chunk instances at 64 and spills), and 16 warps of 128
// registers still fit an SM.
template <bool kChunks, bool kWide>
__global__ void __maxnreg__(128)
uf_stencil_full_kernel(const int* __restrict__ defect_in,
                       const void* __restrict__ words_in,
                       const int* __restrict__ ctab,
                       const int* __restrict__ deltas_in, long long B,
                       int V, int O, int KB, int NC, int L, int max_rounds,
                       int presat, const int* __restrict__ any_defect,
                       bool tables_in_smem, int* __restrict__ out_packed,
                       int* __restrict__ out_act,
                       int* __restrict__ out_chunks) {
  using F = EdgeForm<kWide>;
  using Word = typename F::Word;
  using Sup = typename F::Sup;
  extern __shared__ __align__(16) unsigned char smem[];
  __shared__ int deltas[kMaxOffsets];

  const int lane = threadIdx.x & 31;
  const int warp = threadIdx.x >> 5;
  const int nwarps = blockDim.x >> 5;
  const int OK = O + KB;
  const int bn = V - 1;
  const int nw = (V + 31) >> 5;

  // -- the graph's tables, once per block
  if (threadIdx.x < O) deltas[threadIdx.x] = deltas_in[threadIdx.x];
  const Word* E = reinterpret_cast<const Word*>(words_in);
  size_t tab_bytes = 0;
  if (tables_in_smem) {
    Word* Es = reinterpret_cast<Word*>(smem);
    stage_words(Es, OK * V, [&](int i) { return E[i]; });
    E = Es;
    tab_bytes = align16((size_t)OK * V * sizeof(Word));
  }
  __syncthreads();
  const Word* Bw = E + (size_t)O * V;  // [KB, V] boundary slot words

  // -- this warp's shot state, clean between shots
  const ShotLayout lay = shot_layout(V, O, KB, NC, (int)sizeof(Sup));
  unsigned char* base = smem + tab_bytes + (size_t)warp * lay.bytes;
  int* cur = reinterpret_cast<int*>(base + lay.cur);
  int* nxt = reinterpret_cast<int*>(base + lay.nxt);
  unsigned* sat = reinterpret_cast<unsigned*>(base + lay.sat);
  int* ccur = reinterpret_cast<int*>(base + lay.ccur);
  int* cnxt = reinterpret_cast<int*>(base + lay.cnxt);
  Sup* sup = reinterpret_cast<Sup*>(base + lay.sup);
  unsigned* mbits = reinterpret_cast<unsigned*>(base + lay.mbits);
  unsigned* mark = reinterpret_cast<unsigned*>(base + lay.mark);
  unsigned* cnt = reinterpret_cast<unsigned*>(base + lay.cnt);
  uint16_t* mem = reinterpret_cast<uint16_t*>(base + lay.mem);
  uint16_t* fr = reinterpret_cast<uint16_t*>(base + lay.fr);
  unsigned char* act = base + lay.act;

  for (int v = lane; v < V; v += 32) {
    cur[v] = v << L;
    sat[v] = 0u;
    act[v] = 0;
  }
  if (kChunks)
    for (int i = lane; i < NC * V; i += 32) ccur[i] = 0;
  for (int i = lane; i < OK * V; i += 32) sup[i] = 0;
  for (int w = lane; w < nw; w += 32) {
    mbits[w] = 0u;
    mark[w] = 0u;
    cnt[w] = 0u;
  }
  __syncwarp();

  // set by any_defect_kernel, launched just before on the same stream
  const bool batch_defect = presat && *any_defect != 0;
  const long long stride = (long long)gridDim.x * nwarps;
  // The first 32 * kLoadWords detector words of a shot are loaded while
  // the warp still decodes the shot before it, so their latency hides
  // behind that work; the rest (V > 768) are loaded on the spot.
  const long long first = (long long)blockIdx.x * nwarps + warp;
  int x[kLoadWords];
  fetch_defects(defect_in, first, B, V, 0, x);
  for (long long shot = first; shot < B; shot += stride) {
    const long long row = shot * V;

    // -- defects: the first entries of the member list, ascending
    int nM = 0;
    take_defects(x, 0, V, mbits, mem, act, &nM);
    for (int g = 32 * kLoadWords; g < bn; g += 32 * kLoadWords) {
      fetch_defects(defect_in, shot, B, V, g, x);
      take_defects(x, g, V, mbits, mem, act, &nM);
    }
    fetch_defects(defect_in, shot + stride, B, V, 0, x);
    const int nD = nM;
    __syncwarp();

    // the plain version's round loop is batch-wide: with edges of weight
    // 0, a shot without defects runs the first round when another has one
    bool active = nD > 0 || batch_defect;
    bool hubF = false;  // the hub is in the frontier
    for (int round = 0; active && round < max_rounds; ++round) {
      // -- edges of weight <= 0 are saturated from the first growth step
      if (round == 0 && presat) {
        bool hub_new = false;
        for (int i = lane; i < OK * V; i += 32) {
          const int o = i / V;
          const int v = i - o * V;
          const Word w = E[i];
          if (!F::present(w, L) || F::weight(w, L) > 0) continue;
          if (o < O) {
            const int p = v + deltas[o];
            atomicOr(&sat[v], 1u << (2 * o));
            atomicOr(&sat[p], 1u << (2 * o + 1));
            set_bit(mark, v);
            set_bit(mark, p);
          } else {
            atomicOr(&sat[v], 1u << (2 * O + o - O));
            set_bit(mark, v);
            hub_new = true;
          }
        }
        hubF = __any_sync(kFull, hub_new);
      }

      // -- growth, delta-stepped, over the active members. Pass 1 finds
      //    each member's growable edges (bit 2o: edge (o, u); 2o+1: edge
      //    (o, u - d), grown from u when u - d is not active; 2O+k: slot
      //    k) and the slack, with every load of an offset issued up front
      //    (indices clamped into the shot); pass 2 grows those edges. The
      //    masks wait in `nxt`, by member position: the sweeps write it
      //    only later.
      const int hub_comp = cur[bn] >> L;
      int local = kBig;
      for (int i = lane; i < nM; i += 32) {
        const int u = mem[i];
        unsigned gm = 0u;
        if (act[u]) {
          const int cu = cur[u] >> L;
          const unsigned su = sat[u];
#pragma unroll
          for (int o = 0; o < kMaxOffsets; ++o) {
            if (o < O) {
              const int d = deltas[o];
              const int p = min(u + d, bn);
              const int q = max(u - d, 0);
              const Word wd = E[o * V + u];  // edge (o, u): u -- u + d
              const Word wq = E[o * V + q];  // edge (o, u - d)
              const int cp = cur[p] >> L;
              const int cq = cur[q] >> L;
              const int ap = act[p];
              const int aq = act[q];
              const int sp = sup[o * V + u];
              const int sq = sup[o * V + q];
              if (F::present(wd, L) && !((su >> (2 * o)) & 1u) && cu != cp) {
                const int inc = 1 + ap;  // ceil((wt - sup) / inc), inc 1 or 2
                local = min(local,
                            (F::weight(wd, L) - sp + inc - 1) >> (inc - 1));
                gm |= 1u << (2 * o);
              }
              if (u >= d && !aq && F::present(wq, L) &&
                  !((su >> (2 * o + 1)) & 1u) && cu != cq) {
                local = min(local, F::weight(wq, L) - sq);
                gm |= 1u << (2 * o + 1);
              }
            }
          }
#pragma unroll
          for (int k = 0; k < kMaxBoundary; ++k) {
            if (k < KB) {
              const Word wb = Bw[k * V + u];
              const int sb = sup[(O + k) * V + u];
              if (F::present(wb, L) && !((su >> (2 * O + k)) & 1u) &&
                  cu != hub_comp) {
                local = min(local, F::weight(wb, L) - sb);
                gm |= 1u << (2 * O + k);
              }
            }
          }
        }
        nxt[i] = (int)gm;
      }
      const int slack = __reduce_min_sync(kFull, local);
      const bool grew = slack < kBig;
      if (grew) {
        const int delta = slack > 1 ? slack : 1;
        bool hub_new = false;
        for (int i = lane; i < nM; i += 32) {
          const unsigned gm = (unsigned)nxt[i];
          if (!gm) continue;
          const int u = mem[i];
          for (unsigned m = gm; m; m &= m - 1u) {
            const int b = __ffs(m) - 1;
            const bool slot = b >= 2 * O;
            const int row = slot ? b - O : b >> 1;  // edge o or O + k
            const int d = slot ? 0 : deltas[row];
            const int lo = (b & 1) && !slot ? u - d : u;
            const int inc = slot || (b & 1) ? 1 : 1 + act[u + d];
            const int idx = row * V + lo;  // Bw = E + O * V
            const int w = F::weight(E[idx], L);
            const int s = min((int)sup[idx] + inc * delta, w);
            sup[idx] = (Sup)s;
            if (s < w) continue;
            if (slot) {
              atomicOr(&sat[u], 1u << b);
              set_bit(mark, u);
              hub_new = true;
            } else {
              atomicOr(&sat[lo], 1u << (2 * row));
              atomicOr(&sat[lo + d], 1u << (2 * row + 1));
              set_bit(mark, lo);
              set_bit(mark, lo + d);
            }
          }
        }
        hubF = __any_sync(kFull, hubF || hub_new);
      }
      __syncwarp();
      // the ends of the new saturated edges: the first frontier, and
      // members from now on
      int nF = compact_bits(mark, nw, fr, mbits, mem, &nM);

      // -- label propagation to the fixpoint, frontier by frontier
      while (nF > 0 || hubF) {
        const int hv = cur[bn];
        bool hub_next = false;
        for (int i = lane; i < nF; i += 32) {
          const int v = fr[i];
          const int pv = cur[v];
          const unsigned sb = sat[v];
          int cand = kBig;
          int slot = -1;
          for (unsigned m = sb; m; m &= m - 1u) {
            const int b = __ffs(m) - 1;
            int c;
            if (b < 2 * O) {
              const int o = b >> 1;
              const int d = deltas[o];
              c = (b & 1) ? (cur[v - d] ^ F::obs(E[o * V + v - d], L))
                          : (cur[v + d] ^ F::obs(E[o * V + v], L));
            } else {
              c = hv ^ F::obs(Bw[(b - 2 * O) * V + v], L);
            }
            if (c < cand) {
              cand = c;
              slot = b;
            }
          }
          const bool adopt = (cand >> L) < (pv >> L);
          nxt[v] = adopt ? cand : pv;
          if (adopt) {
            if (kChunks) {
              for (int c = 0; c < NC; ++c) {
                const int* bits = ctab + (size_t)c * OK * V;
                int w;
                if (slot >= 2 * O) {
                  w = ccur[c * V + bn] ^
                      __ldg(bits + (O + slot - 2 * O) * V + v);
                } else {
                  const int o = slot >> 1;
                  const int d = deltas[o];
                  w = (slot & 1)
                          ? (ccur[c * V + v - d] ^ __ldg(bits + o * V + v - d))
                          : (ccur[c * V + v + d] ^ __ldg(bits + o * V + v));
                }
                cnxt[c * V + v] = w;
              }
            }
            for (unsigned m = sb; m; m &= m - 1u) {
              const int b = __ffs(m) - 1;
              if (b < 2 * O) {
                const int d = deltas[b >> 1];
                set_bit(mark, (b & 1) ? v - d : v + d);
              } else {
                hub_next = true;
              }
            }
          }
        }
        // the hub adopts the minimum over every saturated boundary slot
        bool adopt_b = false;
        int hub = kBig;
        if (hubF) {
          int hl = kBig;
          for (int i = lane; i < nM; i += 32) {
            const int v = mem[i];
            const unsigned sb = sat[v] >> (2 * O);
            for (int k = 0; k < KB; ++k)
              if ((sb >> k) & 1u)
                hl = min(hl, cur[v] ^ F::obs(Bw[k * V + v], L));
          }
          hub = __reduce_min_sync(kFull, hl);
          adopt_b = (hub >> L) < (hv >> L);
          if (adopt_b) {
            int key = 0x7fffffff;  // k * V + v of the hub's provider
            for (int i = lane; i < nM; i += 32) {
              const int v = mem[i];
              const unsigned sb = sat[v] >> (2 * O);
              if (sb) set_bit(mark, v);
              if (kChunks)
                for (int k = 0; k < KB; ++k)
                  if (((sb >> k) & 1u) &&
                      (cur[v] ^ F::obs(Bw[k * V + v], L)) == hub)
                    key = min(key, k * V + v);
            }
            if (kChunks) {
              key = __reduce_min_sync(kFull, key);
              if (lane == 0) {
                const int k = key / V;
                const int v = key - k * V;
                for (int c = 0; c < NC; ++c)
                  cnxt[c * V + bn] = ccur[c * V + v] ^
                      __ldg(ctab + ((size_t)c * OK + O + k) * V + v);
              }
            }
          }
        }
        hubF = __any_sync(kFull, hub_next);
        __syncwarp();
        for (int i = lane; i < nF; i += 32) {
          const int v = fr[i];
          const int n = nxt[v];
          if (n != cur[v]) {
            cur[v] = n;
            if (kChunks)
              for (int c = 0; c < NC; ++c) ccur[c * V + v] = cnxt[c * V + v];
          }
        }
        if (adopt_b && lane == 0) {
          cur[bn] = hub;
          if (kChunks)
            for (int c = 0; c < NC; ++c) ccur[c * V + bn] = cnxt[c * V + bn];
        }
        __syncwarp();
        nF = compact_bits(mark, nw, fr, nullptr, nullptr, nullptr);
      }

      // -- cluster parity per root over the defects, then activity
      for (int i = lane; i < nD; i += 32) {
        const int r = cur[mem[i]] >> L;
        atomicXor(&cnt[r >> 5], 1u << (r & 31));
      }
      __syncwarp();
      const int broot = cur[bn] >> L;
      bool any_act = false;
      for (int i = lane; i < nM; i += 32) {
        const int v = mem[i];
        const int r = cur[v] >> L;
        const bool a = ((cnt[r >> 5] >> (r & 31)) & 1u) && r != broot;
        act[v] = a;
        any_act |= a;
      }
      any_act = __any_sync(kFull, any_act);
      __syncwarp();
      for (int w = lane; w < nw; w += 32) cnt[w] = 0u;
      __syncwarp();
      active = any_act && grew;
    }

    // -- the shot's final state out
    for (int v = lane; v < V; v += 32) {
      out_packed[row + v] = cur[v];
      out_act[row + v] = act[v];
    }
    if (kChunks)
      for (int c = 0; c < NC; ++c)
        for (int v = lane; v < V; v += 32)
          out_chunks[(c * B + shot) * V + v] = ccur[c * V + v];
    __syncwarp();

    // -- reset what the shot touched: only members changed
    for (int i = lane; i < nM; i += 32) {
      const int v = mem[i];
      cur[v] = v << L;
      act[v] = 0;
      sat[v] = 0u;
      for (int o = 0; o < O; ++o) {
        sup[o * V + v] = 0;
        if (v >= deltas[o]) sup[o * V + v - deltas[o]] = 0;
      }
      for (int k = 0; k < KB; ++k) sup[(O + k) * V + v] = 0;
      if (kChunks)
        for (int c = 0; c < NC; ++c) ccur[c * V + v] = 0;
    }
    if (lane == 0) {
      cur[bn] = bn << L;
      if (kChunks)
        for (int c = 0; c < NC; ++c) ccur[c * V + bn] = 0;
    }
    for (int w = lane; w < nw; w += 32) mbits[w] = 0u;
    __syncwarp();
  }
}

// *flag = 1 if a shot of defect [B, V] has a defect outside the hub
// column, V - 1 (flag zeroed before): the batch-wide test of the plain
// version's round loop, kept on the device.
__global__ void any_defect_kernel(const int* __restrict__ defect,
                                  long long n, int V, int* flag) {
  const long long step = (long long)gridDim.x * blockDim.x;
  for (long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x; i < n;
       i += step)
    if (defect[i] != 0 && i % V != V - 1) {
      *flag = 1;
      return;
    }
}

// As many shots a block as shared memory holds, up to kMaxShotsPerBlock,
// the edge words staged beside them when they fit.
Plan plan_for(int V, int O, int KB, int NC, bool wide) {
  return plan_shots(shot_layout(V, O, KB, NC, wide ? 4 : 1).bytes,
                    align16((size_t)(O + KB) * V * (wide ? 8 : 4)), true,
                    kMaxShotsPerBlock);
}

template <bool kChunks, bool kWide>
const void* kernel_ptr() {
  return reinterpret_cast<const void*>(
      uf_stencil_full_kernel<kChunks, kWide>);
}

const void* pick_kernel(bool chunks, bool wide) {
  if (chunks)
    return wide ? kernel_ptr<true, true>() : kernel_ptr<true, false>();
  return wide ? kernel_ptr<false, true>() : kernel_ptr<false, false>();
}

bool shape_ok(int V, int O, int KB, int NC) {
  return qcss::stencil_shape_ok(V, O, KB) && 2 * O + KB <= 32 && NC >= 0 &&
         V <= 65536;
}

}  // namespace

// The launch plan of K1 at a graph's shape: out[0] shots (warps) per
// block, out[1] dynamic shared memory per block in bytes, out[2] 1 if
// the tables are staged in shared memory, out[3] bytes of one shot's
// state, out[4] registers per thread, out[5] resident blocks per SM.
// Returns the CUDA error code (0 = success); out[0] is 0 when one shot's
// state does not fit in a block.
extern "C" int qcss_uf_stencil_full_config(int V, int O, int KB, int NC,
                                           int wide, long long* out) {
  if (!shape_ok(V, O, KB, NC)) return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(V, O, KB, NC, wide != 0);
  out[0] = p.shots_per_block;
  out[1] = (long long)p.smem;
  out[2] = p.tables_in_smem;
  out[3] = (long long)p.shot_bytes;
  out[4] = out[5] = 0;
  if (p.shots_per_block == 0) return 0;
  const void* k = pick_kernel(NC > 0, wide != 0);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  cudaFuncAttributes attr;
  err = cudaFuncGetAttributes(&attr, k);
  if (err != cudaSuccess) return (int)err;
  out[4] = attr.numRegs;
  int blocks = 0;
  err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
      &blocks, k, p.shots_per_block * 32, p.smem);
  out[5] = blocks;
  return (int)err;
}

// defect [B, V] int32 (column V-1, the boundary hub, is ignored); words
// the edge and boundary-slot words [O + KB, V] (narrow: int32; wide:
// int32 pairs {obs, weight or -1}); chunk_tables [NC, O+KB, V] int32, per
// chunk the edge bits (O rows) and the boundary bits (KB rows), unread
// when NC = 0; deltas [O] int32; presat: 1 if some present edge or slot
// has weight <= 0, else 0; flag: one int32 of scratch on the device, used
// when presat is 1 (then every shot runs the first round if some shot of
// the batch has a defect). Writes packed and act [B, V] int32 and chunks
// [NC, B, V] int32. Returns the CUDA error code of the launch (0 =
// success).
extern "C" int qcss_uf_stencil_full(const int* defect, const void* words,
                                    const int* chunk_tables,
                                    const int* deltas, long long B, int V,
                                    int O, int KB, int NC, int L,
                                    int max_rounds, int wide, int presat,
                                    int* flag, int* out_packed, int* out_act,
                                    int* out_chunks, void* stream) {
  if (!shape_ok(V, O, KB, NC) || B < 0 || (presat && flag == nullptr))
    return (int)cudaErrorInvalidValue;
  const Plan p = plan_for(V, O, KB, NC, wide != 0);
  if (p.shots_per_block == 0) return (int)cudaErrorInvalidValue;
  const void* k = pick_kernel(NC > 0, wide != 0);
  cudaError_t err = cudaFuncSetAttribute(
      k, cudaFuncAttributeMaxDynamicSharedMemorySize, (int)p.smem);
  if (err != cudaSuccess) return (int)err;
  if (B == 0) return (int)cudaGetLastError();
  int dev = 0, sms = 0, per_sm = 0;
  if ((err = cudaGetDevice(&dev)) != cudaSuccess) return (int)err;
  if ((err = cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount,
                                    dev)) != cudaSuccess)
    return (int)err;
  if ((err = cudaOccupancyMaxActiveBlocksPerMultiprocessor(
           &per_sm, k, p.shots_per_block * 32, p.smem)) != cudaSuccess)
    return (int)err;
  const long long need = (B + p.shots_per_block - 1) / p.shots_per_block;
  const int grid = (int)std::min<long long>(need, (long long)sms *
                                                      std::max(per_sm, 1));
  if (presat) {
    const cudaStream_t s = (cudaStream_t)stream;
    if ((err = cudaMemsetAsync(flag, 0, sizeof(int), s)) != cudaSuccess)
      return (int)err;
    const long long n = B * V;
    const int blocks = (int)std::min<long long>((n + 255) / 256, 4LL * sms);
    any_defect_kernel<<<blocks, 256, 0, s>>>(defect, n, V, flag);
    if ((err = cudaGetLastError()) != cudaSuccess) return (int)err;
  }
  bool staged = p.tables_in_smem;
  const int* any_defect = flag;
  void* args[] = {(void*)&defect, (void*)&words, (void*)&chunk_tables,
                  (void*)&deltas, (void*)&B, (void*)&V, (void*)&O,
                  (void*)&KB, (void*)&NC, (void*)&L, (void*)&max_rounds,
                  (void*)&presat, (void*)&any_defect, (void*)&staged,
                  (void*)&out_packed, (void*)&out_act, (void*)&out_chunks};
  err = cudaLaunchKernel(k, dim3(grid), dim3(p.shots_per_block * 32), args,
                         p.smem, (cudaStream_t)stream);
  if (err != cudaSuccess) return (int)err;
  return (int)cudaGetLastError();
}
