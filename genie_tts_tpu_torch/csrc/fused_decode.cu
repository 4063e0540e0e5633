// One whole B=1 T2S decode step over all L layers, for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel genie_tts_tpu/ops/fused_decode.py::
// fused_decode_step (kernel _layer_kernel). Per layer, with the hidden
// state h carried in fp32:
//
//   qkv  = h . Wqkv + b                    the new K/V row is written in
//                                          place into the [L,S,D] caches at pos
//   att  = softmax(q . K^T / sqrt(Dh) + (mask - 1) * 1e10) . V     per head
//   h    = LN1(h + att . Wout + b)
//   h    = LN2(h + relu(h . W1 + b1) . W2 + b2)
//
// Every product rounds its activation operand to the compute dtype C (the
// cache dtype) and accumulates in fp32, as the TPU kernel's bf16 operands
// do. Weights W are bf16/fp32 (the TPU kernel's contract) or int8 codes
// with a per-output-channel fp32 scale: then a product is
// (x . w_int8) * scale + b in fp32, models/t2s.py's int8 linear.
//
// What bounds it on the H100: latency, not bytes. At L=24, D=512 a step
// reads 75.5 MB of int8 weights plus the visible cache rows, ~26 us at
// 3.35 TB/s, and the products are GEMVs (M=1), far below the tensor cores'
// ratio of operations to bytes, so no tensor core is used. But each layer
// needs the whole of the last layer's h: the step is a chain of phases
// across the grid, each bounded by its slowest block's chain of dependent
// L2 round trips, its instruction latency (8 warps a block, each running
// the whole phase) and the handoff to the next phase.
// chip_smoke.py prints the time per layer, the grid barriers' time alone
// and, from clock64 stamps in the kernel (phase_cycles), each span's share
// of a layer.
//
// Design: one persistent cooperative launch per step, one block of 256
// threads per SM, four phases per layer:
//
//   A  LN2 of the last layer, then qkv and attention. Per head, three
//      producer blocks compute q, k and v (each reads its head's D x Dh
//      weights once); the K producer writes the K row at pos, the V
//      producer the V row, in place. NC = SMs/H - 3 chunk blocks per head
//      (5 on the H100) wait for q, each take every NC-th 16-row group of
//      the cache (interleaved, so visible rows spread evenly), skip row
//      pos, and write a flash partial (m, l, o); the K producer writes the
//      score of row pos, which joins the partials with l = 1 and o = the
//      V row.
//   B  each block combines the heads of its K slices (max, then
//      exp-weighted sums in a fixed order), rounds att to C, and takes its
//      share of att . Wout split-K over 4 slices of D (whole heads).
//   C  LN1 (every block sums the 4 proj partials in order, so all hold the
//      same bits), then whole columns of W1 per block, ReLU applied.
//   D  ffn2 split-K over 4 slices of F: 4 partial vectors that the next
//      layer's LN2 (or the end) sums in order.
//
// One grid barrier per layer, after D (L a step, where a barrier after
// every phase would take 5 L):
// LN2 needs every block's ffn2 partial anyway. The other handoffs (q to
// its consumers, A to B, B to C, C to D) are point to point: the producer
// stores 64-bit words (value, layer + 1) and each consumer polls only the
// words it needs. The barrier keeps every block within one layer, so a
// buffer is never rewritten while a slower block still reads it; the
// tagged words are zeroed at the start of a launch. Every wait has a
// bounded spin that traps, so a fault ends the launch with an error.
//
// p is not rounded to C: the chunk partials carry unnormalised exp(s - m)
// and the combination normalises at the end (the plain version rounds the
// normalised p to C; chip_smoke.py holds the kernel to within twice the
// plain bf16 version's distance from the fp32 result). att is rounded to
// C before out-proj, as every product's activation is.
//
// All SMs work in every phase: each GEMV is cut into (16-byte column
// chunk x K rows) tiles, ~1/128 of the phase's weight bytes per block,
// whose warp sums use a reduce-scatter (V shuffles for V columns, not
// 5 V). No float atomics: every cross-block sum has a fixed order, so a
// run repeats itself bit for bit. The index arithmetic of a block's tiles
// is the same in every layer and is computed once per launch (Plan).
//
// Weights reach shared memory by TMA bulk copies (cp.async.bulk, one
// instruction per contiguous range, completing on an mbarrier): the
// wrapper keeps a copy of the weights re-laid so that each block's tile of
// each phase and layer is contiguous (fused_decode_tile_index), and the
// small vectors of the LayerNorms and epilogues follow it. A block's
// copies for phase X of layer l + 1 go out when it finishes phase X of
// layer l (int8 ~34 KB and bf16 ~68 KB of tiles a block per layer, and
// ~17 KB of vectors; fp32 keeps one phase ahead in one region). The next
// layer's visible K/V rows are prefetched into L2, and a chunk's V rows
// into L1 while its scores are computed. K and V rows are read with
// 16-byte loads, Dh*es/16 lanes a row; a 16-row group with no visible key
// is not read, as long as some key of the row is visible (else every row
// counts, as in the reference). Values that other blocks wrote in this
// launch are read through L2, since L1 is not coherent across SMs. int8
// codes become floats by the bias trick (byte permute and one
// subtraction) rather than the quarter-rate I2F.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxD = 1024;
constexpr int kMaxF = 4096;
constexpr int kMaxS = 4096;
constexpr int kMaxDh = 64;
constexpr int kMaxCols = 128;       // output columns of one block's GEMV share
constexpr int kSlices = 4;          // split-K slices of out-proj and ffn2
constexpr int kMaxNC = 8;           // S-chunks per head
constexpr int kStamps = 13;         // trace points per layer (phase_cycles)
constexpr int kMaxDevices = 64;
using genie::kSpinLimit;   // polls (~seconds) before a missing producer traps

typedef unsigned long long u64;

struct Geo {
  int NC, CH;                       // S-chunks per head, rows per chunk
  int n[4], ipb[4], KR[4];          // items, items per block, rows per item of A-D
  int off[4];                       // regions (bytes) of phases A-D
  int tiles[4];                     // weight tile bytes at the head of each region
  int sc_off;                       // attention scores (CH floats)
  int ahead;                        // 1: a whole layer ahead, 0: one phase
  int dyn;                          // dynamic shared memory (bytes)
  // scratch: the tagged words (offsets in words: q, attention partials,
  // self scores, V rows at pos, proj partials, ff), then in floats the
  // ff2 partials and the barrier count
  int s_tag, n_tag, t_q, t_attp, t_self, t_vself, t_proj, t_ff;
  int s_ff2, s_sync, s_total;
};

struct Args {
  const void* w[4];          // qkv, out, ffn1, ffn2: [L, in, out] of W
  const float* s[4];         // per-channel scales [L, out] (int8 W), else null
  const float* b[4];         // biases [L, out]
  const float* n1s; const float* n1b; const float* n2s; const float* n2b;  // [L, D]
  void* kc; void* vc;        // [L, S, D] of C, updated in place at row pos
  const float* mask;         // [S], 1 = attend
  const float* h_in;         // [D]
  float* h_out;              // [D]
  float* scratch;            // Geo::s_total floats
  const uint8_t* tiles[4];   // the weights tiled per block: [L, grid, Geo::tiles]
  long long* trace;          // null, or [grid, L, kStamps] clock64 stamps
  const int* pos_ptr;        // the write row, one int32 in device memory
  int L, S, D, H, F, pos;    // pos: *pos_ptr, read once per block
  float scale, eps;
  Geo g;
};

// The items of block b in phase p (how many; item j's first row and first
// column, an element index): the kernel's plan and the host's tile layout
// both come from here. Phase A: blocks b < H (NC + 3), kind b % (NC + 3),
// head b / (NC + 3); kinds 0, 1, 2 produce q, k, v of the head and hold its
// column chunks, kinds 3.. are S-chunks and hold none. B, D: (K slice,
// column chunk) items; C: column chunks of whole columns.
__host__ __device__ inline int items_of(const Geo& g, int D, int H, int V, int p, int b) {
  if (p == 0) return b < g.n[0] && b % (g.NC + 3) < 3 ? (D / H) / V : 0;
  const int left = g.n[p] - b * g.ipb[p];
  return left < 0 ? 0 : left < g.ipb[p] ? left : g.ipb[p];
}
__host__ __device__ inline void item_at(const Geo& g, int D, int H, int V, int p, int b, int j,
                                        int* row0, int* col) {
  const int Dh = D / H, nc = D / V, i = b * g.ipb[p] + j;
  if (p == 0) {
    *row0 = 0;
    *col = (b % (g.NC + 3)) * D + (b / (g.NC + 3)) * Dh + j * V;
  } else if (p == 2) {
    *row0 = 0;
    *col = i * V;
  } else {
    *row0 = (i / nc) * g.KR[p];
    *col = (i % nc) * V;
  }
}

// A block's share of each phase, computed once per launch (the index
// arithmetic is the same in every layer, and integer division is slow):
// items j < ni, each KR rows of one 16-byte column chunk, from row0[j] of
// column col[j] (an element index); out[j] is where its V results go.
// Phase A has one item kind per block: 0, 1, 2 produce q, k, v of head
// `head`, 3.. are its S-chunks; a producer's items are its head's column
// chunks. Tiles lie in shared memory as [item][row] x 16 bytes.
constexpr int kMaxItems = kMaxCols / 4;        // V >= 4 columns an item
struct Plan {
  int ni[4], KR[4], gpi[4];
  int row0[4][kMaxItems], col[4][kMaxItems], out[4][kMaxItems];
  int wmask[4][kMaxItems];                      // the warps that hold an item's rows
  int wj[4][kWarps], wrg[4][kWarps], wn[4][kWarps];  // a warp's first group, its count
  int kind, head;                               // phase A (kind -1: no item)
  int h0, h1;                                   // phase B: the heads of its K slices
  int k0, k1;                                   // phase D: its rows of ff
};

template <typename W>
__device__ void make_plan(const Args& a, Plan& P) {
  constexpr int V = genie::Pack16<W>::N;
  const Geo& g = a.g;
  const int D = a.D, Dh = D / a.H, nc = D / V, b = blockIdx.x;
  if (threadIdx.x < 4) {
    const int p = threadIdx.x;
    const int ni = items_of(g, D, a.H, V, p, b), i0 = b * g.ipb[p];
    P.ni[p] = ni;
    P.KR[p] = g.KR[p];
    P.gpi[p] = g.KR[p] / 32;
    if (p == 1 && ni) {
      P.h0 = (i0 / nc) * (g.KR[1] / Dh);
      P.h1 = ((i0 + ni - 1) / nc + 1) * (g.KR[1] / Dh);
    }
    if (p == 3 && ni) {
      P.k0 = (i0 / nc) * g.KR[3];
      P.k1 = ((i0 + ni - 1) / nc + 1) * g.KR[3];
    }
  }
  if (threadIdx.x == 4) {
    P.kind = b < g.n[0] ? b % (g.NC + 3) : -1;
    P.head = b / (g.NC + 3);
  }
  __syncthreads();
  for (int t = threadIdx.x; t < 4 * kMaxItems; t += kThreads) {
    const int p = t / kMaxItems, j = t % kMaxItems;
    if (j >= P.ni[p]) continue;
    int row0, col;
    item_at(g, D, a.H, V, p, b, j, &row0, &col);
    // where the results go: q/k/v by column within the head, ff by column,
    // proj and ff2 partials by (slice, column)
    const int out = p == 0 ? j * V : p == 2 ? col : (row0 / g.KR[p]) * D + col;
    P.row0[p][j] = row0;
    P.col[p][j] = col;
    P.out[p][j] = out;
    const int gpi = P.gpi[p], ng = P.ni[p] * gpi;
    int mask = 0;
    for (int w = 0; w < kWarps; ++w) {
      const int a0 = w * ng / kWarps, a1 = (w + 1) * ng / kWarps;
      if (a0 < a1 && a0 < (j + 1) * gpi && a1 > j * gpi) mask |= 1 << w;
    }
    P.wmask[p][j] = mask;
  }
  if (threadIdx.x < 4 * kWarps) {
    const int p = threadIdx.x / kWarps, w = threadIdx.x % kWarps;
    const int gpi = P.gpi[p], ng = P.ni[p] * gpi;
    const int g0 = w * ng / kWarps, g1 = (w + 1) * ng / kWarps;
    P.wn[p][w] = g1 - g0;
    P.wj[p][w] = gpi ? g0 / gpi : 0;
    P.wrg[p][w] = gpi ? g0 % gpi : 0;
  }
  __syncthreads();
}

// Start, from one thread, the bulk copies of this block's phase `phase` of
// layer l into `dst`, completing on `mbar`: its weight tile (contiguous in
// the wrapper's tiled copy of the weights), then the small vectors:
//   phase A: scale, bias, LN gain, LN bias of the last layer's ffn2 / LN2
//            [4 x D], then scale and bias of a producer's qkv columns [2 x Dh]
//   phase C: the same of this layer's out-proj / LN1 [4 x D], then scale
//            and bias of the block's ffn1 columns [2 x ipb * V]
// (a scale is absent for float weights).
__device__ __noinline__ void load_phase(const Args& a, const Plan& P, int phase, int l,
                                  uint8_t* dst, u64* mbar, int V) {
  const Geo& g = a.g;
  const int D = a.D;
  const void* src[8];
  unsigned bytes[8], off[8];
  int n = 0;
  auto add = [&](const void* p, unsigned o, unsigned b) {
    if (p != nullptr && b > 0) {
      src[n] = p;
      off[n] = o;
      bytes[n++] = b;
    }
  };
  if (P.ni[phase] > 0)
    add(a.tiles[phase] + ((size_t)l * gridDim.x + blockIdx.x) * g.tiles[phase], 0,
        g.tiles[phase]);
  const unsigned v0 = g.tiles[phase];
  if (phase == 0) {
    if (l > 0) {
      const size_t o = (size_t)(l - 1) * D;
      add(a.s[3] ? a.s[3] + o : nullptr, v0, 4 * D);
      add(a.b[3] + o, v0 + 4 * D, 4 * D);
      add(a.n2s + o, v0 + 8 * D, 4 * D);
      add(a.n2b + o, v0 + 12 * D, 4 * D);
    }
    if (P.ni[0] > 0) {
      const size_t o = (size_t)l * 3 * D + P.col[0][0];
      const int Dh = D / a.H;
      add(a.s[0] ? a.s[0] + o : nullptr, v0 + 16 * D, 4 * Dh);
      add(a.b[0] + o, v0 + 16 * D + 4 * Dh, 4 * Dh);
    }
  } else if (phase == 2) {
    const size_t o = (size_t)l * D;
    add(a.s[1] ? a.s[1] + o : nullptr, v0, 4 * D);
    add(a.b[1] + o, v0 + 4 * D, 4 * D);
    add(a.n1s + o, v0 + 8 * D, 4 * D);
    add(a.n1b + o, v0 + 12 * D, 4 * D);
    if (P.ni[2] > 0) {
      const size_t oc = (size_t)l * a.F + P.col[2][0];
      add(a.s[2] ? a.s[2] + oc : nullptr, v0 + 16 * D, 4 * P.ni[2] * V);
      add(a.b[2] + oc, v0 + 16 * D + 4 * g.ipb[2] * V, 4 * P.ni[2] * V);
    }
  }
  unsigned total = 0;
  for (int i = 0; i < n; ++i) total += bytes[i];
  asm volatile("fence.proxy.async.shared::cta;" ::: "memory");
  genie::mbar_expect(mbar, total);
  for (int i = 0; i < n; ++i) genie::bulk_copy(dst + off[i], src[i], bytes[i], mbar);
}

// The grid barrier, split: a block arrives when its work is done, starts
// its next copies while the others finish, then waits. `cnt` counts
// arrivals; barrier k of the launch is passed at (k + 1) * gridDim.x.
__device__ __forceinline__ void grid_arrive(unsigned* cnt) {
  __syncthreads();
  if (threadIdx.x == 0) {
    __threadfence();
    atomicAdd(cnt, 1u);
  }
}
__device__ __forceinline__ unsigned ld_acquire(const unsigned* p) {
  unsigned v;
  asm volatile("ld.acquire.gpu.global.u32 %0, [%1];" : "=r"(v) : "l"(p) : "memory");
  return v;
}
__device__ __forceinline__ void grid_wait(const unsigned* cnt, unsigned target) {
  if (threadIdx.x == 0) {
    long long n = 0;
    while (ld_acquire(cnt) < target)
      if (++n > kSpinLimit) __trap();
  }
  __syncthreads();
}

// Tagged values: a 64-bit word holds a float and the layer (+ 1) that
// wrote it, stored and loaded whole. A consumer polls the words it needs
// until every tag is its layer's: a point-to-point handoff in place of a
// grid barrier. The tagged buffers are zeroed at the start of a launch.
__device__ __forceinline__ void st_tag(u64* p, float v, unsigned tag) {
  const u64 w = (u64)tag << 32 | __float_as_uint(v);
  asm volatile("st.relaxed.gpu.global.u64 [%0], %1;" ::"l"(p), "l"(w) : "memory");
}
__device__ __forceinline__ u64 ld_word(const u64* p) {
  u64 w;
  asm volatile("ld.relaxed.gpu.global.u64 %0, [%1];" : "=l"(w) : "l"(p) : "memory");
  return w;
}
// v[k] = the value at p[k * stride] for k < n (N >= n), all polled together
template <int N>
__device__ __forceinline__ void ld_tags(const u64* p, int stride, int n, unsigned tag, float* v) {
  long long spins = 0;
  bool ready;
  do {
    ready = true;
#pragma unroll
    for (int k = 0; k < N; ++k)
      if (k < n) {
        const u64 w = ld_word(p + (size_t)k * stride);
        v[k] = __uint_as_float((unsigned)w);
        ready &= (unsigned)(w >> 32) == tag;
      }
    if (++spins > kSpinLimit) __trap();
  } while (!ready);
}

// The warp-wide sums of V values, reduce-scatter: each halving step sends
// half of a lane's values to its partner (V - 1 shuffles in all, then the
// remaining butterfly steps); column v's sum ends in lanes whose bits
// above the halving steps spell v. Returns this lane's sum and sets *col.
template <int V>
__device__ __forceinline__ float warp_sums(float (&acc)[V], int lane, int* col) {
  constexpr int kSteps = V == 16 ? 4 : V == 8 ? 3 : 2;   // log2(V)
  int width = V, c = 0;
#pragma unroll
  for (int st = 0; st < kSteps; ++st) {
    const int off = 16 >> st;
    const bool upper = (lane & off) != 0;
    width >>= 1;
#pragma unroll
    for (int i = 0; i < V / 2; ++i)
      if (i < width) {
        const float send = upper ? acc[i] : acc[i + width];
        const float keep = upper ? acc[i + width] : acc[i];
        acc[i] = keep + __shfl_xor_sync(0xffffffffu, send, off);
      }
    c = c * 2 + (upper ? 1 : 0);
  }
  float v = acc[0];
#pragma unroll
  for (int off = 16 >> kSteps; off > 0; off >>= 1) v += __shfl_xor_sync(0xffffffffu, v, off);
  *col = c;
  return v;
}

// One block's GEMV share of `phase` from its tiles in shared memory: thread
// t = j * V + v < ni * V gets sum_r xs[row0[j] + r] * W[row0[j] + r, col[j] + v].
// Each warp takes a contiguous run of 32-row groups; partial sums meet in
// `red` and are added in warp order. One copy serves all four phases.
template <typename W>
__device__ __noinline__ float gemv(const Plan& P, int phase, const uint4* wt, const float* xs,
                                   float* red) {
  constexpr int V = genie::Pack16<W>::N;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int KR = P.KR[phase], gpi = P.gpi[phase], n = P.wn[phase][warp];
  int j = P.wj[phase][warp], rg = P.wrg[phase][warp];
  int row0 = n ? P.row0[phase][j] : 0;
  float acc[V];
#pragma unroll
  for (int v = 0; v < V; ++v) acc[v] = 0.f;
  for (int k = 0; k < n; ++k) {
    const int r = rg * 32 + lane;
    float wv[V];
    genie::Pack16<W>::unpack(wt[j * KR + r], wv);
    const float x = xs[row0 + r];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = fmaf(x, wv[v], acc[v]);
    const bool end = ++rg == gpi;
    if (end || k == n - 1) {
      int c;
      const float s = warp_sums<V>(acc, lane, &c);
      if ((lane & ((32 / V) - 1)) == 0) red[(j * kWarps + warp) * V + c] = s;
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = 0.f;
      if (end && k < n - 1) {
        rg = 0;
        row0 = P.row0[phase][++j];
      }
    }
  }
  __syncthreads();
  float s = 0.f;
  const int t = threadIdx.x;
  if (t < P.ni[phase] * V) {
    const int jj = t / V, v = t % V, mask = P.wmask[phase][jj];
#pragma unroll
    for (int w = 0; w < kWarps; ++w)
      if (mask >> w & 1) s += red[(jj * kWarps + w) * V + v];
  }
  return s;
}

// hs = LayerNorm(hs + sum_k p[k * D + .] * scale + bias) over D, where p
// holds the kSlices split-K partials of other blocks (floats read through
// L2, or tagged words of layer tag; summed in order, all loads of an
// element in flight at once) and scale may be null;
// fp32 statistics (mean, then the mean square deviation, as the plain
// version), in every block, in a fixed order: every block holds the same
// bits. Then xs = hs rounded to the compute dtype (round_bf16: C is bf16).
template <typename Part>
__device__ __noinline__ void add_layer_norm(float* hs, const Part* p, unsigned tag,
                                            const float* scale, const float* bias,
                                            const float* g, const float* b, int D, float eps,
                                            float* red32, float* xs, bool round_bf16) {
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    float v[kSlices];
    if constexpr (sizeof(Part) == 8) {
      ld_tags<kSlices>(p + i, D, kSlices, tag, v);
    } else {
#pragma unroll
      for (int k = 0; k < kSlices; ++k) v[k] = __ldcg(p + (size_t)k * D + i);
    }
    float t = 0.f;
#pragma unroll
    for (int k = 0; k < kSlices; ++k) t += v[k];
    const float x = hs[i] + (scale ? t * scale[i] : t) + bias[i];
    hs[i] = x;
    s += x;
  }
  const float mean = genie::block_sum(s, red32) / D;
  float q = 0.f;
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float d = hs[i] - mean;
    q += d * d;
  }
  const float r = rsqrtf(genie::block_sum(q, red32) / D + eps);
  for (int i = threadIdx.x; i < D; i += kThreads) {
    const float v = (hs[i] - mean) * r * g[i] + b[i];
    hs[i] = v;
    xs[i] = round_bf16 ? genie::round_to<__nv_bfloat16>(v) : v;
  }
  __syncthreads();
}

// The flash partial (m, l, o) of head h over chunk c of NC, as tagged words: the 16-row
// groups c, c + NC, c + 2 NC, ... of the cache (interleaved, so the visible
// rows spread evenly over the chunks), except row pos; into out[0],
// out[1], out[2 + d]. Local row t of the chunk is cache row
// (c + (t / 16) NC) 16 + t % 16; sc and gskip are indexed by local rows
// and groups. Returns the number of local groups.
template <typename C, int DH>
__device__ int attend_chunk(const Args& a, const C* kc, const C* vc, int h, int c, int NC,
                            bool anyv, const float* qs, float* sc, uint8_t* gskip,
                            float (*part)[kMaxDh], float* red32, u64* out, unsigned tag) {
  constexpr int P = genie::Pack16<C>::N;
  constexpr int LPR = DH / P, RPL = 32 / LPR, NLD = 16 / RPL;
  const int D = a.D, S = a.S, pos = a.pos;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int cc = lane % LPR, slot = lane / LPR;
  const int total = (S + 15) / 16;
  const int ngroups = total > c ? (total - c + NC - 1) / NC : 0;
  float qr[P];
#pragma unroll
  for (int i = 0; i < P; ++i) qr[i] = qs[cc * P + i];

  float lmax = -INFINITY;
  for (int g = warp; g < ngroups; g += kWarps) {
    const int g0 = (c + g * NC) * 16, s16 = g0 + lane;
    const int vis = lane < 16 && s16 < S && s16 != pos && __ldg(a.mask + s16) != 0.f;
    const bool skip = anyv && !__any_sync(0xffffffffu, vis);
    if (lane == 0) gskip[g] = skip;
    if (skip) {
      if (lane < 16) sc[g * 16 + lane] = -INFINITY;
      continue;
    }
    uint4 u[NLD];
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int s = g0 + j * RPL + slot;
      u[j] = s < S && s != pos
                 ? __ldg(reinterpret_cast<const uint4*>(kc + (size_t)s * D + h * DH) + cc)
                 : make_uint4(0, 0, 0, 0);
      // the V row, read after the softmax: into L1 now
      if (cc == 0 && s < S && s != pos)
        asm volatile("prefetch.global.L1 [%0];" ::"l"(vc + (size_t)s * D + h * DH));
    }
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      float f[P];
      genie::Pack16<C>::unpack(u[j], f);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) acc = fmaf(qr[i], f[i], acc);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      const int s = g0 + j * RPL + slot;
      if (cc == 0) {
        const float x = s >= S || s == pos
                            ? -INFINITY
                            : acc * a.scale + (__ldg(a.mask + s) - 1.f) * 1e10f;
        sc[g * 16 + j * RPL + slot] = x;
        lmax = fmaxf(lmax, x);
      }
    }
  }
  const float m = genie::block_max(lmax, red32);
  if (m == -INFINITY) {                 // nothing to attend to in this chunk
    for (int i = threadIdx.x; i < DH + 2; i += kThreads) st_tag(out + i, i == 0 ? -INFINITY : 0.f, tag);
    return ngroups;
  }
  float lsum = 0.f;
  for (int t = threadIdx.x; t < ngroups * 16; t += kThreads) {
    const float e = expf(sc[t] - m);
    sc[t] = e;
    lsum += e;
  }
  const float l = genie::block_sum(lsum, red32);

  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;
  for (int g = warp; g < ngroups; g += kWarps) {
    if (gskip[g]) continue;
    const int g0 = (c + g * NC) * 16;
    uint4 u[NLD];
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int s = g0 + j * RPL + slot;
      u[j] = s < S && s != pos
                 ? __ldg(reinterpret_cast<const uint4*>(vc + (size_t)s * D + h * DH) + cc)
                 : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const float p = sc[g * 16 + j * RPL + slot];
      float f[P];
      genie::Pack16<C>::unpack(u[j], f);
#pragma unroll
      for (int i = 0; i < P; ++i) acc[i] = fmaf(p, f[i], acc[i]);
    }
  }
#pragma unroll
  for (int i = 0; i < P; ++i)
#pragma unroll
    for (int o = LPR; o < 32; o <<= 1) acc[i] += __shfl_xor_sync(0xffffffffu, acc[i], o);
  if (slot == 0)
#pragma unroll
    for (int i = 0; i < P; ++i) part[warp][cc * P + i] = acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < DH; d += kThreads) {
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += part[w][d];
    st_tag(out + 2 + d, o, tag);
  }
  if (threadIdx.x == 0) {
    st_tag(out, m, tag);
    st_tag(out + 1, l, tag);
  }
  return ngroups;
}

template <typename W, typename C, int DH>
__global__ void __launch_bounds__(kThreads, 1) fused_decode_kernel(const Args args) {
  constexpr int V = genie::Pack16<W>::N;
  constexpr bool kBf16 = sizeof(C) == 2;
  extern __shared__ __align__(16) uint8_t wsm[];
  __shared__ Args a;          // the arguments, read by the shared helpers
  __shared__ float xs[kMaxF];
  __shared__ float hs[kMaxD];
  __shared__ float red[kWarps * kMaxCols];
  __shared__ float part[kWarps][kMaxDh];
  __shared__ float qk[2 * kMaxDh];
  __shared__ float red32[3 * kWarps > 32 ? 3 * kWarps : 32];
  __shared__ uint8_t gskip[kMaxS / 16];
  __shared__ Plan P;
  __shared__ u64 mbar[4];

  if (threadIdx.x == 0) {
    a = args;
    // the write row lives in device memory, so a captured graph replays
    // the step at the row its caller advanced on the device
    a.pos = *args.pos_ptr;
    if (a.pos < 0 || a.pos >= a.S) __trap();
  }
  __syncthreads();
  make_plan<W>(a, P);
  cg::grid_group grid = cg::this_grid();
  const Geo& g = a.g;
  const int D = a.D, NC = g.NC;
  float* sc = reinterpret_cast<float*>(wsm + g.sc_off);
  u64* tagged = reinterpret_cast<u64*>(a.scratch + g.s_tag);
  u64* qtag = tagged + g.t_q;
  u64* attp = tagged + g.t_attp;
  u64* sself = tagged + g.t_self;
  u64* vself = tagged + g.t_vself;
  u64* proj = tagged + g.t_proj;
  u64* ff = tagged + g.t_ff;
  float* ff2 = a.scratch + g.s_ff2;
  auto region = [&](int phase) { return wsm + g.off[phase]; };
  auto wtile = [&](int phase) { return reinterpret_cast<const uint4*>(region(phase)); };
  auto vecs = [&](int phase) {
    return reinterpret_cast<const float*>(region(phase) + g.tiles[phase]);
  };
  // a region fills once a layer (a layer ahead), or once a phase (one
  // region, one phase ahead); fill k completes phase k of its mbarrier
  auto mbar_of = [&](int phase) { return &mbar[g.ahead ? phase : 0]; };
  // wait for the copies of phase `phase` of layer l; the block barrier
  // after it also publishes what the block's threads wrote before it
  auto wait_tiles = [&](int phase, int l) {
    genie::mbar_wait(mbar_of(phase), g.ahead ? l & 1 : phase & 1);
    __syncthreads();
  };
  // after phase `phase` of layer l: the next tiles into the freed region
  auto prefetch = [&](int phase, int l) {
    __syncthreads();
    const int np = g.ahead ? phase : (phase + 1) % 4;
    const int nl = g.ahead || phase == 3 ? l + 1 : l;
    if (threadIdx.x == 0 && nl < a.L) load_phase(a, P, np, nl, region(np), mbar_of(np), V);
  };
  // the grid barrier after phase D of layer l, with D's next copies started
  // between arriving and waiting
  unsigned* bar = reinterpret_cast<unsigned*>(a.scratch + g.s_sync);
  unsigned passed = 0;
  auto barrier = [&](int l) {
    grid_arrive(bar);
    prefetch(3, l);
    grid_wait(bar, ++passed * gridDim.x);
  };
  // the optional trace: a clock64 stamp per block at kStamps points of a
  // layer, in program order (see fused_decode.py::phase_cycles)
  auto stamp = [&](int l, int i) {
    if (a.trace != nullptr && threadIdx.x == 0)
      a.trace[((size_t)blockIdx.x * a.L + l) * kStamps + i] = clock64();
  };

  for (int i = threadIdx.x; i < D; i += kThreads) {
    hs[i] = a.h_in[i];
    xs[i] = genie::round_to<C>(hs[i]);
  }
  int vis = 0;
  for (int s = threadIdx.x; s < a.S; s += kThreads) vis |= a.mask[s] == 1.f;
  const bool anyv = __syncthreads_or(vis);
  if (threadIdx.x == 0) {
    for (int i = 0; i < 4; ++i) genie::mbar_init(&mbar[i]);
    for (int p = 0; p < (g.ahead ? 4 : 1); ++p) load_phase(a, P, p, 0, region(p), mbar_of(p), V);
  }
  // the barrier count and the tagged words start at 0 in every launch
  if (blockIdx.x == 0 && threadIdx.x == 0) *bar = 0;
  for (int i = blockIdx.x * kThreads + threadIdx.x; i < g.n_tag; i += gridDim.x * kThreads)
    tagged[i] = 0;
  grid.sync();

  for (int l = 0; l < a.L; ++l) {
    const unsigned tag = l + 1;
    // ---- A: LN2 of the last layer, qkv of this block's head, attention
    stamp(l, 0);
    wait_tiles(0, l);
    const float* va = vecs(0);
    if (l > 0) {
      add_layer_norm(hs, ff2, 0u, a.s[3] ? va : nullptr, va + D, va + 2 * D, va + 3 * D, D,
                     a.eps, red32, xs, kBf16);
    }
    stamp(l, 1);
    if (P.kind >= 0) {
      const int h = P.head, kind = P.kind;
      C* kc = reinterpret_cast<C*>(a.kc) + (size_t)l * a.S * D;
      C* vc = reinterpret_cast<C*>(a.vc) + (size_t)l * a.S * D;
      float* qs = qk + kMaxDh;
      if (kind < 3) {                          // producers: q, k or v of head h
        const float* vq = va + 4 * D;
        const float r = gemv<W>(P, 0, wtile(0), xs, red);
        const int d = threadIdx.x;
        if (d < DH) {
          const C y = genie::from_f<C>(r * (a.s[0] ? vq[d] : 1.f) + vq[DH + d]);
          if (kind == 0) {                     // q_h, to its consumers
            st_tag(qtag + h * DH + d, genie::to_f(y), tag);
          } else if (kind == 1) {              // the K row at pos, in place
            kc[(size_t)a.pos * D + h * DH + d] = y;
            qk[d] = genie::to_f(y);
          } else {                             // the V row at pos, in place
            vc[(size_t)a.pos * D + h * DH + d] = y;
            st_tag(vself + h * DH + d, genie::to_f(y), tag);
          }
        }
      }
      if (kind == 1 || kind >= 3) {            // consumers of q_h
        if (threadIdx.x < DH) ld_tags<1>(qtag + h * DH + threadIdx.x, 0, 1, tag, qs + threadIdx.x);
        __syncthreads();
      }
      stamp(l, 2);
      if (kind == 1) {                         // the score of row pos
        if (threadIdx.x < 32) {
          float t = 0.f;
          for (int d = threadIdx.x; d < DH; d += 32) t = fmaf(qs[d], qk[d], t);
          t = genie::warp_sum(t);
          if (threadIdx.x == 0) st_tag(sself + h, t * a.scale + (a.mask[a.pos] - 1.f) * 1e10f, tag);
        }
      } else if (kind >= 3) {                  // an S-chunk's flash partial
        const int c = kind - 3;
        const int ng = attend_chunk<C, DH>(a, kc, vc, h, c, NC, anyv, qs, sc, gskip, part,
                                           red32, attp + (size_t)(h * NC + c) * (DH + 2), tag);
        // the next layer reads the same rows (the mask does not change):
        // bring them into L2 under this layer's remaining phases
        if (l + 1 < a.L)
          for (int t = threadIdx.x; t < 2 * 16 * ng; t += kThreads) {
            const int lr = t / 2, s = (c + (lr / 16) * NC) * 16 + lr % 16;
            if (s >= a.S || s == a.pos || gskip[lr / 16]) continue;
            const C* row = (t & 1 ? vc : kc) + (size_t)a.S * D + (size_t)s * D + h * DH;
            asm volatile("prefetch.global.L2 [%0];" ::"l"(row));
          }
      }
    }
    stamp(l, 3);
    prefetch(0, l);
    stamp(l, 4);

    // ---- B: combine the heads of this block's K slices, then its share
    // of att . Wout
    if (P.ni[1] > 0) {
      const int h0 = P.h0, h1 = P.h1;
      for (int t = threadIdx.x; t < (h1 - h0) * DH; t += kThreads) {
        const int h = h0 + t / DH, d = t % DH;
        const u64* ap = attp + (size_t)h * NC * (DH + 2);
        // every partial of (h, d), polled together: chunks, then self
        float ms[kMaxNC + 1], ls[kMaxNC + 1], os[kMaxNC + 1];
        ld_tags<kMaxNC>(ap, DH + 2, NC, tag, ms);
        ld_tags<kMaxNC>(ap + 1, DH + 2, NC, tag, ls);
        ld_tags<kMaxNC>(ap + 2 + d, DH + 2, NC, tag, os);
        ld_tags<1>(sself + h, 0, 1, tag, ms + NC);
        ld_tags<1>(vself + h * DH + d, 0, 1, tag, os + NC);
        ls[NC] = 1.f;
#pragma unroll
        for (int k = 0; k <= kMaxNC; ++k)
          if (k > NC) ms[k] = -INFINITY;
        float m = -INFINITY;
#pragma unroll
        for (int k = 0; k <= kMaxNC; ++k) m = fmaxf(m, ms[k]);
        float lt = 0.f, o = 0.f;
#pragma unroll
        for (int k = 0; k <= kMaxNC; ++k)
          if (ms[k] != -INFINITY) {
            const float e = expf(ms[k] - m);
            lt = fmaf(e, ls[k], lt);
            o = fmaf(e, os[k], o);
          }
        xs[h * DH + d] = genie::round_to<C>(o / lt);
      }
    }
    wait_tiles(1, l);
    if (P.ni[1] > 0) {
      const float r = gemv<W>(P, 1, wtile(1), xs, red);
      const int t = threadIdx.x;
      if (t < P.ni[1] * V) st_tag(proj + P.out[1][t / V] + t % V, r, tag);
    }
    stamp(l, 5);
    prefetch(1, l);
    stamp(l, 6);

    // ---- C: LN1 (the proj partials in order), then ffn1 columns
    wait_tiles(2, l);
    const float* vcv = vecs(2);
    stamp(l, 7);
    add_layer_norm(hs, proj, tag, a.s[1] ? vcv : nullptr, vcv + D, vcv + 2 * D, vcv + 3 * D,
                   D, a.eps, red32, xs, kBf16);
    stamp(l, 8);
    if (P.ni[2] > 0) {
      const float* v1 = vcv + 4 * D;
      const float r = gemv<W>(P, 2, wtile(2), xs, red);
      const int c = threadIdx.x;
      if (c < P.ni[2] * V)
        st_tag(ff + P.col[2][0] + c,
               fmaxf(r * (a.s[2] ? v1[c] : 1.f) + v1[g.ipb[2] * V + c], 0.f), tag);
    }
    stamp(l, 9);
    prefetch(2, l);
    stamp(l, 10);

    // ---- D: this block's split-K share of ff . W2
    if (P.ni[3] > 0) {
      for (int k = P.k0 + threadIdx.x; k < P.k1; k += kThreads) {
        float v;
        ld_tags<1>(ff + k, 0, 1, tag, &v);
        xs[k] = genie::round_to<C>(v);
      }
    }
    wait_tiles(3, l);
    stamp(l, 11);
    if (P.ni[3] > 0) {
      const float r = gemv<W>(P, 3, wtile(3), xs, red);
      const int t = threadIdx.x;
      if (t < P.ni[3] * V) ff2[P.out[3][t / V] + t % V] = r;
    }
    stamp(l, 12);
    barrier(l);
  }
  // the last LN2, from device memory (once a step)
  const size_t o = (size_t)(a.L - 1) * D;
  add_layer_norm(hs, ff2, 0u, a.s[3] ? a.s[3] + o : nullptr, a.b[3] + o, a.n2s + o, a.n2b + o,
                 D, a.eps, red32, xs, kBf16);
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < D; i += kThreads) a.h_out[i] = hs[i];
}

// n grid barriers and nothing else, on the step kernel's grid: what the
// step's L barriers cost alone.
__device__ unsigned probe_count;

__global__ void __launch_bounds__(kThreads, 1) barrier_loop_kernel(int n) {
  if (blockIdx.x == 0 && threadIdx.x == 0) probe_count = 0;
  cg::this_grid().sync();
  for (int i = 0; i < n; ++i) {
    grid_arrive(&probe_count);
    grid_wait(&probe_count, (i + 1) * gridDim.x);
  }
}

// Static facts of the current device, read once per device.
struct DeviceInfo {
  int sms, coop, smem_optin;
};

int device_info(DeviceInfo* out) {
  static DeviceInfo info[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  if (info[dev].sms == 0) {
    DeviceInfo d{};
    cudaDeviceGetAttribute(&d.sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&d.coop, cudaDevAttrCooperativeLaunch, dev);
    cudaDeviceGetAttribute(&d.smem_optin, cudaDevAttrMaxSharedMemoryPerBlockOptin, dev);
    info[dev] = d;
  }
  *out = info[dev];
  return 0;
}

// The geometry of a launch; 0 or cudaErrorInvalidValue.
int make_geo(int S, int D, int H, int F, int wbytes, int cbytes, int G, int static_smem,
             int smem_optin, Geo* g) {
  const int V = 16 / wbytes;
  if (H < 1 || D % H != 0) return (int)cudaErrorInvalidValue;
  const int Dh = D / H;
  const int KRB = D / kSlices;      // rows of an out-proj slice (whole heads)
  if (S < 1 || S > kMaxS || D > kMaxD || F > kMaxF || (Dh != 32 && Dh != 64) ||
      D % 32 != 0 || KRB % 32 != 0 || KRB % Dh != 0 || Dh % V != 0 ||
      F % (kSlices * 32) != 0 || (Dh * cbytes) % 16 != 0 || G < 4 * H)
    return (int)cudaErrorInvalidValue;
  g->NC = min(G / H - 3, kMaxNC);
  g->CH = (S + 16 * g->NC - 1) / (16 * g->NC) * 16;
  const int n[4] = {H * (g->NC + 3), kSlices * (D / V), F / V, kSlices * (D / V)};
  const int KR[4] = {D, KRB, D, F / kSlices};
  for (int p = 0; p < 4; ++p) {
    g->n[p] = n[p];
    g->KR[p] = KR[p];
    g->ipb[p] = p == 0 ? 1 : (n[p] + G - 1) / G;
    if (g->ipb[p] * V > kMaxCols)
      return (int)cudaErrorInvalidValue;
  }
  g->tiles[0] = Dh * D * wbytes;
  for (int p = 1; p < 4; ++p) g->tiles[p] = g->ipb[p] * KR[p] * 16;
  const int bytes[4] = {g->tiles[0] + (4 * D + 2 * Dh) * 4, g->tiles[1],
                        g->tiles[2] + (4 * D + 2 * g->ipb[2] * V) * 4, g->tiles[3]};
  const int total = bytes[0] + bytes[1] + bytes[2] + bytes[3];
  const int most = max(max(bytes[0], bytes[1]), max(bytes[2], bytes[3]));
  g->ahead = static_smem + total + g->CH * 4 <= smem_optin;
  int off = 0;
  for (int p = 0; p < 4; ++p) {
    g->off[p] = g->ahead ? off : 0;
    off += bytes[p];
  }
  g->sc_off = g->ahead ? total : most;
  g->dyn = g->sc_off + g->CH * 4;
  if (static_smem + g->dyn > smem_optin) return (int)cudaErrorInvalidValue;
  g->s_tag = 0;
  g->t_q = 0;
  g->t_attp = D;
  g->t_self = g->t_attp + H * g->NC * (Dh + 2);
  g->t_vself = g->t_self + H;
  g->t_proj = g->t_vself + D;
  g->t_ff = g->t_proj + kSlices * D;
  g->n_tag = g->t_ff + F;
  g->s_ff2 = g->s_tag + 2 * g->n_tag;
  g->s_sync = g->s_ff2 + kSlices * D;   // the barrier count
  g->s_total = g->s_sync + 1;
  return 0;
}

template <typename W, typename C, int DH>
int launch(Args& a, const DeviceInfo& dev, long long scratch_floats, cudaStream_t st) {
  auto kernel = fused_decode_kernel<W, C, DH>;
  static bool configured[kMaxDevices] = {};
  static int static_smem = 0;
  int d = 0;
  cudaGetDevice(&d);
  if (!configured[d]) {
    cudaFuncAttributes fa;
    cudaError_t e = cudaFuncGetAttributes(&fa, kernel);
    if (e != cudaSuccess) return (int)e;
    static_smem = (int)fa.sharedSizeBytes;
    e = cudaFuncSetAttribute(kernel, cudaFuncAttributeMaxDynamicSharedMemorySize,
                             dev.smem_optin - static_smem);
    if (e != cudaSuccess) return (int)e;
    configured[d] = true;
  }
  int err = make_geo(a.S, a.D, a.H, a.F, sizeof(W), sizeof(C), dev.sms, static_smem,
                     dev.smem_optin, &a.g);
  if (err) return err;
  if (scratch_floats < a.g.s_total) return (int)cudaErrorInvalidValue;
  int per_sm = 0;
  cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, kernel, kThreads, a.g.dyn);
  if (!dev.coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
  void* args[] = {&a};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(kernel), dim3(dev.sms), dim3(kThreads), args,
      a.g.dyn, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

template <typename W, typename C>
int launch_dh(Args& a, const DeviceInfo& dev, long long n, cudaStream_t st) {
  const int Dh = a.H > 0 ? a.D / a.H : 0;
  if (Dh == 32) return launch<W, C, 32>(a, dev, n, st);
  if (Dh == 64) return launch<W, C, 64>(a, dev, n, st);
  return (int)cudaErrorInvalidValue;
}

}  // namespace

// A timing probe: one cooperative launch of n grid barriers on the grid of
// fused_decode_step (one block of 256 threads per SM).
extern "C" int fused_decode_barriers(int n, void* stream) {
  DeviceInfo dev;
  if (int e = device_info(&dev)) return e;
  void* args[] = {&n};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(barrier_loop_kernel), dim3(dev.sms), dim3(kThreads),
      args, 0, reinterpret_cast<cudaStream_t>(stream));
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

// Floats of scratch that fused_decode_step needs on the current device for
// dims = (L, S, D, H, F) and weights of `wbytes` bytes, or -1 for dims the
// kernel does not take.
extern "C" long long fused_decode_scratch_floats(const int* dims, int wbytes) {
  DeviceInfo dev;
  if (device_info(&dev) != 0 || (wbytes != 1 && wbytes != 2 && wbytes != 4)) return -1;
  Geo g;
  // the size does not depend on the shared-memory plan: no limit here
  if (make_geo(dims[1], dims[2], dims[3], dims[4], wbytes, 2, dev.sms, 0, 1 << 30, &g))
    return -1;
  return g.s_total;
}

// The layout of the tiled weights: block b's tile of matrix `phase` (0 qkv,
// 1 out, 2 ffn1, 3 ffn2) for layer l is bytes [(l G + b) T, (l G + b + 1) T)
// of a [L, G, T] tensor, G the device's SM count and T 16 x the value
// returned; its 16-byte chunk j KR + r is the chunk at row row0(j) + r,
// column col(j) of the layer's matrix. With idx not null, writes for every
// block and chunk (G x T/16 entries) the index of that chunk in the
// layer's matrix seen as 16-byte chunks, 0 for padding. Returns T/16, or
// -1 for dims (L, S, D, H, F) the kernel does not take.
extern "C" long long fused_decode_tile_index(const int* dims, int wbytes, int phase,
                                             long long* idx) {
  DeviceInfo dev;
  if (device_info(&dev) != 0 || (wbytes != 1 && wbytes != 2 && wbytes != 4) || phase < 0 ||
      phase > 3)
    return -1;
  Geo g;
  const int S = dims[1], D = dims[2], H = dims[3], F = dims[4], V = 16 / wbytes;
  if (make_geo(S, D, H, F, wbytes, 2, dev.sms, 0, 1 << 30, &g)) return -1;
  const long long T = g.tiles[phase] / 16;
  const long long N = phase == 0 ? 3 * D : phase == 2 ? F : D;   // row length
  if (idx != nullptr)
    for (int b = 0; b < dev.sms; ++b) {
      long long* t = idx + b * T;
      for (long long c = 0; c < T; ++c) t[c] = 0;
      const int ni = items_of(g, D, H, V, phase, b);
      for (int j = 0; j < ni; ++j) {
        int row0, col;
        item_at(g, D, H, V, phase, b, j, &row0, &col);
        for (int r = 0; r < g.KR[phase]; ++r)
          t[(long long)j * g.KR[phase] + r] = ((row0 + r) * N + col) / V;
      }
    }
  return T;
}

// ptrs (28 device pointers, 0 for none): wqkv, wout, w1, w2, sqkv, sout, s1,
// s2, bqkv, bout, b1, b2, n1s, n1b, n2s, n2b, k_cache, v_cache, mask, h_in,
// h_out, scratch, trace (0 for none), then the tiled qkv, out, ffn1 and
// ffn2 weights (fused_decode_tile_index), then pos (one int32: the write
// row, read by the kernel; outside [0, S) it traps). dims: L, S, D, H, F.
// wtype: 0 float32, 1 bfloat16, 2 int8. ctype (caches and activations): 0 float32, 1 bfloat16. Float
// weights are in the compute dtype (wtype == ctype); int8 takes either.
// scratch_floats: the scratch's size (fused_decode_scratch_floats).
extern "C" int fused_decode_step(const unsigned long long* ptrs, const int* dims,
                                 float scale, float eps, int wtype, int ctype,
                                 long long scratch_floats, void* stream) {
  Args a;
  for (int m = 0; m < 4; ++m) {
    a.w[m] = reinterpret_cast<const void*>(ptrs[m]);
    a.s[m] = reinterpret_cast<const float*>(ptrs[4 + m]);
    a.b[m] = reinterpret_cast<const float*>(ptrs[8 + m]);
  }
  a.n1s = reinterpret_cast<const float*>(ptrs[12]);
  a.n1b = reinterpret_cast<const float*>(ptrs[13]);
  a.n2s = reinterpret_cast<const float*>(ptrs[14]);
  a.n2b = reinterpret_cast<const float*>(ptrs[15]);
  a.kc = reinterpret_cast<void*>(ptrs[16]);
  a.vc = reinterpret_cast<void*>(ptrs[17]);
  a.mask = reinterpret_cast<const float*>(ptrs[18]);
  a.h_in = reinterpret_cast<const float*>(ptrs[19]);
  a.h_out = reinterpret_cast<float*>(ptrs[20]);
  a.scratch = reinterpret_cast<float*>(ptrs[21]);
  a.trace = reinterpret_cast<long long*>(ptrs[22]);
  for (int p = 0; p < 4; ++p) {
    a.tiles[p] = reinterpret_cast<const uint8_t*>(ptrs[23 + p]);
    if (a.tiles[p] == nullptr) return (int)cudaErrorInvalidValue;
  }
  a.pos_ptr = reinterpret_cast<const int*>(ptrs[27]);
  a.L = dims[0]; a.S = dims[1]; a.D = dims[2]; a.H = dims[3]; a.F = dims[4];
  a.pos = 0;
  a.scale = scale;
  a.eps = eps;
  if ((wtype == 2) != (a.s[0] != nullptr) || a.pos_ptr == nullptr || a.L < 1)
    return (int)cudaErrorInvalidValue;
  DeviceInfo dev;
  if (int e = device_info(&dev)) return e;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (wtype * 2 + ctype) {
    case 0: return launch_dh<float, float>(a, dev, scratch_floats, st);
    case 3: return launch_dh<__nv_bfloat16, __nv_bfloat16>(a, dev, scratch_floats, st);
    case 4: return launch_dh<int8_t, float>(a, dev, scratch_floats, st);
    case 5: return launch_dh<int8_t, __nv_bfloat16>(a, dev, scratch_floats, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
