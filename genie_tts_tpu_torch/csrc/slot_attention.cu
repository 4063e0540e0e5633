// Decode attention of the slot machine's step over exact (bf16 or fp32)
// KV caches, for Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs this route (the exact,
// non-int8 slot cache of models/slots.py) as XLA ops, a gather of read
// windows and a masked softmax, and so did the port's plain PyTorch
// (models/t2s.py::buffered_attention, ~45 small kernels a layer that cast
// every window to fp32 each step). For each (slot b, head h) of one
// decode step, in one launch a layer:
//
//   visible(s) = s < x_len+p_len                       (compacted context)
//              | (rpos >= 0 & floor_mod(head-1-rpos, ring) < keys_written)
//                with rpos = s - (sx+sp)                (the first ring copy)
//   scores     = [q . K[:, s] for visible s | q . Kbuf[:, j] for j < col |
//                 q . k_new] / sqrt(Dh)                  fp32
//   p          = softmax(scores), rounded to T           (as the plain version)
//   out        = sum p V over the same columns            fp32 sum, stored in T
//
// and the step's own k_new / v_new are written into column `col` of the
// segment's write buffer. K, V [B,H,Dh,ld] kv-major (one row of columns
// per d), read in place over [0, S) with S = sx+sp+ring; the buffer
// [B,H,Dh,W]; q, k_new, v_new straight from the qkv projection's output
// (rows of a pitch, heads of Dh); out [B, H*Dh], the merged-heads row the
// output projection reads. The scalars are segment-frozen and live in
// device memory (x_len, p_len, keys_written [B], the ring head one int32),
// so a captured segment graph replays at what the last merge left there.
//
// What bounds it on the H100: the bytes of the visible columns, K and V,
// 2 * Dh * sizeof(T) a column: at the 8-slot serving geometry (H=16,
// Dh=32, bf16, 896 columns fully visible) 14.7 MB a layer, ~4.4 us at
// 3.35 TB/s. The arithmetic (4 * Dh FMAs a column) is far below the fp32
// rate, so the time is latency: memory round trips and barriers.
//
// Design:
//
// - Visibility as at most three column intervals from one modulo per
//   block (share_of, as csrc/int8_decode.cu; ops/int8_decode.py::
//   visible_intervals and chunk_share are its CPU twins); nothing is read
//   of a 16-column chunk that holds no visible column.
// - A cluster of 4 blocks per (b, h) splits the visible chunks evenly; the
//   last block also takes the buffer's columns and the step's own.
// - One memory round trip: at block start every block issues the V of its
//   columns into shared memory by cp.async (16 bytes each, zero-filled past
//   S), the last block first the buffer's K and V as a copy group of their
//   own, and then loads K with 16-byte loads straight into registers;
//   scores are computed while V lands. A column group's score is split over
//   4 lanes by d rows and summed by shuffles. (Read from device memory in
//   the last block's loops, the buffer cost a round trip a loop: 3.7 us of
//   15.3 at the serving geometry.)
// - At most 128 registers a thread (4 blocks an SM), so the 8-slot
//   geometry's 512 blocks run in one wave.
// - The blocks exchange (max, sum of exp) through distributed shared
//   memory (one cluster sync); each forms p = round_to<T>(exp(s - m) / l)
//   as the plain version rounds p, sums p * V over its columns (a few lanes
//   a d row), and the leader sums the four partial rows in rank order (a
//   second sync; a third keeps shared memory alive until it has).
// - Rows whose pitch or base is not 16-byte aligned take element loads
//   into the same buffers.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;                       // blocks per (b, h)
constexpr int kThreads = 128;
constexpr int kSlices = 4;                        // lanes a column group's score is split over
constexpr int kMaxS = 2048;

// A row's visible columns and one block's share of them: visible [0, c),
// [a1, e1), [a2, e2), disjoint and sorted (empty where a >= e), all below
// S. The block's 16-column chunks form up to three runs, laid out one after
// the other: run i starts at global chunk first[i] and holds n[i] chunks;
// local column j belongs to run 0 below lim1, run 1 below lim2, else run
// 2, and is global column j + off[run].
struct Share {
  int c, a1, e1, a2, e2;
  int first[3], n[3], off[3];
  int lim1, lim2, ncols;
};

__device__ __forceinline__ Share share_of(int ctx, int kw, int head, int sxsp, int ring,
                                          int S, int rank) {
  Share sh;
  const int c = min(max(ctx, 0), S);
  const int k = min(max(kw, 0), ring);
  int h = head % ring;                            // floor_mod, once per block
  if (h < 0) h += ring;
  int a1 = S, e1 = S, a2 = S, e2 = S;
  if (k == ring) {
    a1 = sxsp;
  } else if (k > 0 && h >= k) {
    a1 = sxsp + h - k;
    e1 = sxsp + h;
  } else if (k > 0) {
    a1 = sxsp;
    e1 = sxsp + h;
    a2 = S + h - k;
  }
  sh.c = c;                                       // ring columns below c are the context's
  sh.a1 = max(a1, c);
  sh.e1 = e1;
  sh.a2 = max(a2, c);
  sh.e2 = e2;
  const int a[3] = {0, sh.a1, sh.a2}, e[3] = {c, e1, e2};
  int cs[3], cn[3], prev = 0, total = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {                   // a chunk two intervals share counts once
    cs[i] = prev;
    cn[i] = 0;
    if (a[i] < e[i]) {
      const int hi = (e[i] + 15) >> 4;
      cs[i] = max(a[i] >> 4, prev);
      cn[i] = max(hi - cs[i], 0);
      prev = max(prev, hi);
    }
    total += cn[i];
  }
  const int r0 = total * rank / kCluster, r1 = total * (rank + 1) / kCluster;
  int base = 0, loc = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
    const int lo = max(base, r0), hi = min(base + cn[i], r1);
    sh.n[i] = max(hi - lo, 0);
    sh.first[i] = cs[i] + lo - base;
    sh.off[i] = 16 * (sh.first[i] - loc);
    loc += sh.n[i];
    base += cn[i];
  }
  sh.lim1 = 16 * sh.n[0];
  sh.lim2 = 16 * (sh.n[0] + sh.n[1]);
  sh.ncols = 16 * loc;
  return sh;
}

__device__ __forceinline__ int global_col(const Share& sh, int j) {
  return j + (j < sh.lim1 ? sh.off[0] : j < sh.lim2 ? sh.off[1] : sh.off[2]);
}

__device__ __forceinline__ bool visible(const Share& sh, int s) {
  return s < sh.c || (s >= sh.a1 && s < sh.e1) || (s >= sh.a2 && s < sh.e2);
}

// 16 bytes global -> shared, asynchronous; bytes past `src_bytes` are zeros
__device__ __forceinline__ void cp_async16(void* dst, const void* src, int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;" ::"r"(genie::smem_addr(dst)),
               "l"(src), "r"(src_bytes)
               : "memory");
}

// Shared memory (dynamic): the V of the block's columns [Dh][pitch] in T,
// the write buffer's K and V [Dh][W] in T (the last block's), then the
// scores and probabilities of its columns, the buffer's and the step's
// own, fp32.
template <typename T, int kDh, bool kVec>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads, 4)
slot_attn_kernel(const T* __restrict__ q, const T* __restrict__ kn, const T* __restrict__ vn,
                 long long qld, const T* __restrict__ kc, const T* __restrict__ vc, long long ld,
                 T* kb, T* vb, int W, int col, int bvec, const int* __restrict__ x_len,
                 const int* __restrict__ p_len, const int* __restrict__ keys_written,
                 const int* __restrict__ head, int sxsp, int ring, T* __restrict__ out, int H,
                 float scale, int pitch) {
  constexpr int kCpt = 16 / sizeof(T);            // columns of one 16-byte load
  constexpr int kRps = kDh / kSlices;             // d rows of one lane's score slice
  constexpr int kTpr = kThreads / kDh;            // lanes of one d row in P.V
  extern __shared__ __align__(16) uint8_t smem_raw[];
  T* vs = reinterpret_cast<T*>(smem_raw);
  T* kbs = vs + kDh * pitch;
  T* vbs = kbs + kDh * W;
  float* sc = reinterpret_cast<float*>(vbs + kDh * W);
  __shared__ float qs[kDh];
  __shared__ float obuf[kDh];
  __shared__ float stat[2];
  __shared__ float red[32];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y, b = bh / H, h = bh - b * H;
  const int tid = threadIdx.x;
  const int S = sxsp + ring;
  const Share sh = share_of(x_len[b] + p_len[b], keys_written[b], *head, sxsp, ring, S, rank);
  const int ncols = sh.ncols, ng = ncols / kCpt;
  const int nx = rank == kCluster - 1 ? col + 1 : 0;   // the buffer's [0, col) and the step's own
  const T* kp = kc + (size_t)bh * kDh * ld;
  const T* vp = vc + (size_t)bh * kDh * ld;
  T* kbp = kb + (size_t)bh * kDh * W;
  T* vbp = vb + (size_t)bh * kDh * W;
  const size_t row = (size_t)b * qld + (size_t)h * kDh;

  // the last block: the write buffer's K and V (all W columns; those from
  // col on go unread), a copy group of their own, first
  if (nx > 1) {
    if (bvec) {
      for (int i = tid * kCpt; i < kDh * W; i += kThreads * kCpt) {
        cp_async16(kbs + i, kbp + i, 16);
        cp_async16(vbs + i, vbp + i, 16);
      }
    } else {
      for (int i = tid; i < kDh * W; i += kThreads) {
        kbs[i] = kbp[i];
        vbs[i] = vbp[i];
      }
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  // V of the block's columns into shared memory, in flight while K is read
  for (int it = tid; it < kDh * ng; it += kThreads) {
    const int d = it / ng, j = (it - d * ng) * kCpt, s = global_col(sh, j);
    T* dst = vs + d * pitch + j;
    const T* src = vp + (size_t)d * ld + s;
    if constexpr (kVec) {
      const int bytes = max(min(S - s, kCpt), 0) * (int)sizeof(T);
      cp_async16(dst, bytes > 0 ? src : vp, bytes);
    } else {
#pragma unroll
      for (int c = 0; c < kCpt; ++c) dst[c] = s + c < S ? src[c] : genie::from_f<T>(0.f);
    }
  }
  asm volatile("cp.async.commit_group;" ::: "memory");
  if (tid < kDh) qs[tid] = genie::to_f(q[row + tid]);
  __syncthreads();

  // scores of the block's columns: lane (group g, slice sl) sums kRps rows
  float lmax = -INFINITY;
  for (int base = 0; base < ng * kSlices; base += kThreads) {
    const int it = base + tid, g = it / kSlices, sl = it % kSlices;
    const bool on = g < ng;
    const int j = g * kCpt, s = on ? global_col(sh, j) : 0;
    float acc[kCpt];
#pragma unroll
    for (int c = 0; c < kCpt; ++c) acc[c] = 0.f;
    if (on) {
      if (kVec && s + kCpt <= S) {
        uint4 u[kRps];
#pragma unroll
        for (int r = 0; r < kRps; ++r)
          u[r] = __ldg(reinterpret_cast<const uint4*>(kp + (size_t)(sl * kRps + r) * ld + s));
#pragma unroll
        for (int r = 0; r < kRps; ++r) {
          float f[kCpt];
          genie::Pack16<T>::unpack(u[r], f);
          const float qd = qs[sl * kRps + r];
#pragma unroll
          for (int c = 0; c < kCpt; ++c) acc[c] = fmaf(qd, f[c], acc[c]);
        }
      } else {
        for (int r = 0; r < kRps; ++r) {
          const T* kr = kp + (size_t)(sl * kRps + r) * ld + s;
          const float qd = qs[sl * kRps + r];
#pragma unroll
          for (int c = 0; c < kCpt; ++c)
            if (s + c < S) acc[c] = fmaf(qd, genie::to_f(kr[c]), acc[c]);
        }
      }
    }
#pragma unroll
    for (int c = 0; c < kCpt; ++c)
#pragma unroll
      for (int o = 1; o < kSlices; o <<= 1) acc[c] += __shfl_xor_sync(0xffffffffu, acc[c], o);
    if (on)
#pragma unroll
      for (int c = 0; c < kCpt; ++c)
        if (c % kSlices == sl) {
          const float x = visible(sh, s + c) ? acc[c] * scale : -INFINITY;
          sc[j + c] = x;
          lmax = fmaxf(lmax, x);
        }
  }
  // the buffer's columns before this step's (their copy group landed; V
  // of the block's columns may still be in flight), and the step's own
  if (nx > 1) {
    asm volatile("cp.async.wait_group 1;" ::: "memory");
    __syncthreads();
  }
  for (int x = tid; x < nx; x += kThreads) {
    float acc = 0.f;
    if (x < col)
      for (int d = 0; d < kDh; ++d) acc = fmaf(qs[d], genie::to_f(kbs[d * W + x]), acc);
    else
      for (int d = 0; d < kDh; ++d) acc = fmaf(qs[d], genie::to_f(kn[row + d]), acc);
    sc[ncols + x] = acc * scale;
    lmax = fmaxf(lmax, acc * scale);
  }

  const float mb = genie::block_max(lmax, red);
  float lsum = 0.f;
  if (mb != -INFINITY)
    for (int j = tid; j < ncols + nx; j += kThreads) lsum += expf(sc[j] - mb);
  const float lb = genie::block_sum(lsum, red);
  if (tid == 0) {
    stat[0] = mb;
    stat[1] = lb;
  }
  cluster.sync();

  // the global max and sum in rank order (the same bits in every block);
  // the last block holds the step's own column, so l > 0
  float m = -INFINITY;
  for (int r = 0; r < kCluster; ++r) m = fmaxf(m, cluster.map_shared_rank(stat, r)[0]);
  float l = 0.f;
  for (int r = 0; r < kCluster; ++r) {
    const float* st = cluster.map_shared_rank(stat, r);
    if (st[0] != -INFINITY) l += expf(st[0] - m) * st[1];
  }
  for (int j = tid; j < ncols + nx; j += kThreads)
    sc[j] = genie::round_to<T>(expf(sc[j] - m) / l);
  asm volatile("cp.async.wait_all;" ::: "memory");
  __syncthreads();

  // P.V: lanes (d, k) sum groups k, k + kTpr, ... of row d
  {
    const int d = tid / kTpr, k = tid - d * kTpr;
    float o = 0.f;
    for (int g = k; g < ng; g += kTpr) {
      const int j = g * kCpt;
      float f[kCpt];
      genie::Pack16<T>::unpack(*reinterpret_cast<const uint4*>(vs + d * pitch + j), f);
#pragma unroll
      for (int c = 0; c < kCpt; ++c) o = fmaf(sc[j + c], f[c], o);
    }
    for (int x = k; x < nx; x += kTpr)
      o = fmaf(sc[ncols + x], genie::to_f(x < col ? vbs[d * W + x] : vn[row + d]), o);
#pragma unroll
    for (int off = 1; off < kTpr; off <<= 1) o += __shfl_xor_sync(0xffffffffu, o, off);
    if (k == 0) obuf[d] = o;
  }
  cluster.sync();
  if (rank == 0 && tid < kDh) {
    float o = 0.f;
    for (int r = 0; r < kCluster; ++r) o += cluster.map_shared_rank(obuf, r)[tid];
    out[(size_t)bh * kDh + tid] = genie::from_f<T>(o);
    // the step's own column into the write buffer (no block reads it)
    kbp[tid * W + col] = kn[row + tid];
    vbp[tid * W + col] = vn[row + tid];
  }
  cluster.sync();
}

template <typename T, int kDh, bool kVec>
int launch(cudaStream_t st, const void* q, const void* kn, const void* vn, long long qld,
           const void* kc, const void* vc, long long ld, void* kb, void* vb, int W, int col,
           const void* x_len, const void* p_len, const void* kw, const void* head, int sxsp,
           int ring, void* out, int B, int H, float scale) {
  constexpr int kTpr = kThreads / kDh;
  const int S = sxsp + ring;
  // a block holds at most a quarter of the row's chunks; its V rows are
  // padded so that the kTpr lanes of consecutive d rows fall on other banks
  const int per = ((S + 15) / 16 + kCluster - 1) / kCluster;
  const int row_bytes = (per * 16 * (int)sizeof(T) + 127) / 128 * 128 + (kTpr * 16) % 128;
  const int pitch = row_bytes / (int)sizeof(T);
  const int dyn = kDh * row_bytes + 2 * kDh * W * (int)sizeof(T) + (per * 16 + W + 1) * 4;
  // the buffer by 16-byte copies where its rows of W hold whole ones
  const int bvec = (W * (int)sizeof(T)) % 16 == 0 && reinterpret_cast<uintptr_t>(kb) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vb) % 16 == 0;
  auto kern = slot_attn_kernel<T, kDh, kVec>;
  if (dyn > 40 * 1024) {                          // above 48 KB in all only by opting in
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(kCluster, B * H), kThreads, dyn, st>>>(
      (const T*)q, (const T*)kn, (const T*)vn, qld, (const T*)kc, (const T*)vc, ld, (T*)kb,
      (T*)vb, W, col, bvec, (const int*)x_len, (const int*)p_len, (const int*)kw,
      (const int*)head, sxsp, ring, (T*)out, H, scale, pitch);
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (every tensor). q, k_new, v_new: rows
// of qld elements, heads of Dh; kc/vc: [B,H,Dh,ld] (S = sxsp + ring
// columns read); kb/vb: [B,H,Dh,W], column col written; head: one int32 in
// device memory. vec: kc/vc 16-byte aligned with a pitch of a multiple of
// 16 bytes (the wrapper checks), else element loads.
extern "C" int slot_attention(const void* q, const void* k_new, const void* v_new, long long qld,
                              const void* kc, const void* vc, long long ld, void* kb, void* vb,
                              int W, int col, const void* x_len, const void* p_len,
                              const void* keys_written, const void* head, int sxsp, int ring,
                              void* out, int B, int H, int Dh, float scale, int dtype, int vec,
                              void* stream) {
  const int S = sxsp + ring;
  if (S < 1 || S > kMaxS || ld < S || ring < 1 || sxsp < 0 || head == nullptr || W < 1 ||
      col < 0 || col >= W || B * H < 1 || B * H > 65535 || (Dh != 32 && Dh != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
#define GENIE_LAUNCH(T, DH)                                                                    \
  return vec ? launch<T, DH, true>(st, q, k_new, v_new, qld, kc, vc, ld, kb, vb, W, col, x_len, \
                                   p_len, keys_written, head, sxsp, ring, out, B, H, scale)    \
             : launch<T, DH, false>(st, q, k_new, v_new, qld, kc, vc, ld, kb, vb, W, col,      \
                                    x_len, p_len, keys_written, head, sxsp, ring, out, B, H,   \
                                    scale)
  if (dtype == 0 && Dh == 32) GENIE_LAUNCH(float, 32);
  if (dtype == 0 && Dh == 64) GENIE_LAUNCH(float, 64);
  if (dtype == 1 && Dh == 32) GENIE_LAUNCH(__nv_bfloat16, 32);
  if (dtype == 1 && Dh == 64) GENIE_LAUNCH(__nv_bfloat16, 64);
#undef GENIE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
