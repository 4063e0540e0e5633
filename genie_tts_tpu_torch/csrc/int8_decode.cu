// Flash partials of decode attention over the int8 slot KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel genie_tts_tpu/ops/int8_decode.py::
// int8_big_attention (kernel _kernel). For each (slot b, head h):
//
//   visible(s) = s < x_len+p_len                      (compacted context)
//              | (rpos >= 0 & floor_mod(head-1-rpos, ring) < keys_written)
//                with rpos = s - (sx+sp)               (the decode ring)
//                head: one int32 in device memory, as the slot state
//                keeps it, so a captured segment graph replays at the
//                head the last merge advanced on the device
//   score[s]   = (q . Kq[:, s]) * ks[s] / sqrt(Dh)     -1e30 where not visible
//   m = max_s score,  p[s] = visible ? exp(score[s] - m) : 0,  l = sum_s p
//   o[d]       = sum_s p[s] * vs[s] * Vq[d, s]         (unnormalized)
//
// Kq/Vq are int8 codes [B,H,Dh,S] kv-major (one row of S columns per d),
// ks/vs fp32 per-column scales [B,H,S]; rows may be strided (the slot
// state's caches are wider than the S columns read). A row with nothing
// visible gives m = -1e30, l = 0, o = 0. The caller merges the partials
// with its exact write-buffer columns (models/t2s.py::
// _layer_decode_buffered).
//
// What bounds it on the H100: the bytes of the visible columns, codes and
// scales, 2 * (Dh + 4) bytes a column (~32 KB per (b, h) at S = 896,
// Dh = 32 and half the columns visible), over 3.35 TB/s: ~1.2 us at the
// 8-slot serving geometry. The arithmetic (2 * Dh FMAs a column) is far
// below the fp32 rate. So what costs time is latency: dependent trips to
// memory, too few bytes in flight per SM, barriers.
//
// Design:
//
// - Visibility as intervals, once per block. A row sees [0, min(ctx, S))
//   and the last kw' = clamp(keys_written, 0, ring) ring writes before the
//   head: ring positions [h - kw', h) with h = floor_mod(head, ring), one
//   range or, where it wraps, two. So at most three disjoint column
//   intervals from one modulo per block (share_of); masks and chunk
//   skipping compare against interval ends. ops/int8_decode.py::
//   visible_intervals and chunk_share are its CPU twin, tested against the
//   mask for every head and count of small rings.
// - A cluster of 4 blocks per (b, h) (512 blocks at the serving geometry)
//   splits the row's visible 16-column chunks evenly (not S): a block
//   holds at most three runs of chunks, at most a quarter of S.
// - One load round. At block start a block asks for all of its bytes at
//   once: one TMA tensor-map copy per 16-column chunk (all Dh rows of it,
//   so the count of copies does not grow with the runs a wrapped ring
//   makes) and one bulk copy per run of scales; K codes and ks complete on
//   one mbarrier, V codes and vs on a second, so scores start while V
//   lands. Rows whose pitch is not a multiple of 16 bytes take byte loads
//   into the same buffers. Columns past S read as 0; the columns that
//   rounding to 16 adds are masked by the interval ends.
// - Warps own 32-column groups: a lane scores one column from shared memory
//   with q in registers and the column's scale folded in, and the warp
//   keeps its own online (m, l, o); o is summed a lane per d row with
//   16-byte reads of the V codes. Codes become floats by the bias trick.
// - Each warp stores its (m, l, o) into the leader block's shared memory,
//   and the leader combines the 16 partials in a fixed order. The cluster
//   barrier is split into arrive and wait: the first phase only proves that
//   every block runs (before any stores into the leader), the second
//   publishes the partials. No block-wide barrier after the copies start.
//
// Measured (chip_smoke.py; PERF.md, NVIDIA H100 80GB HBM3 at 700 W): the
// time is a floor of launch, scalar loads and cluster barriers that rows
// with nothing visible also pay, plus one memory round trip and the
// arithmetic, which do not overlap much.
#include <cooperative_groups.h>
#include <cuda.h>
#include <cudaTypedefs.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;                       // blocks per (b, h)
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kParts = kCluster * kWarps;         // (m, l, o) partials per (b, h)
constexpr int kMaxS = 2048;
constexpr int kMaxDh = 64;
constexpr int kStamps = 9;                        // trace points (ops/int8_decode.py::PHASE_STAMPS)

__device__ __forceinline__ void cluster_arrive() {
  asm volatile("barrier.cluster.arrive.aligned;" ::: "memory");
}
__device__ __forceinline__ void cluster_wait() {
  asm volatile("barrier.cluster.wait.aligned;" ::: "memory");
}

// A row's visible columns and one block's share of them. Visible: [0, c),
// [a1, e1), [a2, e2), disjoint and sorted (empty where a >= e); columns
// from S on, which the last chunk may hold, are never visible. The block's
// chunks form up to three runs, laid out one after the other in its
// buffers: run i starts at global chunk first[i] and holds n[i] chunks;
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
  // the ring writes, ring positions [h - k, h) modulo ring, as columns
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
  // ring columns below c are the context's
  sh.c = c;
  sh.a1 = max(a1, c);
  sh.e1 = e1;
  sh.a2 = max(a2, c);
  sh.e2 = e2;
  // the intervals' 16-column chunks in order; a chunk two intervals share
  // counts once
  const int a[3] = {0, sh.a1, sh.a2}, e[3] = {c, e1, e2};
  int cs[3], cn[3], prev = 0, total = 0;
#pragma unroll
  for (int i = 0; i < 3; ++i) {
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
  // this block's chunks: [r0, r1) of the row's `total`
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

// one box of a 3D tensor map (TMA) into shared memory, completing on mbar
__device__ __forceinline__ void tensor_copy(void* dst, const CUtensorMap* map, int c0, int c1,
                                            int c2, unsigned long long* mbar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.mbarrier::complete_tx::bytes "
      "[%0], [%1, {%2, %3, %4}], [%5];"
      ::"r"(genie::smem_addr(dst)), "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1),
        "r"(c2), "r"(genie::smem_addr(mbar)) : "memory");
}

// Shared memory (dynamic, from a 128-byte boundary): the K and V codes as
// [chunk][d][16 columns] (one chunk is one TMA box of kDh x 16 bytes), cap
// columns each (cap a multiple of 32); then the scales of the block's
// columns kss, vss and p * vs, cap floats each.
template <typename TQ, int kDh, bool kTma>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
int8_attn_kernel(const __grid_constant__ CUtensorMap kmap,
                 const __grid_constant__ CUtensorMap vmap, const TQ* __restrict__ q,
                 const int8_t* __restrict__ kq, const float* __restrict__ ks,
                 const int8_t* __restrict__ vq, const float* __restrict__ vs,
                 const int* __restrict__ x_len, const int* __restrict__ p_len,
                 const int* __restrict__ keys_written, float* __restrict__ o,
                 float* __restrict__ m_out, float* __restrict__ l_out, int H, int S,
                 long long ld, long long lds, const int* __restrict__ head, int sxsp,
                 int ring, float scale, int cap, long long* __restrict__ trace) {
  constexpr int kRows = kDh / 32;                 // V rows a lane sums
  constexpr int kChunk = kDh * 16;                // bytes of one chunk of codes
  extern __shared__ __align__(16) uint8_t smem_raw[];
  __shared__ float part[kParts][kMaxDh + 2];      // the leader's: each warp's m, l, o
  __shared__ unsigned long long mbar[2];          // K codes + ks; V codes + vs
  uint8_t* kc = smem_raw + ((128 - (genie::smem_addr(smem_raw) & 127)) & 127);
  uint8_t* vc = kc + cap * kDh;
  float* kss = reinterpret_cast<float*>(vc + cap * kDh);
  float* vss = kss + cap;
  float* pv = vss + cap;

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y, b = bh / H;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  // the optional trace: clock64 stamps of thread 0 (warp 0, which issues
  // the K copies) at kStamps points, in program order
  auto stamp = [&](int i, int after = 0) {
    if (trace != nullptr && tid == 0 && after != -1)  // read `after` first
      trace[((size_t)bh * kCluster + rank) * kStamps + i] = clock64();
  };
  stamp(0);
  cluster_arrive();                               // phase 1: this block runs
  const int ctx = x_len[b] + p_len[b], kw = keys_written[b];
  float qr[kDh];
#pragma unroll
  for (int d = 0; d < kDh; ++d) qr[d] = genie::to_f(q[(size_t)bh * kDh + d]) * scale;
  const Share sh = share_of(ctx, kw, *head, sxsp, ring, S, rank);
  const int nch = sh.ncols >> 4;
  stamp(1, nch);
  if (kTma && tid == 0) {
    genie::mbar_init(&mbar[0]);
    genie::mbar_init(&mbar[1]);
  }
  const int S4 = (S + 3) & ~3;                    // scale rows hold whole 16-byte units
  const int8_t* kp = kq + (size_t)bh * kDh * ld;
  const int8_t* vp = vq + (size_t)bh * kDh * ld;
  const float* ksp = ks + (size_t)bh * lds;
  const float* vsp = vs + (size_t)bh * lds;

  if constexpr (kTma) {
    __syncthreads();                              // the mbarriers are initialised
    // warp 0: K codes and ks, warp 1: V codes and vs; a lane a chunk (a box
    // of kDh rows x 16 columns), one copy a run of scales
    if (warp < 2 && nch > 0) {
      const CUtensorMap* map = warp == 0 ? &kmap : &vmap;
      uint8_t* dst = warp == 0 ? kc : vc;
      const float* ssrc = warp == 0 ? ksp : vsp;
      float* sdst = warp == 0 ? kss : vss;
      unsigned long long* bar = &mbar[warp];
      if (lane == 0) {
        unsigned bytes = nch * kChunk;
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (sh.n[i] > 0) bytes += 4 * min(16 * sh.n[i], S4 - 16 * sh.first[i]);
        genie::mbar_expect(bar, bytes);
#pragma unroll
        for (int i = 0; i < 3; ++i)
          if (sh.n[i] > 0) {
            const int col = 16 * sh.first[i];
            genie::bulk_copy(sdst + col - sh.off[i], ssrc + col,
                             4 * min(16 * sh.n[i], S4 - col), bar);
          }
      }
      // a copy may land before lane 0's expect (the count goes below 0);
      // the phase completes only after the expect's arrival
      for (int c = lane; c < nch; c += 32)
        tensor_copy(dst + c * kChunk, map, global_col(sh, 16 * c), 0, bh, bar);
    }
    stamp(2);
  } else {
    // byte loads (any pitch); nothing past column S is read
    for (int d = 0; d < kDh; ++d)
      for (int j = tid; j < sh.ncols; j += kThreads) {
        const int s = global_col(sh, j), at = (j >> 4) * kChunk + d * 16 + (j & 15);
        kc[at] = s < S ? kp[d * ld + s] : 0;
        vc[at] = s < S ? vp[d * ld + s] : 0;
      }
    for (int j = tid; j < sh.ncols; j += kThreads) {
      const int s = global_col(sh, j);
      kss[j] = s < S ? ksp[s] : 0.f;
      vss[j] = s < S ? vsp[s] : 0.f;
    }
    __syncthreads();
  }

  // this warp's 32-column groups: online (m, l, o)
  float m = -1e30f, l = 0.f, acc[kRows];
#pragma unroll
  for (int r = 0; r < kRows; ++r) acc[r] = 0.f;
  for (int g0 = warp * 32; g0 < sh.ncols; g0 += kThreads) {
    if constexpr (kTma) genie::mbar_wait(&mbar[0], 0);
    if (g0 == 0) stamp(3);
    const int j = g0 + lane;
    const bool vis = j < sh.ncols && visible(sh, global_col(sh, j));
    const uint8_t* kj = kc + (j >> 4) * kChunk + (j & 15);
    float t[4] = {0.f, 0.f, 0.f, 0.f};
#pragma unroll
    for (int d = 0; d < kDh; ++d) t[d & 3] = fmaf(qr[d], genie::i8_to_f(kj[d * 16]), t[d & 3]);
    // a select, so a scale past the loaded columns never reaches the sums
    const float x = vis ? ((t[0] + t[1]) + (t[2] + t[3])) * kss[j] : -1e30f;
    const float mn = fmaxf(m, genie::warp_max(x));
    const float p = vis ? expf(x - mn) : 0.f;
    const float corr = expf(m - mn);
    l = l * corr + genie::warp_sum(p);
    m = mn;
    if constexpr (kTma) genie::mbar_wait(&mbar[1], 0);
    if (g0 == 0) stamp(4);
    pv[j] = vis ? p * vss[j] : 0.f;
    __syncwarp();
    const float4* pw = reinterpret_cast<const float4*>(pv + g0);
#pragma unroll
    for (int r = 0; r < kRows; ++r) {
      const uint8_t* vrow = vc + (g0 >> 4) * kChunk + (lane + 32 * r) * 16;
      float sum[2] = {0.f, 0.f};
#pragma unroll
      for (int hf = 0; hf < 2; ++hf) {
        float f[16];
        genie::Pack16<int8_t>::unpack(*reinterpret_cast<const uint4*>(vrow + hf * kChunk), f);
#pragma unroll
        for (int c4 = 0; c4 < 4; ++c4) {
          const float4 w = pw[4 * hf + c4];
          sum[hf] = fmaf(w.x, f[4 * c4], sum[hf]);
          sum[hf] = fmaf(w.y, f[4 * c4 + 1], sum[hf]);
          sum[hf] = fmaf(w.z, f[4 * c4 + 2], sum[hf]);
          sum[hf] = fmaf(w.w, f[4 * c4 + 3], sum[hf]);
        }
      }
      acc[r] = acc[r] * corr + (sum[0] + sum[1]);
    }
  }

  stamp(5);
  // every block runs: store this warp's partial into the leader's part[]
  cluster_wait();
  stamp(6);
  float* dst = cluster.map_shared_rank(&part[0][0], 0) + (rank * kWarps + warp) * (kMaxDh + 2);
#pragma unroll
  for (int r = 0; r < kRows; ++r) dst[2 + lane + 32 * r] = acc[r];
  if (lane == 0) {
    dst[0] = m;
    dst[1] = l;
  }
  cluster_arrive();                               // phase 2: the partials are stored
  cluster_wait();
  stamp(7);
  if (rank != 0) return;
  // m = max_i m_i, l = sum_i l_i exp(m_i - m), o = sum_i o_i exp(m_i - m):
  // a row that sees nothing keeps m = -1e30, l = 0, o = 0 (exp(0) * 0)
  float mx = -1e30f;
#pragma unroll
  for (int i = 0; i < kParts; ++i) mx = fmaxf(mx, part[i][0]);
  if (tid < kDh) {
    float od = 0.f;
#pragma unroll
    for (int i = 0; i < kParts; ++i) od = fmaf(part[i][2 + tid], expf(part[i][0] - mx), od);
    o[(size_t)bh * kDh + tid] = od;
  } else if (tid == kThreads - 1) {
    float ls = 0.f;
#pragma unroll
    for (int i = 0; i < kParts; ++i) ls = fmaf(part[i][1], expf(part[i][0] - mx), ls);
    m_out[bh] = mx;
    l_out[bh] = ls;
  }
  stamp(8);
}

// cuTensorMapEncodeTiled (a libcuda function), looked up through the CUDA
// runtime, so the library needs no link against libcuda
PFN_cuTensorMapEncodeTiled_v12000 encode_fn() {
  static PFN_cuTensorMapEncodeTiled_v12000 fn = nullptr;
  if (fn == nullptr) {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t e = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                           cudaEnableDefault, &found);
#else
    const cudaError_t e =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    if (e == cudaSuccess && found == cudaDriverEntryPointSuccess)
      fn = reinterpret_cast<PFN_cuTensorMapEncodeTiled_v12000>(p);
  }
  return fn;
}

// the codes [B*H, Dh, S] (row pitch ld bytes) as boxes of Dh rows x 16
// columns; columns past S read as 0
bool codes_map(CUtensorMap* map, const void* base, int BH, int Dh, int S, long long ld) {
  const PFN_cuTensorMapEncodeTiled_v12000 encode = encode_fn();
  if (encode == nullptr) return false;
  const cuuint64_t dims[3] = {(cuuint64_t)S, (cuuint64_t)Dh, (cuuint64_t)BH};
  const cuuint64_t strides[2] = {(cuuint64_t)ld, (cuuint64_t)ld * Dh};
  const cuuint32_t box[3] = {16, (cuuint32_t)Dh, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 3, const_cast<void*>(base), dims, strides,
                box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_NONE,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename TQ, int kDh, bool kTma>
int launch(cudaStream_t st, const CUtensorMap& kmap, const CUtensorMap& vmap, const void* q,
           const void* kq, const void* ks, const void* vq, const void* vs, const void* x_len,
           const void* p_len, const void* kw, void* o, void* m, void* l, int BH, int H, int S,
           long long ld, long long lds, const void* head, int sxsp, int ring, float scale,
           long long* trace) {
  // a block holds at most a quarter of the row's chunks, rounded up to a
  // 32-column group
  const int per = ((S + 15) / 16 + kCluster - 1) / kCluster;
  const int cap = (per * 16 + 31) / 32 * 32;
  const int dyn = 128 + 2 * cap * kDh + 3 * cap * 4;
  constexpr int kStatic = kParts * (kMaxDh + 2) * 4 + 16;
  auto kern = int8_attn_kernel<TQ, kDh, kTma>;
  if (dyn + kStatic > 48 * 1024) {                // above 48 KB only by opting in
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeMaxDynamicSharedMemorySize, dyn);
    if (e != cudaSuccess) return (int)e;
  }
  kern<<<dim3(kCluster, BH), kThreads, dyn, st>>>(
      kmap, vmap, (const TQ*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
      (const float*)vs, (const int*)x_len, (const int*)p_len, (const int*)kw, (float*)o,
      (float*)m, (float*)l, H, S, ld, lds, (const int*)head, sxsp, ring, scale, cap, trace);
  return (int)cudaGetLastError();
}

}  // namespace

// qdtype: 0 = float32, 1 = bfloat16. kq/vq rows have a pitch of ld bytes,
// ks/vs rows a pitch of lds floats; S == sxsp + ring; head: one int32 in
// device memory (the ring head, floor modulo ring). vec: kq/vq are
// 16-byte aligned with a pitch that is a multiple of 16 (the wrapper
// checks); with 16-byte aligned scale rows too, the copies are TMA
// (tensor-map copies of the codes, bulk copies of the scales), else byte
// loads. trace: null, or [B*H, 4, 9] int64 clock64 stamps (phase_cycles).
extern "C" int int8_big_attention(const void* q, const void* kq, const void* ks,
                                  const void* vq, const void* vs, const void* x_len,
                                  const void* p_len, const void* keys_written,
                                  void* o, void* m, void* l, int B, int H, int Dh,
                                  int S, long long ld, long long lds, const void* head,
                                  int sxsp, int ring, float scale, int qdtype,
                                  int vec, void* stream, void* trace) {
  if (S < 1 || S > kMaxS || ld < S || lds < S || ring < 1 || sxsp < 0 || head == nullptr ||
      S != sxsp + ring || B * H < 1 || B * H > 65535 || (Dh != 32 && Dh != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const bool tma = vec != 0 && lds % 4 == 0 && reinterpret_cast<uintptr_t>(ks) % 16 == 0 &&
                   reinterpret_cast<uintptr_t>(vs) % 16 == 0;
  CUtensorMap kmap{}, vmap{};
  if (tma && !(codes_map(&kmap, kq, B * H, Dh, S, ld) &&
               codes_map(&vmap, vq, B * H, Dh, S, ld)))
    return (int)cudaErrorInvalidValue;
#define GENIE_LAUNCH(TQ, DH)                                                                   \
  return tma ? launch<TQ, DH, true>(st, kmap, vmap, q, kq, ks, vq, vs, x_len, p_len,           \
                                    keys_written, o, m, l, B * H, H, S, ld, lds, head, sxsp,   \
                                    ring, scale, (long long*)trace)                            \
             : launch<TQ, DH, false>(st, kmap, vmap, q, kq, ks, vq, vs, x_len, p_len,          \
                                     keys_written, o, m, l, B * H, H, S, ld, lds, head, sxsp,  \
                                     ring, scale, (long long*)trace)
  if (qdtype == 0 && Dh == 32) GENIE_LAUNCH(float, 32);
  if (qdtype == 0 && Dh == 64) GENIE_LAUNCH(float, 64);
  if (qdtype == 1 && Dh == 32) GENIE_LAUNCH(__nv_bfloat16, 32);
  if (qdtype == 1 && Dh == 64) GENIE_LAUNCH(__nv_bfloat16, 64);
#undef GENIE_LAUNCH
  return (int)cudaErrorInvalidValue;
}
