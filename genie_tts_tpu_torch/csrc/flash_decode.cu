// Single-token KV-cache decode attention for Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel genie_tts_tpu/ops/flash_decode.py::
// flash_decode_attention (kernel _decode_attn_kernel). It computes what the
// reference's xla_decode_attention computes:
//
//   scores[s] = (q . K[s]) / sqrt(Dh)      fp32, -1e30 where mask[s] is false
//   p         = softmax(scores)            fp32, then rounded to V's dtype
//   out       = sum_s p[s] V[s]            fp32 sum, stored in q's dtype
//
// so a row whose mask is all false gets the mean of V (the Pallas kernel
// would divide 0 by 0 there).
//
// What bounds it on the H100: not the bytes. At B=4, H=16, S=448, Dh=32 in
// bf16 the visible K/V rows are ~2 MB, well under a microsecond at 3.35
// TB/s; a launch with one block per (b, h) leaves half the 132 SMs idle and
// streams each 57 KB slice through one SM, so latency (dependent loads,
// block-wide reductions) bounds it.
//
// Design: a thread-block cluster of 4 blocks per (b, h), grid (4, B*H), so
// B=4 gives 256 blocks. Each block takes one 16-row-aligned quarter of S:
//
// - q lives in registers. A K or V row is read with 16-byte loads, Dh*es/16
//   lanes per row (4 at Dh=32 bf16, 8 in fp32), so one warp-wide load
//   covers 8 rows; a score is a shuffle sum over the row's lanes.
// - Each warp takes 16-row groups and reads their mask bytes first. A group
//   with no visible key is neither scored nor read, unless the whole mask
//   row is false: then every row counts, with score -1e30, and the result
//   is the mean of V as in the reference.
// - The blocks exchange their (max, sum of exp) through distributed shared
//   memory (one cluster.sync). With the global max m and sum l, every block
//   forms p = round_to<T>(exp(s - m) / l) exactly as the plain version
//   rounds p to V's dtype, and sums p * V over its rows.
// - The leader block sums the four partial outputs (a second cluster.sync)
//   in rank order and stores the row; a third cluster.sync keeps the other
//   blocks' shared memory alive until it has read them.
//
// One launch, no global scratch, three cluster syncs.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 4;
constexpr int kThreads = 128;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 4096;
constexpr int kRowsMax = kMaxS / kCluster;   // rows of one block

template <typename T, int DH>
__global__ void __cluster_dims__(kCluster, 1, 1) __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ mask,
                   T* __restrict__ out, int H, int S, float scale) {
  constexpr int P = genie::Pack16<T>::N;     // elements per 16 bytes
  constexpr int LPR = DH / P;                // lanes per row
  constexpr int RPL = 32 / LPR;              // rows per warp-wide load
  constexpr int NLD = 16 / RPL;              // loads per lane per 16-row group
  __shared__ float sc[kRowsMax];
  __shared__ uint8_t gskip[kRowsMax / 16];
  __shared__ float part[kWarps][DH];
  __shared__ float obuf[DH];
  __shared__ float stat[2];
  __shared__ float red[32];

  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int bh = blockIdx.y, b = bh / H;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int c = lane % LPR, slot = lane / LPR;
  const T* kp = k + (size_t)bh * S * DH;
  const T* vp = v + (size_t)bh * S * DH;
  const uint8_t* mp = mask + (size_t)b * S;
  const int per = (S + 16 * kCluster - 1) / (16 * kCluster) * 16;
  const int r0 = rank * per, r1 = min(S, r0 + per);
  const int ngroups = r1 > r0 ? (r1 - r0 + 15) / 16 : 0;

  int anyv = 0;
  for (int s = threadIdx.x; s < S; s += kThreads) anyv |= mp[s];
  anyv = __syncthreads_or(anyv);

  float qr[P];
#pragma unroll
  for (int i = 0; i < P; ++i) qr[i] = genie::to_f(q[(size_t)bh * DH + c * P + i]);

  // scores of this block's rows
  float lmax = -INFINITY;
  for (int g = warp; g < ngroups; g += kWarps) {
    const int g0 = r0 + g * 16;
    const int vis = lane < 16 && g0 + lane < r1 ? mp[g0 + lane] : 0;
    const bool skip = anyv && !__any_sync(0xffffffffu, vis);
    if (lane == 0) gskip[g] = skip;
    if (skip) {
      if (lane < 16 && g0 + lane < r1) sc[g0 - r0 + lane] = -INFINITY;
      continue;
    }
    uint4 u[NLD];
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int s = g0 + j * RPL + slot;
      u[j] = s < r1 ? __ldg(reinterpret_cast<const uint4*>(kp + (size_t)s * DH) + c)
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      float f[P];
      genie::Pack16<T>::unpack(u[j], f);
      float acc = 0.f;
#pragma unroll
      for (int i = 0; i < P; ++i) acc = fmaf(qr[i], f[i], acc);
#pragma unroll
      for (int o = LPR / 2; o > 0; o >>= 1) acc += __shfl_xor_sync(0xffffffffu, acc, o);
      const int s = g0 + j * RPL + slot;
      if (c == 0 && s < r1) {
        const float x = mp[s] ? acc * scale : -1e30f;
        sc[s - r0] = x;
        lmax = fmaxf(lmax, x);
      }
    }
  }
  const float mb = genie::block_max(lmax, red);
  float lsum = 0.f;
  if (mb != -INFINITY)
    for (int s = r0 + threadIdx.x; s < r1; s += kThreads) lsum += expf(sc[s - r0] - mb);
  const float lb = genie::block_sum(lsum, red);
  if (threadIdx.x == 0) {
    stat[0] = mb;
    stat[1] = lb;
  }
  cluster.sync();

  // the global max and sum, in rank order (the same bits in every block)
  float m = -INFINITY;
  for (int r = 0; r < kCluster; ++r) m = fmaxf(m, cluster.map_shared_rank(stat, r)[0]);
  float l = 0.f;
  for (int r = 0; r < kCluster; ++r) {
    const float* st = cluster.map_shared_rank(stat, r);
    if (st[0] != -INFINITY) l += expf(st[0] - m) * st[1];
  }
  for (int s = r0 + threadIdx.x; s < r1; s += kThreads)
    sc[s - r0] = genie::round_to<T>(expf(sc[s - r0] - m) / l);
  __syncthreads();

  float acc[P];
#pragma unroll
  for (int i = 0; i < P; ++i) acc[i] = 0.f;
  for (int g = warp; g < ngroups; g += kWarps) {
    if (gskip[g]) continue;
    const int g0 = r0 + g * 16;
    uint4 u[NLD];
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int s = g0 + j * RPL + slot;
      u[j] = s < r1 ? __ldg(reinterpret_cast<const uint4*>(vp + (size_t)s * DH) + c)
                    : make_uint4(0, 0, 0, 0);
    }
#pragma unroll
    for (int j = 0; j < NLD; ++j) {
      const int s = g0 + j * RPL + slot;
      const float p = s < r1 ? sc[s - r0] : 0.f;
      float f[P];
      genie::Pack16<T>::unpack(u[j], f);
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
    for (int i = 0; i < P; ++i) part[warp][c * P + i] = acc[i];
  __syncthreads();
  for (int d = threadIdx.x; d < DH; d += kThreads) {
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += part[w][d];
    obuf[d] = o;
  }
  cluster.sync();
  if (rank == 0)
    for (int d = threadIdx.x; d < DH; d += kThreads) {
      float o = 0.f;
      for (int r = 0; r < kCluster; ++r) o += cluster.map_shared_rank(obuf, r)[d];
      out[(size_t)bh * DH + d] = genie::from_f<T>(o);
    }
  cluster.sync();
}

template <typename T, int DH>
void launch(const void* q, const void* k, const void* v, const void* mask, void* out,
            int B, int H, int S, float scale, cudaStream_t st) {
  decode_attn_kernel<T, DH><<<dim3(kCluster, B * H), kThreads, 0, st>>>(
      (const T*)q, (const T*)k, (const T*)v, (const uint8_t*)mask, (T*)out, H, S, scale);
}

template <typename T>
int launch_dh(const void* q, const void* k, const void* v, const void* mask, void* out,
              int B, int H, int S, int Dh, float scale, cudaStream_t st) {
  switch (Dh) {
    case 32: launch<T, 32>(q, k, v, mask, out, B, H, S, scale, st); break;
    case 64: launch<T, 64>(q, k, v, mask, out, B, H, S, scale, st); break;
    case 128: launch<T, 128>(q, k, v, mask, out, B, H, S, scale, st); break;
    default: return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask: [B, S] bytes (torch.bool).
// Dh: 32, 64 or 128; q, k and v 16-byte aligned.
extern "C" int flash_decode_attention(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int B, int H,
                                      int S, int Dh, float scale, int dtype,
                                      void* stream) {
  if (S < 1 || S > kMaxS || B * H < 1 || B * H > 65535) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_dh<float>(q, k, v, mask, out, B, H, S, Dh, scale, st);
  if (dtype == 1)
    return launch_dh<__nv_bfloat16>(q, k, v, mask, out, B, H, S, Dh, scale, st);
  return (int)cudaErrorInvalidValue;
}
