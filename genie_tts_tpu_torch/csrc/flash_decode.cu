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
// What bounds it on the H100: the K/V bytes. At B=4, H=16, S=448, Dh=32 in
// bf16 that is 3.7 MB, about 1.1 us at 3.35 TB/s, so a launch (several us)
// costs more than the reads. Design: one block per (b, h); the whole S
// slice of scores lives in shared memory (16 KB for S <= 4096), so K and V
// are each read from device memory exactly once and nothing but the output
// is written. Each thread scores whole K rows (64 contiguous bytes at
// Dh=32 bf16); for P.V each warp takes rows and its lanes take the Dh
// columns, so a warp reads one contiguous row per load.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kMaxS = 4096;
constexpr int kMaxDh = 128;

template <typename T>
__global__ void __launch_bounds__(kThreads)
decode_attn_kernel(const T* __restrict__ q, const T* __restrict__ k,
                   const T* __restrict__ v, const uint8_t* __restrict__ mask,
                   T* __restrict__ out, int H, int S, int Dh, float scale) {
  __shared__ float sc[kMaxS];
  __shared__ float qs[kMaxDh];
  __shared__ float part[kWarps][kMaxDh];
  __shared__ float red[32];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const T* qp = q + (size_t)bh * Dh;
  const T* kp = k + (size_t)bh * S * Dh;
  const T* vp = v + (size_t)bh * S * Dh;
  const uint8_t* mp = mask + (size_t)b * S;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;

  for (int d = threadIdx.x; d < Dh; d += blockDim.x) qs[d] = genie::to_f(qp[d]);
  __syncthreads();

  float lmax = -INFINITY;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const T* row = kp + (size_t)s * Dh;
    float acc = 0.f;
    for (int d = 0; d < Dh; ++d) acc += qs[d] * genie::to_f(row[d]);
    const float x = mp[s] ? acc * scale : -1e30f;
    sc[s] = x;
    lmax = fmaxf(lmax, x);
  }
  const float m = genie::block_max(lmax, red);
  float lsum = 0.f;
  for (int s = threadIdx.x; s < S; s += blockDim.x) {
    const float e = expf(sc[s] - m);
    sc[s] = e;
    lsum += e;
  }
  const float l = genie::block_sum(lsum, red);
  for (int s = threadIdx.x; s < S; s += blockDim.x)
    sc[s] = genie::round_to<T>(sc[s] / l);
  __syncthreads();

  float acc[kMaxDh / 32];
#pragma unroll
  for (int j = 0; j < kMaxDh / 32; ++j) acc[j] = 0.f;
  for (int s = warp; s < S; s += kWarps) {
    const float p = sc[s];
    const T* row = vp + (size_t)s * Dh;
#pragma unroll
    for (int j = 0; j < kMaxDh / 32; ++j) {
      const int d = j * 32 + lane;
      if (d < Dh) acc[j] += p * genie::to_f(row[d]);
    }
  }
#pragma unroll
  for (int j = 0; j < kMaxDh / 32; ++j) {
    const int d = j * 32 + lane;
    if (d < Dh) part[warp][d] = acc[j];
  }
  __syncthreads();
  for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
    float o = 0.f;
    for (int w = 0; w < kWarps; ++w) o += part[w][d];
    out[(size_t)bh * Dh + d] = genie::from_f<T>(o);
  }
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16. mask: [B, S] bytes (torch.bool).
extern "C" int flash_decode_attention(const void* q, const void* k, const void* v,
                                      const void* mask, void* out, int B, int H,
                                      int S, int Dh, float scale, int dtype,
                                      void* stream) {
  if (S < 1 || S > kMaxS || Dh < 1 || Dh > kMaxDh || B * H < 1)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(B * H), block(kThreads);
  if (dtype == 0) {
    decode_attn_kernel<float><<<grid, block, 0, st>>>(
        (const float*)q, (const float*)k, (const float*)v, (const uint8_t*)mask,
        (float*)out, H, S, Dh, scale);
  } else if (dtype == 1) {
    decode_attn_kernel<__nv_bfloat16><<<grid, block, 0, st>>>(
        (const __nv_bfloat16*)q, (const __nv_bfloat16*)k, (const __nv_bfloat16*)v,
        (const uint8_t*)mask, (__nv_bfloat16*)out, H, S, Dh, scale);
  } else {
    return (int)cudaErrorInvalidValue;
  }
  return (int)cudaGetLastError();
}
