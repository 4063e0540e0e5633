// Shared device helpers for the hand-written decode kernels.
#pragma once

#include <cuda_bf16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace genie {

// Element conversions. Cache and activation types are float or bf16;
// weights may also be int8 (weight-only quantization, see fused_decode.cu).
__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) { return v; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(float v) {
  return __float2bfloat16_rn(v);
}

// Round an fp32 value to T's precision and back (the reference's
// ``x.astype(T)`` before a product that accumulates in fp32).
template <typename T> __device__ __forceinline__ float round_to(float v) {
  return to_f(from_f<T>(v));
}

// Load through L2 only (ld.global.cg): for data that other blocks of the
// same launch wrote; L1 is not coherent across SMs.
__device__ __forceinline__ float ldcg_f(const float* p) { return __ldcg(p); }
__device__ __forceinline__ float ldcg_f(const __nv_bfloat16* p) {
  unsigned short bits = __ldcg(reinterpret_cast<const unsigned short*>(p));
  return __uint_as_float(static_cast<unsigned>(bits) << 16);
}

// 16 bytes of T unpacked to fp32: 8 bf16, 4 float or 16 int8 values.
template <typename T> struct Pack16;
template <> struct Pack16<__nv_bfloat16> {
  static constexpr int N = 8;
  __device__ __forceinline__ static void unpack(const uint4& u, float* o) {
    const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&u);
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float2 f = __bfloat1622float2(h[i]);
      o[2 * i] = f.x;
      o[2 * i + 1] = f.y;
    }
  }
};
template <> struct Pack16<float> {
  static constexpr int N = 4;
  __device__ __forceinline__ static void unpack(const uint4& u, float* o) {
    o[0] = __uint_as_float(u.x);
    o[1] = __uint_as_float(u.y);
    o[2] = __uint_as_float(u.z);
    o[3] = __uint_as_float(u.w);
  }
};
// int8 codes go through the bias trick, exact for every code and at full
// rate (the byte permute places a code, offset to unsigned, in the low bits
// of 2^23; one subtraction removes both): the I2F conversion runs at a
// quarter of the rate.
__device__ __forceinline__ float i8_to_f(unsigned byte) {
  return __uint_as_float(0x4B000000u | (byte ^ 0x80u)) - 8388736.f;
}
template <> struct Pack16<int8_t> {
  static constexpr int N = 16;
  __device__ __forceinline__ static void unpack(const uint4& u, float* o) {
    const unsigned w[4] = {u.x ^ 0x80808080u, u.y ^ 0x80808080u, u.z ^ 0x80808080u,
                           u.w ^ 0x80808080u};
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int k = 0; k < 4; ++k)
        o[4 * i + k] =
            __uint_as_float(__byte_perm(w[i], 0x4B000000u, 0x7650 + k)) - 8388736.f;
  }
};

// Bulk copies (TMA, one instruction per contiguous range of a multiple of
// 16 bytes, both ends 16-byte aligned) into shared memory, completing on an
// mbarrier: the starting thread does not wait. Every wait has a bounded
// spin that traps, so a copy that never lands ends the launch with an error.
constexpr long long kSpinLimit = 1ll << 22;   // polls (~seconds) before a wait traps

__device__ __forceinline__ unsigned smem_addr(const void* p) {
  return static_cast<unsigned>(__cvta_generic_to_shared(p));
}
// one thread: an mbarrier that completes when one thread arrives and the
// expected bytes have landed; visible to the block after a __syncthreads
__device__ __forceinline__ void mbar_init(unsigned long long* mbar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;" ::"r"(smem_addr(mbar)) : "memory");
  asm volatile("fence.mbarrier_init.release.cluster;" ::: "memory");
}
__device__ __forceinline__ void bulk_copy(void* dst, const void* src, unsigned bytes,
                                          unsigned long long* mbar) {
  asm volatile(
      "cp.async.bulk.shared::cluster.global.mbarrier::complete_tx::bytes [%0], [%1], %2, [%3];"
      ::"r"(smem_addr(dst)), "l"(src), "r"(bytes), "r"(smem_addr(mbar)) : "memory");
}
__device__ __forceinline__ void mbar_expect(unsigned long long* mbar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;" ::"r"(smem_addr(mbar)),
               "r"(bytes) : "memory");
}
__device__ __forceinline__ void mbar_wait(unsigned long long* mbar, unsigned parity) {
  long long spins = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(smem_addr(mbar)), "r"(parity) : "memory");
    if (done) return;
    if (++spins > kSpinLimit) __trap();
  }
}

__device__ __forceinline__ float warp_sum(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v += __shfl_xor_sync(0xffffffffu, v, o);
  return v;
}

__device__ __forceinline__ float warp_max(float v) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) v = fmaxf(v, __shfl_xor_sync(0xffffffffu, v, o));
  return v;
}

// Block-wide reductions over blockDim.x threads (a multiple of 32, at most
// 1024). ``red`` is __shared__ scratch of 32 floats. Every thread gets the
// result. The order of the sums is fixed, so every block that reduces the
// same values gets the same bits.
__device__ __forceinline__ float block_sum(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_sum(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = 0.f;
  for (int w = 0; w < nw; ++w) t += red[w];
  return t;
}

__device__ __forceinline__ float block_max(float v, float* red) {
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  const int nw = blockDim.x >> 5;
  v = warp_max(v);
  __syncthreads();
  if (lane == 0) red[warp] = v;
  __syncthreads();
  float t = red[0];
  for (int w = 1; w < nw; ++w) t = fmaxf(t, red[w]);
  return t;
}

}  // namespace genie
