// The V4 DiT block's elementwise glue between its GEMMs and its attention,
// for Hopper (sm_90a): two kernels.
//
// Replaces no Pallas kernel: the JAX package has no V4. The port ran this
// glue as PyTorch's composition (models/sovits_v4.py): per block, two
// adaLN-modulated LayerNorms (a `1 + scale` op and a LayerNorm each), two
// gated residuals (`addcmul`) and the rotary of q and of k, each ~7 ops over
// a strided [R, T, 64] slice (a cast, a negation, a stack, two products, a
// sum, a strided copy back): ~20 launches a block beside its 7 GEMMs and
// one attention, ~440 a forward.
//
// dit_adanorm: one launch for a gated residual and the LayerNorm after it,
//
//   h'  = h + g * y          (g absent: h + y)     one rounding to T
//   n   = ((h' - mean) * rstd) * (1 + scale) + shift, one rounding to T
//
// mean and variance in fp32 over the rounded h' (two passes over the row in
// registers), eps as given, `1 + scale` rounded to T first and applied in
// fp32 with shift: the rounding points of the composition it replaces
// (`torch.addcmul`, then `F.layer_norm` with weight `1 + scale`), which the
// plain version in ops/dit_glue.py runs. One warp owns a row: each lane
// holds 4 or 8 16-byte chunks of it (the DiT's d1024 is 4 in bf16 and 8 in
// fp32; any D <= 2048 in bf16, 1024 in fp32),
// issues all its loads of h and y before it uses any, and the two sums are
// warp shuffles: no shared memory, no block barrier, no atomics, so the
// bits repeat from run to run. What bounds it on the H100 is bytes: h and y
// read, h' and n written, 8 KB a row of d1024 in bf16 (32.8 MB, 9.8 us at
// 3.35 TB/s, for the narration cell's largest launch of 4 rows of 1000
// frames); the modulation vectors are shared by every row and stay in L2.
//
// dit_rope: x-transformers' rotary on the first `rot` channels of every row
// of q and of k [R, T, C], in place, in one launch: for each interleaved
// pair (x0, x1) at frame t,
//
//   x0' = x0 * cos[t, 2i]   + (-x1) * sin[t, 2i]
//   x1' = x1 * cos[t, 2i+1] +   x0  * sin[t, 2i+1]
//
// each product and the sum rounded to fp32 (no fused multiply-add: the
// composition's separate products), then once to T; channels from `rot` on
// are not touched. One warp owns a row of q or of k, a lane a pair; q's and
// k's rows of one frame are neighbours, so their cos and sin rows are read
// once from L2. What bounds it is the launch: 2 x 128 bytes read and written
// a row (1 MB for 4 x 1000 rows, 0.3 us at 3.35 TB/s) against a launch's
// few us of fixed cost.
//
// Both launch on the caller's stream, allocate nothing, read nothing back,
// and are captured in the CFM program's CUDA graph.

#include "common.cuh"

namespace {

using genie::Pack16;
using genie::round_to;
using genie::warp_sum;

constexpr int kRowsPerBlock = 4;     // warps of a dit_adanorm block, a row each
constexpr int kMaxChunks = 8;        // 16-byte chunks a lane holds, at most
constexpr int kRopeWarps = 8;        // warps of a dit_rope block, a row each

// 16 bytes of T packed from fp32 (one round-to-nearest-even each)
template <typename T> __device__ __forceinline__ uint4 pack16(const float* v);
template <> __device__ __forceinline__ uint4 pack16<__nv_bfloat16>(const float* v) {
  uint4 u;
  __nv_bfloat162* h = reinterpret_cast<__nv_bfloat162*>(&u);
#pragma unroll
  for (int i = 0; i < 4; ++i) h[i] = __floats2bfloat162_rn(v[2 * i], v[2 * i + 1]);
  return u;
}
template <> __device__ __forceinline__ uint4 pack16<float>(const float* v) {
  return make_uint4(__float_as_uint(v[0]), __float_as_uint(v[1]), __float_as_uint(v[2]),
                    __float_as_uint(v[3]));
}

template <typename T, int NC>
__global__ void __launch_bounds__(32 * kRowsPerBlock)
adanorm_kernel(const T* __restrict__ h, const T* __restrict__ y, const T* __restrict__ g,
               const T* __restrict__ scale, const T* __restrict__ shift,
               T* __restrict__ h_out, T* __restrict__ n_out, long long rows, int D,
               float eps) {
  constexpr int V = Pack16<T>::N;
  const int lane = threadIdx.x & 31;
  const long long row = (long long)blockIdx.x * kRowsPerBlock + (threadIdx.x >> 5);
  if (row >= rows) return;
  const int nch = D / V;
  const uint4* hp = reinterpret_cast<const uint4*>(h + row * D);
  const uint4* yp = reinterpret_cast<const uint4*>(y + row * D);

  uint4 hv[NC], yv[NC];
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = lane + 32 * c;
    if (i < nch) {
      hv[c] = hp[i];
      yv[c] = yp[i];
    }
  }
  // h' replaces h in hv: rounded to T, it packs back exactly, and the row
  // held as T (not as fp32) keeps the registers, and so the warps resident
  // on an SM, of a bare copy
  float sum = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = lane + 32 * c;
    if (i >= nch) continue;
    float x[V], yy[V], gg[V];
    Pack16<T>::unpack(hv[c], x);
    Pack16<T>::unpack(yv[c], yy);
    if (g) {
      Pack16<T>::unpack(reinterpret_cast<const uint4*>(g)[i], gg);
    } else {
#pragma unroll
      for (int j = 0; j < V; ++j) gg[j] = 1.f;
    }
#pragma unroll
    for (int j = 0; j < V; ++j) {
      x[j] = round_to<T>(fmaf(gg[j], yy[j], x[j]));
      sum += x[j];
    }
    hv[c] = pack16<T>(x);
    reinterpret_cast<uint4*>(h_out + row * D)[i] = hv[c];
  }
  const float mean = warp_sum(sum) / D;
  float sq = 0.f;
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    if (lane + 32 * c >= nch) continue;
    float x[V];
    Pack16<T>::unpack(hv[c], x);
#pragma unroll
    for (int j = 0; j < V; ++j) {
      const float d = x[j] - mean;
      sq = fmaf(d, d, sq);
    }
  }
  const float rstd = rsqrtf(warp_sum(sq) / D + eps);
#pragma unroll
  for (int c = 0; c < NC; ++c) {
    const int i = lane + 32 * c;
    if (i >= nch) continue;
    float x[V], s[V], b[V], o[V];
    Pack16<T>::unpack(hv[c], x);
    Pack16<T>::unpack(reinterpret_cast<const uint4*>(scale)[i], s);
    Pack16<T>::unpack(reinterpret_cast<const uint4*>(shift)[i], b);
#pragma unroll
    for (int j = 0; j < V; ++j)
      o[j] = round_to<T>(1.f + s[j]) * (rstd * (x[j] - mean)) + b[j];
    reinterpret_cast<uint4*>(n_out + row * D)[i] = pack16<T>(o);
  }
}

template <typename T>
__device__ __forceinline__ float2 load_pair(const T* p);
template <> __device__ __forceinline__ float2 load_pair<float>(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
template <> __device__ __forceinline__ float2 load_pair<__nv_bfloat16>(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
template <typename T>
__device__ __forceinline__ void store_pair(T* p, float a, float b);
template <> __device__ __forceinline__ void store_pair<float>(float* p, float a, float b) {
  *reinterpret_cast<float2*>(p) = make_float2(a, b);
}
template <>
__device__ __forceinline__ void store_pair<__nv_bfloat16>(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}

template <typename T>
__global__ void __launch_bounds__(32 * kRopeWarps)
rope_kernel(T* __restrict__ q, T* __restrict__ k, const float* __restrict__ cos_t,
            const float* __restrict__ sin_t, long long rows, int frames, int C, int rot) {
  const int lane = threadIdx.x & 31;
  const long long item = (long long)blockIdx.x * kRopeWarps + (threadIdx.x >> 5);
  if (item >= 2 * rows) return;
  const long long row = item >> 1;
  T* x = ((item & 1) ? k : q) + row * C;
  const long long t = row % frames;
  const float* cr = cos_t + t * rot;
  const float* sr = sin_t + t * rot;
  for (int p = lane; 2 * p < rot; p += 32) {
    const float2 v = load_pair<T>(x + 2 * p);
    const float2 c = *reinterpret_cast<const float2*>(cr + 2 * p);
    const float2 s = *reinterpret_cast<const float2*>(sr + 2 * p);
    const float o0 = __fadd_rn(__fmul_rn(v.x, c.x), __fmul_rn(-v.y, s.x));
    const float o1 = __fadd_rn(__fmul_rn(v.y, c.y), __fmul_rn(v.x, s.y));
    store_pair<T>(x + 2 * p, o0, o1);
  }
}

template <typename T, int NC>
void launch_adanorm_nc(cudaStream_t st, const void* h, const void* y, const void* g,
                       const void* scale, const void* shift, void* h_out, void* n_out,
                       long long rows, int D, float eps) {
  const long long blocks = (rows + kRowsPerBlock - 1) / kRowsPerBlock;
  adanorm_kernel<T, NC><<<(unsigned)blocks, 32 * kRowsPerBlock, 0, st>>>(
      static_cast<const T*>(h), static_cast<const T*>(y), static_cast<const T*>(g),
      static_cast<const T*>(scale), static_cast<const T*>(shift), static_cast<T*>(h_out),
      static_cast<T*>(n_out), rows, D, eps);
}

// 4 chunks a lane where they cover a row (d1024 in bf16), else 8
template <typename T>
int launch_adanorm(cudaStream_t st, const void* h, const void* y, const void* g,
                   const void* scale, const void* shift, void* h_out, void* n_out,
                   long long rows, int D, float eps) {
  if (D <= 4 * 32 * Pack16<T>::N)
    launch_adanorm_nc<T, 4>(st, h, y, g, scale, shift, h_out, n_out, rows, D, eps);
  else
    launch_adanorm_nc<T, kMaxChunks>(st, h, y, g, scale, shift, h_out, n_out, rows, D, eps);
  return (int)cudaGetLastError();
}

template <typename T>
int launch_rope(cudaStream_t st, void* q, void* k, const void* cos_t, const void* sin_t,
                long long rows, int frames, int C, int rot) {
  const long long blocks = (2 * rows + kRopeWarps - 1) / kRopeWarps;
  rope_kernel<T><<<(unsigned)blocks, 32 * kRopeWarps, 0, st>>>(
      static_cast<T*>(q), static_cast<T*>(k), static_cast<const float*>(cos_t),
      static_cast<const float*>(sin_t), rows, frames, C, rot);
  return (int)cudaGetLastError();
}

}  // namespace

// rows of D in T (dtype 0: fp32, 1: bf16); g may be null (a gate of one);
// every pointer on a 16-byte boundary, D a multiple of 16 bytes and at most
// 8 x 32 x 16 bytes.
extern "C" int dit_adanorm(const void* h, const void* y, const void* g, const void* scale,
                           const void* shift, void* h_out, void* n_out, long long rows, int D,
                           float eps, int dtype, void* stream) {
  const int esize = dtype == 0 ? 4 : 2;
  if ((dtype != 0 && dtype != 1) || rows < 1 || D < 1 || (D * esize) % 16 != 0 ||
      D * esize > kMaxChunks * 32 * 16 ||
      (rows + kRowsPerBlock - 1) / kRowsPerBlock > 0x7fffffff ||
      h == nullptr || y == nullptr || scale == nullptr || shift == nullptr ||
      h_out == nullptr || n_out == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch_adanorm<float>(st, h, y, g, scale, shift, h_out, n_out, rows, D, eps);
  return launch_adanorm<__nv_bfloat16>(st, h, y, g, scale, shift, h_out, n_out, rows, D, eps);
}

// q and k: rows (R x frames) of C in T, in place; cos and sin: fp32 [frames,
// rot]; rot even, at most C; C even.
extern "C" int dit_rope(void* q, void* k, const void* cos_t, const void* sin_t, long long rows,
                        int frames, int C, int rot, int dtype, void* stream) {
  if ((dtype != 0 && dtype != 1) || rows < 1 || frames < 1 || rows % frames != 0 || rot < 2 ||
      rot % 2 != 0 || C % 2 != 0 || rot > C ||
      (2 * rows + kRopeWarps - 1) / kRopeWarps > 0x7fffffff ||
      q == nullptr || k == nullptr || cos_t == nullptr || sin_t == nullptr)
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0) return launch_rope<float>(st, q, k, cos_t, sin_t, rows, frames, C, rot);
  return launch_rope<__nv_bfloat16>(st, q, k, cos_t, sin_t, rows, frames, C, rot);
}
