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
// What bounds it on the H100: the weight bytes. At L=24, D=512 a step
// reads 24 x 3,145,728 weights (75.5 MB in int8, 151 MB in bf16) plus
// 24 x 2 x S x 512 cache values (22 MB in bf16 at S=448): about 29 us
// for int8 at 3.35 TB/s. The products are GEMVs (M=1), far below the
// tensor cores' ratio of operations to bytes, so no tensor core is used.
//
// Design: one persistent cooperative launch per step (one block per SM),
// with a grid-wide barrier between the phases of a layer (qkv | attention
// | out-proj | ffn1 | ffn2: 5 barriers per layer). Each block keeps its
// own copy of h in shared memory and recomputes both LayerNorms of the
// 512-vector itself; the reductions have a fixed order, so every block
// holds the same bits. GEMVs map threads to output columns: a tile of
// 2 x 16 bytes of a weight row per block iteration, its K rows split over
// 128 thread groups and summed in shared memory, so every read of the
// [in, out] row-major weights is a full 32-byte sector. Attention takes
// one block per head; the whole row of scores lives in shared memory.
// Values that other blocks wrote in this launch are read through L2
// (ld.global.cg), since L1 is not coherent across SMs. The barriers, not
// the bytes, bound this first version.
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kThreads = 256;
constexpr int kWarps = kThreads / 32;
constexpr int kKGroups = kThreads / 2;   // GEMV: 2 column lanes x 128 k groups
constexpr int kMaxD = 1024;
constexpr int kMaxF = 4096;
constexpr int kMaxDh = 64;
constexpr int kRed = 4096;               // GEMV partials (128 x 32) and scores
constexpr int kMaxS = kRed;
constexpr int kMaxDevices = 64;

struct Args {
  const void* w[4];          // qkv, out, ffn1, ffn2: [L, in, out] of W
  const float* s[4];         // per-channel scales [L, out] (int8 W), else null
  const float* b[4];         // biases [L, out]
  const float* n1s; const float* n1b; const float* n2s; const float* n2b;  // [L, D]
  void* kc; void* vc;        // [L, S, D] of C, updated in place at row pos
  const float* mask;         // [S], 1 = attend
  const float* h_in;         // [D]
  float* h_out;              // [D]
  float* scratch;            // qkv [3D] | att [D] | proj [D] | ff [F] | ff2 [D]
  int L, S, D, H, F, pos;
  float scale, eps;
};

// y[n] = act(sum_k xs[k] W[k, n] (* scale[n]) + b[n]) for n < N.
template <typename W>
__device__ void gemv(const W* __restrict__ w, const float* __restrict__ scale,
                     const float* __restrict__ bias, const float* xs, int K, int N,
                     bool relu, float* y, float* red) {
  constexpr int V = genie::Pack16<W>::N;
  constexpr int TN = 2 * V;
  const int cl = threadIdx.x & 1, kg = threadIdx.x >> 1;
  const int ntiles = N / TN;
  for (int tile = blockIdx.x; tile < ntiles; tile += gridDim.x) {
    const int col0 = tile * TN + cl * V;
    float acc[V];
#pragma unroll
    for (int v = 0; v < V; ++v) acc[v] = 0.f;
    for (int k = kg; k < K; k += kKGroups) {
      const uint4 u = __ldg(reinterpret_cast<const uint4*>(w + (size_t)k * N + col0));
      float wv[V];
      genie::Pack16<W>::unpack(u, wv);
      const float xk = xs[k];
#pragma unroll
      for (int v = 0; v < V; ++v) acc[v] = fmaf(xk, wv[v], acc[v]);
    }
#pragma unroll
    for (int v = 0; v < V; ++v) red[kg * TN + cl * V + v] = acc[v];
    __syncthreads();
    if (threadIdx.x < TN) {
      float t = 0.f;
      for (int g = 0; g < kKGroups; ++g) t += red[g * TN + threadIdx.x];
      const int n = tile * TN + threadIdx.x;
      if (scale != nullptr) t *= scale[n];
      t += bias[n];
      y[n] = relu ? fmaxf(t, 0.f) : t;
    }
    __syncthreads();
  }
}

// hs = LayerNorm(hs + add) over D, fp32 statistics, in every block.
__device__ void add_layer_norm(float* hs, const float* add, const float* g,
                               const float* b, int D, float eps, float* red32) {
  float s = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float v = hs[i] + genie::ldcg_f(add + i);
    hs[i] = v;
    s += v;
  }
  const float mean = genie::block_sum(s, red32) / D;
  float q = 0.f;
  for (int i = threadIdx.x; i < D; i += blockDim.x) {
    const float d = hs[i] - mean;
    q += d * d;
  }
  const float var = genie::block_sum(q, red32) / D;
  const float r = rsqrtf(var + eps);
  for (int i = threadIdx.x; i < D; i += blockDim.x)
    hs[i] = (hs[i] - mean) * r * g[i] + b[i];
  __syncthreads();
}

// One block per head: write the head's slice of the new K/V row at pos,
// then softmax(q . K^T) . V over the whole cache row.
template <typename C>
__device__ void attention(const Args& a, int l, const float* qkv, float* att,
                          float* sc, float* qs, float (*part)[kMaxDh], float* red32) {
  const int D = a.D, S = a.S, H = a.H, Dh = D / H;
  constexpr int P = genie::Pack16<C>::N;
  C* kc = reinterpret_cast<C*>(a.kc) + (size_t)l * S * D;
  C* vc = reinterpret_cast<C*>(a.vc) + (size_t)l * S * D;
  const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
  for (int h = blockIdx.x; h < H; h += gridDim.x) {
    for (int d = threadIdx.x; d < Dh; d += blockDim.x) {
      const int c = h * Dh + d;
      qs[d] = genie::round_to<C>(genie::ldcg_f(qkv + c));
      // in-place cache update at the row-uniform write position
      kc[(size_t)a.pos * D + c] = genie::from_f<C>(genie::ldcg_f(qkv + D + c));
      vc[(size_t)a.pos * D + c] = genie::from_f<C>(genie::ldcg_f(qkv + 2 * D + c));
    }
    __syncthreads();

    float lmax = -INFINITY;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const uint4* row = reinterpret_cast<const uint4*>(kc + (size_t)s * D + h * Dh);
      float acc = 0.f;
      for (int j = 0; j < Dh / P; ++j) {
        float f[P];
        genie::Pack16<C>::unpack(__ldcg(row + j), f);
#pragma unroll
        for (int t = 0; t < P; ++t) acc = fmaf(qs[j * P + t], f[t], acc);
      }
      const float x = acc * a.scale + (a.mask[s] - 1.f) * 1e10f;
      sc[s] = x;
      lmax = fmaxf(lmax, x);
    }
    const float m = genie::block_max(lmax, red32);
    float lsum = 0.f;
    for (int s = threadIdx.x; s < S; s += blockDim.x) {
      const float e = expf(sc[s] - m);
      sc[s] = e;
      lsum += e;
    }
    const float lt = genie::block_sum(lsum, red32);
    for (int s = threadIdx.x; s < S; s += blockDim.x)
      sc[s] = genie::round_to<C>(sc[s] / lt);
    __syncthreads();

    float acc[kMaxDh / 32];
#pragma unroll
    for (int j = 0; j < kMaxDh / 32; ++j) acc[j] = 0.f;
    for (int s = warp; s < S; s += kWarps) {
      const float p = sc[s];
      const C* row = vc + (size_t)s * D + h * Dh;
#pragma unroll
      for (int j = 0; j < kMaxDh / 32; ++j) {
        const int d = j * 32 + lane;
        if (d < Dh) acc[j] = fmaf(p, genie::ldcg_f(row + d), acc[j]);
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
      att[h * Dh + d] = o;
    }
    __syncthreads();
  }
}

template <typename W, typename C>
__global__ void __launch_bounds__(kThreads, 1) fused_decode_kernel(const Args a) {
  cg::grid_group grid = cg::this_grid();
  __shared__ float xs[kMaxF];
  __shared__ float hs[kMaxD];
  __shared__ float red[kRed];
  __shared__ float qs[kMaxDh];
  __shared__ float part[kWarps][kMaxDh];
  __shared__ float red32[32];

  const int D = a.D, F = a.F;
  float* qkv = a.scratch;
  float* att = qkv + 3 * D;
  float* proj = att + D;
  float* ff = proj + D;
  float* ff2 = ff + F;
  const int N[4] = {3 * D, D, F, D};
  const int K[4] = {D, D, D, F};

  for (int i = threadIdx.x; i < D; i += blockDim.x) hs[i] = a.h_in[i];
  __syncthreads();

  for (int l = 0; l < a.L; ++l) {
    const W* w[4];
    const float* sc[4];
    const float* bs[4];
#pragma unroll
    for (int m = 0; m < 4; ++m) {
      w[m] = reinterpret_cast<const W*>(a.w[m]) + (size_t)l * K[m] * N[m];
      sc[m] = a.s[m] ? a.s[m] + (size_t)l * N[m] : nullptr;
      bs[m] = a.b[m] + (size_t)l * N[m];
    }

    for (int i = threadIdx.x; i < D; i += blockDim.x) xs[i] = genie::round_to<C>(hs[i]);
    __syncthreads();
    gemv<W>(w[0], sc[0], bs[0], xs, D, 3 * D, false, qkv, red);
    grid.sync();

    attention<C>(a, l, qkv, att, red, qs, part, red32);
    grid.sync();

    for (int i = threadIdx.x; i < D; i += blockDim.x)
      xs[i] = genie::round_to<C>(genie::ldcg_f(att + i));
    __syncthreads();
    gemv<W>(w[1], sc[1], bs[1], xs, D, D, false, proj, red);
    grid.sync();

    add_layer_norm(hs, proj, a.n1s + (size_t)l * D, a.n1b + (size_t)l * D, D, a.eps, red32);
    for (int i = threadIdx.x; i < D; i += blockDim.x) xs[i] = genie::round_to<C>(hs[i]);
    __syncthreads();
    gemv<W>(w[2], sc[2], bs[2], xs, D, F, true, ff, red);
    grid.sync();

    for (int i = threadIdx.x; i < F; i += blockDim.x)
      xs[i] = genie::round_to<C>(genie::ldcg_f(ff + i));
    __syncthreads();
    gemv<W>(w[3], sc[3], bs[3], xs, F, D, false, ff2, red);
    grid.sync();

    add_layer_norm(hs, ff2, a.n2s + (size_t)l * D, a.n2b + (size_t)l * D, D, a.eps, red32);
  }
  if (blockIdx.x == 0)
    for (int i = threadIdx.x; i < D; i += blockDim.x) a.h_out[i] = hs[i];
}

template <typename W, typename C>
int launch(const Args& a, cudaStream_t st) {
  constexpr int TN = 2 * genie::Pack16<W>::N;
  const int Dh = a.D / a.H;
  if (a.D > kMaxD || a.F > kMaxF || a.S > kMaxS || Dh > kMaxDh || a.D % a.H != 0 ||
      a.D % TN != 0 || a.F % TN != 0 || Dh % genie::Pack16<C>::N != 0 || a.pos < 0 ||
      a.pos >= a.S || a.L < 1)
    return (int)cudaErrorInvalidValue;
  // the grid is sized for the current device (the caller makes it the
  // device of the stream) and cached per device
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  static int grid_blocks[kMaxDevices] = {};
  if (grid_blocks[dev] == 0) {
    int sms = 0, coop = 0, per_sm = 0;
    cudaDeviceGetAttribute(&sms, cudaDevAttrMultiProcessorCount, dev);
    cudaDeviceGetAttribute(&coop, cudaDevAttrCooperativeLaunch, dev);
    cudaOccupancyMaxActiveBlocksPerMultiprocessor(&per_sm, fused_decode_kernel<W, C>,
                                                  kThreads, 0);
    if (!coop || per_sm < 1) return (int)cudaErrorCooperativeLaunchTooLarge;
    grid_blocks[dev] = sms;  // one resident block per SM
  }
  void* args[] = {const_cast<Args*>(&a)};
  const cudaError_t e = cudaLaunchCooperativeKernel(
      reinterpret_cast<const void*>(fused_decode_kernel<W, C>), dim3(grid_blocks[dev]),
      dim3(kThreads), args, 0, st);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// ptrs (22 device pointers, 0 for none): wqkv, wout, w1, w2, sqkv, sout, s1,
// s2, bqkv, bout, b1, b2, n1s, n1b, n2s, n2b, k_cache, v_cache, mask, h_in,
// h_out, scratch. dims: L, S, D, H, F, pos. wtype: 0 float32, 1 bfloat16,
// 2 int8. ctype (caches and activations): 0 float32, 1 bfloat16. Float
// weights are in the compute dtype (wtype == ctype); int8 takes either.
extern "C" int fused_decode_step(const unsigned long long* ptrs, const int* dims,
                                 float scale, float eps, int wtype, int ctype,
                                 void* stream) {
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
  a.L = dims[0]; a.S = dims[1]; a.D = dims[2]; a.H = dims[3]; a.F = dims[4];
  a.pos = dims[5];
  a.scale = scale;
  a.eps = eps;
  if ((wtype == 2) != (a.s[0] != nullptr)) return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  switch (wtype * 2 + ctype) {
    case 0: return launch<float, float>(a, st);
    case 3: return launch<__nv_bfloat16, __nv_bfloat16>(a, st);
    case 4: return launch<int8_t, float>(a, st);
    case 5: return launch<int8_t, __nv_bfloat16>(a, st);
    default: return (int)cudaErrorInvalidValue;
  }
}
