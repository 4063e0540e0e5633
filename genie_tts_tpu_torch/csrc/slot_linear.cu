// One int8 linear of the slot machine's decode layer with its epilogue, for
// Hopper (sm_90a).
//
// Replaces no Pallas kernel: the JAX package runs the slot decode layer's
// dense path (models/t2s.py::_layer_decode_buffered) as XLA ops, and so did
// the port's plain PyTorch (ops/layers.py::linear and layer_norm), which
// casts each int8 weight to the activation dtype every step and runs a
// LayerNorm as ten small kernels: ~46 launches a layer, each a few us of
// fixed cost over 8 rows. One launch here computes, for the B rows of x
// [B, K] (the slots) and the int8 codes w [K, N] with per-column fp32
// scales,
//
//   y   = (x @ w) * scale + b                       fp32 sums, exact products
//   out = y                                          tail 0 (qkv)
//       | relu(y)                                    tail 1 (ffn1)
//       | LayerNorm(res + y) * g + beta              tail 2 (out, ffn2):
//                                                     fp32 mean and variance
//
// stored once in the activation dtype. No bf16 copy of a weight is written.
//
// What bounds it on the H100: the weight bytes (0.26-1.05 MB a launch at the
// T2S widths, 0.08-0.31 us at 3.35 TB/s), far below the fixed cost of a
// launch, a memory round trip and a cluster barrier; the arithmetic (8 rows)
// is a few MFLOP. So the design spends as few round trips and barriers as
// it can and spreads each weight over enough SMs that its bytes arrive in
// one round trip:
//
// - A cluster of 16 blocks covers a tile of NT output columns (the whole
//   row, for the LayerNorm tail) and splits K between its 128 warps: each
//   warp owns a 128-column group and a strided set of 16-row k-steps, and
//   issues the loads of up to four k-steps (16-byte loads, 64 bytes a lane
//   a step, read in place from the stored [K, N] layout) before it uses
//   any, so all of a block's bytes are in flight at once.
// - The products run on the tensor cores (mma.m16n8k16, bf16 in, fp32
//   out): A is the weight tile transposed (16 columns x 16 k), B the 8 rows
//   of x, so the slots are the mma's N = 8. The codes are dequantized in
//   registers: the bias trick gives each code as an exact fp32, whose upper
//   half is the exact bf16 (|code| <= 128 needs 8 significant bits). The
//   k and column orders inside a step are permuted (any order sums the same
//   products) so that a lane's four rows of 16 bytes feed eight mmas
//   directly, with no shuffle and no shared-memory staging. fp32
//   activations split into three bf16 terms (hi + mid + lo == x exactly),
//   three mmas per tile: products stay exact.
// - Block r owns NT/16 of the tile's columns. Each warp pushes its partial
//   sums into the owners' shared memory (distributed shared memory) by
//   st.async stores that count their bytes on the owner's mbarrier, and
//   each block waits only for the 32 KB sent to it: no barrier of the whole
//   cluster (in the first design, 32 remote loads in turn cost ~3 us a
//   launch, and then each cluster.sync ~1.5 us; this exchange saved ~0.6 us
//   of 5.7 a launch over the barriers, H100, CUDA graph). Each block sums its
//   columns' partials from its own shared memory in a fixed order (no
//   atomics: the bits repeat from run to run) and applies scale, bias and
//   the tail in fp32, with the scale, bias and norm parameters loaded while
//   the weights stream in. The LayerNorm's row statistics are one more
//   exchange: each block pushes its own mean and sum of squared deviations
//   of the row (two-pass over its columns) to every block, and each
//   combines the 16 in rank order (Chan's formula), so the variance is the
//   whole row's without a second pass. One cluster barrier, split around
//   the weight loads, makes sure every block's mbarriers exist before the
//   first push; a block ends only when every byte sent to it has landed.
// - Programmatic dependent launch: each launch lets the next one on the
//   stream start at once (griddepcontrol.launch_dependents; after any
//   other kernel a launch starts when that kernel ends, as before). A
//   launch issues its weight loads (which no launch writes) and waits
//   (griddepcontrol.wait) only before it reads x and the residual; every
//   launch waits before it ends, so launches still end in stream order.
//   This hid ~1.8 us of the ~7.5 us a launch took back to back at the
//   serving geometry (H100, CUDA graph).
// - B above 8 loops over row tiles of 8 (the weights are read again, from
//   L2).
#include <cooperative_groups.h>

#include "common.cuh"

namespace cg = cooperative_groups;

namespace {

constexpr int kCluster = 16;    // blocks of a cluster, splitting K
constexpr int kThreads = 256;   // 8 warps
constexpr int kWarps = kThreads / 32;
constexpr int kRows = 8;        // rows of a row tile: the mma's N
constexpr int kWarpCols = 128;  // columns of a warp's group: 8 lane groups x 16
constexpr int kRecv = kWarps * kWarpCols / kCluster * kRows;  // floats from one rank
constexpr int kChunk = 4;       // k-steps whose loads a warp issues before using any
constexpr int kMaxPerLane = 2;  // epilogue columns a lane: NT / kCluster <= 64
constexpr int kMaxDevices = 64;

enum Tail { kNone = 0, kRelu = 1, kNorm = 2 };

__device__ __forceinline__ uint4 ld_stream(const int8_t* p) {
  uint4 v;
  asm volatile("ld.global.nc.L1::no_allocate.v4.u32 {%0,%1,%2,%3}, [%4];"
               : "=r"(v.x), "=r"(v.y), "=r"(v.z), "=r"(v.w) : "l"(p));
  return v;
}

// the code in byte ``sel`` of ``w`` (already xor 0x80808080) as fp32 bits
__device__ __forceinline__ uint32_t code_bits(uint32_t w, int sel) {
  return __float_as_uint(__uint_as_float(__byte_perm(w, 0x4B000000u, 0x7650 + sel)) -
                         8388736.f);
}

// bf16x2 of two exact small-integer floats: their upper halves
__device__ __forceinline__ uint32_t pack_hi(uint32_t lo, uint32_t hi) {
  return __byte_perm(lo, hi, 0x7632);
}

__device__ __forceinline__ uint32_t bf2(float lo, float hi) {
  __nv_bfloat162 v = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&v);
}

// Distributed shared memory with arrival counted in bytes: a store into
// block ``rank``'s shared memory that completes bytes on that block's
// mbarrier (st.async), so a receiver waits for exactly the bytes sent to it
// and no block waits on a barrier of the whole cluster.
__device__ __forceinline__ unsigned remote(const void* p, int rank) {
  unsigned r;
  asm volatile("mapa.shared::cluster.u32 %0, %1, %2;" : "=r"(r) : "r"(genie::smem_addr(p)),
               "r"(rank));
  return r;
}
__device__ __forceinline__ void push4(unsigned dst, float4 v, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v4.f32 [%0], {%1,%2,%3,%4}, [%5];"
      ::"r"(dst), "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w), "r"(bar) : "memory");
}
__device__ __forceinline__ void push2(unsigned dst, float a, float b, unsigned bar) {
  asm volatile(
      "st.async.shared::cluster.mbarrier::complete_tx::bytes.v2.f32 [%0], {%1,%2}, [%3];"
      ::"r"(dst), "f"(a), "f"(b), "r"(bar) : "memory");
}
// wait for the phase of ``parity`` of a local mbarrier that remote blocks
// complete (acquire at cluster scope); a bounded spin traps, so bytes that
// never arrive end the launch with an error
__device__ __forceinline__ void wait_bytes(unsigned long long* bar, unsigned parity) {
  long long spins = 0;
  for (;;) {
    unsigned done;
    asm volatile(
        "{ .reg .pred p; mbarrier.try_wait.parity.acquire.cluster.shared::cta.b64 p, [%1], %2; "
        "selp.u32 %0, 1, 0, p; }"
        : "=r"(done) : "r"(genie::smem_addr(bar)), "r"(parity) : "memory");
    if (done) return;
    if (++spins > genie::kSpinLimit) __trap();
  }
}

__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4], uint32_t b0,
                                    uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 {%0,%1,%2,%3}, {%4,%5,%6,%7}, "
      "{%8,%9}, {%0,%1,%2,%3};"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}

// The B operand of one k-step: x[row][k .. k+3] as bf16 pairs, one term
// for bf16 rows, three (hi, mid, lo) for fp32 rows. x may be the previous
// launch's output, written while this launch runs (programmatic dependent
// launch), so it is read with coherent loads (ld.global.cg) after
// griddepcontrol.wait, never through the read-only path; only the weights,
// which no launch writes, stream through ld.global.nc.
template <typename T> struct XTerms;
template <> struct XTerms<__nv_bfloat16> {
  static constexpr int N = 1;
  __device__ __forceinline__ static void load(const __nv_bfloat16* p, bool ok, uint32_t (*b)[2]) {
    uint2 v = make_uint2(0u, 0u);
    if (ok) v = __ldcg(reinterpret_cast<const uint2*>(p));
    b[0][0] = v.x;
    b[0][1] = v.y;
  }
};
template <> struct XTerms<float> {
  static constexpr int N = 3;
  __device__ __forceinline__ static void load(const float* p, bool ok, uint32_t (*b)[2]) {
    float4 v = make_float4(0.f, 0.f, 0.f, 0.f);
    if (ok) v = __ldcg(reinterpret_cast<const float4*>(p));
    float r[4] = {v.x, v.y, v.z, v.w};
    float t[3][4];
#pragma unroll
    for (int i = 0; i < 4; ++i) {
      float rest = r[i];
#pragma unroll
      for (int s = 0; s < 3; ++s) {
        t[s][i] = __bfloat162float(__float2bfloat16_rn(rest));
        rest -= t[s][i];
      }
    }
#pragma unroll
    for (int s = 0; s < 3; ++s) {
      b[s][0] = bf2(t[s][0], t[s][1]);
      b[s][1] = bf2(t[s][2], t[s][3]);
    }
  }
};

template <typename T>
__global__ void __launch_bounds__(kThreads, 1)
slot_linear_kernel(const T* __restrict__ x, long long ldx, const int8_t* __restrict__ w,
                   const float* __restrict__ scale, const T* __restrict__ bias,
                   const T* __restrict__ res, long long ldr, const float* __restrict__ ln_g,
                   const float* __restrict__ ln_b, T* __restrict__ out,
                   long long ldo, int B, int K, int N, int NT, int tail, float eps) {
  // partials pushed here by every block: [source rank][k-part][row][cw]
  __shared__ __align__(16) float recv[kCluster * kRecv];
  // each block's (mean, sum of squared deviations) of its columns, by row
  __shared__ __align__(8) float2 stat[kCluster][kRows];
  // completed by the bytes of the partials and of the statistics pushed here
  __shared__ __align__(8) unsigned long long bar[2];
  cg::cluster_group cluster = cg::this_cluster();
  const int rank = (int)cluster.block_rank();
  const int tile = blockIdx.x / kCluster;
  const int tid = threadIdx.x, lane = tid & 31, warp = tid >> 5;
  const int g = lane >> 2, t = lane & 3;          // mma group and lane in group
  const int ncg = NT / kWarpCols;                 // column groups: 1, 2, 4 or 8
  const int kpb = kWarps / ncg;                   // k-parts a block
  const int cgi = warp % ncg, kpl = warp / ncg;
  const int kparts = kCluster * kpb;
  const int kp = rank * kpb + kpl;
  const int nsteps = K / 16;
  const int col0 = tile * NT + cgi * kWarpCols + 16 * g;  // this lane's 16 weight columns
  const int cw = NT / kCluster;                   // epilogue columns of this block
  constexpr int kTerms = XTerms<T>::N;

  // the next launch on the stream may start its own weight loads now; it
  // reads what this one writes only after its griddepcontrol.wait
  asm volatile("griddepcontrol.launch_dependents;" ::: "memory");
  constexpr unsigned kPartBytes = kCluster * kRecv * 4, kStatBytes = kCluster * kRows * 8;
  if (tid == 0) {
    genie::mbar_init(&bar[0]);
    genie::mbar_init(&bar[1]);
    genie::mbar_expect(&bar[0], kPartBytes);
    if (tail == kNorm) genie::mbar_expect(&bar[1], kStatBytes);
  }
  // no block pushes into another before that one's mbarriers exist: the
  // arrive here, the wait just before the first push (the weights load between)
  asm volatile("barrier.cluster.arrive.release.aligned;" ::: "memory");
  bool joined = false;

  // the epilogue's columns (warp = row of the tile, lanes over this block's
  // cw columns) and their parameters, loaded while the weights stream in
  int col[kMaxPerLane];
  bool has[kMaxPerLane];
  float sc[kMaxPerLane], bi[kMaxPerLane], gg[kMaxPerLane], bb[kMaxPerLane];
#pragma unroll
  for (int v = 0; v < kMaxPerLane; ++v) {
    const int cl = lane + 32 * v;
    has[v] = cl < cw;
    col[v] = tile * NT + rank * cw + (has[v] ? cl : 0);
    sc[v] = scale[col[v]];
    bi[v] = genie::to_f(bias[col[v]]);
    gg[v] = tail == kNorm ? ln_g[col[v]] : 0.f;
    bb[v] = tail == kNorm ? ln_b[col[v]] : 0.f;
  }

  for (int row0 = 0; row0 < B; row0 += kRows) {
    float c[8][4];
#pragma unroll
    for (int j = 0; j < 8; ++j) c[j][0] = c[j][1] = c[j][2] = c[j][3] = 0.f;
    const int xrow = row0 + g;
    const T* xp = x + (long long)xrow * ldx + 4 * t;
    for (int base = kp; base < nsteps; base += kChunk * kparts) {
      uint4 wr[kChunk][4];
      uint32_t bx[kChunk][kTerms][2];
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int st = base + i * kparts;
        if (st < nsteps) {
          const int8_t* wp = w + (long long)(st * 16 + 4 * t) * N + col0;
#pragma unroll
          for (int r = 0; r < 4; ++r) wr[i][r] = ld_stream(wp + (long long)r * N);
        }
      }
      // x (and below the residual) may be the previous launch's output
      asm volatile("griddepcontrol.wait;" ::: "memory");
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int st = base + i * kparts;
        if (st < nsteps) XTerms<T>::load(xp + st * 16, xrow < B, bx[i]);
      }
#pragma unroll
      for (int i = 0; i < kChunk; ++i) {
        const int st = base + i * kparts;
        if (st >= nsteps) break;
        uint32_t wv[4][4];
#pragma unroll
        for (int r = 0; r < 4; ++r) {
          wv[r][0] = wr[i][r].x ^ 0x80808080u;
          wv[r][1] = wr[i][r].y ^ 0x80808080u;
          wv[r][2] = wr[i][r].z ^ 0x80808080u;
          wv[r][3] = wr[i][r].w ^ 0x80808080u;
        }
        // mma j: columns 16g+2j (A row g) and 16g+2j+1 (A row g+8); the
        // step's rows 4t..4t+3 are k = 2t, 2t+1, 2t+8, 2t+9 of the mma
#pragma unroll
        for (int j = 0; j < 8; ++j) {
          const int wi = j >> 1, sel = (j & 1) * 2;
          uint32_t f[4][2];
#pragma unroll
          for (int r = 0; r < 4; ++r) {
            f[r][0] = code_bits(wv[r][wi], sel);
            f[r][1] = code_bits(wv[r][wi], sel + 1);
          }
          const uint32_t a[4] = {pack_hi(f[0][0], f[1][0]), pack_hi(f[0][1], f[1][1]),
                                 pack_hi(f[2][0], f[3][0]), pack_hi(f[2][1], f[3][1])};
#pragma unroll
          for (int s = 0; s < kTerms; ++s) mma(c[j], a, bx[i][s][0], bx[i][s][1]);
        }
      }
    }
    asm volatile("griddepcontrol.wait;" ::: "memory");   // a warp with no k-step
    const int row = row0 + warp;
    const bool live = row < B;
    float rs[kMaxPerLane];
#pragma unroll
    for (int v = 0; v < kMaxPerLane; ++v)
      rs[v] = tail == kNorm && live && has[v] ? genie::ldcg_f(res + (long long)row * ldr + col[v])
                                              : 0.f;
    if (!joined) {
      asm volatile("barrier.cluster.wait.acquire.aligned;" ::: "memory");
      joined = true;
    }
    const unsigned parity = (row0 / kRows) & 1;
    // partials: c[j][0..3] = y[row 2t, 2t+1][col 16g+2j], y[2t, 2t+1][16g+2j+1],
    // pushed as float4s of 4 columns into the shared memory of the block
    // that owns those columns
    {
      const int n0 = cgi * kWarpCols + 16 * g;
#pragma unroll
      for (int q = 0; q < 4; ++q) {
        const int n = n0 + 4 * q, owner = n / cw;
        const unsigned dst =
            remote(recv + ((rank * kpb + kpl) * kRows + 2 * t) * cw + n % cw, owner);
        const unsigned rbar = remote(&bar[0], owner);
        push4(dst, make_float4(c[2 * q][0], c[2 * q][2], c[2 * q + 1][0], c[2 * q + 1][2]),
              rbar);
        push4(dst + cw * 4,
              make_float4(c[2 * q][1], c[2 * q][3], c[2 * q + 1][1], c[2 * q + 1][3]), rbar);
      }
    }
    wait_bytes(&bar[0], parity);

    // each column's 16 x kpb partials summed from local shared memory in
    // rank order, then scale, bias and the tail
    float z[kMaxPerLane];
    float s1 = 0.f;
#pragma unroll
    for (int v = 0; v < kMaxPerLane; ++v) {
      z[v] = 0.f;
      if (has[v]) {
        const int cl = lane + 32 * v;
        float acc = 0.f;
#pragma unroll 8
        for (int src = 0; src < kCluster * kpb; ++src) acc += recv[(src * kRows + warp) * cw + cl];
        float y = acc * sc[v] + bi[v];
        if (tail == kRelu) y = fmaxf(y, 0.f);
        z[v] = y + rs[v];
        s1 += z[v];
      }
    }
    if (tail == kNorm) {
      // this block's mean and sum of squared deviations of the row, pushed
      // to every block of the cluster; every block combines the 16 in rank
      // order (equal counts: M2 = sum M2_q + cw * sum (mean_q - mean)^2)
      const float m_b = genie::warp_sum(s1) / (float)cw;
      float s2 = 0.f;
#pragma unroll
      for (int v = 0; v < kMaxPerLane; ++v)
        if (has[v]) s2 += (z[v] - m_b) * (z[v] - m_b);
      s2 = genie::warp_sum(s2);
      if (lane < kCluster) push2(remote(&stat[rank][warp], lane), m_b, s2, remote(&bar[1], lane));
      wait_bytes(&bar[1], parity);
      float tot = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) tot += stat[q][warp].x;
      const float mean = tot / (float)kCluster;
      float m2 = 0.f, dev = 0.f;
#pragma unroll
      for (int q = 0; q < kCluster; ++q) {
        const float d = stat[q][warp].x - mean;
        m2 += stat[q][warp].y;
        dev += d * d;
      }
      const float rstd = rsqrtf((m2 + (float)cw * dev) / (float)N + eps);
#pragma unroll
      for (int v = 0; v < kMaxPerLane; ++v) z[v] = (z[v] - mean) * rstd * gg[v] + bb[v];
    }
    if (live) {
#pragma unroll
      for (int v = 0; v < kMaxPerLane; ++v)
        if (has[v]) out[(long long)row * ldo + col[v]] = genie::from_f<T>(z[v]);
    }
    // the next row tile pushes into shared memory only after every block has
    // read this one's. A block ends only when every byte sent to it has
    // landed, so no push reaches a block that has ended.
    if (row0 + kRows < B) {
      if (tid == 0) {
        genie::mbar_expect(&bar[0], kPartBytes);
        if (tail == kNorm) genie::mbar_expect(&bar[1], kStatBytes);
      }
      cluster.sync();
    }
  }
}

template <typename T>
int launch(cudaStream_t st, const void* x, long long ldx, const void* w, const void* scale,
           const void* bias, const void* res, long long ldr, const void* ln_g,
           const void* ln_b, void* out, long long ldo, int B, int K, int N, int NT,
           int tail, float eps) {
  auto kern = slot_linear_kernel<T>;
  // a cluster of 16 is above the portable 8: opt in once on each device (the
  // attribute holds for the kernel on the current device only)
  static bool ready[kMaxDevices] = {};
  int dev = 0;
  if (cudaGetDevice(&dev) != cudaSuccess || dev < 0 || dev >= kMaxDevices)
    return (int)cudaErrorInvalidDevice;
  if (!ready[dev]) {
    const cudaError_t e =
        cudaFuncSetAttribute(kern, cudaFuncAttributeNonPortableClusterSizeAllowed, 1);
    if (e != cudaSuccess) return (int)e;
    ready[dev] = true;
  }
  cudaLaunchConfig_t cfg = {};
  cfg.gridDim = dim3(kCluster * (N / NT));
  cfg.blockDim = dim3(kThreads);
  cfg.dynamicSmemBytes = 0;
  cfg.stream = st;
  cudaLaunchAttribute attr[2];
  attr[0].id = cudaLaunchAttributeClusterDimension;
  attr[0].val.clusterDim.x = kCluster;
  attr[0].val.clusterDim.y = 1;
  attr[0].val.clusterDim.z = 1;
  // programmatic dependent launch: this launch may start (and load its
  // weights) before the previous one on the stream ends
  attr[1].id = cudaLaunchAttributeProgrammaticStreamSerialization;
  attr[1].val.programmaticStreamSerializationAllowed = 1;
  cfg.attrs = attr;
  cfg.numAttrs = 2;
  const cudaError_t e = cudaLaunchKernelEx(
      &cfg, kern, (const T*)x, ldx, (const int8_t*)w, (const float*)scale, (const T*)bias,
      (const T*)res, ldr, (const float*)ln_g, (const float*)ln_b, (T*)out, ldo, B, K, N, NT,
      tail, eps);
  if (e != cudaSuccess) return (int)e;
  return (int)cudaGetLastError();
}

}  // namespace

// dtype: 0 = float32, 1 = bfloat16 (x, bias, res, out). x: rows of ldx
// elements, 16-byte aligned; w: int8 [K, N] row-major, 16-byte aligned;
// scale, ln_g, ln_b: fp32 [N]; bias: [N]; res: rows of ldr (tail 2 only).
// NT: the columns of a cluster, 128, 256, 512 or 1024, dividing N (tail 2:
// NT == N). K a multiple of 16.
extern "C" int slot_linear(const void* x, long long ldx, const void* w, const void* scale,
                           const void* bias, const void* res, long long ldr, const void* ln_g,
                           const void* ln_b, void* out, long long ldo, int B, int K, int N,
                           int NT, int tail, float eps, int dtype, void* stream) {
  if (B < 1 || K < 16 || K % 16 != 0 || (NT != 128 && NT != 256 && NT != 512 && NT != 1024) ||
      N % NT != 0 || N / NT * kCluster > 65535 || tail < kNone || tail > kNorm ||
      bias == nullptr ||
      (tail == kNorm && (NT != N || res == nullptr || ln_g == nullptr || ln_b == nullptr)))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  if (dtype == 0)
    return launch<float>(st, x, ldx, w, scale, bias, res, ldr, ln_g, ln_b, out, ldo, B, K, N,
                         NT, tail, eps);
  if (dtype == 1)
    return launch<__nv_bfloat16>(st, x, ldx, w, scale, bias, res, ldr, ln_g, ln_b, out, ldo, B,
                                 K, N, NT, tail, eps);
  return (int)cudaErrorInvalidValue;
}
