// Flash partials of decode attention over the int8 slot KV cache, for
// Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel genie_tts_tpu/ops/int8_decode.py::
// int8_big_attention (kernel _kernel). For each (slot b, head h):
//
//   visible(s) = s < x_len+p_len                      (compacted context)
//              | (rpos >= 0 & floor_mod(head-1-rpos, ring) < keys_written)
//                with rpos = s - (sx+sp)               (the decode ring)
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
// What bounds it on the H100: the bytes of the visible columns (codes and
// scales, ~60 KB per (b, h) at S = 896, Dh = 32) over 3.35 TB/s; the
// arithmetic (2 * Dh FMAs per column) is far below the fp32 rate. Design:
// one block per (b, h) (128 blocks at the 8-slot serving geometry); 4
// groups of 64 threads split the Dh rows, and each thread takes 16
// neighbouring columns with one 16-byte load per d row, so a warp reads
// 512 contiguous bytes of a row. A 16-column chunk with no visible column
// is never loaded (mid-decode at the serving geometry about half the
// columns are invisible: the padded context tail and the unwritten ring).
// Scores live in shared memory (4 x S floats), so K and V codes are each
// read once and only the partials are written.
#include "common.cuh"

namespace {

constexpr int kThreads = 256;
constexpr int kGroups = 4;                          // d-row groups
constexpr int kChunkThreads = kThreads / kGroups;   // column chunks in flight
constexpr int kCols = 16;                           // columns per 16-byte load
constexpr int kMaxS = 2048;
constexpr int kWarps = kThreads / 32;

struct Visibility {
  int ctx, sxsp, ring, head, kw, S;
  __device__ __forceinline__ bool operator()(int s) const {
    if (s >= S) return false;
    if (s < ctx) return true;
    const int rpos = s - sxsp;
    if (rpos < 0) return false;
    // floor_mod: C's % truncates toward zero, and head-1-rpos is negative
    // for ring columns after the head
    const int age = ((head - 1 - rpos) % ring + ring) % ring;
    return age < kw;
  }
};

// 16 int8 codes of one row starting at column s0, as fp32. kVec: one
// 16-byte load (row pitch and base 16-byte aligned; columns past S lie
// inside the row pitch and are masked by the caller); else byte loads,
// zero past S.
template <bool kVec>
__device__ __forceinline__ void load16(const int8_t* p, int left, float* out) {
  if constexpr (kVec) {
    const uint4 u = __ldg(reinterpret_cast<const uint4*>(p));
    genie::Pack16<int8_t>::unpack(u, out);
  } else {
#pragma unroll
    for (int j = 0; j < kCols; ++j) out[j] = j < left ? static_cast<float>(p[j]) : 0.f;
  }
}

template <typename TQ, int kDh, bool kVec>
__global__ void __launch_bounds__(kThreads)
int8_attn_kernel(const TQ* __restrict__ q, const int8_t* __restrict__ kq,
                 const float* __restrict__ ks, const int8_t* __restrict__ vq,
                 const float* __restrict__ vs, const int* __restrict__ x_len,
                 const int* __restrict__ p_len, const int* __restrict__ keys_written,
                 float* __restrict__ o, float* __restrict__ m_out,
                 float* __restrict__ l_out, int H, int S, long long ld,
                 long long lds, int head, int sxsp, int ring, float scale) {
  constexpr int kDg = kDh / kGroups;                // d rows per group
  __shared__ float part[kGroups][kMaxS];            // partial scores; then p*vs
  __shared__ float qs[kDh];
  __shared__ float opart[kWarps][kDg];
  __shared__ float red[32];

  const int bh = blockIdx.x;
  const int b = bh / H;
  const int tid = threadIdx.x;
  const int g = tid / kChunkThreads, c_first = tid % kChunkThreads;
  const int8_t* kp = kq + (size_t)bh * kDh * ld;
  const int8_t* vp = vq + (size_t)bh * kDh * ld;
  const float* ksp = ks + (size_t)bh * lds;
  const float* vsp = vs + (size_t)bh * lds;
  const Visibility vis{x_len[b] + p_len[b], sxsp, ring, head, keys_written[b], S};
  const int nchunk = (S + kCols - 1) / kCols;
  const int spad = nchunk * kCols;

  for (int d = tid; d < kDh; d += kThreads) qs[d] = genie::to_f(q[(size_t)bh * kDh + d]);
  __syncthreads();

  // partial scores: thread (g, c) sums its group's d rows for 16 columns
  for (int c = c_first; c < nchunk; c += kChunkThreads) {
    const int s0 = c * kCols;
    bool any = false;
#pragma unroll
    for (int j = 0; j < kCols; ++j) any |= vis(s0 + j);
    float acc[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) acc[j] = 0.f;
    if (any) {
#pragma unroll
      for (int i = 0; i < kDg; ++i) {
        const int d = g * kDg + i;
        float code[kCols];
        load16<kVec>(kp + (size_t)d * ld + s0, S - s0, code);
        const float qd = qs[d];
#pragma unroll
        for (int j = 0; j < kCols; ++j) acc[j] += qd * code[j];
      }
    }
#pragma unroll
    for (int j = 0; j < kCols; ++j) part[g][s0 + j] = acc[j];
  }
  __syncthreads();

  // masked scores (per-column dequant folded in) and their max
  float lmax = -INFINITY;
  for (int s = tid; s < spad; s += kThreads) {
    float x = -1e30f;
    if (vis(s)) {
      const float t = (part[0][s] + part[1][s]) + (part[2][s] + part[3][s]);
      x = t * (ksp[s] * scale);
    }
    part[0][s] = x;
    lmax = fmaxf(lmax, x);
  }
  const float m = genie::block_max(lmax, red);

  // exp and sum; the V dequant scale folds into the probabilities
  float lsum = 0.f;
  for (int s = tid; s < spad; s += kThreads) {
    float pv = 0.f;
    if (vis(s)) {
      const float p = expf(part[0][s] - m);
      lsum += p;
      pv = p * vsp[s];
    }
    part[0][s] = pv;
  }
  const float l = genie::block_sum(lsum, red);   // its barriers publish part[0]

  // o: thread (g, c) takes its group's d rows over its 16 columns
  float acc[kDg];
#pragma unroll
  for (int i = 0; i < kDg; ++i) acc[i] = 0.f;
  for (int c = c_first; c < nchunk; c += kChunkThreads) {
    const int s0 = c * kCols;
    bool any = false;
#pragma unroll
    for (int j = 0; j < kCols; ++j) any |= vis(s0 + j);
    if (!any) continue;
    float pv[kCols];
#pragma unroll
    for (int j = 0; j < kCols; ++j) pv[j] = part[0][s0 + j];
#pragma unroll
    for (int i = 0; i < kDg; ++i) {
      float code[kCols];
      load16<kVec>(vp + (size_t)(g * kDg + i) * ld + s0, S - s0, code);
      float t = 0.f;
#pragma unroll
      for (int j = 0; j < kCols; ++j) t += pv[j] * code[j];
      acc[i] += t;
    }
  }
  // reduce over the 64 threads (2 warps) of each group
  const int lane = tid & 31, warp = tid >> 5;
#pragma unroll
  for (int i = 0; i < kDg; ++i) {
    const float v = genie::warp_sum(acc[i]);
    if (lane == 0) opart[warp][i] = v;
  }
  __syncthreads();
  if (tid < kDh) {
    const int gd = tid / kDg, i = tid % kDg;
    o[(size_t)bh * kDh + tid] = opart[2 * gd][i] + opart[2 * gd + 1][i];
  }
  if (tid == 0) {
    m_out[bh] = m;
    l_out[bh] = l;
  }
}

template <typename TQ, int kDh>
void launch(bool vec, dim3 grid, cudaStream_t st, const void* q, const void* kq,
            const void* ks, const void* vq, const void* vs, const void* x_len,
            const void* p_len, const void* kw, void* o, void* m, void* l, int H,
            int S, long long ld, long long lds, int head, int sxsp, int ring,
            float scale) {
  if (vec) {
    int8_attn_kernel<TQ, kDh, true><<<grid, kThreads, 0, st>>>(
        (const TQ*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
        (const float*)vs, (const int*)x_len, (const int*)p_len, (const int*)kw,
        (float*)o, (float*)m, (float*)l, H, S, ld, lds, head, sxsp, ring, scale);
  } else {
    int8_attn_kernel<TQ, kDh, false><<<grid, kThreads, 0, st>>>(
        (const TQ*)q, (const int8_t*)kq, (const float*)ks, (const int8_t*)vq,
        (const float*)vs, (const int*)x_len, (const int*)p_len, (const int*)kw,
        (float*)o, (float*)m, (float*)l, H, S, ld, lds, head, sxsp, ring, scale);
  }
}

}  // namespace

// qdtype: 0 = float32, 1 = bfloat16. kq/vq rows have a pitch of ld bytes,
// ks/vs rows a pitch of lds floats. vec: kq/vq are 16-byte aligned with a
// pitch that is a multiple of 16 (the wrapper checks).
extern "C" int int8_big_attention(const void* q, const void* kq, const void* ks,
                                  const void* vq, const void* vs, const void* x_len,
                                  const void* p_len, const void* keys_written,
                                  void* o, void* m, void* l, int B, int H, int Dh,
                                  int S, long long ld, long long lds, int head,
                                  int sxsp, int ring, float scale, int qdtype,
                                  int vec, void* stream) {
  if (S < 1 || S > kMaxS || ld < S || lds < S || ring < 1 || B * H < 1 ||
      (Dh != 32 && Dh != 64))
    return (int)cudaErrorInvalidValue;
  cudaStream_t st = reinterpret_cast<cudaStream_t>(stream);
  const dim3 grid(B * H);
  const bool v = vec != 0;
#define GENIE_LAUNCH(TQ, DH)                                                        \
  launch<TQ, DH>(v, grid, st, q, kq, ks, vq, vs, x_len, p_len, keys_written, o, m, \
                 l, H, S, ld, lds, head, sxsp, ring, scale)
  if (qdtype == 0 && Dh == 32) GENIE_LAUNCH(float, 32);
  else if (qdtype == 0 && Dh == 64) GENIE_LAUNCH(float, 64);
  else if (qdtype == 1 && Dh == 32) GENIE_LAUNCH(__nv_bfloat16, 32);
  else if (qdtype == 1 && Dh == 64) GENIE_LAUNCH(__nv_bfloat16, 64);
  else return (int)cudaErrorInvalidValue;
#undef GENIE_LAUNCH
  return (int)cudaGetLastError();
}
