// Masked flash attention forward for Hopper (sm_90a), with a plain C interface.
//
// Replaces handyrl_tpu/ops/flash_attention.py::_masked_flash_kernel (driven by
// _masked_flash_forward, exposed as masked_flash_attention): causal attention
// over (rows, T, H, D) with per-key observation masks, an ALiBi bias over
// observed-step ages, ring-window eviction and self always visible:
//
//   age[q, k] = counts[q] - counts[k]            (counts = cumsum(key_mask))
//   valid     = key_mask[k] > 0 && k <= q && 0 <= age < window,  or  q == k
//   score     = q.k / sqrt(D) - slope_h * age     (-1e30 where invalid)
//   out[q]    = sum_k p[q, k] v[k] / sum_k p[q, k],  p = exp(score - max) * valid
//
// Design.  One block of 128 threads per (row * head, 64-query tile) walks the
// key tiles up to the diagonal, carrying the running max, denominator and the
// 64 x D output accumulator in registers (fp32), so no score matrix reaches
// device memory.  The TPU kernel carried those in VMEM scratch across grid
// steps; blocks here run in no order, so the loop over key tiles sits inside
// the block.  Q, K, V are read through their strides in the (rows, T, H, D)
// layout: no fold to (B*H, T, D), no padding of D to 128 lanes or of T to a
// tile multiple; the ragged T edge is masked here.  Products are FMA in fp32
// from shared memory (bf16 inputs are widened on load), so fp32 inputs match
// the plain version to rounding.
//
// What bounds it.  At the training shape (32, 512, 16, 96) in bf16, q, k, v and
// out are 4 x 32*512*16*96 x 2 B = 201 MB, ~60 us at the H100 SXM's 3.35 TB/s;
// the causal half of the T^2 scores is ~2.6e10 FLOP, ~26 us at 989 TFLOP/s
// (~2.9e10 if whole 64-wide diagonal tiles are counted, ~3.2e10 with the TPU
// kernel's 128-wide ones), and with window 32 the valid pairs need only
// ~3e9.  So the work is bound by bytes.  Under ring eviction (window 32 observed steps) most key
// tiles hold no key that any query of the tile can see: such a tile is
// detected from the (key_mask, counts) rows alone, by one block-wide vote,
// and skipped before its K/V are read, so a query tile reads only the key
// tiles inside its window plus its diagonal tile.  A tile that is read is
// read again by every query tile that needs it (no reuse across blocks);
// wgmma and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // a 16 x 8 grid: ty owns 4 query rows, tx owns 8 keys / D/8 columns
constexpr float NEG_INF = -1e30f;

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }

template <int D>
constexpr int smem_floats() {
  // sQ, sK padded to D + 1 (conflict-free column walks), sV, sP padded, key rows
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + 2 * BK;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
masked_flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
                    const float* __restrict__ key_mask, const float* __restrict__ counts,
                    const float* __restrict__ slopes, T* __restrict__ out, int Tn, int H,
                    long long s_row, long long s_t, long long s_h, float window, float scale) {
  constexpr int DP = D + 1;
  constexpr int PP = BK + 1;
  constexpr int DJ = D / 8;
  extern __shared__ float smem[];
  float* sQ = smem;
  float* sK = sQ + BQ * DP;
  float* sV = sK + BK * DP;
  float* sP = sV + BK * D;
  float* sMask = sP + BQ * PP;
  float* sCnt = sMask + BK;

  const int tid = threadIdx.x;
  const int ty = tid >> 3;
  const int tx = tid & 7;
  const int bh = blockIdx.x;
  const int row = bh / H;
  const int h = bh - row * H;
  const int q0 = blockIdx.y * BQ;
  const long long base = row * s_row + h * s_h;
  const float* mask_row = key_mask + (long long)row * Tn;
  const float* cnt_row = counts + (long long)row * Tn;
  const float slope = slopes[h];

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D, t = q0 + r;
    sQ[r * DP + d] = t < Tn ? to_float(q[base + t * s_t + d]) : 0.f;
  }

  int qpos[4];
  float cq[4], m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q0 + ty * 4 + i;
    cq[i] = cnt_row[min(qpos[i], Tn - 1)];
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  // counts never decrease, so the tile's first query has the smallest count:
  // a key with counts[k] <= cq0 - window is out of every query's window
  const float cq0 = cnt_row[q0];
  const int n_kt = (min(q0 + BQ, Tn) - 1) / BK + 1;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    bool live = false;
    if (tid < BK) {
      const int kk = k0 + tid;
      const float mk = kk < Tn ? mask_row[kk] : 0.f;
      const float ck = kk < Tn ? cnt_row[kk] : 0.f;
      sMask[tid] = mk;
      sCnt[tid] = ck;
      live = kk < Tn && mk > 0.f && ck > cq0 - window;
    }
    // a tile that overlaps the query rows holds q == k pairs, always visible
    const bool diagonal = k0 + BK > q0;
    if (!__syncthreads_or(live) && !diagonal) continue;

    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D, t = k0 + r;
      const bool in = t < Tn;
      sK[r * DP + d] = in ? to_float(k[base + t * s_t + d]) : 0.f;
      sV[r * D + d] = in ? to_float(v[base + t * s_t + d]) : 0.f;
    }
    __syncthreads();

    float s[4][8];
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < 8; ++j) s[i][j] = 0.f;
#pragma unroll 4
    for (int d = 0; d < D; ++d) {
      float qv[4], kv[8];
#pragma unroll
      for (int i = 0; i < 4; ++i) qv[i] = sQ[(ty * 4 + i) * DP + d];
#pragma unroll
      for (int j = 0; j < 8; ++j) kv[j] = sK[(tx + 8 * j) * DP + d];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 8; ++j) s[i][j] = fmaf(qv[i], kv[j], s[i][j]);
    }

#pragma unroll
    for (int i = 0; i < 4; ++i) {
      unsigned valid = 0;
      float mb = NEG_INF;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        const int kl = tx + 8 * j, kk = k0 + kl;
        const float age = cq[i] - sCnt[kl];
        const bool ok = kk < Tn && ((sMask[kl] > 0.f && qpos[i] >= kk && age >= 0.f && age < window) ||
                                    qpos[i] == kk);
        s[i][j] = ok ? s[i][j] * scale - slope * age : NEG_INF;
        valid |= (unsigned)ok << j;
        mb = fmaxf(mb, s[i][j]);
      }
      // the 8 threads of a query row are 8 neighbouring lanes
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 1));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 2));
      mb = fmaxf(mb, __shfl_xor_sync(0xffffffffu, mb, 4));
      const float m_new = fmaxf(m[i], mb);
      const float alpha = expf(m[i] - m_new);
      float ps = 0.f;
#pragma unroll
      for (int j = 0; j < 8; ++j) {
        // zeroed explicitly: exp(NEG_INF - NEG_INF) = 1 must not reach the sum
        const float p = (valid >> j) & 1u ? expf(s[i][j] - m_new) : 0.f;
        sP[(ty * 4 + i) * PP + tx + 8 * j] = p;
        ps += p;
      }
      ps += __shfl_xor_sync(0xffffffffu, ps, 1);
      ps += __shfl_xor_sync(0xffffffffu, ps, 2);
      ps += __shfl_xor_sync(0xffffffffu, ps, 4);
      l[i] = l[i] * alpha + ps;
      m[i] = m_new;
#pragma unroll
      for (int j = 0; j < DJ; ++j) acc[i][j] *= alpha;
    }
    __syncthreads();

#pragma unroll 4
    for (int kl = 0; kl < BK; ++kl) {
      float pv[4];
#pragma unroll
      for (int i = 0; i < 4; ++i) pv[i] = sP[(ty * 4 + i) * PP + kl];
#pragma unroll
      for (int j = 0; j < DJ; ++j) {
        const float vv = sV[kl * D + tx + 8 * j];
#pragma unroll
        for (int i = 0; i < 4; ++i) acc[i][j] = fmaf(pv[i], vv, acc[i][j]);
      }
    }
    __syncthreads();
  }

#pragma unroll
  for (int i = 0; i < 4; ++i) {
    if (qpos[i] >= Tn) continue;
    const float den = fmaxf(l[i], 1e-30f);
    T* o = out + base + qpos[i] * s_t;
#pragma unroll
    for (int j = 0; j < DJ; ++j) store(o + tx + 8 * j, acc[i][j] / den);
  }
}

template <typename T, int D>
cudaError_t launch(const void* q, const void* k, const void* v, const float* key_mask,
                   const float* counts, const float* slopes, void* out, int rows, int Tn, int H,
                   long long s_row, long long s_t, long long s_h, float window, float scale,
                   cudaStream_t stream) {
  constexpr int bytes = smem_floats<D>() * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(masked_flash_kernel<T, D>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(rows * H, (Tn + BQ - 1) / BQ);
  masked_flash_kernel<T, D><<<grid, THREADS, bytes, stream>>>(
      static_cast<const T*>(q), static_cast<const T*>(k), static_cast<const T*>(v), key_mask,
      counts, slopes, static_cast<T*>(out), Tn, H, s_row, s_t, s_h, window, scale);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(int D, const void* q, const void* k, const void* v, const float* key_mask,
                     const float* counts, const float* slopes, void* out, int rows, int Tn, int H,
                     long long s_row, long long s_t, long long s_h, float window, float scale,
                     cudaStream_t stream) {
#define HANDYRL_CASE(DD)                                                                       \
  case DD:                                                                                     \
    return launch<T, DD>(q, k, v, key_mask, counts, slopes, out, rows, Tn, H, s_row, s_t, s_h, \
                         window, scale, stream);
  switch (D) {
    HANDYRL_CASE(16)
    HANDYRL_CASE(32)
    HANDYRL_CASE(64)
    HANDYRL_CASE(96)
    HANDYRL_CASE(128)
    default:
      return cudaErrorInvalidValue;
  }
#undef HANDYRL_CASE
}

}  // namespace

// Dynamic shared memory a block of the head-dim-D kernel asks for, in bytes
// (ptxas -v reports static shared memory only); 0 for an unsupported D.
extern "C" int masked_flash_smem_bytes(int D) {
  switch (D) {
    case 16: return smem_floats<16>() * (int)sizeof(float);
    case 32: return smem_floats<32>() * (int)sizeof(float);
    case 64: return smem_floats<64>() * (int)sizeof(float);
    case 96: return smem_floats<96>() * (int)sizeof(float);
    case 128: return smem_floats<128>() * (int)sizeof(float);
    default: return 0;
  }
}

// dtype: 0 = float32, 1 = bfloat16.  q, k, v and out share the strides
// (s_row, s_t, s_h) in elements, with D contiguous; key_mask and counts are
// (rows, T) contiguous float32, slopes (H,) float32.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int masked_flash_forward(const void* q, const void* k, const void* v,
                                    const float* key_mask, const float* counts,
                                    const float* slopes, void* out, int rows, int Tn, int H,
                                    int D, long long s_row, long long s_t, long long s_h,
                                    float window, float scale, int dtype, void* stream) {
  if (rows <= 0 || Tn <= 0 || H <= 0) return (int)cudaErrorInvalidValue;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  cudaError_t err =
      dtype == 1
          ? dispatch<__nv_bfloat16>(D, q, k, v, key_mask, counts, slopes, out, rows, Tn, H, s_row,
                                    s_t, s_h, window, scale, st)
          : dispatch<float>(D, q, k, v, key_mask, counts, slopes, out, rows, Tn, H, s_row, s_t,
                            s_h, window, scale, st);
  return (int)err;
}
