// Flash attention forwards for Hopper (sm_90a), with a plain C interface: the
// masked kernel and the plain one, one template with a compile-time flag.
//
// masked_flash_forward replaces handyrl_tpu/ops/flash_attention.py::
// _masked_flash_kernel (driven by _masked_flash_forward, exposed as
// masked_flash_attention): causal attention over (rows, T, H, D) with per-key
// observation masks, an ALiBi bias over observed-step ages, ring-window
// eviction and self always visible:
//
//   age[q, k] = counts[q] - counts[k]            (counts = cumsum(key_mask))
//   valid     = key_mask[k] > 0 && k <= q && 0 <= age < window,  or  q == k
//   score     = q.k / sqrt(D) - slope_h * age     (-1e30 where invalid)
//
// flash_forward replaces handyrl_tpu/ops/flash_attention.py::_flash_kernel
// (driven by _flash_forward, exposed as flash_attention): plain causal or full
// attention over (B, T, H, D), no masks and no bias:
//
//   valid     = k <= q if causal, every k < T otherwise
//   score     = q.k / sqrt(D)                     (-1e30 where invalid)
//
// Both:  out[q] = sum_k p[q, k] v[k] / max(sum_k p[q, k], 1e-30),
//        p = exp(score - max) * valid.
//
// Design.  One block of 128 threads per (row * head, 64-query tile) walks the
// key tiles in order from tile 0, carrying the running max, denominator and
// the 64 x D output accumulator in registers (fp32), so no score matrix
// reaches device memory.  The TPU kernels carried those in VMEM scratch across
// the sequential key-tile grid axis; blocks here run in no order, so the loop
// over key tiles sits inside the block.  A causal block stops at its diagonal
// tile, a full block walks every tile.  Q, K, V are read through their strides
// in the (rows, T, H, D) layout: no fold to (B*H, T, D), no padding of D to 128
// lanes or of T to a tile multiple; the ragged T edge is masked here.  D is a
// template parameter (16/32/64/96/128); the wrappers zero-pad other head dims
// up to the next one.  Products are FMA in fp32 from shared memory (bf16 and
// fp16 inputs are widened on load, as the TPU kernels widen them), so fp32
// inputs match the plain versions to rounding.  A probability whose key is
// invalid is set to 0 rather than left to exp(-1e30 - m): a row's running max
// is still -1e30 until it has seen a visible key, and exp(0) = 1 would then
// reach the denominator.  The plain instance reads no mask, count or slope.
//
// What bounds them.  Masked, at the training shape (32, 512, 16, 96) in bf16:
// q, k, v and out are 4 x 32*512*16*96 x 2 B = 201 MB, ~60 us at the H100
// SXM's 3.35 TB/s; the causal half of the T^2 scores is ~2.6e10 FLOP, ~26 us at
// 989 TFLOP/s, and with window 32 the valid pairs need only ~3e9.  So the work
// is bound by bytes.  Under ring eviction most key tiles hold no key that any
// query of the tile can see: such a tile is detected from the (key_mask,
// counts) rows alone, by one block-wide vote, and skipped before its K/V are
// read, so a query tile reads only the key tiles inside its window plus its
// diagonal tile.  Plain, at (16, 1024, 16, 96) in bf16: 201 MB, ~60 us; the
// causal half of the scores and products is 4*B*H*D*T(T+1)/2 = 51.6 GFLOP,
// ~52 us on the tensor cores, so both limits sit close together; with no
// window to skip tiles by, the products run on the fp32 FMA pipes (67
// TFLOP/s), so this kernel is bound by operations at ~0.8 ms there.  A tile
// that is read is read again by every query tile that needs it (no reuse
// across blocks); mma/wgmma and TMA are left for later work.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

namespace {

constexpr int BQ = 64;        // query rows per block
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // a 16 x 8 grid: ty owns 4 query rows, tx owns 8 keys / D/8 columns
constexpr float NEG_INF = -1e30f;
constexpr int HEAD_DIMS[] = {16, 32, 64, 96, 128};

__device__ __forceinline__ float to_float(float x) { return x; }
__device__ __forceinline__ float to_float(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_float(__half x) { return __half2float(x); }
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) { *p = __float2bfloat16(x); }
__device__ __forceinline__ void store(__half* p, float x) { *p = __float2half(x); }

constexpr int smem_floats(int D, bool masked) {
  // sQ, sK padded to D + 1 (conflict-free column walks), sV, sP padded; the
  // masked kernel adds the tile's key_mask and counts rows
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + (masked ? 2 * BK : 0);
}

// key_mask, counts and slopes are read only when MASKED, which is always causal.
// At D = 96 and 128 shared memory holds two blocks per SM; saying so to ptxas
// (min 2 blocks, not the 4 it aims for) lifts its 128-register cap, under
// which the masked D = 96 instance spilled.
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 2)
flash_kernel(const T* __restrict__ q, const T* __restrict__ k, const T* __restrict__ v,
             const float* __restrict__ key_mask, const float* __restrict__ counts,
             const float* __restrict__ slopes, T* __restrict__ out, int Tn, int H,
             long long s_row, long long s_t, long long s_h, float window, float scale,
             bool causal) {
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
  const float* mask_row = nullptr;
  const float* cnt_row = nullptr;
  float slope = 0.f;
  if constexpr (MASKED) {
    mask_row = key_mask + (long long)row * Tn;
    cnt_row = counts + (long long)row * Tn;
    slope = slopes[h];
  }

  for (int idx = tid; idx < BQ * D; idx += THREADS) {
    const int r = idx / D, d = idx - r * D, t = q0 + r;
    sQ[r * DP + d] = t < Tn ? to_float(q[base + t * s_t + d]) : 0.f;
  }

  int qpos[4];
  float cq[4], m[4], l[4], acc[4][DJ];
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    qpos[i] = q0 + ty * 4 + i;
    if constexpr (MASKED) cq[i] = cnt_row[min(qpos[i], Tn - 1)];
    m[i] = NEG_INF;
    l[i] = 0.f;
#pragma unroll
    for (int j = 0; j < DJ; ++j) acc[i][j] = 0.f;
  }
  // counts never decrease, so the tile's first query has the smallest count:
  // a key with counts[k] <= cq0 - window is out of every query's window
  float cq0 = 0.f;
  if constexpr (MASKED) cq0 = cnt_row[q0];
  // causal: key tiles past the query tile's last row hold no visible key
  const int n_kt = ((MASKED || causal ? min(q0 + BQ, Tn) : Tn) - 1) / BK + 1;

  for (int kt = 0; kt < n_kt; ++kt) {
    const int k0 = kt * BK;
    if constexpr (MASKED) {
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
    }

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
        bool ok;
        if constexpr (MASKED) {
          const float age = cq[i] - sCnt[kl];
          ok = kk < Tn && ((sMask[kl] > 0.f && qpos[i] >= kk && age >= 0.f && age < window) ||
                           qpos[i] == kk);
          s[i][j] = ok ? s[i][j] * scale - slope * age : NEG_INF;
        } else {
          ok = kk < Tn && (!causal || qpos[i] >= kk);
          s[i][j] = ok ? s[i][j] * scale : NEG_INF;
        }
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

// one launch's arguments; the mask pointers are null for the plain kernel
struct Args {
  const void *q, *k, *v;
  const float *key_mask, *counts, *slopes;
  void* out;
  int rows, Tn, H;
  long long s_row, s_t, s_h;
  float window, scale;
  bool causal;
  cudaStream_t stream;
};

template <typename T, int D, bool MASKED>
cudaError_t launch(const Args& a) {
  constexpr int bytes = smem_floats(D, MASKED) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(flash_kernel<T, D, MASKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.rows * a.H, (a.Tn + BQ - 1) / BQ);
  flash_kernel<T, D, MASKED><<<grid, THREADS, bytes, a.stream>>>(
      static_cast<const T*>(a.q), static_cast<const T*>(a.k), static_cast<const T*>(a.v),
      a.key_mask, a.counts, a.slopes, static_cast<T*>(a.out), a.Tn, a.H, a.s_row, a.s_t, a.s_h,
      a.window, a.scale, a.causal);
  return cudaGetLastError();
}

template <typename T, bool MASKED>
cudaError_t dispatch_head_dim(int D, const Args& a) {
  switch (D) {
    case 16: return launch<T, 16, MASKED>(a);
    case 32: return launch<T, 32, MASKED>(a);
    case 64: return launch<T, 64, MASKED>(a);
    case 96: return launch<T, 96, MASKED>(a);
    case 128: return launch<T, 128, MASKED>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool MASKED>
int forward(int D, int dtype, const Args& a) {
  if (a.rows <= 0 || a.Tn <= 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  switch (dtype) {
    case 0: return (int)dispatch_head_dim<float, MASKED>(D, a);
    case 1: return (int)dispatch_head_dim<__nv_bfloat16, MASKED>(D, a);
    case 2: return (int)dispatch_head_dim<__half, MASKED>(D, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory a block of the head-dim-D kernel asks for, in bytes
// (ptxas -v reports static shared memory only); masked: 0 = plain kernel,
// otherwise the masked one.  0 for an unsupported D.
extern "C" int flash_smem_bytes(int D, int masked) {
  for (int d : HEAD_DIMS)
    if (d == D) return smem_floats(D, masked != 0) * (int)sizeof(float);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q, k, v and out share the strides
// (s_row, s_t, s_h) in elements, with D contiguous; key_mask and counts are
// (rows, T) contiguous float32, slopes (H,) float32.  Returns the CUDA error
// code of the launch (0 on success).
extern "C" int masked_flash_forward(const void* q, const void* k, const void* v,
                                    const float* key_mask, const float* counts,
                                    const float* slopes, void* out, int rows, int Tn, int H,
                                    int D, long long s_row, long long s_t, long long s_h,
                                    float window, float scale, int dtype, void* stream) {
  return forward<true>(D, dtype, Args{q, k, v, key_mask, counts, slopes, out, rows, Tn, H, s_row,
                                      s_t, s_h, window, scale, true,
                                      static_cast<cudaStream_t>(stream)});
}

// dtype as above.  q, k, v and out share the strides (s_b, s_t, s_h) in
// elements, with D contiguous.  causal: 0 = full attention, otherwise causal.
// Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_forward(const void* q, const void* k, const void* v, void* out, int B, int Tn,
                             int H, int D, long long s_b, long long s_t, long long s_h, float scale,
                             int causal, int dtype, void* stream) {
  return forward<false>(D, dtype, Args{q, k, v, nullptr, nullptr, nullptr, out, B, Tn, H, s_b, s_t,
                                       s_h, 0.f, scale, causal != 0,
                                       static_cast<cudaStream_t>(stream)});
}
