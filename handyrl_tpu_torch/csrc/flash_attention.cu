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
// One block of 128 threads per (row * head, 64-query tile) walks the key tiles
// in order, carrying the running max, denominator and the 64 x D output
// accumulator in registers (fp32), so no score matrix reaches device memory.
// The TPU kernels carried those in VMEM scratch across the sequential key-tile
// grid axis; blocks here run in no order, so the loop over key tiles sits
// inside the block.  A causal block stops at its diagonal tile, a full block
// walks every tile; the ragged T edge is masked here.  D is a template
// parameter (16/32/64/96/128); the wrappers zero-pad other head dims up to the
// next one.  A probability whose key is invalid is set to 0 rather than left
// to exp(-1e30 - m): a row's running max is still -1e30 until it has seen a
// visible key, and exp(0) = 1 would then reach the denominator.  The masked
// semantics live in masked_visible / key_in_window, which both bodies call.
// Under ring eviction (window 32) most key tiles hold no key that any query of
// the tile can see: such a tile is found from the (key_mask, counts) rows
// alone, by one block-wide vote, and skipped before its K and V are read.
//
// Two bodies.  bf16 and fp16 (wgmma_kernel): Hopper's tensor cores.  S = Q.K^T
// is wgmma m64n64k16 with Q and K in shared memory; the online softmax runs on
// the fp32 accumulator fragments, each thread holding parts of two rows
// (reduced over its quad with two shuffles); P is rounded to the input type in
// registers, already in the A-fragment layout, and O += P.V is wgmma m64nDk16
// with V read from shared memory as an MN-major B operand.  The bf16 x bf16
// products are exact in fp32, as the TPU kernel's widen-then-dot is; only the
// order of the sums differs.  P is rounded to the input type before the
// product, as the JAX package's einsum reference rounds it, and the
// denominator sums those rounded p, so the weights of each output row sum to 1
// in the rounding that P.V sees.  Q, K and V come in by TMA on a 4-D
// (rows, T, H, D) tensor map: Q once per block, K and V through a 2-stage ring
// of shared-memory tiles with one mbarrier each, so the copy of the next live
// tile is in flight while the current one is computed.  Tiles are stored in
// panels of one swizzle span (64 columns with the 128-byte swizzle when 64
// divides D, 32 with the 64-byte one for D = 32 and 96, 16 with the 32-byte
// one for D = 16), each panel one TMA box, so D = 96 runs unpadded.  The grid
// puts the query tile on x and (row, head) on y: blocks that run together
// share one head's K/V in L2; causal and masked grids start the longest query
// tiles first.  fp32 (fma_kernel): the exact function cannot use TF32 and
// hold 1e-4, so fp32 stays on FMA from shared memory, scalar loads.
//
// What bounds them (H100 SXM, 3.35 TB/s, 989 TFLOP/s dense bf16).  Plain at
// (16, 1024, 16, 96) bf16 causal: q, k, v and out are 201 MB, 60 us; the causal
// half of the scores and products is 51.6 GFLOP, 52 us; the two limits sit
// close together.  Masked at (32, 512, 16, 96) bf16, window 32: the same
// 201 MB, and the visible pairs need ~3e9 FLOP, so bytes bound it.  On the
// tensor cores the kernels are held back by what each block does in series:
// one warpgroup waits for its own Q.K^T before the softmax and for P.V before
// the next tile (no ping-pong between warpgroups), and a key tile is fetched
// again by every query tile of its head (from L2, where the grid order keeps
// it).

#include <cuda.h>
#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>

#include <cstdint>
#include <type_traits>

namespace {

constexpr int BQ = 64;        // query rows per block: wgmma's M
constexpr int BK = 64;        // keys per tile
constexpr int THREADS = 128;  // one warpgroup
constexpr float NEG_INF = -1e30f;
constexpr float LOG2E = 1.4426950408889634f;
constexpr int HEAD_DIMS[] = {16, 32, 64, 96, 128};
static_assert(BQ == BK, "a query tile and a key tile share one TMA box and the diagonal test");

// Whether query qp sees key kk of the masked kernel, given the key's
// observed-step age from qp and its mask.
__device__ __forceinline__ bool masked_visible(int qp, int kk, int Tn, float age, float mk,
                                               float window) {
  return kk < Tn && ((mk > 0.f && qp >= kk && age >= 0.f && age < window) || qp == kk);
}

// Whether query qp sees key kk of the plain kernel.
__device__ __forceinline__ bool plain_visible(int qp, int kk, int Tn, bool causal) {
  return kk < Tn && (!causal || qp >= kk);
}

// The tile vote of the masked kernel: whether key kk may be visible to some
// query of a tile whose first query has count cq0.  Counts never decrease, so
// that query has the tile's smallest count, and a key with counts[k] <= cq0 -
// window is out of every query's window.
__device__ __forceinline__ bool key_in_window(int kk, int Tn, float mk, float ck, float cq0,
                                              float window) {
  return kk < Tn && mk > 0.f && ck > cq0 - window;
}

// ---------------------------------------------------------------------------
// fp32: FMA from shared memory

constexpr int fma_smem_floats(int D, bool masked) {
  // sQ, sK padded to D + 1 (conflict-free column walks), sV, sP padded; the
  // masked kernel adds the tile's key_mask and counts rows
  return BQ * (D + 1) + BK * (D + 1) + BK * D + BQ * (BK + 1) + (masked ? 2 * BK : 0);
}

// 128 threads as a 16 x 8 grid: ty owns 4 query rows, tx owns 8 keys and D/8
// output columns.  key_mask, counts and slopes are read only when MASKED, which
// is always causal.  At D = 96 and 128 shared memory holds two blocks per SM;
// saying so to ptxas (min 2 blocks, not the 4 it aims for) lifts its
// 128-register cap, under which the masked D = 96 instance spilled.
template <int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 2)
fma_kernel(const float* __restrict__ q, const float* __restrict__ k,
           const float* __restrict__ v, const float* __restrict__ key_mask,
           const float* __restrict__ counts, const float* __restrict__ slopes,
           float* __restrict__ out, int Tn, int H,
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
    sQ[r * DP + d] = t < Tn ? q[base + t * s_t + d] : 0.f;
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
        live = key_in_window(kk, Tn, mk, ck, cq0, window);
      }
      // a tile that overlaps the query rows holds q == k pairs, always visible
      const bool diagonal = k0 + BK > q0;
      if (!__syncthreads_or(live) && !diagonal) continue;
    }

    for (int idx = tid; idx < BK * D; idx += THREADS) {
      const int r = idx / D, d = idx - r * D, t = k0 + r;
      const bool in = t < Tn;
      sK[r * DP + d] = in ? k[base + t * s_t + d] : 0.f;
      sV[r * D + d] = in ? v[base + t * s_t + d] : 0.f;
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
          ok = masked_visible(qpos[i], kk, Tn, age, sMask[kl], window);
          s[i][j] = ok ? s[i][j] * scale - slope * age : NEG_INF;
        } else {
          ok = plain_visible(qpos[i], kk, Tn, causal);
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
    float* o = out + base + qpos[i] * s_t;
#pragma unroll
    for (int j = 0; j < DJ; ++j) o[tx + 8 * j] = acc[i][j] / den;
  }
}

// ---------------------------------------------------------------------------
// bf16 / fp16: wgmma and TMA

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}

__device__ __forceinline__ void mbar_init(uint64_t* bar) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], 1;\n" ::"r"(smem_u32(bar)) : "memory");
}

// the one arrival of a phase, and the bytes its TMA copies will bring
__device__ __forceinline__ void mbar_expect_tx(uint64_t* bar, int bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(smem_u32(bar)),
               "r"(bytes)
               : "memory");
}

// Waits for the phase after `parity` to complete.  A copy that never lands
// (a bad tensor map) traps after ~2^22 polls instead of hanging the card.
__device__ __forceinline__ void mbar_wait(uint64_t* bar, uint32_t parity) {
  for (int polls = 0;; ++polls) {
    uint32_t done;
    asm volatile(
        "{\n.reg .pred p;\n"
        "mbarrier.try_wait.parity.shared::cta.b64 p, [%1], %2;\n"
        "selp.u32 %0, 1, 0, p;\n}\n"
        : "=r"(done)
        : "r"(smem_u32(bar)), "r"(parity)
        : "memory");
    if (done) return;
    if (polls == (1 << 22)) __trap();
  }
}

// one box of a 4-D tensor map (coordinates innermost first) into shared memory
__device__ __forceinline__ void tma_load(void* dst, const CUtensorMap* map, uint64_t* bar, int c0,
                                         int c1, int c2, int c3) {
  asm volatile(
      "cp.async.bulk.tensor.4d.shared::cluster.global.mbarrier::complete_tx::bytes"
      " [%0], [%1, {%2, %3, %4, %5}], [%6];\n" ::"r"(smem_u32(dst)),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c0), "r"(c1), "r"(c2), "r"(c3), "r"(smem_u32(bar))
      : "memory");
}

__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_wait() {
  asm volatile("wgmma.wait_group.sync.aligned 0;\n" ::: "memory");
}

// Keeps the compiler from moving reads or writes of wgmma's register operands
// across the asynchronous product (wgmma_fence / wgmma_wait order the card).
template <int N>
__device__ __forceinline__ void fence_regs(float (&r)[N]) {
#pragma unroll
  for (int i = 0; i < N; ++i) asm volatile("" : "+f"(r[i])::"memory");
}
template <int N>
__device__ __forceinline__ void fence_regs(uint32_t (&r)[N][4]) {
#pragma unroll
  for (int i = 0; i < N; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) asm volatile("" : "+r"(r[i][j])::"memory");
}

// Columns of one shared-memory panel: one swizzle span of 16-bit values.
__host__ __device__ constexpr int panel_width(int D) {
  return D % 64 == 0 ? 64 : D % 32 == 0 ? 32 : 16;
}

// wgmma's layout code of a swizzle span: 128 B -> 1, 64 B -> 2, 32 B -> 3.
__host__ __device__ constexpr uint32_t layout_code(int span_bytes) {
  return span_bytes == 128 ? 1u : span_bytes == 64 ? 2u : 3u;
}

// A shared-memory matrix descriptor: start address, leading and stride byte
// offsets (16-byte units) and the swizzle layout.
__device__ __forceinline__ uint64_t smem_desc(const void* p, uint32_t lbo, uint32_t sbo,
                                              uint32_t layout) {
  return (uint64_t)((smem_u32(p) >> 4) & 0x3FFF) | (uint64_t)((lbo >> 4) & 0x3FFF) << 16 |
         (uint64_t)((sbo >> 4) & 0x3FFF) << 32 | (uint64_t)layout << 62;
}

// Two fp32 values rounded to T, packed as wgmma's A fragment holds them (the
// lower column in the low half), and the rounded values back in fp32.
__device__ __forceinline__ uint32_t pack_round(float a, float b, float& ra, float& rb,
                                               __nv_bfloat16) {
  __nv_bfloat162 x = __floats2bfloat162_rn(a, b);
  ra = __low2float(x);
  rb = __high2float(x);
  return *reinterpret_cast<uint32_t*>(&x);
}
__device__ __forceinline__ uint32_t pack_round(float a, float b, float& ra, float& rb, __half) {
  __half2 x = __floats2half2_rn(a, b);
  ra = __low2float(x);
  rb = __high2float(x);
  return *reinterpret_cast<uint32_t*>(&x);
}

__device__ __forceinline__ void store2(__nv_bfloat16* p, float a, float b) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(a, b);
}
__device__ __forceinline__ void store2(__half* p, float a, float b) {
  *reinterpret_cast<__half2*>(p) = __floats2half2_rn(a, b);
}

// The wgmma wrappers.  Each is one asm statement that names every accumulator
// register; TY is the operands' PTX type, bf16 or f16.  scale-d is a true
// predicate: the products add to the accumulators.

// S += Q.K^T over one k16 step: m64n64k16, Q and K from shared memory, both
// K-major (tnspA = tnspB = 0).
#define FLASH_MMA_QK(TY)                                                                           \
  asm volatile(                                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %34, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                                   \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                                     \
      "}, %32, %33, p, 1, 1, 0, 0;\n}\n"                                                           \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                                            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                                            \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                                          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                                        \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                                        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                                        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                                        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                                         \
      : "l"(da), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_qk(float (&d)[32], uint64_t da, uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    FLASH_MMA_QK("bf16");
  } else {
    FLASH_MMA_QK("f16");
  }
}

// O += P.V over one k16 step: m64nNk16 with N = D, P from registers (the A
// fragment), V from shared memory MN-major (tnspB = 1); one overload per head
// dim.
#define FLASH_MMA_PV16(TY)                                                                         \
  asm volatile(                                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %13, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n16k16.f32." TY "." TY " {"                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7"                                                             \
      "}, {%8, %9, %10, %11}, %12, p, 1, 1, 1;\n}\n"                                               \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                                            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7])                                             \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_pv(float (&d)[8], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    FLASH_MMA_PV16("bf16");
  } else {
    FLASH_MMA_PV16("f16");
  }
}

#define FLASH_MMA_PV32(TY)                                                                         \
  asm volatile(                                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n32k16.f32." TY "." TY " {"                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                                           \
      "%8, %9, %10, %11, %12, %13, %14, %15"                                                       \
      "}, {%16, %17, %18, %19}, %20, p, 1, 1, 1;\n}\n"                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                                            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                                            \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                                          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15])                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_pv(float (&d)[16], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    FLASH_MMA_PV32("bf16");
  } else {
    FLASH_MMA_PV32("f16");
  }
}

#define FLASH_MMA_PV64(TY)                                                                         \
  asm volatile(                                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %37, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n64k16.f32." TY "." TY " {"                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                                   \
      "%24, %25, %26, %27, %28, %29, %30, %31"                                                     \
      "}, {%32, %33, %34, %35}, %36, p, 1, 1, 1;\n}\n"                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                                            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                                            \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                                          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                                        \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                                        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                                        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                                        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31])                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_pv(float (&d)[32], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    FLASH_MMA_PV64("bf16");
  } else {
    FLASH_MMA_PV64("f16");
  }
}

#define FLASH_MMA_PV96(TY)                                                                         \
  asm volatile(                                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %53, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n96k16.f32." TY "." TY " {"                                 \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                                   \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                                   \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                                   \
      "%40, %41, %42, %43, %44, %45, %46, %47"                                                     \
      "}, {%48, %49, %50, %51}, %52, p, 1, 1, 1;\n}\n"                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                                            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                                            \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                                          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                                        \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                                        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                                        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                                        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                                        \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                                        \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                                        \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                                        \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47])                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_pv(float (&d)[48], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    FLASH_MMA_PV96("bf16");
  } else {
    FLASH_MMA_PV96("f16");
  }
}

#define FLASH_MMA_PV128(TY)                                                                        \
  asm volatile(                                                                                    \
      "{\n.reg .pred p;\nsetp.ne.b32 p, %69, 0;\n"                                                 \
      "wgmma.mma_async.sync.aligned.m64n128k16.f32." TY "." TY " {"                                \
      "%0, %1, %2, %3, %4, %5, %6, %7, "                                                           \
      "%8, %9, %10, %11, %12, %13, %14, %15, "                                                     \
      "%16, %17, %18, %19, %20, %21, %22, %23, "                                                   \
      "%24, %25, %26, %27, %28, %29, %30, %31, "                                                   \
      "%32, %33, %34, %35, %36, %37, %38, %39, "                                                   \
      "%40, %41, %42, %43, %44, %45, %46, %47, "                                                   \
      "%48, %49, %50, %51, %52, %53, %54, %55, "                                                   \
      "%56, %57, %58, %59, %60, %61, %62, %63"                                                     \
      "}, {%64, %65, %66, %67}, %68, p, 1, 1, 1;\n}\n"                                             \
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]),                                            \
        "+f"(d[4]), "+f"(d[5]), "+f"(d[6]), "+f"(d[7]),                                            \
        "+f"(d[8]), "+f"(d[9]), "+f"(d[10]), "+f"(d[11]),                                          \
        "+f"(d[12]), "+f"(d[13]), "+f"(d[14]), "+f"(d[15]),                                        \
        "+f"(d[16]), "+f"(d[17]), "+f"(d[18]), "+f"(d[19]),                                        \
        "+f"(d[20]), "+f"(d[21]), "+f"(d[22]), "+f"(d[23]),                                        \
        "+f"(d[24]), "+f"(d[25]), "+f"(d[26]), "+f"(d[27]),                                        \
        "+f"(d[28]), "+f"(d[29]), "+f"(d[30]), "+f"(d[31]),                                        \
        "+f"(d[32]), "+f"(d[33]), "+f"(d[34]), "+f"(d[35]),                                        \
        "+f"(d[36]), "+f"(d[37]), "+f"(d[38]), "+f"(d[39]),                                        \
        "+f"(d[40]), "+f"(d[41]), "+f"(d[42]), "+f"(d[43]),                                        \
        "+f"(d[44]), "+f"(d[45]), "+f"(d[46]), "+f"(d[47]),                                        \
        "+f"(d[48]), "+f"(d[49]), "+f"(d[50]), "+f"(d[51]),                                        \
        "+f"(d[52]), "+f"(d[53]), "+f"(d[54]), "+f"(d[55]),                                        \
        "+f"(d[56]), "+f"(d[57]), "+f"(d[58]), "+f"(d[59]),                                        \
        "+f"(d[60]), "+f"(d[61]), "+f"(d[62]), "+f"(d[63])                                         \
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(db), "r"(1))

template <typename T>
__device__ __forceinline__ void mma_pv(float (&d)[64], const uint32_t (&a)[4], uint64_t db) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    FLASH_MMA_PV128("bf16");
  } else {
    FLASH_MMA_PV128("f16");
  }
}

// Dynamic shared memory of the wgmma kernel: Q, two K stages and two V stages
// of 64 x D 16-bit values, the staged key_mask and counts rows (masked), three
// mbarriers, and slack to align the tiles to the 1024-byte swizzle pattern.
constexpr int wgmma_smem_bytes(int D, bool masked) {
  return 1024 + 5 * BQ * D * 2 + (masked ? 2 * 2 * BK * 4 : 0) + 3 * 8;
}

// The thread's fragment coordinates (wgmma's accumulator layout, which is also
// its A-fragment layout): warp w holds rows 16w..16w+15; a thread holds rows
// r0 = 16w + lane/4 and r0 + 8, and in each group of 8 columns the two at
// 2 * (lane % 4).  Accumulator element i sits in row r0 + 8 * ((i >> 1) & 1),
// column 8 * (i >> 2) + 2 * (lane % 4) + (i & 1).
template <typename T, int D, bool MASKED>
__global__ void __launch_bounds__(THREADS, 1)
wgmma_kernel(const __grid_constant__ CUtensorMap tq, const __grid_constant__ CUtensorMap tk,
             const __grid_constant__ CUtensorMap tv, const float* __restrict__ key_mask,
             const float* __restrict__ counts, const float* __restrict__ slopes,
             T* __restrict__ out, int Tn, int H, int BH, long long s_row, long long s_t,
             long long s_h, float window, float scale, bool causal) {
  constexpr int PW = panel_width(D);
  constexpr int SPAN = PW * 2;          // bytes of a panel row
  constexpr int PANEL = BK * SPAN;      // bytes of a 64-row panel
  constexpr int TILE = BQ * D * 2;      // bytes of a 64 x D tile
  constexpr uint32_t LAYOUT = layout_code(SPAN);
  constexpr int ND = D / 2;             // output accumulator floats per thread
  static_assert(D % 16 == 0 && PANEL % 1024 == 0, "panels must keep the swizzle's alignment");

  extern __shared__ uint8_t smem_raw[];
  uint8_t* sQ = smem_raw + ((1024u - (smem_u32(smem_raw) & 1023u)) & 1023u);
  uint8_t* sK = sQ + TILE;         // stage s at sK + s * TILE
  uint8_t* sV = sK + 2 * TILE;
  float* sMask = reinterpret_cast<float*>(sV + 2 * TILE);  // [2][BK], masked only
  float* sCnt = sMask + (MASKED ? 2 * BK : 0);
  uint64_t* bar = reinterpret_cast<uint64_t*>(sCnt + (MASKED ? 2 * BK : 0));  // K/V x2, Q

  const int bh = blockIdx.y + blockIdx.z * gridDim.y;
  if (bh >= BH) return;
  const int tid = threadIdx.x, lane = tid & 31;
  const int row = bh / H;
  const int h = bh - row * H;
  const int n_qt = (Tn + BQ - 1) / BQ;
  // causal and masked query tiles walk up to their diagonal: longest first
  const int q0 = ((MASKED || causal) ? n_qt - 1 - (int)blockIdx.x : (int)blockIdx.x) * BQ;
  const long long base = row * s_row + h * s_h;
  const int r0 = (tid >> 5) * 16 + (lane >> 2);
  const int qp[2] = {q0 + r0, q0 + r0 + 8};
  const int cbase = 2 * (lane & 3);

  const float* mask_row = nullptr;
  const float* cnt_row = nullptr;
  float slope2 = 0.f, cq0 = 0.f, cq[2] = {0.f, 0.f};
  if constexpr (MASKED) {
    mask_row = key_mask + (long long)row * Tn;
    cnt_row = counts + (long long)row * Tn;
    slope2 = slopes[h] * LOG2E;
    cq0 = cnt_row[q0];
    cq[0] = cnt_row[min(qp[0], Tn - 1)];
    cq[1] = cnt_row[min(qp[1], Tn - 1)];
  }
  const float scale2 = scale * LOG2E;  // scores in log2 units: exp2 of them is exp
  const int n_kt = ((MASKED || causal ? min(q0 + BQ, Tn) : Tn) - 1) / BK + 1;

  if (tid == 0) {
    mbar_init(&bar[0]);
    mbar_init(&bar[1]);
    mbar_init(&bar[2]);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // thread 0 issues every copy: a panel per TMA box, coordinates (d, h, t, row)
  auto load_tile = [&](uint8_t* dst, const CUtensorMap* map, uint64_t* b, int t0) {
#pragma unroll
    for (int p = 0; p < D / PW; ++p) tma_load(dst + p * PANEL, map, b, p * PW, h, t0, row);
  };
  auto load_kv = [&](int kt, int stage) {
    mbar_expect_tx(&bar[stage], 2 * TILE);
    load_tile(sK + stage * TILE, &tk, &bar[stage], kt * BK);
    load_tile(sV + stage * TILE, &tv, &bar[stage], kt * BK);
  };
  // The first key tile at or after kt that the block reads (n_kt if none).
  // Masked: the tile vote, with the tile's key_mask and counts rows staged
  // beside its K/V stage for the visibility test; a tile that overlaps the
  // query rows holds q == k pairs and is always read.
  auto next_tile = [&](int kt, int stage) {
    if constexpr (MASKED) {
      for (; kt < n_kt; ++kt) {
        const int k0 = kt * BK;
        bool live = false;
        if (tid < BK) {
          const int kk = k0 + tid;
          const float mk = kk < Tn ? mask_row[kk] : 0.f;
          const float ck = kk < Tn ? cnt_row[kk] : 0.f;
          sMask[stage * BK + tid] = mk;
          sCnt[stage * BK + tid] = ck;
          live = key_in_window(kk, Tn, mk, ck, cq0, window);
        }
        if (__syncthreads_or(live) || k0 + BK > q0) break;
      }
    }
    return kt;
  };

  if (tid == 0) {
    mbar_expect_tx(&bar[2], TILE);
    load_tile(sQ, &tq, &bar[2], q0);
  }
  int kt = next_tile(0, 0);
  if (tid == 0) load_kv(kt, 0);   // the diagonal tile is always read: kt < n_kt

  const uint64_t desc_q = smem_desc(sQ, 16, 8 * SPAN, LAYOUT);
  float o[ND], m[2] = {NEG_INF, NEG_INF}, l[2] = {0.f, 0.f};
#pragma unroll
  for (int i = 0; i < ND; ++i) o[i] = 0.f;
  uint32_t phase = 0;  // bit s: the parity stage s waits for next
  int stage = 0;
  mbar_wait(&bar[2], 0);

  while (kt < n_kt) {
    const int nxt = next_tile(kt + 1, stage ^ 1);
    if (tid == 0 && nxt < n_kt) load_kv(nxt, stage ^ 1);
    mbar_wait(&bar[stage], (phase >> stage) & 1u);
    phase ^= 1u << stage;

    // S = Q.K^T: one k16 step per 16 columns of D, each inside one panel
    float s[32];
#pragma unroll
    for (int i = 0; i < 32; ++i) s[i] = 0.f;
    const uint64_t desc_k = smem_desc(sK + stage * TILE, 16, 8 * SPAN, LAYOUT);
    fence_regs(s);
    wgmma_fence();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const uint32_t off = (kk * 16 / PW) * PANEL + (kk * 16 % PW) * 2;
      mma_qk<T>(s, desc_q + (off >> 4), desc_k + (off >> 4));
    }
    wgmma_commit();
    wgmma_wait();
    fence_regs(s);

    // scores, validity and the row max (a row's 64 columns live in one quad)
    const int k0 = kt * BK;
    unsigned valid = 0;
    float mx[2] = {NEG_INF, NEG_INF};
#pragma unroll
    for (int i = 0; i < 32; ++i) {
      const int hi = (i >> 1) & 1;
      const int kl = 8 * (i >> 2) + cbase + (i & 1);
      bool ok;
      float x;
      if constexpr (MASKED) {
        const float age = cq[hi] - sCnt[stage * BK + kl];
        ok = masked_visible(qp[hi], k0 + kl, Tn, age, sMask[stage * BK + kl], window);
        x = s[i] * scale2 - slope2 * age;
      } else {
        ok = plain_visible(qp[hi], k0 + kl, Tn, causal);
        x = s[i] * scale2;
      }
      s[i] = ok ? x : NEG_INF;
      valid |= (unsigned)ok << i;
      mx[hi] = fmaxf(mx[hi], s[i]);
    }
    float alpha[2];
#pragma unroll
    for (int hi = 0; hi < 2; ++hi) {
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 1));
      mx[hi] = fmaxf(mx[hi], __shfl_xor_sync(0xffffffffu, mx[hi], 2));
      const float m_new = fmaxf(m[hi], mx[hi]);
      alpha[hi] = exp2f(m[hi] - m_new);
      m[hi] = m_new;
      l[hi] *= alpha[hi];  // per-thread partial sums; the quad adds them at the end
    }

    // P in the A-fragment layout: k16 step c takes accumulator elements
    // 8c..8c+7, as registers (r0, 2 cols), (r0 + 8, 2), (r0, +8), (r0 + 8, +8).
    // Zeroed explicitly where invalid: exp2(NEG_INF - NEG_INF) = 1 must not
    // reach the sum.  l sums the rounded p that P.V multiplies.
    uint32_t a[4][4];
#pragma unroll
    for (int i = 0; i < 32; i += 2) {
      const int hi = (i >> 1) & 1;
      const float p0 = (valid >> i) & 1u ? exp2f(s[i] - m[hi]) : 0.f;
      const float p1 = (valid >> (i + 1)) & 1u ? exp2f(s[i + 1] - m[hi]) : 0.f;
      float r0v, r1v;
      a[i >> 3][(i >> 1) & 3] = pack_round(p0, p1, r0v, r1v, T());
      l[hi] += r0v + r1v;
    }
#pragma unroll
    for (int i = 0; i < ND; ++i) o[i] *= alpha[(i >> 1) & 1];

    // O += P.V: V is B, MN-major (D contiguous); LBO steps panels along D,
    // SBO steps 8 keys, and each k16 step starts 16 keys further on
    const uint64_t desc_v = smem_desc(sV + stage * TILE, PANEL, 8 * SPAN, LAYOUT);
    fence_regs(o);
    fence_regs(a);
    wgmma_fence();
#pragma unroll
    for (int c = 0; c < BK / 16; ++c) mma_pv<T>(o, a[c], desc_v + ((c * 16 * SPAN) >> 4));
    wgmma_commit();
    wgmma_wait();
    fence_regs(o);

    __syncthreads();  // every warp is done with this stage before it is loaded again
    kt = nxt;
    stage ^= 1;
  }

#pragma unroll
  for (int hi = 0; hi < 2; ++hi) {
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 1);
    l[hi] += __shfl_xor_sync(0xffffffffu, l[hi], 2);
    if (qp[hi] >= Tn) continue;
    const float den = fmaxf(l[hi], 1e-30f);
    T* o_row = out + base + qp[hi] * s_t + cbase;
#pragma unroll
    for (int j = 0; j < D / 8; ++j)
      store2(o_row + 8 * j, o[4 * j + 2 * hi] / den, o[4 * j + 2 * hi + 1] / den);
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

template <int D, bool MASKED>
cudaError_t launch_fma(const Args& a) {
  constexpr int bytes = fma_smem_floats(D, MASKED) * (int)sizeof(float);
  cudaError_t err = cudaFuncSetAttribute(fma_kernel<D, MASKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const dim3 grid(a.rows * a.H, (a.Tn + BQ - 1) / BQ);
  fma_kernel<D, MASKED><<<grid, THREADS, bytes, a.stream>>>(
      static_cast<const float*>(a.q), static_cast<const float*>(a.k),
      static_cast<const float*>(a.v), a.key_mask, a.counts, a.slopes, static_cast<float*>(a.out),
      a.Tn, a.H, a.s_row, a.s_t, a.s_h, a.window, a.scale, a.causal);
  return cudaGetLastError();
}

using EncodeTiled = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t, void*,
                                 const cuuint64_t*, const cuuint64_t*, const cuuint32_t*,
                                 const cuuint32_t*, CUtensorMapInterleave, CUtensorMapSwizzle,
                                 CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// cuTensorMapEncodeTiled from the driver the runtime already loaded, so the
// library links no libcuda.
EncodeTiled encode_tiled() {
  static const EncodeTiled fn = [] {
    void* p = nullptr;
    cudaDriverEntryPointQueryResult found;
#if CUDART_VERSION >= 12050
    const cudaError_t err = cudaGetDriverEntryPointByVersion("cuTensorMapEncodeTiled", &p, 12000,
                                                             cudaEnableDefault, &found);
#else
    const cudaError_t err =
        cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &p, cudaEnableDefault, &found);
#endif
    return err == cudaSuccess && found == cudaDriverEntryPointSuccess
               ? reinterpret_cast<EncodeTiled>(p) : nullptr;
  }();
  return fn;
}

// The 4-D (rows, T, H, D) view of a 16-bit operand, cut into boxes of one
// panel: PW columns by 64 steps of one (row, head).  Rows past T read as zeros.
bool encode_map(CUtensorMap* map, const void* ptr, bool bf16, int D, const Args& a) {
  const EncodeTiled encode = encode_tiled();
  if (encode == nullptr) return false;
  const int pw = panel_width(D);
  const cuuint64_t dims[4] = {(cuuint64_t)D, (cuuint64_t)a.H, (cuuint64_t)a.Tn,
                              (cuuint64_t)a.rows};
  const cuuint64_t strides[3] = {(cuuint64_t)a.s_h * 2, (cuuint64_t)a.s_t * 2,
                                 (cuuint64_t)a.s_row * 2};
  const cuuint32_t box[4] = {(cuuint32_t)pw, 1, BK, 1};
  const cuuint32_t unit[4] = {1, 1, 1, 1};
  const CUtensorMapSwizzle swizzle = pw == 64   ? CU_TENSOR_MAP_SWIZZLE_128B
                                     : pw == 32 ? CU_TENSOR_MAP_SWIZZLE_64B
                                                : CU_TENSOR_MAP_SWIZZLE_32B;
  return encode(map, bf16 ? CU_TENSOR_MAP_DATA_TYPE_BFLOAT16 : CU_TENSOR_MAP_DATA_TYPE_FLOAT16, 4,
                const_cast<void*>(ptr), dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                swizzle, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

template <typename T, int D, bool MASKED>
cudaError_t launch_wgmma(const Args& a) {
  // TMA reads from a 16-byte aligned base with strides of whole 16 bytes; a
  // view that starts elsewhere is refused, never read misaligned
  const uintptr_t addr = (uintptr_t)a.q | (uintptr_t)a.k | (uintptr_t)a.v;
  if (addr % 16 != 0) return cudaErrorMisalignedAddress;
  if ((a.s_row | a.s_t | a.s_h) % 8 != 0) return cudaErrorInvalidValue;
  constexpr bool bf16 = std::is_same<T, __nv_bfloat16>::value;
  CUtensorMap tq, tk, tv;
  if (!encode_map(&tq, a.q, bf16, D, a) || !encode_map(&tk, a.k, bf16, D, a) ||
      !encode_map(&tv, a.v, bf16, D, a))
    return cudaErrorInvalidValue;
  constexpr int bytes = wgmma_smem_bytes(D, MASKED);
  cudaError_t err = cudaFuncSetAttribute(wgmma_kernel<T, D, MASKED>,
                                         cudaFuncAttributeMaxDynamicSharedMemorySize, bytes);
  if (err != cudaSuccess) return err;
  const int bh = a.rows * a.H;
  const int gy = bh < 65535 ? bh : 65535;
  const dim3 grid((a.Tn + BQ - 1) / BQ, gy, (bh + gy - 1) / gy);
  wgmma_kernel<T, D, MASKED><<<grid, THREADS, bytes, a.stream>>>(
      tq, tk, tv, a.key_mask, a.counts, a.slopes, static_cast<T*>(a.out), a.Tn, a.H, bh, a.s_row,
      a.s_t, a.s_h, a.window, a.scale, a.causal);
  return cudaGetLastError();
}

template <int D, bool MASKED>
cudaError_t launch(int dtype, const Args& a) {
  switch (dtype) {
    case 0: return launch_fma<D, MASKED>(a);
    case 1: return launch_wgmma<__nv_bfloat16, D, MASKED>(a);
    case 2: return launch_wgmma<__half, D, MASKED>(a);
    default: return cudaErrorInvalidValue;
  }
}

template <bool MASKED>
int forward(int D, int dtype, const Args& a) {
  if (a.rows <= 0 || a.Tn <= 0 || a.H <= 0) return (int)cudaErrorInvalidValue;
  switch (D) {
    case 16: return (int)launch<16, MASKED>(dtype, a);
    case 32: return (int)launch<32, MASKED>(dtype, a);
    case 64: return (int)launch<64, MASKED>(dtype, a);
    case 96: return (int)launch<96, MASKED>(dtype, a);
    case 128: return (int)launch<128, MASKED>(dtype, a);
    default: return (int)cudaErrorInvalidValue;
  }
}

}  // namespace

// Dynamic shared memory a block of the head-dim-D kernel asks for, in bytes
// (ptxas -v reports static shared memory only); masked: 0 = plain kernel,
// otherwise the masked one; dtype as below (0: the FMA body, else wgmma).
// 0 for an unsupported D.
extern "C" int flash_smem_bytes(int D, int masked, int dtype) {
  for (int d : HEAD_DIMS)
    if (d == D)
      return dtype == 0 ? fma_smem_floats(D, masked != 0) * (int)sizeof(float)
                        : wgmma_smem_bytes(D, masked != 0);
  return 0;
}

// dtype: 0 = float32, 1 = bfloat16, 2 = float16.  q, k, v and out share the strides
// (s_row, s_t, s_h) in elements, with D contiguous; key_mask and counts are
// (rows, T) contiguous float32, slopes (H,) float32.  bf16 and fp16 need q, k
// and v 16-byte aligned and strides in multiples of 8 elements.  Returns the
// CUDA error code of the launch (0 on success).
extern "C" int masked_flash_forward(const void* q, const void* k, const void* v,
                                    const float* key_mask, const float* counts,
                                    const float* slopes, void* out, int rows, int Tn, int H,
                                    int D, long long s_row, long long s_t, long long s_h,
                                    float window, float scale, int dtype, void* stream) {
  return forward<true>(D, dtype, Args{q, k, v, key_mask, counts, slopes, out, rows, Tn, H, s_row,
                                      s_t, s_h, window, scale, true,
                                      static_cast<cudaStream_t>(stream)});
}

// dtype and alignment as above.  q, k, v and out share the strides (s_b, s_t,
// s_h) in elements, with D contiguous.  causal: 0 = full attention, otherwise
// causal.  Returns the CUDA error code of the launch (0 on success).
extern "C" int flash_forward(const void* q, const void* k, const void* v, void* out, int B, int Tn,
                             int H, int D, long long s_b, long long s_t, long long s_h, float scale,
                             int causal, int dtype, void* stream) {
  return forward<false>(D, dtype, Args{q, k, v, nullptr, nullptr, nullptr, out, B, Tn, H, s_b, s_t,
                                       s_h, 0.f, scale, causal != 0,
                                       static_cast<cudaStream_t>(stream)});
}
