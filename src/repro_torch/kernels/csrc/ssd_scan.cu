// Mamba-2 SSD chunked scan for Hopper (sm_90a), CUDA C++ behind a plain C
// interface.  Built by nvcc into a shared library and loaded with ctypes by
// repro_torch/kernels/build.py; the Python wrapper is
// repro_torch/kernels/ssd_scan.py::ssd_chunked.
//
// Replaces the Pallas TPU kernel repro/kernels/ssd_scan.py::ssd_scan (body
// _ssd_kernel) and computes the function of the JAX model's chunked scan
// (repro/models/layers.py::_ssd_chunked): the Pallas kernel's function,
// grown by an initial state and the final state, which the cached prefill
// needs.  Inputs x [B,T,H,P], dt [B,T,H] (f32), A [H] (f32, negative),
// Bm/Cm [B,T,N] (one group shared by all heads), optional init_state
// [B,H,P,N] (f32); outputs y [B,T,H,P] in x's dtype and final_state
// [B,H,P,N] (f32, never written over init_state).  Per chunk of c
// positions, for each (batch row, head):
//   cum      = cumsum(dt * A)                                  [c]
//   y[i,p]   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x[j,p]
//            + exp(cum_i) sum_n C[i,n] state[p,n]
//   state    = state exp(cum_last)
//            + sum_j x[j,p] exp(cum_last - cum_j) dt_j B[j,n]
// The causal mask is applied before exp (j > i is never exponentiated), as
// the reference's -1e30 does.  dt*A is scanned in double, and every decay
// exponent (cum_i - cum_j, cum_last - cum_j, cum_i) is formed in double
// before the f32 exp: at the serving shape cum reaches ~-400, where an f32
// ulp is 3e-5, and a difference of two such f32 values carries that error
// into its decay factor, the same order as the f32 tolerance (2e-5).
//
// Design: Mamba-2's chunk-parallel split (arXiv:2405.21060 s6), four
// launches on the caller's stream, each of which fills the card:
//   1. scores   G = C.B^T, one block per (row, chunk, 64x64 tile on or
//      below the diagonal), shared by every head (one group), into an f32
//      scratch [B, nc, c, c];
//   2. states   one block per (row, chunk, head, 128 state columns; 64 at
//      P = 128): the chunk's dt*A scan (written to a double scratch
//      [B, nc, H, c]), wend_j = exp(cum_last - cum_j) dt_j, and the
//      chunk's own state S[p,n] = sum_j x[j,p] wend_j B[j,n], a
//      [P x c].[c x 128] product, into an f32 scratch [B, nc, H, P, N];
//   3. passing  per (row, head), each thread four state entries: in[0] =
//      init_state (or 0), in[k+1] = in[k] exp(cum_last[k]) + S[k], walked
//      over the chunks in order; it writes in[k] over S[k] and the last
//      value into final_state;
//   4. outputs  one block per (row, chunk, head, 64-row tile), the heads of
//      one tile side by side (they share the C and G tiles in L2), the
//      last row tiles first: y = (C_tile . in[k]^T) exp(cum_i) plus the
//      sum over the causal 32-key sub-tiles of (G o decay o dt_j) . x.
//      The intra-chunk weight is formed straight into the A-fragment
//      registers from G, cum and dt; it never goes through shared memory.
//      For a sub-tile whose last key r is at or before row i, the decay is
//      exp(cum_i - cum_r) exp(cum_r - cum_j): both exponents are formed in
//      double and are <= 0, and the second factor (times dt_j) is computed
//      once per position, so those pairs take no exp of their own; the
//      diagonal's pairs take exp(cum_i - cum_j).
// At the serving shape (B 4, T 512, H 80, P 64, N 128, chunk 256) that is
// 80 + 640 + 2,560 + 2,560 blocks, against the 320 of the first version,
// whose blocks walked the chunks in series.
//
// Every product runs on the tensor cores (mma.sync, four warps per block,
// each warp 16-row slices).  f32: m16n8k8 TF32 with both operands split
// as flash_attention.cu splits them ("3xTF32"): big = x rounded to TF32 by
// an integer add and mask, small = x - big passed raw (the tensor core
// truncates it), and a product is big*big + big*small + small*big with f32
// accumulation (about 1e-6 relative per product; one TF32 pass, 5e-4,
// misses the f32 tolerance).  The k index of each 8-wide step is permuted
// (logical t, t + 4 are physical 2t, 2t + 1), so each thread reads its A
// and B fragments as neighbouring pairs.  bf16: m16n8k16 bf16 with f32
// accumulation.  x, B and C are bf16 already, so the scores are one exact
// pass; in the other three products the f32 operand (the passed state,
// the intra-chunk weight, x*wend) is split into two bf16 terms, hi + lo,
// which leave less than 2^-17 of it, and takes two passes, while the bf16
// operand (x, B) comes in transposed by ldmatrix.  The passes are issued
// pass-major over a warp's n8 tiles, so consecutive mma.sync never wait on
// one accumulator.  Tiles
// come in through a two-stage cp.async ring (16-byte copies, neighbouring
// threads on neighbouring addresses, one barrier per tile); when the
// wrapper finds a row or pointer that is not 16-byte aligned, the same ring
// is filled by plain loads.
//
// What bounds it on the H100, at the serving shape in f32: its operations
// (~8.1 GFLOP of products at the causal pair count, counted in
// chip_smoke.py) at 495/3 = 165 TFLOP/s of 3xTF32, 0.049 ms; the bytes of
// the function (x, y, B, C, dt, states: ~107 MB) take 0.032 ms, and the
// scratch adds ~21 MB of chunk states written by (2), read and written by
// (3) and read by (4), plus 2 MB of scores.  What the design does about
// the first version's losses: products moved from f32 FMAs out of shared
// memory onto the tensor cores; synchronous tile loads replaced by the
// cp.async ring; 320 blocks walking chunks in series replaced by grids of
// 640 to 2,560 independent blocks; x read once per use from a tile instead
// of twice per chunk; the intra-chunk weights kept in registers.  What
// holds it back now (PERF.md): the work around each mma.sync m16n8k8 (a
// thread loads and splits its B fragment for every 16 x 8 x 8 product, and
// each of a block's four warps splits the same B tile) and the tiles
// streamed from L2 per block.  mma.sync with cp.async is the step that is
// right at every shape (chunks of 16 and 32 below the 64-row tile, N = 8,
// ragged edges); wgmma with TMA is the next one: a warpgroup reads its B
// operand from shared memory with no per-thread fragment work, over 64-row
// tiles that fit both the outputs and the states products.  It needs the
// f32 operands split into big and small planes in shared memory (wgmma
// cannot split a shared-memory operand on the fly), and TF32 wgmma wants
// both operands K-major, which x in the outputs product is not.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr int THREADS = 128;            // product kernels: four warps
constexpr int PASS_THREADS = 256;       // state passing
constexpr int TM = 64;                  // rows of an output tile
constexpr int STAGES = 2;               // tiles in the cp.async ring
constexpr int KT = 32;                  // depth of one ring stage
constexpr int LDK = KT + 8;             // pitch of a [rows][KT] tile
constexpr int MAX_CHUNK = 1024;

struct Params {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const float* init_state;              // may be null: zero initial state
  void* y;
  float* final_state;                   // [B,H,P,N] contiguous
  float* scores;                        // [B,nc,c,c] contiguous
  float* states;                        // [B,nc,H,P,N] contiguous
  double* cum;                          // [B,nc,H,c] contiguous
  int B, T, H, P, N, chunk, nc;
  int vec;                              // 16-byte copies allowed
  long long sx_b, sx_t, sx_h;           // strides in elements; unit on p
  long long sdt_b, sdt_t, sdt_h;
  long long sB_b, sB_t;                 // unit stride on n
  long long sC_b, sC_t;
  long long sy_b, sy_t, sy_h;
  long long si_b, si_h;                 // init_state; [P,N] rows contiguous
};

// ---------------------------------------------------------------------------
// Small helpers
// ---------------------------------------------------------------------------

template <typename T> __device__ __forceinline__ T zero();
template <> __device__ __forceinline__ float zero<float>() { return 0.f; }
template <> __device__ __forceinline__ __nv_bfloat16 zero<__nv_bfloat16>() {
  return __float2bfloat16(0.f);
}
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}
// two neighbouring elements of a shared-memory row, as floats
__device__ __forceinline__ float2 pair(const float* p) {
  return *reinterpret_cast<const float2*>(p);
}
__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return static_cast<uint32_t>(__cvta_generic_to_shared(p));
}
// 16-byte async copy; when !pred nothing is read and the 16 bytes are zeroed
__device__ __forceinline__ void cp_async16(void* dst, const void* src,
                                           bool pred) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 16 : 0));
}
__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" :: "n"(N) : "memory");
}

// rows x cols elements of a global matrix (row stride ``stride``, unit
// column stride) into shared memory with row pitch ``pitch``; rows past
// ``rows_ok`` and columns past ``cols_ok`` are zero.  With ``vec``,
// 16-byte cp.async copies (cols and cols_ok multiples of 16 bytes, rows
// 16-byte aligned: the wrapper checks); else plain loads and stores.
template <typename T>
__device__ __forceinline__ void load_tile(T* dst, int pitch, const T* src,
                                          long long stride, int rows,
                                          int cols, int rows_ok, int cols_ok,
                                          bool vec) {
  if (vec) {
    constexpr int VEC = 16 / (int)sizeof(T);
    const int ch = cols / VEC;
    for (int e = threadIdx.x; e < rows * ch; e += blockDim.x) {
      const int r = e / ch, c = (e % ch) * VEC;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + r * pitch + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = threadIdx.x; e < rows * cols; e += blockDim.x) {
      const int r = e / cols, c = e % cols;
      dst[r * pitch + c] = (r < rows_ok && c < cols_ok)
          ? src[r * stride + c] : zero<T>();
    }
  }
}

// The cp.async ring: ``load(tile, stage)`` issues one tile's copies and
// commits them as one group.  ring_start issues the first STAGES - 1
// tiles; ring_next, called before tile ``it`` is read, waits for it, lets
// every thread see it (and every thread be done with tile it - 1), and
// issues tile it + STAGES - 1 into the stage that tile it - 1 held.  An
// empty group stands in for a tile past the end, so the count of pending
// groups stays right.  One barrier per tile.
template <typename L>
__device__ __forceinline__ void ring_start(L&& load, int n) {
#pragma unroll
  for (int s = 0; s < STAGES - 1; ++s) {
    if (s < n) load(s, s);
    else cp_async_commit();
  }
}
template <typename L>
__device__ __forceinline__ int ring_next(L&& load, int it, int n) {
  cp_async_wait<STAGES - 2>();
  __syncthreads();
  const int next = it + STAGES - 1;
  if (next < n) load(next, next % STAGES);
  else cp_async_commit();
  return it % STAGES;
}

// ---------------------------------------------------------------------------
// Tensor-core products (mma.sync)
// ---------------------------------------------------------------------------

// x = big + small: big is x rounded to TF32 (to nearest, ties away from
// zero) by integer ops on its bit pattern, small = x - big exactly; small
// goes to the tensor core as it is, which reads its top 19 bits
__device__ __forceinline__ void split(float x, uint32_t& big,
                                      uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = __float_as_uint(x - __uint_as_float(big));
}
__device__ __forceinline__ void mma_tf32(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
// c[n] += a.b[n] for the NT n8 tiles of one m16 row of tiles in split
// TF32, small terms first.  Pass-major order: the NT products of a pass
// are independent, so consecutive mma.sync never wait on each other's
// accumulator.
template <int NT>
__device__ __forceinline__ void mma_3xtf32(float (&c)[NT][4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[NT][2],
                                           const uint32_t (&bs)[NT][2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(c[n], as, bb[n]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(c[n], ab, bs[n]);
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_tf32(c[n], ab, bb[n]);
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

// c[n] += a.b[n] in bf16 for the NT n8 tiles of one m16 row of tiles
template <int NT>
__device__ __forceinline__ void mma_bf16_row(float (&c)[NT][4],
                                             const uint32_t (&a)[4],
                                             const uint32_t (&b)[NT][2]) {
#pragma unroll
  for (int n = 0; n < NT; ++n) mma_bf16(c[n], a, b[n]);
}
// (x0, x1) = hi + lo as two bf16 pairs (x0 in the low half): hi is (x0,
// x1) rounded to bf16, lo = bf16(x - hi); what is left, |x - hi - lo|, is
// below 2^-17 |x|
__device__ __forceinline__ void split_bf16(float x0, float x1, uint32_t& hi,
                                           uint32_t& lo) {
  const __nv_bfloat162 h = __floats2bfloat162_rn(x0, x1);
  const float2 hf = __bfloat1622float2(h);
  const __nv_bfloat162 l = __floats2bfloat162_rn(x0 - hf.x, x1 - hf.y);
  hi = *reinterpret_cast<const uint32_t*>(&h);
  lo = *reinterpret_cast<const uint32_t*>(&l);
}
__device__ __forceinline__ float2 unpack_bf16(uint32_t v) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(&v));
}
// four 8x8 bf16 matrices, transposed: lanes 8q..8q+7 give the row
// addresses of matrix q, whose transpose lands in r[q] (each thread: rows
// 2 t4, 2 t4 + 1 of column g)
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
// the bf16 B fragments of NT n8 tiles (k16 x 8 each) of a [k][n] tile in
// shared memory (row pitch ld elements), from row k0 and column n0
template <int NT>
__device__ __forceinline__ void b_frags_trans(uint32_t (&b)[NT][2],
                                              const __nv_bfloat16* t, int ld,
                                              int k0, int n0) {
  const int lane = threadIdx.x & 31;
#pragma unroll
  for (int q = 0; q < NT / 2; ++q) {
    uint32_t r[4];
    ldmatrix_x4_trans(r, t + (k0 + (lane & 15)) * ld + n0 + q * 16
                             + (lane >> 4) * 8);
    b[2 * q][0] = r[0];
    b[2 * q][1] = r[1];
    b[2 * q + 1][0] = r[2];
    b[2 * q + 1][1] = r[3];
  }
}

// an m16n8 accumulator's two neighbouring columns (n, n + 1) of one f32
// row of n_end; one 8-byte store when the rows' length is even
__device__ __forceinline__ void store_pair(float* row, int n, int n_end,
                                           bool even_rows, float a, float b) {
  if (even_rows && n + 1 < n_end) {
    store2(row + n, a, b);
  } else {
    if (n < n_end) row[n] = a;
    if (n + 1 < n_end) row[n + 1] = b;
  }
}

template <typename T>
constexpr bool IS_F32 = std::is_same<T, float>::value;

// ---------------------------------------------------------------------------
// 1. Scores G = C.B^T
// ---------------------------------------------------------------------------

template <typename T>
constexpr int scores_smem() {
  return STAGES * 2 * TM * LDK * (int)sizeof(T);
}

// G[b, k, i, j] = sum_n C[t0+i, n] B[t0+j, n] for the 64x64 tiles on or
// below the diagonal (the scan reads only j <= i).  Grid: (causal tile,
// row * n_chunks); warp w owns the tile's rows 16w..16w+15.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scores_kernel(const Params p) {
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const int bc = blockIdx.y, b = bc / p.nc, ci = bc % p.nc, c = p.chunk;
  const int i0 = ti * TM, j0 = tj * TM, t0 = ci * c;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* cs = reinterpret_cast<T*>(smem_raw);             // [STAGES][TM][LDK]
  T* bs = cs + STAGES * TM * LDK;                     // [STAGES][TM][LDK]
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const T* Cp = static_cast<const T*>(p.Cm) + b * p.sC_b
                + (long long)(t0 + i0) * p.sC_t;
  const T* Bp = static_cast<const T*>(p.Bm) + b * p.sB_b
                + (long long)(t0 + j0) * p.sB_t;
  const int rows_i = min(TM, c - i0), rows_j = min(TM, c - j0);
  const int n_k = (p.N + KT - 1) / KT;
  auto load = [&](int k, int st) {
    load_tile(cs + st * TM * LDK, LDK, Cp + k * KT, p.sC_t, TM, KT, rows_i,
              p.N - k * KT, p.vec);
    load_tile(bs + st * TM * LDK, LDK, Bp + k * KT, p.sB_t, TM, KT, rows_j,
              p.N - k * KT, p.vec);
    cp_async_commit();
  };
  ring_start(load, n_k);

  float acc[8][4];
#pragma unroll
  for (int n = 0; n < 8; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int k = 0; k < n_k; ++k) {
    const int st = ring_next(load, k, n_k);
    const T* ca = cs + st * TM * LDK + (warp * 16 + g) * LDK;
    const T* ba = bs + st * TM * LDK + g * LDK;
    if constexpr (IS_F32<T>) {
#pragma unroll
      for (int kk = 0; kk < KT / 8; ++kk) {
        // logical k = t4 / t4 + 4 are physical n = 2 t4 / 2 t4 + 1
        const float2 x0 = pair(ca + kk * 8 + 2 * t4);
        const float2 x1 = pair(ca + 8 * LDK + kk * 8 + 2 * t4);
        uint32_t ab[4], as[4];
        split(x0.x, ab[0], as[0]);
        split(x1.x, ab[1], as[1]);
        split(x0.y, ab[2], as[2]);
        split(x1.y, ab[3], as[3]);
        uint32_t bb[8][2], bsm[8][2];
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const float2 y = pair(ba + n * 8 * LDK + kk * 8 + 2 * t4);
          split(y.x, bb[n][0], bsm[n][0]);
          split(y.y, bb[n][1], bsm[n][1]);
        }
        mma_3xtf32(acc, ab, as, bb, bsm);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        const uint32_t a[4] = {ld_u32(ca + kk * 16 + 2 * t4),
                               ld_u32(ca + 8 * LDK + kk * 16 + 2 * t4),
                               ld_u32(ca + kk * 16 + 8 + 2 * t4),
                               ld_u32(ca + 8 * LDK + kk * 16 + 8 + 2 * t4)};
#pragma unroll
        for (int n = 0; n < 8; ++n) {
          const T* bp = ba + n * 8 * LDK + kk * 16 + 2 * t4;
          const uint32_t bf[2] = {ld_u32(bp), ld_u32(bp + 8)};
          mma_bf16(acc[n], a, bf);
        }
      }
    }
  }

  float* G = p.scores + (long long)bc * c * c;
  const bool even = (c & 1) == 0;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = i0 + warp * 16 + g + 8 * h2;
    if (i >= c) continue;
    float* row = G + (long long)i * c;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store_pair(row, j0 + n * 8 + 2 * t4, c, even, acc[n][2 * h2],
                 acc[n][2 * h2 + 1]);
  }
}

// ---------------------------------------------------------------------------
// 2. Chunk states
// ---------------------------------------------------------------------------

template <typename T, int P>
struct StateCfg {
  // state columns a block owns: 128 (x read once per 128 columns), 64 at
  // P = 128, where 128 would take 128 accumulators a thread
  static constexpr int NB = P <= 64 ? 128 : 64;
  static constexpr int WM = P / 16 < 4 ? P / 16 : 4;  // warps along p
  static constexpr int WN = 4 / WM;                   // warps along n
  static constexpr int MT = P / 16 / WM;              // m16 tiles a warp
  static constexpr int NT = NB / 8 / WN;              // n8 tiles a warp
  // x and B tiles are read by rows of k (pairs 2t, 2t + 1 apart): a pitch
  // of 4 mod 16 words keeps a warp's reads on distinct banks
  static constexpr int LDX = P + (IS_F32<T> ? 4 : 8);
  static constexpr int LDB = NB + (IS_F32<T> ? 4 : 8);
  static constexpr int TILES = STAGES * KT * (LDX + LDB) * (int)sizeof(T);
  static int smem(int c) {
    return TILES + c * (int)sizeof(double)
           + ((c + KT - 1) / KT) * KT * (int)sizeof(float);
  }
};

// one warp: cum[e] = sum_{e' <= e} dt[e'] A in double, per-lane runs joined
// by shuffles (dts: dt of the chunk in shared memory)
__device__ __forceinline__ void scan_cum(const float* dts, double* cum, int c,
                                         float A) {
  const int lane = threadIdx.x;
  const int per = (c + 31) / 32;
  const int beg = min(lane * per, c), end = min(beg + per, c);
  double s = 0.0;
  for (int e = beg; e < end; ++e) {
    s += (double)dts[e] * (double)A;
    cum[e] = s;
  }
  double incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_up_sync(0xffffffffu, incl, off);
    if (lane >= off) incl += v;
  }
  const double before = incl - s;
  for (int e = beg; e < end; ++e) cum[e] += before;
}

// S[b,k,h][p, n0+n] = sum_j x[j,p] wend_j B[j, n0+n], wend_j = exp(cum_last
// - cum_j) dt_j.  Grid: (NB-column block of N, head, row * n_chunks).
template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_states_kernel(const Params p) {
  using C = StateCfg<T, P>;
  constexpr int LDX = C::LDX, LDB = C::LDB, MT = C::MT, NT = C::NT;
  constexpr int NB = C::NB;
  constexpr bool F32 = IS_F32<T>;
  const int nb = blockIdx.x, h = blockIdx.y, bc = blockIdx.z;
  const int b = bc / p.nc, ci = bc % p.nc, c = p.chunk, t0 = ci * c;
  const int n0 = nb * NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* xs = reinterpret_cast<T*>(smem_raw);             // [STAGES][KT][LDX]
  T* bs = xs + STAGES * KT * LDX;                     // [STAGES][KT][LDB]
  double* cum = reinterpret_cast<double*>(smem_raw + C::TILES);  // [c]
  float* w = reinterpret_cast<float*>(cum + c);       // [c, KT-padded]

  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const T* xp = static_cast<const T*>(p.x) + b * p.sx_b + h * p.sx_h
                + (long long)t0 * p.sx_t;
  const T* Bp = static_cast<const T*>(p.Bm) + b * p.sB_b
                + (long long)t0 * p.sB_t + n0;
  const int n_k = (c + KT - 1) / KT;
  auto load = [&](int k, int st) {
    const int j0 = k * KT;
    load_tile(xs + st * KT * LDX, LDX, xp + j0 * p.sx_t, p.sx_t, KT, P,
              c - j0, P, p.vec);
    load_tile(bs + st * KT * LDB, LDB, Bp + j0 * p.sB_t, p.sB_t, KT, NB,
              c - j0, p.N - n0, p.vec);
    cp_async_commit();
  };
  ring_start(load, n_k);                              // flies over the scan

  const float* dtp = p.dt + b * p.sdt_b + h * p.sdt_h + (long long)t0 * p.sdt_t;
  for (int e = tid; e < n_k * KT; e += THREADS)
    w[e] = e < c ? dtp[e * p.sdt_t] : 0.f;
  __syncthreads();
  if (warp == 0) scan_cum(w, cum, c, p.A[h]);
  __syncthreads();
  const double cum_last = cum[c - 1];
  for (int e = tid; e < c; e += THREADS)
    w[e] = expf((float)(cum_last - cum[e])) * w[e];
  if (nb == 0) {
    double* out = p.cum + ((long long)bc * p.H + h) * c;
    for (int e = tid; e < c; e += THREADS) out[e] = cum[e];
  }

  const int wm = warp % C::WM, wn = warp / C::WM;
  const int pb = wm * MT * 16, nbase = wn * NT * 8;
  float acc[MT][NT][4];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int n = 0; n < NT; ++n)
      acc[m][n][0] = acc[m][n][1] = acc[m][n][2] = acc[m][n][3] = 0.f;

  for (int k = 0; k < n_k; ++k) {
    const int st = ring_next(load, k, n_k);     // (also: w is complete)
    const T* xt = xs + st * KT * LDX;
    const T* bt = bs + st * KT * LDB;
    if constexpr (F32) {
#pragma unroll
      for (int kk = 0; kk < KT / 8; ++kk) {
        // logical k = t4 / t4 + 4 are chunk positions j / j + 1
        const int j = kk * 8 + 2 * t4;
        const float w0 = w[k * KT + j], w1 = w[k * KT + j + 1];
        uint32_t ab[MT][4], as[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          const int r = pb + m * 16 + g;
          split(xt[j * LDX + r] * w0, ab[m][0], as[m][0]);
          split(xt[j * LDX + r + 8] * w0, ab[m][1], as[m][1]);
          split(xt[(j + 1) * LDX + r] * w1, ab[m][2], as[m][2]);
          split(xt[(j + 1) * LDX + r + 8] * w1, ab[m][3], as[m][3]);
        }
        uint32_t bb[NT][2], bsm[NT][2];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int col = nbase + n * 8 + g;
          split(bt[j * LDB + col], bb[n][0], bsm[n][0]);
          split(bt[(j + 1) * LDB + col], bb[n][1], bsm[n][1]);
        }
#pragma unroll
        for (int m = 0; m < MT; ++m)
          mma_3xtf32(acc[m], ab[m], as[m], bb, bsm);
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < KT / 16; ++kk) {
        // A = (x wend)^T, split into bf16 hi + lo: x's k16 x 16 tile comes
        // transposed by ldmatrix (r[q]: p = g (+8), j = 2 t4, 2 t4 + 1 (+8))
        const int j = k * KT + kk * 16 + 2 * t4;
        const float2 w0 = pair(w + j), w1 = pair(w + j + 8);
        uint32_t ah[MT][4], al[MT][4];
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          uint32_t r[4];
          ldmatrix_x4_trans(r, xt + (kk * 16 + (lane & 7) + 8 * (lane >> 4))
                                        * LDX
                                   + pb + m * 16 + 8 * ((lane >> 3) & 1));
#pragma unroll
          for (int q = 0; q < 4; ++q) {
            const float2 v = unpack_bf16(r[q]), ww = q < 2 ? w0 : w1;
            split_bf16(v.x * ww.x, v.y * ww.y, ah[m][q], al[m][q]);
          }
        }
        uint32_t bf[NT][2];                     // B: exact in bf16
        b_frags_trans(bf, bt, LDB, kk * 16, nbase);
#pragma unroll
        for (int m = 0; m < MT; ++m) {
          mma_bf16_row(acc[m], al[m], bf);
          mma_bf16_row(acc[m], ah[m], bf);
        }
      }
    }
  }

  float* S = p.states + ((long long)bc * p.H + h) * P * p.N;
  const bool even = (p.N & 1) == 0;
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      float* row = S + (long long)(pb + m * 16 + g + 8 * h2) * p.N;
#pragma unroll
      for (int n = 0; n < NT; ++n)
        store_pair(row, n0 + nbase + n * 8 + 2 * t4, p.N, even,
                   acc[m][n][2 * h2], acc[m][n][2 * h2 + 1]);
    }
}

// ---------------------------------------------------------------------------
// 3. State passing
// ---------------------------------------------------------------------------

// per (row, head) and state entry e: in = init (or 0); for each chunk k:
// S[k] <- in, in = in exp(cum_last[k]) + S[k]; final_state <- in.  A
// thread owns four neighbouring entries (16-byte loads and stores) and
// loads four chunks' states before it writes any, so the loads of a
// thread are in flight together.  Grid: (entries / 1024, head, row).
constexpr int PASS_UNROLL = 4;

__global__ void __launch_bounds__(PASS_THREADS)
ssd_pass_kernel(const Params p) {
  const int PN = p.P * p.N;                           // a multiple of 16
  const int e = 4 * (blockIdx.x * PASS_THREADS + threadIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, c = p.chunk;
  if (e >= PN) return;
  float4 s = make_float4(0.f, 0.f, 0.f, 0.f);
  if (p.init_state) {
    const float* ip = p.init_state + b * p.si_b + h * p.si_h + e;
    s = make_float4(ip[0], ip[1], ip[2], ip[3]);
  }
  const long long step = (long long)p.H * PN;         // chunk to chunk
  float* __restrict__ S = p.states + ((long long)b * p.nc * p.H + h) * PN + e;
  const double* __restrict__ last = p.cum + ((long long)b * p.nc * p.H + h) * c
                                    + c - 1;
  for (int k0 = 0; k0 < p.nc; k0 += PASS_UNROLL) {
    float4 v[PASS_UNROLL];
    float d[PASS_UNROLL];
#pragma unroll
    for (int u = 0; u < PASS_UNROLL; ++u) {
      if (k0 + u < p.nc) {
        v[u] = *reinterpret_cast<const float4*>(S + (k0 + u) * step);
        d[u] = expf((float)last[(long long)(k0 + u) * p.H * c]);
      }
    }
#pragma unroll
    for (int u = 0; u < PASS_UNROLL; ++u) {
      if (k0 + u < p.nc) {
        *reinterpret_cast<float4*>(S + (k0 + u) * step) = s;
        s.x = s.x * d[u] + v[u].x;
        s.y = s.y * d[u] + v[u].y;
        s.z = s.z * d[u] + v[u].z;
        s.w = s.w * d[u] + v[u].w;
      }
    }
  }
  *reinterpret_cast<float4*>(p.final_state + ((long long)b * p.H + h) * PN
                             + e) = s;
}

// ---------------------------------------------------------------------------
// 4. Chunk outputs
// ---------------------------------------------------------------------------

// the weights of pairs (i, j) and (i, j + 1) of a sub-tile that reaches
// past row i (last valid row mi): G exp(cum_i - cum_j) dt_j, 0 past the
// diagonal (never exponentiated)
__device__ __forceinline__ float2 diag_weights(float2 gg, double cum_i,
                                               const double* cum,
                                               const float* dts, int j,
                                               int mi) {
  float2 w = make_float2(0.f, 0.f);
  if (j <= mi) w.x = gg.x * expf((float)(cum_i - cum[j])) * dts[j];
  if (j < mi) w.y = gg.y * expf((float)(cum_i - cum[j + 1])) * dts[j + 1];
  return w;
}

template <typename T, int P>
struct OutCfg {
  // a ring stage: region A holds a C tile [TM][LDK] (T) or a G tile
  // [TM][LDK] (f32); region B the passed state [P][LDK] (f32) or an x tile
  // [KT][LDX] (T, read by rows of k: pitch 4 mod 16 words)
  static constexpr int LDX = P + (IS_F32<T> ? 4 : 8);
  static constexpr int REG_A = TM * LDK * 4;
  static constexpr int REG_B = P * LDK * 4 > KT * LDX * (int)sizeof(T)
                                   ? P * LDK * 4 : KT * LDX * (int)sizeof(T);
  static constexpr int STAGE = REG_A + REG_B;
  static int smem(int c) {
    // cum [c] doubles, then dt_j and exp(cum_r - cum_j) dt_j [c] floats
    // each, read in pairs (one past the end when c is odd)
    return STAGES * STAGE + c * (int)(sizeof(double) + 2 * sizeof(float))
           + 16;
  }
};

// y rows i0..i0+63 of one (row, chunk, head).  Grid: (head, row *
// n_chunks, row tile): the heads of one (row, chunk, row tile), which read
// the same C and G tiles, run side by side; the last row tiles (most
// causal sub-tiles) first.  Warp w owns rows 16w..16w+15 and every p.
//
// The intra-chunk decay of a pair (i, j) in a key sub-tile whose last
// position r is at or before row i is taken as exp(cum_i - cum_r)
// exp(cum_r - cum_j): both exponents are formed in double and are <= 0
// (j <= r <= i, cum falls), so neither factor overflows, and the product
// is within 2 f32 ulps of exp(cum_i - cum_j).  The second factor (times
// dt_j) is computed once per position, the first once per row and
// sub-tile, so such a pair takes no exp of its own.  A sub-tile that
// reaches past row i (the diagonal's) takes exp(cum_i - cum_j) per pair.
template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_out_kernel(const Params p) {
  using C = OutCfg<T, P>;
  constexpr int LDX = C::LDX, NT = P / 8;
  constexpr bool F32 = IS_F32<T>;
  const int h = blockIdx.x, bc = blockIdx.y;
  const int ti = gridDim.z - 1 - blockIdx.z;
  const int b = bc / p.nc, ci = bc % p.nc, c = p.chunk, t0 = ci * c;
  const int i0 = ti * TM, rows = min(TM, c - i0), i_end = i0 + rows;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw + STAGES * C::STAGE);
  const int n2 = (i_end + 2) & ~1;                    // even, > i_end
  float* dts = reinterpret_cast<float*>(cum + i_end); // [n2]
  float* fj = dts + n2;                               // [n2], 8-byte aligned
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const T* Cp = static_cast<const T*>(p.Cm) + b * p.sC_b
                + (long long)(t0 + i0) * p.sC_t;
  const T* xp = static_cast<const T*>(p.x) + b * p.sx_b + h * p.sx_h
                + (long long)t0 * p.sx_t;
  const float* Sin = p.states + ((long long)bc * p.H + h) * P * p.N;
  const float* G = p.scores + ((long long)bc * c + i0) * c;
  // the passed-in state is zero for the first chunk of an unseeded scan
  const int n_read = (ci == 0 && p.init_state == nullptr)
                         ? 0 : (p.N + KT - 1) / KT;
  const int n_tiles = n_read + (i_end + KT - 1) / KT;
  auto stage_a = [&](int st) { return smem_raw + st * C::STAGE; };
  auto stage_b = [&](int st) { return smem_raw + st * C::STAGE + C::REG_A; };
  auto load = [&](int it, int st) {
    if (it < n_read) {
      const int n0 = it * KT;
      load_tile(reinterpret_cast<T*>(stage_a(st)), LDK, Cp + n0, p.sC_t, TM,
                KT, rows, p.N - n0, p.vec);
      load_tile(reinterpret_cast<float*>(stage_b(st)), LDK, Sin + n0,
                (long long)p.N, P, KT, P, p.N - n0, p.vec);
    } else {
      const int j0 = (it - n_read) * KT;
      load_tile(reinterpret_cast<float*>(stage_a(st)), LDK, G + j0,
                (long long)c, TM, KT, rows, c - j0, p.vec);
      load_tile(reinterpret_cast<T*>(stage_b(st)), LDX, xp + j0 * p.sx_t,
                p.sx_t, KT, P, c - j0, P, p.vec);
    }
    cp_async_commit();
  };
  ring_start(load, n_tiles);                          // flies over cum, dt

  // cum, dt, and per position j: exp(cum_r - cum_j) dt_j, r the last
  // position of j's sub-tile
  const double* cum_g = p.cum + ((long long)bc * p.H + h) * c;
  const float* dtp = p.dt + b * p.sdt_b + h * p.sdt_h + (long long)t0 * p.sdt_t;
  for (int e = tid; e < i_end; e += THREADS) {
    const double ce = cum_g[e];
    const float d = dtp[e * p.sdt_t];
    cum[e] = ce;
    dts[e] = d;
    fj[e] = expf((float)(cum_g[min(e / KT * KT + KT, i_end) - 1] - ce)) * d;
  }
  if (tid < n2 - i_end) dts[i_end + tid] = fj[i_end + tid] = 0.f;  // pad
  __syncthreads();
  // this thread's rows; a row past the chunk computes as its last row and
  // is not stored
  const int ra = i0 + warp * 16 + g, rb = ra + 8;
  const int ma = min(ra, i_end - 1), mb = min(rb, i_end - 1);
  const double cum_a = cum[ma], cum_b = cum[mb];

  float acc[NT][4];
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = ring_next(load, it, n_tiles);
    if (it < n_read) {
      // ---- readout: acc += C_tile . in^T over state columns ------------
      const T* ca = reinterpret_cast<const T*>(stage_a(st))
                    + (warp * 16 + g) * LDK;
      const float* sb = reinterpret_cast<const float*>(stage_b(st)) + g * LDK;
      if constexpr (F32) {
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk) {
          // logical k = t4 / t4 + 4 are physical n = 2 t4 / 2 t4 + 1
          const float2 x0 = pair(ca + kk * 8 + 2 * t4);
          const float2 x1 = pair(ca + 8 * LDK + kk * 8 + 2 * t4);
          uint32_t ab[4], as[4];
          split(x0.x, ab[0], as[0]);
          split(x1.x, ab[1], as[1]);
          split(x0.y, ab[2], as[2]);
          split(x1.y, ab[3], as[3]);
          uint32_t bb[NT][2], bsm[NT][2];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float2 y = pair(sb + n * 8 * LDK + kk * 8 + 2 * t4);
            split(y.x, bb[n][0], bsm[n][0]);
            split(y.y, bb[n][1], bsm[n][1]);
          }
          mma_3xtf32(acc, ab, as, bb, bsm);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          // A = C, exact in bf16; B = the passed state, split hi + lo
          const T* cp = ca + kk * 16 + 2 * t4;
          const uint32_t a[4] = {ld_u32(cp), ld_u32(cp + 8 * LDK),
                                 ld_u32(cp + 8), ld_u32(cp + 8 * LDK + 8)};
          uint32_t bh[NT][2], bl[NT][2];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float* sp = sb + n * 8 * LDK + kk * 16 + 2 * t4;
            const float2 s0 = pair(sp), s1 = pair(sp + 8);
            split_bf16(s0.x, s0.y, bh[n][0], bl[n][0]);
            split_bf16(s1.x, s1.y, bh[n][1], bl[n][1]);
          }
          mma_bf16_row(acc, a, bl);
          mma_bf16_row(acc, a, bh);
        }
      }
    } else {
      if (it == n_read) {                       // readout done: * exp(cum_i)
        const float da = expf((float)cum_a), db = expf((float)cum_b);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          acc[n][0] *= da;
          acc[n][1] *= da;
          acc[n][2] *= db;
          acc[n][3] *= db;
        }
      }
      // ---- intra-chunk: acc += (G o exp(cum_i - cum_j) o dt_j) . x -----
      const int j0 = (it - n_read) * KT, r = min(j0 + KT, i_end) - 1;
      // rows at or past the sub-tile's end r take the factored decay
      const bool fa = r <= ma, fb = r <= mb;
      const float ea = fa ? expf((float)(cum_a - cum[r])) : 0.f;
      const float eb = fb ? expf((float)(cum_b - cum[r])) : 0.f;
      const float* ga = reinterpret_cast<const float*>(stage_a(st))
                        + (warp * 16 + g) * LDK;
      const T* xb = reinterpret_cast<const T*>(stage_b(st));
      // the weights of keys jj, jj + 1 for row a (h2 = 0) or b (h2 = 1)
      auto wpair = [&](int jl, int h2) {
        const int jj = j0 + jl;
        float2 wv = make_float2(0.f, 0.f);
        if (jj < i_end) {
          const float2 gg = pair(ga + 8 * h2 * LDK + jl);
          const float e = h2 ? eb : ea;
          if (h2 ? fb : fa) {
            const float2 f = pair(fj + jj);
            wv = make_float2(gg.x * e * f.x, gg.y * e * f.y);
          } else {
            wv = diag_weights(gg, h2 ? cum_b : cum_a, cum, dts, jj,
                              h2 ? mb : ma);
          }
        }
        return wv;
      };
      if constexpr (F32) {
#pragma unroll
        for (int kk = 0; kk < KT / 8; ++kk) {
          // logical k = t4 / t4 + 4 are chunk positions j / j + 1
          const int jl = kk * 8 + 2 * t4;
          const float2 wa = wpair(jl, 0), wb = wpair(jl, 1);
          uint32_t ab[4], as[4];
          split(wa.x, ab[0], as[0]);
          split(wb.x, ab[1], as[1]);
          split(wa.y, ab[2], as[2]);
          split(wb.y, ab[3], as[3]);
          uint32_t bb[NT][2], bsm[NT][2];
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            split(xb[jl * LDX + n * 8 + g], bb[n][0], bsm[n][0]);
            split(xb[(jl + 1) * LDX + n * 8 + g], bb[n][1], bsm[n][1]);
          }
          mma_3xtf32(acc, ab, as, bb, bsm);
        }
      } else {
#pragma unroll
        for (int kk = 0; kk < KT / 16; ++kk) {
          // A = the weights, split hi + lo; B = x, exact, by ldmatrix
          const int jl = kk * 16 + 2 * t4;
          const float2 wa0 = wpair(jl, 0), wb0 = wpair(jl, 1);
          const float2 wa1 = wpair(jl + 8, 0), wb1 = wpair(jl + 8, 1);
          uint32_t ah[4], al[4];
          split_bf16(wa0.x, wa0.y, ah[0], al[0]);
          split_bf16(wb0.x, wb0.y, ah[1], al[1]);
          split_bf16(wa1.x, wa1.y, ah[2], al[2]);
          split_bf16(wb1.x, wb1.y, ah[3], al[3]);
          uint32_t bf[NT][2];
          b_frags_trans(bf, xb, LDX, kk * 16, 0);
          mma_bf16_row(acc, al, bf);
          mma_bf16_row(acc, ah, bf);
        }
      }
    }
  }

  T* yp = static_cast<T*>(p.y) + b * p.sy_b + h * p.sy_h;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = (h2 ? rb : ra);
    if (i >= i_end) continue;
    T* row = yp + (long long)(t0 + i) * p.sy_t;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2(row + n * 8 + 2 * t4, acc[n][2 * h2], acc[n][2 * h2 + 1]);
  }
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename K>
cudaError_t allow_smem(K kernel, int bytes) {
  return bytes > 48 * 1024
      ? cudaFuncSetAttribute(kernel,
                             cudaFuncAttributeMaxDynamicSharedMemorySize, bytes)
      : cudaSuccess;
}

template <typename T, int P>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  using SC = StateCfg<T, P>;
  using OC = OutCfg<T, P>;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    cudaError_t err = allow_smem(ssd_scores_kernel<T>, scores_smem<T>());
    if (err == cudaSuccess)
      err = allow_smem(ssd_states_kernel<T, P>, SC::smem(MAX_CHUNK));
    if (err == cudaSuccess)
      err = allow_smem(ssd_out_kernel<T, P>, OC::smem(MAX_CHUNK));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int c = p.chunk, tiles = (c + TM - 1) / TM, bnc = p.B * p.nc;
  ssd_scores_kernel<T><<<dim3(tiles * (tiles + 1) / 2, bnc), THREADS,
                         scores_smem<T>(), stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_states_kernel<T, P><<<dim3((p.N + SC::NB - 1) / SC::NB, p.H, bnc),
                            THREADS,
                            SC::smem(c), stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_pass_kernel<<<dim3((P * p.N / 4 + PASS_THREADS - 1) / PASS_THREADS,
                         p.H, p.B), PASS_THREADS, 0, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_out_kernel<T, P><<<dim3(p.H, bnc, tiles), THREADS, OC::smem(c),
                         stream>>>(p);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch(const Params& p, cudaStream_t stream) {
  switch (p.P) {
    case 16: return launch<T, 16>(p, stream);
    case 32: return launch<T, 32>(p, stream);
    case 64: return launch<T, 64>(p, stream);
    case 128: return launch<T, 128>(p, stream);
    default: return cudaErrorInvalidValue;
  }
}

}  // namespace

extern "C" {

// dtype (of x, Bm, Cm, y): 0 = float32, 1 = bfloat16.  T must be n_chunks
// * chunk, chunk <= 1024.  Scratch the caller allocates: scores [B, nc, c,
// c] f32, states [B, nc, H, P, N] f32, cum [B, nc, H, c] f64.  vec != 0
// allows 16-byte copies: x/Bm/Cm pointers and row strides 16-byte
// aligned, N * element size and 4 * chunk multiples of 16 bytes.  Returns
// a cudaError_t (0 = success); the four launches are asynchronous on
// ``stream`` and allocate nothing.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* init_state, void* y,
                 void* final_state, void* scores, void* states, void* cum,
                 int B, int T, int H, int P, int N, int chunk, int dtype,
                 int vec,
                 long long sx_b, long long sx_t, long long sx_h,
                 long long sdt_b, long long sdt_t, long long sdt_h,
                 long long sB_b, long long sB_t,
                 long long sC_b, long long sC_t,
                 long long sy_b, long long sy_t, long long sy_h,
                 long long si_b, long long si_h, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || N <= 0 || chunk <= 0 ||
      chunk > MAX_CHUNK || T % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, static_cast<const float*>(init_state), y,
           static_cast<float*>(final_state), static_cast<float*>(scores),
           static_cast<float*>(states), static_cast<double*>(cum),
           B, T, H, P, N, chunk, T / chunk, vec != 0,
           sx_b, sx_t, sx_h, sdt_b, sdt_t, sdt_h, sB_b, sB_t, sC_b, sC_t,
           sy_b, sy_t, sy_h, si_b, si_h};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch<float>(p, st);
  if (dtype == 1) return (int)dispatch<__nv_bfloat16>(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
