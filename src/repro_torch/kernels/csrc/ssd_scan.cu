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

// load_tile by threads tid, tid + nthr, ... only (the warps of a block
// that own a ring while the others do other work)
template <typename T>
__device__ __forceinline__ void load_tile_by(T* dst, int pitch, const T* src,
                                             long long stride, int rows,
                                             int cols, int rows_ok,
                                             int cols_ok, bool vec, int tid,
                                             int nthr) {
  if (vec) {
    constexpr int VEC = 16 / (int)sizeof(T);
    const int ch = cols / VEC;
    for (int e = tid; e < rows * ch; e += nthr) {
      const int r = e / ch, c = (e % ch) * VEC;
      const bool ok = r < rows_ok && c < cols_ok;
      cp_async16(dst + r * pitch + c, ok ? src + r * stride + c : src, ok);
    }
  } else {
    for (int e = tid; e < rows * cols; e += nthr) {
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

// named barrier ``id`` over ``n`` threads
template <int ID, int N>
__device__ __forceinline__ void bar_sync() {
  asm volatile("bar.sync %0, %1;\n" :: "n"(ID), "n"(N) : "memory");
}
template <int ID, int N>
__device__ __forceinline__ void bar_arrive() {
  asm volatile("bar.arrive %0, %1;\n" :: "n"(ID), "n"(N) : "memory");
}
// The same ring with S stages, shared by the NB threads of named barrier
// BAR (a block's warps that own it while the others do other work)
template <int S, typename L>
__device__ __forceinline__ void ring_start_s(L&& load, int n) {
#pragma unroll
  for (int s = 0; s < S - 1; ++s) {
    if (s < n) load(s, s);
    else cp_async_commit();
  }
}
template <int S, int BAR, int NB, typename L>
__device__ __forceinline__ int ring_next_s(L&& load, int it, int n) {
  cp_async_wait<S - 2>();
  bar_sync<BAR, NB>();
  const int next = it + S - 1;
  if (next < n) load(next, next % S);
  else cp_async_commit();
  return it % S;
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
// GRAD (the backward's first kernel, called with x = dy and Bm = Cm): the
// gradient's own readout state sum_j dy[j,p] exp(cum_j) C[j, n0+n], from
// the forward's cum, which it reads instead of scanning dt.
template <typename T, int P, bool GRAD = false>
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

  if constexpr (GRAD) {
    const double* cg = p.cum + ((long long)bc * p.H + h) * c;
    for (int e = tid; e < n_k * KT; e += THREADS)
      w[e] = e < c ? expf((float)cg[e]) : 0.f;
  } else {
    const float* dtp = p.dt + b * p.sdt_b + h * p.sdt_h
                       + (long long)t0 * p.sdt_t;
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

// ===========================================================================
// The backward
// ===========================================================================
//
// The gradient of the scan (no Pallas counterpart: the JAX model lets XLA
// differentiate repro/models/layers.py::_ssd_chunked), by the forward's
// chunk-parallel split.  Per (row b, chunk k, head h), with cum, L[i,j] =
// exp(cum_i - cum_j) (j <= i), G = C.B^T, W = G L dt_j, S_in the passed-in
// state and dS_own the gradient of the chunk's own state:
//   Z       = sum_i exp(cum_i) dy_i (x) C_i                 [P x N]
//   g_nc    = dfinal;  dS_own[k] = g_{k+1};  g_k = e_k g_{k+1} + Z_k;
//   dinit   = g_0                                   (e_k = exp(cum_end))
//   dx_j    = sum_{i>=j} W[i,j] dy_i + exp(cum_end - cum_j) dt_j dS_own B_j
//   dWL     = (dy_i . x_j) L[i,j]                   (dW o L, causal)
//   dC_i    = sum_h [sum_j dWL dt_j B_j + exp(cum_i) S_in^T dy_i]
//   dB_j    = sum_h [sum_i dWL dt_j C_i
//                    + exp(cum_end - cum_j) dt_j dS_own^T x_j]
//   dcum_i  = sum_{j<i} dWL G dt_j - dt_i sum_{i'>i} dWL[i',i] G[i',i]
//             + dy_i . y_off_i - q_i  (+ sum_j q_j + e_k <g_{k+1}, S_in> at
//             the end), q_j = dt_j r_j, r_j = exp(cum_end - cum_j) x_j .
//             dS_own B_j; the diagonal pair i' = i = j is in both sums
//             and cancels exactly, so it is left out of both (its two
//             rounded copies would not cancel: where the decay is steep
//             they are most of each sum and set the error of R, so of
//             ddt and dA)
//   R       = the in-chunk reverse cumsum of dcum
//   ddt_j   = sum_{i>=j} dWL[i,j] G[i,j] + r_j + A R_j;
//   dA      = sum_{b,k,j} dt_j R_j
// The forward's scratch (scores G, the passed-in states, the double cum)
// comes in saved; masked pairs (j > i) are never exponentiated.  Bm and Cm
// are one group shared by every head, so the intra-chunk terms of dB and
// dC need only the scores' gradient summed over heads, dG = sum_h dWL dt_j,
// one [c x c] per (row, chunk): dC_i += sum_j dG[i,j] B_j, dB_j += sum_i
// dG[i,j] C_i.  Eight launches on the caller's stream:
//   1. ssd_states_kernel<GRAD>: Z per (row, chunk, head), into dstates;
//   2. ssd_bwd_pass_kernel: the reverse pass over chunks, dS_own over Z in
//      place, dinit, and per block a part of e_k <g_{k+1}, S_in[k]>;
//   3. ssd_bwd_dg_kernel: per causal 64x64 tile and group of HG heads, each
//      head's dW = dy . x^T, dWL, its row sums (sum_{j<i} dWL G dt_j),
//      column sums (sum_{i>j} dWL G) and diagonal dWL G, and dWL dt_j
//      summed over the group's heads in registers, in head order, into
//      an f32 part [B, nc, ng, c, c] (ng = ceil(H / HG) groups: 640
//      blocks at mamba2's training shape, where one per tile would be 80);
//   4. ssd_bwd_dgsum_kernel: dG = the groups' parts added in group order;
//   5. ssd_bwd_dx_kernel: per 64 positions j, dS_own B_j (then r_j, and the
//      rows scaled to dx's state term over dt_j), then u_j = sum_{i>=j} G
//      L dy_i, and dx = dt_j times the sum;
//   6. ssd_bwd_dbc_kernel: dB and dC in one launch, per 64 positions, 64
//      columns of N and split: split s < ng sums the state terms of group
//      s's heads along the reduction axis (K = heads x P: dC's exp(cum_i)
//      dy_i . S_in, dB's exp(cum_end - cum_j) dt_j x_j . dS_own), reading
//      each head's dy_i . y_off_i (= C_i . dC_off_i) off its partial
//      product before it joins the sum; split ng takes the intra-chunk
//      term from dG; each writes an f32 part [2, B, nc, ng + 1, c, N];
//   7. ssd_bwd_fin_kernel: per (row, chunk, head) one block gathers dcum,
//      scans it backwards in double, writes ddt and a part of dA;
//   8. ssd_bwd_sum_kernel: dB, dC = their ng + 1 parts added in split
//      order, dA = its parts added in (row, chunk) order.
// No per-head [c x c] or [c x N] buffer goes through device memory (the
// first version wrote dWL per head and dB, dC per head, ~0.4 GB a call at
// the training shape; the parts here are ~38 MB, which L2 mostly holds).
// No atomics: every sum across blocks goes through f32 (dA: f64) parts
// added in a fixed order, and every sum inside a block runs in a fixed
// order, so a second call gives the same bits.  Every product runs on
// mma.sync m16n8k8 in 3xTF32 (the forward's split, with the small term
// rounded to TF32 too: split_rn), for bf16 inputs too: a bf16 value is
// exact in TF32, and its tiles are widened on the fragment reads; each
// head's product ends in its own accumulator, and heads are added by f32
// adds.
// What bounds it (chip_smoke.py's ssd_bwd_bound): six products of c x P x
// N or the causal pairs x P per head, about twice the forward's; the
// design now does those and, per (row, chunk), the two products of dG.

struct BwdParams {
  const void* x;
  const float* dt;
  const float* A;
  const void* Bm;
  const void* Cm;
  const void* dy;
  const float* dfinal;                  // [B,H,P,N] contiguous; may be null
  const float* scores;                  // the forward's G [B,nc,c,c]
  const float* states;                  // the forward's S_in [B,nc,H,P,N]
  const double* cum;                    // the forward's cum [B,nc,H,c]
  float* dstates;                       // Z, then dS_own [B,nc,H,P,N]
  float* dgp;                           // dG's group parts [B,nc,ng,c,c]
  float* dg;                            // dG [B,nc,c,c]
  float* rs;                            // row-sum parts [B,nc,H,nt,c]
  float* cs;                            // column-sum parts [B,nc,H,nt+1,c],
                                        // slot nt the diagonal of dWL G
  float* yoff;                          // dy.y_off parts [B,nc,H,nnb,c]
  float* r;                             // r_j [B,nc,H,c]
  float* gpart;                         // [B,nc,H,npass]
  float* dbcp;                          // dB, dC parts [2,B,nc,ng+1,c,N]
  double* dapart;                       // [B,nc,H]
  void* dx;                             // [B,T,H,P] contiguous, x's dtype
  float* ddt;                           // [B,T,H] contiguous
  float* dA;                            // [H]
  void* dB;                             // [B,T,N] contiguous, x's dtype
  void* dC;
  float* dinit;                         // [B,H,P,N] contiguous; may be null
  int B, T, H, P, N, chunk, nc;
  int nt, nnb, npass, ng;               // 64-row tiles, 64-column blocks of
                                        // N, blocks of the reverse pass,
                                        // head groups
  int vec;                              // 16-byte copies allowed
  long long sx_b, sx_t, sx_h;           // strides in elements; unit on p/n
  long long sdt_b, sdt_t, sdt_h;
  long long sB_b, sB_t;
  long long sC_b, sC_t;
  long long sdy_b, sdy_t, sdy_h;
};

constexpr int BWD_NB = 64;              // columns of N a dB/dC block owns
constexpr int HG = 10;                  // heads a dG or dB/dC block sums
constexpr unsigned FULL = 0xffffffffu;

__device__ __forceinline__ float to_f(float v) { return v; }
__device__ __forceinline__ float to_f(__nv_bfloat16 v) {
  return __bfloat162float(v);
}
template <typename T> __device__ __forceinline__ T from_f(float v);
template <> __device__ __forceinline__ float from_f<float>(float v) {
  return v;
}
template <> __device__ __forceinline__ __nv_bfloat16 from_f<__nv_bfloat16>(
    float v) {
  return __float2bfloat16(v);
}
__device__ __forceinline__ float2 pair_f(const float* p) { return pair(p); }
__device__ __forceinline__ float2 pair_f(const __nv_bfloat16* p) {
  return __bfloat1622float2(*reinterpret_cast<const __nv_bfloat162*>(p));
}
// The backward's split: as split, with small rounded to TF32 as well (the
// tensor core would truncate it), which halves the truncation's share of
// a 3xTF32 product's error.  dA sums dt R over a chunk's positions with
// heavy cancellation: at mamba2's full width a_log's gradient shows the
// backward's rounding (chip_smoke.py phase 22).
__device__ __forceinline__ void split_rn(float x, uint32_t& big,
                                         uint32_t& small) {
  big = (__float_as_uint(x) + 0x1000u) & 0xffffe000u;
  small = (__float_as_uint(x - __uint_as_float(big)) + 0x1000u) & 0xffffe000u;
}
__device__ __forceinline__ void split_a(const float (&v)[4], uint32_t (&ab)[4],
                                        uint32_t (&as)[4]) {
#pragma unroll
  for (int q = 0; q < 4; ++q) split_rn(v[q], ab[q], as[q]);
}
// A fragment values (rows r0 + g, r0 + g + 8; logical k t4, t4 + 4 =
// physical k0 + 2 t4, k0 + 2 t4 + 1) of a [row][k] tile with pitch ld
template <typename T>
__device__ __forceinline__ void a_rowmajor(float (&v)[4], const T* s, int ld,
                                           int r0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const float2 a = pair_f(s + (r0 + g) * ld + k0 + 2 * t4);
  const float2 b = pair_f(s + (r0 + g + 8) * ld + k0 + 2 * t4);
  v[0] = a.x;
  v[1] = b.x;
  v[2] = a.y;
  v[3] = b.y;
}
// ... of a [k][row] tile (the operand transposed in memory)
template <typename T>
__device__ __forceinline__ void a_colmajor(float (&v)[4], const T* s, int ld,
                                           int r0, int k0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const T* q = s + (k0 + 2 * t4) * ld + r0 + g;
  v[0] = to_f(q[0]);
  v[1] = to_f(q[8]);
  v[2] = to_f(q[ld]);
  v[3] = to_f(q[ld + 8]);
}
// split TF32 B fragments of NT n8 tiles (columns n0 + 8 n + g) of a
// [k][n] tile with pitch ld
template <int NT, typename T>
__device__ __forceinline__ void b_kmajor(uint32_t (&bb)[NT][2],
                                         uint32_t (&bs)[NT][2], const T* s,
                                         int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const T* q = s + (k0 + 2 * t4) * ld + n0 + g;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    split_rn(to_f(q[n * 8]), bb[n][0], bs[n][0]);
    split_rn(to_f(q[ld + n * 8]), bb[n][1], bs[n][1]);
  }
}
// ... of an [n][k] tile
template <int NT, typename T>
__device__ __forceinline__ void b_nmajor(uint32_t (&bb)[NT][2],
                                         uint32_t (&bs)[NT][2], const T* s,
                                         int ld, int k0, int n0) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const T* q = s + (n0 + g) * ld + k0 + 2 * t4;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    const float2 y = pair_f(q + n * 8 * ld);
    split_rn(y.x, bb[n][0], bs[n][0]);
    split_rn(y.y, bb[n][1], bs[n][1]);
  }
}
// the sum over the four lanes of a quad (the t4 lanes of one row), the
// same bits on every lane
__device__ __forceinline__ float quad_sum(float v) {
  v += __shfl_xor_sync(FULL, v, 1);
  return v + __shfl_xor_sync(FULL, v, 2);
}
template <int NT>
__device__ __forceinline__ void zero_acc(float (&acc)[NT][4]) {
#pragma unroll
  for (int n = 0; n < NT; ++n)
    acc[n][0] = acc[n][1] = acc[n][2] = acc[n][3] = 0.f;
}
// the dots of an accumulator's two rows (a, b) with v of the same layout,
// summed over the quad: the same bits on every lane
template <int NT>
__device__ __forceinline__ float2 row_dots(const float (&acc)[NT][4],
                                           const float (&v)[NT][4]) {
  float a = 0.f, b = 0.f;
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    a += acc[n][0] * v[n][0] + acc[n][1] * v[n][1];
    b += acc[n][2] * v[n][2] + acc[n][3] * v[n][3];
  }
  return make_float2(quad_sum(a), quad_sum(b));
}
template <int NT>
__device__ __forceinline__ void scale_rows(float (&acc)[NT][4], float fa,
                                           float fb) {
#pragma unroll
  for (int n = 0; n < NT; ++n) {
    acc[n][0] *= fa;
    acc[n][1] *= fa;
    acc[n][2] *= fb;
    acc[n][3] *= fb;
  }
}

// ---------------------------------------------------------------------------
// 2. The reverse pass over chunks
// ---------------------------------------------------------------------------

// a block's sum in a fixed order (a warp's butterfly, then the warps in
// order); valid on thread 0
__device__ __forceinline__ float block_sum(float v, float* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  float t = 0.f;
  if (threadIdx.x == 0)
    for (int w = 0; w < (int)(blockDim.x >> 5); ++w) t += red[w];
  __syncthreads();
  return t;
}

// per (row, head) and state entry e, from the last chunk back: g = dfinal
// (or 0); per chunk k: this block's part of e_k <g, S_in[k]>, dstates[k]
// <- g (it held Z_k), g = e_k g + Z_k; dinit <- g.  A thread owns four
// neighbouring entries.  Grid: (npass, head, row).
__global__ void __launch_bounds__(PASS_THREADS)
ssd_bwd_pass_kernel(const BwdParams p) {
  __shared__ float red[PASS_THREADS / 32];
  const int PN = p.P * p.N;                           // a multiple of 16
  const int e = 4 * (blockIdx.x * PASS_THREADS + threadIdx.x);
  const int h = blockIdx.y, b = blockIdx.z, c = p.chunk;
  const bool live = e < PN;
  float4 g = make_float4(0.f, 0.f, 0.f, 0.f);
  if (live && p.dfinal)
    g = *reinterpret_cast<const float4*>(
        p.dfinal + ((long long)b * p.H + h) * PN + e);
  for (int k = p.nc - 1; k >= 0; --k) {
    const long long bkh = ((long long)b * p.nc + k) * p.H + h;
    float4 z = make_float4(0.f, 0.f, 0.f, 0.f), s = z;
    if (live) {
      z = *reinterpret_cast<const float4*>(p.dstates + bkh * PN + e);
      s = *reinterpret_cast<const float4*>(p.states + bkh * PN + e);
    }
    const float ek = expf((float)p.cum[bkh * c + c - 1]);
    const float tot = block_sum(g.x * s.x + g.y * s.y + g.z * s.z
                                + g.w * s.w, red);
    if (threadIdx.x == 0) p.gpart[bkh * p.npass + blockIdx.x] = ek * tot;
    if (live) {
      *reinterpret_cast<float4*>(p.dstates + bkh * PN + e) = g;
      g.x = g.x * ek + z.x;
      g.y = g.y * ek + z.y;
      g.z = g.z * ek + z.z;
      g.w = g.w * ek + z.w;
    }
  }
  if (live && p.dinit)
    *reinterpret_cast<float4*>(p.dinit + ((long long)b * p.H + h) * PN + e)
        = g;
}

// ---------------------------------------------------------------------------
// 3./4. dG = sum_h dWL dt_j per causal tile and head group, each head's row
//    sums; the groups' parts added
// ---------------------------------------------------------------------------

constexpr int LDGT = TM + 8;            // pitch of a [TM][TM] f32 tile read
                                        // in pairs (8 mod 32 words)
constexpr int DG_THREADS = 2 * THREADS; // four product warps, four epilogue
constexpr int DG_STAGES = 3;            // tiles in the product warps' ring
// named barriers: the product warps' ring; a dW tile handed over (FULL)
// and its buffer handed back (FREE); the epilogue warps' set-up
constexpr int BAR_RING = 1, BAR_FULL = 2, BAR_FREE = 3, BAR_EPI = 4;

template <typename T>
struct DgCfg {
  // the dy and x ring, the G tile, per head of the group: cum at the
  // tile's positions (double; the diagonal tile's rows and columns are the
  // same positions), dt_j, exp(cum_r - cum_j) (times dt_j off the
  // diagonal), exp(cum_i - cum_r); a dW tile in the product warps'
  // fragment order [4 warps][32 values][32 lanes]; and the column sums'
  // exchange [2][4][TM]
  static constexpr int RING = DG_STAGES * 2 * TM * LDK * (int)sizeof(T);
  static constexpr int GT = TM * LDGT * 4;
  static constexpr int HEAD = TM * (8 + 3 * 4);
  static constexpr int XBUF = 4 * 32 * 32 * 4;
  static constexpr int SMEM = RING + GT + HG * HEAD + XBUF + 2 * 4 * TM * 4;
};

// Sums of 16 column values a lane holds, v[n][e] for column 8 n + 2 t4 +
// e, over the 8 lanes g of one t4, by recursive halving (14 shuffles, a
// fixed order): lane g ends with columns 8 g + 2 t4 + e, written to out.
__device__ __forceinline__ void column_sums(const float (&v)[8][2],
                                            float* out) {
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  float a[4][2], q[2][2], w[2];
  const bool b2 = g & 4, b1 = g & 2, b0 = g & 1;
#pragma unroll
  for (int n = 0; n < 4; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {             // keep n + 4 b2
      const float send = b2 ? v[n][e] : v[n + 4][e];
      a[n][e] = (b2 ? v[n + 4][e] : v[n][e]) + __shfl_xor_sync(FULL, send, 16);
    }
#pragma unroll
  for (int n = 0; n < 2; ++n)
#pragma unroll
    for (int e = 0; e < 2; ++e) {             // keep n + 2 b1 + 4 b2
      const float send = b1 ? a[n][e] : a[n + 2][e];
      q[n][e] = (b1 ? a[n + 2][e] : a[n][e]) + __shfl_xor_sync(FULL, send, 8);
    }
#pragma unroll
  for (int e = 0; e < 2; ++e) {               // keep b0 + 2 b1 + 4 b2 = g
    const float send = b0 ? q[0][e] : q[1][e];
    w[e] = (b0 ? q[1][e] : q[0][e]) + __shfl_xor_sync(FULL, send, 4);
  }
  out[g * 8 + 2 * t4] = w[0];
  out[g * 8 + 2 * t4 + 1] = w[1];
}

// Grid: (causal tile, head group, row * n_chunks); 8 warps.  Warps 0-3
// (the product warps) walk the ring over (head, 32-wide slice of P) and
// form each head's dW = dy . x^T tile, warp w rows 16w..16w+15 (positions
// i) and all 64 columns (positions j); each finished tile goes to shared
// memory (once the epilogue warps have read the last one) and they go on
// to the next head.  Warps 4-7 (the epilogue warps) load the G tile and
// the heads' decay factors, then take each tile over (warp 4 + w that of
// warp w, in the same fragment order) and make it dWL: exp(cum_i - cum_j)
// as exp(cum_i - cum_r) exp(cum_r - cum_j), both exponents <= 0 and
// formed in double (the factors' exp too), with r the tile's
// last column off the diagonal and, on it, the last column of each
// 16-column block before the warp's rows, so those pairs take no exp of
// their own; the pairs of a warp's own 16 x 16 diagonal block take one
// each, masked pairs none.  They write the head's row sums (sum_{j<i}
// dWL G dt_j), column sums (sum_{i>j} dWL G) and, on the diagonal tile,
// the diagonal dWL G apart (into the column sums' last slot), and add dWL
// dt_j to the group's dG in registers.  The epilogue runs beside the next
// head's products instead of after them.
template <typename T>
__global__ void __launch_bounds__(DG_THREADS, 2)
ssd_bwd_dg_kernel(const BwdParams p) {
  using C = DgCfg<T>;
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const bool diag = ti == tj;
  const int grp = blockIdx.y, h0 = grp * HG, nh = min(HG, p.H - h0);
  const int bc = blockIdx.z, b = bc / p.nc, ci = bc % p.nc;
  const int c = p.chunk, i0 = ti * TM, j0 = tj * TM, t0 = ci * c;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* ds = reinterpret_cast<T*>(smem_raw);             // [DG_STAGES][TM][LDK]
  T* xs = ds + DG_STAGES * TM * LDK;                  // [DG_STAGES][TM][LDK]
  float* Gs = reinterpret_cast<float*>(smem_raw + C::RING);  // [TM][LDGT]
  double* cumd = reinterpret_cast<double*>(Gs + TM * LDGT);  // [HG][TM]
  float* dtj = reinterpret_cast<float*>(cumd + HG * TM);     // [HG][TM]
  float* fj = dtj + HG * TM;                          // [HG][TM]
  float* ea = fj + HG * TM;                           // [HG][TM]
  float* xbuf = ea + HG * TM;                         // [4][32][32]
  float* red = xbuf + 4 * 32 * 32;                    // [2][4][TM]
  const int tid = threadIdx.x, warp = (tid >> 5) & 3, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int rows_i = min(TM, c - i0), rows_j = min(TM, c - j0);
  const int n_k = (p.P + KT - 1) / KT, n_tiles = nh * n_k;

  if (tid < THREADS) {
    // ---- the product warps --------------------------------------------------
    auto load = [&](int it, int st) {
      const int h = h0 + it / n_k, k0 = (it % n_k) * KT;
      load_tile_by(ds + st * TM * LDK, LDK,
                   static_cast<const T*>(p.dy) + b * p.sdy_b + h * p.sdy_h
                       + (long long)(t0 + i0) * p.sdy_t + k0,
                   p.sdy_t, TM, KT, rows_i, p.P - k0, p.vec, tid, THREADS);
      load_tile_by(xs + st * TM * LDK, LDK,
                   static_cast<const T*>(p.x) + b * p.sx_b + h * p.sx_h
                       + (long long)(t0 + j0) * p.sx_t + k0,
                   p.sx_t, TM, KT, rows_j, p.P - k0, p.vec, tid, THREADS);
      cp_async_commit();
    };
    ring_start_s<DG_STAGES>(load, n_tiles);
    float acc[8][4];
    for (int it = 0; it < n_tiles; ++it) {
      const int st = ring_next_s<DG_STAGES, BAR_RING, THREADS>(load, it,
                                                             n_tiles);
      const int hh = it / n_k, k = it % n_k;
      if (k == 0) zero_acc(acc);
      const T* da = ds + st * TM * LDK;
      const T* xb = xs + st * TM * LDK;
#pragma unroll
      for (int kk = 0; kk < KT / 8; ++kk) {
        float v[4];
        a_rowmajor(v, da, LDK, warp * 16, kk * 8);
        uint32_t ab[4], as[4];
        split_a(v, ab, as);
        uint32_t bb[8][2], bs[8][2];
        b_nmajor<8>(bb, bs, xb, LDK, kk * 8, 0);
        mma_3xtf32(acc, ab, as, bb, bs);
      }
      if (k != n_k - 1) continue;
      // head hh's dW tile, once the epilogue warps have read head hh - 1's
      float* xb_out = xbuf + warp * 32 * 32 + lane;
      if (hh >= 1) bar_sync<BAR_FREE, DG_THREADS>();
#pragma unroll
      for (int n = 0; n < 8; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) xb_out[(n * 4 + q) * 32] = acc[n][q];
      bar_arrive<BAR_FULL, DG_THREADS>();
    }
    return;
  }

  // ---- the epilogue warps ---------------------------------------------------
  const int etid = tid - THREADS;
  for (int e = etid; e < TM * TM; e += THREADS) {     // the G tile
    const int r = e / TM, cl = e % TM;
    Gs[r * LDGT + cl] = (r < rows_i && cl < rows_j)
        ? p.scores[((long long)bc * c + i0 + r) * c + j0 + cl] : 0.f;
  }
  const int r_last = j0 + rows_j - 1;                 // the tile's last column
  for (int e = etid; e < nh * TM; e += THREADS) {
    const int hh = e / TM, l = e % TM, h = h0 + hh;
    const double* cg = p.cum + ((long long)bc * p.H + h) * c;
    const int i = i0 + l, j = j0 + l;
    dtj[e] = j < c ? p.dt[b * p.sdt_b + h * p.sdt_h
                          + (long long)(t0 + j) * p.sdt_t] : 0.f;
    // the factors each stand for many pairs: exp in double, rounded once
    if (diag) {                       // anchor: the 16-column block's last
      cumd[e] = i < c ? cg[i] : 0.0;
      fj[e] = j < c ? (float)exp(cg[j0 + min(l | 15, rows_j - 1)] - cg[j])
                    : 0.f;
    } else {                                          // every i > r >= j
      const double cr = cg[r_last];
      fj[e] = j < c ? (float)exp(cr - cg[j]) : 0.f;
      ea[e] = i < c ? (float)exp(cg[i] - cr) : 0.f;
    }
  }
  bar_sync<BAR_EPI, THREADS>();

  float dg[8][4];
  zero_acc(dg);
  for (int hh = 0; hh < nh; ++hh) {
    bar_sync<BAR_FULL, DG_THREADS>();
    float acc[8][4];
    const float* xb_in = xbuf + warp * 32 * 32 + lane;
#pragma unroll
    for (int n = 0; n < 8; ++n)
#pragma unroll
      for (int q = 0; q < 4; ++q) acc[n][q] = xb_in[(n * 4 + q) * 32];
    // the product warps want the buffer back for the next head
    if (hh + 1 < nh) bar_arrive<BAR_FREE, DG_THREADS>();
    const long long bkh = (long long)bc * p.H + h0 + hh;
    const double* cd = cumd + hh * TM;
    const float* dth = dtj + hh * TM;
    const float* fh = fj + hh * TM;
    float colv[8][2];
#pragma unroll
    for (int n = 0; n < 8; ++n) colv[n][0] = colv[n][1] = 0.f;
#pragma unroll
    for (int h2 = 0; h2 < 2; ++h2) {
      const int il = warp * 16 + g + 8 * h2, i = i0 + il;
      const float* grow = Gs + il * LDGT;
      const float e_i = diag ? 0.f : ea[hh * TM + il];
      const double c_i = diag ? cd[il] : 0.0;
      float rsum = 0.f, em = 0.f, ediag = 0.f;
      bool has_diag = false;
#pragma unroll
      for (int n = 0; n < 8; ++n) {
        const int jl = n * 8 + 2 * t4, m = n >> 1;
        const float2 gg = pair(grow + jl), dd = pair(dth + jl);
        float v0 = 0.f, v1 = 0.f;
        if (!diag) {
          const float2 f = pair(fh + jl);
          v0 = acc[n][2 * h2] * e_i * f.x;
          v1 = acc[n][2 * h2 + 1] * e_i * f.y;
        } else if (m < warp) {        // a 16-column block before the rows
          if ((n & 1) == 0)
            em = i < c ? expf((float)(c_i - cd[m * 16 + 15])) : 0.f;
          const float2 f = pair(fh + jl);
          v0 = acc[n][2 * h2] * em * f.x;
          v1 = acc[n][2 * h2 + 1] * em * f.y;
        } else if (m == warp) {       // the warp's own block
          if (i < c && jl <= il)
            v0 = acc[n][2 * h2] * expf((float)(c_i - cd[jl]));
          if (i < c && jl + 1 <= il)
            v1 = acc[n][2 * h2 + 1] * expf((float)(c_i - cd[jl + 1]));
        }                             // later blocks: masked
        float e0 = v0 * gg.x, e1 = v1 * gg.y;
        dg[n][2 * h2] += v0 * dd.x;
        dg[n][2 * h2 + 1] += v1 * dd.y;
        if (diag && m == warp && i < c) {     // the diagonal, kept apart
          if (jl == il) {
            ediag = e0;
            e0 = 0.f;
            has_diag = true;
          } else if (jl + 1 == il) {
            ediag = e1;
            e1 = 0.f;
            has_diag = true;
          }
        }
        rsum += e0 * dd.x + e1 * dd.y;
        colv[n][0] += e0;
        colv[n][1] += e1;
      }
      rsum = quad_sum(rsum);
      if (i < c && t4 == 0) p.rs[(bkh * p.nt + tj) * c + i] = rsum;
      if (has_diag) p.cs[(bkh * (p.nt + 1) + p.nt) * c + i] = ediag;
    }
    // the column sums: over the warp's rows, then over the four warps in
    // order (red is two buffers: head hh + 2 writes this one after every
    // epilogue warp has passed head hh + 1's barrier)
    float* rd = red + (hh & 1) * 4 * TM;
    column_sums(colv, rd + warp * TM);
    bar_sync<BAR_EPI, THREADS>();
    if (etid < TM && j0 + etid < c)
      p.cs[(bkh * (p.nt + 1) + ti) * c + j0 + etid] =
          rd[etid] + rd[TM + etid] + rd[2 * TM + etid] + rd[3 * TM + etid];
  }

  float* D = p.dgp + ((long long)bc * p.ng + grp) * c * c;
  const bool even = (c & 1) == 0;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int i = i0 + warp * 16 + g + 8 * h2;
    if (i >= c) continue;
    float* row = D + (long long)i * c;
#pragma unroll
    for (int n = 0; n < 8; ++n)
      store_pair(row, j0 + n * 8 + 2 * t4, c, even, dg[n][2 * h2],
                 dg[n][2 * h2 + 1]);
  }
}

// dG = the head groups' parts added in group order, over the causal tiles.
// Grid: (causal tile, row * n_chunks, 16-row quarter of the tile).
constexpr int DGS_THREADS = 256;
constexpr int DGS_ROWS = 16;

__global__ void __launch_bounds__(DGS_THREADS)
ssd_bwd_dgsum_kernel(const BwdParams p) {
  int ti = 0;
  while ((ti + 1) * (ti + 2) / 2 <= (int)blockIdx.x) ++ti;
  const int tj = blockIdx.x - ti * (ti + 1) / 2;
  const int c = p.chunk, bc = blockIdx.y;
  const int i0 = ti * TM + blockIdx.z * DGS_ROWS, j0 = tj * TM;
  const long long cc = (long long)c * c;
  const float* src = p.dgp + (long long)bc * p.ng * cc;
  float* dst = p.dg + (long long)bc * cc;
  for (int e = threadIdx.x; e < DGS_ROWS * TM; e += DGS_THREADS) {
    const int i = i0 + e / TM, j = j0 + e % TM;
    if (i >= c || j >= c) continue;
    const long long o = (long long)i * c + j;
    float s = 0.f;
    for (int q = 0; q < p.ng; ++q) s += src[q * cc + o];
    dst[o] = s;
  }
}

// ---------------------------------------------------------------------------
// 5. dx
// ---------------------------------------------------------------------------

template <typename T, int P>
struct DxCfg {
  // region A: a B tile [TM][LDK] (T) or a G tile [KT][LDG] (f32, read
  // transposed); region B: dS_own [P][LDK] (f32, read transposed) or a dy
  // tile [KT][LDX] (T)
  static constexpr int LDX = P + (IS_F32<T> ? 4 : 8);
  static constexpr int LDG = TM + 4;
  static constexpr int A_T = TM * LDK * (int)sizeof(T);
  static constexpr int A_G = KT * LDG * 4;
  static constexpr int REG_A = A_T > A_G ? A_T : A_G;
  static constexpr int B_S = P * LDK * 4;
  static constexpr int B_X = KT * LDX * (int)sizeof(T);
  static constexpr int REG_B = B_S > B_X ? B_S : B_X;
  static constexpr int STAGE = REG_A + REG_B;
  static int smem(int c) {
    // cum [c] doubles, then dt and exp(cum_i - cum_r(i)) [c] floats each
    return STAGES * STAGE + c * (int)(sizeof(double) + 2 * sizeof(float));
  }
};

// dx rows j0..j0+63 of one (row, chunk, head).  Grid: (head, row *
// n_chunks, row tile); warp w owns rows 16w..16w+15 and every p.  First
// U = B . dS_own^T over the state columns, whence r_j; then the rows are
// scaled by exp(cum_end - cum_j) and u = (G o L)^T dy is added over the
// 32-position sub-tiles i >= j0, the weight formed from G and cum straight
// into the A fragments; the sum is dx_j / dt_j.  As in the forward's
// outputs, a sub-tile that starts at r past the block's rows takes
// exp(cum_i - cum_j) as exp(cum_i - cum_r) (once per position) times
// exp(cum_r - cum_j) (once per row and sub-tile), both exponents <= 0 and
// formed in double; the two sub-tiles over the block's own rows take one
// exp per pair.
template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dx_kernel(const BwdParams p) {
  using C = DxCfg<T, P>;
  constexpr int NT = P / 8, LDX = C::LDX, LDG = C::LDG;
  const int h = blockIdx.x, bc = blockIdx.y, tj = blockIdx.z;
  const int b = bc / p.nc, ci = bc % p.nc, c = p.chunk, t0 = ci * c;
  const int j0 = tj * TM, rows = min(TM, c - j0);
  extern __shared__ __align__(16) unsigned char smem_raw[];
  double* cum = reinterpret_cast<double*>(smem_raw + STAGES * C::STAGE);
  float* dts = reinterpret_cast<float*>(cum + c);
  float* fi = dts + c;                                // exp(cum_i - cum_r(i))
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const long long bkh = (long long)bc * p.H + h;
  const T* Bp = static_cast<const T*>(p.Bm) + b * p.sB_b
                + (long long)(t0 + j0) * p.sB_t;
  const float* dS = p.dstates + bkh * P * p.N;
  const float* G = p.scores + (long long)bc * c * c;
  const T* dyp = static_cast<const T*>(p.dy) + b * p.sdy_b + h * p.sdy_h
                 + (long long)t0 * p.sdy_t;
  const int n_state = (p.N + KT - 1) / KT;
  const int n_tiles = n_state + (c - j0 + KT - 1) / KT;
  auto stage_a = [&](int st) { return smem_raw + st * C::STAGE; };
  auto stage_b = [&](int st) { return smem_raw + st * C::STAGE + C::REG_A; };
  auto load = [&](int it, int st) {
    if (it < n_state) {
      const int n0 = it * KT;
      load_tile(reinterpret_cast<T*>(stage_a(st)), LDK, Bp + n0, p.sB_t, TM,
                KT, rows, p.N - n0, p.vec);
      load_tile(reinterpret_cast<float*>(stage_b(st)), LDK, dS + n0,
                (long long)p.N, P, KT, P, p.N - n0, p.vec);
    } else {
      const int i0 = j0 + (it - n_state) * KT;
      load_tile(reinterpret_cast<float*>(stage_a(st)), LDG,
                G + (long long)i0 * c + j0, (long long)c, KT, TM, c - i0,
                c - j0, p.vec);
      load_tile(reinterpret_cast<T*>(stage_b(st)), LDX,
                dyp + (long long)i0 * p.sdy_t, p.sdy_t, KT, P, c - i0, P,
                p.vec);
    }
    cp_async_commit();
  };
  ring_start(load, n_tiles);
  const double* cg = p.cum + bkh * c;
  const float* dtp = p.dt + b * p.sdt_b + h * p.sdt_h + (long long)t0 * p.sdt_t;
  for (int e = tid; e < c; e += THREADS) {
    const double ce = cg[e];
    cum[e] = ce;
    dts[e] = dtp[(long long)e * p.sdt_t];
    fi[e] = expf((float)(ce - cg[e / KT * KT]));
  }
  // this thread's rows; a row past the chunk computes as the last one and
  // is not stored
  const int ra = j0 + warp * 16 + g, rb = ra + 8;
  const int ma = min(ra, c - 1), mb = min(rb, c - 1);

  float acc[NT][4];
  zero_acc(acc);
  for (int it = 0; it < n_tiles; ++it) {
    const int st = ring_next(load, it, n_tiles);
    if (it < n_state) {
      // ---- U = B_tile . dS_own^T over state columns ---------------------
      const T* As = reinterpret_cast<const T*>(stage_a(st));
      const float* Bs = reinterpret_cast<const float*>(stage_b(st));
#pragma unroll
      for (int kk = 0; kk < KT / 8; ++kk) {
        float v[4];
        a_rowmajor(v, As, LDK, warp * 16, kk * 8);
        uint32_t ab[4], as[4];
        split_a(v, ab, as);
        uint32_t bb[NT][2], bs[NT][2];
        b_nmajor<NT>(bb, bs, Bs, LDK, kk * 8, 0);
        mma_3xtf32(acc, ab, as, bb, bs);
      }
      continue;
    }
    if (it == n_state) {
      // r_j = exp(cum_end - cum_j) x_j . U_j; then U_j -> dx's state term
      // over dt_j
      const T* xa = static_cast<const T*>(p.x) + b * p.sx_b + h * p.sx_h
                    + (long long)(t0 + ma) * p.sx_t;
      const T* xb = static_cast<const T*>(p.x) + b * p.sx_b + h * p.sx_h
                    + (long long)(t0 + mb) * p.sx_t;
      float xv[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        const int col = n * 8 + 2 * t4;
        xv[n][0] = to_f(xa[col]);
        xv[n][1] = to_f(xa[col + 1]);
        xv[n][2] = to_f(xb[col]);
        xv[n][3] = to_f(xb[col + 1]);
      }
      const double cend = cum[c - 1];
      const float ea = expf((float)(cend - cum[ma]));
      const float eb = expf((float)(cend - cum[mb]));
      const float2 d = row_dots(acc, xv);
      if (t4 == 0) {
        if (ra < c) p.r[bkh * c + ra] = ea * d.x;
        if (rb < c) p.r[bkh * c + rb] = eb * d.y;
      }
      scale_rows(acc, ea, eb);
    }
    // ---- u += (G o L)^T dy: A[j][i] = G[i][j] exp(cum_i - cum_j), i >= j
    const int i0 = j0 + (it - n_state) * KT;
    const float* Gs = reinterpret_cast<const float*>(stage_a(st));
    const T* dys = reinterpret_cast<const T*>(stage_b(st));
    const double cja = cum[ma], cjb = cum[mb];
    // past the block's rows: the row factor exp(cum_r - cum_j)
    const bool far = i0 >= j0 + TM;
    const float fa = far ? expf((float)(cum[i0] - cja)) : 0.f;
    const float fb = far ? expf((float)(cum[i0] - cjb)) : 0.f;
#pragma unroll
    for (int kk = 0; kk < KT / 8; ++kk) {
      const int ia = i0 + kk * 8 + 2 * t4, ib = ia + 1;
      float v[4];
      a_colmajor(v, Gs, LDG, warp * 16, kk * 8);
      if (far) {                        // G is 0 past c (the tile's fill)
        const float f0 = ia < c ? fi[ia] : 0.f, f1 = ib < c ? fi[ib] : 0.f;
        v[0] *= f0 * fa;
        v[1] *= f0 * fb;
        v[2] *= f1 * fa;
        v[3] *= f1 * fb;
      } else {
        const double cia = ia < c ? cum[ia] : 0.0;
        const double cib = ib < c ? cum[ib] : 0.0;
        v[0] = (ia < c && ia >= ra) ? v[0] * expf((float)(cia - cja)) : 0.f;
        v[1] = (ia < c && ia >= rb) ? v[1] * expf((float)(cia - cjb)) : 0.f;
        v[2] = (ib < c && ib >= ra) ? v[2] * expf((float)(cib - cja)) : 0.f;
        v[3] = (ib < c && ib >= rb) ? v[3] * expf((float)(cib - cjb)) : 0.f;
      }
      uint32_t ab[4], as[4];
      split_a(v, ab, as);
      uint32_t bb[NT][2], bs[NT][2];
      b_kmajor<NT>(bb, bs, dys, LDX, kk * 8, 0);
      mma_3xtf32(acc, ab, as, bb, bs);
    }
  }

  const float dta = dts[ma], dtb = dts[mb];
  T* dxp = static_cast<T*>(p.dx) + (((long long)b * p.T + t0) * p.H + h) * P;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int j = h2 ? rb : ra;
    if (j >= c) continue;
    const float dj = h2 ? dtb : dta;
    T* row = dxp + (long long)j * p.H * P;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store2(row + n * 8 + 2 * t4, acc[n][2 * h2] * dj,
             acc[n][2 * h2 + 1] * dj);
  }
}

// ---------------------------------------------------------------------------
// 6. dB and dC: the heads' state terms along the reduction axis, and the
//    intra-chunk terms from dG, in f32 parts
// ---------------------------------------------------------------------------

template <typename T>
struct BcCfg {
  // region A: an x or dy tile [TM][LDK] (T), a dG tile [TM][LDK] (f32, dC)
  // or [KT][LDG] (f32, dB: read transposed); region B: a state tile
  // [KT][LDN] (f32) or a B or C tile [KT][LDT] (T); then each head's row
  // factors [HG][TM]
  static constexpr int LDN = BWD_NB + 4;
  static constexpr int LDT = BWD_NB + (IS_F32<T> ? 4 : 8);
  static constexpr int LDG = TM + 4;
  static constexpr int A_R = TM * LDK * 4;
  static constexpr int A_G = KT * LDG * 4;
  static constexpr int REG_A = A_R > A_G ? A_R : A_G;
  static constexpr int B_S = KT * LDN * 4;
  static constexpr int B_T = KT * LDT * (int)sizeof(T);
  static constexpr int REG_B = B_S > B_T ? B_S : B_T;
  static constexpr int STAGE = REG_A + REG_B;
  static constexpr int SMEM = STAGES * STAGE + HG * TM * 4;
};

// One split's part of dC (DC) or dB for 64 positions and 64 columns of N.
//   split s < ng, the state terms of heads s HG .. s HG + HG - 1, in head
//   order, K = heads x P:
//     DC: sum_h exp(cum_i) dy_i . S_in over p; each head's product goes to
//         its own accumulator first, whose rows times exp(cum_i) (dC_off)
//         dotted with C_i are this block's part of that head's dy_i .
//         y_off_i;
//     dB: sum_h exp(cum_end - cum_j) dt_j x_j . dS_own over p;
//   split ng, the intra-chunk term: DC sum_j dG[i,j] B_j over j < the
//   tile's end, dB sum_i dG[i,j] C_i over i >= the tile's start.
// dB's row factors scale the A fragments before their TF32 split.
template <typename T, bool DC>
__device__ __forceinline__ void dbc_part(const BwdParams& p, int tile,
                                         int nb, int s, int bc) {
  using C = BcCfg<T>;
  constexpr int NT = BWD_NB / 8, LDN = C::LDN, LDT = C::LDT, LDG = C::LDG;
  const int b = bc / p.nc, ci = bc % p.nc, c = p.chunk, t0 = ci * c;
  const int r0 = tile * TM, rows = min(TM, c - r0), n0 = nb * BWD_NB;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* fac = reinterpret_cast<float*>(smem_raw + STAGES * C::STAGE);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int ra = r0 + warp * 16 + g, rb = ra + 8;
  auto stage_a = [&](int st) { return smem_raw + st * C::STAGE; };
  auto stage_b = [&](int st) { return smem_raw + st * C::STAGE + C::REG_A; };

  float acc[NT][4];
  zero_acc(acc);
  if (s < p.ng) {
    // ---- the state terms of one head group ---------------------------------
    const int h0 = s * HG, nh = min(HG, p.H - h0);
    const int n_k = (p.P + KT - 1) / KT, n_tiles = nh * n_k;
    const T* a1 = static_cast<const T*>(DC ? p.dy : p.x)
                  + b * (DC ? p.sdy_b : p.sx_b)
                  + (long long)(t0 + r0) * (DC ? p.sdy_t : p.sx_t);
    const long long sa_t = DC ? p.sdy_t : p.sx_t, sa_h = DC ? p.sdy_h : p.sx_h;
    const float* b1 = (DC ? p.states : p.dstates) + n0;
    auto load = [&](int it, int st) {
      const int h = h0 + it / n_k, k0 = (it % n_k) * KT;
      load_tile(reinterpret_cast<T*>(stage_a(st)), LDK, a1 + h * sa_h + k0,
                sa_t, TM, KT, rows, p.P - k0, p.vec);
      load_tile(reinterpret_cast<float*>(stage_b(st)), LDN,
                b1 + (((long long)bc * p.H + h) * p.P + k0) * p.N,
                (long long)p.N, KT, BWD_NB, p.P - k0, p.N - n0, p.vec);
      cp_async_commit();
    };
    ring_start(load, n_tiles);
    // row factors: DC exp(cum_i), dB exp(cum_end - cum_j) dt_j (0 past c)
    for (int e = tid; e < nh * TM; e += THREADS) {
      const int h = h0 + e / TM, r = r0 + e % TM;
      const double* cg = p.cum + ((long long)bc * p.H + h) * c;
      float f = 0.f;
      if (r < c) {
        f = DC ? expf((float)cg[r])
               : expf((float)(cg[c - 1] - cg[r]))
                     * p.dt[b * p.sdt_b + h * p.sdt_h
                            + (long long)(t0 + r) * p.sdt_t];
      }
      fac[e] = f;
    }
    // DC: C at this thread's rows and columns, for the y_off parts
    float cv[2][NT][2];
    if constexpr (DC) {
#pragma unroll
      for (int h2 = 0; h2 < 2; ++h2) {
        const T* crow = static_cast<const T*>(p.Cm) + b * p.sC_b
                        + (long long)(t0 + min(h2 ? rb : ra, c - 1)) * p.sC_t;
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int e = 0; e < 2; ++e) {
            const int col = n0 + n * 8 + 2 * t4 + e;
            cv[h2][n][e] = col < p.N ? to_f(crow[col]) : 0.f;
          }
      }
    }
    float acc_h[NT][4];
    zero_acc(acc_h);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = ring_next(load, it, n_tiles);
      const int hh = it / n_k;
      const float fa = fac[hh * TM + warp * 16 + g];
      const float fb = fac[hh * TM + warp * 16 + g + 8];
      const T* As = reinterpret_cast<const T*>(stage_a(st));
      const float* Bs = reinterpret_cast<const float*>(stage_b(st));
#pragma unroll
      for (int kk = 0; kk < KT / 8; ++kk) {
        float v[4];
        a_rowmajor(v, As, LDK, warp * 16, kk * 8);
        if constexpr (!DC) {
          v[0] *= fa;
          v[1] *= fb;
          v[2] *= fa;
          v[3] *= fb;
        }
        uint32_t ab[4], as[4];
        split_a(v, ab, as);
        uint32_t bb[NT][2], bs[NT][2];
        b_kmajor<NT>(bb, bs, Bs, LDN, kk * 8, 0);
        mma_3xtf32(acc_h, ab, as, bb, bs);
      }
      // each head's product is summed on the tensor core over its P only,
      // then added to the sum over heads by f32 adds
      if (it % n_k != n_k - 1) continue;
      if constexpr (DC) {
        // head h's dy . S_in rows are complete: times exp(cum_i) they are
        // dC_off, whose dot with C_i is this block's part of dy_i .
        // y_off_i
        scale_rows(acc_h, fa, fb);
        float ya = 0.f, yb = 0.f;
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          ya += acc_h[n][0] * cv[0][n][0] + acc_h[n][1] * cv[0][n][1];
          yb += acc_h[n][2] * cv[1][n][0] + acc_h[n][3] * cv[1][n][1];
        }
        ya = quad_sum(ya);
        yb = quad_sum(yb);
        float* yo = p.yoff + (((long long)bc * p.H + h0 + hh) * p.nnb + nb) * c;
        if (t4 == 0) {
          if (ra < c) yo[ra] = ya;
          if (rb < c) yo[rb] = yb;
        }
      }
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int q = 0; q < 4; ++q) {
          acc[n][q] += acc_h[n][q];
          acc_h[n][q] = 0.f;
        }
    }
  } else {
    // ---- the intra-chunk term from dG ---------------------------------------
    const float* dg = p.dg + (long long)bc * c * c;
    const int k_beg = DC ? 0 : r0, k_end = DC ? r0 + rows : c;
    const int n_tiles = (k_end - k_beg + KT - 1) / KT;
    const T* b2 = DC ? static_cast<const T*>(p.Bm) + b * p.sB_b
                           + (long long)t0 * p.sB_t + n0
                     : static_cast<const T*>(p.Cm) + b * p.sC_b
                           + (long long)t0 * p.sC_t + n0;
    const long long sb2 = DC ? p.sB_t : p.sC_t;
    auto load = [&](int it, int st) {
      const int k0 = k_beg + it * KT;
      if (DC)
        load_tile(reinterpret_cast<float*>(stage_a(st)), LDK,
                  dg + (long long)r0 * c + k0, (long long)c, TM, KT, rows,
                  c - k0, p.vec);
      else
        load_tile(reinterpret_cast<float*>(stage_a(st)), LDG,
                  dg + (long long)k0 * c + r0, (long long)c, KT, TM, c - k0,
                  c - r0, p.vec);
      load_tile(reinterpret_cast<T*>(stage_b(st)), LDT, b2 + k0 * sb2, sb2,
                KT, BWD_NB, c - k0, p.N - n0, p.vec);
      cp_async_commit();
    };
    ring_start(load, n_tiles);
    for (int it = 0; it < n_tiles; ++it) {
      const int st = ring_next(load, it, n_tiles);
      const float* As = reinterpret_cast<const float*>(stage_a(st));
      const T* Bs = reinterpret_cast<const T*>(stage_b(st));
#pragma unroll
      for (int kk = 0; kk < KT / 8; ++kk) {
        float v[4];
        if (DC) a_rowmajor(v, As, LDK, warp * 16, kk * 8);  // A[i][j] = dG
        else a_colmajor(v, As, LDG, warp * 16, kk * 8);     // A[j][i] = dG^T
        uint32_t ab[4], as[4];
        split_a(v, ab, as);
        uint32_t bb[NT][2], bs[NT][2];
        b_kmajor<NT>(bb, bs, Bs, LDT, kk * 8, 0);
        mma_3xtf32(acc, ab, as, bb, bs);
      }
    }
  }

  float* out = p.dbcp + ((((long long)DC * p.B * p.nc + bc) * (p.ng + 1) + s)
                         * c) * p.N;
  const bool even = (p.N & 1) == 0;
#pragma unroll
  for (int h2 = 0; h2 < 2; ++h2) {
    const int r = h2 ? rb : ra;
    if (r >= c) continue;
    float* row = out + (long long)r * p.N;
#pragma unroll
    for (int n = 0; n < NT; ++n)
      store_pair(row, n0 + n * 8 + 2 * t4, p.N, even, acc[n][2 * h2],
                 acc[n][2 * h2 + 1]);
  }
}

// Grid: (row tile * nnb + column block, split, (row * n_chunks) * 2 +
// side): dB's blocks (side 0) and dC's (side 1) in one launch, the blocks
// that share an x or dy tile side by side.
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_bwd_dbc_kernel(const BwdParams p) {
  const int tile = blockIdx.x / p.nnb, nb = blockIdx.x % p.nnb;
  const int s = blockIdx.y, bc = blockIdx.z >> 1;
  if (blockIdx.z & 1) dbc_part<T, true>(p, tile, nb, s, bc);
  else dbc_part<T, false>(p, tile, nb, s, bc);
}

// ---------------------------------------------------------------------------
// 7. dcum, its reverse scan, ddt and the parts of dA
// ---------------------------------------------------------------------------

constexpr int FIN_THREADS = 256;

// the sum over a block of FIN_THREADS of one double per thread in a fixed
// order (a warp's butterfly, then the warps in order), on every thread
__device__ __forceinline__ double fin_sum(double v, double* red) {
#pragma unroll
  for (int off = 16; off; off >>= 1) v += __shfl_xor_sync(FULL, v, off);
  __syncthreads();                      // red's last readers are done
  if ((threadIdx.x & 31) == 0) red[threadIdx.x >> 5] = v;
  __syncthreads();
  double t = 0.0;
#pragma unroll
  for (int w = 0; w < FIN_THREADS / 32; ++w) t += red[w];
  return t;
}

// One block per (head, row * n_chunks); thread t owns a run of positions
// (one at chunk 256), so every part is read by consecutive threads at
// consecutive positions.
__global__ void __launch_bounds__(FIN_THREADS)
ssd_bwd_fin_kernel(const BwdParams p) {
  __shared__ double dc[MAX_CHUNK];
  __shared__ float dd[MAX_CHUNK];
  __shared__ double red[FIN_THREADS / 32];
  const int h = blockIdx.x, bc = blockIdx.y, b = bc / p.nc, ci = bc % p.nc;
  const int c = p.chunk, t0 = ci * c, tid = threadIdx.x, lane = tid & 31;
  const long long bkh = (long long)bc * p.H + h;
  const int per = (c + FIN_THREADS - 1) / FIN_THREADS;
  const int beg = min(tid * per, c), end = min(beg + per, c);
  const float* dtp = p.dt + b * p.sdt_b + h * p.sdt_h + (long long)t0 * p.sdt_t;
  double qsum = 0.0;
  for (int e = beg; e < end; ++e) {
    const int te = e / TM;
    float rs = 0.f, cs = 0.f, yo = 0.f;
    for (int t = 0; t <= te; ++t) rs += p.rs[(bkh * p.nt + t) * c + e];
    for (int t = te; t < p.nt; ++t)
      cs += p.cs[(bkh * (p.nt + 1) + t) * c + e];
    const float dgl = p.cs[(bkh * (p.nt + 1) + p.nt) * c + e];
    for (int t = 0; t < p.nnb; ++t) yo += p.yoff[(bkh * p.nnb + t) * c + e];
    const float d = dtp[(long long)e * p.sdt_t], r = p.r[bkh * c + e];
    const float q = d * r;
    dc[e] = (double)rs - (double)d * cs + yo - q;   // no diagonal in either
    dd[e] = cs + dgl + r;
    qsum += q;
  }
  qsum = fin_sum(qsum, red);
  if (beg <= c - 1 && c - 1 < end) {
    double gp = 0.0;
    for (int t = 0; t < p.npass; ++t) gp += p.gpart[bkh * p.npass + t];
    dc[c - 1] += qsum + gp;
  }
  // R = the reverse cumsum of dc: each thread's run, then the runs after
  // it (within the warp by shuffles, then the later warps' totals)
  double s = 0.0;
  for (int e = end - 1; e >= beg; --e) {
    s += dc[e];
    dc[e] = s;
  }
  double incl = s;
#pragma unroll
  for (int off = 1; off < 32; off <<= 1) {
    const double v = __shfl_down_sync(FULL, incl, off);
    if (lane + off < 32) incl += v;
  }
  __syncthreads();
  if (lane == 0) red[tid >> 5] = incl;  // the warp's total
  __syncthreads();
  double after = incl - s;
  for (int w = FIN_THREADS / 32 - 1; w > (tid >> 5); --w) after += red[w];
  const double A = p.A[h];
  float* ddt = p.ddt + ((long long)b * p.T + t0) * p.H + h;
  double da = 0.0;
  for (int e = beg; e < end; ++e) {
    const double R = dc[e] + after;
    ddt[(long long)e * p.H] = dd[e] + (float)(A * R);
    da += (double)dtp[(long long)e * p.sdt_t] * R;
  }
  da = fin_sum(da, red);
  if (tid == 0) p.dapart[bkh] = da;
}

// ---------------------------------------------------------------------------
// 8. dB's and dC's parts, and dA's parts, added in order
// ---------------------------------------------------------------------------

constexpr int SUM_THREADS = 256;

template <typename T>
__global__ void __launch_bounds__(SUM_THREADS)
ssd_bwd_sum_kernel(const BwdParams p) {
  const long long idx = (long long)blockIdx.x * SUM_THREADS + threadIdx.x;
  if (idx < (long long)p.B * p.T * p.N) {
    const int n = (int)(idx % p.N);
    const long long bt = idx / p.N;
    const int t = (int)(bt % p.T), b = (int)(bt / p.T);
    const int ci = t / p.chunk, i = t % p.chunk;
    const int ns = p.ng + 1;
    const long long cN = (long long)p.chunk * p.N;
    const float* db = p.dbcp + (((long long)b * p.nc + ci) * ns * p.chunk + i)
                               * p.N + n;
    const float* dc = db + (long long)p.B * p.nc * ns * cN;
    float sb = 0.f, sc = 0.f;
    for (int s = 0; s < ns; ++s) {
      sb += db[s * cN];
      sc += dc[s * cN];
    }
    static_cast<T*>(p.dB)[idx] = from_f<T>(sb);
    static_cast<T*>(p.dC)[idx] = from_f<T>(sc);
  }
  if (idx < p.H) {
    double s = 0.0;
    for (int k = 0; k < p.B * p.nc; ++k)
      s += p.dapart[(long long)k * p.H + idx];
    p.dA[idx] = (float)s;
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

template <typename T, int P>
cudaError_t launch_bwd(const BwdParams& bp, const Params& pz,
                       cudaStream_t stream) {
  using SC = StateCfg<T, P>;
  using XC = DxCfg<T, P>;
  using BC = BcCfg<T>;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    cudaError_t err = allow_smem(ssd_states_kernel<T, P, true>,
                                 SC::smem(MAX_CHUNK));
    if (err == cudaSuccess)
      err = allow_smem(ssd_bwd_dg_kernel<T>, DgCfg<T>::SMEM);
    if (err == cudaSuccess)
      err = allow_smem(ssd_bwd_dx_kernel<T, P>, XC::smem(MAX_CHUNK));
    if (err == cudaSuccess)
      err = allow_smem(ssd_bwd_dbc_kernel<T>, BC::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int c = bp.chunk, tiles = bp.nt, bnc = bp.B * bp.nc;
  const int causal = tiles * (tiles + 1) / 2;
  ssd_states_kernel<T, P, true><<<dim3((bp.N + SC::NB - 1) / SC::NB, bp.H,
                                       bnc),
                                  THREADS, SC::smem(c), stream>>>(pz);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_pass_kernel<<<dim3(bp.npass, bp.H, bp.B), PASS_THREADS, 0,
                        stream>>>(bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dg_kernel<T><<<dim3(causal, bp.ng, bnc), DG_THREADS,
                         DgCfg<T>::SMEM, stream>>>(bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dgsum_kernel<<<dim3(causal, bnc, TM / DGS_ROWS), DGS_THREADS, 0,
                         stream>>>(bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dx_kernel<T, P><<<dim3(bp.H, bnc, tiles), THREADS, XC::smem(c),
                            stream>>>(bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_dbc_kernel<T><<<dim3(tiles * bp.nnb, bp.ng + 1, bnc * 2), THREADS,
                          BC::SMEM, stream>>>(bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_bwd_fin_kernel<<<dim3(bp.H, bnc), FIN_THREADS, 0, stream>>>(bp);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  long long n_sum = (long long)bp.B * bp.T * bp.N;
  if (n_sum < bp.H) n_sum = bp.H;
  ssd_bwd_sum_kernel<T><<<(unsigned)((n_sum + SUM_THREADS - 1) / SUM_THREADS),
                          SUM_THREADS, 0, stream>>>(bp);
  return cudaGetLastError();
}

template <typename T>
cudaError_t dispatch_bwd(const BwdParams& bp, const Params& pz,
                         cudaStream_t stream) {
  switch (bp.P) {
    case 16: return launch_bwd<T, 16>(bp, pz, stream);
    case 32: return launch_bwd<T, 32>(bp, pz, stream);
    case 64: return launch_bwd<T, 64>(bp, pz, stream);
    case 128: return launch_bwd<T, 128>(bp, pz, stream);
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

// The gradient of ssd_scan_fwd.  dtype, vec and the strides of x, dt, Bm,
// Cm as there (dy's strides likewise, unit on p); dfinal [B,H,P,N]
// contiguous or null (zero).  scores, states, cum: the forward's scratch
// of the same inputs, as it left them.  Scratch the caller allocates (f32
// unless named): dstates [B,nc,H,P,N], dgp [B,nc,ng,c,c], dg [B,nc,c,c],
// rs [B,nc,H,nt,c], cs [B,nc,H,nt+1,c], yoff [B,nc,H,nnb,c], r
// [B,nc,H,c], gpart [B,nc,H,npass], dbcp [2,B,nc,ng+1,c,N], dapart
// [B,nc,H] f64, where nt = ceil(c / 64), nnb = ceil(N / 64), npass =
// ceil(P N / 1024), ng = ceil(H / 10) (HG).  Outputs, contiguous: dx
// [B,T,H,P] and dB, dC [B,T,N] in x's dtype; ddt [B,T,H], dA [H] and
// dinit [B,H,P,N] (null: not written) f32.  Returns a cudaError_t; the
// eight launches are asynchronous on ``stream`` and allocate nothing.
int ssd_scan_bwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* dy, const void* dfinal,
                 const void* scores, const void* states, const void* cum,
                 void* dstates, void* dgp, void* dg, void* rs, void* cs,
                 void* yoff, void* r, void* gpart, void* dbcp, void* dapart,
                 void* dx, void* ddt, void* dA, void* dB, void* dC,
                 void* dinit,
                 int B, int T, int H, int P, int N, int chunk, int dtype,
                 int vec,
                 long long sx_b, long long sx_t, long long sx_h,
                 long long sdt_b, long long sdt_t, long long sdt_h,
                 long long sB_b, long long sB_t,
                 long long sC_b, long long sC_t,
                 long long sdy_b, long long sdy_t, long long sdy_h,
                 void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || N <= 0 || chunk <= 0 ||
      chunk > MAX_CHUNK || T % chunk != 0 || (P * N) % 16 != 0)
    return (int)cudaErrorInvalidValue;
  BwdParams bp{};
  bp.x = x;
  bp.dt = static_cast<const float*>(dt);
  bp.A = static_cast<const float*>(A);
  bp.Bm = Bm;
  bp.Cm = Cm;
  bp.dy = dy;
  bp.dfinal = static_cast<const float*>(dfinal);
  bp.scores = static_cast<const float*>(scores);
  bp.states = static_cast<const float*>(states);
  bp.cum = static_cast<const double*>(cum);
  bp.dstates = static_cast<float*>(dstates);
  bp.dgp = static_cast<float*>(dgp);
  bp.dg = static_cast<float*>(dg);
  bp.rs = static_cast<float*>(rs);
  bp.cs = static_cast<float*>(cs);
  bp.yoff = static_cast<float*>(yoff);
  bp.r = static_cast<float*>(r);
  bp.gpart = static_cast<float*>(gpart);
  bp.dbcp = static_cast<float*>(dbcp);
  bp.dapart = static_cast<double*>(dapart);
  bp.dx = dx;
  bp.ddt = static_cast<float*>(ddt);
  bp.dA = static_cast<float*>(dA);
  bp.dB = dB;
  bp.dC = dC;
  bp.dinit = static_cast<float*>(dinit);
  bp.B = B;
  bp.T = T;
  bp.H = H;
  bp.P = P;
  bp.N = N;
  bp.chunk = chunk;
  bp.nc = T / chunk;
  bp.nt = (chunk + TM - 1) / TM;
  bp.nnb = (N + BWD_NB - 1) / BWD_NB;
  bp.npass = (P * N / 4 + PASS_THREADS - 1) / PASS_THREADS;
  bp.ng = (H + HG - 1) / HG;
  bp.vec = vec != 0;
  bp.sx_b = sx_b;
  bp.sx_t = sx_t;
  bp.sx_h = sx_h;
  bp.sdt_b = sdt_b;
  bp.sdt_t = sdt_t;
  bp.sdt_h = sdt_h;
  bp.sB_b = sB_b;
  bp.sB_t = sB_t;
  bp.sC_b = sC_b;
  bp.sC_t = sC_t;
  bp.sdy_b = sdy_b;
  bp.sdy_t = sdy_t;
  bp.sdy_h = sdy_h;
  // the states kernel's parameters for Z: x = dy, Bm = Cm
  Params pz{};
  pz.x = dy;
  pz.dt = bp.dt;
  pz.A = bp.A;
  pz.Bm = Cm;
  pz.Cm = Cm;
  pz.states = bp.dstates;
  pz.cum = const_cast<double*>(bp.cum);
  pz.B = B;
  pz.T = T;
  pz.H = H;
  pz.P = P;
  pz.N = N;
  pz.chunk = chunk;
  pz.nc = bp.nc;
  pz.vec = bp.vec;
  pz.sx_b = sdy_b;
  pz.sx_t = sdy_t;
  pz.sx_h = sdy_h;
  pz.sdt_b = sdt_b;
  pz.sdt_t = sdt_t;
  pz.sdt_h = sdt_h;
  pz.sB_b = sC_b;
  pz.sB_t = sC_t;
  pz.sC_b = sC_b;
  pz.sC_t = sC_t;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0) return (int)dispatch_bwd<float>(bp, pz, st);
  if (dtype == 1) return (int)dispatch_bwd<__nv_bfloat16>(bp, pz, st);
  return (int)cudaErrorInvalidValue;
}

const char* ssd_scan_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
