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
// [B,H,P,N] (f32).  Per chunk of c positions, for each (batch row, head):
//   cum      = cumsum(dt * A)                                  [c]
//   y[i,p]   = sum_{j<=i} (C_i . B_j) exp(cum_i - cum_j) dt_j x[j,p]
//            + exp(cum_i) sum_n C[i,n] state[p,n]
//   state    = state exp(cum_last)
//            + sum_j x[j,p] exp(cum_last - cum_j) dt_j B[j,n]
// The causal mask is applied before exp (j > i is never exponentiated), as
// the reference's -1e30 does.
//
// Design (simple and right first):
//   * The TPU grid walks chunks in order and carries the [hb,P,N] state in
//     VMEM scratch.  Hopper runs blocks in no order, so here one block per
//     (head, batch row) loops over the chunks itself and keeps its f32
//     state in shared memory, transposed to [N][P] (row padded so the
//     state update's stores hit distinct banks).  At the serving shape
//     (B 4, H 80) that is 320 blocks of 256 threads, ~70 KB of dynamic
//     shared memory each, three resident per SM: one wave.
//   * C.B^T is shared by all heads (one group).  A first kernel computes it
//     once per (batch row, chunk), only for the 64x64 tiles on or below the
//     diagonal, into an f32 scratch [B, n_chunks, c, c] that the wrapper
//     allocates; each head then reads its tiles from L2 instead of
//     recomputing c*c*N products (at the serving shape ~5.4 GFLOP for
//     the causal tiles alone, two thirds of the rest of the scan).
//   * Every product is a shared-memory tiled matrix product on the CUDA
//     cores in f32 (inputs widened on load): 64-row output tiles, depth-32
//     sub-tiles, 256 threads each owning 4 rows x P/16 columns (readout and
//     intra-chunk) or P/16 x 4 state entries per 64-column pass.  f32
//     products keep the reference's precision (TF32 tensor cores would not).
//   * dt*A is scanned by one warp (per-lane runs joined by shuffles) in
//     double, and every decay exponent (cum_i - cum_j, cum_last - cum_j,
//     cum_i) is formed in double before the f32 exp.  At the serving shape
//     cum reaches ~-400, where an f32 ulp is 3e-5, and a difference of two
//     such f32 values carries that error into its decay factor, the same
//     order as the f32 tolerance (2e-5 of max|y|).
//
// What bounds it on the H100: at the serving shape in f32 its operations
// (~8.1 GFLOP: intra-chunk, chunk states, readout, scores, counted in
// chip_smoke.py) at 67 TFLOP/s of f32 outside the tensor cores; the bytes
// (x, y, B, C, dt, states: ~107 MB) take a quarter of that.  This version
// is held back by its shared-memory traffic (about one 4-byte shared load
// per two FMAs) and by synchronous tile loads; mma/wgmma products (bf16
// in, f32 accumulate where the tolerance allows), cp.async/TMA double
// buffering and a chunk-parallel split of the state pass are the next
// steps, measured against the bound in PERF.md.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int THREADS = 256;
constexpr int TI = 64;                  // rows (chunk positions) per tile
constexpr int TK = 32;                  // depth of a shared-memory sub-tile
constexpr int TN = 64;                  // state columns per update pass
constexpr int PAD = TK + 1;             // padded row of a [*][TK] tile
constexpr int MAX_SMEM = 232448;        // per block on sm_90

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
  int B, T, H, P, N, chunk, nc;
  long long sx_b, sx_t, sx_h;           // strides in elements; unit on p
  long long sdt_b, sdt_t, sdt_h;
  long long sB_b, sB_t;                 // unit stride on n
  long long sC_b, sC_t;
  long long sy_b, sy_t, sy_h;
  long long si_b, si_h;                 // init_state; [P,N] rows contiguous
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

// G[b, ci, i, j] = sum_n C[t0+i, n] B[t0+j, n] for the 64x64 tiles on or
// below the diagonal (the scan reads only j <= i).
template <typename T>
__global__ void __launch_bounds__(THREADS)
ssd_scores_kernel(const Params p) {
  const int ti = blockIdx.x, tj = blockIdx.y;
  if (tj > ti) return;
  const int bc = blockIdx.z;
  const int b = bc / p.nc, ci = bc % p.nc;
  const int c = p.chunk;
  const int i0 = ti * TI, j0 = tj * TI, t0 = ci * c;
  __shared__ float cs[TI][PAD];
  __shared__ float bs[TI][PAD];
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const T* __restrict__ Cp = static_cast<const T*>(p.Cm) + b * p.sC_b;
  const T* __restrict__ Bp = static_cast<const T*>(p.Bm) + b * p.sB_b;

  float acc[4][4];
#pragma unroll
  for (int r = 0; r < 4; ++r)
#pragma unroll
    for (int q = 0; q < 4; ++q) acc[r][q] = 0.f;

  for (int n0 = 0; n0 < p.N; n0 += TK) {
    for (int e = tid; e < TI * TK; e += THREADS) {
      const int r = e / TK, k = e % TK, n = n0 + k;
      float cv = 0.f, bv = 0.f;
      if (n < p.N) {
        if (i0 + r < c) cv = to_f32(Cp[(long long)(t0 + i0 + r) * p.sC_t + n]);
        if (j0 + r < c) bv = to_f32(Bp[(long long)(t0 + j0 + r) * p.sB_t + n]);
      }
      cs[r][k] = cv;
      bs[r][k] = bv;
    }
    __syncthreads();
#pragma unroll
    for (int k = 0; k < TK; ++k) {
      float a[4], bb[4];
#pragma unroll
      for (int r = 0; r < 4; ++r) a[r] = cs[ty + 16 * r][k];
#pragma unroll
      for (int q = 0; q < 4; ++q) bb[q] = bs[tx + 16 * q][k];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < 4; ++q) acc[r][q] = fmaf(a[r], bb[q], acc[r][q]);
    }
    __syncthreads();
  }
  float* G = p.scores + (long long)bc * c * c;
#pragma unroll
  for (int r = 0; r < 4; ++r) {
    const int i = i0 + ty + 16 * r;
#pragma unroll
    for (int q = 0; q < 4; ++q) {
      const int j = j0 + tx + 16 * q;
      if (i < c && j < c) G[(long long)i * c + j] = acc[r][q];
    }
  }
}

// Padded row of the transposed state st[N][SP]: rows n and n+1 (the two
// row groups of a warp in the state update) start 16 banks apart.
template <int P>
__host__ __device__ constexpr int state_pitch() {
  return P % 32 == 0 ? P + 16 : P;
}

template <int P>
size_t chunk_smem_bytes(int N, int c) {
  return sizeof(double) * (size_t)c
      + sizeof(float) * ((size_t)N * state_pitch<P>() + TK * P
                         + 2 * TI * PAD + 2 * (size_t)c);
}

template <typename T, int P>
__global__ void __launch_bounds__(THREADS)
ssd_chunk_kernel(const Params p) {
  constexpr int CP = P / 16;            // p columns per thread
  constexpr int SP = state_pitch<P>();
  extern __shared__ double smem_d[];
  const int c = p.chunk, N = p.N;
  double* cum = smem_d;                 // [c] cumsum(dt*A), in double
  float* st = reinterpret_cast<float*>(cum + c);  // [N][SP] state, n-major
  float* xs = st + N * SP;              // [TK][P] x sub-tile
  float* ws = xs + TK * P;              // [TI][PAD] intra-chunk weights
  float* ab = ws + TI * PAD;            // [TI][PAD] C tile | [TK][TN+1] B tile
  float* dts = ab + TI * PAD;           // [c] dt
  float* wend = dts + c;                // [c] exp(cum_last - cum_j) dt_j

  const int h = blockIdx.x, b = blockIdx.y;
  const int tid = threadIdx.x, ty = tid / 16, tx = tid % 16;
  const float A = p.A[h];
  const T* __restrict__ xp = static_cast<const T*>(p.x) + b * p.sx_b + h * p.sx_h;
  const float* __restrict__ dtp = p.dt + b * p.sdt_b + h * p.sdt_h;
  const T* __restrict__ Bp = static_cast<const T*>(p.Bm) + b * p.sB_b;
  const T* __restrict__ Cp = static_cast<const T*>(p.Cm) + b * p.sC_b;
  T* __restrict__ yp = static_cast<T*>(p.y) + b * p.sy_b + h * p.sy_h;

  for (int e = tid; e < P * N; e += THREADS) {
    const int pp = e / N, n = e % N;
    st[n * SP + pp] = p.init_state
        ? p.init_state[b * p.si_b + h * p.si_h + e] : 0.f;
  }

  for (int ci = 0; ci < p.nc; ++ci) {
    const int t0 = ci * c;
    for (int e = tid; e < c; e += THREADS)
      dts[e] = dtp[(long long)(t0 + e) * p.sdt_t];
    __syncthreads();
    if (tid < 32) {                     // cum = cumsum(dt * A), one warp
      const int per = (c + 31) / 32;
      const int beg = min(tid * per, c), end = min(beg + per, c);
      double s = 0.0;
      for (int e = beg; e < end; ++e) {
        s += (double)dts[e] * (double)A;
        cum[e] = s;
      }
      double incl = s;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const double v = __shfl_up_sync(0xffffffffu, incl, off);
        if (tid >= off) incl += v;
      }
      const double before = incl - s;
      for (int e = beg; e < end; ++e) cum[e] += before;
    }
    __syncthreads();
    const double cum_last = cum[c - 1];
    for (int e = tid; e < c; e += THREADS)
      wend[e] = expf((float)(cum_last - cum[e])) * dts[e];

    // ---- y of this chunk, TI rows at a time (reads the carried state) ---
    const float* G = p.scores + (long long)(b * p.nc + ci) * c * c;
    for (int i0 = 0; i0 < c; i0 += TI) {
      float acc[4][CP];
#pragma unroll
      for (int r = 0; r < 4; ++r)
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[r][q] = 0.f;

      // carried-state readout: sum_n C[i,n] st[n,p], then * exp(cum_i)
      for (int n0 = 0; n0 < N; n0 += TK) {
        for (int e = tid; e < TI * TK; e += THREADS) {
          const int r = e / TK, k = e % TK, i = i0 + r, n = n0 + k;
          ab[r * PAD + k] = (i < c && n < N)
              ? to_f32(Cp[(long long)(t0 + i) * p.sC_t + n]) : 0.f;
        }
        __syncthreads();
        const int kmax = min(TK, N - n0);
#pragma unroll 8
        for (int k = 0; k < kmax; ++k) {
          float a[4], bv[CP];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = ab[(ty + 16 * r) * PAD + k];
#pragma unroll
          for (int q = 0; q < CP; ++q) bv[q] = st[(n0 + k) * SP + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < CP; ++q) acc[r][q] = fmaf(a[r], bv[q], acc[r][q]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        const float d = i < c ? expf((float)cum[i]) : 0.f;
#pragma unroll
        for (int q = 0; q < CP; ++q) acc[r][q] *= d;
      }

      // intra-chunk: sum_{j<=i} G[i,j] exp(cum_i - cum_j) dt_j x[j,p]
      const int jend = min(i0 + TI, c);
      for (int j0 = 0; j0 < jend; j0 += TK) {
        for (int e = tid; e < TI * TK; e += THREADS) {
          const int r = e / TK, k = e % TK, i = i0 + r, j = j0 + k;
          float w = 0.f;
          if (i < c && j <= i)
            w = G[(long long)i * c + j] * expf((float)(cum[i] - cum[j]))
                * dts[j];
          ws[r * PAD + k] = w;
        }
        for (int e = tid; e < TK * P; e += THREADS) {
          const int k = e / P, pp = e % P, j = j0 + k;
          xs[e] = j < c ? to_f32(xp[(long long)(t0 + j) * p.sx_t + pp]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < TK; ++k) {
          float a[4], bv[CP];
#pragma unroll
          for (int r = 0; r < 4; ++r) a[r] = ws[(ty + 16 * r) * PAD + k];
#pragma unroll
          for (int q = 0; q < CP; ++q) bv[q] = xs[k * P + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r)
#pragma unroll
            for (int q = 0; q < CP; ++q) acc[r][q] = fmaf(a[r], bv[q], acc[r][q]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int i = i0 + ty + 16 * r;
        if (i < c) {
          T* yrow = yp + (long long)(t0 + i) * p.sy_t;
#pragma unroll
          for (int q = 0; q < CP; ++q) store(yrow + tx + 16 * q, acc[r][q]);
        }
      }
    }

    // ---- state update: st = st exp(cum_last) + sum_j x[j,p] wend_j B[j,n]
    const float chunk_decay = expf((float)cum_last);
    for (int n0 = 0; n0 < N; n0 += TN) {
      float acc2[CP][4];
#pragma unroll
      for (int q = 0; q < CP; ++q)
#pragma unroll
        for (int r = 0; r < 4; ++r) acc2[q][r] = 0.f;
      for (int j0 = 0; j0 < c; j0 += TK) {
        for (int e = tid; e < TK * TN; e += THREADS) {
          const int k = e / TN, nn = e % TN, j = j0 + k, n = n0 + nn;
          ab[k * (TN + 1) + nn] = (j < c && n < N)
              ? to_f32(Bp[(long long)(t0 + j) * p.sB_t + n]) * wend[j] : 0.f;
        }
        for (int e = tid; e < TK * P; e += THREADS) {
          const int k = e / P, pp = e % P, j = j0 + k;
          xs[e] = j < c ? to_f32(xp[(long long)(t0 + j) * p.sx_t + pp]) : 0.f;
        }
        __syncthreads();
#pragma unroll
        for (int k = 0; k < TK; ++k) {
          float xv[CP], bw[4];
#pragma unroll
          for (int q = 0; q < CP; ++q) xv[q] = xs[k * P + tx + 16 * q];
#pragma unroll
          for (int r = 0; r < 4; ++r) bw[r] = ab[k * (TN + 1) + ty + 16 * r];
#pragma unroll
          for (int q = 0; q < CP; ++q)
#pragma unroll
            for (int r = 0; r < 4; ++r) acc2[q][r] = fmaf(xv[q], bw[r], acc2[q][r]);
        }
        __syncthreads();
      }
#pragma unroll
      for (int r = 0; r < 4; ++r) {
        const int n = n0 + ty + 16 * r;
        if (n < N) {
#pragma unroll
          for (int q = 0; q < CP; ++q) {
            float* s = st + n * SP + tx + 16 * q;
            *s = *s * chunk_decay + acc2[q][r];
          }
        }
      }
    }
    __syncthreads();
  }

  float* fs = p.final_state + ((long long)b * p.H + h) * P * N;
  for (int e = tid; e < P * N; e += THREADS) {
    const int pp = e / N, n = e % N;
    fs[e] = st[n * SP + pp];
  }
}

template <typename T, int P>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const size_t smem = chunk_smem_bytes<P>(p.N, p.chunk);
  if (smem > (size_t)MAX_SMEM) return cudaErrorInvalidValue;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        ssd_chunk_kernel<T, P>, cudaFuncAttributeMaxDynamicSharedMemorySize,
        MAX_SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const int tiles = (p.chunk + TI - 1) / TI;
  ssd_scores_kernel<T><<<dim3(tiles, tiles, p.B * p.nc), THREADS, 0,
                         stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  ssd_chunk_kernel<T, P><<<dim3(p.H, p.B), THREADS, smem, stream>>>(p);
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
// * chunk.  Returns a cudaError_t (0 = success); both launches are
// asynchronous on ``stream`` and allocate nothing.
int ssd_scan_fwd(const void* x, const void* dt, const void* A, const void* Bm,
                 const void* Cm, const void* init_state, void* y,
                 void* final_state, void* scores,
                 int B, int T, int H, int P, int N, int chunk, int dtype,
                 long long sx_b, long long sx_t, long long sx_h,
                 long long sdt_b, long long sdt_t, long long sdt_h,
                 long long sB_b, long long sB_t,
                 long long sC_b, long long sC_t,
                 long long sy_b, long long sy_t, long long sy_h,
                 long long si_b, long long si_h, void* stream) {
  if (B <= 0 || T <= 0 || H <= 0 || N <= 0 || chunk <= 0 || T % chunk != 0)
    return (int)cudaErrorInvalidValue;
  Params p{x, static_cast<const float*>(dt), static_cast<const float*>(A),
           Bm, Cm, static_cast<const float*>(init_state), y,
           static_cast<float*>(final_state), static_cast<float*>(scores),
           B, T, H, P, N, chunk, T / chunk,
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
