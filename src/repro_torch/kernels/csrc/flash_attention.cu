// Flash attention forward for Hopper (sm_90a), CUDA C++ behind a plain C
// interface.  Built by nvcc into a shared library and loaded with ctypes by
// repro_torch/kernels/build.py; the Python wrapper is
// repro_torch/kernels/flash_attention.py::flash_attend.
//
// Replaces the Pallas TPU kernel repro/kernels/flash_attention.py::
// flash_attention (body _flash_kernel) and computes the function the JAX
// model's attention computes (repro/models/layers.py::attend, window=None):
//   q [B,T,Hq,D], k/v [B,S,Hkv,D], read in place through strides;
//   GQA by head index: query head h reads kv head h / (Hq / Hkv);
//   per-row q_start[b] and kv_len[b] (int32 device arrays);
//   key j is visible to query row i iff j < kv_len[b] and, when causal,
//   j <= q_start[b] + i;  masked logits are -1e30 (finite), so a row that
//   sees no key at all averages V over all S keys, as the reference does;
//   f32 scores, running max / sum / accumulator; output in q's dtype.
//
// Design (simple and right first):
//   one block per (64-row query tile, query head, batch row), 256 threads,
//   four threads per query row, each owning D/4 interleaved columns of q
//   and of the f32 accumulator (column c = 4*i + part, so the four threads
//   of a row hit four consecutive shared-memory banks);
//   K/V tiles of 32 keys are staged in shared memory as f32;
//   a q.k score is four partial dot products joined by two xor shuffles;
//   online softmax per tile: max over the tile, rescale, exp, P.V;
//   the kv loop stops at min(kv_len[b], causal limit of the tile's last
//   row), so decode and short prefixes read only the keys they need.
//
// What bounds it on the H100: at the serving shapes (head_dim 64, f32) the
// prefill call's least time is set by its operations (4*D flops per
// visible query-key pair, 67 TFLOP/s of f32 outside the tensor cores) and
// the decode call's (one query row) by the bytes of the K/V prefix.  This
// version is held back by its own issue rate instead: every FMA reads its
// K or V operand with its own 4-byte shared-memory load, so load issue,
// not the FMA units, sets the pace, and a decode block computes all 64
// rows of its tile though one is live.  Vectorised shared loads or more
// rows per thread, mma/wgmma products, double-buffered tiles (cp.async /
// TMA) and a decode block that packs the query heads of one kv head are
// the next steps, measured against the bounds in PERF.md.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>

namespace {

constexpr int BLOCK_Q = 64;             // query rows per block
constexpr int BLOCK_K = 32;             // keys per shared-memory tile
constexpr int TPR = 4;                  // threads per query row
constexpr int THREADS = BLOCK_Q * TPR;  // 256
constexpr float NEG_MASK = -1e30f;      // the reference's masked logit

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_start;
  const int* kv_len;
  int B, T, S, Hq, Hkv;
  long long sq_b, sq_t, sq_h;           // strides in elements
  long long sk_b, sk_s, sk_h;
  long long sv_b, sv_s, sv_h;
  long long so_b, so_t, so_h;
  float scale;
  int causal;
};

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_fwd_kernel(const Params p) {
  constexpr int DP = D / TPR;           // columns per thread
  __shared__ float k_s[BLOCK_K][D];
  __shared__ float v_s[BLOCK_K][D];

  const int qt = blockIdx.x, h = blockIdx.y, b = blockIdx.z;
  const int tid = threadIdx.x;
  const int r = tid / TPR, part = tid % TPR;
  const int i = qt * BLOCK_Q + r;       // this thread's query row
  const int hk = h / (p.Hq / p.Hkv);

  const T* __restrict__ qp = static_cast<const T*>(p.q);
  const T* __restrict__ kp = static_cast<const T*>(p.k);
  const T* __restrict__ vp = static_cast<const T*>(p.v);
  T* __restrict__ op = static_cast<T*>(p.o);

  // keys row ii may see: [0, row_end(ii)); non-decreasing in ii
  const int q0 = p.q_start[b];
  const int kl = min(p.kv_len[b], p.S);
  auto row_end = [&](int ii) { return p.causal ? min(kl, q0 + ii + 1) : kl; };
  const int i_first = qt * BLOCK_Q;
  const int i_last = min(i_first + BLOCK_Q, p.T) - 1;
  int n_loop = row_end(i_last);
  // a row that sees no key averages V over all S keys (all logits -1e30)
  if (row_end(i_first) <= 0) n_loop = p.S;
  const int my_end = row_end(i);

  float qv[DP], acc[DP];
#pragma unroll
  for (int c = 0; c < DP; ++c) {
    qv[c] = 0.f;
    acc[c] = 0.f;
  }
  if (i < p.T) {
    const T* qrow = qp + b * p.sq_b + (long long)i * p.sq_t + h * p.sq_h;
#pragma unroll
    for (int c = 0; c < DP; ++c) qv[c] = to_f32(qrow[c * TPR + part]);
  }
  float m = NEG_MASK, l = 0.f;

  const long long kbase = b * p.sk_b + hk * p.sk_h;
  const long long vbase = b * p.sv_b + hk * p.sv_h;
  for (int j0 = 0; j0 < n_loop; j0 += BLOCK_K) {
    // stage keys/values [j0, j0 + BLOCK_K) as f32; rows past n_loop are
    // zero and get weight exactly 0 below
    for (int e = tid; e < BLOCK_K * D; e += THREADS) {
      const int jj = e / D, c = e % D, key = j0 + jj;
      float kx = 0.f, vx = 0.f;
      if (key < n_loop) {
        kx = to_f32(kp[kbase + (long long)key * p.sk_s + c]);
        vx = to_f32(vp[vbase + (long long)key * p.sv_s + c]);
      }
      k_s[jj][c] = kx;
      v_s[jj][c] = vx;
    }
    __syncthreads();

    float s[BLOCK_K];
    float m_tile = NEG_MASK;
#pragma unroll
    for (int jj = 0; jj < BLOCK_K; ++jj) {
      float dot = 0.f;
#pragma unroll
      for (int c = 0; c < DP; ++c) dot = fmaf(qv[c], k_s[jj][c * TPR + part], dot);
      dot += __shfl_xor_sync(0xffffffffu, dot, 1);
      dot += __shfl_xor_sync(0xffffffffu, dot, 2);
      const int key = j0 + jj;
      const float sc = key >= n_loop ? -INFINITY
                       : (key < my_end ? dot * p.scale : NEG_MASK);
      s[jj] = sc;
      m_tile = fmaxf(m_tile, sc);
    }
    const float m_new = fmaxf(m, m_tile);
    const float alpha = expf(m - m_new);
    float psum = 0.f;
#pragma unroll
    for (int jj = 0; jj < BLOCK_K; ++jj) {
      s[jj] = expf(s[jj] - m_new);
      psum += s[jj];
    }
    l = l * alpha + psum;
#pragma unroll
    for (int c = 0; c < DP; ++c) {
      float a = acc[c] * alpha;
#pragma unroll
      for (int jj = 0; jj < BLOCK_K; ++jj) a = fmaf(s[jj], v_s[jj][c * TPR + part], a);
      acc[c] = a;
    }
    m = m_new;
    __syncthreads();
  }

  if (i < p.T) {
    T* orow = op + b * p.so_b + (long long)i * p.so_t + h * p.so_h;
    const float inv = 1.f / l;
#pragma unroll
    for (int c = 0; c < DP; ++c) store(orow + c * TPR + part, acc[c] * inv);
  }
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  const dim3 grid((p.T + BLOCK_Q - 1) / BLOCK_Q, p.Hq, p.B);
  flash_fwd_kernel<T, D><<<grid, THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  Returns a cudaError_t (0 = success);
// the launch is asynchronous on ``stream`` and allocates nothing.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const void* q_start, const void* kv_len,
                        int B, int T, int S, int Hq, int Hkv, int D, int dtype,
                        long long sq_b, long long sq_t, long long sq_h,
                        long long sk_b, long long sk_s, long long sk_h,
                        long long sv_b, long long sv_s, long long sv_h,
                        long long so_b, long long so_t, long long so_h,
                        float scale, int causal, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o,
           static_cast<const int*>(q_start), static_cast<const int*>(kv_len),
           B, T, S, Hq, Hkv,
           sq_b, sq_t, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h,
           so_b, so_t, so_h, scale, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 32) return (int)launch<float, 32>(p, st);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(p, st);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(p, st);
  if (dtype == 1 && D == 32) return (int)launch<__nv_bfloat16, 32>(p, st);
  if (dtype == 1 && D == 64) return (int)launch<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return (int)launch<__nv_bfloat16, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
