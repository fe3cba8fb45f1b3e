// Flash attention forward and backward for Hopper (sm_90a), CUDA C++ behind
// a plain C interface.  Built by nvcc into a shared library and loaded with
// ctypes by repro_torch/kernels/build.py; the Python wrappers are
// repro_torch/kernels/flash_attention.py::flash_attend (forward) and
// ::flash_attend_bwd (backward, the gradient FlashAttention.backward takes;
// the Pallas kernel has none, the JAX model trains through XLA's gradient
// of layers.attend).
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
// Two routes behind the one entry point; the wrapper picks one from static
// shapes (flash_attention.py::route): decode when T * (Hq / Hkv) <= 16,
// prefill otherwise.
//
// Decode route (split-KV, GQA-packed).  At T = 1 the call is bound by the
// bytes of the K/V prefix (4 rows x 8 kv heads x ~540 keys x 64 x 4 B x 2
// at the serving shape: 2.3 us at 3.35 TB/s), so the design is about bytes
// in flight.  One block per (key split, kv head, batch row) holds all
// Hq/Hkv query heads x T rows of that kv head (<= 16 rows), so each K/V
// byte is read once per call.  The split length is a multiple of 64 keys
// chosen by the wrapper from the static S (never from kv_len) so that the
// grid fills the card (64 keys a split at the serving shape: 9 splits, 288
// blocks).  A 64-key K and V tile arrive by 16-byte cp.async (neighbouring
// threads on neighbouring addresses), double-buffered when a split holds
// more than one tile.  Scores, softmax and P.V run on the CUDA cores from
// shared memory (the work is tiny); when the rows are fewer than P.V's
// lane groups, the spare groups take every other key and their sums are
// added at the end, so no thread idles.  Each split writes its f32 partial
// (max, sum, unnormalised acc) into a scratch the wrapper allocates; a
// combine kernel (one block per query row) merges the splits with
// log-sum-exp rescaling.  A split past a row's visible keys reports (max
// -1e30, sum 0) and adds no mass; a row that sees no key takes -1e30
// logits in every split, so the merge averages V over all S keys.
//
// Prefill route (tensor cores, cp.async double buffering).  At T = 512 the
// call is bound by its operations.  One block per (64 query rows, query
// head, batch row), four warps of 16 rows each (FlashAttention-2 style);
// blocks are issued longest-first (the last query tile, which sees the
// most keys under the causal mask, first) so the diagonal's unequal work
// does not leave SMs idle at the tail.  K/V tiles of 64 keys (32 for f32
// at head_dim 128) stream through a two-stage cp.async ring; the kv loop
// ends at the tile's last visible key.  Q.K^T and P.V run on the tensor
// cores with mma.sync:
//   bf16: m16n8k16 with f32 accumulation; the score accumulator of two
//     key tiles is the A fragment of P.V as it stands, and V's B fragment
//     comes from ldmatrix.trans;
//   f32: m16n8k8 TF32 in split precision ("3xTF32"): each operand x is
//     split as big = tf32(x) (rounded to nearest), small = x - big (exact,
//     read by the tensor core as TF32, i.e. truncated), and a product is
//     big*big + big*small + small*big with f32 accumulation.  What it
//     leaves: small*small (<= 2^-22 |ab|) and the truncation of the small
//     parts (< 2^-21 |ab| each), about 1e-6 relative per product, against
//     one TF32 pass's 2^-11 ~ 5e-4, which misses the 2e-5 f32 tolerance
//     (tests/test_torch_flash_split.py emulates both).  The score accumulator of m16n8k8 is not laid out like
//     its A fragment; the kernel needs no shuffle because the sum over a
//     k-step may take its 8 indices in any order: logical k = t and t + 4
//     are read as physical 2t and 2t + 1 (for d in Q.K^T, for keys in
//     P.V), which is where the accumulator already holds them.
// mma.sync with cp.async is the first Hopper design; wgmma with TMA (and
// V transposed in shared memory for TF32's K-major operands) is the route
// to the full tensor-core rate.
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <math.h>
#include <stdint.h>
#include <type_traits>

namespace {

constexpr float NEG_MASK = -1e30f;      // the reference's masked logit
constexpr float LOG2E = 1.4426950408889634f;
constexpr float LN2 = 0.6931471805599453f;
constexpr int THREADS = 128;            // both routes: four warps
constexpr int DEC_ROWS = 16;            // query rows a decode block holds
constexpr int DEC_TK = 64;              // keys per decode tile
constexpr int DEC_MAX_SPLITS = 64;

struct Params {
  const void* q;
  const void* k;
  const void* v;
  void* o;
  const int* q_start;
  const int* kv_len;
  float* part;                          // decode: split partials
  float* lse;                           // prefill: per-row log-sum-exp, or null
  int B, T, S, Hq, Hkv;
  int n_split, split_len;               // decode route
  long long sq_b, sq_t, sq_h;           // strides in elements
  long long sk_b, sk_s, sk_h;
  long long sv_b, sv_s, sv_h;
  long long so_b, so_t, so_h;
  float scale_log2;                     // softmax scale * log2(e)
  int causal;
};

// ---------------------------------------------------------------------------
// Small helpers
// ---------------------------------------------------------------------------

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) {
  return __bfloat162float(x);
}
__device__ __forceinline__ void store(float* p, float x) { *p = x; }
__device__ __forceinline__ void store(__nv_bfloat16* p, float x) {
  *p = __float2bfloat16(x);
}
// two neighbouring outputs (8- or 4-byte aligned)
__device__ __forceinline__ void store2(float* p, float x, float y) {
  *reinterpret_cast<float2*>(p) = make_float2(x, y);
}
__device__ __forceinline__ void store2(__nv_bfloat16* p, float x, float y) {
  *reinterpret_cast<__nv_bfloat162*>(p) = __floats2bfloat162_rn(x, y);
}

// 16 bytes of shared memory as floats
__device__ __forceinline__ void load16(const float* p, float (&f)[4]) {
  const float4 x = *reinterpret_cast<const float4*>(p);
  f[0] = x.x; f[1] = x.y; f[2] = x.z; f[3] = x.w;
}
__device__ __forceinline__ void load16(const __nv_bfloat16* p, float (&f)[8]) {
  const uint4 x = *reinterpret_cast<const uint4*>(p);
  const __nv_bfloat162* h = reinterpret_cast<const __nv_bfloat162*>(&x);
#pragma unroll
  for (int i = 0; i < 4; ++i) {
    const float2 t = __bfloat1622float2(h[i]);
    f[2 * i] = t.x;
    f[2 * i + 1] = t.y;
  }
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

__device__ __forceinline__ float warp_max(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x = fmaxf(x, __shfl_xor_sync(0xffffffffu, x, o));
  return x;
}
__device__ __forceinline__ float warp_sum(float x) {
#pragma unroll
  for (int o = 16; o > 0; o >>= 1) x += __shfl_xor_sync(0xffffffffu, x, o);
  return x;
}

// keys row i may see: [0, row_end); row_end <= 0 means the row sees none
// and, as in the reference, averages V over all S keys
__device__ __forceinline__ int row_end(const Params& p, int q0, int kl,
                                       int i) {
  return p.causal ? min(kl, q0 + i + 1) : kl;
}
// the score of key ``key`` for a row with visible end ``re``: its value if
// visible, -1e30 for every key < S of a row that sees none, else -inf (no
// weight at all, which is what -1e30 gives beside a finite logit)
__device__ __forceinline__ float mask_score(float s, int key, int re, int S) {
  if (re > 0) return key < re ? s : -INFINITY;
  return key < S ? NEG_MASK : -INFINITY;
}

// ---------------------------------------------------------------------------
// Tensor-core products (mma.sync)
// ---------------------------------------------------------------------------

// x = big + small: big is x rounded to TF32 (to nearest, ties away from
// zero, as cvt.rna.tf32.f32 gives) by integer ops on its bit pattern, and
// small = x - big exactly; small goes to the tensor core as it is, which
// reads its top 19 bits (TF32 truncation of small)
__device__ __forceinline__ void split_tf32(float x, uint32_t& big,
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
// c += a.b in 3xTF32 (small terms first)
__device__ __forceinline__ void mma_3xtf32(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bb)[2],
                                           const uint32_t (&bs)[2]) {
  mma_tf32(c, as, bb);
  mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}
__device__ __forceinline__ void mma_bf16(float (&c)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k16.row.col.f32.bf16.bf16.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}
__device__ __forceinline__ void ldmatrix_x4_trans(uint32_t (&r)[4],
                                                  const void* p) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.trans.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3])
      : "r"(smem_u32(p)));
}
__device__ __forceinline__ uint32_t pack_bf16(float lo, float hi) {
  __nv_bfloat162 h = __floats2bfloat162_rn(lo, hi);
  return *reinterpret_cast<uint32_t*>(&h);
}
__device__ __forceinline__ uint32_t ld_u32(const __nv_bfloat16* p) {
  return *reinterpret_cast<const uint32_t*>(p);
}

// ---------------------------------------------------------------------------
// Prefill route
// ---------------------------------------------------------------------------

template <typename T, int D>
struct PrefillCfg {
  static constexpr bool F32 = std::is_same<T, float>::value;
  static constexpr int BM = 64;                       // query rows per block
  static constexpr int BN = (F32 && D == 128) ? 32 : 64;  // keys per tile
  // row pitches (elements) that keep each warp's fragment loads free of
  // bank conflicts: 8 extra elements for Q and K; V is read by rows of
  // keys (f32: two 4-byte loads 2t and 2t+1 keys apart) or by ldmatrix
  static constexpr int LDQ = D + 8;
  static constexpr int LDK = D + 8;
  static constexpr int LDV = D + (F32 ? 4 : 8);
  static constexpr int SMEM = (BM * LDQ + 2 * BN * LDK + 2 * BN * LDV)
                              * (int)sizeof(T);
};

// LSE: write the per-row statistics (a separate instantiation, so the
// serving path's kernel is the one without the epilogue)
template <typename T, int D, bool LSE>
__global__ void __launch_bounds__(THREADS)
flash_prefill_kernel(const Params p) {
  using C = PrefillCfg<T, D>;
  constexpr int BM = C::BM, BN = C::BN, NT = BN / 8, DT = D / 8;
  constexpr int LDQ = C::LDQ, LDK = C::LDK, LDV = C::LDV;
  constexpr int VEC = 16 / (int)sizeof(T);            // elements per 16 B
  constexpr int CH = D / VEC;                         // 16 B chunks per row
  extern __shared__ __align__(16) unsigned char smem_raw[];
  T* q_s = reinterpret_cast<T*>(smem_raw);            // [BM][LDQ]
  T* k_s = q_s + BM * LDQ;                            // [2][BN][LDK]
  T* v_s = k_s + 2 * BN * LDK;                        // [2][BN][LDV]

  const int n_qt = gridDim.z;
  const int qt = n_qt - 1 - blockIdx.z;               // longest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;
  const int g = lane >> 2, t4 = lane & 3;

  const T* __restrict__ qp = static_cast<const T*>(p.q);
  const T* __restrict__ kp = static_cast<const T*>(p.k);
  const T* __restrict__ vp = static_cast<const T*>(p.v);
  T* __restrict__ op = static_cast<T*>(p.o);

  const int q0 = p.q_start[b];
  const int kl = min(p.kv_len[b], p.S);
  const int i_first = qt * BM;
  const int i_last = min(i_first + BM, p.T) - 1;
  // row_end is non-decreasing in i: the last row sees the most keys; a
  // tile whose first row sees none needs every key (its -1e30 logits)
  int n_loop = row_end(p, q0, kl, i_last);
  if (row_end(p, q0, kl, i_first) <= 0) n_loop = p.S;
  const int n_tiles = (n_loop + BN - 1) / BN;

  // this thread's two rows, and the warp's first row (fewest keys)
  const int r0 = i_first + warp * 16 + g;
  const int re0 = row_end(p, q0, kl, r0);
  const int re1 = row_end(p, q0, kl, r0 + 8);
  const int w_end = row_end(p, q0, kl, i_first + warp * 16);

  // Q tile (its own cp.async group), then K/V tile 0
  for (int e = tid; e < BM * CH; e += THREADS) {
    const int r = e / CH, c = e % CH, i = i_first + r;
    const bool ok = i < p.T;
    const T* src = qp + b * p.sq_b + (long long)(ok ? i : 0) * p.sq_t
                   + h * p.sq_h + c * VEC;
    cp_async16(q_s + r * LDQ + c * VEC, src, ok);
  }
  cp_async_commit();
  const long long kbase = b * p.sk_b + hk * p.sk_h;
  const long long vbase = b * p.sv_b + hk * p.sv_h;
  auto load_kv = [&](int tile, int st) {
    const int j0 = tile * BN;
    for (int e = tid; e < BN * CH; e += THREADS) {
      const int r = e / CH, c = e % CH, key = j0 + r;
      const bool ok = key < n_loop;                   // zero past the end
      const long long kk = ok ? key : 0;
      cp_async16(k_s + (st * BN + r) * LDK + c * VEC,
                 kp + kbase + kk * p.sk_s + c * VEC, ok);
      cp_async16(v_s + (st * BN + r) * LDV + c * VEC,
                 vp + vbase + kk * p.sv_s + c * VEC, ok);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  float o[DT][4];
#pragma unroll
  for (int d = 0; d < DT; ++d) o[d][0] = o[d][1] = o[d][2] = o[d][3] = 0.f;
  float m0 = NEG_MASK, m1 = NEG_MASK, l0 = 0.f, l1 = 0.f;
  const T* qw = q_s + (warp * 16) * LDQ;
  // bf16: the warp's Q fragments, held in registers for the whole loop
  // (f32 re-reads Q from shared memory: its split halves would not fit)
  uint32_t qf[C::F32 ? 1 : D / 16][4];
  if constexpr (!C::F32) {
    cp_async_wait<1>();                         // the Q group has landed
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < D / 16; ++kk) {
      const T* qa = qw + g * LDQ + kk * 16 + 2 * t4;
      qf[kk][0] = ld_u32(qa);
      qf[kk][1] = ld_u32(qa + 8 * LDQ);
      qf[kk][2] = ld_u32(qa + 8);
      qf[kk][3] = ld_u32(qa + 8 * LDQ + 8);
    }
  }

  for (int it = 0; it < n_tiles; ++it) {
    const int st = it & 1;
    if (it + 1 < n_tiles) {
      load_kv(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const T* ks = k_s + st * BN * LDK;
    const T* vs = v_s + st * BN * LDV;

    // ---- S = Q K^T (this warp's 16 rows x BN keys) -----------------------
    float s[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n) s[n][0] = s[n][1] = s[n][2] = s[n][3] = 0.f;
    if constexpr (C::F32) {
#pragma unroll
      for (int kk = 0; kk < D / 8; ++kk) {
        // logical k = t4 / t4 + 4 are physical d = 2 t4 / 2 t4 + 1
        const float* qa = qw + g * LDQ + kk * 8 + 2 * t4;
        const float2 x0 = *reinterpret_cast<const float2*>(qa);
        const float2 x1 = *reinterpret_cast<const float2*>(qa + 8 * LDQ);
        uint32_t ab[4], as[4];
        split_tf32(x0.x, ab[0], as[0]);
        split_tf32(x1.x, ab[1], as[1]);
        split_tf32(x0.y, ab[2], as[2]);
        split_tf32(x1.y, ab[3], as[3]);
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const float2 y = *reinterpret_cast<const float2*>(
              ks + (n * 8 + g) * LDK + kk * 8 + 2 * t4);
          uint32_t bb[2], bs[2];
          split_tf32(y.x, bb[0], bs[0]);
          split_tf32(y.y, bb[1], bs[1]);
          mma_3xtf32(s[n], ab, as, bb, bs);
        }
      }
    } else {
#pragma unroll
      for (int kk = 0; kk < D / 16; ++kk) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const T* kb = ks + (n * 8 + g) * LDK + kk * 16 + 2 * t4;
          const uint32_t bf[2] = {ld_u32(kb), ld_u32(kb + 8)};
          mma_bf16(s[n], qf[kk], bf);
        }
      }
    }

    // ---- online softmax (base 2) ------------------------------------------
    const int j0 = it * BN;
    const bool need_mask = w_end <= 0 || j0 + BN > w_end;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * p.scale_log2;
        if (need_mask)
          x = mask_score(x, j0 + n * 8 + 2 * t4 + (c & 1), c < 2 ? re0 : re1,
                         p.S);
        s[n][c] = x;
      }
    }
    float mx0 = NEG_MASK, mx1 = NEG_MASK;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      mx0 = fmaxf(mx0, fmaxf(s[n][0], s[n][1]));
      mx1 = fmaxf(mx1, fmaxf(s[n][2], s[n][3]));
    }
#pragma unroll
    for (int o_ = 1; o_ <= 2; o_ <<= 1) {     // the quad shares the rows
      mx0 = fmaxf(mx0, __shfl_xor_sync(0xffffffffu, mx0, o_));
      mx1 = fmaxf(mx1, __shfl_xor_sync(0xffffffffu, mx1, o_));
    }
    const float mn0 = fmaxf(m0, mx0), mn1 = fmaxf(m1, mx1);
    const float al0 = exp2f(m0 - mn0), al1 = exp2f(m1 - mn1);
    float ps0 = 0.f, ps1 = 0.f;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      s[n][0] = exp2f(s[n][0] - mn0);
      s[n][1] = exp2f(s[n][1] - mn0);
      s[n][2] = exp2f(s[n][2] - mn1);
      s[n][3] = exp2f(s[n][3] - mn1);
      ps0 += s[n][0] + s[n][1];
      ps1 += s[n][2] + s[n][3];
    }
    l0 = l0 * al0 + ps0;                       // per-thread partial sums
    l1 = l1 * al1 + ps1;
    m0 = mn0;
    m1 = mn1;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      o[d][0] *= al0;
      o[d][1] *= al0;
      o[d][2] *= al1;
      o[d][3] *= al1;
    }

    // ---- O += P V ------------------------------------------------------------
    if constexpr (C::F32) {
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        // the k-step is key tile n; logical k = t4 / t4 + 4 are keys
        // 2 t4 / 2 t4 + 1, which this thread's accumulator already holds
        uint32_t pb[4], pl[4];
        split_tf32(s[n][0], pb[0], pl[0]);
        split_tf32(s[n][2], pb[1], pl[1]);
        split_tf32(s[n][1], pb[2], pl[2]);
        split_tf32(s[n][3], pb[3], pl[3]);
        const float* vb = vs + (n * 8 + 2 * t4) * LDV + g;
#pragma unroll
        for (int d = 0; d < DT; ++d) {
          uint32_t bb[2], bs[2];
          split_tf32(vb[d * 8], bb[0], bs[0]);
          split_tf32(vb[LDV + d * 8], bb[1], bs[1]);
          mma_3xtf32(o[d], pb, pl, bb, bs);
        }
      }
    } else {
#pragma unroll
      for (int ks2 = 0; ks2 < BN / 16; ++ks2) {
        const uint32_t a[4] = {pack_bf16(s[2 * ks2][0], s[2 * ks2][1]),
                               pack_bf16(s[2 * ks2][2], s[2 * ks2][3]),
                               pack_bf16(s[2 * ks2 + 1][0], s[2 * ks2 + 1][1]),
                               pack_bf16(s[2 * ks2 + 1][2], s[2 * ks2 + 1][3])};
#pragma unroll
        for (int dp = 0; dp < D / 16; ++dp) {
          uint32_t r[4];
          ldmatrix_x4_trans(
              r, vs + (ks2 * 16 + (lane & 15)) * LDV + dp * 16 + (lane >> 4) * 8);
          const uint32_t b0[2] = {r[0], r[1]}, b1[2] = {r[2], r[3]};
          mma_bf16(o[2 * dp], a, b0);
          mma_bf16(o[2 * dp + 1], a, b1);
        }
      }
    }
    __syncthreads();                            // stage st is free again
  }

  // ---- normalise and write ---------------------------------------------------
#pragma unroll
  for (int o_ = 1; o_ <= 2; o_ <<= 1) {
    l0 += __shfl_xor_sync(0xffffffffu, l0, o_);
    l1 += __shfl_xor_sync(0xffffffffu, l1, o_);
  }
  const float inv0 = 1.f / l0, inv1 = 1.f / l1;
  if (LSE && t4 == 0) {
    // natural-log statistics [B, Hq, T] for the backward; a row that sees
    // no key stores -1e30, what log-sum-exp of its -1e30 logits rounds to
    float* lrow = p.lse + ((long long)b * p.Hq + h) * p.T;
    if (r0 < p.T)
      lrow[r0] = m0 == NEG_MASK ? NEG_MASK : (m0 + log2f(l0)) * LN2;
    if (r0 + 8 < p.T)
      lrow[r0 + 8] = m1 == NEG_MASK ? NEG_MASK : (m1 + log2f(l1)) * LN2;
  }
  T* orow0 = op + b * p.so_b + (long long)r0 * p.so_t + h * p.so_h;
  T* orow1 = orow0 + 8 * p.so_t;
#pragma unroll
  for (int d = 0; d < DT; ++d) {
    const int c = d * 8 + 2 * t4;
    if (r0 < p.T) store2(orow0 + c, o[d][0] * inv0, o[d][1] * inv0);
    if (r0 + 8 < p.T) store2(orow1 + c, o[d][2] * inv1, o[d][3] * inv1);
  }
}

// ---------------------------------------------------------------------------
// Decode route
// ---------------------------------------------------------------------------

template <typename T, int D>
struct DecodeCfg {
  static constexpr int VEC = 16 / (int)sizeof(T);     // elements per 16 B
  static constexpr int CH = D / VEC;                  // 16 B chunks per row
  static constexpr int LDK = D + VEC;                 // one 16 B pad per row
  static constexpr int NRG = THREADS / CH;            // P.V row groups
  static constexpr int RPT = (DEC_ROWS + NRG - 1) / NRG;  // P.V rows/thread
  static constexpr size_t smem(int stages) {
    return (size_t)stages * 2 * DEC_TK * LDK * sizeof(T)   // K, V ring
           + DEC_ROWS * D * 4                             // q (scaled, f32)
           + DEC_ROWS * DEC_TK * 4                        // p
           + 2 * DEC_ROWS * 4;                            // alpha, l
  }
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const Params p) {
  using C = DecodeCfg<T, D>;
  constexpr int TK = DEC_TK, VEC = C::VEC, CH = C::CH, LDK = C::LDK;
  constexpr int NRG = C::NRG, RPT = C::RPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stages = p.split_len > TK ? 2 : 1;
  T* k_s = reinterpret_cast<T*>(smem_raw);            // [stages][TK][LDK]
  T* v_s = k_s + stages * TK * LDK;                   // [stages][TK][LDK]
  float* q_s = reinterpret_cast<float*>(v_s + stages * TK * LDK);  // [16][D]
  float* p_s = q_s + DEC_ROWS * D;                    // [16][TK]
  float* a_s = p_s + DEC_ROWS * TK;                   // [16] rescale
  float* l_s = a_s + DEC_ROWS;                        // [16] row sums

  const int sp = blockIdx.x, hk = blockIdx.y, b = blockIdx.z;
  const int G = p.Hq / p.Hkv, R = G * p.T;            // row r: i = r / G
  const int tid = threadIdx.x, warp = tid >> 5, lane = tid & 31;

  const int q0 = p.q_start[b];
  const int kl = min(p.kv_len[b], p.S);
  const int s0 = sp * p.split_len;
  // the block's last needed key: the last row's visible end, or S when
  // the first row sees none (its -1e30 logits reach every key)
  const int need = row_end(p, q0, kl, 0) <= 0 ? p.S
                                              : row_end(p, q0, kl, p.T - 1);
  const int e = min(min(s0 + p.split_len, p.S), need);

  const long long pbase = ((long long)(b * p.Hkv + hk) * p.n_split + sp) * R;
  float* part_acc = p.part;
  float* part_ml = p.part + (long long)p.B * p.Hkv * p.n_split * R * D;
  if (e <= s0) {                                      // nothing to see here
    for (int x = tid; x < R * D; x += THREADS) part_acc[pbase * D + x] = 0.f;
    for (int r = tid; r < R; r += THREADS) {
      part_ml[2 * (pbase + r)] = NEG_MASK;
      part_ml[2 * (pbase + r) + 1] = 0.f;
    }
    return;
  }

  const T* __restrict__ qp = static_cast<const T*>(p.q);
  const T* __restrict__ kp = static_cast<const T*>(p.k);
  const T* __restrict__ vp = static_cast<const T*>(p.v);
  const long long kbase = b * p.sk_b + hk * p.sk_h;
  const long long vbase = b * p.sv_b + hk * p.sv_h;
  const int n_tiles = (e - s0 + TK - 1) / TK;
  auto load_kv = [&](int tile, int st) {
    const int j0 = s0 + tile * TK;
    for (int x = tid; x < TK * CH; x += THREADS) {
      const int r = x / CH, c = x % CH, key = j0 + r;
      const bool ok = key < e;                        // zero past the end
      const long long kk = ok ? key : s0;
      cp_async16(k_s + (st * TK + r) * LDK + c * VEC,
                 kp + kbase + kk * p.sk_s + c * VEC, ok);
      cp_async16(v_s + (st * TK + r) * LDK + c * VEC,
                 vp + vbase + kk * p.sv_s + c * VEC, ok);
    }
    cp_async_commit();
  };
  load_kv(0, 0);

  // q rows of this kv head, scaled by scale * log2(e), while tile 0 flies
  for (int x = tid; x < R * D; x += THREADS) {
    const int r = x / D, c = x % D, i = r / G, hq = hk * G + r % G;
    q_s[x] = to_f32(qp[b * p.sq_b + (long long)i * p.sq_t + hq * p.sq_h + c])
             * p.scale_log2;
  }

  float m_w[4], l_w[4];                               // rows warp + 4 k
#pragma unroll
  for (int k = 0; k < 4; ++k) {
    m_w[k] = NEG_MASK;
    l_w[k] = 0.f;
  }
  float acc[RPT][VEC];
#pragma unroll
  for (int k = 0; k < RPT; ++k)
#pragma unroll
    for (int c = 0; c < VEC; ++c) acc[k][c] = 0.f;

  const int jj = tid % TK, rg = tid / TK;             // scores: key, rows
  // P.V: thread = 16 B of columns (cv) x lane group (vg) owning rows vrow,
  // vrow + NRG, ...; when the rows leave lane groups over (R < NRG), KS =
  // NRG / R groups share a row, each taking every KS-th key, and their
  // partial sums are added once, after the last tile
  const int cv = tid % CH, vg = tid / CH;
  const int KS = R < NRG ? NRG / R : 1;
  const int kslice = R < NRG ? vg / R : 0;
  const int vrow = R < NRG ? vg % R : vg;
  const bool pv_on = R >= NRG || vg < R * KS;

  for (int it = 0; it < n_tiles; ++it) {
    const int st = stages == 2 ? it & 1 : 0;
    if (it + 1 < n_tiles) {                           // stages == 2 here
      load_kv(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = s0 + it * TK;

    // ---- scores: thread = key jj, rows rg, rg + 2, ... ---------------------
    {
      float dot[DEC_ROWS / 2];
#pragma unroll
      for (int k = 0; k < DEC_ROWS / 2; ++k) dot[k] = 0.f;
      const T* krow = k_s + (st * TK + jj) * LDK;
#pragma unroll
      for (int c = 0; c < CH; ++c) {
        float kf[VEC];
        load16(krow + c * VEC, kf);
#pragma unroll
        for (int k = 0; k < DEC_ROWS / 2; ++k) {
          const int r = rg + 2 * k;
          if (r < R) {
            const float* qr = q_s + r * D + c * VEC;
#pragma unroll
            for (int x = 0; x < VEC; x += 4) {
              const float4 q4 = *reinterpret_cast<const float4*>(qr + x);
              dot[k] = fmaf(q4.x, kf[x], dot[k]);
              dot[k] = fmaf(q4.y, kf[x + 1], dot[k]);
              dot[k] = fmaf(q4.z, kf[x + 2], dot[k]);
              dot[k] = fmaf(q4.w, kf[x + 3], dot[k]);
            }
          }
        }
      }
      const int key = j0 + jj;
#pragma unroll
      for (int k = 0; k < DEC_ROWS / 2; ++k) {
        const int r = rg + 2 * k;
        if (r < R)
          p_s[r * TK + jj] = key < e ? mask_score(dot[k], key,
                                                  row_end(p, q0, kl, r / G),
                                                  p.S)
                                     : -INFINITY;
      }
    }
    __syncthreads();

    // ---- online softmax: warp w owns rows w, w + 4, ... --------------------
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = warp + 4 * k;
      if (r < R) {
        float* pr = p_s + r * TK;
        const float x0 = pr[lane], x1 = pr[lane + 32];
        const float mn = fmaxf(m_w[k], warp_max(fmaxf(x0, x1)));
        const float al = exp2f(m_w[k] - mn);
        const float e0 = exp2f(x0 - mn), e1 = exp2f(x1 - mn);
        pr[lane] = e0;
        pr[lane + 32] = e1;
        l_w[k] = l_w[k] * al + warp_sum(e0 + e1);
        m_w[k] = mn;
        if (lane == 0) {
          a_s[r] = al;
          l_s[r] = l_w[k];
        }
      }
    }
    __syncthreads();

    // ---- acc = acc * alpha + P V: thread = 16 B of columns, rows vg + ... --
    {
      const int nk = min(TK, e - j0);
#pragma unroll
      for (int k = 0; k < RPT; ++k) {
        const int r = vrow + NRG * k;
        if (pv_on && r < R) {
          const float al = a_s[r];
#pragma unroll
          for (int c = 0; c < VEC; ++c) acc[k][c] *= al;
        }
      }
      const T* vcol = v_s + st * TK * LDK + cv * VEC;
#pragma unroll 4
      for (int j = kslice; j < nk; j += KS) {
        float vf[VEC];
        load16(vcol + j * LDK, vf);
#pragma unroll
        for (int k = 0; k < RPT; ++k) {
          const int r = vrow + NRG * k;
          if (pv_on && r < R) {
            const float pk = p_s[r * TK + j];
#pragma unroll
            for (int c = 0; c < VEC; ++c) acc[k][c] = fmaf(pk, vf[c], acc[k][c]);
          }
        }
      }
    }
    __syncthreads();                            // stage st and p_s are free
  }

  // ---- add the key slices' partial sums (the ring is free now) -------------
  if (KS > 1) {
    float* red = reinterpret_cast<float*>(smem_raw);  // [KS - 1][R][D]
    if (pv_on && kslice > 0) {
#pragma unroll
      for (int c = 0; c < VEC; ++c)
        red[((kslice - 1) * R + vrow) * D + cv * VEC + c] = acc[0][c];
    }
    __syncthreads();
    if (pv_on && kslice == 0) {
      for (int ks = 1; ks < KS; ++ks)
#pragma unroll
        for (int c = 0; c < VEC; ++c)
          acc[0][c] += red[((ks - 1) * R + vrow) * D + cv * VEC + c];
    }
  }

  // ---- write: the output itself (one split) or this split's partial ------
#pragma unroll
  for (int k = 0; k < RPT; ++k) {
    const int r = vrow + NRG * k;
    if (!pv_on || kslice > 0 || r >= R) continue;
    if (p.n_split == 1) {
      const int i = r / G, hq = hk * G + r % G;
      T* orow = static_cast<T*>(p.o) + b * p.so_b + (long long)i * p.so_t
                + hq * p.so_h + cv * VEC;
      const float inv = 1.f / l_s[r];
#pragma unroll
      for (int c = 0; c < VEC; ++c) store(orow + c, acc[k][c] * inv);
    } else {
      float* dst = part_acc + (pbase + r) * D + cv * VEC;
#pragma unroll
      for (int c = 0; c < VEC; c += 4)
        *reinterpret_cast<float4*>(dst + c) =
            make_float4(acc[k][c], acc[k][c + 1], acc[k][c + 2], acc[k][c + 3]);
    }
  }
  if (p.n_split > 1) {
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const int r = warp + 4 * k;
      if (r < R && lane == 0) {
        part_ml[2 * (pbase + r)] = m_w[k];
        part_ml[2 * (pbase + r) + 1] = l_w[k];
      }
    }
  }
}

// Merge the splits of one query row (one block per row, kv head, batch row;
// one thread per column): out = sum_s w_s acc_s / sum_s w_s l_s with
// w_s = 2^(m_s - max_s m_s), taken online so that the loads of different
// splits do not wait on each other.
template <typename T, int D>
__global__ void __launch_bounds__(D)
flash_combine_kernel(const Params p) {
  const int r = blockIdx.x, hk = blockIdx.y, b = blockIdx.z, c = threadIdx.x;
  const int G = p.Hq / p.Hkv, R = G * p.T, ns = p.n_split;
  // split s of this row is partial index base + s * R
  const long long base = (long long)(b * p.Hkv + hk) * ns * R + r;
  const float* __restrict__ acc = p.part;
  const float* __restrict__ ml = p.part + (long long)p.B * p.Hkv * ns * R * D;
  float M = ml[2 * base], L = ml[2 * base + 1], A = acc[base * D + c];
#pragma unroll 4
  for (int s = 1; s < ns; ++s) {
    const long long i = base + (long long)s * R;
    const float m = ml[2 * i], l = ml[2 * i + 1], a = acc[i * D + c];
    const float mn = fmaxf(M, m), f = exp2f(M - mn), w = exp2f(m - mn);
    L = L * f + l * w;
    A = A * f + a * w;
    M = mn;
  }
  const int i = r / G, hq = hk * G + r % G;
  store(static_cast<T*>(p.o) + b * p.so_b + (long long)i * p.so_t
            + hq * p.so_h + c, A / L);
}

// ---------------------------------------------------------------------------
// Backward (FlashAttention-2's split, on the tensor cores)
// ---------------------------------------------------------------------------
//
// The gradient of the forward's function: with P the softmax of the masked
// logits (recomputed from the saved per-row log-sum-exp), D_i = dO_i . O_i,
//   dV = P^T dO,  dP = dO V^T,  dS = P o (dP - D) (zero where the forward
//   masked: a masked logit is a constant -1e30 with no gradient),
//   dQ = scale dS K,  dK = scale dS^T Q.
// A row that sees no key has P = 1/S over all S keys (its forward output is
// the mean of V) and dS = 0; its saved statistic (-1e30) cannot give 1/S, so
// the kernels pick such rows out by their visible end instead.
//
// Bound: operations.  Per visible query-key pair the five products take
// 10 D flops (the scores recomputed, dP, dV, dK, dQ); at the training shape
// (batch 2, T = S = 1024, 32/8 heads, D 64, causal) that is 21.5 GFLOP
// against ~84 MB moved.  Three CUDA kernels per call:
//   * a pre-pass D = rowsum(dO o O) (one warp per row and head);
//   * dK/dV: one block per (64 keys, kv head, batch row), four warps of 16
//     keys; it loops over the query tiles of all Hq/Hkv query heads of its
//     group that see its keys and sums them in registers (S^T = K Q^T and
//     dP^T = V dO^T, then P^T and dS^T in place, then dV += P^T dO and
//     dK += dS^T Q): the GQA sum needs no second pass;
//   * dQ: one block per (64 query rows, query head, batch row), four warps
//     of 16 rows, looping over the key tiles its rows see (S = Q K^T,
//     dP = dO V^T, dS, dQ += dS K), longest tiles first.
// Every output element is written once by one thread, with no atomics, so
// the gradients are bitwise reproducible.  The products that sum over many
// rows or keys (dV, dK, dQ) keep the tensor core's accumulator for one
// tile only (at most 8 k-steps) and then add it into an f32 slot of its
// thread in shared memory: the tensor core's accumulation truncates, and
// kept over the 512 k-steps of the training shape's dK/dV it costs ~3e-5
// of the result; forming every k-step's product from zero instead costs a
// fifth of the time.  Tiles are staged in shared memory as f32 (bf16
// widened on the way in; pitch D + 4 keeps the scalar fragment reads of
// the dV/dK/dQ products free of bank conflicts).  The
// products run on mma.sync m16n8k8 TF32 with the forward's order trick (the
// k-step's logical indices t, t + 4 are physical 2t, 2t + 1, so the score
// accumulators are the A fragments of the next product as they stand).  An
// f32 operand is split into big + small (3xTF32: three products); a bf16
// value is exact in TF32 and goes in one part, so with bf16 inputs the
// scores and dP take one product and dV, dK, dQ (P or dS split) two.

constexpr int BWD_THREADS = 256;        // the D pre-pass: eight rows a block
constexpr int BWD_ROWS = 64;            // keys (dK/dV) or rows (dQ) a block

struct BwdParams {
  const void* q;
  const void* k;
  const void* v;
  const void* o;
  const void* dout;
  const float* lse;                     // [B, Hq, T]
  float* delta;                         // [B, Hq, T] (pre-pass output)
  void* dq;                             // [B, T, Hq, D] contiguous
  void* dk;                             // [B, S, Hkv, D] contiguous
  void* dv;
  const int* q_start;
  const int* kv_len;
  int B, T, S, Hq, Hkv;
  long long sq_b, sq_t, sq_h;           // strides in elements
  long long sk_b, sk_s, sk_h;
  long long sv_b, sv_s, sv_h;
  long long so_b, so_t, so_h;
  long long sd_b, sd_t, sd_h;           // dout
  float scale, scale_log2;
  int causal;
};

__device__ __forceinline__ int bwd_row_end(const BwdParams& p, int q0, int kl,
                                           int i) {
  return p.causal ? min(kl, q0 + i + 1) : kl;
}

// D_i = dO_i . O_i in f32: one warp per (batch row, query row, head)
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_delta_kernel(const BwdParams p) {
  const long long r = (long long)blockIdx.x * (BWD_THREADS / 32)
                      + (threadIdx.x >> 5);
  const int lane = threadIdx.x & 31;
  if (r >= (long long)p.B * p.T * p.Hq) return;
  const int h = (int)(r % p.Hq);
  const int i = (int)((r / p.Hq) % p.T);
  const int b = (int)(r / ((long long)p.Hq * p.T));
  const T* o = static_cast<const T*>(p.o) + b * p.so_b + (long long)i * p.so_t
               + h * p.so_h;
  const T* d = static_cast<const T*>(p.dout) + b * p.sd_b
               + (long long)i * p.sd_t + h * p.sd_h;
  float acc = 0.f;
#pragma unroll
  for (int c = lane; c < D; c += 32) acc = fmaf(to_f32(o[c]), to_f32(d[c]), acc);
  acc = warp_sum(acc);
  if (lane == 0) p.delta[((long long)b * p.Hq + h) * p.T + i] = acc;
}

template <typename T, int D>
struct BwdCfg {
  // bf16 values are exact in TF32: no small part
  static constexpr bool SPLIT = std::is_same<T, float>::value;
  // the loop tile: query rows (dK/dV kernel) or keys (dQ kernel)
  static constexpr int BT = D == 128 ? 32 : 64;
  static constexpr int LD = D + 4;                    // f32 tile pitch
  static constexpr int ACC = D / 8 * 4;               // sums a thread keeps
  // dK/dV: K, V, Q, dO tiles, statistics, dK and dV running sums; dQ: the
  // same tiles (Q, dO of 64 rows, K, V of BT keys), the dQ running sums
  static constexpr int SMEM_KV =
      (2 * BWD_ROWS * LD + 2 * BT * LD + 2 * BT + 2 * ACC * THREADS) * 4;
  static constexpr int SMEM_Q =
      (2 * BWD_ROWS * LD + 2 * BT * LD + 2 * BWD_ROWS + ACC * THREADS) * 4;
};

// add a thread's tile accumulators into its f32 running sums in shared
// memory (slot c * THREADS + tid: neighbouring threads, neighbouring
// words) and clear them
template <int N>
__device__ __forceinline__ void bwd_flush(float (&acc)[N][4], float* sums) {
#pragma unroll
  for (int d = 0; d < N; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) {
      sums[(d * 4 + c) * THREADS + threadIdx.x] += acc[d][c];
      acc[d][c] = 0.f;
    }
}

// rows [r0, r0 + n) of one head of a [B, L, H, D] tensor into an f32 tile
// of pitch LD, zero past ``limit``
template <typename T, int D, int LD>
__device__ __forceinline__ void bwd_stage(float* dst, const void* src,
                                          long long base, long long s_row,
                                          int r0, int n, int limit) {
  const T* sp = static_cast<const T*>(src) + base;
  for (int e = threadIdx.x; e < n * D; e += THREADS) {
    const int r = e / D, c = e % D, i = r0 + r;
    dst[r * LD + c] = i < limit ? to_f32(sp[(long long)i * s_row + c]) : 0.f;
  }
}

// the statistics of rows [r0, r0 + n) of head h: log-sum-exp in base 2 (as
// the scores) and D
__device__ __forceinline__ void bwd_stage_stats(const BwdParams& p, int b,
                                                int h, int r0, int n,
                                                float* ls, float* dls) {
  for (int r = threadIdx.x; r < n; r += THREADS) {
    const int i = r0 + r;
    const long long at = ((long long)b * p.Hq + h) * p.T + i;
    ls[r] = i < p.T ? p.lse[at] * LOG2E : 0.f;
    dls[r] = i < p.T ? p.delta[at] : 0.f;
  }
}

template <bool SPLIT>
__device__ __forceinline__ void tf32_parts(float x, uint32_t& big,
                                           uint32_t& small) {
  if constexpr (SPLIT) {
    split_tf32(x, big, small);
  } else {
    big = __float_as_uint(x);
    small = 0u;
  }
}

// c += a.b, small terms first; an operand exact in TF32 has no small part
template <bool SA, bool SB>
__device__ __forceinline__ void mma_parts(float (&c)[4],
                                          const uint32_t (&ab)[4],
                                          const uint32_t (&as)[4],
                                          const uint32_t (&bb)[2],
                                          const uint32_t (&bs)[2]) {
  if constexpr (SA) mma_tf32(c, as, bb);
  if constexpr (SB) mma_tf32(c, ab, bs);
  mma_tf32(c, ab, bb);
}

// A fragment of rows (r, r + 8) at the k-step's columns (2t, 2t + 1) of a
// row-major f32 tile
template <bool SPLIT>
__device__ __forceinline__ void a_frag(const float* row, int ld,
                                       uint32_t (&big)[4],
                                       uint32_t (&small)[4]) {
  const float2 x0 = *reinterpret_cast<const float2*>(row);
  const float2 x1 = *reinterpret_cast<const float2*>(row + 8 * ld);
  tf32_parts<SPLIT>(x0.x, big[0], small[0]);
  tf32_parts<SPLIT>(x1.x, big[1], small[1]);
  tf32_parts<SPLIT>(x0.y, big[2], small[2]);
  tf32_parts<SPLIT>(x1.y, big[3], small[3]);
}

// B fragment of a product whose B is a row-major tile's transpose: its
// row n at the k-step's columns (2t, 2t + 1)
template <bool SPLIT>
__device__ __forceinline__ void bt_frag(const float* row, uint32_t (&big)[2],
                                        uint32_t (&small)[2]) {
  const float2 y = *reinterpret_cast<const float2*>(row);
  tf32_parts<SPLIT>(y.x, big[0], small[0]);
  tf32_parts<SPLIT>(y.y, big[1], small[1]);
}

// B fragment of a product whose B is a row-major tile: rows (2t, 2t + 1)
// of the k-step at column n
template <bool SPLIT>
__device__ __forceinline__ void b_frag(const float* at, int ld,
                                       uint32_t (&big)[2],
                                       uint32_t (&small)[2]) {
  tf32_parts<SPLIT>(at[0], big[0], small[0]);
  tf32_parts<SPLIT>(at[ld], big[1], small[1]);
}

// an accumulator tile (16 x 8: c0, c1 row g; c2, c3 row g + 8; columns
// 2t, 2t + 1) as the A fragment of the next product's k-step, split
__device__ __forceinline__ void acc_frag(const float (&c)[4],
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// P and dS of one score / dP entry (row i, key j) in place
__device__ __forceinline__ void bwd_p_ds(const BwdParams& p, int q0, int kl,
                                         int i, int j, float ls, float dl,
                                         float& s, float& dp) {
  float pv = 0.f, dv = 0.f;
  if (i < p.T && j < p.S) {
    const int re = bwd_row_end(p, q0, kl, i);
    if (re <= 0) {
      pv = 1.f / (float)p.S;                  // sees no key: mean of V
    } else if (j < re) {
      pv = exp2f(s * p.scale_log2 - ls);
      dv = pv * (dp - dl);
    }
  }
  s = pv;
  dp = dv;
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dkdv_kernel(const BwdParams p) {
  using C = BwdCfg<T, D>;
  constexpr int BT = C::BT, LD = C::LD, NT = BT / 8, DT = D / 8;
  constexpr bool SPLIT = C::SPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* ks = reinterpret_cast<float*>(smem_raw);     // [64][LD]
  float* vs = ks + BWD_ROWS * LD;                     // [64][LD]
  float* qs = vs + BWD_ROWS * LD;                     // [BT][LD]
  float* dos = qs + BT * LD;                          // [BT][LD]
  float* ls = dos + BT * LD;                          // [BT]
  float* dls = ls + BT;                               // [BT]
  float* dk_sum = dls + BT;                           // [ACC][THREADS]
  float* dv_sum = dk_sum + C::ACC * THREADS;          // [ACC][THREADS]

  const int hk = blockIdx.y, b = blockIdx.z;
  const int j0 = blockIdx.x * BWD_ROWS;
  const int G = p.Hq / p.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = j0 + warp * 16;                      // this warp's keys
  const int q0 = p.q_start[b];
  const int kl = min(p.kv_len[b], p.S);

  bwd_stage<T, D, LD>(ks, p.k, b * p.sk_b + hk * p.sk_h, p.sk_s, j0,
                      BWD_ROWS, p.S);
  bwd_stage<T, D, LD>(vs, p.v, b * p.sv_b + hk * p.sv_h, p.sv_s, j0,
                      BWD_ROWS, p.S);

  float dk[DT][4], dv[DT][4];                         // keys kw + g (+ 8)
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dk[d][c] = dv[d][c] = 0.f;
  for (int c = 0; c < C::ACC; ++c)
    dk_sum[c * THREADS + threadIdx.x] = dv_sum[c * THREADS + threadIdx.x] = 0.f;

  const float* kwr = ks + (warp * 16 + g) * LD + 2 * t4;
  const float* vwr = vs + (warp * 16 + g) * LD + 2 * t4;
  const int n_qt = (p.T + BT - 1) / BT;
  for (int step = 0; step < G * n_qt; ++step) {     // query head, row tile
    const int h = hk * G + step / n_qt;
    const int i0 = step % n_qt * BT;
    const int i_last = min(i0 + BT, p.T) - 1;
    // a tile touches these keys if its last row (which sees the most
    // keys) sees one of them, or if its first row sees no key at all
    const bool idle = bwd_row_end(p, q0, kl, i0) <= 0;
    const int re_last = bwd_row_end(p, q0, kl, i_last);
    if (!idle && re_last <= j0) continue;           // the whole block
    __syncthreads();                        // the last tile's readers done
    bwd_stage<T, D, LD>(qs, p.q, b * p.sq_b + h * p.sq_h, p.sq_t, i0, BT,
                        p.T);
    bwd_stage<T, D, LD>(dos, p.dout, b * p.sd_b + h * p.sd_h, p.sd_t, i0,
                        BT, p.T);
    bwd_stage_stats(p, b, h, i0, BT, ls, dls);
    __syncthreads();
    if (kw >= p.S || (!idle && re_last <= kw)) continue;   // this warp

    // S^T = K Q^T and dP^T = V dO^T: 16 keys x BT rows
    float st[NT][4], dpt[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) st[n][c] = dpt[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      uint32_t kb[4], ksm[4], vb[4], vsm[4];
      a_frag<SPLIT>(kwr + kk * 8, LD, kb, ksm);
      a_frag<SPLIT>(vwr + kk * 8, LD, vb, vsm);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t qb[2], qsm[2], db[2], dsm[2];
        bt_frag<SPLIT>(qs + (n * 8 + g) * LD + kk * 8 + 2 * t4, qb, qsm);
        bt_frag<SPLIT>(dos + (n * 8 + g) * LD + kk * 8 + 2 * t4, db, dsm);
        mma_parts<SPLIT, SPLIT>(st[n], kb, ksm, qb, qsm);
        mma_parts<SPLIT, SPLIT>(dpt[n], vb, vsm, db, dsm);
      }
    }
    // P^T and dS^T in place
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = n * 8 + 2 * t4 + (c & 1);
        bwd_p_ds(p, q0, kl, i0 + r, kw + g + (c < 2 ? 0 : 8), ls[r],
                 dls[r], st[n][c], dpt[n][c]);
      }
    // dV += P^T dO, dK += dS^T Q: the k-steps are the row tiles n
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t pb[4], pl[4], sb[4], sl[4];
      acc_frag(st[n], pb, pl);
      acc_frag(dpt[n], sb, sl);
      const float* dor = dos + (n * 8 + 2 * t4) * LD + g;
      const float* qr = qs + (n * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t bb[2], bs[2];
        b_frag<SPLIT>(dor + d * 8, LD, bb, bs);
        mma_parts<true, SPLIT>(dv[d], pb, pl, bb, bs);
        b_frag<SPLIT>(qr + d * 8, LD, bb, bs);
        mma_parts<true, SPLIT>(dk[d], sb, sl, bb, bs);
      }
    }
    bwd_flush(dk, dk_sum);
    bwd_flush(dv, dv_sum);
  }

  T* dkp = static_cast<T*>(p.dk);
  T* dvp = static_cast<T*>(p.dv);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int j = kw + g + 8 * half;
    if (j >= p.S) continue;
    const long long row = (((long long)b * p.S + j) * p.Hkv + hk) * D;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const int c = d * 8 + 2 * t4;
      const float* ks_ = dk_sum + (d * 4 + 2 * half) * THREADS + threadIdx.x;
      const float* vs_ = dv_sum + (d * 4 + 2 * half) * THREADS + threadIdx.x;
      store2(dkp + row + c, ks_[0] * p.scale, ks_[THREADS] * p.scale);
      store2(dvp + row + c, vs_[0], vs_[THREADS]);
    }
  }
}

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_bwd_dq_kernel(const BwdParams p) {
  using C = BwdCfg<T, D>;
  constexpr int BT = C::BT, LD = C::LD, NT = BT / 8, DT = D / 8;
  constexpr bool SPLIT = C::SPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  float* qs = reinterpret_cast<float*>(smem_raw);     // [64][LD]
  float* dos = qs + BWD_ROWS * LD;                    // [64][LD]
  float* ks = dos + BWD_ROWS * LD;                    // [BT][LD]
  float* vs = ks + BT * LD;                           // [BT][LD]
  float* ls = vs + BT * LD;                           // [64]
  float* dls = ls + BWD_ROWS;                         // [64]
  float* dq_sum = dls + BWD_ROWS;                     // [ACC][THREADS]

  const int n_qt = gridDim.x;
  const int qt = n_qt - 1 - blockIdx.x;               // longest tiles first
  const int h = blockIdx.y, b = blockIdx.z;
  const int hk = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = p.q_start[b];
  const int kl = min(p.kv_len[b], p.S);
  const int i0 = qt * BWD_ROWS;
  const int iw = i0 + warp * 16;                      // this warp's rows
  // rows that see no key have dS = 0: only visible keys add to dQ
  const int n_loop = max(0, bwd_row_end(p, q0, kl,
                                        min(i0 + BWD_ROWS, p.T) - 1));
  const int w_end = iw < p.T ? bwd_row_end(p, q0, kl, min(iw + 15, p.T - 1))
                             : 0;

  bwd_stage<T, D, LD>(qs, p.q, b * p.sq_b + h * p.sq_h, p.sq_t, i0,
                      BWD_ROWS, p.T);
  bwd_stage<T, D, LD>(dos, p.dout, b * p.sd_b + h * p.sd_h, p.sd_t, i0,
                      BWD_ROWS, p.T);
  bwd_stage_stats(p, b, h, i0, BWD_ROWS, ls, dls);

  float dq[DT][4];                                    // rows iw + g (+ 8)
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[d][c] = 0.f;
  for (int c = 0; c < C::ACC; ++c) dq_sum[c * THREADS + threadIdx.x] = 0.f;
  const float* qwr = qs + (warp * 16 + g) * LD + 2 * t4;
  const float* dwr = dos + (warp * 16 + g) * LD + 2 * t4;
  const int r0 = warp * 16 + g;

  for (int j0 = 0; j0 < n_loop; j0 += BT) {
    __syncthreads();                          // the last tile's readers done
    bwd_stage<T, D, LD>(ks, p.k, b * p.sk_b + hk * p.sk_h, p.sk_s, j0, BT,
                        p.S);
    bwd_stage<T, D, LD>(vs, p.v, b * p.sv_b + hk * p.sv_h, p.sv_s, j0, BT,
                        p.S);
    __syncthreads();
    if (j0 >= w_end) continue;                // this warp's rows see none

    // S = Q K^T and dP = dO V^T: 16 rows x BT keys
    float s[NT][4], dpm[NT][4];
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) s[n][c] = dpm[n][c] = 0.f;
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      uint32_t qb[4], qsm[4], db[4], dsm[4];
      a_frag<SPLIT>(qwr + kk * 8, LD, qb, qsm);
      a_frag<SPLIT>(dwr + kk * 8, LD, db, dsm);
#pragma unroll
      for (int n = 0; n < NT; ++n) {
        uint32_t kb[2], ksm[2], vb[2], vsm[2];
        bt_frag<SPLIT>(ks + (n * 8 + g) * LD + kk * 8 + 2 * t4, kb, ksm);
        bt_frag<SPLIT>(vs + (n * 8 + g) * LD + kk * 8 + 2 * t4, vb, vsm);
        mma_parts<SPLIT, SPLIT>(s[n], qb, qsm, kb, ksm);
        mma_parts<SPLIT, SPLIT>(dpm[n], db, dsm, vb, vsm);
      }
    }
    // dS in place (in dpm); the scores' registers are free after
#pragma unroll
    for (int n = 0; n < NT; ++n)
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        const int r = r0 + (c < 2 ? 0 : 8);
        bwd_p_ds(p, q0, kl, i0 + r, j0 + n * 8 + 2 * t4 + (c & 1), ls[r],
                 dls[r], s[n][c], dpm[n][c]);
      }
    // dQ += dS K: the k-steps are the key tiles n
#pragma unroll
    for (int n = 0; n < NT; ++n) {
      uint32_t sb[4], sl[4];
      acc_frag(dpm[n], sb, sl);
      const float* kr = ks + (n * 8 + 2 * t4) * LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        uint32_t bb[2], bs[2];
        b_frag<SPLIT>(kr + d * 8, LD, bb, bs);
        mma_parts<true, SPLIT>(dq[d], sb, sl, bb, bs);
      }
    }
    bwd_flush(dq, dq_sum);
  }

  T* dqp = static_cast<T*>(p.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = iw + g + 8 * half;
    if (i >= p.T) continue;
    const long long row = (((long long)b * p.T + i) * p.Hq + h) * D;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      const float* qs_ = dq_sum + (d * 4 + 2 * half) * THREADS + threadIdx.x;
      store2(dqp + row + d * 8 + 2 * t4, qs_[0] * p.scale,
             qs_[THREADS] * p.scale);
    }
  }
}

template <typename T, int D>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  using C = BwdCfg<T, D>;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_KV);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_Q);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long rows = (long long)p.B * p.T * p.Hq;
  const int per = BWD_THREADS / 32;
  flash_bwd_delta_kernel<T, D>
      <<<(unsigned)((rows + per - 1) / per), BWD_THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gkv((p.S + BWD_ROWS - 1) / BWD_ROWS, p.Hkv, p.B);
  flash_bwd_dkdv_kernel<T, D><<<gkv, THREADS, C::SMEM_KV, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq((p.T + BWD_ROWS - 1) / BWD_ROWS, p.Hq, p.B);
  flash_bwd_dq_kernel<T, D><<<gq, THREADS, C::SMEM_Q, stream>>>(p);
  return cudaGetLastError();
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D, bool LSE>
cudaError_t launch_prefill(const Params& p, cudaStream_t stream) {
  using C = PrefillCfg<T, D>;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T, D, LSE>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(p.Hq, p.B, (p.T + C::BM - 1) / C::BM);
  flash_prefill_kernel<T, D, LSE><<<grid, THREADS, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const Params& p, cudaStream_t stream) {
  using C = DecodeCfg<T, D>;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, (int)C::smem(2));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const size_t smem = C::smem(p.split_len > DEC_TK ? 2 : 1);
  flash_decode_kernel<T, D>
      <<<dim3(p.n_split, p.Hkv, p.B), THREADS, smem, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess || p.n_split == 1) return err;
  const int rows = p.T * (p.Hq / p.Hkv);
  flash_combine_kernel<T, D><<<dim3(rows, p.Hkv, p.B), D, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch(const Params& p, cudaStream_t stream) {
  if (p.n_split > 0) return launch_decode<T, D>(p, stream);
  return p.lse != nullptr ? launch_prefill<T, D, true>(p, stream)
                          : launch_prefill<T, D, false>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16.  n_split = 0 takes the prefill route;
// n_split > 0 the decode route, with keys cut into n_split ranges of
// split_len (a multiple of 64, n_split * split_len >= S, n_split <= 64,
// T * Hq / Hkv <= 16) and, when n_split > 1, ``workspace`` holding
// B * Hkv * n_split * (T * Hq / Hkv) * (D + 2) floats.  A non-null ``lse``
// (prefill route only) receives the per-row natural-log log-sum-exp of the
// masked logits, f32 [B, Hq, T] contiguous.  q/k/v rows and their strides
// must be 16-byte aligned.  Returns a cudaError_t (0 = success); the
// launches are asynchronous on ``stream`` and allocate nothing.
int flash_attention_fwd(const void* q, const void* k, const void* v, void* o,
                        const void* q_start, const void* kv_len,
                        int B, int T, int S, int Hq, int Hkv, int D, int dtype,
                        long long sq_b, long long sq_t, long long sq_h,
                        long long sk_b, long long sk_s, long long sk_h,
                        long long sv_b, long long sv_s, long long sv_h,
                        long long so_b, long long so_t, long long so_h,
                        float scale, int causal, int n_split, int split_len,
                        void* workspace, void* lse, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  if (n_split > 0 &&
      (T * (Hq / Hkv) > DEC_ROWS || n_split > DEC_MAX_SPLITS ||
       split_len <= 0 || split_len % DEC_TK != 0 ||
       (long long)n_split * split_len < S ||
       (n_split > 1 && workspace == nullptr) || lse != nullptr))
    return (int)cudaErrorInvalidValue;
  Params p{q, k, v, o,
           static_cast<const int*>(q_start), static_cast<const int*>(kv_len),
           static_cast<float*>(workspace), static_cast<float*>(lse),
           B, T, S, Hq, Hkv, n_split, split_len,
           sq_b, sq_t, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h,
           so_b, so_t, so_h, scale * LOG2E, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 32) return (int)launch<float, 32>(p, st);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(p, st);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(p, st);
  if (dtype == 1 && D == 32) return (int)launch<__nv_bfloat16, 32>(p, st);
  if (dtype == 1 && D == 64) return (int)launch<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return (int)launch<__nv_bfloat16, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: dq [B,T,Hq,D], dk/dv [B,S,Hkv,D] (contiguous, in q's
// dtype) from q/k/v, the forward's output o and the output gradient dout
// (strided like q), the forward's ``lse`` (f32 [B,Hq,T] contiguous) and
// ``delta``, an f32 [B,Hq,T] scratch.  Three CUDA kernels on ``stream``;
// returns a cudaError_t (0 = success) and allocates nothing.

int flash_attention_bwd(const void* q, const void* k, const void* v,
                        const void* o, const void* dout, const void* lse,
                        void* delta, void* dq, void* dk, void* dv,
                        const void* q_start, const void* kv_len,
                        int B, int T, int S, int Hq, int Hkv, int D, int dtype,
                        long long sq_b, long long sq_t, long long sq_h,
                        long long sk_b, long long sk_s, long long sk_h,
                        long long sv_b, long long sv_s, long long sv_h,
                        long long so_b, long long so_t, long long so_h,
                        long long sd_b, long long sd_t, long long sd_h,
                        float scale, int causal, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0)
    return (int)cudaErrorInvalidValue;
  BwdParams p{q, k, v, o, dout,
              static_cast<const float*>(lse), static_cast<float*>(delta),
              dq, dk, dv,
              static_cast<const int*>(q_start), static_cast<const int*>(kv_len),
              B, T, S, Hq, Hkv,
              sq_b, sq_t, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h,
              so_b, so_t, so_h, sd_b, sd_t, sd_h,
              scale, scale * LOG2E, causal};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 32) return (int)launch_bwd<float, 32>(p, st);
  if (dtype == 0 && D == 64) return (int)launch_bwd<float, 64>(p, st);
  if (dtype == 0 && D == 128) return (int)launch_bwd<float, 128>(p, st);
  if (dtype == 1 && D == 32) return (int)launch_bwd<__nv_bfloat16, 32>(p, st);
  if (dtype == 1 && D == 64) return (int)launch_bwd<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return (int)launch_bwd<__nv_bfloat16, 128>(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
