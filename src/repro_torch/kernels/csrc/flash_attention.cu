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
// model's attention computes (repro/models/layers.py::attend):
//   q [B,T,Hq,D], k/v [B,S,Hkv,D] (D = 32, 64, 128 or 256), read in place
//   through strides;
//   GQA by head index: query head h reads kv head h / (Hq / Hkv);
//   per-row q_start[b] and kv_len[b] (int32 device arrays), and a sliding
//   window w per call (0 = global);
//   key j is visible to query row i iff j < kv_len[b], when causal
//   j <= q_start[b] + i, and when w > 0 j > q_start[b] + i - w: a row sees
//   the keys [row_start, row_end), both non-decreasing in i, so the rows
//   that see none are a prefix and/or a suffix of the rows;  masked logits
//   are -1e30 (finite), so a row that sees no key at all averages V over
//   all S keys, as the reference does;
//   f32 scores, running max / sum / accumulator; output in q's dtype.
//
// The window bounds every route's work by what the rows see: at most
// w + (tile rows - 1) keys a query tile instead of up to S, so a causal
// call's operations fall from ~T S / 2 to ~T w pairs (at T = S = 4096,
// w = 512: 0.23x) and the decode route's bytes from the whole cache to
// the last w keys (S 1056 at gemma3's decode: 4.2 of 8.7 MB a layer).
// The prefill route's and the backward's kernels are built with and
// without the window (template WIN) and a call without one runs the
// WIN = false kernels: with the window's bounds compiled in, nvcc gave
// the f32 D = 64 prefill kernel 133 registers instead of 157, and it ran
// 38% slower on an H100.
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
// log-sum-exp rescaling.  A split starts at the first key some row of its
// block sees (so under a window a split wholly before it loads nothing)
// and ends at the last; a split outside a row's visible keys reports (max
// -1e30, sum 0) and adds no mass; a row that sees no key takes -1e30
// logits in every split, so the merge averages V over all S keys.  At
// D = 256 in f32 the K/V ring has one slot (two would need 266 KB).
//
// Prefill route (tensor cores, cp.async double buffering).  At T = 512 the
// call is bound by its operations.  One block per (64 query rows, query
// head, batch row), four warps of 16 rows each (FlashAttention-2 style);
// blocks are issued longest-first (the last query tile, which sees the
// most keys under the causal mask, first) so the diagonal's unequal work
// does not leave SMs idle at the tail (under a window the work is nearly
// uniform and the order does not matter).  K/V tiles of 64 keys (32 for
// f32 at head_dim 128 and 256) stream through a two-stage cp.async ring;
// the kv loop starts at the tile of the first row's first visible key and
// ends at the last row's last one.  At D = 256 a warp's f32 accumulator
// alone is 128 registers a thread, so bf16 reads its Q fragments from
// shared memory as f32 always does.  Q.K^T and P.V run on the tensor
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
// to the full tensor-core rate.  The D = 256 backward's sums already run
// on wgmma, transposed so that no operand is stored transposed (Bwd256).
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
  int window;                           // sliding window; 0 = global
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

// keys row i may see: [row_start, row_end) (kl = min(kv_len, S)); an empty
// range means the row sees none and, as in the reference, averages V over
// all S keys.  P is Params or BwdParams.  WIN = false compiles the window
// out (row_start is 0): the prefill and backward kernels are instantiated
// both ways and a call without a window takes the WIN = false kernels,
// whose code is what it was before the window.
template <class P>
__device__ __forceinline__ int row_end(const P& p, int q0, int kl, int i) {
  return p.causal ? min(kl, q0 + i + 1) : kl;
}
template <bool WIN = true, class P>
__device__ __forceinline__ int row_start(const P& p, int q0, int i) {
  return WIN && p.window > 0 ? max(0, q0 + i - p.window + 1) : 0;
}
template <bool WIN = true, class P>
__device__ __forceinline__ bool row_idle(const P& p, int q0, int kl, int i) {
  return row_start<WIN>(p, q0, i) >= row_end(p, q0, kl, i);
}
// the score of key ``key`` for a row that sees [rs, re): its value if
// visible, -1e30 for every key < S of a row that sees none, else -inf (no
// weight at all, which is what -1e30 gives beside a finite logit)
template <bool WIN = true>
__device__ __forceinline__ float mask_score(float s, int key, int rs, int re,
                                            int S) {
  if (rs < re) return (!WIN || key >= rs) && key < re ? s : -INFINITY;
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
  static constexpr int BN = (F32 && D >= 128) ? 32 : 64;  // keys per tile
  // bf16 holds the warp's Q fragments in registers up to D = 128
  static constexpr bool HOLDQ = !F32 && D <= 128;
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
// serving path's kernel is the one without the epilogue); WIN: a sliding
// window (row_start)
template <typename T, int D, bool LSE, bool WIN>
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
  // the tile's keys run from its first row's start to its last row's end;
  // a tile with a row that sees none (its first or last: such rows are a
  // prefix and/or a suffix) needs every key (its -1e30 logits)
  int k_lo = row_start<WIN>(p, q0, i_first);
  int k_hi = row_end(p, q0, kl, i_last);
  if (row_idle<WIN>(p, q0, kl, i_first) || row_idle<WIN>(p, q0, kl, i_last)) {
    k_lo = 0;
    k_hi = p.S;
  }
  const int t_lo = k_lo / BN;
  const int n_tiles = (k_hi + BN - 1) / BN - t_lo;

  // this thread's two rows, and the warp's first row (fewest keys, the
  // earliest end) and last (the latest start)
  const int r0 = i_first + warp * 16 + g;
  const int rs0 = row_start<WIN>(p, q0, r0), re0 = row_end(p, q0, kl, r0);
  const int rs1 = row_start<WIN>(p, q0, r0 + 8);
  const int re1 = row_end(p, q0, kl, r0 + 8);
  const int wf = i_first + warp * 16;
  const int w_end = row_end(p, q0, kl, wf);
  const int w_start = row_start<WIN>(p, q0, wf + 15);
  const bool w_idle = row_idle<WIN>(p, q0, kl, wf)
                      || row_idle<WIN>(p, q0, kl, wf + 15);

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
    const int j0 = (t_lo + tile) * BN;
    for (int e = tid; e < BN * CH; e += THREADS) {
      const int r = e / CH, c = e % CH, key = j0 + r;
      const bool ok = key < k_hi;                     // zero past the end
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
  // bf16 up to D = 128: the warp's Q fragments, held in registers for the
  // whole loop (f32 re-reads Q from shared memory: its split halves would
  // not fit; so does bf16 at D = 256 beside its 128-register accumulator)
  uint32_t qf[C::HOLDQ ? D / 16 : 1][4];
  if constexpr (C::HOLDQ) {
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
        uint32_t qa[4];
        if constexpr (C::HOLDQ) {
#pragma unroll
          for (int c = 0; c < 4; ++c) qa[c] = qf[kk][c];
        } else {
          const T* qr = qw + g * LDQ + kk * 16 + 2 * t4;
          qa[0] = ld_u32(qr);
          qa[1] = ld_u32(qr + 8 * LDQ);
          qa[2] = ld_u32(qr + 8);
          qa[3] = ld_u32(qr + 8 * LDQ + 8);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const T* kb = ks + (n * 8 + g) * LDK + kk * 16 + 2 * t4;
          const uint32_t bf[2] = {ld_u32(kb), ld_u32(kb + 8)};
          mma_bf16(s[n], qa, bf);
        }
      }
    }

    // ---- online softmax (base 2) ------------------------------------------
    const int j0 = (t_lo + it) * BN;
    const bool need_mask = w_idle || (WIN && j0 < w_start) || j0 + BN > w_end;
#pragma unroll
    for (int n = 0; n < NT; ++n) {
#pragma unroll
      for (int c = 0; c < 4; ++c) {
        float x = s[n][c] * p.scale_log2;
        if (need_mask)
          x = mask_score<WIN>(x, j0 + n * 8 + 2 * t4 + (c & 1),
                              c < 2 ? rs0 : rs1, c < 2 ? re0 : re1, p.S);
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
  // a two-slot ring where it fits a block's 232,448 bytes (not f32 at
  // D = 256: 286,848)
  static constexpr int MAX_STAGES = smem(2) <= 232448 ? 2 : 1;
};

template <typename T, int D>
__global__ void __launch_bounds__(THREADS)
flash_decode_kernel(const Params p) {
  using C = DecodeCfg<T, D>;
  constexpr int TK = DEC_TK, VEC = C::VEC, CH = C::CH, LDK = C::LDK;
  constexpr int NRG = C::NRG, RPT = C::RPT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  const int stages = p.split_len > TK ? C::MAX_STAGES : 1;
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
  // the block's keys: from the first row's start to the last row's end,
  // or all S when a row sees none (its -1e30 logits reach every key)
  int lo = row_start(p, q0, 0), hi = row_end(p, q0, kl, p.T - 1);
  if (row_idle(p, q0, kl, 0) || row_idle(p, q0, kl, p.T - 1)) {
    lo = 0;
    hi = p.S;
  }
  const int sb = max(s0, lo);                         // this split's keys:
  const int e = min(min(s0 + p.split_len, p.S), hi);  // [sb, e)

  const long long pbase = ((long long)(b * p.Hkv + hk) * p.n_split + sp) * R;
  float* part_acc = p.part;
  float* part_ml = p.part + (long long)p.B * p.Hkv * p.n_split * R * D;
  if (e <= sb) {                                      // nothing to see here
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
  const int n_tiles = (e - sb + TK - 1) / TK;
  auto load_kv = [&](int tile, int st) {
    const int j0 = sb + tile * TK;
    for (int x = tid; x < TK * CH; x += THREADS) {
      const int r = x / CH, c = x % CH, key = j0 + r;
      const bool ok = key < e;                        // zero past the end
      const long long kk = ok ? key : sb;
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
    if (stages == 2 && it + 1 < n_tiles) {
      load_kv(it + 1, st ^ 1);
      cp_async_wait<1>();
    } else {
      cp_async_wait<0>();
    }
    __syncthreads();
    const int j0 = sb + it * TK;

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
                                                  row_start(p, q0, r / G),
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
    if (stages == 1 && it + 1 < n_tiles) load_kv(it + 1, 0);
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
// against ~84 MB moved.  Three CUDA kernels per call (four at D = 256,
// whose kernels follow these):
//   * a pre-pass D = rowsum(dO o O) (16-byte loads, a few lanes a row);
//   * dK/dV: one block per (BS keys, kv head, batch row), walking the query
//     tiles of all Hq/Hkv query heads of its group that see its keys (S^T =
//     K Q^T and dP^T = V dO^T, then P^T and dS^T in place, then dV += P^T dO
//     and dK += dS^T Q), so the GQA sum needs no second pass.  Blocks are
//     issued key tile 0 first: under the causal mask every query tile sees
//     it and the fewest see the last one, so the longest blocks start first
//     and the short ones fill the tail (on an H100 at the training shape
//     this took the kernel from 726 to 465 us against the natural order);
//   * dQ: one block per (BS query rows, query head, batch row), walking the
//     key tiles its rows see (S = Q K^T, dP = dO V^T, dS, dQ += dS K),
//     longest tiles first.  S and dP are computed a second time here: dQ
//     partials written per key tile would move more bytes than the
//     recompute costs, and atomics would lose bitwise reproducibility.
// Every output element is written once, with no atomics, so the gradients
// are bitwise reproducible.
//
// Hopper design (mma.sync m16n8k8 TF32 and cp.async):
//   * Operand planes.  A tile is split once, by one pass over it when it
//     lands, into TF32 planes in shared memory: big = x rounded to TF32 and
//     small = x - big, for the forward's split-precision products (3xTF32:
//     big*big + big*small + small*big); a bf16 value is exact in TF32 and
//     has only its big plane.  The inner loops load fragments and issue
//     mma.sync, nothing else: ldmatrix for operands read along rows (the A
//     fragments of K, V, Q, dO and the B fragments of Q^T, dO^T, K^T, V^T;
//     the b16 ldmatrix hands each lane one 32-bit word, which is the TF32
//     fragment), 32-bit loads for B fragments read down columns (dO and Q
//     in dV += P^T dO and dK += dS^T Q, K in dQ += dS K).  The pitch D + 4
//     words keeps both free of bank conflicts: an ldmatrix's 8 rows fall on
//     8 distinct groups of 4 banks, and a column read's rows (2t, 2t + 1)
//     by columns g cover the 32 banks.
//   * The stationary tiles (K and V in dK/dV; Q, dO and their statistics in
//     dQ) land and are split once, at block start.  The streamed tiles (Q,
//     dO and their statistics in dK/dV; K and V in dQ) pass through a ring
//     of STAGES slots by 16-byte cp.async (4-byte for the statistics): the
//     copies of step it + STAGES - 1 go out before step it's products, and
//     each thread splits the chunks it copied itself as soon as they have
//     landed (cp.async.wait_group makes a thread's own copies visible to
//     it), so one barrier a step publishes the new planes and frees the
//     slot of the step before.
//   * Warps.  dK/dV: each group of 16 MK keys (MK = 2 m16 tiles up to
//     D = 64, so every B fragment loaded feeds two products) has, for each
//     of WT = 2 streamed row halves (RT rows a step), a pair of warps: role
//     0 forms S^T and P^T and adds dV += P^T dO, role 1 forms dP^T, takes
//     P^T from its partner through shared memory (a named barrier for the
//     pair), forms dS^T and adds dK += dS^T Q; each warp keeps one output's
//     sums.  The two pairs of a key group sum disjoint rows; at the end one
//     adds the other's partial, handed over in the idle ring, and writes
//     (the same bits whichever adds).  dQ: a warp takes 16 rows and forms
//     S, dP, dS and dQ += dS K itself; at D = 64 a block takes 128 rows and
//     a warp all 32 keys of a step (each K/V tile then serves 128 rows),
//     elsewhere two warps split a row group's keys as in dK/dV; up to
//     D = 64 the big planes of a warp's Q and dO fragments stay in
//     registers for the whole loop.
//   * A step whose rows are all valid and see all the warp's keys takes a
//     branch-free path (no mask, no check for rows that see no key); on an
//     H100 the per-element mask branch had cost ~11% of the dQ kernel.
//   * Accuracy: the tensor core's accumulation truncates (kept over the 512
//     k-steps of the training shape's dK/dV it costs ~3e-5 of the result),
//     so the products that sum over many rows or keys (dV, dK, dQ) form
//     each step's RT / 8 k-steps in a fresh accumulator and add it into f32
//     sums held in registers.  With bf16 inputs, P and dS are rounded to
//     TF32 for their products (one TF32 pass; f32 splits them).
//   * Tiles and shared memory, in 4-byte words (bf16 rows land raw in the
//     small plane, which bf16 does not otherwise use): the stationary planes
//     4 x BS x (D + 4) and their statistics 2 BS, the ring STAGES x (4 x BT
//     x (D + 4) + 2 BT), and in dK/dV the pairs' hand-over.  D = 64: dK/dV
//     BS 64 keys, BT 32 rows, three slots, 8 warps, 191,744 bytes; dQ 128
//     rows, BT 32 keys, two slots, 8 warps, 210,432 bytes; one block an SM.
//     D = 32: BS 64, BT 32, 8 warps, 109,824 and 93,440 bytes, two blocks an
//     SM.  D = 128: BS 32, BT 16, 8 and 4 warps, 171,648 and 169,600 bytes,
//     one block an SM.  D = 256 has kernels of its own (Bwd256 below).
//   * The window.  A row sees [row_start, row_end), both non-decreasing in
//     the row, so the rows that see a key tile are one range, and the rows
//     that see none a prefix and/or a suffix: dK/dV walks the query tiles
//     of those three ranges only, dQ the key tiles from its first seeing
//     row's start to its last one's end.

constexpr int BWD_THREADS = 256;        // the D pre-pass

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
  int window;                           // sliding window; 0 = global
  float* ws;                            // D = 256: dV, dK partials per part
};

// the first t in [0, n) with pred(t), n if none; pred is monotone (false
// for a prefix, then true)
template <typename F>
__device__ __forceinline__ int bwd_first(int n, F pred) {
  int lo = 0, hi = n;
  while (lo < hi) {
    const int mid = (lo + hi) / 2;
    if (pred(mid)) hi = mid; else lo = mid + 1;
  }
  return lo;
}

// D_i = dO_i . O_i in f32: LPR lanes per (batch row, query row, head),
// 16 bytes each, PER times (neighbouring lanes on neighbouring bytes),
// heads fastest
template <typename T, int D>
struct DeltaCfg {
  static constexpr int VEC = 16 / (int)sizeof(T), CHUNKS = D / VEC;
  static constexpr int LPR = CHUNKS < 32 ? CHUNKS : 32, PER = CHUNKS / LPR;
};
template <typename T, int D>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_delta_kernel(const BwdParams p) {
  using C = DeltaCfg<T, D>;
  constexpr int VEC = C::VEC, LPR = C::LPR;
  const long long r =
      ((long long)blockIdx.x * BWD_THREADS + threadIdx.x) / LPR;
  const int c = (threadIdx.x % LPR) * VEC;
  const bool ok = r < (long long)p.B * p.T * p.Hq;
  const int h = (int)(r % p.Hq);
  const int i = (int)((r / p.Hq) % p.T);
  const int b = (int)(r / ((long long)p.Hq * p.T));
  float acc = 0.f;
  if (ok) {
#pragma unroll
    for (int k = 0; k < C::PER; ++k) {
      float x[VEC], y[VEC];
      const int cc = c + k * LPR * VEC;
      load16(static_cast<const T*>(p.o) + b * p.so_b + (long long)i * p.so_t
                 + h * p.so_h + cc, x);
      load16(static_cast<const T*>(p.dout) + b * p.sd_b
                 + (long long)i * p.sd_t + h * p.sd_h + cc, y);
#pragma unroll
      for (int e = 0; e < VEC; ++e) acc = fmaf(x[e], y[e], acc);
    }
  }
#pragma unroll
  for (int o = LPR / 2; o > 0; o >>= 1)
    acc += __shfl_xor_sync(0xffffffffu, acc, o);
  if (ok && c == 0) p.delta[((long long)b * p.Hq + h) * p.T + i] = acc;
}

// D <= 128 (D = 256 has its own kernels, Bwd256 below)
template <typename T, int D>
struct BwdCfg {
  static_assert(D <= 128, "D = 256 takes the Bwd256 kernels");
  static constexpr bool SPLIT = std::is_same<T, float>::value;  // small planes
  static constexpr int BS = D == 128 ? 32 : 64;  // stationary
  static constexpr int MK = D >= 128 ? 1 : 2;    // m16 tiles a warp holds
  static constexpr int WK = BS / (16 * MK);      // warp groups along them
  static constexpr int WT = 2;                   // warps along streamed rows
  static constexpr int RT = D >= 128 ? 8 : 16;   // streamed rows a warp, a step
  static constexpr int NT = RT / 8;
  static constexpr int BT = RT * WT;             // streamed rows a step
  static constexpr int PAIRS = WK * WT;          // two warps (roles) a pair
  static constexpr int NTH = 2 * 32 * PAIRS;     // dK/dV

  static constexpr int MIN_BLOCKS = D == 32 ? 2 : 1;
  static constexpr int STAGES = 3;
  static constexpr int LD = D + 4;               // plane pitch, words
  static constexpr int PS = BS * LD;             // words of a stationary plane
  static constexpr int PT = BT * LD;             // words of a streamed plane
  // a ring slot: two matrices' big and small planes, then lse and D rows
  static constexpr int SLOT = 4 * PT + 2 * BT;
  // the stationary planes and statistics come first, then the ring, then
  // the pairs' hand-over of P (and dS)
  static constexpr int RING = 4 * PS + 2 * BS;
  static constexpr int XB = PAIRS * MK * NT * 4 * 32;
  static constexpr int SMEM = (RING + STAGES * SLOT + XB) * 4;
  // dQ: 16 rows a warp; at D = 64 a block takes 128 rows (each K/V tile
  // then serves twice the rows) and a warp all of a step's keys, in two
  // ring slots (its planes fill 210 KB); elsewhere BS rows and two warps a
  // row group (D = 32 keeps two blocks an SM within 128 registers)
  static constexpr int BS_Q = D == 64 ? 128 : BS;
  static constexpr int WT_Q = D == 64 ? 1 : 2;
  static constexpr int RT_Q = BT / WT_Q, NT_Q = RT_Q / 8;
  static constexpr int NTH_Q = 32 * BS_Q / 16 * WT_Q;
  static constexpr int STAGES_Q = D == 64 ? 2 : 3;
  static constexpr int SMEM_Q = (4 * BS_Q * LD + 2 * BS_Q + STAGES_Q * SLOT) * 4;
  static_assert(WT == 2, "the final sums pair two warps");
  static_assert(BS / 16 * 32 * D <= STAGES * SLOT,
                "the partial sums fit the ring");
};

// 4-byte async copy (a statistics row need not start 16-byte aligned);
// when !pred nothing is read and the word is zeroed
__device__ __forceinline__ void cp_async4(void* dst, const void* src,
                                          bool pred) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4, %2;\n"
               :: "r"(smem_u32(dst)), "l"(src), "r"(pred ? 4 : 0));
}
__device__ __forceinline__ void ldsm_x4(uint32_t (&r)[4], uint32_t addr) {
  asm volatile(
      "ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
      : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}
__device__ __forceinline__ void ldsm_x2(uint32_t (&r)[2], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x2.shared.b16 {%0,%1}, [%2];\n"
               : "=r"(r[0]), "=r"(r[1]) : "r"(addr));
}
// d = a.b from a zero accumulator
__device__ __forceinline__ void mma_tf32_z(float (&d)[4],
                                           const uint32_t (&a)[4],
                                           const uint32_t (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%10,%10,%10,%10};\n"
      : "=f"(d[0]), "=f"(d[1]), "=f"(d[2]), "=f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]),
        "f"(0.f));
}
// the first k-step of a fresh accumulator starts from zero
template <bool FIRST>
__device__ __forceinline__ void mma_step(float (&d)[4], const uint32_t (&a)[4],
                                         const uint32_t (&b)[2]) {
  if constexpr (FIRST) mma_tf32_z(d, a, b); else mma_tf32(d, a, b);
}

// ldmatrix row addresses, in words from a tile's first row and column: the
// A fragment of 16 rows x 8 columns (registers a0..a3), and the B fragment
// of 8 rows x 8 columns in both planes (big b0, b1, then small b0, b1, the
// small plane ``plane`` words on; bf16's x2 load reads the first two)
__device__ __forceinline__ int lane_a(int lane, int ld) {
  return ((lane & 7) + ((lane >> 3) & 1) * 8) * ld + (lane >> 4) * 4;
}
__device__ __forceinline__ int lane_b(int lane, int ld, int plane) {
  return (lane & 7) * ld + ((lane >> 3) & 1) * 4 + (lane >> 4) * plane;
}

// Copy the N rows of a tile (``src`` at its first row, rows ``s_row``
// apart; rows at or past ``n_ok`` are zero) into a plane pair by 16-byte
// cp.async: f32 rows land in the big plane, bf16 rows (D / 2 words) at the
// start of the small plane's rows.  Thread tid takes chunks tid, tid + NTH,
// ..., and bwd_split the same ones.
template <typename T, int D, int LD, int N, int NTH>
__device__ __forceinline__ void bwd_copy(uint32_t* big, uint32_t* small,
                                         const T* src, long long s_row,
                                         int n_ok) {
  constexpr int VEC = 16 / (int)sizeof(T), CH = D / VEC;
  uint32_t* land = std::is_same<T, float>::value ? big : small;
#pragma unroll
  for (int k = 0; k < (N * CH + NTH - 1) / NTH; ++k) {
    const int e = threadIdx.x + k * NTH;
    if (N * CH % NTH == 0 || e < N * CH) {
      const int r = e / CH, c = e % CH;
      const bool ok = r < n_ok;
      cp_async16(land + r * LD + c * 4, src + (ok ? r * s_row + c * VEC : 0),
                 ok);
    }
  }
}

// The split pass over this thread's chunks of a landed tile (bwd_copy's):
// f32 x becomes big (in place) and small; bf16 widens into the big plane
// (a bf16 is the top half of its f32)
template <typename T, int D, int LD, int N, int NTH>
__device__ __forceinline__ void bwd_split(uint32_t* big, uint32_t* small) {
  constexpr int VEC = 16 / (int)sizeof(T), CH = D / VEC;
#pragma unroll
  for (int k = 0; k < (N * CH + NTH - 1) / NTH; ++k) {
    const int e = threadIdx.x + k * NTH;
    if (e < N * CH) {
      const int r = e / CH, c = e % CH;
      if constexpr (std::is_same<T, float>::value) {
        uint4* at = reinterpret_cast<uint4*>(big + r * LD + c * 4);
        const uint4 x = *at;
        uint4 hi, lo;
        split_tf32(__uint_as_float(x.x), hi.x, lo.x);
        split_tf32(__uint_as_float(x.y), hi.y, lo.y);
        split_tf32(__uint_as_float(x.z), hi.z, lo.z);
        split_tf32(__uint_as_float(x.w), hi.w, lo.w);
        *at = hi;
        *reinterpret_cast<uint4*>(small + r * LD + c * 4) = lo;
      } else {
        const uint4 x = *reinterpret_cast<const uint4*>(small + r * LD + c * 4);
        uint4* at = reinterpret_cast<uint4*>(big + r * LD + c * 8);
        at[0] = make_uint4(x.x << 16, x.x & 0xffff0000u, x.y << 16,
                           x.y & 0xffff0000u);
        at[1] = make_uint4(x.z << 16, x.z & 0xffff0000u, x.w << 16,
                           x.w & 0xffff0000u);
      }
    }
  }
}

// lse (natural log, as the forward saved it) into ls[0, N) and D into
// ls[N, 2N) for the N rows from row r0 of head h, zero past T;
// bwd_split_stats takes lse to base 2 (the scores' base) in this thread's
// words
template <int N, int NTH>
__device__ __forceinline__ void bwd_copy_stats(float* ls, const BwdParams& p,
                                               int b, int h, int r0) {
  const long long at = ((long long)b * p.Hq + h) * p.T + r0;
  for (int e = threadIdx.x; e < 2 * N; e += NTH) {
    const int r = e % N;
    const bool ok = r0 + r < p.T;
    cp_async4(ls + e, (e < N ? p.lse : p.delta) + at + (ok ? r : 0), ok);
  }
}
template <int N, int NTH>
__device__ __forceinline__ void bwd_split_stats(float* ls) {
  for (int e = threadIdx.x; e < N; e += NTH) ls[e] *= LOG2E;
}

// an accumulator tile (16 x 8: c0, c1 row g; c2, c3 row g + 8; columns
// 2t, 2t + 1) as the A fragment of the next product's k-step, split (the
// k-step's logical indices t, t + 4 are physical 2t, 2t + 1)
__device__ __forceinline__ void acc_frag(const float (&c)[4],
                                         uint32_t (&big)[4],
                                         uint32_t (&small)[4]) {
  split_tf32(c[0], big[0], small[0]);
  split_tf32(c[2], big[1], small[1]);
  split_tf32(c[1], big[2], small[2]);
  split_tf32(c[3], big[3], small[3]);
}

// P and dS of one score / dP entry (row i, key j) in place
template <bool WIN>
__device__ __forceinline__ void bwd_p_ds(const BwdParams& p, int q0, int kl,
                                         int i, int j, float ls, float dl,
                                         float& s, float& dp) {
  float pv = 0.f, dv = 0.f;
  if (i < p.T && j < p.S) {
    const int rs = row_start<WIN>(p, q0, i), re = row_end(p, q0, kl, i);
    if (rs >= re) {
      pv = 1.f / (float)p.S;                  // sees no key: mean of V
    } else if ((!WIN || j >= rs) && j < re) {
      pv = exp2f(s * p.scale_log2 - ls);
      dv = pv * (dp - dl);
    }
  }
  s = pv;
  dp = dv;
}

// c += a.b over one k-step of a product whose A is P or dS (split in f32,
// TF32-rounded with bf16 inputs) and whose B comes from planes (f32: three
// TF32 products, small terms first; bf16: one)
template <bool SPLIT, bool FIRST>
__device__ __forceinline__ void mma_acc(float (&c)[4], const uint32_t (&ab)[4],
                                        const uint32_t (&as)[4],
                                        const uint32_t (&bb)[2],
                                        const uint32_t (&bs)[2]) {
  if constexpr (SPLIT) {
    mma_step<FIRST>(c, as, bb);
    mma_tf32(c, ab, bs);
    mma_tf32(c, ab, bb);
  } else {
    mma_step<FIRST>(c, ab, bb);
  }
}

// c += a.b over one k-step with A and B both from planes: f32 three TF32
// products, bf16 one (its values are exact in TF32)
template <bool SPLIT>
__device__ __forceinline__ void mma_planes(float (&c)[4],
                                           const uint32_t (&ab)[4],
                                           const uint32_t (&as)[4],
                                           const uint32_t (&bf)[4]) {
  const uint32_t bb[2] = {bf[0], bf[1]};
  if constexpr (SPLIT) {
    const uint32_t bs[2] = {bf[2], bf[3]};
    mma_3xtf32(c, ab, as, bb, bs);
  } else {
    mma_tf32(c, ab, bb);
  }
}

// the probability of one score entry (row i, key j): its softmax weight if
// visible, 1/S over all S keys for a row that sees none, else 0
template <bool WIN>
__device__ __forceinline__ float bwd_p(const BwdParams& p, int q0, int kl,
                                       int i, int j, float s, float ls) {
  if (i >= p.T || j >= p.S) return 0.f;
  const int rs = row_start<WIN>(p, q0, i), re = row_end(p, q0, kl, i);
  if (rs >= re) return 1.f / (float)p.S;      // sees no key: mean of V
  return (!WIN || j >= rs) && j < re ? exp2f(s * p.scale_log2 - ls) : 0.f;
}

// The query tiles (BT rows) that touch keys [j0, j0 + BS) of batch row b
// (q0 = its q_start, kl its visible length), as up to three ranges
// [0, n1), [b_lo, b_hi) and [c_lo, n_qt), walked in order.  The rows that
// see no key (each adds 1/S of its dO to every dV row) are a prefix
// [0, n_pre) (row_end <= 0) and a suffix [n_suf, T) (past the window's
// reach; empty without one); between them the rows that see one of the
// keys are [s_lo, s_hi) (a row's start and end never decrease with i).
template <bool WIN, int BT, int BS>
struct KeyTileSteps {
  int n1 = 0, b_lo = 0, c_lo = 0, n12 = 0, n = 0;   // n: the tiles in all
  KeyTileSteps() = default;
  __device__ __forceinline__ KeyTileSteps(const BwdParams& p, int q0, int kl,
                                          int j0) {
    const int n_qt = (p.T + BT - 1) / BT;
    const int n_pre = bwd_first(p.T, [&](int i) {
      return row_end(p, q0, kl, i) > 0; });
    const int n_suf = n_pre + bwd_first(p.T - n_pre, [&](int i) {
      return row_idle<WIN>(p, q0, kl, n_pre + i); });
    const int s_lo = max(n_pre, bwd_first(p.T, [&](int i) {
      return row_end(p, q0, kl, i) > j0; }));
    const int s_hi = min(n_suf, bwd_first(p.T, [&](int i) {
      return row_start<WIN>(p, q0, i) >= j0 + BS; }));
    const bool see = s_lo < s_hi;
    n1 = (n_pre + BT - 1) / BT;
    b_lo = see ? max(s_lo / BT, n1) : n1;
    const int b_hi = see ? max((s_hi + BT - 1) / BT, b_lo) : n1;
    c_lo = max(n_suf < p.T ? n_suf / BT : n_qt, b_hi);
    n12 = n1 + b_hi - b_lo;
    n = n12 + n_qt - c_lo;
  }
  // the first row of the a-th touching tile (without a window the third
  // range is empty: a test per copy that the f32 D = 64 dK/dV kernel
  // takes 2.5% longer for)
  __device__ __forceinline__ int row(int a) const {
    if constexpr (!WIN) return (a < n1 ? a : b_lo + a - n1) * BT;
    return (a < n1 ? a : a < n12 ? b_lo + a - n1 : c_lo + a - n12) * BT;
  }
};

// The keys [k_lo, k_hi) that query rows [i0, i1) see: rows that see no key
// have dS = 0, so only keys some row sees add to dQ, from the first seeing
// row's start to the last one's end
template <bool WIN>
__device__ __forceinline__ void dq_key_range(const BwdParams& p, int q0,
                                             int kl, int i0, int i1,
                                             int& k_lo, int& k_hi) {
  k_lo = 0;
  k_hi = max(0, row_end(p, q0, kl, i1 - 1));
  if constexpr (WIN) {
    k_lo = p.S;
    k_hi = 0;
    for (int i = i0; i < i1; ++i) {
      if (!row_idle<WIN>(p, q0, kl, i)) {
        k_lo = min(k_lo, row_start<WIN>(p, q0, i));
        k_hi = max(k_hi, row_end(p, q0, kl, i));
      }
    }
  }
}

// bar.sync on a named barrier for ``n`` threads (the two warps of a pair)
__device__ __forceinline__ void bar_pair(int id, int n) {
  asm volatile("bar.sync %0, %1;\n" :: "r"(id), "r"(n) : "memory");
}

// dK/dV.  Each group of 16 MK keys has two warps a streamed row half: role
// 0 forms S^T = K Q^T, P^T, and dV += P^T dO; role 1 forms dP^T = V dO^T,
// takes P^T from its partner through shared memory (a named barrier for
// the pair), dS^T, and dK += dS^T Q.  Each warp keeps one matrix's sums
// for its keys, so every B fragment it loads feeds MK m16 tiles.
template <typename T, int D, bool WIN>
__global__ void __launch_bounds__(BwdCfg<T, D>::NTH, BwdCfg<T, D>::MIN_BLOCKS)
flash_bwd_dkdv_kernel(const BwdParams p) {
  using C = BwdCfg<T, D>;
  constexpr int LD = C::LD, NT = C::NT, DT = D / 8, RT = C::RT, BS = C::BS;
  constexpr int BT = C::BT, NTH = C::NTH, PS = C::PS, PT = C::PT;
  constexpr int MK = C::MK, WK = C::WK;
  constexpr int STAGES = C::STAGES, SLOT = C::SLOT;
  constexpr bool SPLIT = C::SPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // K big, K small, V big, V small [BS][LD]; then the ring of slots: Q big,
  // Q small, dO big, dO small [BT][LD], lse (base 2) [BT], D [BT]; then the
  // pairs' P^T hand-over [pair][MK * NT * 4][32]
  uint32_t* kv = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* ring = kv + C::RING;
  float* xbuf = reinterpret_cast<float*>(ring + STAGES * SLOT);

  const int hk = blockIdx.x, b = blockIdx.y;
  const int j0 = blockIdx.z * BS;                     // key tile 0 first
  const int G = p.Hq / p.Hkv;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ws = warp % WK, wt = warp / WK % C::WT;
  const int role = warp / (WK * C::WT);
  const int pair = ws + WK * wt;
  const int g = lane >> 2, t4 = lane & 3;
  const int kw = j0 + ws * 16 * MK;                   // this warp's keys
  const int q0 = p.q_start[b];
  const int kl = min(p.kv_len[b], p.S);

  // the query tiles that touch these keys (KeyTileSteps), walked in order,
  // each once, for each query head of the group
  const KeyTileSteps<WIN, BT, BS> tiles(p, q0, kl, j0);
  const int n_act = tiles.n;
  const int n_steps = G * n_act;
  auto tile_row = [&](int a) { return tiles.row(a); };
  const T* qb = static_cast<const T*>(p.q) + b * p.sq_b + hk * G * p.sq_h;
  const T* db = static_cast<const T*>(p.dout) + b * p.sd_b + hk * G * p.sd_h;
  int c_a = 0, c_h = 0;                 // the next step to copy: tile, head
  auto copy = [&](int s) {                // step s into slot s % STAGES
    if (s < n_steps) {
      const int i0 = tile_row(c_a);
      uint32_t* sl = ring + (s % STAGES) * SLOT;
      bwd_copy<T, D, LD, BT, NTH>(sl, sl + PT,
                                  qb + c_h * p.sq_h + i0 * p.sq_t, p.sq_t,
                                  p.T - i0);
      bwd_copy<T, D, LD, BT, NTH>(sl + 2 * PT, sl + 3 * PT,
                                  db + c_h * p.sd_h + i0 * p.sd_t, p.sd_t,
                                  p.T - i0);
      bwd_copy_stats<BT, NTH>(reinterpret_cast<float*>(sl + 4 * PT), p, b,
                              hk * G + c_h, i0);
      if (++c_a == n_act) { c_a = 0; ++c_h; }
    }
    cp_async_commit();
  };
  auto split = [&](int s) {
    if (s < n_steps) {
      uint32_t* sl = ring + (s % STAGES) * SLOT;
      bwd_split<T, D, LD, BT, NTH>(sl, sl + PT);
      bwd_split<T, D, LD, BT, NTH>(sl + 2 * PT, sl + 3 * PT);
      bwd_split_stats<BT, NTH>(reinterpret_cast<float*>(sl + 4 * PT));
    }
  };

  // K and V go with step 0 in the first group, then steps 1 .. STAGES - 2
  bwd_copy<T, D, LD, BS, NTH>(
      kv, kv + PS,
      static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h + j0 * p.sk_s,
      p.sk_s, p.S - j0);
  bwd_copy<T, D, LD, BS, NTH>(
      kv + 2 * PS, kv + 3 * PS,
      static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h + j0 * p.sv_s,
      p.sv_s, p.S - j0);
  for (int s = 0; s < STAGES - 1; ++s) copy(s);
  cp_async_wait<STAGES - 2>();
  bwd_split<T, D, LD, BS, NTH>(kv, kv + PS);
  bwd_split<T, D, LD, BS, NTH>(kv + 2 * PS, kv + 3 * PS);
  split(0);

  float acc[MK][DT][4];       // dV (role 0) or dK (role 1) sums: keys kw +
#pragma unroll                // 16 m + g (+ 8), columns d * 8 + 2t (+ 1)
  for (int m = 0; m < MK; ++m)
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c) acc[m][d][c] = 0.f;
  // role 0 reads K and, in its first product, Q, then dO down the columns;
  // role 1 V, dO, then Q
  const uint32_t kv_a = smem_u32(kv)
      + 4 * (lane_a(lane, LD) + ws * 16 * MK * LD + role * 2 * PS);
  const int lb = lane_b(lane, LD, PT) + role * 2 * PT;
  float* xb = xbuf + pair * (MK * NT * 4 * 32) + lane;

  int a = 0;                            // step it's tile
  for (int it = 0; it < n_steps; ++it, a = a + 1 == n_act ? 0 : a + 1) {
    __syncthreads();                    // step it is split; slot it-1 is free
    copy(it + STAGES - 1);
    const int i0 = tile_row(a);
    const uint32_t* sl = ring + (it % STAGES) * SLOT;
    const float* ls = reinterpret_cast<const float*>(sl + 4 * PT);
    const int ir = wt * RT;             // this warp's rows of the tile
    const int iw = i0 + ir;
    const int il = min(iw + RT, p.T) - 1;
    const int re_first = row_end(p, q0, kl, iw);
    const int re_last = row_end(p, q0, kl, il);
    // nothing to add: no row, no key, or every row sees keys and none of
    // these (a row that sees no key adds 1/S of its dO to every dV row; such
    // rows are a prefix and/or a suffix, so the first and last rows tell);
    // the same for both warps of the pair
    bool none = iw >= p.T || kw >= p.S;
    if constexpr (WIN)
      none = none || (!row_idle<WIN>(p, q0, kl, iw)
                      && !row_idle<WIN>(p, q0, kl, il)
                      && (re_last <= kw
                          || row_start<WIN>(p, q0, iw) >= kw + 16 * MK));
    else
      none = none || (re_first > 0 && re_last <= kw);
    if (!none) {
      // every row valid and seeing all 16 MK keys: no mask
      const bool full = iw + RT <= p.T && kw + 16 * MK <= p.S
                        && re_first >= kw + 16 * MK
                        && (!WIN || row_start<WIN>(p, q0, il) <= kw);
      // S^T = K Q^T (role 0) or dP^T = V dO^T (role 1): 16 MK keys x RT rows
      float st[MK][NT][4];
#pragma unroll
      for (int m = 0; m < MK; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c) st[m][n][c] = 0.f;
      const uint32_t ba = smem_u32(sl) + 4 * (lb + ir * LD);
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        uint32_t ka[MK][4], ksm[MK][4] = {};
#pragma unroll
        for (int m = 0; m < MK; ++m) {
          ldsm_x4(ka[m], kv_a + 4 * m * 16 * LD + 32 * kk);
          if constexpr (SPLIT)
            ldsm_x4(ksm[m], kv_a + 4 * (PS + m * 16 * LD) + 32 * kk);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t o = 4 * n * 8 * LD + 32 * kk;
          uint32_t bf[4] = {};
          if constexpr (SPLIT) {
            ldsm_x4(bf, ba + o);
          } else {
            uint32_t b2[2];
            ldsm_x2(b2, ba + o);
            bf[0] = b2[0]; bf[1] = b2[1];
          }
#pragma unroll
          for (int m = 0; m < MK; ++m)
            mma_planes<SPLIT>(st[m][n], ka[m], ksm[m], bf);
        }
      }
      // role 0: P^T, handed to the partner; role 1: dS^T = P^T o (dP^T - D),
      // zero for a row that sees no key
      if (role == 0) {
        if (full) {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const float2 l2 = *reinterpret_cast<const float2*>(
                ls + ir + n * 8 + 2 * t4);
#pragma unroll
            for (int m = 0; m < MK; ++m)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                st[m][n][c] = exp2f(st[m][n][c] * p.scale_log2
                                    - (c & 1 ? l2.y : l2.x));
          }
        } else {
#pragma unroll
          for (int n = 0; n < NT; ++n) {
            const int r = ir + n * 8 + 2 * t4;      // tile row of c0, c2
            const float2 l2 = *reinterpret_cast<const float2*>(ls + r);
#pragma unroll
            for (int m = 0; m < MK; ++m)
#pragma unroll
              for (int c = 0; c < 4; ++c)
                st[m][n][c] = bwd_p<WIN>(p, q0, kl, i0 + r + (c & 1),
                                    kw + m * 16 + g + (c < 2 ? 0 : 8),
                                    st[m][n][c], c & 1 ? l2.y : l2.x);
          }
        }
#pragma unroll
        for (int m = 0; m < MK; ++m)
#pragma unroll
          for (int n = 0; n < NT; ++n)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              xb[((m * NT + n) * 4 + c) * 32] = st[m][n][c];
      }
      bar_pair(1 + pair, 64);
      if (role == 1) {
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int r = ir + n * 8 + 2 * t4;
          const float2 d2 = *reinterpret_cast<const float2*>(ls + BT + r);
          // a row that sees no key has dS = 0 (its P is 1/S)
          const bool idle0 = !full && row_idle<WIN>(p, q0, kl, i0 + r);
          const bool idle1 = !full && row_idle<WIN>(p, q0, kl, i0 + r + 1);
#pragma unroll
          for (int m = 0; m < MK; ++m)
#pragma unroll
            for (int c = 0; c < 4; ++c)
              st[m][n][c] = (c & 1 ? idle1 : idle0) ? 0.f
                  : xb[((m * NT + n) * 4 + c) * 32]
                        * (st[m][n][c] - (c & 1 ? d2.y : d2.x));
        }
      }
      // dV += P^T dO (role 0) or dK += dS^T Q (role 1): the k-steps are the
      // warp's row tiles; B read down the columns (rows 2t, 2t + 1, col g)
      uint32_t pb[MK][NT][4], pl[MK][NT][4];
#pragma unroll
      for (int m = 0; m < MK; ++m)
#pragma unroll
        for (int n = 0; n < NT; ++n) acc_frag(st[m][n], pb[m][n], pl[m][n]);
      const uint32_t* bc = sl + (ir + 2 * t4) * LD + g + (1 - role) * 2 * PT;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        float tv[MK][4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int o = n * 8 * LD + d * 8;
          const uint32_t bb[2] = {bc[o], bc[o + LD]};
          uint32_t bs[2] = {0u, 0u};
          if constexpr (SPLIT) {
            bs[0] = bc[o + PT]; bs[1] = bc[o + LD + PT];
          }
#pragma unroll
          for (int m = 0; m < MK; ++m) {
            if (n == 0) mma_acc<SPLIT, true>(tv[m], pb[m][n], pl[m][n], bb, bs);
            else mma_acc<SPLIT, false>(tv[m], pb[m][n], pl[m][n], bb, bs);
          }
        }
#pragma unroll
        for (int m = 0; m < MK; ++m)
#pragma unroll
          for (int c = 0; c < 4; ++c) acc[m][d][c] += tv[m][c];
      }
    }
    cp_async_wait<STAGES - 2>();
    split(it + 1);
  }

  // the two row halves of a key group summed disjoint rows: wt 1 hands its
  // sums over in the ring, wt 0 adds them and writes dV (role 0) or dK
  __syncthreads();                      // the ring is idle: no copy in flight
  float* part = reinterpret_cast<float*>(ring);
  constexpr int NS = MK * DT * 4, W = WK * 32;
  float* mine = part + role * NS * W + ws * 32 + lane;
  if (wt == 1) {
#pragma unroll
    for (int m = 0; m < MK; ++m)
#pragma unroll
      for (int d = 0; d < DT; ++d)
#pragma unroll
        for (int c = 0; c < 4; ++c)
          mine[((m * DT + d) * 4 + c) * W] = acc[m][d][c];
  }
  __syncthreads();
  if (wt != 0) return;
  T* out = static_cast<T*>(role == 0 ? p.dv : p.dk);
  const float sc = role == 0 ? 1.f : p.scale;
#pragma unroll
  for (int m = 0; m < MK; ++m)
#pragma unroll
    for (int half = 0; half < 2; ++half) {
      const int j = kw + m * 16 + g + 8 * half;
      if (j >= p.S) continue;
      T* row = out + (((long long)b * p.S + j) * p.Hkv + hk) * D + 2 * t4;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        const float* o = mine + ((m * DT + d) * 4 + 2 * half) * W;
        store2(row + d * 8, (acc[m][d][2 * half] + o[0]) * sc,
               (acc[m][d][2 * half + 1] + o[W]) * sc);
      }
    }
}

template <typename T, int D, bool WIN>
__global__ void __launch_bounds__(BwdCfg<T, D>::NTH_Q, BwdCfg<T, D>::MIN_BLOCKS)
flash_bwd_dq_kernel(const BwdParams p) {
  using C = BwdCfg<T, D>;
  constexpr int LD = C::LD, NT = C::NT_Q, DT = D / 8, RT = C::RT_Q;
  constexpr int BS = C::BS_Q, BT = C::BT, NTH = C::NTH_Q, PT = C::PT;
  constexpr int PS = BS * LD, WS = BS / 16, WT = C::WT_Q;
  constexpr int STAGES = C::STAGES_Q, SLOT = C::SLOT;
  constexpr bool SPLIT = C::SPLIT;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // Q big, Q small, dO big, dO small [BS][LD], lse (base 2) [BS], D [BS];
  // then the ring of slots: K big, K small, V big, V small [BT][LD]
  uint32_t* qd = reinterpret_cast<uint32_t*>(smem_raw);
  float* qst = reinterpret_cast<float*>(qd + 4 * PS);
  uint32_t* ring = qd + 4 * PS + 2 * BS;

  const int n_qt = gridDim.z;
  const int qt = n_qt - 1 - blockIdx.z;               // longest tiles first
  const int h = blockIdx.x, b = blockIdx.y;
  const int hk = h / (p.Hq / p.Hkv);
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int ws = warp % WS, wt = warp / WS;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = p.q_start[b];
  const int kl = min(p.kv_len[b], p.S);
  const int i0 = qt * BS;
  const int iw = i0 + ws * 16;                        // this warp's rows
  int k_lo, k_hi;
  dq_key_range<WIN>(p, q0, kl, i0, min(i0 + BS, p.T), k_lo, k_hi);
  const int t0 = k_lo < k_hi ? k_lo / BT : 0;
  const int n_steps = k_lo < k_hi ? (k_hi + BT - 1) / BT - t0 : 0;
  const int wl = min(iw + 15, p.T - 1);               // the warp's last row

  const T* kb = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* vb = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;
  auto copy = [&](int s) {                // key tile s into slot s % STAGES
    if (s < n_steps) {
      uint32_t* sl = ring + (s % STAGES) * SLOT;
      const int j0 = (t0 + s) * BT;
      bwd_copy<T, D, LD, BT, NTH>(sl, sl + PT, kb + j0 * p.sk_s, p.sk_s,
                                  p.S - j0);
      bwd_copy<T, D, LD, BT, NTH>(sl + 2 * PT, sl + 3 * PT, vb + j0 * p.sv_s,
                                  p.sv_s, p.S - j0);
    }
    cp_async_commit();
  };
  auto split = [&](int s) {
    if (s < n_steps) {
      uint32_t* sl = ring + (s % STAGES) * SLOT;
      bwd_split<T, D, LD, BT, NTH>(sl, sl + PT);
      bwd_split<T, D, LD, BT, NTH>(sl + 2 * PT, sl + 3 * PT);
    }
  };

  // Q, dO and their statistics go with key tile 0 in the first group
  bwd_copy<T, D, LD, BS, NTH>(
      qd, qd + PS,
      static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h + i0 * p.sq_t,
      p.sq_t, p.T - i0);
  bwd_copy<T, D, LD, BS, NTH>(
      qd + 2 * PS, qd + 3 * PS,
      static_cast<const T*>(p.dout) + b * p.sd_b + h * p.sd_h + i0 * p.sd_t,
      p.sd_t, p.T - i0);
  bwd_copy_stats<BS, NTH>(qst, p, b, h, i0);
  for (int s = 0; s < STAGES - 1; ++s) copy(s);
  cp_async_wait<STAGES - 2>();
  bwd_split<T, D, LD, BS, NTH>(qd, qd + PS);
  bwd_split<T, D, LD, BS, NTH>(qd + 2 * PS, qd + 3 * PS);
  bwd_split_stats<BS, NTH>(qst);
  split(0);

  float dq[DT][4];                      // sums: rows iw + g (+ 8), d 2t (+1)
#pragma unroll
  for (int d = 0; d < DT; ++d)
#pragma unroll
    for (int c = 0; c < 4; ++c) dq[d][c] = 0.f;
  const uint32_t qa = smem_u32(qd) + 4 * (lane_a(lane, LD) + ws * 16 * LD);
  // up to D = 64 the big planes of the warp's Q and dO A fragments stay in
  // registers for the whole loop (at D = 128 they would cost 128)
  constexpr bool HOLD = D <= 64;
  uint32_t qreg[HOLD ? DT : 1][4], dreg[HOLD ? DT : 1][4];
  if constexpr (HOLD) {
    __syncthreads();                    // every thread's Q, dO chunks split
#pragma unroll
    for (int kk = 0; kk < DT; ++kk) {
      ldsm_x4(qreg[kk], qa + 32 * kk);
      ldsm_x4(dreg[kk], qa + 4 * 2 * PS + 32 * kk);
    }
  }
  const int lb = lane_b(lane, LD, PT);

  for (int it = 0; it < n_steps; ++it) {
    __syncthreads();                    // step it is split; slot it-1 is free
    copy(it + STAGES - 1);
    const uint32_t* sl = ring + (it % STAGES) * SLOT;
    const int kr = wt * RT;             // this warp's keys of the tile
    const int kj = (t0 + it) * BT + kr;
    const bool none = iw >= p.T || kj >= p.S
        || row_end(p, q0, kl, wl) <= kj
        || (WIN && row_start<WIN>(p, q0, iw) >= kj + RT);
    if (!none) {
      // every row valid and seeing all RT keys: no mask
      const bool full = iw + 16 <= p.T && kj + RT <= p.S
                        && row_end(p, q0, kl, iw) >= kj + RT
                        && (!WIN || row_start<WIN>(p, q0, iw + 15) <= kj);
      // S = Q K^T and dP = dO V^T: 16 rows x RT keys
      float s[NT][4], dp[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n)
#pragma unroll
        for (int c = 0; c < 4; ++c) s[n][c] = dp[n][c] = 0.f;
      const uint32_t ka = smem_u32(sl) + 4 * (lb + kr * LD);
      const uint32_t va = ka + 4 * 2 * PT;
#pragma unroll
      for (int kk = 0; kk < DT; ++kk) {
        uint32_t qb[4], qsm[4] = {}, db[4], dsm[4] = {};
        if constexpr (HOLD) {
#pragma unroll
          for (int c = 0; c < 4; ++c) {
            qb[c] = qreg[kk][c];
            db[c] = dreg[kk][c];
          }
        } else {
          ldsm_x4(qb, qa + 32 * kk);
          ldsm_x4(db, qa + 4 * 2 * PS + 32 * kk);
        }
        if constexpr (SPLIT) {
          ldsm_x4(qsm, qa + 4 * PS + 32 * kk);
          ldsm_x4(dsm, qa + 4 * 3 * PS + 32 * kk);
        }
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const uint32_t o = 4 * n * 8 * LD + 32 * kk;
          uint32_t kf[4] = {}, vf[4] = {};
          if constexpr (SPLIT) {
            ldsm_x4(kf, ka + o);
            ldsm_x4(vf, va + o);
          } else {
            uint32_t k2[2], v2[2];
            ldsm_x2(k2, ka + o);
            ldsm_x2(v2, va + o);
            kf[0] = k2[0]; kf[1] = k2[1]; vf[0] = v2[0]; vf[1] = v2[1];
          }
          mma_planes<SPLIT>(s[n], qb, qsm, kf);
          mma_planes<SPLIT>(dp[n], db, dsm, vf);
        }
      }
      // dS in place (in dp)
      const int rw = ws * 16 + g;                     // block row of c0, c1
      const float ls0 = qst[rw], ls1 = qst[rw + 8];
      const float dl0 = qst[BS + rw], dl1 = qst[BS + rw + 8];
      if (full) {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            dp[n][c] = exp2f(s[n][c] * p.scale_log2 - (c < 2 ? ls0 : ls1))
                       * (dp[n][c] - (c < 2 ? dl0 : dl1));
      } else {
#pragma unroll
        for (int n = 0; n < NT; ++n)
#pragma unroll
          for (int c = 0; c < 4; ++c)
            bwd_p_ds<WIN>(p, q0, kl, iw + g + (c < 2 ? 0 : 8),
                     kj + n * 8 + 2 * t4 + (c & 1), c < 2 ? ls0 : ls1,
                     c < 2 ? dl0 : dl1, s[n][c], dp[n][c]);
      }
      // dQ += dS K: the k-steps are the warp's key tiles; B read down K's
      // columns (keys 2t, 2t + 1, column g)
      uint32_t sb[NT][4], sm[NT][4];
#pragma unroll
      for (int n = 0; n < NT; ++n) acc_frag(dp[n], sb[n], sm[n]);
      const uint32_t* kc = sl + (kr + 2 * t4) * LD + g;
#pragma unroll
      for (int d = 0; d < DT; ++d) {
        float tq[4];
#pragma unroll
        for (int n = 0; n < NT; ++n) {
          const int o = n * 8 * LD + d * 8;
          const uint32_t bk[2] = {kc[o], kc[o + LD]};
          uint32_t bks[2] = {0u, 0u};
          if constexpr (SPLIT) {
            bks[0] = kc[o + PT]; bks[1] = kc[o + LD + PT];
          }
          if (n == 0) mma_acc<SPLIT, true>(tq, sb[n], sm[n], bk, bks);
          else mma_acc<SPLIT, false>(tq, sb[n], sm[n], bk, bks);
        }
#pragma unroll
        for (int c = 0; c < 4; ++c) dq[d][c] += tq[c];
      }
    }
    cp_async_wait<STAGES - 2>();
    split(it + 1);
  }

  // with two warps a row group (WT = 2) each summed disjoint keys: wt 0
  // finishes the first half of the columns and wt 1 the second, each adding
  // the other's partial, handed over in the ring
  constexpr int W = WS * 32, HALF = DT / 2;
  const int slot = ws * 32 + lane;
  float* part = reinterpret_cast<float*>(ring);
  if constexpr (WT == 2) {
    __syncthreads();                    // the ring is idle: no copy in flight
#pragma unroll
    for (int d = 0; d < DT; ++d)
#pragma unroll
      for (int c = 0; c < 4; ++c)
        if ((d < HALF) == (wt == 1)) part[(d * 4 + c) * W + slot] = dq[d][c];
    __syncthreads();
  }
  T* dqp = static_cast<T*>(p.dq);
#pragma unroll
  for (int half = 0; half < 2; ++half) {
    const int i = iw + g + 8 * half;
    if (i >= p.T) continue;
    T* row = dqp + (((long long)b * p.T + i) * p.Hq + h) * D + 2 * t4;
#pragma unroll
    for (int d = 0; d < DT; ++d) {
      if constexpr (WT == 2) {
        if ((d < HALF) != (wt == 0)) continue;        // the other warp's half
        const float* o = part + (d * 4 + 2 * half) * W + slot;
        store2(row + d * 8, (dq[d][2 * half] + o[0]) * p.scale,
               (dq[d][2 * half + 1] + o[W]) * p.scale);
      } else {
        store2(row + d * 8, dq[d][2 * half] * p.scale,
               dq[d][2 * half + 1] * p.scale);
      }
    }
  }
}

// ---------------------------------------------------------------------------
// Backward at head_dim 256
// ---------------------------------------------------------------------------
//
// The same function and the same steps as above (pre-pass, dK/dV, dQ),
// redesigned for D = 256, where the D <= 128 tiles do not fit: both TF32
// planes of a row cost 2,080 bytes, and a warp's sums over a whole D = 256
// row are 128 registers a thread.
//   * Fill the card for one kv head.  dK/dV runs one block per (BS keys,
//     query head, batch row): the G = Hq / Hkv heads of a group are G
//     parts, each writing f32 partial sums of dV and dK into the workspace
//     ws [2][G][B][S][Hkv][D] (dV, dK); a last kernel adds the parts in
//     order 0 .. G - 1 and writes dK, dV in the inputs' dtype (no atomics:
//     the same bits on every call).  At gemma3's training shape (B 2,
//     T = S = 1024, 4/1 heads) dK/dV has 256 blocks where one block a key
//     tile and kv head had 128, and the longest (key tile 0 under the
//     causal mask) walks 32 query tiles, not 4 x 64.  dK/dV's and dQ's
//     blocks share one launch (flash_bwd256_kernel), so that each fills
//     the other's tail.
//   * Tiles: BS = 32 stationary rows (keys in dK/dV, query rows in dQ) and
//     BT = 32 streamed rows a step, 8 warps, one block an SM.  Rows stay
//     raw, as f32 words (a bf16 value widened, exact in TF32), pitch D + 4
//     words, and are split into TF32 big (rounded) and small parts in
//     registers as the fragments load: half the shared memory of split
//     planes, so that 32 stationary and 2 x 32 streamed rows of two
//     matrices fit (216,832 bytes with the exchange).
//   * A step has two phases.  A: S (or S^T) and dP over D, each warp a
//     16 x 16 tile of one of them (mma.sync m16n8k8: 3xTF32 in f32, one
//     TF32 product in bf16); the warp that formed P hands it to the warp
//     of dP's same tile (a named barrier for the pair), which forms dS;
//     both land in an exchange buffer, split into TF32 big and small
//     planes.  B: the sums over the step's 32 rows (or keys) on wgmma, in
//     the transposed orientation dV^T += dO^T P, dK^T += Q^T dS, dQ^T +=
//     K^T dS^T, so that the 64-row side of m64n32k8 runs along D and the
//     32 stationary rows are its N: warps 0-3 (a warpgroup) sum all of
//     dV and 4-7 all of dK, or each group half of dQ's columns, 64 or 32
//     sums a thread and no warp a whole D row.  A (D x k) is read down the
//     streamed tile's columns into registers (mma.sync's A fragment,
//     conflict-free at pitch D + 4) and split there; B (k x N, K-major,
//     as TF32 wgmma needs) is P or dS as the exchange holds it, in 8 x 4
//     core matrices without swizzle.  Each step's k-steps of an m-tile sum
//     in a fresh accumulator that is added into f32 registers, as above.
//   * Loads: 16-byte cp.async into a two-slot ring, a step ahead; four
//     threads own a row (its chunks q, q + 4, ...).  bf16 lands raw in the
//     upper half of its row's words and its owners widen it in place
//     (read, __syncwarp, write).
//   * dQ recomputes S and dP, as the D <= 128 kernel does, over the key
//     tiles its 32 rows see, longest tiles first.

struct Bwd256 {
  static constexpr int D = 256;
  static constexpr int BS = 32;             // stationary rows a block
  static constexpr int BT = 32;             // streamed rows a step
  static constexpr int NTH = 256;           // 8 warps
  static constexpr int LD = D + 4;          // row pitch, words
  // the stationary pair (and dQ's statistics), a ring slot (the streamed
  // pair and dK/dV's statistics), the exchange (P big, small; dS big,
  // small; each BS x BT, bwd256_xoff)
  static constexpr int STAT = 2 * BS * LD + 2 * BS;
  static constexpr int SLOT = 2 * BT * LD + 2 * BT;
  static constexpr int PLANE = BS * BT;
  static constexpr int XCH = 4 * PLANE;
  static constexpr int SMEM = (STAT + 2 * SLOT + XCH) * 4;
  static_assert(BS == 32 && BT == 32, "a pair of tiles is 64 rows, four "
                "threads a row, and each phase's warps cover 32 x 32");
};

// The 64 rows of a pair of 32-row tiles (rows [0, 32) from a, [32, 64)
// from b, each sa / sb elements apart; rows at or past n_ok read as zero)
// into f32 words at dst, pitch LD, by 16-byte cp.async.  Thread t owns row
// t / 4 and its chunks t % 4, t % 4 + 4, ...: f32 lands in place, bf16 in
// the upper half of the row's words (bwd256_widen).
template <typename T>
__device__ __forceinline__ void bwd256_copy(uint32_t* dst, const T* a,
                                            long long sa, const T* b,
                                            long long sb, int n_ok) {
  constexpr int VEC = 16 / (int)sizeof(T), CH = Bwd256::D / VEC;
  const int r = threadIdx.x >> 2, q = threadIdx.x & 3, rr = r & 31;
  const bool ok = rr < n_ok;
  const T* src = r < 32 ? a + rr * sa : b + rr * sb;
  uint32_t* row = dst + r * Bwd256::LD + (VEC == 8 ? Bwd256::D / 2 : 0);
#pragma unroll
  for (int k = 0; k < CH / 4; ++k) {
    const int c = q + 4 * k;
    cp_async16(row + 4 * c, ok ? src + c * VEC : a, ok);
  }
}

// bf16: this thread's landed chunks widened in place into f32 words (a
// bf16 is the top half of its f32); a row's four owners read before any
// of them writes.  f32: nothing to do.
template <typename T>
__device__ __forceinline__ void bwd256_widen(uint32_t* dst) {
  if constexpr (std::is_same<T, __nv_bfloat16>::value) {
    constexpr int CH = Bwd256::D / 8;
    const int q = threadIdx.x & 3;
    uint32_t* row = dst + (threadIdx.x >> 2) * Bwd256::LD;
    uint4 x[CH / 4];
#pragma unroll
    for (int k = 0; k < CH / 4; ++k)
      x[k] = *reinterpret_cast<const uint4*>(row + Bwd256::D / 2
                                             + 4 * (q + 4 * k));
    __syncwarp();
#pragma unroll
    for (int k = 0; k < CH / 4; ++k) {
      uint4* at = reinterpret_cast<uint4*>(row + 8 * (q + 4 * k));
      at[0] = make_uint4(x[k].x << 16, x[k].x & 0xffff0000u, x[k].y << 16,
                         x[k].y & 0xffff0000u);
      at[1] = make_uint4(x[k].z << 16, x[k].z & 0xffff0000u, x[k].w << 16,
                         x[k].w & 0xffff0000u);
    }
  }
}

// ldmatrix row addresses (words) of two B fragments of raw rows: n-tile 0
// (rows 0-7) in registers 0, 1 and n-tile 1 (rows 8-15) in 2, 3
__device__ __forceinline__ int lane_b2(int lane, int ld) {
  return (lane & 7) * ld + ((lane >> 3) & 1) * 4 + (lane >> 4) * 8 * ld;
}

// The exchange's word of (stationary row n, streamed row k) in a plane:
// K-major 8 x 4 core matrices (128 bytes), k's groups of 4 128 bytes apart
// and n's groups of 8 1,024 bytes apart (bwd256_desc)
__device__ __forceinline__ int bwd256_xoff(int n, int k) {
  return (n >> 3) * 256 + (k >> 2) * 32 + (n & 7) * 4 + (k & 3);
}

// Phase A of a step for this warp: a 16 x 16 tile of S = X Y^T (prod 0:
// the first matrices of the stationary and streamed pairs) or of dP (prod
// 1: the second ones) over D; then P (prod 0) and dS (prod 1, from its
// partner's P) into the exchange's planes, each split into big and small
// (P = big + small exactly).  KEYS_M: the tile's M
// index is the key (dK/dV: S^T = K Q^T), else the query row (dQ).  ``ls``
// holds lse (base 2) and D of the BT query rows from i0; j0 is the first
// key.
template <typename T, bool WIN, bool KEYS_M>
__device__ __forceinline__ void bwd256_scores(const BwdParams& p, int q0,
                                              int kl, const uint32_t* stat,
                                              const uint32_t* slot,
                                              uint32_t* xch, const float* ls,
                                              int i0, int j0) {
  constexpr int LD = Bwd256::LD, BT = Bwd256::BT, PL = Bwd256::PLANE;
  constexpr bool SPLIT = std::is_same<T, float>::value;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int prod = warp >> 2, mt = (warp >> 1) & 1, nh = warp & 1;
  // the warp's query rows [iw, iw + 16) and keys [jw, jw + 16)
  const int iw = i0 + 16 * (KEYS_M ? nh : mt);
  const int jw = j0 + 16 * (KEYS_M ? mt : nh);
  const int il = min(iw + 15, p.T - 1);
  float c[2][4] = {};
  // no visible pair in the tile: the products are skipped (P and dS below
  // do not read them)
  const bool skip = iw >= p.T || jw >= p.S || row_end(p, q0, kl, il) <= jw
      || (WIN && row_start<WIN>(p, q0, iw) >= jw + 16);
  if (!skip) {
    const uint32_t xa = smem_u32(stat)
        + 4 * (lane_a(lane, LD) + (prod * Bwd256::BS + 16 * mt) * LD);
    const uint32_t yb = smem_u32(slot)
        + 4 * (lane_b2(lane, LD) + (prod * BT + 16 * nh) * LD);
#pragma unroll
    for (int kk = 0; kk < Bwd256::D / 8; ++kk) {
      uint32_t a[4], b[4];
      ldsm_x4(a, xa + 32 * kk);
      ldsm_x4(b, yb + 32 * kk);
      if constexpr (SPLIT) {
        uint32_t ab[4], as[4], bb[4], bs[4];
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          split_tf32(__uint_as_float(a[i]), ab[i], as[i]);
          split_tf32(__uint_as_float(b[i]), bb[i], bs[i]);
        }
        const uint32_t b0[2] = {bb[0], bb[1]}, s0[2] = {bs[0], bs[1]};
        const uint32_t b1[2] = {bb[2], bb[3]}, s1[2] = {bs[2], bs[3]};
        mma_3xtf32(c[0], ab, as, b0, s0);
        mma_3xtf32(c[1], ab, as, b1, s1);
      } else {
        const uint32_t b0[2] = {b[0], b[1]}, b1[2] = {b[2], b[3]};
        mma_tf32(c[0], a, b0);
        mma_tf32(c[1], a, b1);
      }
    }
  }
  // every row valid and seeing all 16 keys: no mask
  const bool full = iw + 16 <= p.T && jw + 16 <= p.S
      && row_end(p, q0, kl, iw) >= jw + 16
      && (!WIN || row_start<WIN>(p, q0, il) <= jw);
  // c[n][e] is (M index 16 mt + g + 8 (e >> 1), N index 16 nh + 8 n + 2t +
  // (e & 1)): M the stationary row, N the streamed one
  uint32_t* x = xch + bwd256_xoff(16 * mt + g, 16 * nh + 2 * t4);
  auto at = [&](int n, int e) { return 256 * (e >> 1) + 64 * n + (e & 1); };
  auto row = [&](int n, int e) {          // the query row, from i0
    return KEYS_M ? 16 * nh + 8 * n + 2 * t4 + (e & 1)
                  : 16 * mt + g + 8 * (e >> 1); };
  auto key = [&](int n, int e) {
    return KEYS_M ? jw + g + 8 * (e >> 1) : jw + 8 * n + 2 * t4 + (e & 1); };
  if (prod == 0) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row(n, e);
        const float pv = full ? exp2f(c[n][e] * p.scale_log2 - ls[r])
            : bwd_p<WIN>(p, q0, kl, i0 + r, key(n, e), c[n][e], ls[r]);
        split_tf32(pv, x[at(n, e)], x[PL + at(n, e)]);
      }
  }
  bar_pair(1 + (warp & 3), 64);
  if (prod == 1) {
#pragma unroll
    for (int n = 0; n < 2; ++n)
#pragma unroll
      for (int e = 0; e < 4; ++e) {
        const int r = row(n, e);
        // a row that sees no key has dS = 0 (its P is 1/S)
        const bool idle = !full && row_idle<WIN>(p, q0, kl, i0 + r);
        const float pv = __uint_as_float(x[at(n, e)])
                         + __uint_as_float(x[PL + at(n, e)]);
        split_tf32(idle ? 0.f : pv * (c[n][e] - ls[BT + r]),
                   x[2 * PL + at(n, e)], x[3 * PL + at(n, e)]);
      }
  }
  // the planes are read by wgmma (the async proxy) after the barrier
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// wgmma of the warpgroup: d (+)= a.b, m64n32k8, TF32 operands, f32 sums
// (d is overwritten when ``add`` is 0).  A (64 x 8) from registers, warp w
// of the group holding rows 16 w .. 16 w + 15 as mma.sync's m16n8k8 A
// fragment; B (8 x 32) from shared memory at descriptor ``desc``.  d[4 n +
// e] is row 16 w + g + 8 (e >> 1), column 8 n + 2t + (e & 1).
__device__ __forceinline__ void wgmma_m64n32k8(float (&d)[16],
                                               const uint32_t (&a)[4],
                                               uint64_t desc, int add) {
  asm volatile(
      "{\n.reg .pred p;\nsetp.ne.b32 p, %21, 0;\n"
      "wgmma.mma_async.sync.aligned.m64n32k8.f32.tf32.tf32 "
      "{%0, %1, %2, %3, %4, %5, %6, %7, %8, %9, %10, %11, %12, %13, %14, "
      "%15}, {%16, %17, %18, %19}, %20, p, 1, 1;\n}\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3]), "+f"(d[4]),
        "+f"(d[5]), "+f"(d[6]), "+f"(d[7]), "+f"(d[8]), "+f"(d[9]),
        "+f"(d[10]), "+f"(d[11]), "+f"(d[12]), "+f"(d[13]), "+f"(d[14]),
        "+f"(d[15])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "l"(desc), "r"(add));
}
__device__ __forceinline__ void wgmma_fence() {
  asm volatile("wgmma.fence.sync.aligned;\n" ::: "memory");
}
__device__ __forceinline__ void wgmma_commit() {
  asm volatile("wgmma.commit_group.sync.aligned;\n" ::: "memory");
}
template <int N>
__device__ __forceinline__ void wgmma_wait(float (&d)[16]) {
  asm volatile("wgmma.wait_group.sync.aligned %0;\n" :: "n"(N) : "memory");
#pragma unroll
  for (int i = 0; i < 16; ++i) asm volatile("" : "+f"(d[i]) :: "memory");
}
// the descriptor of a K-major B tile at shared address ``addr`` laid out
// as bwd256_xoff: no swizzle, core matrices 128 bytes apart along K (the
// leading byte offset) and 1,024 along N (the stride byte offset)
__device__ __forceinline__ uint64_t bwd256_desc(uint32_t addr) {
  return (uint64_t)((addr & 0x3FFFF) >> 4) | ((uint64_t)(128 >> 4) << 16)
         | ((uint64_t)(1024 >> 4) << 32);
}

// Phase B for this warp's group: acc[m] += A B over a step's 32 k.  A (64
// D columns x 32 k) is a streamed matrix transposed, read down its columns
// from ``at`` (its row k, column 64 m + 16 w: w the warp of the group) and
// split in f32; B (32 k x 32 stationary rows) is P or dS from the
// exchange's plane pair ``xb`` (big, then small).  Each m-tile's k-steps
// sum in a fresh accumulator (two, alternating, so that one m-tile's
// products run while the last one's sums are added).
template <bool SPLIT, int MT>
__device__ __forceinline__ void bwd256_accumulate(float (&acc)[MT][16],
                                                  const uint32_t* xb,
                                                  const uint32_t* at) {
  constexpr int LD = Bwd256::LD;
  const int lane = threadIdx.x & 31, g = lane >> 2, t4 = lane & 3;
  const uint32_t* ap = at + t4 * LD + 16 * ((threadIdx.x >> 5) & 3) + g;
  const uint32_t xs = smem_u32(xb);
  float tv[2][16] = {};
  auto add = [&](int m) {
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] += tv[m & 1][i];
  };
#pragma unroll
  for (int m = 0; m < MT; ++m) {
    uint32_t ab[4][4], as[4][4];
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint32_t* q = ap + 8 * k * LD + 64 * m;
      const uint32_t r[4] = {q[0], q[8], q[4 * LD], q[4 * LD + 8]};
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        if constexpr (SPLIT) split_tf32(__uint_as_float(r[i]), ab[k][i],
                                        as[k][i]);
        else ab[k][i] = r[i];
      }
    }
    wgmma_fence();
#pragma unroll
    for (int k = 0; k < 4; ++k) {
      const uint64_t big = bwd256_desc(xs + 256 * k);
      if constexpr (SPLIT) {                // small terms first
        wgmma_m64n32k8(tv[m & 1], as[k], big, k);
        wgmma_m64n32k8(tv[m & 1], ab[k],
                       bwd256_desc(xs + 4 * Bwd256::PLANE + 256 * k), 1);
        wgmma_m64n32k8(tv[m & 1], ab[k], big, 1);
      } else {
        wgmma_m64n32k8(tv[m & 1], ab[k], big, k);
      }
    }
    wgmma_commit();
    if (m > 0) {
      wgmma_wait<1>(tv[(m - 1) & 1]);
      add(m - 1);
    }
  }
  wgmma_wait<0>(tv[(MT - 1) & 1]);
  add(MT - 1);
}

// dK/dV (DQ = false): the block of (query head h, batch row, key tile
// ``tile``) walks the query tiles of head h that touch its keys
// (KeyTileSteps: rows that see no key before them, the rows that see
// these keys, rows past the window's reach); phase B's warps
// 0-3 sum dV += P^T dO and 4-7 dK += dS^T Q, all 256 columns, and write
// their f32 partials into part h % G of the workspace.  dQ (DQ = true):
// the block of (query head, batch row, query tile n_qt - 1 - ``tile``)
// walks the key tiles its rows see; phase B's warpgroups each sum 128
// columns of dQ += dS K and write dQ.
template <typename T, bool WIN, bool DQ>
__device__ __forceinline__ void bwd256_body(const BwdParams& p, int tile) {
  using C = Bwd256;
  constexpr int LD = C::LD, BS = C::BS, BT = C::BT, NTH = C::NTH;
  constexpr int MT = DQ ? 2 : 4;        // phase B's m-tiles (64 columns)
  constexpr bool SPLIT = std::is_same<T, float>::value;
  extern __shared__ __align__(16) unsigned char smem_raw[];
  // the stationary pair (K, V or Q, dO) [BS][LD] and dQ's lse, D [BS];
  // the ring of two slots: the streamed pair [BT][LD] and dK/dV's lse, D
  // [BT]; the exchange: P, dS, each in two planes [BS x BT]
  uint32_t* stat = reinterpret_cast<uint32_t*>(smem_raw);
  uint32_t* ring = stat + C::STAT;
  uint32_t* xch = ring + 2 * C::SLOT;
  float* stat_ls = reinterpret_cast<float*>(stat + 2 * BS * LD);

  const int h = blockIdx.x, b = blockIdx.y;
  const int G = p.Hq / p.Hkv, hk = h / G;
  const int warp = threadIdx.x >> 5, lane = threadIdx.x & 31;
  const int g = lane >> 2, t4 = lane & 3;
  const int q0 = p.q_start[b];
  const int kl = min(p.kv_len[b], p.S);
  const T* qh = static_cast<const T*>(p.q) + b * p.sq_b + h * p.sq_h;
  const T* dh = static_cast<const T*>(p.dout) + b * p.sd_b + h * p.sd_h;
  const T* kh = static_cast<const T*>(p.k) + b * p.sk_b + hk * p.sk_h;
  const T* vh = static_cast<const T*>(p.v) + b * p.sv_b + hk * p.sv_h;

  // the stationary tile's first row (a query row in dQ, a key in dK/dV),
  // and the steps: the key tiles [t0, t0 + n_steps) its rows see (dQ) or
  // the query tiles touching its keys (dK/dV)
  const int first = DQ ? ((p.T + BS - 1) / BS - 1 - tile) * BS : tile * BS;
  int k_lo = 0, k_hi = 0;
  if constexpr (DQ)
    dq_key_range<WIN>(p, q0, kl, first, min(first + BS, p.T), k_lo, k_hi);
  const int t0 = k_lo < k_hi ? k_lo / BT : 0;
  KeyTileSteps<WIN, BT, BS> tiles;
  if constexpr (!DQ) tiles = KeyTileSteps<WIN, BT, BS>(p, q0, kl, first);
  const int n_steps = DQ ? (k_lo < k_hi ? (k_hi + BT - 1) / BT - t0 : 0)
                         : tiles.n;
  // step s's first streamed row: a key (dQ) or a query row (dK/dV)
  auto step_row = [&](int s) { return DQ ? (t0 + s) * BT : tiles.row(s); };
  auto copy = [&](int s) {                // step s into slot s % 2
    if (s < n_steps) {
      const int r0 = step_row(s);
      uint32_t* sl = ring + (s & 1) * C::SLOT;
      if constexpr (DQ) {
        bwd256_copy<T>(sl, kh + r0 * p.sk_s, p.sk_s, vh + r0 * p.sv_s,
                       p.sv_s, p.S - r0);
      } else {
        bwd256_copy<T>(sl, qh + r0 * p.sq_t, p.sq_t, dh + r0 * p.sd_t,
                       p.sd_t, p.T - r0);
        bwd_copy_stats<BT, NTH>(reinterpret_cast<float*>(sl + 2 * BT * LD),
                                p, b, h, r0);
      }
    }
    cp_async_commit();
  };
  auto land = [&](int s) {
    if (s < n_steps) {
      uint32_t* sl = ring + (s & 1) * C::SLOT;
      bwd256_widen<T>(sl);
      if constexpr (!DQ)
        bwd_split_stats<BT, NTH>(reinterpret_cast<float*>(sl + 2 * BT * LD));
    }
  };

  // the stationary pair (and dQ's statistics) go with step 0
  if constexpr (DQ) {
    bwd256_copy<T>(stat, qh + first * p.sq_t, p.sq_t, dh + first * p.sd_t,
                   p.sd_t, p.T - first);
    bwd_copy_stats<BS, NTH>(stat_ls, p, b, h, first);
  } else {
    bwd256_copy<T>(stat, kh + first * p.sk_s, p.sk_s, vh + first * p.sv_s,
                   p.sv_s, p.S - first);
  }
  copy(0);
  cp_async_wait<0>();
  bwd256_widen<T>(stat);
  if constexpr (DQ) bwd_split_stats<BS, NTH>(stat_ls);
  land(0);

  // phase B's sums: acc[m][4 n + e] is column cb + 64 m + 16 (warp % 4) +
  // g + 8 (e >> 1) of row (key in dK/dV) first + 8 n + 2t + (e & 1); in
  // dK/dV warps 0-3 hold dV, 4-7 dK
  const int mat = DQ ? 1 : warp >> 2;
  const int cb = DQ ? 128 * (warp >> 2) : 0;
  float acc[MT][16];
#pragma unroll
  for (int m = 0; m < MT; ++m)
#pragma unroll
    for (int i = 0; i < 16; ++i) acc[m][i] = 0.f;

  for (int it = 0; it < n_steps; ++it) {
    __syncthreads();                    // step it landed; slot it-1 is free
    copy(it + 1);
    const uint32_t* sl = ring + (it & 1) * C::SLOT;
    const int r0 = step_row(it);
    if constexpr (DQ)
      bwd256_scores<T, WIN, false>(p, q0, kl, stat, sl, xch, stat_ls, first,
                                   r0);
    else
      bwd256_scores<T, WIN, true>(
          p, q0, kl, stat, sl, xch,
          reinterpret_cast<const float*>(sl + 2 * BT * LD), r0, first);
    __syncthreads();                    // P and dS are in the exchange
    // dV += P^T dO, dK += dS^T Q, dQ += dS K: B is the streamed pair's
    // second matrix for dV, its first otherwise
    bwd256_accumulate<SPLIT, MT>(acc, xch + 2 * mat * C::PLANE,
                                 sl + (DQ ? 0 : (1 - mat) * BT * LD) + cb);
    cp_async_wait<0>();
    land(it + 1);
  }

  const int col = cb + 16 * (warp & 3) + g;
  if constexpr (DQ) {
    T* dqp = static_cast<T*>(p.dq);
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int lo = 0; lo < 2; ++lo) {
        const int i = first + 8 * n + 2 * t4 + lo;
        if (i >= p.T) continue;
        T* row = dqp + (((long long)b * p.T + i) * p.Hq + h) * C::D + col;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            store(row + 64 * m + 8 * hi,
                  acc[m][4 * n + 2 * hi + lo] * p.scale);
      }
  } else {
    // the workspace [2][G][B][S][Hkv][D] as the wrapper allocates it
    // (flash_attention.py's bwd_parts, the one statement of its shape)
    float* part = p.ws + ((long long)(mat * G + h % G) * p.B + b) * p.S
                  * p.Hkv * C::D;
#pragma unroll
    for (int n = 0; n < 4; ++n)
#pragma unroll
      for (int lo = 0; lo < 2; ++lo) {
        const int j = first + 8 * n + 2 * t4 + lo;
        if (j >= p.S) continue;
        float* row = part + ((long long)j * p.Hkv + hk) * C::D + col;
#pragma unroll
        for (int m = 0; m < MT; ++m)
#pragma unroll
          for (int hi = 0; hi < 2; ++hi)
            row[64 * m + 8 * hi] = acc[m][4 * n + 2 * hi + lo];
      }
  }
}

// dK/dV and dQ in one launch, so that the blocks of each fill the other's
// tail (at gemma3's local layers every block walks at most 17 tiles, and
// 256 of them take two rounds of 132 SMs alone).  Along z, the slowest
// index of the issue order, the two alternate, each longest first (key
// tile 0 of dK/dV, the last query tile of dQ, under the causal mask); the
// longer list's rest follows.
template <typename T, bool WIN>
__global__ void __launch_bounds__(Bwd256::NTH, 1)
flash_bwd256_kernel(const BwdParams p) {
  const int n_kt = (p.S + Bwd256::BS - 1) / Bwd256::BS;
  const int n_qt = (p.T + Bwd256::BS - 1) / Bwd256::BS;
  const int z = blockIdx.z, both = 2 * min(n_kt, n_qt);
  const bool dq = z < both ? (z & 1) : n_qt > n_kt;
  const int tile = z < both ? z >> 1 : z - both / 2;
  if (dq) bwd256_body<T, WIN, true>(p, tile);
  else bwd256_body<T, WIN, false>(p, tile);
}

// dV = the sum of the G parts (the workspace as bwd_parts shapes it), dK =
// scale x theirs, added in part order
// 0 .. G - 1, written in the inputs' dtype; four elements a thread
template <typename T>
__global__ void __launch_bounds__(BWD_THREADS)
flash_bwd_sum_kernel(const BwdParams p) {
  const long long n4 = (long long)p.B * p.S * p.Hkv * Bwd256::D / 4;
  const long long e = (long long)blockIdx.x * BWD_THREADS + threadIdx.x;
  if (e >= 2 * n4) return;
  const int G = p.Hq / p.Hkv, mat = e >= n4;
  const long long i = e - mat * n4;
  const float4* src = reinterpret_cast<const float4*>(p.ws) + mat * G * n4
                      + i;
  float4 s = src[0];
  for (int q = 1; q < G; ++q) {
    const float4 x = src[q * n4];
    s.x += x.x; s.y += x.y; s.z += x.z; s.w += x.w;
  }
  const float sc = mat ? p.scale : 1.f;
  T* out = static_cast<T*>(mat ? p.dk : p.dv) + 4 * i;
  store2(out, s.x * sc, s.y * sc);
  store2(out + 2, s.z * sc, s.w * sc);
}

template <typename T, bool WIN>
cudaError_t launch_bwd256(const BwdParams& p, cudaStream_t stream) {
  using C = Bwd256;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd256_kernel<T, WIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long lanes = (long long)p.B * p.T * p.Hq
                          * DeltaCfg<T, C::D>::LPR;
  flash_bwd_delta_kernel<T, C::D><<<(unsigned)((lanes + BWD_THREADS - 1)
                                               / BWD_THREADS),
                                    BWD_THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 grid(p.Hq, p.B,
                  (p.S + C::BS - 1) / C::BS + (p.T + C::BS - 1) / C::BS);
  flash_bwd256_kernel<T, WIN><<<grid, C::NTH, C::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const long long n = 2LL * p.B * p.S * p.Hkv * C::D / 4;
  flash_bwd_sum_kernel<T><<<(unsigned)((n + BWD_THREADS - 1) / BWD_THREADS),
                            BWD_THREADS, 0, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D, bool WIN>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  using C = BwdCfg<T, D>;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_bwd_dkdv_kernel<T, D, WIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    err = cudaFuncSetAttribute(
        flash_bwd_dq_kernel<T, D, WIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM_Q);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const long long lanes = (long long)p.B * p.T * p.Hq * DeltaCfg<T, D>::LPR;
  flash_bwd_delta_kernel<T, D><<<(unsigned)((lanes + BWD_THREADS - 1)
                                            / BWD_THREADS),
                                 BWD_THREADS, 0, stream>>>(p);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  // key tiles on z, the slowest index of the issue order: key tile 0 first
  const dim3 gkv(p.Hkv, p.B, (p.S + C::BS - 1) / C::BS);
  flash_bwd_dkdv_kernel<T, D, WIN><<<gkv, C::NTH, C::SMEM, stream>>>(p);
  err = cudaGetLastError();
  if (err != cudaSuccess) return err;
  const dim3 gq(p.Hq, p.B, (p.T + C::BS_Q - 1) / C::BS_Q);
  flash_bwd_dq_kernel<T, D, WIN><<<gq, C::NTH_Q, C::SMEM_Q, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_bwd(const BwdParams& p, cudaStream_t stream) {
  if constexpr (D == 256)
    return p.window > 0 ? launch_bwd256<T, true>(p, stream)
                        : launch_bwd256<T, false>(p, stream);
  else
    return p.window > 0 ? launch_bwd<T, D, true>(p, stream)
                        : launch_bwd<T, D, false>(p, stream);
}

// ---------------------------------------------------------------------------
// Launch
// ---------------------------------------------------------------------------

template <typename T, int D, bool LSE, bool WIN>
cudaError_t launch_prefill(const Params& p, cudaStream_t stream) {
  using C = PrefillCfg<T, D>;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_prefill_kernel<T, D, LSE, WIN>,
        cudaFuncAttributeMaxDynamicSharedMemorySize, C::SMEM);
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const dim3 grid(p.Hq, p.B, (p.T + C::BM - 1) / C::BM);
  flash_prefill_kernel<T, D, LSE, WIN><<<grid, THREADS, C::SMEM, stream>>>(p);
  return cudaGetLastError();
}

template <typename T, int D>
cudaError_t launch_decode(const Params& p, cudaStream_t stream) {
  using C = DecodeCfg<T, D>;
  static bool attr_set = false;         // once per instantiation
  if (!attr_set) {
    cudaError_t err = cudaFuncSetAttribute(
        flash_decode_kernel<T, D>,
        cudaFuncAttributeMaxDynamicSharedMemorySize,
        (int)C::smem(C::MAX_STAGES));
    if (err != cudaSuccess) return err;
    attr_set = true;
  }
  const size_t smem = C::smem(p.split_len > DEC_TK ? C::MAX_STAGES : 1);
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
  if (p.window > 0)
    return p.lse != nullptr ? launch_prefill<T, D, true, true>(p, stream)
                            : launch_prefill<T, D, false, true>(p, stream);
  return p.lse != nullptr ? launch_prefill<T, D, true, false>(p, stream)
                          : launch_prefill<T, D, false, false>(p, stream);
}

}  // namespace

extern "C" {

// dtype: 0 = float32, 1 = bfloat16; window >= 0 (0 = global).  n_split = 0
// takes the prefill route;
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
                        float scale, int causal, int window, int n_split,
                        int split_len, void* workspace, void* lse,
                        void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0
      || window < 0)
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
           so_b, so_t, so_h, scale * LOG2E, causal, window};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 32) return (int)launch<float, 32>(p, st);
  if (dtype == 0 && D == 64) return (int)launch<float, 64>(p, st);
  if (dtype == 0 && D == 128) return (int)launch<float, 128>(p, st);
  if (dtype == 0 && D == 256) return (int)launch<float, 256>(p, st);
  if (dtype == 1 && D == 32) return (int)launch<__nv_bfloat16, 32>(p, st);
  if (dtype == 1 && D == 64) return (int)launch<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return (int)launch<__nv_bfloat16, 128>(p, st);
  if (dtype == 1 && D == 256) return (int)launch<__nv_bfloat16, 256>(p, st);
  return (int)cudaErrorInvalidValue;
}

// The backward: dq [B,T,Hq,D], dk/dv [B,S,Hkv,D] (contiguous, in q's
// dtype) from q/k/v, the forward's output o and the output gradient dout
// (strided like q), the forward's ``lse`` (f32 [B,Hq,T] contiguous) and
// ``delta``, an f32 [B,Hq,T] scratch.  At D = 256 ``workspace`` holds the
// dK/dV parts, 2 * Hq * B * S * D floats (null otherwise).  Three CUDA
// kernels on ``stream`` (four at D = 256); returns a cudaError_t (0 =
// success) and allocates nothing.

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
                        float scale, int causal, int window,
                        void* workspace, void* stream) {
  if (B <= 0 || T <= 0 || S <= 0 || Hq <= 0 || Hkv <= 0 || Hq % Hkv != 0
      || window < 0 || (D == 256 && workspace == nullptr))
    return (int)cudaErrorInvalidValue;
  BwdParams p{q, k, v, o, dout,
              static_cast<const float*>(lse), static_cast<float*>(delta),
              dq, dk, dv,
              static_cast<const int*>(q_start), static_cast<const int*>(kv_len),
              B, T, S, Hq, Hkv,
              sq_b, sq_t, sq_h, sk_b, sk_s, sk_h, sv_b, sv_s, sv_h,
              so_b, so_t, so_h, sd_b, sd_t, sd_h,
              scale, scale * LOG2E, causal, window,
              static_cast<float*>(workspace)};
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  if (dtype == 0 && D == 32) return (int)launch_bwd<float, 32>(p, st);
  if (dtype == 0 && D == 64) return (int)launch_bwd<float, 64>(p, st);
  if (dtype == 0 && D == 128) return (int)launch_bwd<float, 128>(p, st);
  if (dtype == 0 && D == 256) return (int)launch_bwd<float, 256>(p, st);
  if (dtype == 1 && D == 32) return (int)launch_bwd<__nv_bfloat16, 32>(p, st);
  if (dtype == 1 && D == 64) return (int)launch_bwd<__nv_bfloat16, 64>(p, st);
  if (dtype == 1 && D == 128) return (int)launch_bwd<__nv_bfloat16, 128>(p, st);
  if (dtype == 1 && D == 256) return (int)launch_bwd<__nv_bfloat16, 256>(p, st);
  return (int)cudaErrorInvalidValue;
}

const char* flash_attention_error_string(int code) {
  return cudaGetErrorString(static_cast<cudaError_t>(code));
}

}  // extern "C"
