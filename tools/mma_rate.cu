// The card's own ceilings for the mma.sync kernels of this repository: the
// rate of TF32 mma.sync (m16n8k8, register operands only), of ldmatrix.x4
// and of 32-bit shared-memory loads, and of a mix shaped like the flash
// backward's score products (per k-step 8 ldmatrix.x4 and 12 dependent
// mma.sync a warp).  One line per measurement; run on the card:
//
//   nvcc -gencode arch=compute_90a,code=sm_90a -O3 -o build/mma_rate \
//       tools/mma_rate.cu && build/mma_rate
//
// Compare a kernel's achieved rate with these, not with the data sheet's
// 495 TFLOP/s TF32, which only wgmma reaches.
#include <cstdio>
#include <cuda_runtime.h>
#include <stdint.h>

__device__ __forceinline__ uint32_t smem_u32(const void* p) {
  return (uint32_t)__cvta_generic_to_shared(p);
}
__device__ __forceinline__ void mma(float (&c)[4], const uint32_t (&a)[4],
                                    uint32_t b0, uint32_t b1) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0,%1,%2,%3}, {%4,%5,%6,%7}, {%8,%9}, {%0,%1,%2,%3};\n"
      : "+f"(c[0]), "+f"(c[1]), "+f"(c[2]), "+f"(c[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b0), "r"(b1));
}
__device__ __forceinline__ void ldsm(uint32_t (&r)[4], uint32_t addr) {
  asm volatile("ldmatrix.sync.aligned.m8n8.x4.shared.b16 {%0,%1,%2,%3}, [%4];\n"
               : "=r"(r[0]), "=r"(r[1]), "=r"(r[2]), "=r"(r[3]) : "r"(addr));
}

// CH independent accumulators a warp
template <int CH>
__global__ void mma_rate(float* out, int iters) {
  const uint32_t a[4] = {threadIdx.x, threadIdx.x + 1, threadIdx.x + 2,
                         threadIdx.x + 3};
  float c[CH][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < CH; ++j) mma(c[j], a, threadIdx.x * 3, threadIdx.x * 5);
  float s = 0.f;
  for (int j = 0; j < CH; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 12345.f) out[0] = s;
}

// rows of pitch 68 words, as the backward's planes (D = 64)
__global__ void ldsm_rate(float* out, int iters) {
  __shared__ uint32_t buf[64 * 68];
  for (int i = threadIdx.x; i < 64 * 68; i += blockDim.x) buf[i] = i;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t addr = smem_u32(buf) + 4 * (((lane & 7) + ((lane >> 3) & 1) * 8)
                                             * 68 + (lane >> 4) * 4);
  uint32_t acc = 0;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) {
      uint32_t r[4];
      ldsm(r, addr + 32 * j);
      acc += r[0] ^ r[1] ^ r[2] ^ r[3];
    }
  if (acc == 12345u) out[0] = acc;
}

// the column reads of the dV/dK/dQ products: rows 2t, 2t + 1, column g
__global__ void lds_rate(float* out, int iters) {
  __shared__ uint32_t buf[64 * 68];
  for (int i = threadIdx.x; i < 64 * 68; i += blockDim.x) buf[i] = i;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const volatile uint32_t* p = buf + 2 * (lane & 3) * 68 + (lane >> 2);
  uint32_t acc = 0;
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int j = 0; j < 8; ++j) acc += p[j * 8] ^ p[j * 8 + 68];
  if (acc == 12345u) out[0] = acc;
}

// per k-step: 8 ldmatrix.x4, then 12 mma.sync on 4 accumulators
__global__ void mix_rate(float* out, int iters) {
  __shared__ uint32_t buf[64 * 68];
  for (int i = threadIdx.x; i < 64 * 68; i += blockDim.x)
    buf[i] = i & 0x3fffe000;
  __syncthreads();
  const int lane = threadIdx.x & 31;
  const uint32_t addr = smem_u32(buf) + 4 * (((lane & 7) + ((lane >> 3) & 1) * 8)
                                             * 68 + (lane >> 4) * 4);
  float c[4][4] = {};
  for (int i = 0; i < iters; ++i)
#pragma unroll
    for (int kk = 0; kk < 8; ++kk) {
      uint32_t f[8][4];
#pragma unroll
      for (int m = 0; m < 8; ++m) ldsm(f[m], addr + 32 * kk + (4352 * m) % 8192);
#pragma unroll
      for (int n = 0; n < 4; ++n)
#pragma unroll
        for (int t = 0; t < 3; ++t)
          mma(c[n], f[n], f[4 + n][t & 1], f[4 + n][2 + (t >> 1)]);
    }
  float s = 0.f;
  for (int j = 0; j < 4; ++j) s += c[j][0] + c[j][1] + c[j][2] + c[j][3];
  if (s == 12345.f) out[0] = s;
}

template <typename K>
void run(const char* name, K kern, int blocks, int threads, int iters,
         double per_warp_iter, const char* unit, double scale) {
  float* out;
  cudaMalloc(&out, 4);
  kern<<<blocks, threads>>>(out, 10);
  cudaEvent_t a, b;
  cudaEventCreate(&a);
  cudaEventCreate(&b);
  cudaEventRecord(a);
  kern<<<blocks, threads>>>(out, iters);
  cudaEventRecord(b);
  cudaEventSynchronize(b);
  float ms;
  cudaEventElapsedTime(&ms, a, b);
  const double total = (double)blocks * threads / 32 * iters * per_warp_iter;
  printf("{\"what\": \"%s\", \"blocks\": %d, \"threads\": %d, \"ms\": %.4f, "
         "\"%s\": %.2f, \"error\": \"%s\"}\n", name, blocks, threads, ms, unit,
         total / (ms * 1e-3) / scale, cudaGetErrorString(cudaGetLastError()));
  cudaFree(out);
}

int main() {
  cudaDeviceProp prop;
  cudaGetDeviceProperties(&prop, 0);
  const int sms = prop.multiProcessorCount;
  printf("{\"device\": \"%s\", \"sms\": %d}\n", prop.name, sms);
  for (int t : {128, 256, 512})
    run("mma.sync tf32, 8 accumulators a warp", mma_rate<8>, 2 * sms, t, 20000,
        8 * 2048, "TFLOP/s", 1e12);
  run("mma.sync tf32, 4 accumulators a warp", mma_rate<4>, sms, 256, 20000,
      4 * 2048, "TFLOP/s", 1e12);
  for (int t : {256, 512})
    run("ldmatrix.x4", ldsm_rate, sms, t, 20000, 8 * 512, "TB/s", 1e12);
  for (int t : {256, 512})
    run("lds.32 column reads", lds_rate, sms, t, 20000, 16 * 128, "TB/s", 1e12);
  for (int t : {256, 512})
    run("8 ldmatrix.x4 + 12 mma.sync a k-step", mix_rate, sms, t, 5000,
        8 * 12 * 2048, "TFLOP/s", 1e12);
  return 0;
}
