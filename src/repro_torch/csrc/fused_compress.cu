// Fused 8x8 DCT + keep-k truncation + per-tile int8 quantization.
//
// Replaces: src/repro/kernels/fused_compress/kernel.py::compress_plane_pallas
//           (_compress_kernel), the TPU kernel that runs the KV prefill bulk
//           compression and every decode-step tail flush.
//
// Computes, for every 8x8 tile X of an (R, C) plane (row-major, f32 or bf16):
//   z     = C8[:k] X C8[:k]^T                  (k x k low-frequency corner)
//   scale = max(max|z|, 1e-8) / 127
//   q     = clip(rint(z / scale), -127, 127)   (round half to even, divide)
// and writes the blocks layout q (R/8, C/8, k, k) int8, scale (R/8, C/8) f32.
//
// Bound on this card: HBM bytes.  The tile reads R*C*elem bytes and writes
// R*C*k*k/64 + 4*R*C/64; the separable transform is ~2*8*8*(8+k) flops per
// 64 elements, far below the ~20 flop/byte the H100's f32 CUDA cores need
// to become the limit.
//
// Design: one warp per tile, eight tiles per 256-thread block.  Lanes read
// the tile's eight 32-byte row segments (adjacent warps read adjacent
// segments, so every 32-byte sector fetched is fully used), stage it in
// shared memory, run the row pass then the column pass against C8[:k] held
// in __constant__ memory, reduce |z| across the warp with shuffles, and
// store each tile's k*k bytes contiguously.  Only the compressed form is
// ever written back.  keep is a template parameter (1..8).
#include <cuda_runtime.h>
#include <cuda_bf16.h>
#include <stdint.h>

namespace {

__constant__ float fc_dct[64];  // C8, row-major: fc_dct[u * 8 + a] = C[u][a]

constexpr int kTilesPerBlock = 8;

__device__ __forceinline__ float to_f32(float v) { return v; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 v) { return __bfloat162float(v); }

template <typename T, int K>
__global__ void __launch_bounds__(32 * kTilesPerBlock)
compress_kernel(const T* __restrict__ x, long long cols, long long ntiles,
                long long tiles_per_row, int8_t* __restrict__ q,
                float* __restrict__ scale) {
  __shared__ float xs[kTilesPerBlock][8][9];
  __shared__ float ys[kTilesPerBlock][8][9];
  const int warp = threadIdx.x >> 5;
  const int lane = threadIdx.x & 31;
  const long long tile = (long long)blockIdx.x * kTilesPerBlock + warp;
  if (tile >= ntiles) return;  // whole warp leaves; only warp syncs below
  const long long tr = tile / tiles_per_row;
  const long long tc = tile - tr * tiles_per_row;
  const T* src = x + tr * 8 * cols + tc * 8;
#pragma unroll
  for (int e = lane; e < 64; e += 32) {
    xs[warp][e >> 3][e & 7] = to_f32(src[(e >> 3) * cols + (e & 7)]);
  }
  __syncwarp();
  // row pass: Y[u][b] = sum_a C[u][a] X[a][b]
  for (int e = lane; e < K * 8; e += 32) {
    const int u = e >> 3, b = e & 7;
    float acc = 0.f;
#pragma unroll
    for (int a = 0; a < 8; ++a) acc = fmaf(fc_dct[u * 8 + a], xs[warp][a][b], acc);
    ys[warp][u][b] = acc;
  }
  __syncwarp();
  // column pass: Z[u][v] = sum_b Y[u][b] C[v][b]
  float z[2];
  float amax = 0.f;
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = lane + 32 * i;
    z[i] = 0.f;
    if (e < K * K) {
      const int u = e / K, v = e % K;
      float acc = 0.f;
#pragma unroll
      for (int b = 0; b < 8; ++b) acc = fmaf(ys[warp][u][b], fc_dct[v * 8 + b], acc);
      z[i] = acc;
      amax = fmaxf(amax, fabsf(acc));
    }
  }
#pragma unroll
  for (int off = 16; off > 0; off >>= 1) {
    amax = fmaxf(amax, __shfl_xor_sync(0xffffffffu, amax, off));
  }
  const float s = fmaxf(amax, 1e-8f) / 127.0f;
  int8_t* dst = q + tile * (K * K);
#pragma unroll
  for (int i = 0; i < 2; ++i) {
    const int e = lane + 32 * i;
    if (e < K * K) {
      const float r = fminf(fmaxf(rintf(z[i] / s), -127.f), 127.f);
      dst[e] = (int8_t)r;
    }
  }
  if (lane == 0) scale[tile] = s;
}

template <typename T>
void launch(const void* x, long long rows, long long cols, int keep, void* q,
            void* scale, cudaStream_t stream) {
  const long long tiles_per_row = cols / 8;
  const long long ntiles = (rows / 8) * tiles_per_row;
  const dim3 grid((unsigned)((ntiles + kTilesPerBlock - 1) / kTilesPerBlock));
  const dim3 block(32 * kTilesPerBlock);
  const T* xp = static_cast<const T*>(x);
  int8_t* qp = static_cast<int8_t*>(q);
  float* sp = static_cast<float*>(scale);
  switch (keep) {
#define FC_CASE(K) \
    case K: compress_kernel<T, K><<<grid, block, 0, stream>>>(xp, cols, ntiles, tiles_per_row, qp, sp); break;
    FC_CASE(1) FC_CASE(2) FC_CASE(3) FC_CASE(4)
    FC_CASE(5) FC_CASE(6) FC_CASE(7) FC_CASE(8)
#undef FC_CASE
    default: break;
  }
}

}  // namespace

extern "C" int fc_set_dct(const void* host_c8) {
  const cudaError_t err = cudaMemcpyToSymbol(fc_dct, host_c8, 64 * sizeof(float));
  return err != cudaSuccess ? (int)err : (int)cudaGetLastError();
}

// x: (rows, cols) row-major f32 (x_is_bf16 = 0) or bf16 (1); rows, cols
// multiples of 8; keep in 1..8.  q, scale: preallocated outputs.
extern "C" int fc_compress_plane(const void* x, int x_is_bf16, long long rows,
                                 long long cols, int keep, void* q,
                                 void* scale, void* stream) {
  if (keep < 1 || keep > 8 || rows % 8 || cols % 8) return (int)cudaErrorInvalidValue;
  cudaStream_t s = static_cast<cudaStream_t>(stream);
  if (x_is_bf16) {
    launch<__nv_bfloat16>(x, rows, cols, keep, q, scale, s);
  } else {
    launch<float>(x, rows, cols, keep, q, scale, s);
  }
  return (int)cudaGetLastError();
}
