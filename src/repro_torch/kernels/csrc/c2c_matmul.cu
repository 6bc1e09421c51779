// The ideal C2C-ladder MAC as an int8-weight matmul on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/c2c_matmul.py::c2c_matmul
// (_c2c_matmul_kernel):
//
//   out[M, N] = (x[M, K] @ float(w_q[K, N])) * scale
//
// f32 accumulation over K, scale applied once in the epilogue, as the TPU
// kernel does at its last K step.  Every int8 code, -128 included, is
// converted exactly to f32.
//
// Design: a tiled SIMT GEMM.  A block of 256 threads owns one 64 x 64
// output tile and walks K in steps of 16: it stages the x tile (transposed,
// so a k-slice of the tile is contiguous) and the int8 w tile, converted to
// f32 as it is staged, through shared memory; each thread then keeps a
// 4 x 4 block of sums in registers, updated with FFMA.  No tensor cores and
// no TF32: TF32's 10-bit mantissa would miss the reference's tolerance
// (rtol 1e-4, atol 1e-3 at K = 512).  Ragged edges are guarded: a load
// outside the matrix stages 0, a store outside it is skipped.
//
// When the output has too few tiles to fill the card, K is split over
// gridDim.z: each split writes its partial tile to a workspace, and a
// second kernel adds the splits in a fixed order and applies the scale, so
// the result does not depend on the order in which blocks run.
//
// Bound.  Operations: 2 M N K float32 FLOPs against 4 M K + K N + 4 M N
// bytes; at the shapes it is run at (K >= 1024) it is bound by the card's
// float32 rate (67 TFLOP/s outside the tensor cores), not by memory.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 64;
constexpr int BN = 64;
constexpr int BK = 16;
constexpr int TM = 4;
constexpr int TN = 4;
constexpr int THREADS = (BM / TM) * (BN / TN);  // 256

__global__ void __launch_bounds__(THREADS)
c2c_tile_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                float* __restrict__ out, int m, int k, int n, int k_chunk,
                float scale, int apply_scale) {
  __shared__ float xs[BK][BM + 1];   // +1: the transposed stores spread over banks
  __shared__ __align__(16) float ws[BK][BN];
  const int tid = threadIdx.x;
  const int tx = tid % (BN / TN);   // output column group
  const int ty = tid / (BN / TN);   // output row group
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);

  float acc[TM][TN];
#pragma unroll
  for (int i = 0; i < TM; ++i)
#pragma unroll
    for (int j = 0; j < TN; ++j) acc[i][j] = 0.0f;

  for (int k0 = k_begin; k0 < k_end; k0 += BK) {
    // x tile [BM, BK]: neighbouring threads read neighbouring k of a row
#pragma unroll
    for (int i = tid; i < BM * BK; i += THREADS) {
      const int mm = i / BK, kk = i % BK;
      const int gm = m0 + mm, gk = k0 + kk;
      xs[kk][mm] = (gm < m && gk < k_end) ? x[(long long)gm * k + gk] : 0.0f;
    }
    // w tile [BK, BN]: neighbouring threads read neighbouring n of a row
#pragma unroll
    for (int i = tid; i < BK * BN; i += THREADS) {
      const int kk = i / BN, nn = i % BN;
      const int gk = k0 + kk, gn = n0 + nn;
      ws[kk][nn] = (gk < k_end && gn < n)
                       ? (float)w[(long long)gk * n + gn] : 0.0f;
    }
    __syncthreads();
#pragma unroll
    for (int kk = 0; kk < BK; ++kk) {
      float a[TM];
#pragma unroll
      for (int i = 0; i < TM; ++i) a[i] = xs[kk][ty * TM + i];
      const float4 b = *reinterpret_cast<const float4*>(&ws[kk][tx * TN]);
#pragma unroll
      for (int i = 0; i < TM; ++i) {
        acc[i][0] = fmaf(a[i], b.x, acc[i][0]);
        acc[i][1] = fmaf(a[i], b.y, acc[i][1]);
        acc[i][2] = fmaf(a[i], b.z, acc[i][2]);
        acc[i][3] = fmaf(a[i], b.w, acc[i][3]);
      }
    }
    __syncthreads();
  }

  // epilogue: the scale once (one split), or the partial sum into the
  // workspace slice of this split
  float* dst = out + (long long)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < TM; ++i) {
    const int gm = m0 + ty * TM + i;
    if (gm >= m) continue;
#pragma unroll
    for (int j = 0; j < TN; ++j) {
      const int gn = n0 + tx * TN + j;
      if (gn < n)
        dst[(long long)gm * n + gn] = apply_scale ? acc[i][j] * scale
                                                  : acc[i][j];
    }
  }
}

// out[i] = (sum over s in order of part[s][i]) * scale
__global__ void c2c_reduce_kernel(const float* __restrict__ part,
                                  float* __restrict__ out, long long count,
                                  int splits, float scale) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= count) return;
  float s = part[i];
  for (int z = 1; z < splits; ++z) s += part[(long long)z * count + i];
  out[i] = s * scale;
}

}  // namespace

extern "C" {

// x f32 [m, k], w int8 [k, n], out f32 [m, n], all contiguous.  With
// splits > 1, work is f32 [splits, m, n] scratch and k_chunk (a multiple of
// 16) is the K extent of one split; with splits == 1, work may be null.
int c2c_matmul_f32_i8(const void* x, const void* w, void* out, void* work,
                      int m, int k, int n, int k_chunk, int splits,
                      float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  if (splits == 1) {
    c2c_tile_kernel<<<grid, THREADS, 0, s>>>(
        (const float*)x, (const int8_t*)w, (float*)out, m, k, n, k_chunk,
        scale, 1);
    return (int)cudaGetLastError();
  }
  c2c_tile_kernel<<<grid, THREADS, 0, s>>>(
      (const float*)x, (const int8_t*)w, (float*)work, m, k, n, k_chunk,
      scale, 0);
  cudaError_t err = cudaGetLastError();
  if (err != cudaSuccess) return (int)err;
  const long long count = (long long)m * n;
  const int threads = 256;
  c2c_reduce_kernel<<<(unsigned)((count + threads - 1) / threads), threads, 0,
                      s>>>((const float*)work, (float*)out, count, splits,
                           scale);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
