// The ideal C2C-ladder MAC as an int8-weight matmul on Hopper (sm_90a).
//
// Replaces the Pallas TPU kernel src/repro/kernels/c2c_matmul.py::c2c_matmul
// (_c2c_matmul_kernel):
//
//   out[M, N] = (x[M, K] @ float(w_q[K, N])) * scale
//
// f32 accumulation over K, scale applied once in the epilogue, as the TPU
// kernel does at its last K step.
//
// Numerics: the tensor cores through a two-term TF32 split of x.  Every
// int8 code, -128 included, has at most 8 significant bits and is exact
// in TF32 (11), so w needs no split.  x is split as x_hi = tf32_rna(x) and
// x_lo = tf32_rna(x - x_hi) (x - x_hi is exact in f32).  With u = 2^-11
// the unit roundoff of TF32's round-to-nearest, |x - x_hi| <= u |x| and
// |x - x_hi - x_lo| <= u |x - x_hi| <= u^2 |x| = 2^-22 |x|, so
//
//   x w = x_hi w + x_lo w + r w,   |r w| <= 2^-22 |x| |w|,
//
// and each of the two products of 11-bit significands is exact in the
// f32 accumulator.  Summed over K the split's error is at most 2^-22
// (|x| @ |w_q|) = 4 * 2^-24 (|x| @ |w_q|), (K + 1) / 2 times below the
// stated tolerance 2 (K + 1) 2^-24 (|x| @ |w_q|) (times |scale| on both);
// the rest of the tolerance covers the accumulation's rounding.  One term
// is not enough: its error of up to 2^-11 |x| |w| per product exceeds the
// tolerance at K = 1024 (tests/test_torch_kernels.py emulates both).
// With 0/1 inputs x_lo = 0 and every partial sum is an integer below
// 2^24, exact in any order.
//
// Design: mma.sync.m16n8k8 TF32 with f32 accumulators, two MMAs (x_lo,
// then x_hi) per product.  The tensor cores do not round their f32
// accumulation to nearest, and over a long K that loses several times
// what a rounded float32 sum does; so each K step of 32 is summed in
// fresh fragments and added to the running sums with __fadd_rn.  A block
// of 256 threads (8 warps as 2 x 4, a warp tile of 64 x 32) owns a 128 x
// 128 output tile and walks K in steps of 32.  The raw x and int8 w tiles
// of a step come in through a ring of kRaw cp.async stages, 16 bytes a
// thread; one step ahead of the MMAs, each thread converts its share of
// the next step once per block: x into x_hi and x_lo, w into TF32 bit
// patterns, into one of two converted buffers whose rows are padded so
// that the fragment loads hit 32 distinct banks.  One block barrier per K
// step.  Where K is not a multiple of 4 or N of 16 (rows not 16-byte
// aligned), the conversion reads x and w from memory instead, guarded.
// Ragged edges stage 0 and skip their stores.
//
// When the output has too few tiles to fill the card, K is split over
// gridDim.z: each split writes its partial tile to a workspace, and a
// second kernel adds the splits in a fixed order and applies the scale, so
// the result does not depend on the order in which blocks run.  No atomics.
//
// Bound.  Operations: two TF32 MMAs per multiply-add, 4 M N K operations
// at 495 TFLOP/s (the H100's dense TF32 rate), against 4 M K + K N + 4 M N
// bytes at 3.35 TB/s.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int BM = 128;
constexpr int BN = 128;
constexpr int BK = 32;
constexpr int THREADS = 256;
constexpr int WARPS_N = 4;            // warps along N; 2 along M
constexpr int WM = BM / 2;            // warp tile rows: 64
constexpr int WN = BN / WARPS_N;      // warp tile columns: 32
constexpr int MI = WM / 16;           // m16 tiles a warp: 4
constexpr int NI = WN / 8;            // n8 tiles a warp: 4
constexpr int kRaw = 3;               // raw cp.async stages
constexpr int XLD = BK + 4;           // converted x row stride (floats)
constexpr int WLD = BN + 8;           // converted w row stride (floats)
constexpr int RAW_X = BM * BK * 4;    // raw x stage bytes
constexpr int RAW_W = BK * BN;        // raw w stage bytes
constexpr int RAW_BYTES = kRaw * (RAW_X + RAW_W);
constexpr int CONV_FLOATS = 2 * BM * XLD + BK * WLD;  // x_hi, x_lo, w
constexpr int SMEM = RAW_BYTES + 2 * CONV_FLOATS * 4;

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

__device__ __forceinline__ float tf32_rna(float x) {
  unsigned r;
  asm("cvt.rna.tf32.f32 %0, %1;\n" : "=r"(r) : "f"(x));
  return __uint_as_float(r);
}

// d += a @ b on one m16n8k8 TF32 tile
__device__ __forceinline__ void mma_tf32(float (&d)[4], const unsigned (&a)[4],
                                         const unsigned (&b)[2]) {
  asm volatile(
      "mma.sync.aligned.m16n8k8.row.col.f32.tf32.tf32.f32 "
      "{%0, %1, %2, %3}, {%4, %5, %6, %7}, {%8, %9}, {%0, %1, %2, %3};\n"
      : "+f"(d[0]), "+f"(d[1]), "+f"(d[2]), "+f"(d[3])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(b[0]), "r"(b[1]));
}

__global__ void __launch_bounds__(THREADS, 1)
c2c_tile_kernel(const float* __restrict__ x, const int8_t* __restrict__ w,
                float* __restrict__ out, int m, int k, int n, int k_chunk,
                float scale, int apply_scale, int aligned) {
  extern __shared__ __align__(128) unsigned char smem[];
  // raw stages: [kRaw][BM][BK] f32 x, then [kRaw][BK][BN] int8 w;
  // converted buffers: [2][x_hi BM x XLD, x_lo BM x XLD, w BK x WLD] f32
  float* conv = reinterpret_cast<float*>(smem + RAW_BYTES);
  const unsigned raw_x = smem_u32(smem);
  const unsigned raw_w = raw_x + kRaw * RAW_X;

  const int tid = threadIdx.x;
  const int lane = tid % 32, warp = tid / 32;
  const int g = lane / 4, c = lane % 4;  // the fragments' group and column
  const int wm = (warp / WARPS_N) * WM, wn = (warp % WARPS_N) * WN;
  const int m0 = blockIdx.y * BM;
  const int n0 = blockIdx.x * BN;
  const int k_begin = blockIdx.z * k_chunk;
  const int k_end = min(k, k_begin + k_chunk);
  const int steps = (k_end - k_begin + BK - 1) / BK;

  // Step t's raw tiles into ring slot t % kRaw: x 4 granules a thread,
  // w 1; granules outside the matrix or past k_end are zero-filled.
  auto load = [&](int t) {
    if (t >= steps) return;
    const int k0 = k_begin + t * BK, slot = t % kRaw;
#pragma unroll
    for (int j = 0; j < BM * BK / 4 / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int row = i / (BK / 4), kk = (i % (BK / 4)) * 4;
      const int gm = m0 + row, gk = k0 + kk;
      const bool in = gm < m && gk < k_end;
      cp_async16(raw_x + slot * RAW_X + (row * BK + kk) * 4,
                 in ? x + (long long)gm * k + gk : x, in ? 16 : 0);
    }
    {
      const int kk = tid / (BN / 16), nn = (tid % (BN / 16)) * 16;
      const int gk = k0 + kk, gn = n0 + nn;
      const bool in = gk < k_end && gn < n;
      cp_async16(raw_w + slot * RAW_W + kk * BN + nn,
                 in ? w + (long long)gk * n + gn : w, in ? 16 : 0);
    }
  };

  // Step t's tiles converted into buffer t % 2: x as x_hi and x_lo, w as
  // floats (exact TF32 bit patterns), each element once.
  auto convert = [&](int t) {
    if (t >= steps) return;
    const int k0 = k_begin + t * BK, slot = t % kRaw;
    float* xh = conv + (t & 1) * CONV_FLOATS;
    float* xl = xh + BM * XLD;
    float* wc = xl + BM * XLD;
#pragma unroll
    for (int j = 0; j < BM * BK / 4 / THREADS; ++j) {
      const int i = tid + j * THREADS;
      const int row = i / (BK / 4), kk = (i % (BK / 4)) * 4;
      float v[4];
      if (aligned) {
        const float4 q = *reinterpret_cast<const float4*>(
            smem + slot * RAW_X + (row * BK + kk) * 4);
        v[0] = q.x; v[1] = q.y; v[2] = q.z; v[3] = q.w;
      } else {
        const int gm = m0 + row;
#pragma unroll
        for (int e = 0; e < 4; ++e) {
          const int gk = k0 + kk + e;
          v[e] = gm < m && gk < k_end ? x[(long long)gm * k + gk] : 0.0f;
        }
      }
      float4 hi, lo;
      hi.x = tf32_rna(v[0]); lo.x = tf32_rna(v[0] - hi.x);
      hi.y = tf32_rna(v[1]); lo.y = tf32_rna(v[1] - hi.y);
      hi.z = tf32_rna(v[2]); lo.z = tf32_rna(v[2] - hi.z);
      hi.w = tf32_rna(v[3]); lo.w = tf32_rna(v[3] - hi.w);
      *reinterpret_cast<float4*>(xh + row * XLD + kk) = hi;
      *reinterpret_cast<float4*>(xl + row * XLD + kk) = lo;
    }
    {
      const int kk = tid / (BN / 16), nn = (tid % (BN / 16)) * 16;
      int8_t q[16];
      if (aligned) {
        *reinterpret_cast<int4*>(q) = *reinterpret_cast<const int4*>(
            smem + kRaw * RAW_X + slot * RAW_W + kk * BN + nn);
      } else {
        const int gk = k0 + kk;
#pragma unroll
        for (int e = 0; e < 16; ++e) {
          const int gn = n0 + nn + e;
          q[e] = gk < k_end && gn < n ? w[(long long)gk * n + gn] : 0;
        }
      }
#pragma unroll
      for (int e = 0; e < 16; e += 4)
        *reinterpret_cast<float4*>(wc + kk * WLD + nn + e) =
            make_float4((float)q[e], (float)q[e + 1], (float)q[e + 2],
                        (float)q[e + 3]);
    }
  };

  float acc[MI][NI][4];
#pragma unroll
  for (int i = 0; i < MI; ++i)
#pragma unroll
    for (int j = 0; j < NI; ++j)
#pragma unroll
      for (int e = 0; e < 4; ++e) acc[i][j][e] = 0.0f;

  // Prologue: raw steps 0 .. kRaw - 1 in flight (group t holds step t),
  // step 0 converted.
  if (aligned) {
#pragma unroll
    for (int t = 0; t < kRaw; ++t) {
      load(t);
      cp_async_commit();
    }
    cp_async_wait<kRaw - 1>();
    __syncthreads();
  }
  convert(0);

  for (int t = 0; t < steps; ++t) {
    // Raw step t + 1 landed; buffer t % 2 converted; every thread is done
    // with the MMAs of step t - 1 and the conversion of raw step t.
    if (aligned) cp_async_wait<kRaw - 2>();
    __syncthreads();
    if (aligned) {
      load(t + kRaw);  // into the slot of raw step t, converted already
      cp_async_commit();
    }
    convert(t + 1);

    const float* xh = conv + (t & 1) * CONV_FLOATS;
    const float* xl = xh + BM * XLD;
    const float* wc = xl + BM * XLD;
    float part[MI][NI][4];
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e) part[i][j][e] = 0.0f;
#pragma unroll
    for (int ks = 0; ks < BK; ks += 8) {
      unsigned b[NI][2];
#pragma unroll
      for (int j = 0; j < NI; ++j) {
        const float* p = wc + (ks + c) * WLD + wn + j * 8 + g;
        b[j][0] = __float_as_uint(p[0]);
        b[j][1] = __float_as_uint(p[4 * WLD]);
      }
#pragma unroll
      for (int i = 0; i < MI; ++i) {
        const int r0 = (wm + i * 16 + g) * XLD + ks + c;
        const unsigned lo[4] = {
            __float_as_uint(xl[r0]), __float_as_uint(xl[r0 + 8 * XLD]),
            __float_as_uint(xl[r0 + 4]), __float_as_uint(xl[r0 + 8 * XLD + 4])};
        const unsigned hi[4] = {
            __float_as_uint(xh[r0]), __float_as_uint(xh[r0 + 8 * XLD]),
            __float_as_uint(xh[r0 + 4]), __float_as_uint(xh[r0 + 8 * XLD + 4])};
#pragma unroll
        for (int j = 0; j < NI; ++j) {
          mma_tf32(part[i][j], lo, b[j]);
          mma_tf32(part[i][j], hi, b[j]);
        }
      }
    }
#pragma unroll
    for (int i = 0; i < MI; ++i)
#pragma unroll
      for (int j = 0; j < NI; ++j)
#pragma unroll
        for (int e = 0; e < 4; ++e)
          acc[i][j][e] = __fadd_rn(acc[i][j][e], part[i][j][e]);
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  // epilogue: the scale once (one split), or the partial sum into the
  // workspace slice of this split
  float* dst = out + (long long)blockIdx.z * m * n;
#pragma unroll
  for (int i = 0; i < MI; ++i) {
#pragma unroll
    for (int h = 0; h < 2; ++h) {
      const int gm = m0 + wm + i * 16 + g + h * 8;
      if (gm >= m) continue;
#pragma unroll
      for (int j = 0; j < NI; ++j) {
#pragma unroll
        for (int e = 0; e < 2; ++e) {
          const int gn = n0 + wn + j * 8 + 2 * c + e;
          const float v = acc[i][j][2 * h + e];
          if (gn < n) dst[(long long)gm * n + gn] = apply_scale ? v * scale : v;
        }
      }
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
// 32) is the K extent of one split; with splits == 1, work may be null.
int c2c_matmul_f32_i8(const void* x, const void* w, void* out, void* work,
                      int m, int k, int n, int k_chunk, int splits,
                      float scale, void* stream) {
  cudaStream_t s = (cudaStream_t)stream;
  cudaError_t err = cudaFuncSetAttribute(
      c2c_tile_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  const int aligned = k % 4 == 0 && n % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(x) % 16 == 0 &&
                      reinterpret_cast<uintptr_t>(w) % 16 == 0;
  const dim3 grid((n + BN - 1) / BN, (m + BM - 1) / BM, splits);
  c2c_tile_kernel<<<grid, THREADS, SMEM, s>>>(
      (const float*)x, (const int8_t*)w, (float*)(splits == 1 ? out : work),
      m, k, n, k_chunk, scale, splits == 1, aligned);
  err = cudaGetLastError();
  if (err != cudaSuccess || splits == 1) return (int)err;
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
