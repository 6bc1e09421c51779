// The grouped SSD scan of the published Mamba2 mixer (Zamba2-7B's), with
// its D skip, on Hopper (sm_90a), in float32.
//
// Replaces no TPU kernel: the JAX package's scan is plain JAX
// (src/repro/models/mamba2.py), which XLA fuses on the TPU.  The port's
// plain version (kernels/ssd_scan.py::ssd_scan_grouped) writes every
// chunk's [B, H, Q, Q] decay-weighted scores to device memory and passes
// over them five times; this kernel keeps every intermediate on chip.
//
// Per head h of group g = h / (H / G), with dt >= 0 and A < 0:
//
//   s[t] = exp(dt[t] A) s[t-1] + dt[t] x[t] B[t]^T     s [P, N], s[-1] = 0
//   y[t] = s[t] C[t] + D x[t]
//
// Chunked as the SSD paper does (arXiv:2405.21060), with cum[t] the
// running sum of dt A inside a chunk of Q steps:
//
//   y[l]  = exp(cum[l]) s_in C[l]                          (carried-in state)
//         + sum_{s<=l} (C[l].B[s]) exp(cum[l]-cum[s]) dt[s] x[s]   (intra)
//         + D x[l]
//   s_out = exp(cum[Q-1]) s_in + sum_s x[s] (exp(cum[Q-1]-cum[s]) dt[s] B[s])^T
//
// Every exponent is <= 0, so nothing overflows.  Float32 operands and
// float32 accumulation throughout, on FMA: no TF32 or bf16 products.  The
// sums are taken in another order than the plain version's (another chunk
// length, a prefix sum by pairs), so the two agree to float32 rounding, not
// bit for bit.
//
// Bound.  Per (batch, head) and chunk, the arithmetic the answer needs is
// the two state products, 2 Q P N each at any chunk length, and the lower
// triangles of C B^T (once per group) and of the intra product, which grow
// with Q.  At the Zamba2-7B chat cell's shape (batch 16, L 2048, H 112,
// P = N = 64, G 2) the state products are 60.1 GFLOP a mixer call and the
// triangles at this kernel's chunk of 64 add 15.5: ~75.7 GFLOP, 1.13 ms at
// the H100's 67 TFLOP/s float32 rate; the bytes, x, B, C and dt read once
// and y and the final state written once, ~1.9 GB, are 0.57 ms at
// 3.35 TB/s.  So the scan is bound by float32 operations, and the design
// is about issuing FMAs from registers with few shared-memory loads each.
//
// Design.  One block of 256 threads per (head, batch): 1792 blocks at the
// cell's shape, two resident per SM (88 KB of shared memory and at most
// 128 registers a thread each), ~7 waves over 132 SMs.  The block walks
// the chunks in order with the state in shared memory (and each thread's
// 4 x 4 share of it in registers), so no second pass and no state in
// device memory: with 1792 independent (batch, head) walks the card is
// full without splitting the sequence.  Per chunk, three products on
// 64 x 64 tiles, each thread owning a 4 x 4 register tile and loading
// operands as float4 from rows padded to 68 floats (no bank conflicts):
//   1. W = tril(C B^T) * exp(cum[l] - cum[s]) * dt[s]; each warp computes
//      only the column blocks of 16 that reach its rows' diagonal (62.5 %
//      of the square);
//   2. y = exp(cum) (C s_in) + W x + D x, the intra product summed only up
//      to the warp's last row (the masked upper triangle is skipped, it
//      adds exactly 0), stored as float4 rows of the contiguous y;
//   3. s_out from B scaled in place by exp(cum[Q-1] - cum[s]) dt[s].
// The operands come in behind the arithmetic as cp.async copies (strided
// rows straight from the conv output, 16 bytes a thread): the next
// chunk's C and B, and dt into registers, during 3., its x during 1.  x, B
// and W rotate through three tiles for it, so the pipeline costs no
// shared memory.  A warp takes the prefix sum of dt A, two steps a lane.
// C B^T is recomputed per head (the block holds one head), about a fifth
// of the issued FMAs; holding several heads of a group in one block would
// share it but halve the blocks and leave a ragged last wave.
//
// Chunk length Q = 64 (the config states 256 for its own chunked
// algorithm; the result differs only in rounding).  The quadratic terms
// grow with Q and the state terms do not, so a shorter chunk does less
// arithmetic (at 64: ~90 GFLOP issued a mixer call, against ~120 at 256),
// and 64 x 64 tiles let five operand tiles of a block fit twice on an SM.
// A shorter chunk still would shrink the register tiles and double the
// block barriers per step.
//
// P and N up to 64, each a multiple of 4 (tiles padded with zeros); H a
// multiple of G; x, B and C rows 16-byte aligned.  The wrapper
// (kernels/ssd_scan.py) checks all of it.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int Q = 64;                 // chunk length
constexpr int TILE = 64;              // the P and N extent of a tile
constexpr int LD = TILE + 4;          // shared row stride, floats
constexpr int THREADS = 256;
constexpr int TILE_FLOATS = Q * LD;
constexpr int SMEM = (5 * TILE_FLOATS + 4 * Q) * 4;

struct Args {
  const float* x;    // x[b, t, h, p] = x + b*xb + t*xt + h*P + p
  const float* B;    // B[b, t, g, n] = B + b*bb + t*bt + g*N + n
  const float* C;    // C[b, t, g, n] = C + b*cb + t*ct + g*N + n
  const float* dt;   // dt[b, t, h] = dt + b*db + t*dtt + h*dh
  const float* A;    // [H]
  const float* D;    // [H]
  float* y;          // [batch, L, H, P] contiguous
  float* state;      // [batch, H, P, N] contiguous
  long long xb, xt, bb, bt, cb, ct, db, dtt, dh;
  int L, H, P, N, G;
};

__device__ __forceinline__ float4 ld4(const float* p) {
  return *reinterpret_cast<const float4*>(p);
}

__device__ __forceinline__ void st4(float* p, float4 v) {
  *reinterpret_cast<float4*>(p) = v;
}

__device__ __forceinline__ float at(const float4& v, int k) {
  return k == 0 ? v.x : k == 1 ? v.y : k == 2 ? v.z : v.w;
}

// Rows t0 .. t0+Q-1 of a strided [L, width] operand into s[Q][LD], zeros
// past L and past width: 16 threads a row, 16 bytes each, as cp.async
// copies (a zero-length source fills with zeros) that the caller commits
// and waits for.
__device__ __forceinline__ void stage(float* s, const float* src,
                                      long long row_stride, int t0, int L,
                                      int width) {
#pragma unroll
  for (int k = 0; k < Q * (TILE / 4) / THREADS; ++k) {
    const int idx = threadIdx.x + k * THREADS;
    const int r = idx >> 4, c = (idx & 15) * 4;
    const bool ok = t0 + r < L && c < width;
    const float* g = ok ? src + (long long)(t0 + r) * row_stride + c : src;
    asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::
                 "r"((unsigned)__cvta_generic_to_shared(s + r * LD + c)),
                 "l"(g), "r"(ok ? 16 : 0));
  }
}

__device__ __forceinline__ void commit() {
  asm volatile("cp.async.commit_group;\n" ::);
}

template <int N>
__device__ __forceinline__ void wait_copies() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N));
}

// acc[i][j] += sum_k a[row_i][k] b[col_j][k] over k < n for the rows
// ty*4+i and the first JN of the columns tx + 16 j (both operands with k
// contiguous): a block of C B^T.
template <int JN>
__device__ __forceinline__ void cb_block(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx,
                                         int n) {
#pragma unroll 2
  for (int k = 0; k < n; k += 4) {
    float4 av[4], bv[JN];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + (ty * 4 + i) * LD + k);
#pragma unroll
    for (int j = 0; j < JN; ++j) bv[j] = ld4(b + (tx + 16 * j) * LD + k);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int j = 0; j < JN; ++j) {
        acc[i][j] = fmaf(av[i].x, bv[j].x, acc[i][j]);
        acc[i][j] = fmaf(av[i].y, bv[j].y, acc[i][j]);
        acc[i][j] = fmaf(av[i].z, bv[j].z, acc[i][j]);
        acc[i][j] = fmaf(av[i].w, bv[j].w, acc[i][j]);
      }
  }
}

// acc[i][j] += sum_k a[ty*4+i][k] b[k][tx*4+j] over k < n (a with k
// contiguous, b with the columns contiguous).
__device__ __forceinline__ void nn_block(float (&acc)[4][4], const float* a,
                                         const float* b, int ty, int tx,
                                         int n) {
#pragma unroll 2
  for (int k = 0; k < n; k += 4) {
    float4 av[4], bv[4];
#pragma unroll
    for (int i = 0; i < 4; ++i) av[i] = ld4(a + (ty * 4 + i) * LD + k);
#pragma unroll
    for (int kk = 0; kk < 4; ++kk) bv[kk] = ld4(b + (k + kk) * LD + tx * 4);
#pragma unroll
    for (int i = 0; i < 4; ++i)
#pragma unroll
      for (int kk = 0; kk < 4; ++kk) {
        const float ak = at(av[i], kk);
        acc[i][0] = fmaf(ak, bv[kk].x, acc[i][0]);
        acc[i][1] = fmaf(ak, bv[kk].y, acc[i][1]);
        acc[i][2] = fmaf(ak, bv[kk].z, acc[i][2]);
        acc[i][3] = fmaf(ak, bv[kk].w, acc[i][3]);
      }
  }
}

__global__ void __launch_bounds__(THREADS, 2) ssd_scan_kernel(const Args a) {
  extern __shared__ __align__(16) float smem[];
  // x, B and W rotate through three tiles: while the state update reads
  // this chunk's x and B, the next chunk's B is copied into W's tile and
  // its C into C's; its x follows under the next C B^T
  float* cs = smem + 3 * TILE_FLOATS;  // C[t][n]
  float* ss = cs + TILE_FLOATS;        // the state, transposed: s[n][p]
  float* cum = ss + TILE_FLOATS;       // running sum of dt A in the chunk
  float* ecum = cum + Q;               // exp(cum)
  float* dtv = ecum + Q;               // dt
  float* dec = dtv + Q;                // exp(cum[Q-1] - cum) dt

  const int h = blockIdx.x, b = blockIdx.y;
  const int g = h / (a.H / a.G);
  const int tid = threadIdx.x, tx = tid & 15, ty = tid >> 4;
  const int warp = tid >> 5, lane = tid & 31;
  const float A = a.A[h], D = a.D[h];
  const float* xsrc = a.x + b * a.xb + (long long)h * a.P;
  const float* bsrc = a.B + b * a.bb + (long long)g * a.N;
  const float* csrc = a.C + b * a.cb + (long long)g * a.N;
  const float* dsrc = a.dt + b * a.db + h * a.dh;
  const long long yrow = (long long)a.H * a.P;
  float* ydst = a.y + (long long)b * a.L * yrow + (long long)h * a.P;

  float sreg[4][4];                    // s[ty*4+i][tx*4+j]
#pragma unroll
  for (int i = 0; i < 4; ++i)
#pragma unroll
    for (int j = 0; j < 4; ++j) sreg[i][j] = 0.f;
  for (int i = tid; i < TILE_FLOATS; i += THREADS) ss[i] = 0.f;

  // chunk 0's C and B, and its dt (warp 0, two steps a lane; steps past L
  // have dt = 0: decay 1, no input)
  stage(cs, csrc, a.ct, 0, a.L, a.N);
  stage(smem, bsrc, a.bt, 0, a.L, a.N);
  commit();
  float d0 = 0.f, d1 = 0.f;
  if (warp == 0) {
    d0 = 2 * lane < a.L ? dsrc[2 * lane * a.dtt] : 0.f;
    d1 = 2 * lane + 1 < a.L ? dsrc[(2 * lane + 1) * a.dtt] : 0.f;
  }

  int ib = 0, ix = 1, iw = 2;
  for (int t0 = 0; t0 < a.L; t0 += Q) {
    float* bs = smem + ib * TILE_FLOATS;  // B[t][n], then scaled
    float* xs = smem + ix * TILE_FLOATS;  // x[t][p]
    float* ws = smem + iw * TILE_FLOATS;  // W[l][s]
    stage(xs, xsrc, a.xt, t0, a.L, a.P);
    commit();
    // ---- the prefix sum of dt A
    if (warp == 0) {
      const float pair = fmaf(d0, A, d1 * A);
      float incl = pair;
#pragma unroll
      for (int off = 1; off < 32; off <<= 1) {
        const float v = __shfl_up_sync(0xffffffffu, incl, off);
        if (lane >= off) incl += v;
      }
      float before = __shfl_up_sync(0xffffffffu, incl, 1);
      if (lane == 0) before = 0.f;
      const float c0 = fmaf(d0, A, before);
      const float c1 = fmaf(d1, A, c0);
      const float last = __shfl_sync(0xffffffffu, c1, 31);
      cum[2 * lane] = c0;
      cum[2 * lane + 1] = c1;
      ecum[2 * lane] = expf(c0);
      ecum[2 * lane + 1] = expf(c1);
      dtv[2 * lane] = d0;
      dtv[2 * lane + 1] = d1;
      dec[2 * lane] = expf(last - c0) * d0;
      dec[2 * lane + 1] = expf(last - c1) * d1;
    }
    wait_copies<1>();                  // C and B; x may still be in flight
    __syncthreads();

    // ---- 1. W = tril(C B^T) exp(cum[l] - cum[s]) dt[s]; warp w holds
    // rows 8w .. 8w+7, which reach column blocks 0 .. w/2 only
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      switch (warp >> 1) {
        case 0: cb_block<1>(acc, cs, bs, ty, tx, a.N); break;
        case 1: cb_block<2>(acc, cs, bs, ty, tx, a.N); break;
        case 2: cb_block<3>(acc, cs, bs, ty, tx, a.N); break;
        default: cb_block<4>(acc, cs, bs, ty, tx, a.N); break;
      }
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const int l = ty * 4 + i;
        const float cl = cum[l];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
          const int s = tx + 16 * j;
          ws[l * LD + s] =
              s <= l ? acc[i][j] * expf(cl - cum[s]) * dtv[s] : 0.f;
        }
      }
    }
    wait_copies<0>();                  // x
    __syncthreads();

    // ---- 2. y; meanwhile B is scaled for the state (2. does not read it)
#pragma unroll
    for (int k = 0; k < Q * (TILE / 4) / THREADS; ++k) {
      const int idx = tid + k * THREADS;
      const int r = idx >> 4, c = (idx & 15) * 4;
      float4 v = ld4(bs + r * LD + c);
      const float f = dec[r];
      v.x *= f; v.y *= f; v.z *= f; v.w *= f;
      st4(bs + r * LD + c, v);
    }
    {
      float acc[4][4];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] = 0.f;
      nn_block(acc, cs, ss, ty, tx, a.N);          // C s_in
#pragma unroll
      for (int i = 0; i < 4; ++i) {
        const float e = ecum[ty * 4 + i];
#pragma unroll
        for (int j = 0; j < 4; ++j) acc[i][j] *= e;
      }
      nn_block(acc, ws, xs, ty, tx, 8 * warp + 8);  // W x, lower triangle
      if (tx * 4 < a.P) {
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const int l = ty * 4 + i;
          if (t0 + l < a.L) {
            const float4 xv = ld4(xs + l * LD + tx * 4);
            st4(ydst + (long long)(t0 + l) * yrow + tx * 4,
                make_float4(fmaf(D, xv.x, acc[i][0]), fmaf(D, xv.y, acc[i][1]),
                            fmaf(D, xv.z, acc[i][2]),
                            fmaf(D, xv.w, acc[i][3])));
          }
        }
      }
    }
    __syncthreads();

    // ---- 3. s_out[n][p] = exp(cum[Q-1]) s_in + sum_s B'[s][n] x[s][p];
    // meanwhile the next chunk's C, B and dt come in
    {
      const int next = t0 + Q;
      if (next < a.L) {
        stage(cs, csrc, a.ct, next, a.L, a.N);
        stage(ws, bsrc, a.bt, next, a.L, a.N);
        commit();
        if (warp == 0) {
          const int t = next + 2 * lane;
          d0 = t < a.L ? dsrc[t * a.dtt] : 0.f;
          d1 = t + 1 < a.L ? dsrc[(t + 1) * a.dtt] : 0.f;
        }
      }
      const float e = ecum[Q - 1];
#pragma unroll
      for (int i = 0; i < 4; ++i)
#pragma unroll
        for (int j = 0; j < 4; ++j) sreg[i][j] *= e;
      const int steps = min(Q, a.L - t0);
#pragma unroll 4
      for (int s = 0; s < steps; ++s) {
        const float4 bv = ld4(bs + s * LD + ty * 4);
        const float4 xv = ld4(xs + s * LD + tx * 4);
#pragma unroll
        for (int i = 0; i < 4; ++i) {
          const float bi = at(bv, i);
          sreg[i][0] = fmaf(bi, xv.x, sreg[i][0]);
          sreg[i][1] = fmaf(bi, xv.y, sreg[i][1]);
          sreg[i][2] = fmaf(bi, xv.z, sreg[i][2]);
          sreg[i][3] = fmaf(bi, xv.w, sreg[i][3]);
        }
      }
#pragma unroll
      for (int i = 0; i < 4; ++i)
        st4(ss + (ty * 4 + i) * LD + tx * 4,
            make_float4(sreg[i][0], sreg[i][1], sreg[i][2], sreg[i][3]));
    }
    __syncthreads();
    // the next chunk's B is in W's tile; its x goes to B's, its W to x's
    const int nb = iw;
    iw = ix;
    ix = ib;
    ib = nb;
  }

  // the final state, [P][N] rows from the transposed tile
  float* sdst = a.state + ((long long)b * a.H + h) * a.P * a.N;
  for (int idx = tid; idx < a.P * a.N; idx += THREADS) {
    const int p = idx / a.N, n = idx - p * a.N;
    sdst[idx] = ss[n * LD + p];
  }
}

}  // namespace

extern "C" {

// x, B, C, dt f32 with the strides above (elements; the last dim of each
// contiguous), A and D f32 [H], y f32 [batch, L, H, P] and state f32
// [batch, H, P, N] contiguous.  P, N <= 64 and multiples of 4; H a
// multiple of G; L >= 1.
int ssd_scan_f32(const void* x, const void* B, const void* C, const void* dt,
                 const void* A, const void* D, void* y, void* state,
                 long long xb, long long xt, long long bb, long long bt,
                 long long cb, long long ct, long long db, long long dtt,
                 long long dh, int batch, int L, int H, int P, int N, int G,
                 void* stream) {
  cudaError_t err = cudaFuncSetAttribute(
      ssd_scan_kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, SMEM);
  if (err != cudaSuccess) return (int)err;
  Args a{(const float*)x, (const float*)B, (const float*)C, (const float*)dt,
         (const float*)A, (const float*)D, (float*)y, (float*)state,
         xb, xt, bb, bt, cb, ct, db, dtt, dh, L, H, P, N, G};
  ssd_scan_kernel<<<dim3(H, batch), THREADS, SMEM, (cudaStream_t)stream>>>(a);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
