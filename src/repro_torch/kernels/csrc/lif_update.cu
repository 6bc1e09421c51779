// Fused LIF membrane update on Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lif_update.py::lif_update
// (_lif_update_kernel), and in its time-loop form the lax.scan LIF of the
// reference engine (src/repro/engine/batched_run.py::_lif_scan):
//
//   v_int = beta * v + I;  s = v_int >= threshold;  v' = s ? v_reset : v_int
//
// One kernel serves both forms: the time loop over cur[B, T, n] from v = 0
// with v dropped (what the engine runs, once per layer), and the single
// clock edge, T = 1 with v read from and written back to memory.
//
// Per (b, n) the walk over t is sequential, one thread carrying v in a
// register; beta * v and + I are rounded separately (__fmul_rn,
// __fadd_rn): the numpy oracle and the float32 reference never fuse them
// into an FMA, so the spikes equal the plain version's bit for bit.
//
// Design.  A block owns one sample b and kCols adjacent neurons (32, 64 or
// 128, chosen by the launcher so that the grid fills the card), one thread
// a neuron.  Time is cut into chunks of `steps` <= kMaxSteps rows; each
// chunk's [steps, kCols] tile of currents is staged in shared memory before
// any thread walks it, so that the chunk crosses from memory in one copy
// instead of one load per step on each thread's dependency chain.  Two
// stages: the copy of chunk k + 1 runs while chunk k is walked.  Where the
// rows allow it (n * 4 a multiple of 16 bytes, both bases 16-byte aligned)
// one thread asks the TMA unit for the chunk as one 3-D box (n, T, B) that
// completes on an mbarrier; the box is zero-filled past n and past T, so
// it never reads another sample's rows.  The spikes go to shared memory
// too and leave as one TMA store of the same box, which the unit clips at
// n and T.
// Other rows (n = 10, 301, ...) take the fallback, lif_rows_kernel on the
// same grid: plain coalesced loads and stores, no staging.
//
// Bound.  Memory: 8 bytes per (b, t, n) (one f32 read, one f32 write) for
// four operations, far below the card's arithmetic rate.  At the engine's
// shapes ([8, 16, 1024] is 1 MB moved) that is a fraction of a
// microsecond, below the launch floor (an empty kernel, about 0.9 us on
// the H100): the kernel is bound by its launch, the copy's latency and the
// chain of T dependent steps of one thread.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time, so nothing links libcuda
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kMaxSteps = 32;  // most time steps a staged chunk holds
constexpr int kMaxDevices = 64;  // devices whose shared-memory ceiling is kept

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ float lds_f32(unsigned addr) {
  float v;
  asm volatile("ld.shared.f32 %0, [%1];\n" : "=f"(v) : "r"(addr));
  return v;
}

__device__ __forceinline__ void sts_f32(unsigned addr, float v) {
  asm volatile("st.shared.f32 [%0], %1;\n" ::"r"(addr), "f"(v));
}

__device__ __forceinline__ void mbar_init(unsigned bar, unsigned count) {
  asm volatile("mbarrier.init.shared::cta.b64 [%0], %1;\n" ::"r"(bar),
               "r"(count));
}

__device__ __forceinline__ void mbar_arrive_tx(unsigned bar, unsigned bytes) {
  asm volatile("mbarrier.arrive.expect_tx.shared::cta.b64 _, [%0], %1;\n" ::"r"(
                   bar),
               "r"(bytes)
               : "memory");
}

__device__ __forceinline__ void mbar_wait(unsigned bar, unsigned parity) {
  asm volatile(
      "{\n"
      " .reg .pred done;\n"
      "WAIT_%=:\n"
      " mbarrier.try_wait.parity.shared::cta.b64 done, [%0], %1;\n"
      " @!done bra WAIT_%=;\n"
      "}\n" ::"r"(bar),
      "r"(parity)
      : "memory");
}

// The box at (column c, step t, sample b) into shared memory; completes on
// bar with the box's full byte count (elements out of bounds read as 0).
__device__ __forceinline__ void tma_load_3d(unsigned dst, const CUtensorMap* map,
                                            int c, int t, int b,
                                            unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.3d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3, %4}], [%5];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(t), "r"(b), "r"(bar)
      : "memory");
}

// The box at (c, t, b) from shared memory; elements out of bounds are not
// written.
__device__ __forceinline__ void tma_store_3d(const CUtensorMap* map, int c,
                                             int t, int b, unsigned src) {
  asm volatile(
      "cp.async.bulk.tensor.3d.global.shared::cta.bulk_group "
      "[%0, {%1, %2, %3}], [%4];\n" ::"l"(reinterpret_cast<uint64_t>(map)),
      "r"(c), "r"(t), "r"(b), "r"(src)
      : "memory");
}

__device__ __forceinline__ void bulk_commit() {
  asm volatile("cp.async.bulk.commit_group;\n" ::: "memory");
}

// Every committed TMA store has read its shared memory.
__device__ __forceinline__ void bulk_wait_read() {
  asm volatile("cp.async.bulk.wait_group.read 0;\n" ::: "memory");
}

// Every committed TMA store is done.
__device__ __forceinline__ void bulk_wait() {
  asm volatile("cp.async.bulk.wait_group 0;\n" ::: "memory");
}

// This thread's shared-memory writes, made visible to the TMA unit.
__device__ __forceinline__ void fence_proxy_async() {
  asm volatile("fence.proxy.async.shared::cta;\n" ::: "memory");
}

// cur, spikes [n_batch, n_steps, n]; blockIdx.x = b * n_tiles + tile.
// Shared memory: [2][steps][kCols] currents, then [2][steps][kCols] spikes.
template <int kCols>
__global__ void __launch_bounds__(kCols)
lif_kernel(const __grid_constant__ CUtensorMap cur_map,
           const __grid_constant__ CUtensorMap spk_map,
           const float* __restrict__ v0, float* __restrict__ v_out,
           int n_tiles, int n_steps, int n, int steps, float beta,
           float threshold, float v_reset) {
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t landed[2];  // chunk k: phase k / 2

  const int j = threadIdx.x;
  const int b = blockIdx.x / n_tiles;
  const int c0 = (blockIdx.x % n_tiles) * kCols;
  const int col = c0 + j;
  const bool live = col < n;
  const unsigned stage_bytes = steps * kCols * 4;
  const unsigned cur_s = smem_u32(smem);
  const unsigned spk_s = cur_s + 2 * stage_bytes;
  const int n_chunks = (n_steps + steps - 1) / steps;

  if (j == 0) {
    mbar_init(smem_u32(&landed[0]), 1);
    mbar_init(smem_u32(&landed[1]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();

  // Chunk k into stage k % 2.  The stage was last read while chunk k - 2
  // was walked, which every thread finished before the barrier that ended
  // chunk k - 1.
  auto issue = [&](int k) {
    if (j == 0) {
      const unsigned bar = smem_u32(&landed[k & 1]);
      mbar_arrive_tx(bar, stage_bytes);
      tma_load_3d(cur_s + (k & 1) * stage_bytes, &cur_map, c0, k * steps, b,
                  bar);
    }
  };

  issue(0);
  float v = (v0 && live) ? v0[(long long)b * n + col] : 0.0f;
  for (int k = 0; k < n_chunks; ++k) {
    if (k + 1 < n_chunks) issue(k + 1);
    const int slot = k & 1;
    mbar_wait(smem_u32(&landed[slot]), (k >> 1) & 1);
    const int rows = min(steps, n_steps - k * steps);
    const unsigned in = cur_s + slot * stage_bytes + j * 4;
    const unsigned out = spk_s + slot * stage_bytes + j * 4;

    // The walk, from shared memory.  Unrolled by 4, not fully: a walk
    // unrolled over all kMaxSteps steps was slower on the card at every
    // shape (PERF.md, section 6); the loads of 4 steps go out together.
#pragma unroll 4
    for (int t = 0; t < rows; ++t) {
      const float v_int =
          __fadd_rn(__fmul_rn(beta, v), lds_f32(in + t * kCols * 4));
      const bool fired = v_int >= threshold;
      sts_f32(out + t * kCols * 4, fired ? 1.0f : 0.0f);
      v = fired ? v_reset : v_int;
    }

    // Chunk k's spikes leave as one box once every thread wrote its
    // column; the store of chunk k - 1 read its stage before the barrier,
    // so chunk k + 1 may overwrite that stage after it.
    fence_proxy_async();
    if (j == 0) bulk_wait_read();
    __syncthreads();
    if (j == 0) {
      tma_store_3d(&spk_map, c0, k * steps, b, spk_s + slot * stage_bytes);
      bulk_commit();
    }
  }
  if (j == 0) bulk_wait();
  if (v_out && live) v_out[(long long)b * n + col] = v;
}

// Rows TMA cannot take (n * 4 not a multiple of 16 bytes, or a base that
// is not 16-byte aligned), on the same grid: each thread walks its neuron
// straight from memory with plain loads, those of 4 steps issued together;
// a warp's loads and stores of a step are one coalesced row segment.
template <int kCols>
__global__ void __launch_bounds__(kCols)
lif_rows_kernel(const float* __restrict__ cur, const float* __restrict__ v0,
                float* __restrict__ v_out, float* __restrict__ spikes,
                int n_tiles, int n_steps, int n, float beta,
                float threshold, float v_reset) {
  const int b = blockIdx.x / n_tiles;
  const int col = (blockIdx.x % n_tiles) * kCols + threadIdx.x;
  if (col >= n) return;
  const long long lane = (long long)b * n_steps * n + col;  // (b, 0, col)
  float v = v0 ? v0[(long long)b * n + col] : 0.0f;
#pragma unroll 4
  for (int t = 0; t < n_steps; ++t) {
    const long long at = lane + (long long)t * n;
    const float v_int = __fadd_rn(__fmul_rn(beta, v), __ldg(cur + at));
    const bool fired = v_int >= threshold;
    spikes[at] = fired ? 1.0f : 0.0f;
    v = fired ? v_reset : v_int;
  }
  if (v_out) v_out[(long long)b * n + col] = v;
}

__global__ void empty_kernel() {}

using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                            void*, const cuuint64_t*, const cuuint64_t*,
                            const cuuint32_t*, const cuuint32_t*,
                            CUtensorMapInterleave, CUtensorMapSwizzle,
                            CUtensorMapL2promotion, CUtensorMapFloatOOBfill);

// A 3-D tensor map (n, n_steps, n_batch) of f32 at p for boxes of
// (cols, steps, 1), or false where the rows are not 16-byte aligned or
// libcuda has no cuTensorMapEncodeTiled.
bool step_map(CUtensorMap* map, const void* p, long long n_batch,
              int n_steps, int n, int cols, int steps) {
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault) != cudaSuccess || !fn)
      return false;
    encode = (Encode)fn;
  }
  if ((long long)n * 4 % 16 != 0 || reinterpret_cast<uintptr_t>(p) % 16 != 0)
    return false;
  const cuuint64_t dims[3] = {(cuuint64_t)n, (cuuint64_t)n_steps,
                              (cuuint64_t)n_batch};
  const cuuint64_t strides[2] = {(cuuint64_t)n * 4,
                                 (cuuint64_t)n * 4 * n_steps};
  const cuuint32_t box[3] = {(cuuint32_t)cols, (cuuint32_t)steps, 1};
  const cuuint32_t unit[3] = {1, 1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_FLOAT32, 3,
                const_cast<void*>(p), dims, strides, box, unit,
                CU_TENSOR_MAP_INTERLEAVE_NONE, CU_TENSOR_MAP_SWIZZLE_NONE,
                CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// lif_kernel where both tensor maps encode, else lif_rows_kernel.
template <int kCols>
int launch(const float* cur, const float* v0, float* v_out, float* spikes,
           long long n_batch, int n_steps, int n, float beta,
           float threshold, float v_reset, cudaStream_t stream) {
  const int steps = n_steps < kMaxSteps ? n_steps : kMaxSteps;
  const int n_tiles = (n + kCols - 1) / kCols;
  const unsigned blocks = (unsigned)(n_batch * n_tiles);
  CUtensorMap cur_map = {}, spk_map = {};
  if (!step_map(&cur_map, cur, n_batch, n_steps, n, kCols, steps) ||
      !step_map(&spk_map, spikes, n_batch, n_steps, n, kCols, steps)) {
    lif_rows_kernel<kCols><<<blocks, kCols, 0, stream>>>(
        cur, v0, v_out, spikes, n_tiles, n_steps, n, beta, threshold,
        v_reset);
    return (int)cudaGetLastError();
  }
  // the shared-memory ceiling is an attribute of the kernel on the current
  // device: set once per device (the launcher makes the data's device
  // current)
  static bool sized[kMaxDevices] = {};
  int dev = 0;
  cudaError_t err = cudaGetDevice(&dev);
  if (err != cudaSuccess) return (int)err;
  if (dev < 0 || dev >= kMaxDevices) return (int)cudaErrorInvalidDevice;
  if (!sized[dev]) {
    err = cudaFuncSetAttribute(lif_kernel<kCols>,
                               cudaFuncAttributeMaxDynamicSharedMemorySize,
                               4 * kMaxSteps * kCols * 4);
    if (err != cudaSuccess) return (int)err;
    sized[dev] = true;
  }
  lif_kernel<kCols><<<blocks, kCols, 4 * steps * kCols * 4, stream>>>(
      cur_map, spk_map, v0, v_out, n_tiles, n_steps, n, steps, beta,
      threshold, v_reset);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// cur, spikes f32 [n_batch, n_steps, n] contiguous; v0, v_out f32
// [n_batch, n] or null (v0 null = start from 0, v_out null = drop v); cols
// the neurons a block owns, 32, 64 or 128.
int lif_scan_f32(const void* cur, const void* v0, void* v_out, void* spikes,
                 long long n_batch, int n_steps, int n, int cols, float beta,
                 float threshold, float v_reset, void* stream) {
  const auto* c = (const float*)cur;
  const auto* v = (const float*)v0;
  auto* vo = (float*)v_out;
  auto* s = (float*)spikes;
  const auto st = (cudaStream_t)stream;
  switch (cols) {
    case 32:
      return launch<32>(c, v, vo, s, n_batch, n_steps, n, beta, threshold,
                        v_reset, st);
    case 64:
      return launch<64>(c, v, vo, s, n_batch, n_steps, n, beta, threshold,
                        v_reset, st);
    case 128:
      return launch<128>(c, v, vo, s, n_batch, n_steps, n, beta, threshold,
                         v_reset, st);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

// An empty kernel of `blocks` blocks of `threads` threads: the launch floor
// that no standalone kernel goes below, timed beside lif_scan_f32.
int empty_launch(long long blocks, int threads, void* stream) {
  empty_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>();
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
