// Fused LIF membrane update on Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernel src/repro/kernels/lif_update.py::lif_update
// (_lif_update_kernel), and in its time-loop form the lax.scan LIF of the
// reference engine (src/repro/engine/batched_run.py::_lif_scan):
//
//   v_int = beta * v + I;  s = v_int >= threshold;  v' = s ? v_reset : v_int
//
// One thread owns one neuron (b, n) and carries v in a register over T
// steps: it reads I[b, t, n] once per step and writes s[b, t, n] once, so a
// whole layer's LIF is one launch instead of T elementwise passes.  The
// single-step form is T = 1 with v read from and written back to memory.
// Neighbouring threads own neighbouring n, so every load and store of a
// step is coalesced.
//
// beta * v and + I are rounded separately (__fmul_rn, __fadd_rn): the numpy
// oracle and the float32 reference never fuse them into an FMA.
//
// Bound.  Memory: 8 bytes per (b, t, n) (one f32 read, one f32 write) for
// four operations, far below the card's arithmetic rate.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

__global__ void lif_kernel(const float* __restrict__ cur,
                           const float* __restrict__ v0,
                           float* __restrict__ v_out,
                           float* __restrict__ spikes, long long n_lanes,
                           int n_steps, int n, float beta, float threshold,
                           float v_reset) {
  const long long i = (long long)blockIdx.x * blockDim.x + threadIdx.x;
  if (i >= n_lanes) return;
  const long long b = i / n;
  const long long off = b * (long long)n_steps * n + (i - b * n);
  float v = v0 ? v0[i] : 0.0f;
  for (int t = 0; t < n_steps; ++t) {
    const long long at = off + (long long)t * n;
    const float v_int = __fadd_rn(__fmul_rn(beta, v), cur[at]);
    const bool fired = v_int >= threshold;
    spikes[at] = fired ? 1.0f : 0.0f;
    v = fired ? v_reset : v_int;
  }
  if (v_out) v_out[i] = v;
}

}  // namespace

extern "C" {

// cur, spikes f32 [n_batch, n_steps, n] contiguous; v0, v_out f32
// [n_batch, n] or null (v0 null = start from 0, v_out null = drop v).
int lif_scan_f32(const void* cur, const void* v0, void* v_out, void* spikes,
                 long long n_batch, int n_steps, int n, float beta,
                 float threshold, float v_reset, void* stream) {
  const long long n_lanes = n_batch * (long long)n;
  const int threads = 256;
  const long long blocks = (n_lanes + threads - 1) / threads;
  lif_kernel<<<(unsigned)blocks, threads, 0, (cudaStream_t)stream>>>(
      (const float*)cur, (const float*)v0, (float*)v_out, (float*)spikes,
      n_lanes, n_steps, n, beta, threshold, v_reset);
  return (int)cudaGetLastError();
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
