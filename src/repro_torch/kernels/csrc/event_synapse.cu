// Event-driven synaptic accumulation on Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/event_synapse.py:
//   event_synapse_f32        <- event_synapse        (_event_synapse_kernel)
//   event_synapse_packed_i8  <- event_synapse_packed (_event_synapse_packed_kernel)
//
//   out[r, d] = sum over the events e of row r, in ascending e, of W[ev[r, e], d]
//
// The event list of a row is compacted (valid sources first, -1 padding
// after), so each row stops at its first -1: padding only ever adds +0.0,
// so the early stop is exact, and a silent row costs one shared-memory read.
//
// Design.  One block per (row block, dest tile): kRows rows x kCols
// destination columns, one thread per (row, column).  The rows' event lists
// are staged in shared memory kChunk events at a time (a full row at
// E = 32768 would be 128 KB).  Every thread of a row walks the same event
// list, and a warp's 32 weight loads per event are one contiguous 128-byte
// segment of the event's weight row.  Staging records where each row's
// first -1 falls, so the event loop has a known length and is unrolled:
// several rows' loads are in flight at once instead of one per thread.
// Each thread keeps one float32 sum and adds in event order with __fadd_rn
// (and, for packed codes, __fmul_rn for the dequantisation): no split-K,
// no atomics, no tensor cores and no fused multiply-add, so the result
// equals the sequential float32 sum of the numpy oracle bit for bit.
//
// Bound.  Memory: each valid event reads one weight row of n_dest values.
// At the CIFAR10-DVS input layer the fused tile is 32768 x 1024 f32
// (134 MB), larger than the 50 MB L2, so the rows come from HBM; the work
// is a gather at one add per loaded value, far below the card's
// arithmetic rate.  Packed codes cut the bytes per row to n_dest*bits/8.

#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kRows = 4;     // event rows per block (threadIdx.y)
constexpr int kCols = 128;   // destination columns per block (threadIdx.x)
constexpr int kChunk = 512;  // events staged per row per pass

struct DenseRows {
  const float* __restrict__ w;
  long long ld;  // row stride of W, in floats
  __device__ __forceinline__ float operator()(int src, int d) const {
    return w[(long long)src * ld + d];
  }
};

// Sign-magnitude codes, 8/BITS destination lanes per byte, lane j of a row
// in byte j / (8/BITS) at bit offset (j % (8/BITS)) * BITS.
template <int BITS>
struct PackedRows {
  const int8_t* __restrict__ w;
  long long ld;  // row stride of the packed tile, in bytes
  float scale;
  __device__ __forceinline__ float operator()(int src, int d) const {
    constexpr int kLanes = 8 / BITS;
    const unsigned byte = (unsigned)(uint8_t)w[(long long)src * ld + d / kLanes];
    const unsigned word = (byte >> ((d % kLanes) * BITS)) & ((1u << BITS) - 1u);
    const int mag = (int)(word & ((1u << (BITS - 1)) - 1u));
    const int q = ((word >> (BITS - 1)) & 1u) ? -mag : mag;
    return __fmul_rn((float)q, scale);
  }
};

template <class Rows>
__global__ void __launch_bounds__(kRows * kCols)
event_synapse_kernel(const int32_t* __restrict__ events, long long ev_ld,
                     Rows rows, float* __restrict__ out,
                     int n_rows, int n_events, int n_dest) {
  __shared__ int32_t ev_s[kRows][kChunk];
  __shared__ int n_valid[kRows];  // position of the first -1 in the chunk
  const int ty = threadIdx.y;
  const int tid = ty * kCols + threadIdx.x;
  const long long row0 = (long long)blockIdx.x * kRows;
  const long long r = row0 + ty;
  const int d = blockIdx.y * kCols + threadIdx.x;

  float acc = 0.0f;
  bool done = r >= n_rows;
  for (int base = 0; base < n_events; base += kChunk) {
    const int len = min(kChunk, n_events - base);
    if (tid < kRows) n_valid[tid] = len;
    __syncthreads();
    for (int i = tid; i < kRows * len; i += kRows * kCols) {
      const int rr = i / len;
      const int k = i % len;
      const long long gr = row0 + rr;
      const int32_t src = gr < n_rows ? events[gr * ev_ld + base + k] : -1;
      ev_s[rr][k] = src;
      if (src < 0) atomicMin(&n_valid[rr], k);
    }
    __syncthreads();
    if (!done) {
      const int n = n_valid[ty];
      if (d < n_dest) {
        // the loads of consecutive events are independent: unrolling keeps
        // several weight rows in flight while the adds stay in event order
#pragma unroll 8
        for (int k = 0; k < n; ++k) acc = __fadd_rn(acc, rows(ev_s[ty][k], d));
      }
      done = n < len;
    }
    // also the barrier that keeps the next chunk from overwriting ev_s
    // while another row of the block still reads it
    if (!__syncthreads_or(!done)) break;
  }
  if (r < n_rows && d < n_dest) out[r * n_dest + d] = acc;
}

template <class Rows>
int launch(const void* events, long long ev_ld, Rows rows, void* out,
           int n_rows, int n_events, int n_dest, void* stream) {
  const dim3 block(kCols, kRows);
  const dim3 grid((n_rows + kRows - 1) / kRows, (n_dest + kCols - 1) / kCols);
  event_synapse_kernel<Rows><<<grid, block, 0, (cudaStream_t)stream>>>(
      (const int32_t*)events, ev_ld, rows, (float*)out, n_rows, n_events,
      n_dest);
  return (int)cudaGetLastError();
}

}  // namespace

extern "C" {

// events i32 [n_rows, n_events] (row stride ev_ld), w f32 [n_src, n_dest]
// (row stride w_ld), out f32 [n_rows, n_dest] contiguous.
int event_synapse_f32(const void* events, long long ev_ld, const void* w,
                      long long w_ld, void* out, int n_rows, int n_events,
                      int n_dest, void* stream) {
  return launch(events, ev_ld, DenseRows{(const float*)w, w_ld}, out, n_rows,
                n_events, n_dest, stream);
}

// packed i8 [n_src, n_dest * bits / 8] (row stride w_ld bytes), bits in
// {2, 4, 8}; each code is dequantised as fl32(q * scale) before its add.
int event_synapse_packed_i8(const void* events, long long ev_ld,
                            const void* packed, long long w_ld, float scale,
                            int bits, void* out, int n_rows, int n_events,
                            int n_dest, void* stream) {
  const int8_t* w = (const int8_t*)packed;
  switch (bits) {
    case 2:
      return launch(events, ev_ld, PackedRows<2>{w, w_ld, scale}, out,
                    n_rows, n_events, n_dest, stream);
    case 4:
      return launch(events, ev_ld, PackedRows<4>{w, w_ld, scale}, out,
                    n_rows, n_events, n_dest, stream);
    case 8:
      return launch(events, ev_ld, PackedRows<8>{w, w_ld, scale}, out,
                    n_rows, n_events, n_dest, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
