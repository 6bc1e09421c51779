// Event-driven synaptic accumulation on Hopper (sm_90a), CUDA C++.
//
// Replaces the Pallas TPU kernels in src/repro/kernels/event_synapse.py:
//   event_synapse_f32        <- event_synapse        (_event_synapse_kernel)
//   event_synapse_packed_i8  <- event_synapse_packed (_event_synapse_packed_kernel)
//
//   out[r, d] = sum over the events e of row r, in ascending e, of W[ev[r, e], d]
//
// with W the f32 tile, or for packed codes W[s, d] = fl32(q[s, d] * scale).
//
// Contract of the event lists.  Each row holds its valid sources first, in
// strictly ascending order, then -1 padding (the layout events_from_spikes
// writes; the launchers in event_synapse.py compact any other list into it
// and reject rows that do not ascend).  A row's sum stops at its first -1:
// padding only ever adds +0.0, so the early stop is exact.  The kernel
// relies on the ascending order too: it walks the sources in ascending
// chunks, and adds a row's events in list order only because that order is
// ascending.
//
// One streaming kernel serves both routes, templated on the stage element:
// f32 weights (kBits = 32) or sign-magnitude codes of kBits in {2, 4, 8}
// (quant.pack_signmag: column j of a row at bit offset j * kBits of the
// row's bytes).  A block owns kCols destination columns of up to kRows
// event rows; one thread owns one row and kVec = 4 adjacent columns (one
// float4).  The block streams the weight
// rows W[s0 : s0 + kSrc, d0 : d0 + kCols] of ascending source chunks (their
// bytes, kCols * kBits / 8 a row) through a ring of kStages shared-memory
// stages, as 2-D TMA boxes of up to 256 rows (cp.async, or byte loads,
// where the tile's rows are not 16-byte aligned), kStages - 1 chunks in
// flight while one is read.  For each staged chunk every thread adds, in
// list order, f32 row ev - s0 of the chunk (the ring slot itself, or for
// codes the chunk's dequantised buffer, below) for each of its row's
// events below s0 + kSrc.
// So each weight row crosses from memory to the SM once per row group, not
// once per event, and the grid puts the row groups of one column slice on
// consecutive blocks, which read the same chunks at about the same time
// through L2.
//
// The rows' event lists are copied into per-row rings of kEv slots with
// cp.async, refilled after every chunk to kEv - 3 positions past the row's
// cursor, so that a thread reads its events from shared memory; a row that
// outruns its landed slots reads the rest from memory.  A thread takes 8
// events a step: the step's weight loads go out together and the next
// step's events load while the adds run.
//
// The block starts at its rows' least first event and stops at their
// greatest event (found by a search of each row's valid prefix, which also
// keeps the copies inside the tile without knowing n_src).  The chunk
// staged next starts at max(end of the last chunk, least next event of the
// block's rows one chunk ago): chunks in which no row has an event are
// skipped.  One block barrier a chunk: it both releases the stage the next
// copy overwrites and publishes the rows' next events.  Ring rows are
// packed back to back, not padded: the rows a warp reads are random
// sources, and at a stride of a power of two two rows either fall on the
// same banks or on disjoint ones, while a padded stride makes partial
// overlaps that conflict more often.  Shared memory is addressed through
// 32-bit shared-window offsets, so the hot loops do no generic-to-shared
// address conversion.
//
// Packed codes cross memory and land in the ring as codes; once a chunk
// has landed, the block dequantises it once, a chunk ahead of the walk,
// into one of two f32 buffers, which the rows then walk as the f32 route
// walks its ring.  (Dequantising in registers at every event cost about
// three times the walk's instructions per event and made the kernel
// issue-bound, slower than a per-event gather; PERF.md.)  A code's
// magnitude m and sign bit go into the float +-(2^23 + m), from which
// +-2^23 is subtracted, exactly, giving q = +-m (and +0 for the code "-0",
// as the plain version's q = 0), then __fmul_rn(q, scale): the plain
// version's fl32(q * scale) bit for bit, with no integer-to-float
// conversion, which runs well below the float add rate on sm_90.
//
// One float32 sum per (r, d) in one thread, events added in order with
// __fadd_rn: no split-K, no atomics, no tensor cores and no fused
// multiply-add, so the result equals the sequential float32 sum of the
// numpy oracle bit for bit.
//
// Bound.  Memory: each distinct weight row an event reads, once, plus the
// events and the output.  At the CIFAR10-DVS input layer the fused tile is
// 32768 x 1024 f32 (134 MB), larger than the 50 MB L2; the kernel reads it
// about once per launch, where a per-event gather read 1.03 GB.  Packed
// codes cut the bytes per row to n_dest * bits / 8.  In the SM the kernel
// is bound by the busiest row of each block: its events are one sequential
// chain of loads and adds, and the chunk barrier makes the block wait for
// that row.

#include <cuda.h>  // CUtensorMap and its enums; cuTensorMapEncodeTiled is
                   // looked up at run time, so nothing links libcuda
#include <cuda_runtime.h>
#include <limits.h>
#include <stdint.h>

namespace {

constexpr int kVec = 4;     // columns per thread: one float4, or 4 codes
constexpr int kProbes = 8;  // probes per lane per step of the prefix search
constexpr int kBoxRows = 256;  // most rows of one TMA box

// The kernel's shape per stage element (kBits = 32: f32 weights), chosen
// on the H100 at the CIFAR10-DVS input layer (PERF.md): columns per block,
// event rows per block, sources per chunk, ring stages, event slots per
// row.  A ring row is kCols * kBits / 8 bytes, a multiple of 16 (TMA's
// least box width), so 2-bit codes take 64 columns; codes add two f32
// chunk buffers to the shared memory.
template <int kBits>
struct Shape;
template <>
struct Shape<32> {
  static constexpr int kCols = 32, kRows = 32, kSrc = 256, kStages = 4,
                       kEv = 512;
};
template <>
struct Shape<8> {
  static constexpr int kCols = 32, kRows = 32, kSrc = 256, kStages = 4,
                       kEv = 512;
};
template <>
struct Shape<4> {
  static constexpr int kCols = 32, kRows = 32, kSrc = 256, kStages = 4,
                       kEv = 512;
};
template <>
struct Shape<2> {
  static constexpr int kCols = 64, kRows = 16, kSrc = 256, kStages = 4,
                       kEv = 512;
};

__device__ __forceinline__ unsigned smem_u32(const void* p) {
  return (unsigned)__cvta_generic_to_shared(p);
}

__device__ __forceinline__ int lds_s32(unsigned addr) {
  int v;
  asm volatile("ld.shared.s32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  return v;
}

// The 8 words at a[j], issued together.
__device__ __forceinline__ void lds8_s32(int (&e)[8], const unsigned (&a)[8]) {
  asm volatile(
      "ld.shared.s32 %0, [%8];\n"
      "ld.shared.s32 %1, [%9];\n"
      "ld.shared.s32 %2, [%10];\n"
      "ld.shared.s32 %3, [%11];\n"
      "ld.shared.s32 %4, [%12];\n"
      "ld.shared.s32 %5, [%13];\n"
      "ld.shared.s32 %6, [%14];\n"
      "ld.shared.s32 %7, [%15];\n"
      : "=r"(e[0]), "=r"(e[1]), "=r"(e[2]), "=r"(e[3]), "=r"(e[4]),
        "=r"(e[5]), "=r"(e[6]), "=r"(e[7])
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]));
}

// v[j] = the float4 at a[j] where take[j] (v[j] is left as it was
// elsewhere), the 8 loads in one asm block.
__device__ __forceinline__ void lds8_f32x4_if(float4 (&v)[8],
                                              const unsigned (&a)[8],
                                              const int (&take)[8]) {
  asm volatile(
      "{\n"
      " .reg .pred p<8>;\n"
      " setp.ne.b32 p0, %40, 0;\n"
      " setp.ne.b32 p1, %41, 0;\n"
      " setp.ne.b32 p2, %42, 0;\n"
      " setp.ne.b32 p3, %43, 0;\n"
      " setp.ne.b32 p4, %44, 0;\n"
      " setp.ne.b32 p5, %45, 0;\n"
      " setp.ne.b32 p6, %46, 0;\n"
      " setp.ne.b32 p7, %47, 0;\n"
      " @p0 ld.shared.v4.f32 {%0, %1, %2, %3}, [%32];\n"
      " @p1 ld.shared.v4.f32 {%4, %5, %6, %7}, [%33];\n"
      " @p2 ld.shared.v4.f32 {%8, %9, %10, %11}, [%34];\n"
      " @p3 ld.shared.v4.f32 {%12, %13, %14, %15}, [%35];\n"
      " @p4 ld.shared.v4.f32 {%16, %17, %18, %19}, [%36];\n"
      " @p5 ld.shared.v4.f32 {%20, %21, %22, %23}, [%37];\n"
      " @p6 ld.shared.v4.f32 {%24, %25, %26, %27}, [%38];\n"
      " @p7 ld.shared.v4.f32 {%28, %29, %30, %31}, [%39];\n"
      "}\n"
      : "+f"(v[0].x), "+f"(v[0].y), "+f"(v[0].z), "+f"(v[0].w),
        "+f"(v[1].x), "+f"(v[1].y), "+f"(v[1].z), "+f"(v[1].w),
        "+f"(v[2].x), "+f"(v[2].y), "+f"(v[2].z), "+f"(v[2].w),
        "+f"(v[3].x), "+f"(v[3].y), "+f"(v[3].z), "+f"(v[3].w),
        "+f"(v[4].x), "+f"(v[4].y), "+f"(v[4].z), "+f"(v[4].w),
        "+f"(v[5].x), "+f"(v[5].y), "+f"(v[5].z), "+f"(v[5].w),
        "+f"(v[6].x), "+f"(v[6].y), "+f"(v[6].z), "+f"(v[6].w),
        "+f"(v[7].x), "+f"(v[7].y), "+f"(v[7].z), "+f"(v[7].w)
      : "r"(a[0]), "r"(a[1]), "r"(a[2]), "r"(a[3]), "r"(a[4]), "r"(a[5]),
        "r"(a[6]), "r"(a[7]), "r"(take[0]), "r"(take[1]), "r"(take[2]),
        "r"(take[3]), "r"(take[4]), "r"(take[5]), "r"(take[6]),
        "r"(take[7]));
}

// The kBytes-wide word at addr, zero-extended.
template <int kBytes>
__device__ __forceinline__ unsigned lds_word(unsigned addr) {
  static_assert(kBytes == 1 || kBytes == 2 || kBytes == 4, "word size");
  unsigned v;
  if constexpr (kBytes == 4) {
    asm volatile("ld.shared.b32 %0, [%1];\n" : "=r"(v) : "r"(addr));
  } else if constexpr (kBytes == 2) {
    asm volatile("ld.shared.u16 %0, [%1];\n" : "=r"(v) : "r"(addr));
  } else {
    asm volatile("ld.shared.u8 %0, [%1];\n" : "=r"(v) : "r"(addr));
  }
  return v;
}

__device__ __forceinline__ void sts_f32x4(unsigned addr, float4 v) {
  asm volatile("st.shared.v4.f32 [%0], {%1, %2, %3, %4};\n" ::"r"(addr),
               "f"(v.x), "f"(v.y), "f"(v.z), "f"(v.w));
}

// The 4 sign-magnitude codes of kBits in w (code j at bit j * kBits) as
// fl32(q * scale), q = m - 2 * sign * m: +-(2^23 + m) - +-2^23 is exactly
// +-m (+0 for m = 0 whatever the sign), then one rounded multiply.
template <int kBits>
__device__ __forceinline__ float4 dequant4(unsigned w, float scale) {
  constexpr unsigned kMag = (1u << (kBits - 1)) - 1u;
  constexpr unsigned kTwo23 = 0x4B000000u;  // the float 2^23
  float q[kVec];
#pragma unroll
  for (int j = 0; j < kVec; ++j) {
    const unsigned c = w >> (j * kBits);
    const unsigned sign = (c << (32 - kBits)) & 0x80000000u;
    q[j] = __fsub_rn(__uint_as_float(kTwo23 | sign | (c & kMag)),
                     __uint_as_float(kTwo23 | sign));
  }
  return make_float4(__fmul_rn(q[0], scale), __fmul_rn(q[1], scale),
                     __fmul_rn(q[2], scale), __fmul_rn(q[3], scale));
}

__device__ __forceinline__ void st_shared_u8(unsigned addr, unsigned v) {
  asm volatile("st.shared.u8 [%0], %1;\n" ::"r"(addr), "r"(v));
}

__device__ __forceinline__ void cp_async16(unsigned dst, const void* src,
                                           int src_bytes) {
  asm volatile("cp.async.cg.shared.global [%0], [%1], 16, %2;\n" ::"r"(dst),
               "l"(src), "r"(src_bytes));
}

__device__ __forceinline__ void cp_async4(unsigned dst, const void* src) {
  asm volatile("cp.async.ca.shared.global [%0], [%1], 4;\n" ::"r"(dst),
               "l"(src));
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

// The tensor-map box at (column c, row s) into shared memory, by the TMA
// unit; completes on bar.
__device__ __forceinline__ void tma_load_2d(unsigned dst, const CUtensorMap* map,
                                            int c, int s, unsigned bar) {
  asm volatile(
      "cp.async.bulk.tensor.2d.shared::cluster.global.tile.mbarrier::"
      "complete_tx::bytes [%0], [%1, {%2, %3}], [%4];\n" ::"r"(dst),
      "l"(reinterpret_cast<uint64_t>(map)), "r"(c), "r"(s), "r"(bar)
      : "memory");
}

__device__ __forceinline__ void cp_async_commit() {
  asm volatile("cp.async.commit_group;\n" ::: "memory");
}

template <int N>
__device__ __forceinline__ void cp_async_wait() {
  asm volatile("cp.async.wait_group %0;\n" ::"n"(N) : "memory");
}

// Length of a row's valid prefix (the position of its first -1, or n), by
// a search in which the kLanes adjacent lanes of the row probe
// kLanes * kProbes positions a step.  Every lane of the warp takes part.
template <int kLanes>
__device__ int valid_prefix(const int32_t* __restrict__ row, int n,
                            int lane) {
  constexpr int kSpan = kLanes * kProbes;
  int lo = 0, hi = n;  // the prefix length lies in [lo, hi]
  while (__any_sync(0xffffffffu, lo < hi)) {
    int step = 1, cnt = 0;
    if (lo < hi) {
      step = (hi - lo + kSpan - 1) / kSpan;
#pragma unroll
      for (int k = 0; k < kProbes; ++k) {
        const int pos = lo + (lane * kProbes + k + 1) * step - 1;
        cnt += pos < hi && __ldg(row + pos) >= 0;
      }
    }
    // the valid probes are a prefix of the row's probes: count them
#pragma unroll
    for (int o = kLanes / 2; o > 0; o >>= 1)
      cnt += __shfl_xor_sync(0xffffffffu, cnt, o);
    if (lo < hi) {
      lo += cnt * step;
      hi = min(hi, lo + step - 1);
    }
  }
  return lo;
}

// kBits: 32 for f32 weights, else the width of a packed code.  kEv: event
// slots per row in shared memory.
template <int kBits, int kCols, int kRows, int kSrc, int kStages, int kEv>
__global__ void __launch_bounds__(kRows * kCols / kVec, 1)
stream_kernel(const __grid_constant__ CUtensorMap w_map, bool w_tma,
              const int32_t* __restrict__ events, long long ev_ld,
              const uint8_t* __restrict__ w, long long w_ld, bool w_vec,
              float scale, const float* __restrict__ scale_ptr,
              float* __restrict__ out, int n_rows, int n_events,
              int n_dest) {
  constexpr int kLanes = kCols / kVec;
  constexpr int kThreads = kRows * kLanes;
  constexpr int kWarps = kThreads / 32;
  constexpr int kGran = 8;  // events a thread takes per step
  constexpr bool kCodes = kBits < 32;          // packed codes, not f32
  constexpr int kRowBytes = kCols * kBits / 8;  // one ring row
  constexpr int kWord = kVec * kBits / 8;       // one thread's share of it
  constexpr unsigned kStageBytes = kSrc * kRowBytes;
  // codes: each chunk dequantised once into one of two f32 buffers
  constexpr unsigned kBufBytes = kCodes ? kSrc * kCols * 4 : 0;
  // commit groups that may still be in flight at the top of iteration i:
  // f32 walks chunk i from the ring; codes convert chunk i + 1 there
  constexpr int kLag = kCodes ? kStages - 3 : kStages - 2;
  constexpr int kBox = kSrc < kBoxRows ? kSrc : kBoxRows;  // rows a box
  static_assert(kBits == 32 || kBits == 8 || kBits == 4 || kBits == 2,
                "stage element");
  static_assert(kCols % kVec == 0 && 32 % kLanes == 0 && kThreads % 32 == 0,
                "a row's lanes must sit in one warp");
  static_assert(kRowBytes % 16 == 0 && kRowBytes <= 256,
                "a ring row must be a TMA box width");
  static_assert(kSrc % kBox == 0, "a chunk must be whole TMA boxes");
  static_assert((kEv & (kEv - 1)) == 0, "kEv must be a power of two");
  static_assert(kEv >= 64, "too few event slots");
  static_assert(kLag >= 0, "too few ring stages");
  extern __shared__ __align__(128) float smem[];
  __shared__ __align__(8) uint64_t w_landed[kStages];  // TMA chunk j: phase j / kStages
  __shared__ int chunk_start[kStages];
  __shared__ int warp_min[2][kWarps];  // by iteration parity
  __shared__ int src_lo, src_hi;

  if (kCodes && scale_ptr) scale = __ldg(scale_ptr);  // a device scale
  const int tid = threadIdx.x;
  const int lane = tid % kLanes;
  const long long r = (long long)blockIdx.x * kRows + tid / kLanes;
  const int d0 = blockIdx.y * kCols;
  const int d = d0 + lane * kVec;
  const int b0 = d0 * kBits / 8;              // the block's first byte of a row
  const int row_bytes = n_dest * kBits / 8;   // the bytes of a tile row
  const bool active = r < n_rows;
  const int32_t* row = events + (active ? r : 0) * ev_ld;
  // [kStages][kSrc][kRowBytes] weight chunks, then (codes) [2][kSrc][kCols]
  // f32 chunks, then [kRows][kEv] event slots: position p of a row lives in
  // slot (p + skew) % kEv, so that the row's 16-byte granules in memory
  // land on 16-byte slots.
  const unsigned ring = smem_u32(smem);
  const unsigned bufs = ring + kStages * kStageBytes;
  const unsigned ev_slots = bufs + 2 * kBufBytes + (tid / kLanes) * (kEv * 4);
  const int skew = (int)((reinterpret_cast<uintptr_t>(row) >> 2) & 3);

  // The block's source range: its rows' least first and greatest event.
  const int n_valid = valid_prefix<kLanes>(row, active ? n_events : 0, lane);
  if (tid == 0) {
    src_lo = INT_MAX;
    src_hi = -1;
    for (int k = 0; k < kStages; ++k) mbar_init(smem_u32(&w_landed[k]), 1);
    asm volatile("fence.mbarrier_init.release.cluster;\n" ::: "memory");
  }
  __syncthreads();
  if (lane == 0 && n_valid > 0) {
    atomicMin(&src_lo, __ldg(row));
    atomicMax(&src_hi, __ldg(row + n_valid - 1));
  }
  __syncthreads();
  const int hi = src_hi;

  // Copy the row's events up to position min(n_valid, cur + kEv - 3) into
  // its slots, whole granules, the row's lanes taking turns.  Granules may
  // reach 3 positions either side: below, they rewrite slots with the
  // values they hold; above, they land in slots of consumed positions.
  int issued = 0;
  auto refill = [&](int cur) {
    const int end = min(n_valid, cur + kEv - 3);
    issued = max(issued, cur);
    if (end <= issued) return;
    const int g_lo = (issued + skew) >> 2, g_hi = (end + skew + 3) >> 2;
    for (int g = g_lo + lane; g < g_hi; g += kLanes)
      cp_async16(ev_slots + ((4 * g) & (kEv - 1)) * 4, row + 4 * g - skew, 16);
    issued = end;
  };

  // Stage the bytes of W[start : min(start + kSrc, hi + 1), d0 : d0 + kCols]
  // into slot: whole TMA boxes while a box lies below hi (so inside the
  // tile), the rest by the threads, cp.async in 16-byte granules where the
  // rows are 16-byte aligned, else in 4-byte words (f32) or bytes.  Bytes
  // past the tile's row are zeros, or never read for a stored column.
  auto stage = [&](int slot, int start) {
    const unsigned dst = ring + slot * kStageBytes;
    const int n = min(kSrc, hi - start + 1);
    const int boxed = w_tma ? n / kBox * kBox : 0;
    if (w_tma && tid == 0) {
      const unsigned bar = smem_u32(&w_landed[slot]);
      mbar_arrive_tx(bar, boxed * kRowBytes);
      for (int s = 0; s < boxed; s += kBox)
        tma_load_2d(dst + s * kRowBytes, &w_map, b0, start + s, bar);
    }
    const uint8_t* src = w + (long long)start * w_ld;
    if (w_vec) {
      constexpr int kG = kRowBytes / 16;
      for (int i = boxed * kG + tid; i < n * kG; i += kThreads) {
        const int s = i / kG, c = (i % kG) * 16;
        const int bytes = min(max(row_bytes - (b0 + c), 0), 16);
        cp_async16(dst + s * kRowBytes + c,
                   src + s * w_ld + (bytes ? b0 + c : 0), bytes);
      }
    } else if constexpr (kBits == 32) {
      for (int i = tid; i < n * kCols; i += kThreads) {
        const int s = i / kCols, c = i % kCols;
        if (d0 + c < n_dest)
          cp_async4(dst + s * kRowBytes + c * 4, src + s * w_ld + b0 + c * 4);
      }
    } else {
      for (int i = tid; i < n * kRowBytes; i += kThreads) {
        const int s = i / kRowBytes, c = i % kRowBytes;
        st_shared_u8(dst + i,
                     b0 + c < row_bytes ? __ldg(src + s * w_ld + b0 + c) : 0u);
      }
    }
    if (tid == 0) chunk_start[slot] = start;
  };

  // Chunk j goes to slot j % kStages in commit group j (groups may be
  // empty); the rows' first events ride in group 0.
  refill(0);
  int staged = 0, next = src_lo;
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) {
    if (next <= hi) {
      stage(k, next);
      ++staged;
      next += kSrc;
    }
    cp_async_commit();
  }
  // landed[k]: how far the row's slots were filled k + 1 iterations ago;
  // copies issued kStages - 1 iterations ago have landed.
  int landed[kStages - 1];
#pragma unroll
  for (int k = 0; k < kStages - 1; ++k) landed[k] = issued;

  // Codes: chunk j's codes, once landed, dequantised into f32 buffer j % 2,
  // every thread 4 columns of a row at a time.  Rows past the staged ones
  // convert whatever the slot holds; no event reads them.
  auto convert = [&](int j) {
    if constexpr (kCodes) {
      const int slot = j % kStages;
      if (w_tma) mbar_wait(smem_u32(&w_landed[slot]), (j / kStages) & 1);
      const unsigned src = ring + slot * kStageBytes;
      const unsigned dst = bufs + (j & 1) * kBufBytes;
      static_assert(kSrc * kLanes % kThreads == 0, "whole conversion rounds");
#pragma unroll
      for (int k = 0; k < kSrc * kLanes / kThreads; ++k) {
        const int g = tid + k * kThreads;
        const int s = g / kLanes, l = g % kLanes;
        const unsigned w4 = lds_word<kWord>(src + s * kRowBytes + l * kWord);
        sts_f32x4(dst + (s * kCols + l * kVec) * 4,
                  dequant4<kBits>(w4, scale));
      }
    }
  };
  if constexpr (kCodes) {
    if (staged > 0) {
      cp_async_wait<kStages - 2>();
      __syncthreads();  // chunk 0's copies landed
      convert(0);
    }
  }

  // The row's events at positions p0 .. p0 + kGran - 1: from its slots
  // below `ready`, from memory above it, INT_MAX past the row's end.
  auto load_events = [&](int (&ev)[kGran], int p0, int ready) {
    unsigned at[kGran];
#pragma unroll
    for (int j = 0; j < kGran; ++j)
      at[j] = ev_slots + ((p0 + j + skew) & (kEv - 1)) * 4;
    if (p0 + kGran <= ready) {
      lds8_s32(ev, at);
    } else {
#pragma unroll
      for (int j = 0; j < kGran; ++j) {
        const int p = p0 + j;
        ev[j] = p < ready ? lds_s32(at[j])
                          : (p < n_valid ? __ldg(row + p) : INT_MAX);
      }
    }
  };

  float4 acc = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
  int cur = 0;  // this row's next unconsumed event
  for (int i = 0; i < staged; ++i) {
    cp_async_wait<kLag>();
    // f32: chunk i landed; codes: chunk i converted, chunk i + 1 landed.
    // Every thread is done with chunk i - 1.
    __syncthreads();

    // Stage chunk i + kStages - 1 into the slot chunk i - 1 used.  The
    // least next event of the block's rows after chunk i - 1 bounds every
    // event still to come, so the chunk starts no lower.
    int least = src_lo;
    if (i > 0) {
      least = warp_min[(i - 1) & 1][0];
#pragma unroll
      for (int k = 1; k < kWarps; ++k)
        least = min(least, warp_min[(i - 1) & 1][k]);
    }
    const int start = max(next, least);
    if (least != INT_MAX && start <= hi) {
      stage(staged % kStages, start);
      ++staged;
      next = start + kSrc;
    }

    const int slot = i % kStages;
    unsigned tile;  // the f32 rows of chunk i, at this thread's columns
    if constexpr (kCodes) {
      // chunk i + 1 into the buffer chunk i - 1 used, while this one walks
      if (i + 1 < staged) convert(i + 1);
      tile = bufs + (i & 1) * kBufBytes + lane * (kVec * 4);
    } else {
      if (w_tma) mbar_wait(smem_u32(&w_landed[slot]), (i / kStages) & 1);
      tile = ring + slot * kStageBytes + lane * (kVec * 4);
    }
    const int s0 = chunk_start[slot];
    const int s_end = s0 + kSrc;
    const int ready = landed[kStages - 2];  // slots below it hold the events

    // Every event of the row below s_end, in list order: the events below
    // s0 went in earlier chunks.  The list ascends, so the events of a step
    // below s_end are a prefix of it; their weight loads go out together,
    // then the adds run in order.
    int nxt = INT_MAX;
    if (cur < n_valid) {
      int ev[kGran];
      load_events(ev, cur, ready);
      while (true) {
        // the next step's events, fetched while this step's weights load
        int ev_next[kGran];
        const bool ahead = cur + 2 * kGran <= ready;
        if (ahead) load_events(ev_next, cur + kGran, ready);
        int take[kGran];
        unsigned at[kGran];
        float4 v[kGran];
#pragma unroll
        for (int j = 0; j < kGran; ++j) {
          v[j] = make_float4(0.0f, 0.0f, 0.0f, 0.0f);
          take[j] = ev[j] < s_end;
          at[j] = tile + (unsigned)(ev[j] - s0) * (kCols * 4);
        }
        lds8_f32x4_if(v, at, take);
        int took = 0, stop = INT_MAX;
#pragma unroll
        for (int j = 0; j < kGran; ++j) {
          if (take[j]) {
            acc.x = __fadd_rn(acc.x, v[j].x);
            acc.y = __fadd_rn(acc.y, v[j].y);
            acc.z = __fadd_rn(acc.z, v[j].z);
            acc.w = __fadd_rn(acc.w, v[j].w);
            ++took;
          } else {
            stop = min(stop, ev[j]);
          }
        }
        cur += took;
        if (took < kGran) {
          nxt = stop;  // the row's first event at or past s_end
          break;
        }
        if (cur >= n_valid) break;
        if (ahead) {
#pragma unroll
          for (int j = 0; j < kGran; ++j) ev[j] = ev_next[j];
        } else {
          load_events(ev, cur, ready);
        }
      }
    }

    // The block's least next event, read after the next barrier; and the
    // row's slots refilled past its new cursor, once every lane of the
    // warp has read the events it overwrites.
    const int m = __reduce_min_sync(0xffffffffu, nxt);
    if (tid % 32 == 0) warp_min[i & 1][tid / 32] = m;
    __syncwarp();
    refill(cur);
    cp_async_commit();
#pragma unroll
    for (int k = kStages - 2; k > 0; --k) landed[k] = landed[k - 1];
    landed[0] = issued;
  }
  asm volatile("cp.async.wait_all;\n" ::: "memory");

  if (active) {
    float* o = out + r * n_dest;
    if (d < n_dest) o[d] = acc.x;
    if (d + 1 < n_dest) o[d + 1] = acc.y;
    if (d + 2 < n_dest) o[d + 2] = acc.z;
    if (d + 3 < n_dest) o[d + 3] = acc.w;
  }
}

// A 2-D tensor map of the tile's bytes for TMA boxes of kBox rows x
// kRowBytes, or false where the tile's rows are not 16-byte aligned or
// libcuda has no cuTensorMapEncodeTiled.  The kernel is not told n_src, so
// the map claims INT_MAX rows; the kernel loads a box only where all its
// rows lie at or below a row some event reads.
template <int kRowBytes, int kBox>
bool weight_map(CUtensorMap* map, const void* w, long long w_ld,
                long long row_bytes) {
  using Encode = CUresult (*)(CUtensorMap*, CUtensorMapDataType, cuuint32_t,
                              void*, const cuuint64_t*, const cuuint64_t*,
                              const cuuint32_t*, const cuuint32_t*,
                              CUtensorMapInterleave, CUtensorMapSwizzle,
                              CUtensorMapL2promotion, CUtensorMapFloatOOBfill);
  static Encode encode = nullptr;
  if (!encode) {
    void* fn = nullptr;
    if (cudaGetDriverEntryPoint("cuTensorMapEncodeTiled", &fn,
                                cudaEnableDefault) != cudaSuccess || !fn)
      return false;
    encode = (Encode)fn;
  }
  if (w_ld % 16 != 0 || reinterpret_cast<uintptr_t>(w) % 16 != 0) return false;
  const cuuint64_t dims[2] = {(cuuint64_t)row_bytes, (cuuint64_t)INT_MAX};
  const cuuint64_t strides[1] = {(cuuint64_t)w_ld};
  const cuuint32_t box[2] = {kRowBytes, kBox};
  const cuuint32_t unit[2] = {1, 1};
  return encode(map, CU_TENSOR_MAP_DATA_TYPE_UINT8, 2, const_cast<void*>(w),
                dims, strides, box, unit, CU_TENSOR_MAP_INTERLEAVE_NONE,
                CU_TENSOR_MAP_SWIZZLE_NONE, CU_TENSOR_MAP_L2_PROMOTION_L2_128B,
                CU_TENSOR_MAP_FLOAT_OOB_FILL_NONE) == CUDA_SUCCESS;
}

// w: the tile's bytes, row stride w_ld bytes; the scale is read for codes
// only, from scale_ptr (device memory) where that is not null.
template <int kBits, int kCols, int kRows, int kSrc, int kStages, int kEv>
int launch_stream(const void* events, long long ev_ld, const void* w,
                  long long w_ld, float scale, const float* scale_ptr,
                  void* out, int n_rows, int n_events, int n_dest,
                  void* stream) {
  constexpr int kThreads = kRows * kCols / kVec;
  constexpr int kRowBytes = kCols * kBits / 8;
  constexpr int kSmem = kStages * kSrc * kRowBytes +
                        (kBits < 32 ? 2 * kSrc * kCols * 4 : 0) +
                        kRows * kEv * 4;
  auto kernel = stream_kernel<kBits, kCols, kRows, kSrc, kStages, kEv>;
  const cudaError_t err = cudaFuncSetAttribute(
      kernel, cudaFuncAttributeMaxDynamicSharedMemorySize, kSmem);
  if (err != cudaSuccess) return (int)err;
  const bool w_vec =
      w_ld % 16 == 0 && reinterpret_cast<uintptr_t>(w) % 16 == 0;
  CUtensorMap map = {};
  const bool w_tma = weight_map<kRowBytes, (kSrc < kBoxRows ? kSrc : kBoxRows)>(
      &map, w, w_ld, (long long)n_dest * kBits / 8);
  // row groups on x, so the blocks of one column slice run side by side
  const dim3 grid((n_rows + kRows - 1) / kRows, (n_dest + kCols - 1) / kCols);
  kernel<<<grid, kThreads, kSmem, (cudaStream_t)stream>>>(
      map, w_tma, (const int32_t*)events, ev_ld, (const uint8_t*)w, w_ld,
      w_vec, scale, scale_ptr, (float*)out, n_rows, n_events, n_dest);
  return (int)cudaGetLastError();
}

// The kernel at the shape chosen for kBits.
template <int kBits>
int launch(const void* events, long long ev_ld, const void* w,
           long long w_ld, float scale, const float* scale_ptr, void* out,
           int n_rows, int n_events, int n_dest, void* stream) {
  using S = Shape<kBits>;
  return launch_stream<kBits, S::kCols, S::kRows, S::kSrc, S::kStages,
                       S::kEv>(events, ev_ld, w, w_ld, scale, scale_ptr, out,
                               n_rows, n_events, n_dest, stream);
}

}  // namespace

extern "C" {

// events i32 [n_rows, n_events] (row stride ev_ld), each row's valid
// sources ascending; w f32 [n_src, n_dest] (row stride w_ld); out f32
// [n_rows, n_dest] contiguous.
int event_synapse_f32(const void* events, long long ev_ld, const void* w,
                      long long w_ld, void* out, int n_rows, int n_events,
                      int n_dest, void* stream) {
  return launch<32>(events, ev_ld, w, w_ld * 4, 0.0f, nullptr, out, n_rows,
                    n_events, n_dest, stream);
}

// packed i8 [n_src, n_dest * bits / 8] (row stride w_ld bytes), bits in
// {2, 4, 8}; each code is dequantised as fl32(q * scale) before its add,
// the scale read from scale_ptr (one f32 in device memory) where that is
// not null, else taken by value: neither reads the device from the host.
int event_synapse_packed_i8(const void* events, long long ev_ld,
                            const void* packed, long long w_ld, float scale,
                            const void* scale_ptr, int bits, void* out,
                            int n_rows, int n_events, int n_dest,
                            void* stream) {
  const float* sp = (const float*)scale_ptr;
  switch (bits) {
    case 2:
      return launch<2>(events, ev_ld, packed, w_ld, scale, sp, out, n_rows,
                       n_events, n_dest, stream);
    case 4:
      return launch<4>(events, ev_ld, packed, w_ld, scale, sp, out, n_rows,
                       n_events, n_dest, stream);
    case 8:
      return launch<8>(events, ev_ld, packed, w_ld, scale, sp, out, n_rows,
                       n_events, n_dest, stream);
    default:
      return (int)cudaErrorInvalidValue;
  }
}

const char* error_string(int err) {
  return cudaGetErrorString((cudaError_t)err);
}

}  // extern "C"
