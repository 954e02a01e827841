// Fused primitive slice application for NVIDIA Hopper (sm_90a): two entries.
//
// Both replace the TPU kernel ``fused_primitive_pallas`` of
// src/repro/kernels/fused_slice.py (body ``_kernel``), which applies, for
// each row of the superstep burst, with flags = (recv, reduce, reads_in, op):
//
//   value = op(payload, local)  computed in f32, rounded back   if reduce
//         = payload                                            elif recv
//         = local                                              elif reads_in
//         = 0                                                  otherwise
//
// op: 0 sum, 1 max, 2 min, 3 prod (clipped to 0..3).  max/min propagate NaN
// like jnp.maximum / jnp.minimum (fmaxf/fminf alone would return the
// non-NaN operand).  There is one arithmetic op per element, built from the
// round-to-nearest intrinsics, and the library is compiled with
// -fmad=false, so nothing is contracted into an FMA.  The non-reducing
// branches copy the element's bits unchanged.  Both entries share ``apply``.
//
// 1. occl_fused_primitive: the one-to-one counterpart of the Pallas
//    contract, over given [N, S] payload / local rows and [N, 4] flags.
//    One block of 128 threads per row, 16-byte loads and stores, the row's
//    flags read once through shared memory.  No runtime path calls it.
//
// 2. occl_fused_burst: the whole slice burst of one superstep, the
//    scheduler's main path (src/repro/core/scheduler.py:564-620 and the
//    outbox cast at :789).  For every rank r, lane l and burst row b, with
//    c = coll[r, l] and W = B * SL:
//
//      recv  = payload[r, c, (tail[r, l] + b) % K, :]
//      local = heap_in[r, s_in + b * SL : ... + SL]
//      value = apply(flags of prim[r, l] and op[c], recv, local)
//      outbox[r, l, b, :] = value                          (every row)
//      heap_out[r, s_out + b * SL + j] = value[j]          (b < n[r, l],
//                                                           if write[r, l])
//
//    where s_in / s_out are in_off[r, c] / out_off[r, c] plus the chunk
//    and (round, slice) offsets, computed in wrapping int32 as the
//    reference does, and placed like lax.dynamic_slice places a start: a
//    negative one counts from the row's end, then it is clamped to
//    [0, H - W].
//    Where two lanes of one rank write one element, the later lane wins,
//    as in the reference's sequential window loop: each block drops the
//    elements that a later lane's window also writes.
//
//    What bounds it: memory traffic — the slot rows and heap_in windows
//    that the flags read, the heap_out rows written and the outbox, at
//    most 4 * R * L * B * SL elements (1 MiB for 8 x 1 x 8 x 1024 f32, 0.31
//    us at 3.35 TB/s).  At that size the latency of the launch and of
//    three dependent rounds of loads (lane descriptor, per-collective
//    tables, data) dominates.  Design, for that: a grid of (R * L * B rows)
//    x (1 KiB column tiles) of 64 threads, so the 64-row flat burst fills
//    the 132 SMs with 256 blocks; every thread reads its lane's descriptor
//    with warp-uniform loads (no shared memory, no barrier), computes the
//    windows itself, and issues its 16-byte loads of the slot row and the
//    heap_in window before the first combine.  Loads the flags do not need
//    are not issued.  Window starts are arbitrary element offsets, so the
//    vector path is taken per row, after a scalar head, only where every
//    pointer the row touches has the same offset modulo 16 bytes; other
//    rows run element by element.  Addresses are 64-bit.  No TMA and no
//    wgmma: there is no product, and each row is one contiguous 0.1-4 KiB
//    run that plain vector loads already cover.
//
// Plain C interface (loaded with ctypes); each entry returns
// cudaGetLastError() after its launch, so a refused launch is reported.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;
constexpr int kBurstThreads = 64;

__device__ __forceinline__ float to_f32(float x) { return x; }
__device__ __forceinline__ float to_f32(__nv_bfloat16 x) { return __bfloat162float(x); }
__device__ __forceinline__ float to_f32(__half x) { return __half2float(x); }

template <typename T> __device__ __forceinline__ T from_f32(float x);
template <> __device__ __forceinline__ float from_f32<float>(float x) { return x; }
template <> __device__ __forceinline__ __nv_bfloat16 from_f32<__nv_bfloat16>(float x) {
  return __float2bfloat16_rn(x);
}
template <> __device__ __forceinline__ __half from_f32<__half>(float x) {
  return __float2half_rn(x);
}

__device__ __forceinline__ float combine(int op, float a, float b) {
  const float qnan = __int_as_float(0x7fc00000);
  switch (op) {
    case 0: return __fadd_rn(a, b);
    case 1: return (isnan(a) || isnan(b)) ? qnan : fmaxf(a, b);
    case 2: return (isnan(a) || isnan(b)) ? qnan : fminf(a, b);
    default: return __fmul_rn(a, b);
  }
}

template <typename T>
__device__ __forceinline__ T apply(bool recv, bool reduce, bool reads, int op,
                                   T p, T l) {
  if (reduce) return from_f32<T>(combine(op, to_f32(p), to_f32(l)));
  if (recv) return p;
  if (reads) return l;
  return from_f32<T>(0.0f);
}

template <typename T>
__global__ void __launch_bounds__(kThreads)
fused_primitive_kernel(const T* __restrict__ payload, const T* __restrict__ local,
                       const int* __restrict__ flags, T* __restrict__ out,
                       int s, int vec_ok) {
  __shared__ int f[4];
  const int row = blockIdx.x;
  if (threadIdx.x < 4) f[threadIdx.x] = flags[4 * row + threadIdx.x];
  __syncthreads();
  const bool recv = f[0] > 0;
  const bool reduce = f[1] > 0;
  const bool reads = f[2] > 0;
  const int op = min(max(f[3], 0), 3);
  const size_t base = static_cast<size_t>(row) * static_cast<size_t>(s);

  if (vec_ok) {
    constexpr int kVec = 16 / sizeof(T);
    const int nvec = s / kVec;
    const uint4* p4 = reinterpret_cast<const uint4*>(payload + base);
    const uint4* l4 = reinterpret_cast<const uint4*>(local + base);
    uint4* o4 = reinterpret_cast<uint4*>(out + base);
    for (int i = threadIdx.x; i < nvec; i += blockDim.x) {
      const uint4 pv = p4[i];
      const uint4 lv = l4[i];
      uint4 ov;
      const T* pe = reinterpret_cast<const T*>(&pv);
      const T* le = reinterpret_cast<const T*>(&lv);
      T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
      for (int k = 0; k < kVec; ++k) oe[k] = apply<T>(recv, reduce, reads, op, pe[k], le[k]);
      o4[i] = ov;
    }
  } else {
    for (int i = threadIdx.x; i < s; i += blockDim.x) {
      out[base + i] = apply<T>(recv, reduce, reads, op, payload[base + i], local[base + i]);
    }
  }
}

template <typename T>
void launch(const void* payload, const void* local, const int* flags, void* out,
            int n_rows, int s, int vec_ok, cudaStream_t stream) {
  fused_primitive_kernel<T><<<n_rows, kThreads, 0, stream>>>(
      static_cast<const T*>(payload), static_cast<const T*>(local), flags,
      static_cast<T*>(out), s, vec_ok);
}

// ---------------------------------------------------------------------------
// the burst kernel
// ---------------------------------------------------------------------------

struct BurstArgs {
  const void* payload;         // [R, C, K, SL], ranks ``pstride`` apart
  const void* heap_in;         // [R, H]
  void* heap_out;              // [R, H], written in place
  void* outbox;                // [R, L, B, SL]
  const int* coll;             // [R, L] lane descriptors
  const int* tail;
  const int* rnd;
  const int* sl;
  const int* chunk;
  const int* prim;
  const int* n;
  const unsigned char* write;  // [R, L] bool
  const int* in_off;           // [R, C]
  const int* out_off;          // [R, C]
  const int* n_rounds;         // [C]
  const int* n_slices;
  const int* in_chunked;
  const int* out_chunked;
  const int* op;
  const int* prim_recv;        // [P]
  const int* prim_reduce;
  const int* prim_reads;
  int R, L, B, C, K, SL, P;
  long long heap;              // H, the padded heap row
  long long pstride;           // elements between two ranks' connectors
};

// int32 arithmetic that wraps like the reference's (signed overflow is
// undefined in C++, so it runs on unsigned values).
__device__ __forceinline__ int wmul(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) * static_cast<unsigned>(b));
}
__device__ __forceinline__ int wadd(int a, int b) {
  return static_cast<int>(static_cast<unsigned>(a) + static_cast<unsigned>(b));
}

// Start of lane rl's [B * SL] window in the heap row: base offset ``off``
// plus the chunk and (round, slice) offsets; a negative start counts from
// the end of the row (JAX's negative-index rule), then it is clamped so the
// window fits (lax.dynamic_slice).
__device__ __forceinline__ long long window_start(const BurstArgs& a, int rl,
                                                  int c, int off, int chunked) {
  const int nsl = a.n_slices[c];
  const int stride = wmul(wmul(a.n_rounds[c], nsl), a.SL);
  const int within = wmul(wadd(wmul(a.rnd[rl], nsl), a.sl[rl]), a.SL);
  const int base = wadd(wadd(off, wmul(chunked > 0 ? a.chunk[rl] : 0, stride)),
                        within);
  const long long start = base < 0 ? base + a.heap : base;
  const long long hi = a.heap - static_cast<long long>(a.B) * a.SL;
  return min(max(start, 0LL), hi);
}

__device__ __forceinline__ int clampi(int x, int lo, int hi) {
  return min(max(x, lo), hi);
}

template <typename T>
__device__ __forceinline__ void load16(T* dst, const T* src) {
  *reinterpret_cast<uint4*>(dst) = __ldg(reinterpret_cast<const uint4*>(src));
}

template <typename T>
__device__ __forceinline__ void store16(T* dst, const T* src) {
  *reinterpret_cast<uint4*>(dst) = *reinterpret_cast<const uint4*>(src);
}

// One block per (burst row, 1 KiB column tile).  Each thread owns kVec
// main elements (one 16-byte vector on the vector path, kVec strided
// elements otherwise) plus, on the vector path in tile 0, one element of
// the scalar head and one of the scalar tail: bits 0..kVec+1 of its masks.
template <typename T>
__global__ void __launch_bounds__(kBurstThreads)
fused_burst_kernel(BurstArgs a) {
  constexpr int kVec = 16 / sizeof(T);
  constexpr int kTile = kBurstThreads * kVec;
  constexpr int kSlots = kVec + 2;
  constexpr unsigned kMain = (1u << kVec) - 1;
  const int tid = threadIdx.x;
  const int tile = blockIdx.y;
  const int row = blockIdx.x;                 // (r * L + l) * B + b
  const int b = row % a.B;
  const int rl = row / a.B;
  const int l = rl % a.L;
  const int r = rl / a.L;
  const int SL = a.SL;

  // Lane descriptor: warp-uniform loads, then the per-collective tables.
  const int c = clampi(a.coll[rl], 0, a.C - 1);
  const int pr = clampi(a.prim[rl], 0, a.P - 1);
  const int rc = r * a.C + c;
  const bool recv = a.prim_recv[pr] > 0;
  const bool reduce = a.prim_reduce[pr] > 0;
  const bool reads = a.prim_reads[pr] > 0;
  const int op = clampi(a.op[c], 0, 3);
  const bool need_p = reduce || recv;
  const bool need_x = reduce || (!recv && reads);
  const int nw = a.write[rl] ? a.n[rl] : 0;
  int slot = wadd(a.tail[rl], b) % a.K;
  if (slot < 0) slot += a.K;

  const long long hrow = static_cast<long long>(r) * a.heap;
  const long long bofs = static_cast<long long>(b) * SL;
  const long long out0 = window_start(a, rl, c, a.out_off[rc], a.out_chunked[c]) + bofs;
  const T* prow = static_cast<const T*>(a.payload) + r * a.pstride
      + (static_cast<long long>(c) * a.K + slot) * SL;
  const T* xrow = static_cast<const T*>(a.heap_in) + hrow
      + window_start(a, rl, c, a.in_off[rc], a.in_chunked[c]) + bofs;
  T* orow = static_cast<T*>(a.heap_out) + hrow + out0;
  T* brow = static_cast<T*>(a.outbox) + static_cast<long long>(row) * SL;

  // The vector path needs one offset modulo 16 bytes for every pointer
  // this row touches; the first ``head`` elements then run scalar.
  const unsigned mis = static_cast<unsigned>(reinterpret_cast<uintptr_t>(brow) & 15);
  const bool vec = (reinterpret_cast<uintptr_t>(brow) & (sizeof(T) - 1)) == 0
      && (!need_p || (reinterpret_cast<uintptr_t>(prow) & 15) == mis)
      && (!need_x || (reinterpret_cast<uintptr_t>(xrow) & 15) == mis)
      && (b >= nw || (reinterpret_cast<uintptr_t>(orow) & 15) == mis);
  const int head = min(static_cast<int>(((16 - mis) & 15) / sizeof(T)), SL);
  const int nv = (SL - head) / kVec;
  const int tail0 = head + nv * kVec;

  int pos[kSlots];
  unsigned valid = 0;
  if (vec) {
    const int v = tile * kBurstThreads + tid;
#pragma unroll
    for (int k = 0; k < kVec; ++k) pos[k] = head + v * kVec + k;
    if (v < nv) valid = kMain;
    pos[kVec] = tid;
    pos[kVec + 1] = tail0 + tid;
    if (tile == 0 && tid < head) valid |= 1u << kVec;
    if (tile == 0 && tail0 + tid < SL) valid |= 1u << (kVec + 1);
  } else {
#pragma unroll
    for (int k = 0; k < kVec; ++k) {
      pos[k] = tile * kTile + tid + k * kBurstThreads;
      if (pos[k] < SL) valid |= 1u << k;
    }
    pos[kVec] = pos[kVec + 1] = 0;
  }

  // Every load before the first combine.
  __align__(16) T pe[kSlots];     // 16-byte aligned: the vector path
  __align__(16) T xe[kSlots];     // moves pe[0..kVec) / xe / ve as one
  __align__(16) T ve[kSlots];     // uint4
#pragma unroll
  for (int i = 0; i < kSlots; ++i) pe[i] = xe[i] = from_f32<T>(0.0f);
  if (vec && (valid & kMain)) {
    if (need_p) load16(pe, prow + pos[0]);
    if (need_x) load16(xe, xrow + pos[0]);
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const bool scalar = vec ? i >= kVec : i < kVec;
    if (scalar && ((valid >> i) & 1)) {
      if (need_p) pe[i] = prow[pos[i]];
      if (need_x) xe[i] = xrow[pos[i]];
    }
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) ve[i] = apply<T>(recv, reduce, reads, op, pe[i], xe[i]);

  // heap_out: rows b < nw, less what a later lane of this rank writes.
  unsigned wmask = b < nw ? valid : 0u;
  for (int l2 = l + 1; wmask != 0 && l2 < a.L; ++l2) {
    const int rl2 = r * a.L + l2;
    const int nw2 = a.write[rl2] ? min(a.n[rl2], a.B) : 0;
    if (nw2 <= 0) continue;
    const int c2 = clampi(a.coll[rl2], 0, a.C - 1);
    const long long lo = window_start(a, rl2, c2, a.out_off[r * a.C + c2],
                                      a.out_chunked[c2]) - out0;
    const long long hi = lo + static_cast<long long>(nw2) * SL;
#pragma unroll
    for (int i = 0; i < kSlots; ++i) {
      if (pos[i] >= lo && pos[i] < hi) wmask &= ~(1u << i);
    }
  }

  if (vec && (valid & kMain)) {
    store16(brow + pos[0], ve);
    if ((wmask & kMain) == kMain) store16(orow + pos[0], ve);
  }
#pragma unroll
  for (int i = 0; i < kSlots; ++i) {
    const bool scalar = vec ? i >= kVec : i < kVec;
    if (scalar && ((valid >> i) & 1)) brow[pos[i]] = ve[i];
    const bool single = scalar || (wmask & kMain) != kMain;
    if (single && ((wmask >> i) & 1)) orow[pos[i]] = ve[i];
  }
}

template <typename T>
void launch_burst(const BurstArgs& a, cudaStream_t stream) {
  constexpr int kTile = kBurstThreads * (16 / static_cast<int>(sizeof(T)));
  const dim3 grid(static_cast<unsigned>(a.R * a.L * a.B),
                  static_cast<unsigned>((a.SL + kTile - 1) / kTile));
  fused_burst_kernel<T><<<grid, kBurstThreads, 0, stream>>>(a);
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  vec_ok: 1 when S is a multiple
// of the 16-byte vector width and all three data pointers are 16-byte
// aligned (checked by the Python wrapper).
extern "C" int occl_fused_primitive(const void* payload, const void* local,
                                    const int* flags, void* out, int n_rows,
                                    int s, int dtype, int vec_ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch<float>(payload, local, flags, out, n_rows, s, vec_ok, st); break;
    case 1: launch<__nv_bfloat16>(payload, local, flags, out, n_rows, s, vec_ok, st); break;
    case 2: launch<__half>(payload, local, flags, out, n_rows, s, vec_ok, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}

// The burst of one superstep.  ``lanes`` holds the 8 [R, L] descriptor
// pointers (coll, tail, rnd, sl, chunk, prim, n, write), ``tables`` the 10
// table pointers (in_off, out_off, n_rounds, n_slices, in_chunked,
// out_chunked, op, prim_recv, prim_reduce, prim_reads_in), ``dims`` the 7
// sizes (R, L, B, C, K, SL, P); ``heap`` is the padded heap row H >= B * SL
// and ``pstride`` the payload's rank stride in elements.
// The wrapper checks shapes, dtypes, contiguity and that heap_in and
// heap_out do not share storage.
extern "C" int occl_fused_burst(const void* payload, long long pstride,
                                const void* heap_in, void* heap_out,
                                void* outbox,
                                const void* const* lanes,
                                const void* const* tables, const int* dims,
                                long long heap, int dtype, void* stream) {
  BurstArgs a;
  a.payload = payload;
  a.pstride = pstride;
  a.heap_in = heap_in;
  a.heap_out = heap_out;
  a.outbox = outbox;
  a.coll = static_cast<const int*>(lanes[0]);
  a.tail = static_cast<const int*>(lanes[1]);
  a.rnd = static_cast<const int*>(lanes[2]);
  a.sl = static_cast<const int*>(lanes[3]);
  a.chunk = static_cast<const int*>(lanes[4]);
  a.prim = static_cast<const int*>(lanes[5]);
  a.n = static_cast<const int*>(lanes[6]);
  a.write = static_cast<const unsigned char*>(lanes[7]);
  a.in_off = static_cast<const int*>(tables[0]);
  a.out_off = static_cast<const int*>(tables[1]);
  a.n_rounds = static_cast<const int*>(tables[2]);
  a.n_slices = static_cast<const int*>(tables[3]);
  a.in_chunked = static_cast<const int*>(tables[4]);
  a.out_chunked = static_cast<const int*>(tables[5]);
  a.op = static_cast<const int*>(tables[6]);
  a.prim_recv = static_cast<const int*>(tables[7]);
  a.prim_reduce = static_cast<const int*>(tables[8]);
  a.prim_reads = static_cast<const int*>(tables[9]);
  a.R = dims[0];
  a.L = dims[1];
  a.B = dims[2];
  a.C = dims[3];
  a.K = dims[4];
  a.SL = dims[5];
  a.P = dims[6];
  a.heap = heap;
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  switch (dtype) {
    case 0: launch_burst<float>(a, st); break;
    case 1: launch_burst<__nv_bfloat16>(a, st); break;
    case 2: launch_burst<__half>(a, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return static_cast<int>(cudaGetLastError());
}
