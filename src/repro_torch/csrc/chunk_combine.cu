// Bulk chunk combine for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ``chunk_combine_pallas`` of
// src/repro/kernels/chunk_combine.py (body ``_kernel``): an elementwise
// combine of two flat [T] buffers,
//
//   out[i] = op(a[i], b[i])   computed in f32, rounded once to the input dtype
//
// with a STATIC op (a template parameter here, as it is a static argument
// of the Pallas kernel): 0 sum, 1 max, 2 min, 3 prod.  max/min propagate
// NaN like jnp.maximum / jnp.minimum (fmaxf/fminf alone would return the
// non-NaN operand): a NaN operand is returned as it is, a (and its payload)
// first.  Sum and product use the round-to-nearest intrinsics and the
// library is compiled with -fmad=false, so nothing is contracted.
//
// What bounds it: memory traffic — 2 reads and 1 write of T elements, one
// op per element: 3 * T * itemsize bytes, 50.3 MB for T = 2^22 f32, i.e.
// 0.0150 ms at 3.35 TB/s.  Design: a grid-stride loop over 16-byte vectors
// (float4 for f32, 8 x 16-bit for bf16/f16), neighbouring threads on
// neighbouring vectors.  The buffers need not be 16-byte aligned (a slice
// of the heap starts anywhere) and T need not divide anything, so the
// first ``head`` elements and the ragged tail are combined one element at
// a time; the wrapper picks ``head`` so that a + head, b + head and
// out + head are all 16-byte aligned, and passes vec_ok = 0 (all scalar)
// when no such head exists.
//
// Plain C interface (loaded with ctypes); returns cudaGetLastError() after
// the launch, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 256;
constexpr int kMaxBlocks = 8192;

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

template <int OP>
__device__ __forceinline__ float combine(float a, float b) {
  if (OP == 0) return __fadd_rn(a, b);
  if (OP == 1) return isnan(a) ? a : (isnan(b) ? b : fmaxf(a, b));
  if (OP == 2) return isnan(a) ? a : (isnan(b) ? b : fminf(a, b));
  return __fmul_rn(a, b);
}

template <typename T, int OP>
__device__ __forceinline__ T apply(T a, T b) {
  return from_f32<T>(combine<OP>(to_f32(a), to_f32(b)));
}

template <typename T, int OP>
__global__ void __launch_bounds__(kThreads)
chunk_combine_kernel(const T* __restrict__ a, const T* __restrict__ b,
                     T* __restrict__ out, int64_t t, int64_t head,
                     int vec_ok) {
  const int64_t tid = static_cast<int64_t>(blockIdx.x) * blockDim.x + threadIdx.x;
  const int64_t stride = static_cast<int64_t>(gridDim.x) * blockDim.x;
  if (!vec_ok) {
    for (int64_t i = tid; i < t; i += stride) out[i] = apply<T, OP>(a[i], b[i]);
    return;
  }
  constexpr int kVec = 16 / sizeof(T);
  const int64_t nvec = (t - head) / kVec;
  const int64_t tail = head + nvec * kVec;
  // Scalar head and tail: fewer than 2 * kVec elements in all.
  if (tid < head) out[tid] = apply<T, OP>(a[tid], b[tid]);
  if (tid < t - tail) {
    const int64_t i = tail + tid;
    out[i] = apply<T, OP>(a[i], b[i]);
  }
  const uint4* a4 = reinterpret_cast<const uint4*>(a + head);
  const uint4* b4 = reinterpret_cast<const uint4*>(b + head);
  uint4* o4 = reinterpret_cast<uint4*>(out + head);
  for (int64_t i = tid; i < nvec; i += stride) {
    const uint4 av = a4[i];
    const uint4 bv = b4[i];
    uint4 ov;
    const T* ae = reinterpret_cast<const T*>(&av);
    const T* be = reinterpret_cast<const T*>(&bv);
    T* oe = reinterpret_cast<T*>(&ov);
#pragma unroll
    for (int k = 0; k < kVec; ++k) oe[k] = apply<T, OP>(ae[k], be[k]);
    o4[i] = ov;
  }
}

template <typename T, int OP>
void launch_op(const void* a, const void* b, void* out, int64_t t,
               int64_t head, int vec_ok, cudaStream_t stream) {
  const int64_t work = vec_ok ? (t - head) / (16 / static_cast<int64_t>(sizeof(T))) + 1 : t;
  int64_t blocks = (work + kThreads - 1) / kThreads;
  if (blocks < 1) blocks = 1;
  if (blocks > kMaxBlocks) blocks = kMaxBlocks;
  chunk_combine_kernel<T, OP><<<static_cast<int>(blocks), kThreads, 0, stream>>>(
      static_cast<const T*>(a), static_cast<const T*>(b), static_cast<T*>(out),
      t, head, vec_ok);
}

template <typename T>
int launch(const void* a, const void* b, void* out, int64_t t, int op,
           int64_t head, int vec_ok, cudaStream_t stream) {
  switch (op) {
    case 0: launch_op<T, 0>(a, b, out, t, head, vec_ok, stream); break;
    case 1: launch_op<T, 1>(a, b, out, t, head, vec_ok, stream); break;
    case 2: launch_op<T, 2>(a, b, out, t, head, vec_ok, stream); break;
    case 3: launch_op<T, 3>(a, b, out, t, head, vec_ok, stream); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  return 0;
}

}  // namespace

// dtype: 0 float32, 1 bfloat16, 2 float16.  op: 0 sum, 1 max, 2 min,
// 3 prod.  head: elements before the 16-byte-aligned body (the same for all
// three pointers); vec_ok: 0 runs everything element by element.
extern "C" int occl_chunk_combine(const void* a, const void* b, void* out,
                                  int64_t t, int dtype, int op, int64_t head,
                                  int vec_ok, void* stream) {
  cudaStream_t st = static_cast<cudaStream_t>(stream);
  int err;
  switch (dtype) {
    case 0: err = launch<float>(a, b, out, t, op, head, vec_ok, st); break;
    case 1: err = launch<__nv_bfloat16>(a, b, out, t, op, head, vec_ok, st); break;
    case 2: err = launch<__half>(a, b, out, t, op, head, vec_ok, st); break;
    default: return static_cast<int>(cudaErrorInvalidValue);
  }
  if (err != 0) return err;
  return static_cast<int>(cudaGetLastError());
}
