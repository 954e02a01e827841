// Fused primitive slice application for NVIDIA Hopper (sm_90a).
//
// Replaces the TPU kernel ``fused_primitive_pallas`` of
// src/repro/kernels/fused_slice.py (body ``_kernel``).  For each row n of the
// superstep burst, with flags[n] = (recv, reduce, reads_in, op):
//
//   out[n] = op(payload[n], local[n])  computed in f32, rounded back   if reduce
//          = payload[n]                                               elif recv
//          = local[n]                                                 elif reads_in
//          = 0                                                        otherwise
//
// op: 0 sum, 1 max, 2 min, 3 prod (clipped to 0..3).  max/min propagate NaN
// like jnp.maximum / jnp.minimum (fmaxf/fminf alone would return the
// non-NaN operand).  There is one arithmetic op per element, built from the
// round-to-nearest intrinsics, and the library is compiled with
// -fmad=false, so nothing is contracted into an FMA.  The non-reducing
// branches copy the element's bits unchanged.
//
// What bounds it: memory traffic — 2 reads and 1 write of N*S elements plus
// 16 bytes of flags per row, one op per element.  At the scheduler's shapes
// (N = R*L*B rows of S = slice_elems, e.g. 64 x 1024 f32 = 256 KiB read) the
// launch itself dominates: the kernel is launch-bound, not bandwidth-bound.
// Design: one block per row, 128 threads, each thread moving 16 bytes per
// load/store (float4 for f32, 8 x 16-bit for bf16/f16) in a loop over S;
// the row's four flags are read once per block through shared memory.
// A faster design — fusing the recv_val / in_val gathers of the scheduler
// (src/repro/core/scheduler.py:564-583) into this kernel so the burst is
// read straight from the connector slots and the heap windows — is later
// work.
//
// Plain C interface (loaded with ctypes); returns cudaGetLastError() after
// the launch, so a refused launch is reported to the caller.

#include <cuda_bf16.h>
#include <cuda_fp16.h>
#include <cuda_runtime.h>
#include <stdint.h>

namespace {

constexpr int kThreads = 128;

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
