// The sorting redistribution given 12 pre-drawn uniforms, one thread per
// env: CUDA C++ for sm_90a.
//
// Replaces the TPU kernel marl_sortingenv_tpu/ops/mvhg_pallas.py::
// sort_redistribute (body _kernel).  It computes what its plain version
// ops/mvhg_cuda.py::sort_redistribute_plain computes (fastb.redistribute_u
// on the transposed operands), bit for bit, at the same support: per
// station the rint(target * acc) split, then 3 conditional hypergeometric
// draws from the station's 3 uniforms (sort_core.cuh::sort_station).
//
// Layout is the JAX kernel's, batch-first: counts i32[N, 4], acc f32[N, 4],
// uniforms f32[N, 12] (station-major: column 3*st + j) -> leftover, true,
// false i32[N, 4].  The TPU kernel put the support on the 128 lanes; here
// the support is a template parameter and the pmf lives in registers.
//
// What bounds it on an H100: 80 bytes in and 48 out per env against 12
// sampler draws (about 4.4e3 f32 operations at support 16): the
// operations, and at small N the serial chain of one thread.  Rows of 4 and
// 12 values are read as 16-byte vectors.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_core.cuh"

template <int CAP>
__global__ void __launch_bounds__(128)
sort_redistribute_kernel(int n, int support, const int4* __restrict__ counts,
                         const float4* __restrict__ acc,
                         const float4* __restrict__ uniforms,
                         int4* __restrict__ leftover, int4* __restrict__ true_out,
                         int4* __restrict__ false_out) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int S = CAP == 104 ? support : CAP;
    const int4 c = counts[i];
    const float4 a4 = acc[i];
    const float4 u0 = uniforms[3 * i], u1 = uniforms[3 * i + 1], u2 = uniforms[3 * i + 2];
    int lv[4] = {c.x, c.y, c.z, c.w};
    const float a[4] = {a4.x, a4.y, a4.z, a4.w};
    const float us[12] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y,
                          u1.z, u1.w, u2.x, u2.y, u2.z, u2.w};
    int tarr[4], farr[4];
#pragma unroll
    for (int st = 0; st < 4; ++st) {
        const float u[3] = {us[3 * st], us[3 * st + 1], us[3 * st + 2]};
        sort_station<CAP>(st, a[st], u, lv, tarr, farr, S);
    }
    leftover[i] = make_int4(lv[0], lv[1], lv[2], lv[3]);
    true_out[i] = make_int4(tarr[0], tarr[1], tarr[2], tarr[3]);
    false_out[i] = make_int4(farr[0], farr[1], farr[2], farr[3]);
}

extern "C" {

// Launch the kernel over n envs on `stream`.  Every pointer must be
// 16-byte aligned (the wrapper passes fresh contiguous tensors).  Returns
// the cudaError_t of the launch (cudaErrorInvalidValue for a support above
// 104 or n < 1).
int sort_redistribute_launch(int n, int support, const void* counts, const void* acc,
                             const void* uniforms, void* leftover, void* true_out,
                             void* false_out, void* stream) {
    if (n < 1 || support < 1) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int4* c = static_cast<const int4*>(counts);
    const float4* a = static_cast<const float4*>(acc);
    const float4* u = static_cast<const float4*>(uniforms);
    int4* lo = static_cast<int4*>(leftover);
    int4* t = static_cast<int4*>(true_out);
    int4* f = static_cast<int4*>(false_out);
    if (support == 16) {
        sort_redistribute_kernel<16><<<blocks, threads, 0, s>>>(n, support, c, a, u, lo, t, f);
    } else if (support <= 104) {
        sort_redistribute_kernel<104><<<blocks, threads, 0, s>>>(n, support, c, a, u, lo, t, f);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
