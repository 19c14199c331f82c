// The sorting core alone, one thread per env: CUDA C++ for sm_90a.
//
// Replaces the TPU kernel marl_sortingenv_tpu/ops/sort_pallas.py::
// sort_material_fused (body _kernel).  It computes what the port's plain
// version ops/sort_cuda.py::sort_material_plain computes (fastb's
// _sort_uniforms + redistribute_u), bit for bit: per station the threefry
// chain split2 -> split3 -> 3 uniforms, the rint(target * acc) split and
// 3 hypergeometric draws over a support-wide pmf (sort_core.cuh).
//
// Inputs (batch-last, as the engine keeps them): counts i32[4, N], acc
// f32[4, N], keys i32[N, 2] (u32 words).  Outputs: leftover, true, false
// i32[4, N] and the new keys i32[N, 2].
//
// What bounds it on an H100: 40 bytes in and 56 out per env, 0.39 MB at
// 4096 envs (0.12 us at 3.35 TB/s), against 32 threefry blocks (2240
// integer ops) and 12 sampler draws (about 4.4e3 f32 ops at support 16)
// per env.  One thread runs its env's chain serially, so the kernel is
// bound by that chain's latency at small N and by the operations once the
// card is full.  The design: every access is coalesced over N, the state
// of one env lives in registers, and the sampler's arrays stay in
// registers through the support template (16 at the default config; a
// rolled generic instantiation for any support up to 104).  Built with
// --fmad=false, so nothing is fused that the plain version rounds twice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_core.cuh"

template <int CAP>
__global__ void __launch_bounds__(128)
sort_material_kernel(int n, int support, const int* __restrict__ counts,
                     const float* __restrict__ acc, const int* __restrict__ keys,
                     int* __restrict__ leftover, int* __restrict__ true_out,
                     int* __restrict__ false_out, int* __restrict__ new_keys) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    if (i >= n) return;
    const int S = CAP == 104 ? support : CAP;
    int lv[4], tarr[4], farr[4];
    float a[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        lv[j] = counts[j * n + i];
        a[j] = acc[j * n + i];
    }
    uint32_t k0 = (uint32_t)keys[2 * i];
    uint32_t k1 = (uint32_t)keys[2 * i + 1];
    sort_core<CAP>(k0, k1, a, lv, tarr, farr, S);
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        leftover[j * n + i] = lv[j];
        true_out[j * n + i] = tarr[j];
        false_out[j * n + i] = farr[j];
    }
    new_keys[2 * i] = (int)k0;
    new_keys[2 * i + 1] = (int)k1;
}

extern "C" {

// Launch the kernel over n envs on `stream`.  Returns the cudaError_t of
// the launch (cudaErrorInvalidValue for a support above 104 or n < 1).
int sort_material_launch(int n, int support, const void* counts, const void* acc,
                         const void* keys, void* leftover, void* true_out,
                         void* false_out, void* new_keys, void* stream) {
    if (n < 1 || support < 1) return (int)cudaErrorInvalidValue;
    const int threads = 128;
    const int blocks = (n + threads - 1) / threads;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int* c = static_cast<const int*>(counts);
    const float* a = static_cast<const float*>(acc);
    const int* k = static_cast<const int*>(keys);
    int* lo = static_cast<int*>(leftover);
    int* t = static_cast<int*>(true_out);
    int* f = static_cast<int*>(false_out);
    int* nk = static_cast<int*>(new_keys);
    if (support == 16) {
        sort_material_kernel<16><<<blocks, threads, 0, s>>>(n, support, c, a, k, lo, t, f, nk);
    } else if (support <= 104) {
        sort_material_kernel<104><<<blocks, threads, 0, s>>>(n, support, c, a, k, lo, t, f, nk);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
