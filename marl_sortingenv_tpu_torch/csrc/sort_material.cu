// The sorting core alone: CUDA C++ for sm_90a.
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
// per env.  One thread per env runs that chain serially, so its time is
// the chain's latency.  The design: a group of LANES lanes per env (the
// template parameter; LANES = 1 is one thread per env) walks the 4-block
// key chain, spreads the 12 uniforms' blocks over its lanes and each draw's
// support points over its lanes (sort_core_lanes); inputs are read through
// the read-only path; a group's outputs are staged in shared memory and
// written as row slices of the block's EPB envs (one thread per env writes
// its own, already coalesced).  Built with --fmad=false, so nothing is
// fused that the plain version rounds twice.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_core.cuh"

// Staged output words of each env: leftover, true, false (4 rows each),
// then the key's two words; slot s of the block's env e at tile[s * EPB + e].
enum { SM_LEFT = 0, SM_TRUE = 4, SM_FALSE = 8, SM_KEY = 12, SM_SLOTS = 14 };

template <int LANES, int CAP>
__global__ void __launch_bounds__(GroupTile<LANES>::THREADS)
sort_material_kernel(int n, int support, const int* __restrict__ counts,
                     const float* __restrict__ acc, const int* __restrict__ keys,
                     int* __restrict__ leftover, int* __restrict__ true_out,
                     int* __restrict__ false_out, int* __restrict__ new_keys) {
    constexpr int EPB = GroupTile<LANES>::EPB;
    constexpr int THREADS = GroupTile<LANES>::THREADS;
    __shared__ int tile[LANES == 1 ? 1 : SM_SLOTS * EPB];
    const int env0 = blockIdx.x * EPB;
    const int nv = min(EPB, n - env0);
    const int e = threadIdx.x / LANES;
    const int i = env0 + e;
    const LaneGroup<LANES> g;
    if (i < n) {
        // a one-lane design runs at S = CAP exactly
        const int S = LANES > 1 ? support : CAP;
        int lv[4], tarr[4], farr[4];
        float a[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            lv[j] = __ldg(counts + (size_t)j * n + i);
            a[j] = __ldg(acc + (size_t)j * n + i);
        }
        uint32_t k0 = (uint32_t)__ldg(keys + 2 * (size_t)i);
        uint32_t k1 = (uint32_t)__ldg(keys + 2 * (size_t)i + 1);
        if constexpr (LANES == 1) {
            sort_core<CAP>(k0, k1, a, lv, tarr, farr, S);
        } else {
            sort_core_lanes<LANES, CAP>(k0, k1, a, lv, tarr, farr, S, g);
        }
        if constexpr (LANES == 1) {
            // one thread per env: these stores are coalesced as they stand
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                leftover[(size_t)j * n + i] = lv[j];
                true_out[(size_t)j * n + i] = tarr[j];
                false_out[(size_t)j * n + i] = farr[j];
            }
            new_keys[2 * (size_t)i] = (int)k0;
            new_keys[2 * (size_t)i + 1] = (int)k1;
            return;
        }
        int* const t = tile + e;
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            t[(SM_LEFT + j) * EPB] = lv[j];
            t[(SM_TRUE + j) * EPB] = tarr[j];
            t[(SM_FALSE + j) * EPB] = farr[j];
        }
        t[SM_KEY * EPB] = (int)k0;
        t[(SM_KEY + 1) * EPB] = (int)k1;
    }
    if constexpr (LANES == 1) return;
    __syncthreads();
    for (int idx = threadIdx.x; idx < 12 * EPB; idx += THREADS) {
        const int s = idx / EPB, ee = idx % EPB;
        if (ee < nv) {
            int* const dst = s < SM_TRUE ? leftover : (s < SM_FALSE ? true_out : false_out);
            dst[(size_t)(s & 3) * n + env0 + ee] = tile[idx];
        }
    }
    for (int idx = threadIdx.x; idx < 2 * nv; idx += THREADS)
        new_keys[2 * (size_t)env0 + idx] = tile[(SM_KEY + (idx & 1)) * EPB + (idx >> 1)];
}

// The designs, (LANES, CAP) pairs, as in step_mono.cu: those
// ops/sort_cuda.py's table picks (mirrored by ops/sort_cuda.py::SORT_DESIGNS
// through sort_material_designs()).
#define SORT_DESIGNS(X) X(1, 16) X(16, 16) X(16, 32) X(32, 32) X(32, 64) X(32, 128)

extern "C" {

// Writes the designs as lanes0, cap0, lanes1, cap1, ... into out (room for
// max pairs); returns their number.
int sort_material_designs(int* out, int max) {
    int k = 0;
#define X(L, C) if (k < max) { out[2 * k] = L; out[2 * k + 1] = C; } ++k;
    SORT_DESIGNS(X)
#undef X
    return k;
}

// Launch the kernel over n envs with design (lanes, cap) on `stream`.
// Returns the cudaError_t of the launch (cudaErrorInvalidValue for n < 1, a
// support outside [1, cap], a one-lane design at another support than its
// cap, or a design that is not built).
int sort_material_launch(int n, int support, const void* counts, const void* acc,
                         const void* keys, void* leftover, void* true_out,
                         void* false_out, void* new_keys, int lanes, int cap,
                         void* stream) {
    if (n < 1 || support < 1 || support > cap || (lanes == 1 && support != cap))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int* c = static_cast<const int*>(counts);
    const float* a = static_cast<const float*>(acc);
    const int* k = static_cast<const int*>(keys);
    int* lo = static_cast<int*>(leftover);
    int* t = static_cast<int*>(true_out);
    int* f = static_cast<int*>(false_out);
    int* nk = static_cast<int*>(new_keys);
#define X(L, C)                                                                   \
    if (lanes == L && cap == C) {                                                 \
        constexpr int epb = GroupTile<L>::EPB;                                    \
        sort_material_kernel<L, C><<<(n + epb - 1) / epb, GroupTile<L>::THREADS, 0, s>>>( \
            n, support, c, a, k, lo, t, f, nk);                                   \
        return (int)cudaGetLastError();                                           \
    }
    SORT_DESIGNS(X)
#undef X
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
