// The sorting redistribution given 12 pre-drawn uniforms: CUDA C++ for
// sm_90a.
//
// Replaces the TPU kernel marl_sortingenv_tpu/ops/mvhg_pallas.py::
// sort_redistribute (body _kernel).  It computes what its plain version
// ops/mvhg_cuda.py::sort_redistribute_plain computes (fastb.redistribute_u
// on the transposed operands), bit for bit, at the same support, 1 to 128
// (the TPU kernel's lane width): per station the rint(target * acc) split,
// then 3 conditional hypergeometric draws from the station's 3 uniforms
// (sort_core.cuh::sort_station, sort_station_lanes).
//
// Layout is the JAX kernel's, batch-first: counts i32[N, 4], acc f32[N, 4],
// uniforms f32[N, 12] (station-major: column 3*st + j) -> leftover, true,
// false i32[N, 4].  The TPU kernel put the support on the 128 lanes of a
// vector register; here it is spread over a group of lanes of a warp.
//
// What bounds it on an H100: 80 bytes in and 48 out per env against 12
// sampler draws (about 4.4e3 f32 operations at support 16): the
// operations, and at small N the serial chain of 12 dependent draws.  The
// design (the template parameters): a group of LANES consecutive lanes
// redistributes one env, each draw's CAP support points spread over the
// group (hg_draw_lanes); LANES = 1 is one thread per env at exactly its
// cap (a compile-time support).  A group covers any support up to its cap
// at run time, so (32, 128) alone serves supports 33 .. 128: a one-lane
// design with a runtime support (544 B of stack, 1.0-4.0 ms per launch
// on an H100) lost to it at every width and support.
// Every lane of a group reads the env's five 16-byte words (counts, acc,
// 3 x uniforms) through the read-only path -- the same addresses, so one
// request per word for the group.  A block's EPB envs' three outputs are
// contiguous (N, 4) rows: a group's rows are staged in shared memory and
// each output is written as one coalesced run of 4 * EPB words; one thread
// per env stores its own rows as 16-byte vectors, already coalesced.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_core.cuh"

template <int LANES, int CAP>
__global__ void __launch_bounds__(GroupTile<LANES>::THREADS)
sort_redistribute_kernel(int n, int support, const int4* __restrict__ counts,
                         const float4* __restrict__ acc,
                         const float4* __restrict__ uniforms,
                         int* __restrict__ leftover, int* __restrict__ true_out,
                         int* __restrict__ false_out) {
    constexpr int EPB = GroupTile<LANES>::EPB;
    constexpr int THREADS = GroupTile<LANES>::THREADS;
    // output o's row of the block's env e at tile[o * 4 * EPB + 4 * e]
    __shared__ int tile[LANES == 1 ? 1 : 12 * EPB];
    const int env0 = blockIdx.x * EPB;
    const int nv = min(EPB, n - env0);
    const int e = threadIdx.x / LANES;
    const int i = env0 + e;
    const LaneGroup<LANES> g;
    if (i < n) {
        const int S = LANES > 1 ? support : CAP;
        const int4 c = __ldg(counts + i);
        const float4 a4 = __ldg(acc + i);
        const float4 u0 = __ldg(uniforms + 3 * (size_t)i);
        const float4 u1 = __ldg(uniforms + 3 * (size_t)i + 1);
        const float4 u2 = __ldg(uniforms + 3 * (size_t)i + 2);
        int lv[4] = {c.x, c.y, c.z, c.w};
        const float a[4] = {a4.x, a4.y, a4.z, a4.w};
        const float us[12] = {u0.x, u0.y, u0.z, u0.w, u1.x, u1.y,
                              u1.z, u1.w, u2.x, u2.y, u2.z, u2.w};
        int tarr[4], farr[4];
#pragma unroll
        for (int st = 0; st < 4; ++st) {
            if constexpr (LANES == 1) {
                sort_station<CAP>(st, a[st], us + 3 * st, lv, tarr, farr, S);
            } else {
                sort_station_lanes<LANES, CAP>(st, a[st], us + 3 * st, lv, tarr, farr, S, g);
            }
        }
        if constexpr (LANES == 1) {
            reinterpret_cast<int4*>(leftover)[i] = make_int4(lv[0], lv[1], lv[2], lv[3]);
            reinterpret_cast<int4*>(true_out)[i] = make_int4(tarr[0], tarr[1], tarr[2], tarr[3]);
            reinterpret_cast<int4*>(false_out)[i] = make_int4(farr[0], farr[1], farr[2], farr[3]);
        } else {
            // the group's lanes share its 12 words (compile-time indices,
            // so the arrays stay in registers)
            int* const t = tile + 4 * e;
#pragma unroll
            for (int w = 0; w < 12; ++w) {
                if (w % LANES == g.lane) {
                    const int j = w & 3;
                    const int v = w < 4 ? lv[j] : (w < 8 ? tarr[j] : farr[j]);
                    t[(w >> 2) * 4 * EPB + j] = v;
                }
            }
        }
    }
    if constexpr (LANES > 1) {
        __syncthreads();
        for (int idx = threadIdx.x; idx < 12 * EPB; idx += THREADS) {
            const int o = idx / (4 * EPB), w = idx % (4 * EPB);
            if (w < 4 * nv) {
                int* const dst = o == 0 ? leftover : (o == 1 ? true_out : false_out);
                dst[4 * (size_t)env0 + w] = tile[idx];
            }
        }
    }
}

// The designs, (LANES, CAP) pairs (mirrored by ops/mvhg_cuda.py::
// REDISTRIBUTE_DESIGNS through sort_redistribute_designs()): those that
// the design sweep of chip_smoke.py found fastest at some support and
// width on an H100 (PERF.md).
#define REDISTRIBUTE_DESIGNS(X) X(1, 16) X(16, 16) X(32, 32) X(32, 64) X(32, 128)

extern "C" {

// Writes the designs as lanes0, cap0, lanes1, cap1, ... into out (room for
// max pairs); returns their number.
int sort_redistribute_designs(int* out, int max) {
    int k = 0;
#define X(L, C) if (k < max) { out[2 * k] = L; out[2 * k + 1] = C; } ++k;
    REDISTRIBUTE_DESIGNS(X)
#undef X
    return k;
}

// Launch the kernel over n envs with design (lanes, cap) on `stream`.
// Every pointer must be 16-byte aligned (the wrapper passes aligned
// contiguous tensors).  Returns the cudaError_t of the launch
// (cudaErrorInvalidValue for n < 1, a support outside [1, cap], a one-lane
// design at another support than its cap, or a design that is not built).
int sort_redistribute_launch(int n, int support, const void* counts, const void* acc,
                             const void* uniforms, void* leftover, void* true_out,
                             void* false_out, int lanes, int cap, void* stream) {
    if (n < 1 || support < 1 || support > cap ||
        (lanes == 1 && support != cap))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    const int4* c = static_cast<const int4*>(counts);
    const float4* a = static_cast<const float4*>(acc);
    const float4* u = static_cast<const float4*>(uniforms);
    int* lo = static_cast<int*>(leftover);
    int* t = static_cast<int*>(true_out);
    int* f = static_cast<int*>(false_out);
#define X(L, C)                                                                   \
    if (lanes == L && cap == C) {                                                 \
        constexpr int epb = GroupTile<L>::EPB;                                    \
        sort_redistribute_kernel<L, C><<<(n + epb - 1) / epb, GroupTile<L>::THREADS, 0, s>>>( \
            n, support, c, a, u, lo, t, f);                                       \
        return (int)cudaGetLastError();                                           \
    }
    REDISTRIBUTE_DESIGNS(X)
#undef X
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
