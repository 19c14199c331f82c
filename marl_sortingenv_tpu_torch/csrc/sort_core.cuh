// The sorting core of one env, one thread: the 4-station sort with its 12
// hypergeometric draws.  Shared by the step kernel (step_mono.cu, section 4)
// and the sorting-core kernel (sort_material.cu); the redistribution of one
// station given its 3 uniforms is shared with sort_redistribute.cu.
//
// Computes what core/fastb.py computes in _sort_uniforms + redistribute_u
// (and the JAX kernel sort_pallas._kernel), op for op:
//   per station: split(key) -> (key, sk); split(sk, 3); one uniform from
//   each of the 3 keys; then target = leftover[st], true = rint(target *
//   acc[st]) (half-even), false = target - true, and 3 conditional draws
//   over the leftover categories remove `false` units from them.
#pragma once

#include <stdint.h>

#include "hypergeom.cuh"
#include "threefry.cuh"

// One station's split and redistribution (fastb.redistribute_u, loop body
// i = st) on the leftover counts lv, given its 3 uniforms u.
template <int CAP>
__device__ __forceinline__ void sort_station(int st, const float acc, const float u[3],
                                             int lv[4], int tarr[4], int farr[4], int S) {
    const int target = lv[st];
    const int true_val = (int)rintf((float)target * acc);
    const int false_val = target - true_val;
    tarr[st] = true_val;
    farr[st] = false_val;
    lv[st] = false_val;
    const int N0 = lv[0] + lv[1] + lv[2] + lv[3];
    const int n0 = min(false_val, N0);
    const int d0 = hg_draw<CAP>(u[0], N0, lv[0], n0, S);
    const int N1 = N0 - lv[0];
    const int n1 = n0 - d0;
    const int d1 = hg_draw<CAP>(u[1], N1, lv[1], n1, S);
    const int N2 = N1 - lv[1];
    const int n2 = n1 - d1;
    const int d2 = hg_draw<CAP>(u[2], N2, lv[2], n2, S);
    const int d3 = n2 - d2;
    lv[0] -= d0;
    lv[1] -= d1;
    lv[2] -= d2;
    lv[3] -= d3;
}

// The whole sorting core: on entry lv holds the sorter's counts and
// (k0, k1) the env's key; on exit lv holds the leftover (to container E),
// tarr/farr the true/false splits, and (k0, k1) the advanced key.
template <int CAP>
__device__ __forceinline__ void sort_core(uint32_t& k0, uint32_t& k1, const float acc[4],
                                          int lv[4], int tarr[4], int farr[4], int S) {
#pragma unroll
    for (int st = 0; st < 4; ++st) {
        uint32_t sk0, sk1, nk0, nk1;
        tf_split(k0, k1, 1u, sk0, sk1);
        tf_split(k0, k1, 0u, nk0, nk1);
        k0 = nk0;
        k1 = nk1;
        float u[3];
#pragma unroll
        for (int j = 0; j < 3; ++j) {
            uint32_t q0, q1;
            tf_split(sk0, sk1, (uint32_t)j, q0, q1);
            u[j] = tf_bits_to_unit(tf_bits(q0, q1, 0u));
        }
        sort_station<CAP>(st, acc[st], u, lv, tarr, farr, S);
    }
}
