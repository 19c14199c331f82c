// The sorting core of one env: the 4-station sort with its 12
// hypergeometric draws, by one thread (sort_core) or by a group of LANES
// lanes (sort_core_lanes).  Shared by the step kernel (step_mono.cu, section 4)
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
#include "hypergeom_lanes.cuh"
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

// sort_station with the draws spread over the env's lane group.
template <int LANES, int CAP>
__device__ __forceinline__ void sort_station_lanes(int st, const float acc, const float u[3],
                                                   int lv[4], int tarr[4], int farr[4],
                                                   int S, const LaneGroup<LANES>& g) {
    const int target = lv[st];
    const int true_val = (int)rintf((float)target * acc);
    const int false_val = target - true_val;
    tarr[st] = true_val;
    farr[st] = false_val;
    lv[st] = false_val;
    const int N0 = lv[0] + lv[1] + lv[2] + lv[3];
    const int n0 = min(false_val, N0);
    const int d0 = hg_draw_lanes<LANES, CAP>(u[0], N0, lv[0], n0, S, g);
    const int N1 = N0 - lv[0];
    const int n1 = n0 - d0;
    const int d1 = hg_draw_lanes<LANES, CAP>(u[1], N1, lv[1], n1, S, g);
    const int N2 = N1 - lv[1];
    const int n2 = n1 - d1;
    const int d2 = hg_draw_lanes<LANES, CAP>(u[2], N2, lv[2], n2, S, g);
    const int d3 = n2 - d2;
    lv[0] -= d0;
    lv[1] -= d1;
    lv[2] -= d2;
    lv[3] -= d3;
}

// The 12 uniforms of the sorting core, spread over the group: every lane
// walks the 4-block split(k, 0) key chain (the only serial part), then lane
// l draws the uniforms of the (station, j) pairs p = l, l + LANES, ... < 12
// -- split(k_st, 1), split(sk, j) and one word, 3 blocks deep -- and the
// group hands them round by shuffles.  On exit (k0, k1) is the advanced
// key and u[3 * st + j] the uniform of pair (st, j), in every lane.
template <int LANES>
__device__ __forceinline__ void sort_uniforms_lanes(uint32_t& k0, uint32_t& k1, float u[12],
                                                    const LaneGroup<LANES>& g) {
    uint32_t c0[5], c1[5];
    c0[0] = k0;
    c1[0] = k1;
#pragma unroll
    for (int st = 0; st < 4; ++st) tf_split(c0[st], c1[st], 0u, c0[st + 1], c1[st + 1]);
    k0 = c0[4];
    k1 = c1[4];
    constexpr int R = (12 + LANES - 1) / LANES;
    float ur[R];
#pragma unroll
    for (int r = 0; r < R; ++r) {
        const int p = min(g.lane + r * LANES, 11);
        const int st = p / 3;
        uint32_t a0 = c0[0], a1 = c1[0];
#pragma unroll
        for (int q = 1; q < 4; ++q) {
            if (st == q) {
                a0 = c0[q];
                a1 = c1[q];
            }
        }
        uint32_t s0, s1, q0, q1;
        tf_split(a0, a1, 1u, s0, s1);
        tf_split(s0, s1, (uint32_t)(p - 3 * st), q0, q1);
        ur[r] = tf_bits_to_unit(tf_bits(q0, q1, 0u));
    }
#pragma unroll
    for (int p = 0; p < 12; ++p) u[p] = g.get(ur[p / LANES], p % LANES);
}

// sort_core by a group of LANES lanes: the same inputs and outputs, in
// every lane of the group.
template <int LANES, int CAP>
__device__ __forceinline__ void sort_core_lanes(uint32_t& k0, uint32_t& k1, const float acc[4],
                                                int lv[4], int tarr[4], int farr[4], int S,
                                                const LaneGroup<LANES>& g) {
    float u[12];
    sort_uniforms_lanes<LANES>(k0, k1, u, g);
#pragma unroll
    for (int st = 0; st < 4; ++st)
        sort_station_lanes<LANES, CAP>(st, acc[st], u + 3 * st, lv, tarr, farr, S, g);
}
