// One hypergeometric draw X ~ Hypergeometric(N, K, n) by inverse CDF from
// the uniform u, computed by a group of LANES consecutive lanes of a warp.
//
// The same function as hg_draw<CAP> (hypergeom.cuh), with the same float
// rounding: the support axis k = 0 .. CAP-1 is spread over the group, lane
// l holding the PPL = CAP / LANES consecutive points k = l*PPL .. l*PPL +
// PPL - 1 in registers.  Every lane of the group passes the same (u, N, K,
// n, S) and gets the same draw back.
//   ratio[k]   one IEEE division per point, as in hg_draw;
//   prefix     the Hillis-Steele doubling steps s = 1, 2, 4, ...: point k
//              takes x[k] op x[k - s] as both stood after the previous
//              step, from its own registers or through __shfl_up_sync from
//              the lane s / PPL (or 1) below; points k < s keep their value
//              -- exactly hg_draw's association, so the same bits;
//   pmf shift  one __shfl_up_sync by one point, 1 at k = 0;
//   threshold  u * x[S-1], the total read from the lane that holds point
//              S-1 (a padded point's doubling tree groups the terms
//              differently, so the group's last lane may differ in the last
//              bit);
//   count      __popc of the group's __ballot_sync over the points k < S.
// Points at or above the support S stay inert in every step, as hg_draw's
// `if (k < S)` keeps them.  The built designs run CAP from 16 to 128 with
// PPL from 1 to 8 (at (32, 128) a step reads up to 16 lanes below).  No shuffle sits under a lane-dependent branch,
// and every shuffle names only the group's lanes, so groups of one warp may
// diverge from each other (an env past the end of the batch skips its step
// while its neighbours draw).
#pragma once

#include <stdint.h>

// The lanes of one env's group: its index in the group and the warp mask of
// the whole group.  LANES divides 32 and groups start at multiples of
// LANES, so a group never straddles two warps.
template <int LANES>
struct LaneGroup {
    static_assert(LANES >= 1 && LANES <= 32 && (LANES & (LANES - 1)) == 0,
                  "LANES is a power of two up to 32");
    int lane;
    unsigned mask;
    __device__ __forceinline__ LaneGroup() {
        const int w = (int)(threadIdx.x & 31u);
        lane = w & (LANES - 1);
        mask = (0xFFFFFFFFu >> (32 - LANES)) << (w & ~(LANES - 1));
    }
    // the value v of lane src of the group
    template <typename T>
    __device__ __forceinline__ T get(T v, int src) const {
        return LANES == 1 ? v : __shfl_sync(mask, v, src, LANES);
    }
};

// The block shape of a kernel that steps EPB envs per block with a group of
// LANES lanes each: at least 16 envs per block, so that a block's slice of
// an (rows, N) leaf is a whole 32-byte sector of int16 or 64 bytes of
// 32-bit words, and 128 threads where that already holds.
template <int LANES>
struct GroupTile {
    static constexpr int EPB = LANES == 1 ? 128 : (128 / LANES > 16 ? 128 / LANES : 16);
    static constexpr int THREADS = LANES * EPB;
};

template <int LANES, int CAP>
__device__ __forceinline__ int hg_draw_lanes(float u, int N, int K, int n,
                                             int S, const LaneGroup<LANES>& g) {
    static_assert(CAP % LANES == 0, "the group covers the support evenly");
    constexpr int PPL = CAP / LANES;
    const float Nf = (float)max(N, 1);
    const float Kf = (float)K;
    const float nf = (float)n;
    const int lo = max(0, n - (N - K));
    const int hi = min(K, n);
    const int k0 = g.lane * PPL;
    float x[PPL];
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
        const int k = k0 + j;
        const float kf = (float)k;
        const float num = (Kf - kf) * (nf - kf);
        const float den = (kf + 1.0f) * ((((Nf - Kf) - nf) + kf) + 1.0f);
        x[j] = (k < S && k >= lo && k < hi) ? num / den : 1.0f;
    }
    // prefix product
#pragma unroll
    for (int s = 1; s < CAP; s <<= 1) {
        float y[PPL];
#pragma unroll
        for (int j = 0; j < PPL; ++j) {
            float src;
            if (s < PPL && j >= s) {
                src = x[j - s];
            } else if (s < PPL) {
                src = __shfl_up_sync(g.mask, x[PPL + j - s], 1, LANES);
            } else {
                src = __shfl_up_sync(g.mask, x[j], s / PPL, LANES);
            }
            const int k = k0 + j;
            y[j] = (k >= s && k < S) ? x[j] * src : x[j];
        }
#pragma unroll
        for (int j = 0; j < PPL; ++j) x[j] = y[j];
    }
    // pmf: shift by one, 1 at k = 0, zero outside [lo, hi]
    {
        const float up = __shfl_up_sync(g.mask, x[PPL - 1], 1, LANES);
#pragma unroll
        for (int j = PPL - 1; j >= 1; --j) {
            if (k0 + j < S) x[j] = x[j - 1];
        }
        x[0] = k0 == 0 ? 1.0f : (k0 < S ? up : x[0]);
#pragma unroll
        for (int j = 0; j < PPL; ++j) {
            const int k = k0 + j;
            if (k < S && !(k >= lo && k <= hi)) x[j] = 0.0f;
        }
    }
    // prefix sum
#pragma unroll
    for (int s = 1; s < CAP; s <<= 1) {
        float y[PPL];
#pragma unroll
        for (int j = 0; j < PPL; ++j) {
            float src;
            if (s < PPL && j >= s) {
                src = x[j - s];
            } else if (s < PPL) {
                src = __shfl_up_sync(g.mask, x[PPL + j - s], 1, LANES);
            } else {
                src = __shfl_up_sync(g.mask, x[j], s / PPL, LANES);
            }
            const int k = k0 + j;
            y[j] = (k >= s && k < S) ? x[j] + src : x[j];
        }
#pragma unroll
        for (int j = 0; j < PPL; ++j) x[j] = y[j];
    }
    // the total from the lane holding point S-1
    float mine = x[0];
#pragma unroll
    for (int j = 1; j < PPL; ++j) {
        if (j == (S - 1) % PPL) mine = x[j];
    }
    const float us = u * __shfl_sync(g.mask, mine, (S - 1) / PPL, LANES);
    int cnt = 0;
#pragma unroll
    for (int j = 0; j < PPL; ++j) {
        const unsigned b = __ballot_sync(g.mask, k0 + j < S && x[j] < us);
        cnt += __popc(b & g.mask);
    }
    return min(max(cnt, lo), hi);
}
