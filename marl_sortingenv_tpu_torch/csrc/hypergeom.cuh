// One hypergeometric draw X ~ Hypergeometric(N, K, n) by inverse CDF from
// the uniform u, one thread per draw.
//
// Copies core/fastb.py::_hypergeom_u (and the JAX sort kernel's _hg_u) op
// for op, so the float rounding is identical:
//   ratio[k] = (K-k)(n-k) / ((k+1)(N-K-n+k+1))  for lo <= k < hi, else 1
//   pmf      = [1, prefix_prod(ratio)[:-1]], zeroed outside [lo, hi]
//   cdf      = prefix_sum(pmf);  X = clip(#{k : cdf[k] < u * cdf[S-1]}, lo, hi)
// Both prefix scans use the Hillis-Steele doubling association
// (x[k] op= x[k - s] for s = 1, 2, 4, ...), walked from the top so each
// step reads the values of the previous one.  Division is IEEE (no fast
// math).  CAP is the array size; S <= CAP is the support.  With S a
// compile-time constant after inlining, the arrays stay in registers.  The
// loops of a large CAP (the generic runtime-support path) stay rolled,
// which keeps its build short.
#pragma once

#define HG_UNROLL _Pragma("unroll (CAP <= 32 ? CAP : 1)")

template <int CAP>
__device__ __forceinline__ int hg_draw(float u, int N, int K, int n, int S) {
    float x[CAP];
    const float Nf = (float)max(N, 1);
    const float Kf = (float)K;
    const float nf = (float)n;
    const int lo = max(0, n - (N - K));
    const int hi = min(K, n);
    HG_UNROLL
    for (int k = 0; k < CAP; ++k) {
        if (k < S) {
            const float kf = (float)k;
            const float num = (Kf - kf) * (nf - kf);
            const float den = (kf + 1.0f) * ((((Nf - Kf) - nf) + kf) + 1.0f);
            x[k] = (k >= lo && k < hi) ? num / den : 1.0f;
        }
    }
    HG_UNROLL
    for (int s = 1; s < CAP; s <<= 1) {
        HG_UNROLL
        for (int k = CAP - 1; k >= s; --k) {
            if (k < S) x[k] = x[k] * x[k - s];
        }
    }
    // pmf: shift by one, 1 at k = 0, zero outside [lo, hi]
    HG_UNROLL
    for (int k = CAP - 1; k >= 1; --k) {
        if (k < S) x[k] = x[k - 1];
    }
    x[0] = 1.0f;
    HG_UNROLL
    for (int k = 0; k < CAP; ++k) {
        if (k < S && !(k >= lo && k <= hi)) x[k] = 0.0f;
    }
    HG_UNROLL
    for (int s = 1; s < CAP; s <<= 1) {
        HG_UNROLL
        for (int k = CAP - 1; k >= s; --k) {
            if (k < S) x[k] = x[k] + x[k - s];
        }
    }
    const float us = u * x[S - 1];
    int cnt = 0;
    HG_UNROLL
    for (int k = 0; k < CAP; ++k) {
        if (k < S) cnt += (x[k] < us) ? 1 : 0;
    }
    return min(max(cnt, lo), hi);
}
