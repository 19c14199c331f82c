// threefry2x32 with jax.random's partitionable semantics, one thread per key.
//
// Device counterpart of core/threefry.py (and of the JAX kernels'
// sort_pallas._threefry / _bits_to_unit_f32):
//   split(key, num) row i   = block (0, i), both output words;
//   32-bit random word i    = o0 ^ o1 of block (0, i);
//   uniform in [0, 1)       = bitcast((bits >> 9) | 0x3f800000) - 1.
#pragma once

#include <stdint.h>

__device__ __forceinline__ uint32_t tf_rotl(uint32_t x, int r) {
    return (x << r) | (x >> (32 - r));
}

__device__ __forceinline__ void threefry2x32(uint32_t k0, uint32_t k1,
                                             uint32_t c0, uint32_t c1,
                                             uint32_t& o0, uint32_t& o1) {
    const uint32_t ks[3] = {k0, k1, k0 ^ k1 ^ 0x1BD11BDAu};
    const int rot[2][4] = {{13, 15, 26, 6}, {17, 29, 16, 24}};
    uint32_t x0 = c0 + ks[0];
    uint32_t x1 = c1 + ks[1];
#pragma unroll
    for (int grp = 0; grp < 5; ++grp) {
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            x0 += x1;
            x1 = tf_rotl(x1, rot[grp & 1][j]);
            x1 ^= x0;
        }
        const int i = grp + 1;
        x0 += ks[i % 3];
        x1 += ks[(i + 1) % 3] + (uint32_t)i;
    }
    o0 = x0;
    o1 = x1;
}

// Row i of split(key, num): the new key (n0, n1).
__device__ __forceinline__ void tf_split(uint32_t k0, uint32_t k1, uint32_t i,
                                         uint32_t& n0, uint32_t& n1) {
    threefry2x32(k0, k1, 0u, i, n0, n1);
}

// Word i of random_bits(key, 32, (k,)).
__device__ __forceinline__ uint32_t tf_bits(uint32_t k0, uint32_t k1,
                                            uint32_t i) {
    uint32_t o0, o1;
    threefry2x32(k0, k1, 0u, i, o0, o1);
    return o0 ^ o1;
}

__device__ __forceinline__ float tf_bits_to_unit(uint32_t b) {
    return __uint_as_float((b >> 9) | 0x3F800000u) - 1.0f;
}
