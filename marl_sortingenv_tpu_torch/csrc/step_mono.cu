// The whole fastb env step: CUDA C++ for sm_90a.
//
// Replaces the TPU kernel marl_sortingenv_tpu/ops/step_pallas.py::step_mono
// (body _kernel).  It computes what the port's eager step computes
// (core/fastb.py: _rule_body, _external_body, _sort_body, _press_body, and
// with_autoreset around them), bit for bit:
//   input generator -> accuracy delay, boost and noise -> 4-station sort
//   with 12 hypergeometric draws -> press tick, event append, press load
//   -> pre-tanh sorting-reward argument and press reward -> observations
//   -> termination -> optional fused autoreset.
//
// What bounds it on an H100: the env step has no reuse across envs, so it
// is a streaming kernel.  At the default config (E = 33 event rows) the
// step reads and writes 887 bytes per env, 3.6 MB per launch at 4096 envs:
// 1.1 us at 3.35 TB/s.  The arithmetic is about 4e3 integer operations (51
// threefry blocks) and 5e3 f32 operations (12 sampler draws) per env.  What
// sets the time of one thread per env is neither: it is the latency of the
// env's serial chain (51 threefry blocks, 12 draws of a 16-point scan each,
// one after another), with 4096 envs filling only 32 of the 132 SMs.
//
// The design: a group of LANES consecutive lanes of a warp steps one env
// (the template parameter; LANES = 1 is one thread per env).  Every lane of
// the group runs the env's scalar step redundantly, in registers; the
// group splits what is wide: the sampler's support points
// (hypergeom_lanes.cuh), and the random words whose keys do not depend on
// the step -- the 4 randint and 4 noise words, and the sorting core's 12
// uniforms behind its 4-block key chain (sort_core.cuh).  That cuts the
// serial chain to about 9 threefry blocks and 12 draws of log2(S) shuffle
// steps.  Memory: a block steps EPB envs (GroupTile); it copies its slice
// of the event log in one block-wide pass, stages every output word and
// observation in shared memory, and writes them after one __syncthreads
// as row slices of EPB envs, so a warp's stores are contiguous; inputs are
// read through the read-only path (every lane of a group reads the same
// word); one thread per env writes its state words itself (coalesced as
// they stand) and stages only its observations.  The at most two appended
// event rows are written after the copy.
//
// Bitwise rules (the build uses --fmad=false): a multiply-add is fused
// only where XLA fuses it on the CPU (the noise draw and three press-reward
// terms, written as __fmaf_rn); division by a config constant is a product
// with its f32 reciprocal, folded on the host as XLA folds it; rintf is
// half-even; float -> int casts truncate.  tanh is left to the caller.
#include <cuda_runtime.h>
#include <stdint.h>

#include "sort_core.cuh"
#include "threefry.cuh"

enum { V_RULE = 0, V_EXTERNAL = 1, V_SORT = 2, V_PRESS = 3 };

// Host-computed constants; the layout is mirrored by a ctypes.Structure in
// ops/step_cuda.py (checked through step_mono_consts_size()).
struct StepConsts {
    int n, E, steps_per_pattern;
    int units0[4], units1[4];
    int rem0, rem1, balesize, press_time_1, press_time_2, max_steps;
    int variant, masked, autoreset, support;
    float base_acc[4];
    float boost, noise, noise_lo, noise_span;
    float quality_threshold, theta, sort_scale;
    float recip_cap, recip_stage, recip_pt1, recip_pt2, recip_100;
    float pen_severe, pen_mild, pen_catastrophic;
    float state_scale, dist_scale, bale_eff, third, two_thirds;
};

// Input and output leaves, in the order of step_cuda.IN_NAMES (+ action)
// and STATE_OUT + EXTRA_OUT.
enum {
    I_INPUT, I_BELT, I_ACC_BELT, I_INPUT_OCC, I_CONT_T, I_CONT_F, I_TIMER,
    I_PMAT, I_PN, I_PQ, I_EV_MAT, I_EV_N, I_EV_Q, I_EV_CNT, I_LPS, I_LPA,
    I_GFIRST, I_GIDX, I_GCTR, I_CSTEP, I_TOTIN, I_KEY, I_ACTION, N_IN
};
enum {
    O_INPUT, O_BELT, O_SORT, O_ACC_BELT, O_ACC_SORTER, O_SENSOR, O_INPUT_OCC,
    O_BELT_OCC, O_CONT_T, O_CONT_F, O_TIMER, O_PMAT, O_PN, O_PQ, O_EV_MAT,
    O_EV_N, O_EV_Q, O_EV_CNT, O_LPS, O_LPA, O_GFIRST, O_GIDX, O_GCTR,
    O_CSTEP, O_TOTIN, O_KEY, O_OBS, O_RAW_SORT, O_PRESS_REWARD, O_PURITY,
    O_ACTION, O_TERM, N_OUT
};

struct StepPtrs {
    const void* in[N_IN];
    void* out[N_OUT];
};

// The per-env output words staged in shared memory, slot-major: slot s of
// the block's env e is tile[s * EPB + e].  Slots below N32 are 32-bit words
// of (rows, N) or (N,) leaves; then the two bool leaves and the key's two
// words.
enum {
    S_INPUT = 0, S_BELT = 4, S_SORT = 8, S_ACC_BELT = 12, S_ACC_SORTER = 16,
    S_CONT_F = 20, S_CONT_T = 24, S_TIMER = 29, S_PMAT = 31, S_PN = 33,
    S_PQ = 35, S_SENSOR = 37, S_INPUT_OCC, S_BELT_OCC, S_EV_CNT, S_LPA,
    S_GFIRST, S_GIDX, S_GCTR, S_CSTEP, S_TOTIN, S_RAW_SORT, S_PRESS_REWARD,
    S_PURITY, S_ACTION, N32,
    S_LPS = N32, S_TERM, S_KEY, N_SLOT = S_KEY + 2
};
constexpr int OBS_MAX = 29;

template <typename T>
__device__ __forceinline__ T ld(const void* base, size_t idx) {
    return __ldg(reinterpret_cast<const T*>(base) + idx);
}

// Floor division and modulo by a positive m, as the eager step's // and %
// (C's / and % truncate toward zero); any action, negative included,
// decodes as it does there.
__device__ __forceinline__ int floor_div(int a, int m) {
    const int q = a / m;
    return (a % m < 0) ? q - 1 : q;
}
__device__ __forceinline__ int floor_mod(int a, int m) {
    const int r = a % m;
    return r < 0 ? r + m : r;
}

// a[k] for a runtime k, by selects: a register array indexed at run time
// would be moved to local memory, once per lane.
template <typename T, int N>
__device__ __forceinline__ T pick(const T (&a)[N], int k) {
    T v = a[0];
#pragma unroll
    for (int j = 1; j < N; ++j) v = k == j ? a[j] : v;
    return v;
}

// Rows [slot, slot + rows) of the tile to rows 0 .. rows-1 of an (rows, N)
// leaf of 32-bit words (or its (N,) row), the block's nv envs from env0.
template <int EPB, int THREADS>
__device__ __forceinline__ void flush32(void* dst, const uint32_t* tile, int slot,
                                        int rows, int n, int env0, int nv) {
    uint32_t* __restrict__ d = reinterpret_cast<uint32_t*>(dst);
    for (int idx = threadIdx.x; idx < rows * EPB; idx += THREADS) {
        const int r = idx / EPB, e = idx % EPB;
        if (e < nv) d[(size_t)r * n + env0 + e] = tile[(slot + r) * EPB + e];
    }
}

template <int EPB, int THREADS>
__device__ __forceinline__ void flush8(void* dst, const uint32_t* tile, int slot,
                                       int env0, int nv) {
    uint8_t* __restrict__ d = reinterpret_cast<uint8_t*>(dst);
    for (int e = threadIdx.x; e < nv; e += THREADS) d[env0 + e] = (uint8_t)tile[slot * EPB + e];
}

template <int LANES, int CAP>
__global__ void __launch_bounds__(GroupTile<LANES>::THREADS)
step_mono_kernel(const StepConsts c, const StepPtrs p) {
    constexpr int EPB = GroupTile<LANES>::EPB;
    constexpr int THREADS = GroupTile<LANES>::THREADS;
    __shared__ uint32_t tile[LANES == 1 ? 1 : N_SLOT * EPB];
    __shared__ float obs_tile[OBS_MAX * EPB];
    const int n = c.n;
    const int env0 = blockIdx.x * EPB;
    const int nv = min(EPB, n - env0);          // envs of this block
    const int e = threadIdx.x / LANES;          // this group's env in the block
    const int i = env0 + e;
    const LaneGroup<LANES> g;
    const int E = c.E;
    const int variant = c.variant;
    const int obs_rows = variant == V_SORT ? 13 : (variant == V_PRESS ? 16 : 29);

    // ---- the event log: copied over, or zeros for an env that the fused
    // autoreset restarts; the block's slice in one pass --------------------
    {
        const int16_t* __restrict__ em = reinterpret_cast<const int16_t*>(p.in[I_EV_MAT]);
        const int16_t* __restrict__ en = reinterpret_cast<const int16_t*>(p.in[I_EV_N]);
        const int16_t* __restrict__ eq = reinterpret_cast<const int16_t*>(p.in[I_EV_Q]);
        int16_t* __restrict__ om = reinterpret_cast<int16_t*>(p.out[O_EV_MAT]);
        int16_t* __restrict__ on = reinterpret_cast<int16_t*>(p.out[O_EV_N]);
        int16_t* __restrict__ oq = reinterpret_cast<int16_t*>(p.out[O_EV_Q]);
        // THREADS is a multiple of EPB: a thread keeps one env column
        const int ee = threadIdx.x % EPB;
        if (ee < nv) {
            const int env = env0 + ee;
            const bool rs = c.autoreset && ld<int>(p.in[I_CSTEP], env) + 1 >= c.max_steps;
            for (int r = threadIdx.x / EPB; r < E; r += THREADS / EPB) {
                const size_t o = (size_t)r * n + env;
                om[o] = rs ? (int16_t)0 : __ldg(em + o);
                on[o] = rs ? (int16_t)0 : __ldg(en + o);
                oq[o] = rs ? (int16_t)0 : __ldg(eq + o);
            }
        }
    }

    // rows appended to the event log, written after the copy
    bool app[2] = {false, false};
    size_t app_o[2] = {0, 0};
    int16_t app_m[2] = {0, 0}, app_n[2] = {0, 0}, app_q[2] = {0, 0};

    if (i < n) {
        // an output word: a group stages it in its tile slot, one thread per
        // env writes it to its leaf at once (that store is coalesced as it is)
        uint32_t* const t = tile + e;           // slot s at t[s * EPB]
        auto put = [&](int leaf, int slot, int row, uint32_t v) {
            if constexpr (LANES == 1) {
                reinterpret_cast<uint32_t*>(p.out[leaf])[(size_t)row * n + i] = v;
            } else {
                t[(slot + row) * EPB] = v;
            }
        };
        float* const ob = obs_tile + e * obs_rows;

        // ---- load the state ----------------------------------------------
        int input_c[4], belt_c[4], sort_c[4], cont_t[5], cont_f[4];
        int timer[2], pmat[2], pn[2];
        float acc_belt[4], acc_sorter[4], pq[2];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            sort_c[j] = ld<int>(p.in[I_BELT], (size_t)j * n + i);      // sorter <- belt
            belt_c[j] = ld<int>(p.in[I_INPUT], (size_t)j * n + i);     // belt <- input
            acc_sorter[j] = ld<float>(p.in[I_ACC_BELT], (size_t)j * n + i);  // one-step delay
            cont_f[j] = ld<int>(p.in[I_CONT_F], (size_t)j * n + i);
        }
#pragma unroll
        for (int j = 0; j < 5; ++j) cont_t[j] = ld<int>(p.in[I_CONT_T], (size_t)j * n + i);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            timer[q] = ld<int>(p.in[I_TIMER], (size_t)q * n + i);
            pmat[q] = ld<int>(p.in[I_PMAT], (size_t)q * n + i);
            pn[q] = ld<int>(p.in[I_PN], (size_t)q * n + i);
            pq[q] = ld<float>(p.in[I_PQ], (size_t)q * n + i);
        }
        const float belt_occ = ld<float>(p.in[I_INPUT_OCC], i);
        int ev_cnt = ld<int>(p.in[I_EV_CNT], i);
        int lps = ld<uint8_t>(p.in[I_LPS], i) ? 1 : 0;
        int lpa = ld<int>(p.in[I_LPA], i);
        int gfirst = ld<int>(p.in[I_GFIRST], i);
        int gidx = ld<int>(p.in[I_GIDX], i);
        int gctr = ld<int>(p.in[I_GCTR], i);
        int cstep = ld<int>(p.in[I_CSTEP], i);
        int totin = ld<int>(p.in[I_TOTIN], i);
        const uint32_t k0 = (uint32_t)ld<int>(p.in[I_KEY], 2 * (size_t)i);
        const uint32_t k1 = (uint32_t)ld<int>(p.in[I_KEY], 2 * (size_t)i + 1);
        const int action = variant == V_RULE ? 0 : ld<int>(p.in[I_ACTION], i);

        const bool term = cstep + 1 >= c.max_steps;
        const bool reset = c.autoreset && term;

        // ---- the random words: the key chain k -> kt = split(k, 0) -> kt'
        // = split(kt, 0) feeds the sort; the input generator's 4 randint
        // words hang off split(split(k, 1), 1), the accuracy's 4 noise words
        // off split(kt, 1) -------------------------------------------------
        uint32_t kt0, kt1, s0, s1, r0, r1, z0, z1;
        tf_split(k0, k1, 0u, kt0, kt1);
        tf_split(k0, k1, 1u, s0, s1);
        tf_split(s0, s1, 1u, r0, r1);          // randint uses split(k1)[1]
        tf_split(kt0, kt1, 1u, z0, z1);        // the noise key
        {
            uint32_t a0, a1;
            tf_split(kt0, kt1, 0u, a0, a1);
            kt0 = a0;
            kt1 = a1;
        }
        uint32_t words[8];                     // 4 randint, 4 noise words
        if constexpr (LANES == 1) {
#pragma unroll
            for (int j = 0; j < 4; ++j) words[j] = tf_bits(r0, r1, (uint32_t)j);
            if (c.noise > 0.0f) {
#pragma unroll
                for (int j = 0; j < 4; ++j) words[4 + j] = tf_bits(z0, z1, (uint32_t)j);
            }
        } else {
            constexpr int R8 = (8 + LANES - 1) / LANES;
            uint32_t w[R8];
#pragma unroll
            for (int r = 0; r < R8; ++r) {
                const int q = min(g.lane + r * LANES, 7);
                w[r] = q < 4 ? tf_bits(r0, r1, (uint32_t)q) : tf_bits(z0, z1, (uint32_t)(q - 4));
            }
#pragma unroll
            for (int q = 0; q < 8; ++q) words[q] = g.get(w[q / LANES], q % LANES);
        }

        // ---- 1. input generator (fastb._generate_input) ----------------
        const bool sw = gctr >= c.steps_per_pattern;
        gidx = sw ? (gidx + 1) % 2 : gidx;
        gctr = (sw ? 0 : gctr) + 1;
        const bool row0 = (gfirst + gidx) % 2 == 0;
        const int rem = row0 ? c.rem0 : c.rem1;
#pragma unroll
        for (int j = 0; j < 4; ++j) input_c[j] = row0 ? c.units0[j] : c.units1[j];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const uint32_t m = words[j] & 3u;
#pragma unroll
            for (int q = 0; q < 4; ++q) input_c[q] += (j < rem && (int)m == q) ? 1 : 0;
        }
        const int in_sum = input_c[0] + input_c[1] + input_c[2] + input_c[3];
        const float input_occ = (float)in_sum * c.recip_100;
        totin += in_sum;

        // ---- 2. the action -----------------------------------------------
        int sort_mode, press_disc = 0, press_id = 0, mat = 0;
        if (variant == V_EXTERNAL) {
            sort_mode = floor_div(action, 11);
            press_disc = floor_mod(action, 11);
        } else if (variant == V_SORT) {
            sort_mode = action;
        } else {
            // fastb._sorting_rules on the new belt
            sort_mode = (belt_c[0] + belt_c[2] > belt_c[1] + belt_c[3]) ? 0 : 1;
            if (variant == V_PRESS) {
                press_disc = action;
            } else {
                // fastb._check_container_level on the pre-sort containers
                const int free_press = timer[0] == 0 ? 1 : (timer[1] == 0 ? 2 : 0);
                int best_idx = 0;
                int best_lvl = cont_t[0] + cont_f[0];
#pragma unroll
                for (int j = 1; j < 4; ++j) {     // first max wins (jnp.argmax)
                    const int l = cont_t[j] + cont_f[j];
                    if (l > best_lvl) { best_idx = j; best_lvl = l; }
                }
                if (cont_t[4] > best_lvl) best_idx = 4;
                best_lvl = max(best_lvl, cont_t[4]);
                const bool ok = free_press > 0 && best_lvl > 0;
                press_id = ok ? free_press : 0;
                mat = ok ? best_idx : 0;
            }
        }

        // ---- 3. accuracy (fastb._update_accuracy) ------------------------
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const float b_ac = (j == 0 || j == 2) ? c.boost : 0.0f;
            const float b_bd = (j == 1 || j == 3) ? c.boost : 0.0f;
            float a = c.base_acc[j] +
                      (sort_mode == 0 ? b_ac : (sort_mode == 1 ? b_bd : 0.0f));
            if (c.noise > 0.0f) {
                const float u01 = tf_bits_to_unit(words[4 + j]);
                a = a + fmaxf(c.noise_lo, __fmaf_rn(u01, c.noise_span, c.noise_lo));
            }
            acc_belt[j] = fminf(fmaxf(a, 0.0f), 1.0f);
        }

        // ---- 4. sort (fastb._sort_material + redistribute_u; sort_core.cuh)
        // a one-lane design runs at S = CAP exactly
        const int S = LANES > 1 ? c.support : CAP;
        const int total_input = sort_c[0] + sort_c[1] + sort_c[2] + sort_c[3];
        int lv[4], tarr[4], farr[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) lv[j] = sort_c[j];
        if constexpr (LANES == 1) {
            sort_core<CAP>(kt0, kt1, acc_sorter, lv, tarr, farr, S);
        } else {
            sort_core_lanes<LANES, CAP>(kt0, kt1, acc_sorter, lv, tarr, farr, S, g);
        }
        const int e_input = lv[0] + lv[1] + lv[2] + lv[3];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            cont_t[j] += tarr[j];
            cont_f[j] += farr[j];
        }
        cont_t[4] += e_input;
        const int true_sum = tarr[0] + tarr[1] + tarr[2] + tarr[3];
        const float purity =
            total_input > 0
                ? 1.0f - (float)(total_input - true_sum) / (float)max(total_input, 1)
                : 0.0f;

        // ---- 5. the press action -----------------------------------------
        int lvl[5];
        bool valid = true;
#pragma unroll
        for (int j = 0; j < 4; ++j) lvl[j] = cont_t[j] + cont_f[j];
        lvl[4] = cont_t[4];
        if (variant == V_EXTERNAL || variant == V_PRESS) {
            press_id = press_disc == 0 ? 0 : (press_disc <= 5 ? 1 : 2);
            // press_disc - 1 wraps at INT_MIN, as the eager step's int32 does
            mat = press_disc == 0
                      ? 0
                      : floor_mod((int)((uint32_t)press_disc - 1u), 5);
            if (!c.masked) {
                // fastb._validate_press on the post-sort state
                const bool busy = press_id == 1 ? timer[0] > 0
                                                : (press_id == 2 && timer[1] > 0);
                valid = press_id == 0 || (!busy && pick(lvl, mat) >= c.balesize);
                if (variant == V_PRESS && !valid) {
                    // sanitize: a no-op press, but the timers still tick
                    press_id = 0;
                    mat = 0;
                }
            }
        } else if (variant == V_SORT) {
            // fastb._sample_masked_press on the post-sort containers
            uint32_t sku0, sku1, nk0, nk1;
            tf_split(kt0, kt1, 1u, sku0, sku1);
            tf_split(kt0, kt1, 0u, nk0, nk1);
            kt0 = nk0;
            kt1 = nk1;
            const float u = tf_bits_to_unit(tf_bits(sku0, sku1, 0u));
            int cum[11];
            int cc = 1;
            cum[0] = 1;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
#pragma unroll
                for (int j = 0; j < 5; ++j) {
                    cc += (lvl[j] >= c.balesize && timer[q] == 0) ? 1 : 0;
                    cum[1 + 5 * q + j] = cc;
                }
            }
            const int nvalid = cc;
            const int r = min((int)(u * (float)nvalid), nvalid - 1);
            int a = 0;
#pragma unroll
            for (int j = 0; j < 11; ++j) a += cum[j] <= r ? 1 : 0;
            press_id = a == 0 ? 0 : (a <= 5 ? 1 : 2);
            mat = a == 0 ? 0 : (a - 1) % 5;
        }
        // step_mono_external unmasked: an invalid press leaves no trace, not
        // even a timer tick
        const bool gate = !(variant == V_EXTERNAL && !c.masked) || valid;

        // _check_press_status: tick, finish, append one event per finished press
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const bool busy = timer[q] > 0;
            const int t_dec = busy ? timer[q] - 1 : timer[q];
            const bool done = gate && busy && t_dec == 0;
            if (done) {
                if (!reset && ev_cnt < E) {
                    app[q] = true;
                    app_o[q] = (size_t)ev_cnt * n + i;
                    app_m[q] = (int16_t)pmat[q];
                    app_n[q] = (int16_t)pn[q];
                    app_q[q] = (int16_t)__float2int_rz(pq[q] * 100.0f);
                }
                ev_cnt += 1;
                pmat[q] = 0;
                pn[q] = 0;
                pq[q] = 0.0f;
            }
            if (gate) timer[q] = t_dec;
        }
        // _use_press(press=max(press_id, 1), m=mat, pred=press_id != 0)
        {
            const int row = press_id <= 1 ? 0 : 1;
            const bool go = gate && press_id != 0 && !((row == 0 ? timer[0] : timer[1]) > 0);
            const int total_lvl = pick(lvl, mat);    // levels before this press
            if (go) {
                const int true_m = mat < 4 ? pick(cont_t, mat) : total_lvl;
                const float quality =
                    (mat < 4 && total_lvl > 0)
                        ? (float)true_m / (float)max(total_lvl, 1)
                        : 0.0f;
                lps = 1;
                lpa = total_lvl;
#pragma unroll
                for (int j = 0; j < 5; ++j) {
                    if (j == mat) cont_t[j] = 0;
                    if (j < 4 && j == mat) cont_f[j] = 0;
                }
#pragma unroll
                for (int q = 0; q < 2; ++q) {
                    if (q == row) {
                        timer[q] = q == 0 ? c.press_time_1 : c.press_time_2;
                        pmat[q] = mat;
                        pn[q] = total_lvl;
                        pq[q] = quality;
                    }
                }
            }
        }

        // ---- 6. rewards --------------------------------------------------
        float purities[4];
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            const int tot = cont_t[j] + cont_f[j];
            purities[j] = tot > 0 ? (float)cont_t[j] / (float)max(tot, 1)
                                  : c.quality_threshold;
        }
        const float score = (((purities[0] - c.theta) + (purities[1] - c.theta)) +
                             (purities[2] - c.theta)) +
                            (purities[3] - c.theta);
        const float raw_sort = score * c.sort_scale;   // tanh by the caller

        bool catastrophic = false, over95 = false, over90 = false;
        int lv_sum = 0;
#pragma unroll
        for (int j = 0; j < 5; ++j) {
            lvl[j] = j < 4 ? cont_t[j] + cont_f[j] : cont_t[4];
            const float f = (float)lvl[j] * c.recip_cap;
            catastrophic |= f > 1.0f;
            over95 |= f > 0.95f;
            over90 |= f > 0.90f;
            lv_sum += lvl[j];
        }
        const float max_penalty = over95 ? c.pen_severe : (over90 ? c.pen_mild : 0.0f);
        const int bs = c.balesize;
        const int num_bales = lpa / bs;
        const int rem_b = lpa % bs;
        const float dist = (float)min(rem_b, bs - rem_b);
        const float efficiency = __fmaf_rn(-dist, c.dist_scale, 1.0f);
        const int w = min(num_bales, 3);
        const float peak = w == 0 ? 0.0f : (w == 1 ? c.third : (w == 2 ? c.two_thirds : 1.0f));
        const float action_reward =
            lps ? __fmaf_rn(efficiency, c.bale_eff, peak - c.bale_eff) : 0.0f;
        const float normal = fminf(
            fmaxf(__fmaf_rn((float)lv_sum, c.state_scale, action_reward), -1.0f),
            1.0f);
        const float press_reward =
            catastrophic ? c.pen_catastrophic : (max_penalty < 0.0f ? max_penalty : normal);
        const bool early = catastrophic || max_penalty < 0.0f;
        if (variant != V_SORT && !early) {
            // fastb.step_sort never calls _press_reward and carries these over
            lps = 0;
            lpa = 0;
        }

        // ---- 7. observations (batch-first rows of obs_rows floats) -------
        {
            int o = 0;
            if (variant != V_PRESS) {
                const int bt = belt_c[0] + belt_c[1] + belt_c[2] + belt_c[3];
                ob[o++] = fminf(fmaxf(belt_occ, -1.0f), 1.0f);
#pragma unroll
                for (int j = 0; j < 4; ++j) {
                    const float pr = bt > 0 ? (float)belt_c[j] / (float)max(bt, 1) : 0.0f;
                    ob[o++] = fminf(fmaxf(pr, -1.0f), 1.0f);
                }
#pragma unroll
                for (int j = 0; j < 4; ++j) ob[o++] = fminf(fmaxf(acc_belt[j], -1.0f), 1.0f);
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    ob[o++] = fminf(fmaxf(purities[j] - c.quality_threshold, -1.0f), 1.0f);
            }
            if (variant != V_SORT) {
#pragma unroll
                for (int r = 0; r < 2; ++r) {
#pragma unroll
                    for (int j = 0; j < 5; ++j)
                        ob[o++] = fminf(fmaxf((float)lvl[j] * c.recip_cap, 0.0f), 1.0f);
                }
#pragma unroll
                for (int j = 0; j < 4; ++j)
                    ob[o++] = fminf(fmaxf((float)sort_c[j] * c.recip_stage, 0.0f), 1.0f);
                ob[o++] = fminf(fmaxf((float)timer[0] * c.recip_pt1, 0.0f), 1.0f);
                ob[o++] = fminf(fmaxf((float)timer[1] * c.recip_pt2, 0.0f), 1.0f);
            }
        }

        // ---- 8. finish -----------------------------------------------------
        cstep += 1;
        const int a_out = variant == V_RULE
                              ? sort_mode * 11 + (press_id == 0 ? 0 : (press_id - 1) * 5 + mat + 1)
                              : action;
        put(O_RAW_SORT, S_RAW_SORT, 0, __float_as_uint(raw_sort));
        put(O_PRESS_REWARD, S_PRESS_REWARD, 0, __float_as_uint(press_reward));
        put(O_PURITY, S_PURITY, 0, __float_as_uint(purity));
        put(O_ACTION, S_ACTION, 0, (uint32_t)a_out);

        // ---- 9. fused autoreset (fastb.with_autoreset / _reset_from_keys) -
        float input_occ_out = input_occ, belt_occ_out = belt_occ;
        if (reset) {
            uint32_t f0, f1, b0, b1;
            tf_split(kt0, kt1, 0u, f0, f1);
            tf_split(kt0, kt1, 1u, b0, b1);
            gfirst = tf_bits_to_unit(tf_bits(b0, b1, 0u)) < 0.5f ? 1 : 0;
            kt0 = f0;
            kt1 = f1;
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                input_c[j] = belt_c[j] = sort_c[j] = 0;
                cont_f[j] = 0;
                acc_belt[j] = acc_sorter[j] = c.base_acc[j];
            }
#pragma unroll
            for (int j = 0; j < 5; ++j) cont_t[j] = 0;
#pragma unroll
            for (int q = 0; q < 2; ++q) {
                timer[q] = pmat[q] = pn[q] = 0;
                pq[q] = 0.0f;
            }
            sort_mode = 0;
            input_occ_out = belt_occ_out = 0.0f;
            ev_cnt = lps = lpa = gidx = gctr = cstep = totin = 0;
        }

        // ---- write (or stage) the state ---------------------------------
#pragma unroll
        for (int j = 0; j < 4; ++j) {
            put(O_INPUT, S_INPUT, j, (uint32_t)input_c[j]);
            put(O_BELT, S_BELT, j, (uint32_t)belt_c[j]);
            put(O_SORT, S_SORT, j, (uint32_t)sort_c[j]);
            put(O_ACC_BELT, S_ACC_BELT, j, __float_as_uint(acc_belt[j]));
            put(O_ACC_SORTER, S_ACC_SORTER, j, __float_as_uint(acc_sorter[j]));
            put(O_CONT_F, S_CONT_F, j, (uint32_t)cont_f[j]);
        }
#pragma unroll
        for (int j = 0; j < 5; ++j) put(O_CONT_T, S_CONT_T, j, (uint32_t)cont_t[j]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            put(O_TIMER, S_TIMER, q, (uint32_t)timer[q]);
            put(O_PMAT, S_PMAT, q, (uint32_t)pmat[q]);
            put(O_PN, S_PN, q, (uint32_t)pn[q]);
            put(O_PQ, S_PQ, q, __float_as_uint(pq[q]));
        }
        put(O_SENSOR, S_SENSOR, 0, (uint32_t)sort_mode);
        put(O_INPUT_OCC, S_INPUT_OCC, 0, __float_as_uint(input_occ_out));
        put(O_BELT_OCC, S_BELT_OCC, 0, __float_as_uint(belt_occ_out));
        put(O_EV_CNT, S_EV_CNT, 0, (uint32_t)ev_cnt);
        put(O_LPA, S_LPA, 0, (uint32_t)lpa);
        put(O_GFIRST, S_GFIRST, 0, (uint32_t)gfirst);
        put(O_GIDX, S_GIDX, 0, (uint32_t)gidx);
        put(O_GCTR, S_GCTR, 0, (uint32_t)gctr);
        put(O_CSTEP, S_CSTEP, 0, (uint32_t)cstep);
        put(O_TOTIN, S_TOTIN, 0, (uint32_t)totin);
        if constexpr (LANES == 1) {
            reinterpret_cast<uint8_t*>(p.out[O_LPS])[i] = (uint8_t)lps;
            reinterpret_cast<uint8_t*>(p.out[O_TERM])[i] = term ? 1 : 0;
            reinterpret_cast<uint32_t*>(p.out[O_KEY])[2 * (size_t)i] = kt0;
            reinterpret_cast<uint32_t*>(p.out[O_KEY])[2 * (size_t)i + 1] = kt1;
        } else {
            t[S_LPS * EPB] = (uint32_t)lps;
            t[S_TERM * EPB] = term ? 1u : 0u;
            t[S_KEY * EPB] = kt0;
            t[(S_KEY + 1) * EPB] = kt1;
        }
    }
    __syncthreads();

    // ---- write: the appended event rows, the staged tile, the obs --------
    if (i < n && g.lane == 0) {
        int16_t* __restrict__ om = reinterpret_cast<int16_t*>(p.out[O_EV_MAT]);
        int16_t* __restrict__ on = reinterpret_cast<int16_t*>(p.out[O_EV_N]);
        int16_t* __restrict__ oq = reinterpret_cast<int16_t*>(p.out[O_EV_Q]);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            if (app[q]) {
                om[app_o[q]] = app_m[q];
                on[app_o[q]] = app_n[q];
                oq[app_o[q]] = app_q[q];
            }
        }
    }
    if constexpr (LANES > 1) {
#define FLUSH(leaf, slot, rows) \
    flush32<EPB, THREADS>(p.out[leaf], tile, slot, rows, n, env0, nv)
        FLUSH(O_INPUT, S_INPUT, 4);
        FLUSH(O_BELT, S_BELT, 4);
        FLUSH(O_SORT, S_SORT, 4);
        FLUSH(O_ACC_BELT, S_ACC_BELT, 4);
        FLUSH(O_ACC_SORTER, S_ACC_SORTER, 4);
        FLUSH(O_CONT_F, S_CONT_F, 4);
        FLUSH(O_CONT_T, S_CONT_T, 5);
        FLUSH(O_TIMER, S_TIMER, 2);
        FLUSH(O_PMAT, S_PMAT, 2);
        FLUSH(O_PN, S_PN, 2);
        FLUSH(O_PQ, S_PQ, 2);
        FLUSH(O_SENSOR, S_SENSOR, 1);
        FLUSH(O_INPUT_OCC, S_INPUT_OCC, 1);
        FLUSH(O_BELT_OCC, S_BELT_OCC, 1);
        FLUSH(O_EV_CNT, S_EV_CNT, 1);
        FLUSH(O_LPA, S_LPA, 1);
        FLUSH(O_GFIRST, S_GFIRST, 1);
        FLUSH(O_GIDX, S_GIDX, 1);
        FLUSH(O_GCTR, S_GCTR, 1);
        FLUSH(O_CSTEP, S_CSTEP, 1);
        FLUSH(O_TOTIN, S_TOTIN, 1);
        FLUSH(O_RAW_SORT, S_RAW_SORT, 1);
        FLUSH(O_PRESS_REWARD, S_PRESS_REWARD, 1);
        FLUSH(O_PURITY, S_PURITY, 1);
        FLUSH(O_ACTION, S_ACTION, 1);
#undef FLUSH
        flush8<EPB, THREADS>(p.out[O_LPS], tile, S_LPS, env0, nv);
        flush8<EPB, THREADS>(p.out[O_TERM], tile, S_TERM, env0, nv);
        uint32_t* __restrict__ key = reinterpret_cast<uint32_t*>(p.out[O_KEY]) + 2 * (size_t)env0;
        for (int idx = threadIdx.x; idx < 2 * nv; idx += THREADS)
            key[idx] = tile[(S_KEY + (idx & 1)) * EPB + (idx >> 1)];
    }
    float* __restrict__ obs = reinterpret_cast<float*>(p.out[O_OBS]) + (size_t)env0 * obs_rows;
    for (int idx = threadIdx.x; idx < nv * obs_rows; idx += THREADS) obs[idx] = obs_tile[idx];
}

// The designs, (LANES, CAP) pairs: CAP is the largest support the design
// covers (the groups at caps 64 and 128 cover supports 33-104), and a
// one-lane design covers its cap alone.  Those ops/step_cuda.py's table
// picks, mirrored by ops/step_cuda.py::STEP_DESIGNS (checked through
// step_mono_designs()).
#define STEP_DESIGNS(X) X(1, 16) X(8, 16) X(16, 16) X(8, 32) X(16, 32) X(8, 64) \
    X(16, 64) X(16, 128)

extern "C" {

int step_mono_consts_size() { return (int)sizeof(StepConsts); }

int step_mono_n_ptrs() { return N_IN * 100 + N_OUT; }

// Writes the designs as lanes0, cap0, lanes1, cap1, ... into out (room for
// max pairs); returns their number.
int step_mono_designs(int* out, int max) {
    int k = 0;
#define X(L, C) if (k < max) { out[2 * k] = L; out[2 * k + 1] = C; } ++k;
    STEP_DESIGNS(X)
#undef X
    return k;
}

// Launch one step with design (lanes, cap) on `stream`.  Returns the
// cudaError_t of the launch; cudaErrorInvalidValue for a design that is not
// built or does not cover the config's support (a one-lane design covers its
// cap alone).
int step_mono_launch(const StepConsts* consts, void* const* in_ptrs,
                     void* const* out_ptrs, int lanes, int cap, void* stream) {
    StepPtrs p;
    for (int k = 0; k < N_IN; ++k) p.in[k] = in_ptrs[k];
    for (int k = 0; k < N_OUT; ++k) p.out[k] = out_ptrs[k];
    const int n = consts->n;
    const int sup = consts->support;
    if (n < 1 || sup < 1 || sup > cap || (lanes == 1 && sup != cap))
        return (int)cudaErrorInvalidValue;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
#define X(L, C)                                                                  \
    if (lanes == L && cap == C) {                                                \
        constexpr int epb = GroupTile<L>::EPB;                                   \
        step_mono_kernel<L, C><<<(n + epb - 1) / epb, GroupTile<L>::THREADS, 0, s>>>( \
            *consts, p);                                                         \
        return (int)cudaGetLastError();                                          \
    }
    STEP_DESIGNS(X)
#undef X
    return (int)cudaErrorInvalidValue;
}

}  // extern "C"
