// The whole fastb env step, one thread per env: CUDA C++ for sm_90a.
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
// 1.1 us at 3.35 TB/s, well under the launch latency.  The arithmetic is
// about 4e3 integer operations (51 threefry blocks) and 5e3 f32 operations
// (12 sampler draws) per env, about 1.2 us of the card's peak rates at
// 4096 envs.  In practice one thread per env runs its whole chain serially,
// so the kernel is bound by that chain's latency, not by either peak.  The
// design keeps every env's state in registers for the whole step (one read
// and one write of each leaf), makes every access coalesced over the env
// axis (the last axis of every (rows, N) leaf), and keeps the sampler's
// support-wide arrays in registers by making the support a template
// parameter (16 at the default config).
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

#define IN(T, k) (reinterpret_cast<const T*>(p.in[k]))
#define OUT(T, k) (reinterpret_cast<T*>(p.out[k]))

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

template <int CAP>
__global__ void __launch_bounds__(128)
step_mono_kernel(const StepConsts c, const StepPtrs p) {
    const int i = blockIdx.x * blockDim.x + threadIdx.x;
    const int n = c.n;
    if (i >= n) return;
    const int S = CAP == 104 ? c.support : CAP;
    const int variant = c.variant;

    // ---- load the state ------------------------------------------------
    int input_c[4], belt_c[4], sort_c[4], cont_t[5], cont_f[4];
    int timer[2], pmat[2], pn[2];
    float acc_belt[4], acc_sorter[4], pq[2];
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        sort_c[j] = IN(int, I_BELT)[j * n + i];     // sorter <- belt
        belt_c[j] = IN(int, I_INPUT)[j * n + i];    // belt <- input
        acc_sorter[j] = IN(float, I_ACC_BELT)[j * n + i];  // one-step delay
        cont_f[j] = IN(int, I_CONT_F)[j * n + i];
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) cont_t[j] = IN(int, I_CONT_T)[j * n + i];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        timer[q] = IN(int, I_TIMER)[q * n + i];
        pmat[q] = IN(int, I_PMAT)[q * n + i];
        pn[q] = IN(int, I_PN)[q * n + i];
        pq[q] = IN(float, I_PQ)[q * n + i];
    }
    const float belt_occ = IN(float, I_INPUT_OCC)[i];
    int ev_cnt = IN(int, I_EV_CNT)[i];
    int lps = IN(uint8_t, I_LPS)[i] ? 1 : 0;
    int lpa = IN(int, I_LPA)[i];
    int gfirst = IN(int, I_GFIRST)[i];
    int gidx = IN(int, I_GIDX)[i];
    int gctr = IN(int, I_GCTR)[i];
    int cstep = IN(int, I_CSTEP)[i];
    int totin = IN(int, I_TOTIN)[i];
    uint32_t k0 = (uint32_t)IN(int, I_KEY)[2 * i];
    uint32_t k1 = (uint32_t)IN(int, I_KEY)[2 * i + 1];
    const int action = variant == V_RULE ? 0 : IN(int, I_ACTION)[i];

    // Whether this env terminates is known up front; with the fused
    // autoreset its event log is written as zeros, else copied over.
    const int E = c.E;
    const bool term = cstep + 1 >= c.max_steps;
    const bool reset = c.autoreset && term;
    {
        const int16_t* em = IN(int16_t, I_EV_MAT);
        const int16_t* en = IN(int16_t, I_EV_N);
        const int16_t* eq = IN(int16_t, I_EV_Q);
        int16_t* om = OUT(int16_t, O_EV_MAT);
        int16_t* on = OUT(int16_t, O_EV_N);
        int16_t* oq = OUT(int16_t, O_EV_Q);
        for (int e = 0; e < E; ++e) {
            const size_t o = (size_t)e * n + i;
            om[o] = reset ? (int16_t)0 : em[o];
            on[o] = reset ? (int16_t)0 : en[o];
            oq[o] = reset ? (int16_t)0 : eq[o];
        }
    }

    // ---- 1. input generator (fastb._generate_input) --------------------
    const bool sw = gctr >= c.steps_per_pattern;
    gidx = sw ? (gidx + 1) % 2 : gidx;
    gctr = (sw ? 0 : gctr) + 1;
    const bool row0 = (gfirst + gidx) % 2 == 0;
    const int rem = row0 ? c.rem0 : c.rem1;
#pragma unroll
    for (int j = 0; j < 4; ++j) input_c[j] = row0 ? c.units0[j] : c.units1[j];
    uint32_t kt0, kt1, s0, s1, r0, r1;
    tf_split(k0, k1, 0u, kt0, kt1);
    tf_split(k0, k1, 1u, s0, s1);
    tf_split(s0, s1, 1u, r0, r1);          // randint uses split(k1)[1]
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const uint32_t m = tf_bits(r0, r1, (uint32_t)j) & 3u;
        if (j < rem) input_c[m] += 1;
    }
    const int in_sum = input_c[0] + input_c[1] + input_c[2] + input_c[3];
    const float input_occ = (float)in_sum * c.recip_100;
    totin += in_sum;

    // ---- 2. the action ---------------------------------------------------
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

    // ---- 3. accuracy (fastb._update_accuracy) ----------------------------
    tf_split(kt0, kt1, 1u, s0, s1);
    {
        uint32_t a0, a1;
        tf_split(kt0, kt1, 0u, a0, a1);
        kt0 = a0;
        kt1 = a1;
    }
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        const float b_ac = (j == 0 || j == 2) ? c.boost : 0.0f;
        const float b_bd = (j == 1 || j == 3) ? c.boost : 0.0f;
        float a = c.base_acc[j] +
                  (sort_mode == 0 ? b_ac : (sort_mode == 1 ? b_bd : 0.0f));
        if (c.noise > 0.0f) {
            const float u01 = tf_bits_to_unit(tf_bits(s0, s1, (uint32_t)j));
            a = a + fmaxf(c.noise_lo, __fmaf_rn(u01, c.noise_span, c.noise_lo));
        }
        acc_belt[j] = fminf(fmaxf(a, 0.0f), 1.0f);
    }

    // ---- 4. sort (fastb._sort_material + redistribute_u; sort_core.cuh) --
    const int total_input = sort_c[0] + sort_c[1] + sort_c[2] + sort_c[3];
    int lv[4], tarr[4], farr[4];
#pragma unroll
    for (int j = 0; j < 4; ++j) lv[j] = sort_c[j];
    sort_core<CAP>(kt0, kt1, acc_sorter, lv, tarr, farr, S);
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

    // ---- 5. the press action ---------------------------------------------
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
            valid = press_id == 0 || (!busy && lvl[mat] >= c.balesize);
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
        const int nv = cc;
        const int r = min((int)(u * (float)nv), nv - 1);
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
    {
        int16_t* om = OUT(int16_t, O_EV_MAT);
        int16_t* on = OUT(int16_t, O_EV_N);
        int16_t* oq = OUT(int16_t, O_EV_Q);
#pragma unroll
        for (int q = 0; q < 2; ++q) {
            const bool busy = timer[q] > 0;
            const int t_dec = busy ? timer[q] - 1 : timer[q];
            const bool done = gate && busy && t_dec == 0;
            if (done) {
                if (!reset && ev_cnt < E) {
                    const size_t o = (size_t)ev_cnt * n + i;
                    om[o] = (int16_t)pmat[q];
                    on[o] = (int16_t)pn[q];
                    oq[o] = (int16_t)__float2int_rz(pq[q] * 100.0f);
                }
                ev_cnt += 1;
                pmat[q] = 0;
                pn[q] = 0;
                pq[q] = 0.0f;
            }
            if (gate) timer[q] = t_dec;
        }
    }
    // _use_press(press=max(press_id, 1), m=mat, pred=press_id != 0)
    {
        const int row = press_id <= 1 ? 0 : 1;
        const bool go = gate && press_id != 0 && !(timer[row] > 0);
        const int total_lvl = lvl[mat];    // levels before this press
        if (go) {
            const int true_m = mat < 4 ? cont_t[mat] : total_lvl;
            const float quality =
                (mat < 4 && total_lvl > 0)
                    ? (float)true_m / (float)max(total_lvl, 1)
                    : 0.0f;
            lps = 1;
            lpa = total_lvl;
            cont_t[mat] = 0;
            if (mat < 4) cont_f[mat] = 0;
            timer[row] = row == 0 ? c.press_time_1 : c.press_time_2;
            pmat[row] = mat;
            pn[row] = total_lvl;
            pq[row] = quality;
        }
    }

    // ---- 6. rewards ------------------------------------------------------
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

    // ---- 7. observations (batch-first rows of obs_rows floats) -----------
    {
        const int rows = variant == V_SORT ? 13 : (variant == V_PRESS ? 16 : 29);
        float* obs = OUT(float, O_OBS) + (size_t)i * rows;
        int o = 0;
        if (variant != V_PRESS) {
            const int bt = belt_c[0] + belt_c[1] + belt_c[2] + belt_c[3];
            obs[o++] = fminf(fmaxf(belt_occ, -1.0f), 1.0f);
#pragma unroll
            for (int j = 0; j < 4; ++j) {
                const float pr = bt > 0 ? (float)belt_c[j] / (float)max(bt, 1) : 0.0f;
                obs[o++] = fminf(fmaxf(pr, -1.0f), 1.0f);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j) obs[o++] = fminf(fmaxf(acc_belt[j], -1.0f), 1.0f);
#pragma unroll
            for (int j = 0; j < 4; ++j)
                obs[o++] = fminf(fmaxf(purities[j] - c.quality_threshold, -1.0f), 1.0f);
        }
        if (variant != V_SORT) {
#pragma unroll
            for (int r = 0; r < 2; ++r) {
#pragma unroll
                for (int j = 0; j < 5; ++j)
                    obs[o++] = fminf(fmaxf((float)lvl[j] * c.recip_cap, 0.0f), 1.0f);
            }
#pragma unroll
            for (int j = 0; j < 4; ++j)
                obs[o++] = fminf(fmaxf((float)sort_c[j] * c.recip_stage, 0.0f), 1.0f);
            obs[o++] = fminf(fmaxf((float)timer[0] * c.recip_pt1, 0.0f), 1.0f);
            obs[o++] = fminf(fmaxf((float)timer[1] * c.recip_pt2, 0.0f), 1.0f);
        }
    }

    // ---- 8. finish ---------------------------------------------------------
    cstep += 1;
    const int a_out = variant == V_RULE
                          ? sort_mode * 11 + (press_id == 0 ? 0 : (press_id - 1) * 5 + mat + 1)
                          : action;
    OUT(float, O_RAW_SORT)[i] = raw_sort;
    OUT(float, O_PRESS_REWARD)[i] = press_reward;
    OUT(float, O_PURITY)[i] = purity;
    OUT(int, O_ACTION)[i] = a_out;
    OUT(uint8_t, O_TERM)[i] = term ? 1 : 0;

    // ---- 9. fused autoreset (fastb.with_autoreset / _reset_from_keys) ----
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

    // ---- write the state -------------------------------------------------
#pragma unroll
    for (int j = 0; j < 4; ++j) {
        OUT(int, O_INPUT)[j * n + i] = input_c[j];
        OUT(int, O_BELT)[j * n + i] = belt_c[j];
        OUT(int, O_SORT)[j * n + i] = sort_c[j];
        OUT(float, O_ACC_BELT)[j * n + i] = acc_belt[j];
        OUT(float, O_ACC_SORTER)[j * n + i] = acc_sorter[j];
        OUT(int, O_CONT_F)[j * n + i] = cont_f[j];
    }
#pragma unroll
    for (int j = 0; j < 5; ++j) OUT(int, O_CONT_T)[j * n + i] = cont_t[j];
#pragma unroll
    for (int q = 0; q < 2; ++q) {
        OUT(int, O_TIMER)[q * n + i] = timer[q];
        OUT(int, O_PMAT)[q * n + i] = pmat[q];
        OUT(int, O_PN)[q * n + i] = pn[q];
        OUT(float, O_PQ)[q * n + i] = pq[q];
    }
    OUT(int, O_SENSOR)[i] = sort_mode;
    OUT(float, O_INPUT_OCC)[i] = input_occ_out;
    OUT(float, O_BELT_OCC)[i] = belt_occ_out;
    OUT(int, O_EV_CNT)[i] = ev_cnt;
    OUT(uint8_t, O_LPS)[i] = (uint8_t)lps;
    OUT(int, O_LPA)[i] = lpa;
    OUT(int, O_GFIRST)[i] = gfirst;
    OUT(int, O_GIDX)[i] = gidx;
    OUT(int, O_GCTR)[i] = gctr;
    OUT(int, O_CSTEP)[i] = cstep;
    OUT(int, O_TOTIN)[i] = totin;
    OUT(int, O_KEY)[2 * i] = (int)kt0;
    OUT(int, O_KEY)[2 * i + 1] = (int)kt1;
}

extern "C" {

int step_mono_consts_size() { return (int)sizeof(StepConsts); }

int step_mono_n_ptrs() { return N_IN * 100 + N_OUT; }

// Launch one step on `stream`.  Returns the cudaError_t of the launch.
int step_mono_launch(const StepConsts* consts, void* const* in_ptrs,
                     void* const* out_ptrs, void* stream) {
    StepPtrs p;
    for (int k = 0; k < N_IN; ++k) p.in[k] = in_ptrs[k];
    for (int k = 0; k < N_OUT; ++k) p.out[k] = out_ptrs[k];
    const int threads = 128;
    const int blocks = (consts->n + threads - 1) / threads;
    cudaStream_t s = reinterpret_cast<cudaStream_t>(stream);
    if (consts->support == 16) {
        step_mono_kernel<16><<<blocks, threads, 0, s>>>(*consts, p);
    } else if (consts->support <= 104) {
        step_mono_kernel<104><<<blocks, threads, 0, s>>>(*consts, p);
    } else {
        return (int)cudaErrorInvalidValue;
    }
    return (int)cudaGetLastError();
}

}  // extern "C"
