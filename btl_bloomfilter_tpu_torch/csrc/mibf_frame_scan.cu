// MIBF classification, pass C: the sequential per-read state of the
// query engine, computed as per-read prefix scans.
//
// For every read r, in frame order t and slot order i, with the per-slot
// running counts c6[r, t, i, 0..5] (count, nonSat, total, totalNonSat,
// nonSatFrame, solid) precomputed by passes A and B, the reference walks
//   ok = consider & active
//        & (count >= min_count | has_cand & count >= best[count])
// and a promoted slot raises best[] column by column and the second-best
// nonSatFrame count; after each frame the saturated-frame and evaluated
// counts advance and the extra-frame early exit (compareStdErr) may stop
// the read. Outputs ok [R, W, h] and active [R, W] (what the scan emits),
// and each read's final best [R, 6], sat_count and eval_count.
//
// Replaces: the lax.scan `cstep` of query_frames_batch in
// btl_bloomfilter_tpu/models/mibf_query.py (pass C). It has no Pallas twin:
// on the TPU it is an XLA scan. frame_scan_plain (kernels/mibf_frame_scan.py)
// is that walk, step by step, and the reference for this kernel.
//
// The chain has no serial dependence that a scan cannot carry. With cv =
// consider & valid, for one read's slots in (frame, slot) order:
//  1. The first promoted slot f is the first cv slot with count >=
//     min_count: before it has_cand is false, so nothing is promoted.
//  2. From f on every cv slot that is not promoted has count below the
//     running best[count], so best[count] before slot s is
//     M_s = max(0, max count over cv slots in [f, s)), and
//     ok_s = cv_s & (count_s >= min_s | s > f & count_s >= M_s).
//     Here (found, M, max) is carried by one associative combine.
//  3. best[col] is max(0, max over ok slots so far). With P_s =
//     best[nonSatFrame] before slot s (an ok-masked exclusive prefix max),
//     second is the running max of nonSatFrame over ok slots with
//     nonSatFrame <= P_s, from 0.
//  4. Per frame t, from the frame-end best and second: reset_t =
//     compareStdErr(best[totalNonSat], second), leading_t = best[nonSatFrame]
//     > second. extra is a segmented count of valid & leading frames,
//     restarted at each valid & reset frame; the stop frame T is the first
//     valid & leading frame whose count before it (after the reset) passes
//     extra_frame_limit.
//  5. Stopping only masks what comes after T: ok and active are false past
//     T, best is its value at T, sat_count and eval_count sum frames <= T.
// The counts may be any int32: every maximum starts at 0, as best and
// second do in the reference, so negative values compare as they do there.
//
// compareStdErr is float32 with IEEE sqrtf, as the JAX engine computes it;
// the build uses no fast-math flag, and the comparison has no product that
// could contract into an FMA. The counts are exact in float32 where the
// reference's are, so the result is the reference's bit for bit.
//
// What bounds it on the H100: at best the bytes (c6 is 24 of the 30 bytes
// a slot moves). A thread per read (the first design)
// left 8 of 132 SMs working at the bench batch of 256 reads and walked
// 8072 dependent steps. Design: one block of 256 threads per read, all
// blocks resident at once; the block walks the read in chunks of 256
// frames, a thread per frame. A thread folds its frame's h slots serially
// and the block combines the 256 frame values with warp-shuffle scans and
// one shared-memory pass over the 8 warp totals, five scans a chunk in the
// order of the identities; the carries (found, M, P, best[totalNonSat],
// second, extra) go from chunk to chunk. A warp's 32 threads read 32
// consecutive frames, so every sector a warp loads is used in full. The
// first chunk that holds a stop writes its frames, the block writes false
// for the rest of the read and ends. What bounds it at the bench batch is
// that chain of dependent block scans, two blocks an SM, not the bytes:
// neither keeping a frame's slots in registers with an L2 prefetch of the
// next chunk nor staging c6 through shared memory to load it coalesced
// made it faster (PERF.md).

#include <climits>

#include "common.cuh"

#define BTL_COUNT 0
#define BTL_TOTALNONSAT 3
#define BTL_NONSATFRAME 4
#define BTL_WARPS (BTL_BLOCK / 32)

__device__ __forceinline__ bool compare_std_err(int a, int b) {
    const float af = (float)a, bf = (float)b;
    const float sa = sqrtf(af), sb = sqrtf(bf);
    return af > bf ? (af - sa) <= (bf + sb) : (bf - sb) <= (af + sa);
}

template <int N>
struct Vals {
    int v[N];
};

// The promotion state of a run of slots: v[0] holds a promotable slot
// (cv & count >= min_count); v[1] = max(0, max count over cv slots from
// the first such slot on); v[2] = max(0, max count over all cv slots).
struct PromoteOp {
    __device__ Vals<3> operator()(const Vals<3>& a, const Vals<3>& b) const {
        return {{a.v[0] | b.v[0], a.v[0] ? max(a.v[1], b.v[2]) : b.v[1],
                 max(a.v[2], b.v[2])}};
    }
};

template <int N>
struct MaxOp {
    __device__ Vals<N> operator()(const Vals<N>& a, const Vals<N>& b) const {
        Vals<N> r;
#pragma unroll
        for (int i = 0; i < N; ++i) r.v[i] = max(a.v[i], b.v[i]);
        return r;
    }
};

// (restart flag, count): a run's count since its last restart
struct SegSumOp {
    __device__ Vals<2> operator()(const Vals<2>& a, const Vals<2>& b) const {
        return {{a.v[0] | b.v[0], b.v[0] ? b.v[1] : a.v[1] + b.v[1]}};
    }
};

// the read's totals: best[6] by max, sat and eval counts by (wrapping) sum
struct TotalsOp {
    __device__ Vals<8> operator()(const Vals<8>& a, const Vals<8>& b) const {
        Vals<8> r;
#pragma unroll
        for (int i = 0; i < 6; ++i) r.v[i] = max(a.v[i], b.v[i]);
#pragma unroll
        for (int i = 6; i < 8; ++i)
            r.v[i] = (int)((unsigned)a.v[i] + (unsigned)b.v[i]);
        return r;
    }
};

// Block-wide scan of one value a thread (thread order), identity 0 in every
// field for all the ops above: the exclusive and inclusive prefixes and the
// total. `sm` is this call site's own buffer of one value a warp: its next
// use comes after another call site's barrier, so one barrier a scan does.
template <int N, class Op>
__device__ __forceinline__ void block_scan(Vals<N> x, Op op, Vals<N>* sm,
                                           Vals<N>& excl, Vals<N>& incl,
                                           Vals<N>& total) {
    const int lane = threadIdx.x & 31, warp = threadIdx.x >> 5;
#pragma unroll
    for (int o = 1; o < 32; o <<= 1) {
        Vals<N> y;
#pragma unroll
        for (int i = 0; i < N; ++i) y.v[i] = __shfl_up_sync(0xFFFFFFFFu, x.v[i], o);
        if (lane >= o) x = op(y, x);
    }
    Vals<N> wex;
#pragma unroll
    for (int i = 0; i < N; ++i) {
        wex.v[i] = __shfl_up_sync(0xFFFFFFFFu, x.v[i], 1);
        if (lane == 0) wex.v[i] = 0;
    }
    if (lane == 31) sm[warp] = x;
    __syncthreads();
    Vals<N> pre = {}, all = {};
#pragma unroll
    for (int w = 0; w < BTL_WARPS; ++w) {
        if (w == warp) pre = all;
        all = op(all, sm[w]);
    }
    excl = op(pre, wex);
    incl = op(pre, x);
    total = all;
}

// one slot's promotion element
__device__ __forceinline__ Vals<3> slot_elem(bool cv, int cnt, int mc) {
    const bool p = cv && cnt >= mc;
    return {{p, p ? max(cnt, 0) : 0, cv ? cnt : 0}};
}

__global__ void __launch_bounds__(BTL_BLOCK)
mibf_frame_scan_kernel(const int32_t* __restrict__ c6,
                       const bool* __restrict__ consider,
                       const int32_t* __restrict__ min_count,
                       const bool* __restrict__ valid,
                       const bool* __restrict__ frame_sat,
                       const bool* __restrict__ frame_eval,
                       const int32_t* __restrict__ hitsum, int W, int h,
                       int extra_frame_limit, bool* __restrict__ ok_out,
                       bool* __restrict__ active_out,
                       int32_t* __restrict__ best_out,
                       int32_t* __restrict__ satc_out,
                       int32_t* __restrict__ evalc_out) {
    __shared__ Vals<3> sm_promote[BTL_WARPS];
    __shared__ Vals<2> sm_best[BTL_WARPS];
    __shared__ Vals<1> sm_second[BTL_WARPS];
    __shared__ Vals<2> sm_extra[BTL_WARPS];
    __shared__ Vals<1> sm_stop[BTL_WARPS];
    __shared__ Vals<8> sm_totals[BTL_WARPS];

    const long long r = blockIdx.x;
    const long long frame0 = r * W;
    // carries from the chunks before
    Vals<3> promote_c = {};
    int best_nsf_c = 0, best_tns_c = 0, second_c = 0, extra_c = 0;
    // this thread's frames up to the stop: best[6], sat and eval counts
    Vals<8> mine = {};
    int rest = W;                  // first frame left unwritten by a stop

    for (int c0 = 0; c0 < W; c0 += BTL_BLOCK) {
        const int t = c0 + threadIdx.x;
        const bool in = t < W;
        const long long f = frame0 + t;
        const bool v = in && valid[f];
        const long long s0 = f * h;

        // identities 1-2: the promotion state before this frame
        Vals<3> loc = {};
        if (v) {
            for (int i = 0; i < h; ++i)
                loc = PromoteOp()(loc, slot_elem(consider[s0 + i],
                                                 c6[(s0 + i) * 6 + BTL_COUNT],
                                                 min_count[s0 + i]));
        }
        Vals<3> ex, inc, tot;
        block_scan(loc, PromoteOp(), sm_promote, ex, inc, tot);
        const Vals<3> pre = PromoteOp()(promote_c, ex);

        // this frame's ok slots, from the state before each one
        auto each_ok = [&](auto&& body) {
            Vals<3> st = pre;
            for (int i = 0; i < h; ++i) {
                const bool cv = v && consider[s0 + i];
                const int cnt = c6[(s0 + i) * 6 + BTL_COUNT];
                const int mc = min_count[s0 + i];
                body(i, cv && (cnt >= mc || (st.v[0] && cnt >= st.v[1])));
                st = PromoteOp()(st, slot_elem(cv, cnt, mc));
            }
        };

        // identity 3: best[nonSatFrame] (P) and best[totalNonSat]
        Vals<2> bl = {};
        each_ok([&](int i, bool ok) {
            if (ok) {
                const int32_t* c = c6 + (s0 + i) * 6;
                bl.v[0] = max(bl.v[0], c[BTL_NONSATFRAME]);
                bl.v[1] = max(bl.v[1], c[BTL_TOTALNONSAT]);
            }
        });
        Vals<2> bex, binc, btot;
        block_scan(bl, MaxOp<2>(), sm_best, bex, binc, btot);
        Vals<1> sl = {};
        int p = max(best_nsf_c, bex.v[0]);
        each_ok([&](int i, bool ok) {
            if (ok) {
                const int nsf = c6[(s0 + i) * 6 + BTL_NONSATFRAME];
                if (nsf <= p) sl.v[0] = max(sl.v[0], nsf);
                p = max(p, nsf);
            }
        });
        Vals<1> sex, sinc, stot;
        block_scan(sl, MaxOp<1>(), sm_second, sex, sinc, stot);

        // identity 4: the frame's reset and leading, the extra count
        const int best_nsf = max(best_nsf_c, binc.v[0]);
        const int second = max(second_c, sinc.v[0]);
        const bool reset =
            v && compare_std_err(max(best_tns_c, binc.v[1]), second);
        const int leading = v && best_nsf > second;
        Vals<2> eex, einc, etot;
        block_scan(Vals<2>{{reset, leading}}, SegSumOp(), sm_extra, eex, einc,
                   etot);
        const int extra = (einc.v[0] ? einc.v[1] : extra_c + einc.v[1])
                          - leading;   // the count the frame checks
        const bool stop = leading && extra_frame_limit < extra;
        int last = INT_MAX;            // the chunk's stop frame, if any
        if (__syncthreads_or(stop)) {  // first stop: max of INT_MAX - t
            Vals<1> x, y, z;
            block_scan(Vals<1>{{stop ? INT_MAX - t : 0}}, MaxOp<1>(), sm_stop,
                       x, y, z);
            last = INT_MAX - z.v[0];
        }

        // identity 5: write the chunk up to the stop
        if (in) {
            const bool live = t <= last;
            each_ok([&](int i, bool ok) {
                ok = ok && live;
                ok_out[s0 + i] = ok;
                if (ok) {
                    const int32_t* c = c6 + (s0 + i) * 6;
#pragma unroll
                    for (int col = 0; col < 6; ++col)
                        mine.v[col] = max(mine.v[col], c[col]);
                }
            });
            active_out[f] = v && live;
            if (live) {
                mine.v[6] += v && frame_sat[f];
                mine.v[7] = (int)((unsigned)mine.v[7] + frame_eval[f]
                                  + (v ? (unsigned)hitsum[f] : 0u));
            }
        }
        if (last != INT_MAX) {
            rest = c0 + BTL_BLOCK;
            break;
        }
        promote_c = PromoteOp()(promote_c, tot);
        best_nsf_c = max(best_nsf_c, btot.v[0]);
        best_tns_c = max(best_tns_c, btot.v[1]);
        second_c = max(second_c, stot.v[0]);
        extra_c = etot.v[0] ? etot.v[1] : extra_c + etot.v[1];
    }

    // past the stop: every slot and frame inactive
    for (long long x = (long long)rest * h + threadIdx.x; x < (long long)W * h;
         x += BTL_BLOCK)
        ok_out[frame0 * h + x] = false;
    for (int t = rest + threadIdx.x; t < W; t += BTL_BLOCK)
        active_out[frame0 + t] = false;

    Vals<8> x, y, z;
    block_scan(mine, TotalsOp(), sm_totals, x, y, z);
    if (threadIdx.x == 0) {
        for (int col = 0; col < 6; ++col) best_out[r * 6 + col] = z.v[col];
        satc_out[r] = z.v[6];
        evalc_out[r] = z.v[7];
    }
}

// c6 int32 [R, W, h, 6]; consider bool, min_count int32 [R, W, h]; valid,
// frame_sat, frame_eval bool, hitsum int32 [R, W]. Outputs ok bool
// [R, W, h], active bool [R, W], best int32 [R, 6], satc, evalc int32 [R].
// Requires W * h * 6 < 2**31 and R < 2**31.
extern "C" int btl_mibf_frame_scan(const void* c6, const void* consider,
                                   const void* min_count, const void* valid,
                                   const void* frame_sat,
                                   const void* frame_eval, const void* hitsum,
                                   long long R, int W, int h,
                                   int extra_frame_limit, void* ok,
                                   void* active, void* best, void* satc,
                                   void* evalc, int device, void* stream) {
    cudaError_t err = btl_set_device(device);
    if (err != cudaSuccess) return (int)err;
    if (R <= 0) return (int)cudaGetLastError();
    if (R > INT_MAX) return (int)cudaErrorInvalidValue;
    mibf_frame_scan_kernel<<<(unsigned)R, BTL_BLOCK, 0,
                             (cudaStream_t)stream>>>(
        (const int32_t*)c6, (const bool*)consider, (const int32_t*)min_count,
        (const bool*)valid, (const bool*)frame_sat, (const bool*)frame_eval,
        (const int32_t*)hitsum, W, h, extra_frame_limit, (bool*)ok,
        (bool*)active, (int32_t*)best, (int32_t*)satc, (int32_t*)evalc);
    return (int)cudaGetLastError();
}
