// MIBF classification, pass C: the sequential per-read state of the
// query engine, walked frame by frame.
//
// For every read r, in frame order t and slot order i, with the per-slot
// running counts c6[r, t, i, 0..5] (count, nonSat, total, totalNonSat,
// nonSatFrame, solid) precomputed by passes A and B:
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
// on the TPU it is an XLA scan. Run eagerly in torch it is a Python loop of
// W * h steps of about ten launches each; here it is one launch.
//
// compareStdErr is float32 with IEEE sqrtf, as the JAX engine computes it;
// the build uses no fast-math flag, and the comparison has no product that
// could contract into an FMA. The counts are small integers, exact in
// float32, so the result is the JAX result bit for bit.
//
// What bounds it on the H100: latency. The work is a dependent chain of W*h
// steps per read with R reads in parallel (256 at the bench batch), far too
// few threads to hide the load latency of each frame's inputs. Design: one
// thread per read, frames in order, loads independent of the carried state
// so the compiler can issue them ahead; making it fast (frame-major inputs
// for coalesced loads, a warp per read) is later work.

#include "common.cuh"

#define BTL_COUNT 0
#define BTL_TOTALNONSAT 3
#define BTL_NONSATFRAME 4

__device__ __forceinline__ bool compare_std_err(int a, int b) {
    const float af = (float)a, bf = (float)b;
    const float sa = sqrtf(af), sb = sqrtf(bf);
    return af > bf ? (af - sa) <= (bf + sb) : (bf - sb) <= (af + sa);
}

__global__ void __launch_bounds__(32)
mibf_frame_scan_kernel(const int32_t* __restrict__ c6,
                       const bool* __restrict__ consider,
                       const int32_t* __restrict__ min_count,
                       const bool* __restrict__ valid,
                       const bool* __restrict__ frame_sat,
                       const bool* __restrict__ frame_eval,
                       const int32_t* __restrict__ hitsum, long long R,
                       int W, int h, int extra_frame_limit,
                       bool* __restrict__ ok_out,
                       bool* __restrict__ active_out,
                       int32_t* __restrict__ best_out,
                       int32_t* __restrict__ satc_out,
                       int32_t* __restrict__ evalc_out) {
    const long long stride = (long long)gridDim.x * blockDim.x;
    for (long long r = (long long)blockIdx.x * blockDim.x + threadIdx.x;
         r < R; r += stride) {
        int best[6] = {0, 0, 0, 0, 0, 0};
        int second = 0, extra = 0, satc = 0, evalc = 0;
        bool stopped = false, has_cand = false;
        for (int t = 0; t < W; ++t) {
            const long long f = r * W + t;
            const bool active = valid[f] && !stopped;
            for (int i = 0; i < h; ++i) {
                const long long s = f * h + i;
                bool ok = false;
                if (active && consider[s]) {
                    const int32_t* c = c6 + s * 6;
                    const int cnt = c[BTL_COUNT];
                    ok = cnt >= min_count[s] ||
                         (has_cand && cnt >= best[BTL_COUNT]);
                    if (ok) {
                        has_cand = true;
                        // second-best reads the best nonSatFrame before
                        // this slot's update
                        const int nsf = c[BTL_NONSATFRAME];
                        if (!(nsf > best[BTL_NONSATFRAME]) && nsf > second)
                            second = nsf;
                        for (int col = 0; col < 6; ++col)
                            best[col] = max(best[col], c[col]);
                    }
                }
                ok_out[s] = ok;
            }
            satc += (active && frame_sat[f]) ? 1 : 0;
            evalc += ((frame_eval[f] && !stopped) ? 1 : 0)
                     + (active ? hitsum[f] : 0);
            if (active && compare_std_err(best[BTL_TOTALNONSAT], second))
                extra = 0;
            const bool leading = best[BTL_NONSATFRAME] > second;
            const bool hit_limit = leading && extra_frame_limit < extra;
            if (active && leading) extra += 1;
            if (active && hit_limit) stopped = true;
            active_out[f] = active;
        }
        for (int col = 0; col < 6; ++col) best_out[r * 6 + col] = best[col];
        satc_out[r] = satc;
        evalc_out[r] = evalc;
    }
}

// c6 int32 [R, W, h, 6]; consider bool, min_count int32 [R, W, h]; valid,
// frame_sat, frame_eval bool, hitsum int32 [R, W]. Outputs ok bool
// [R, W, h], active bool [R, W], best int32 [R, 6], satc, evalc int32 [R].
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
    // one warp per block: the few hundred reads of a batch spread over
    // as many SMs as they can
    const long long blocks = (R + 31) / 32;
    mibf_frame_scan_kernel<<<(unsigned)(blocks < 1 ? 1 : blocks), 32, 0,
                             (cudaStream_t)stream>>>(
        (const int32_t*)c6, (const bool*)consider, (const int32_t*)min_count,
        (const bool*)valid, (const bool*)frame_sat, (const bool*)frame_eval,
        (const int32_t*)hitsum, R, W, h, extra_frame_limit, (bool*)ok,
        (bool*)active, (int32_t*)best, (int32_t*)satc, (int32_t*)evalc);
    return (int)cudaGetLastError();
}
