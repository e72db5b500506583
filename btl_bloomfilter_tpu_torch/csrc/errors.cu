// Error text for the codes the kernel entry points return, and a device
// limit the timing tools record.
#include <cuda_runtime.h>

extern "C" const char* btl_cuda_error_string(int err) {
    return cudaGetErrorString((cudaError_t)err);
}

// cudaLimitMaxL2FetchGranularity of the current device, in bytes (the
// DRAM fetch an L2 miss makes at most), or -1 if it cannot be read.
extern "C" long long btl_l2_fetch_granularity(void) {
    size_t v = 0;
    if (cudaDeviceGetLimit(&v, cudaLimitMaxL2FetchGranularity) != cudaSuccess)
        return -1;
    return (long long)v;
}
