// K-STREAM, the scratch query and the float32 instance.  The kernels are in
// btd_stream.cuh; each instance has its own source, so that nvcc builds
// the three in parallel.
#include "btd_stream.cuh"

// Bytes of global scratch per problem that the wrapper must pass at D: 0
// where the kernel needs none (D <= 32, or the rows fit the device's opt-in
// shared memory).
extern "C" int dgpmp2_btd_stream_scratch_bytes(int d, long long* bytes) {
  *bytes = 0;
  if (d <= kMaxD) return static_cast<int>(cudaSuccess);
  int optin = 0;
  const int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  const size_t n = stream_block_elems(d) * sizeof(double);
  if (n > static_cast<size_t>(optin)) *bytes = static_cast<long long>(n);
  return static_cast<int>(cudaSuccess);
}

extern "C" int dgpmp2_btd_stream_f32(const StreamArgs* a, void* stream) {
  return launch<float, float>(a, stream);
}

