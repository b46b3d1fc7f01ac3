// K-STREAM, the scratch query and the float32 instance.  The kernels are in
// btd_stream.cuh; each instance has its own source, so that nvcc builds
// the three in parallel.
#include "btd_stream.cuh"

int dgpmp2_stream::producer_cap = 0;

// The most producer warps a lane-group block of any instance takes from the
// next launch on (0: the kernel's most), for measuring the choice;
// returns the previous cap.
extern "C" int dgpmp2_btd_stream_set_producers(int n) {
  const int prev = dgpmp2_stream::producer_cap;
  dgpmp2_stream::producer_cap = n < 0 ? 0 : n;
  return prev;
}

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

// The lane-group launch plan at D <= 16 (narrow_geometry).
extern "C" int dgpmp2_btd_stream_f32_geometry(int d, int batch, int* out) {
  return narrow_geometry<float, float>(d, batch, out);
}

