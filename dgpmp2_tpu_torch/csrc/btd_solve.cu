// K-BTD's float32 instances and entry points, and the scratch query; the
// kernels are in btd_solve.cuh (float64: btd_solve_f64.cu).  One source a
// type, so that nvcc builds the two in parallel.
#include "btd_solve.cuh"

// Bytes of global scratch per problem that the wrapper must pass at D: 0
// where the kernel needs none (D <= 32, or the parent block kernel's rows,
// block_elems(d) doubles, fit the device's opt-in shared memory).
extern "C" int dgpmp2_btd_scratch_bytes(int d, long long* bytes) {
  *bytes = 0;
  if (d <= kMaxD) return static_cast<int>(cudaSuccess);
  int optin = 0;
  const int rc = smem_optin(&optin);
  if (rc != 0) return rc;
  const size_t n = block_elems(d) * sizeof(double);
  if (n > static_cast<size_t>(optin)) *bytes = static_cast<long long>(n);
  return static_cast<int>(cudaSuccess);
}

extern "C" int dgpmp2_btd_solve_f32(const float* diag, const float* off,
                                    const float* rhs, float* x, float* gain,
                                    double* scratch, int batch, int steps,
                                    int d, void* stream) {
  return launch<float>(diag, off, rhs, x, gain, scratch, batch, steps, d,
                       stream);
}

extern "C" int dgpmp2_btd_plan_f32(int d, int batch, int* out) {
  return plan_query<float>(d, batch, out);
}
