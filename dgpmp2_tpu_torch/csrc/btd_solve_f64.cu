// K-BTD's float64 instances and entry points; the kernels are in
// btd_solve.cuh.
#include "btd_solve.cuh"

extern "C" int dgpmp2_btd_solve_f64(const double* diag, const double* off,
                                    const double* rhs, double* x, double* gain,
                                    double* scratch, int batch, int steps,
                                    int d, void* stream) {
  return launch<double>(diag, off, rhs, x, gain, scratch, batch, steps, d,
                        stream);
}

extern "C" int dgpmp2_btd_plan_f64(int d, int batch, int* out) {
  return plan_query<double>(d, batch, out);
}
