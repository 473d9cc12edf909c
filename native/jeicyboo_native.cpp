// Native host-side compat kernels for the strictly-sequential streaming ops.
//
// The 7-band GEQ (7Band_GEQ.cpp) and the per-sample NLMS (NormalLMS.cpp)
// quantize to int16 INSIDE their feedback loops, which makes every floating
// point rounding observable.  XLA contracts mul+add into fma inside fused
// loops (changing rounding on exactly-cancelling terms), so bit-exact compat
// for these two kernels lives here, compiled with -ffp-contract=off to match
// the reference's per-operation rounding.  The device fast paths (associative
// scan GEQ, batched BNLMS) remain in JAX.
//
// Exposed C ABI (ctypes):
//   jb_c_short(double) -> int16 semantics helper (MSVC x86-64 rule)
//   jb_geq_process(x, n, b[7*3], a[7*3], keep_in[7*2], keep_out[7*2], out)
//   jb_nlms_process(x, ref, n_blocks, coeff[256], keep[255], est, err)
//   jb_bnlms_process(x, ref, n_blocks, coeff[128], keep_in[127],
//                    keep_ref[127], est, err)

#include <cstdint>
#include <cmath>
#include <cstring>

extern "C" {

static inline int16_t c_short(double v) {
  // MSVC x86-64 double->short: cvttsd2si to int32 (NaN/out-of-range ->
  // INT32_MIN), then low 16 bits.
  double t = std::trunc(v);
  int32_t i;
  if (!(t >= -2147483648.0 && t <= 2147483647.0)) {  // catches NaN too
    i = INT32_MIN;
  } else {
    i = (int32_t)t;
  }
  return (int16_t)(uint16_t)(i & 0xFFFF);
}

int16_t jb_c_short(double v) { return c_short(v); }

// ---- 7-band graphic EQ (7Band_GEQ.cpp:259-332) --------------------------
void jb_geq_process(const int16_t* x, int64_t n, const double* b,
                    const double* a, int16_t* keep_in, int16_t* keep_out,
                    int16_t* out) {
  const int BANDS = 7;
  // per-sample cascade; histories u[band][2] (input) and y[band][2] (output)
  for (int64_t i = 0; i < n; i++) {
    int16_t u2, u1, u0;
    u2 = keep_in[0 * 2 + 0];
    u1 = keep_in[0 * 2 + 1];
    u0 = x[i];
    for (int k = 0; k < BANDS; k++) {
      const double* bk = b + k * 3;
      const double* ak = a + k * 3;
      int16_t y0 = keep_out[k * 2 + 0];
      int16_t y1 = keep_out[k * 2 + 1];
      // exact C accumulation order (7Band_GEQ.cpp:279-283)
      double acc = bk[2] * (double)u2;
      acc -= ak[2] * (double)y0;
      acc += bk[1] * (double)u1;
      acc -= ak[1] * (double)y1;
      acc += bk[0] * (double)u0;
      int16_t y = c_short(acc);
      // shift band k histories
      keep_in[k * 2 + 0] = u1;
      keep_in[k * 2 + 1] = u0;
      keep_out[k * 2 + 0] = y1;
      keep_out[k * 2 + 1] = y;
      // next band's input history is band k's output history
      u2 = y0;
      u1 = y1;
      u0 = y;
    }
    out[i] = u0;
  }
}

// ---- per-sample NLMS (NormalLMS.cpp:96-136) -----------------------------
void jb_nlms_process(const int16_t* x, const int16_t* ref, int64_t n_blocks,
                     double* coeff, int16_t* keep, int16_t* est,
                     int16_t* err) {
  const int T = 256, K = 255, B = 1024;
  const double MU = 0.0001, EPS = 0.0001;
  double* u = new double[K + B];
  for (int64_t blk = 0; blk < n_blocks; blk++) {
    const int16_t* xb = x + blk * B;
    const int16_t* rb = ref + blk * B;
    for (int j = 0; j < K; j++) u[j] = (double)keep[j];
    for (int j = 0; j < B; j++) u[K + j] = (double)xb[j];
    for (int i = 0; i < B; i++) {
      double acc = 0.0;
      for (int j = 0; j < T; j++) acc += coeff[T - 1 - j] * u[j + i];
      int16_t y = c_short(acc);
      est[blk * B + i] = y;
      int e = (int)rb[i] - (int)y;
      err[blk * B + i] = (int16_t)(uint16_t)(e & 0xFFFF);
      double norm = 0.0;
      for (int j = 0; j < T; j++) norm += u[j + i] * u[j + i];
      double d = norm + EPS;
      double ef = (double)e;
      for (int j = 0; j < T; j++) coeff[j] += 2.0 * u[j + i] * MU * ef / d;
    }
    for (int j = 0; j < K; j++) keep[j] = xb[B - K + j];
  }
  delete[] u;
}

// ---- block NLMS (BNLMS.cpp:103-186) -------------------------------------
void jb_bnlms_process(const int16_t* x, const int16_t* ref, int64_t n_blocks,
                      double* coeff, int16_t* keep_in, int16_t* keep_ref,
                      int16_t* est, int16_t* err) {
  const int T = 128, K = 127, B = 1024;
  const double MU = 0.01, EPS = 0.00001;
  double* u = new double[K + B];
  double* r = new double[K + B];
  double* grad = new double[T];
  for (int64_t blk = 0; blk < n_blocks; blk++) {
    const int16_t* xb = x + blk * B;
    const int16_t* rb = ref + blk * B;
    for (int j = 0; j < K; j++) u[j] = (double)keep_in[j];
    for (int j = 0; j < B; j++) u[K + j] = (double)xb[j];
    for (int j = 0; j < K; j++) r[j] = (double)keep_ref[j];
    for (int j = 0; j < B; j++) r[K + j] = (double)rb[j];
    for (int i = 0; i < B; i++) {
      double acc = 0.0;
      for (int j = 0; j < T; j++) acc += coeff[T - 1 - j] * u[j + i];
      int16_t y = c_short(acc);
      est[blk * B + i] = y;
      int e = (int)rb[i] - (int)y;
      err[blk * B + i] = (int16_t)(uint16_t)(e & 0xFFFF);
    }
    // double-talk gate (BNLMS.cpp:164-186); OOB reads defined as zero
    double dmax = 0.0;
    for (int k = 0; k < B; k++) {
      double acc = 0.0;
      int m = 2 * B - k;
      for (int i = 0; i < m; i++) {
        double uv = (i < K + B) ? u[i] : 0.0;
        double rv = (i + k < K + B) ? r[i + k] : 0.0;
        acc += uv * rv;
      }
      acc /= (double)m;
      if (acc > dmax) dmax = acc;
    }
    if (dmax > 0.0) {  // not double talk -> update
      for (int j = 0; j < T; j++) grad[j] = 0.0;
      for (int i = 0; i < B; i++) {
        double norm = 0.0;
        for (int j = 0; j < T; j++) norm += u[j + i] * u[j + i];
        double d = norm + EPS;
        double ef = (double)((int)rb[i] - (int)est[blk * B + i]);
        for (int j = 0; j < T; j++) grad[j] += 2.0 * u[j + i] * MU * ef / d;
      }
      for (int j = 0; j < T; j++) {
        grad[j] /= (double)B;
        coeff[j] += grad[j];
      }
    }
    for (int j = 0; j < K; j++) keep_in[j] = xb[B - K + j];
    for (int j = 0; j < K; j++) keep_ref[j] = rb[B - K + j];
  }
  delete[] u;
  delete[] r;
  delete[] grad;
}

}  // extern "C"
