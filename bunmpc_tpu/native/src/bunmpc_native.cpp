// Native (C++17) golden reference for the biconvex centroidal MPC core.
//
// Re-implements, dependency-free (no Eigen), the solver semantics of the
// reference stack's native components so the batched JAX kernels can be
// golden-tested against an independent implementation:
//   * FISTA with backtracking line search + box / friction-cone projection
//     (reference src/solvers/fista.cpp:6-70, include/solvers/fista.hpp)
//   * QP problem data with the objective-difference trick
//     (reference src/solvers/problem.cpp:31-56)
//   * centroidal dynamics constraint systems A_x/b_x/A_f/b_f
//     (reference src/dynamics/centroidal.cpp:57-127)
//   * biconvex ADMM driver with dual update + exit tolerance
//     (reference src/motion_planner/biconvex.cpp:80-120)
//
// The constraint operators are written matrix-free over (H, n_eff, 3)
// layouts — the same stencil structure the JAX operators use — which is
// mathematically identical to the reference's sparse matrices (verified row
// by row in tests/test_solvers.py against the dense twins).
//
// Exposed through a C ABI for ctypes (no pybind11 in this toolchain).

#include <cmath>
#include <cstring>
#include <limits>
#include <vector>

namespace {

struct Plan {
  int H;
  int ne;
  double m;
  const double* cnt;  // (H, ne)
  const double* r;    // (H, ne, 3)
  const double* dt;   // (H,)
};

// y (H+1, 9) += A_x(X) F   [rows: lin 3..5, ang 6..8 per knot]
void ax_apply(const Plan& p, const double* X, const double* F, double* y) {
  std::memset(y, 0, sizeof(double) * 9 * (p.H + 1));
  for (int t = 0; t < p.H; ++t) {
    const double dt = p.dt[t];
    const double* com = X + 9 * t;
    for (int n = 0; n < p.ne; ++n) {
      const double c = p.cnt[t * p.ne + n];
      const double* f = F + (t * p.ne + n) * 3;
      const double* rr = p.r + (t * p.ne + n) * 3;
      double arm[3] = {rr[0] - com[0], rr[1] - com[1], rr[2] - com[2]};
      for (int k = 0; k < 3; ++k) y[9 * t + 3 + k] += c * dt / p.m * f[k];
      y[9 * t + 6] += c * dt * (arm[1] * f[2] - arm[2] * f[1]);
      y[9 * t + 7] += c * dt * (arm[2] * f[0] - arm[0] * f[2]);
      y[9 * t + 8] += c * dt * (arm[0] * f[1] - arm[1] * f[0]);
    }
  }
}

// out (H, ne, 3) = A_x(X)^T y
void ax_applyT(const Plan& p, const double* X, const double* y, double* out) {
  for (int t = 0; t < p.H; ++t) {
    const double dt = p.dt[t];
    const double* com = X + 9 * t;
    const double* yl = y + 9 * t + 3;
    const double* ya = y + 9 * t + 6;
    for (int n = 0; n < p.ne; ++n) {
      const double c = p.cnt[t * p.ne + n];
      const double* rr = p.r + (t * p.ne + n) * 3;
      double arm[3] = {rr[0] - com[0], rr[1] - com[1], rr[2] - com[2]};
      double* o = out + (t * p.ne + n) * 3;
      // d/df [y_ang . (arm x f)] = y_ang x arm
      o[0] = c * dt * (yl[0] / p.m + ya[1] * arm[2] - ya[2] * arm[1]);
      o[1] = c * dt * (yl[1] / p.m + ya[2] * arm[0] - ya[0] * arm[2]);
      o[2] = c * dt * (yl[2] / p.m + ya[0] * arm[1] - ya[1] * arm[0]);
    }
  }
}

// b_x(X) (H+1, 9)
void bx_vec(const Plan& p, const double* X, double* b) {
  std::memset(b, 0, sizeof(double) * 9 * (p.H + 1));
  for (int t = 0; t < p.H; ++t) {
    for (int k = 3; k < 9; ++k) b[9 * t + k] = X[9 * (t + 1) + k] - X[9 * t + k];
    b[9 * t + 5] += 9.81 * p.dt[t];
  }
}

// y (H+1, 9) = A_f(F) X (incl. initial-state pinning row block)
void af_apply(const Plan& p, const double* F, const double* X, double* y) {
  for (int t = 0; t < p.H; ++t) {
    const double dt = p.dt[t];
    double ftot[3] = {0, 0, 0};
    for (int n = 0; n < p.ne; ++n) {
      const double c = p.cnt[t * p.ne + n];
      const double* f = F + (t * p.ne + n) * 3;
      for (int k = 0; k < 3; ++k) ftot[k] += c * f[k];
    }
    const double* Xt = X + 9 * t;
    const double* Xt1 = X + 9 * (t + 1);
    for (int k = 0; k < 3; ++k)
      y[9 * t + k] = Xt[k] - Xt1[k] + dt * Xt1[3 + k];
    for (int k = 3; k < 6; ++k) y[9 * t + k] = Xt[k] - Xt1[k];
    // ang rows: L_t - L_{t+1} + dt * (ftot x com_t)
    y[9 * t + 6] = Xt[6] - Xt1[6] + dt * (ftot[1] * Xt[2] - ftot[2] * Xt[1]);
    y[9 * t + 7] = Xt[7] - Xt1[7] + dt * (ftot[2] * Xt[0] - ftot[0] * Xt[2]);
    y[9 * t + 8] = Xt[8] - Xt1[8] + dt * (ftot[0] * Xt[1] - ftot[1] * Xt[0]);
  }
  for (int k = 0; k < 9; ++k) y[9 * p.H + k] = X[k];
}

// out (H+1, 9) = A_f(F)^T y
void af_applyT(const Plan& p, const double* F, const double* y, double* out) {
  std::memset(out, 0, sizeof(double) * 9 * (p.H + 1));
  for (int t = 0; t < p.H; ++t) {
    const double dt = p.dt[t];
    double ftot[3] = {0, 0, 0};
    for (int n = 0; n < p.ne; ++n) {
      const double c = p.cnt[t * p.ne + n];
      const double* f = F + (t * p.ne + n) * 3;
      for (int k = 0; k < 3; ++k) ftot[k] += c * f[k];
    }
    const double* yt = y + 9 * t;
    double* ot = out + 9 * t;
    double* ot1 = out + 9 * (t + 1);
    for (int k = 0; k < 3; ++k) {
      ot[k] += yt[k];
      ot1[k] -= yt[k];
      ot1[3 + k] += dt * yt[k];
      ot[3 + k] += yt[3 + k];
      ot1[3 + k] -= yt[3 + k];
      ot[6 + k] += yt[6 + k];
      ot1[6 + k] -= yt[6 + k];
    }
    // d/dcom_t [y_ang . (ftot x com)] = y_ang x ftot
    ot[0] += dt * (yt[7] * ftot[2] - yt[8] * ftot[1]);
    ot[1] += dt * (yt[8] * ftot[0] - yt[6] * ftot[2]);
    ot[2] += dt * (yt[6] * ftot[1] - yt[7] * ftot[0]);
  }
  for (int k = 0; k < 9; ++k) out[k] += y[9 * p.H + k];
}

// b_f(F) (H+1, 9)
void bf_vec(const Plan& p, const double* F, const double* x_init, double* b) {
  std::memset(b, 0, sizeof(double) * 9 * (p.H + 1));
  for (int t = 0; t < p.H; ++t) {
    const double dt = p.dt[t];
    for (int n = 0; n < p.ne; ++n) {
      const double c = p.cnt[t * p.ne + n];
      const double* f = F + (t * p.ne + n) * 3;
      const double* rr = p.r + (t * p.ne + n) * 3;
      for (int k = 0; k < 3; ++k) b[9 * t + 3 + k] += -c * dt / p.m * f[k];
      b[9 * t + 6] += c * dt * (f[1] * rr[2] - f[2] * rr[1]);
      b[9 * t + 7] += c * dt * (f[2] * rr[0] - f[0] * rr[2]);
      b[9 * t + 8] += c * dt * (f[0] * rr[1] - f[1] * rr[0]);
    }
    b[9 * t + 5] += 9.81 * dt;
  }
  for (int k = 0; k < 9; ++k) b[9 * p.H + k] = x_init[k];
}

inline double dot(const double* a, const double* b, int n) {
  double s = 0;
  for (int i = 0; i < n; ++i) s += a[i] * b[i];
  return s;
}

// Friction-cone (second-order cone) projection per 3-vector, Euclidean norm.
void soc_project(double* y, int n_vec3, double mu) {
  for (int i = 0; i < n_vec3; ++i) {
    double* f = y + 3 * i;
    const double s = std::sqrt(f[0] * f[0] + f[1] * f[1]);
    const double z = f[2];
    if (s <= mu * z) continue;  // inside the cone
    if (mu * s <= -z) {         // inside the polar cone -> project to origin
      f[0] = f[1] = f[2] = 0;
      continue;
    }
    const double coef = (mu * mu * s + mu * z) / ((mu * mu + 1) * (s > 0 ? s : 1.0));
    f[0] *= coef;
    f[1] *= coef;
    f[2] = (mu * s + z) / (mu * mu + 1);
  }
}

struct QP {
  // objective: x'diag(Q)x + q.x + rho || A x - b + P ||^2 with operator pair
  int n;           // variable count
  int nres;        // residual count
  const double* Qdiag;
  const double* qlin;  // may be null
  double rho;
  // operator closures (function pointers bound via lambdas below)
};

// Generic FISTA over the two subproblem shapes. op/opT are callables.
template <typename Apply, typename ApplyT, typename Proj>
void fista_solve(int n, int nres, const double* Qdiag, const double* qlin,
                 double rho, const double* bP, Apply apply, ApplyT applyT,
                 Proj proj, double* x, double& L, double beta, int max_iters,
                 double tol) {
  std::vector<double> y(x, x + n), y_next(n), grad(n), res(nres), tmp(n);
  std::vector<double> diff(n);
  double t_k = 1.0;
  for (int it = 0; it < max_iters; ++it) {
    // gradient at y: 2 Q y + q + 2 rho A^T (A y + bP)
    apply(y.data(), res.data());
    for (int i = 0; i < nres; ++i) res[i] += bP[i];
    applyT(res.data(), tmp.data());
    for (int i = 0; i < n; ++i)
      grad[i] = 2.0 * (Qdiag[i] * y[i] + rho * tmp[i]) + (qlin ? qlin[i] : 0.0);

    // backtracking line search (reference fista.cpp:6-27)
    double G_norm = 0;
    for (int ls = 0; ls < 60; ++ls) {
      for (int i = 0; i < n; ++i) y_next[i] = y[i] - grad[i] / L;
      proj(y_next.data());
      for (int i = 0; i < n; ++i) diff[i] = y_next[i] - y[i];
      G_norm = std::sqrt(dot(diff.data(), diff.data(), n));
      // obj difference (reference problem.cpp:46-51)
      double obj_diff = 0;
      for (int i = 0; i < n; ++i)
        obj_diff += (y_next[i] + y[i]) * Qdiag[i] * diff[i] +
                    (qlin ? qlin[i] * diff[i] : 0.0);
      std::vector<double> r1(nres), r0(nres);
      apply(y_next.data(), r1.data());
      apply(y.data(), r0.data());
      double pen = 0;
      for (int i = 0; i < nres; ++i) {
        const double a1 = r1[i] + bP[i];
        const double a0 = r0[i] + bP[i];
        pen += a1 * a1 - a0 * a0;
      }
      obj_diff += rho * pen;
      if (obj_diff > dot(grad.data(), diff.data(), n) + 0.5 * L * G_norm * G_norm)
        L = beta * L;
      else
        break;
    }
    // momentum (reference fista.cpp:34 variant)
    const double t_next = 1.0 + std::sqrt(1.0 + 4.0 * t_k * t_k) / 2.0;
    for (int i = 0; i < n; ++i) {
      const double x_new = y_next[i];
      y[i] = x_new + ((t_k - 1.0) / t_next) * (x_new - x[i]);
      x[i] = x_new;
    }
    t_k = t_next;
    if (G_norm < tol) break;
  }
}

}  // namespace

extern "C" {

// Single biconvex ADMM solve; layouts documented in the Python bindings.
void bunmpc_biconvex_solve(int H, int ne, double m, const double* cnt,
                           const double* r, const double* dts,
                           const double* x_init, const double* W,
                           const double* X_ref, const double* W_F, double rho,
                           int max_admm, int fista_max_iters, double fista_tol,
                           double exit_tol, double beta, double L0_x,
                           double L0_f, double mu, const double* lb_x,
                           const double* ub_x, double* X, double* F,
                           double* viol_out, int* iters_out) {
  Plan p{H, ne, m, cnt, r, dts};
  const int nX = 9 * (H + 1);
  const int nF = 3 * ne * H;
  std::vector<double> P(nX, 0.0), b(nX), bP(nX), qx(nX), viol(nX);
  for (int i = 0; i < nX; ++i) qx[i] = -2.0 * W[i] * X_ref[i];
  double Lx = L0_x, Lf = L0_f;
  std::vector<double> WF0(nF, 0.0);
  double viol_norm = std::numeric_limits<double>::infinity();
  int it = 0;
  for (; it < max_admm; ++it) {
    // F subproblem
    bx_vec(p, X, b.data());
    for (int i = 0; i < nX; ++i) bP[i] = P[i] - b[i];
    fista_solve(
        nF, nX, W_F, nullptr, rho, bP.data(),
        [&](const double* f, double* y) { ax_apply(p, X, f, y); },
        [&](const double* y, double* o) { ax_applyT(p, X, y, o); },
        [&](double* z) { soc_project(z, ne * H, mu); }, F, Lf, beta,
        fista_max_iters, fista_tol);

    // X subproblem
    bf_vec(p, F, x_init, b.data());
    for (int i = 0; i < nX; ++i) bP[i] = P[i] - b[i];
    fista_solve(
        nX, nX, W, qx.data(), rho, bP.data(),
        [&](const double* x, double* y) { af_apply(p, F, x, y); },
        [&](const double* y, double* o) { af_applyT(p, F, y, o); },
        [&](double* z) {
          if (lb_x)
            for (int i = 0; i < nX; ++i)
              z[i] = std::fmin(std::fmax(z[i], lb_x[i]), ub_x[i]);
        },
        X, Lx, beta, fista_max_iters, fista_tol);

    // dual update + exit (reference biconvex.cpp:98-114)
    af_apply(p, F, X, viol.data());
    bf_vec(p, F, x_init, b.data());
    double nrm = 0;
    for (int i = 0; i < nX; ++i) {
      viol[i] -= b[i];
      P[i] += viol[i];
      nrm += viol[i] * viol[i];
    }
    viol_norm = std::sqrt(nrm);
    if (std::isnan(viol_norm) || viol_norm < exit_tol) {
      ++it;
      break;
    }
  }
  *viol_out = viol_norm;
  *iters_out = it;
}

// Standalone operator evaluations for fine-grained golden tests.
void bunmpc_ax_apply(int H, int ne, double m, const double* cnt,
                     const double* r, const double* dts, const double* X,
                     const double* F, double* y) {
  Plan p{H, ne, m, cnt, r, dts};
  ax_apply(p, X, F, y);
}

void bunmpc_af_apply(int H, int ne, double m, const double* cnt,
                     const double* r, const double* dts, const double* F,
                     const double* X, double* y) {
  Plan p{H, ne, m, cnt, r, dts};
  af_apply(p, F, X, y);
}

void bunmpc_bx_vec(int H, int ne, double m, const double* cnt, const double* r,
                   const double* dts, const double* X, double* b) {
  Plan p{H, ne, m, cnt, r, dts};
  bx_vec(p, X, b);
}

void bunmpc_bf_vec(int H, int ne, double m, const double* cnt, const double* r,
                   const double* dts, const double* F, const double* x_init,
                   double* b) {
  Plan p{H, ne, m, cnt, r, dts};
  bf_vec(p, F, x_init, b);
}

void bunmpc_soc_project(double* y, int n_vec3, double mu) {
  soc_project(y, n_vec3, mu);
}

}  // extern "C"

// --- cyclic gait phase machine (reference src/gait_planner/gait_planner.cpp:31-121) ---

extern "C" {

double bunmpc_gait_phi(double t, double period, double offset) {
  return std::fmod(t + offset * period, period);
}

int bunmpc_gait_phase(double t, double period, double offset, double stance_percent) {
  const double phi = bunmpc_gait_phi(t, period, offset);
  const double st = stance_percent * period;
  // includes the reference's 1e-4 boundary tolerance (gait_planner.cpp:48-49)
  return (phi <= st || std::fabs(phi - st) < 1e-4) ? 1 : 0;
}

double bunmpc_gait_percent_in_phase(double t, double period, double offset,
                                    double stance_percent) {
  const double phi = bunmpc_gait_phi(t, period, offset);
  const double st = stance_percent * period;
  if (phi <= st + 1e-4) return phi / st;
  return (phi - st) / (period - st);
}

// batched horizon plan: out (horizon, n_eff) 0/1 flags
void bunmpc_gait_contact_plan(double t, double dt, int horizon, int n_eff,
                              const double* period, const double* offsets,
                              const double* stance_percent, int* out) {
  for (int i = 0; i < horizon; ++i)
    for (int j = 0; j < n_eff; ++j)
      out[i * n_eff + j] =
          bunmpc_gait_phase(t + i * dt, period[0], offsets[j], stance_percent[j]);
}

}  // extern "C"
