// Native SWIPDG P1 assembler on the structured triangulation.
//
// The reference's assembly layer is C++ (dune-gdt grid walks, SURVEY.md
// §2.3); this extension is its counterpart in the new framework's runtime:
// a sequential-CPU COO assembler used as (a) the fast validation oracle and
// (b) the CPU-baseline assembly in benchmarks.  The device compute path
// stays PyTorch/CUDA — this is host-side runtime infrastructure (the port's
// copy of pylrbms_tpu/native/swipdg_assembler.cpp).
//
// Contract: coefficient values are PRE-EVALUATED at quadrature points
// (mirrors dune's function-interface split); this file owns the P1 basis,
// the affine-factor SWIPDG integrands and the dof indexing:
//
//   triangles per quad cell: A = {(0,0),(1,0),(1,1)}, B = {(0,0),(0,1),(1,1)}
//   dof(gx, gy, t, i) = ii*N + ((cy*s+cx)*2 + t)*3 + i,  ii = sy*kx + sx
//   inner face integrand (weights from kappa, lambda linear):
//     pen = sigma_in * (dm*dp/(dm+dp)) * (om_m lam_m + om_p lam_p) / |e|^beta
//     a_e = pen [u][v] - {lam k grad u . n}_om [v] - {lam k grad v . n}_om [u]
//   boundary: pen_b = sigma_bd * delta * lam / |e|^beta (one-sided terms).
//
// Python side: pylrbms_tpu_torch/native/__init__.py (ctypes-free CPython API).

#define PY_SSIZE_T_CLEAN
#include <Python.h>
#define NPY_NO_DEPRECATED_API NPY_1_7_API_VERSION
#include <numpy/arrayobject.h>

#include <cmath>
#include <cstdint>
#include <vector>

namespace {

struct Coo {
  std::vector<int64_t> rows, cols;
  std::vector<double> vals;
  void add(int64_t r, int64_t c, double v) {
    rows.push_back(r);
    cols.push_back(c);
    vals.push_back(v);
  }
};

// P1 barycentric gradients in unit-cell coords, per triangle type.
static const double kGradUnit[2][3][2] = {
    {{-1.0, 0.0}, {1.0, -1.0}, {0.0, 1.0}},   // A
    {{0.0, -1.0}, {-1.0, 1.0}, {1.0, 0.0}},   // B
};

inline void bary(int tri, double xi, double eta, double lam[3]) {
  if (tri == 0) {
    lam[0] = 1.0 - xi;
    lam[1] = xi - eta;
    lam[2] = eta;
  } else {
    lam[0] = 1.0 - eta;
    lam[1] = eta - xi;
    lam[2] = xi;
  }
}

struct Ctx {
  int kx, ky, s;
  double hx, hy, sigma_in, sigma_bd, beta;
  int nqv, nqf;
  const double* qv;    // [2][nqv][2] unit-cell volume points (A then B)
  const double* wv;    // [2][nqv]
  const double* qf;    // [nqf] edge parameter points
  const double* wf;    // [nqf]
  const double* lam_vol;   // [Sy][Sx][2][nqv]
  // face coefficient values, minus/plus sides:
  const double* lam_D_m;   // [Sy][Sx][nqf]
  const double* lam_D_p;
  const double* lam_V_m;   // [Sy][Sx-1][nqf]
  const double* lam_V_p;
  const double* lam_H_m;   // [Sy-1][Sx][nqf]
  const double* lam_H_p;
  const double* lam_bnd;   // [2*Sy + 2*Sx][nqf] (left rows, right rows, bottom cols, top cols)
  int Sx, Sy;

  int64_t dof(int gx, int gy, int t, int i) const {
    int sx = gx / s, sy = gy / s, cx = gx % s, cy = gy % s;
    int64_t ii = (int64_t)sy * kx + sx;
    int64_t N = (int64_t)s * s * 2 * 3;
    return ii * N + (((int64_t)cy * s + cx) * 2 + t) * 3 + i;
  }
};

void volume(const Ctx& c, Coo& out) {
  for (int gy = 0; gy < c.Sy; ++gy)
    for (int gx = 0; gx < c.Sx; ++gx)
      for (int t = 0; t < 2; ++t) {
        double M[3][3] = {{0}};
        for (int q = 0; q < c.nqv; ++q) {
          double lam =
              c.lam_vol[(((int64_t)gy * c.Sx + gx) * 2 + t) * c.nqv + q];
          double w = c.wv[t * c.nqv + q] * c.hx * c.hy * lam;
          for (int i = 0; i < 3; ++i)
            for (int j = 0; j < 3; ++j) {
              double gi0 = kGradUnit[t][i][0] / c.hx,
                     gi1 = kGradUnit[t][i][1] / c.hy;
              double gj0 = kGradUnit[t][j][0] / c.hx,
                     gj1 = kGradUnit[t][j][1] / c.hy;
              M[i][j] += w * (gi0 * gj0 + gi1 * gj1);
            }
        }
        for (int i = 0; i < 3; ++i)
          for (int j = 0; j < 3; ++j)
            out.add(c.dof(gx, gy, t, i), c.dof(gx, gy, t, j), M[i][j]);
      }
}

// one inner face with kappa = I (delta = 1, omega = 1/2, gamma = 1/2)
void inner_face(const Ctx& c, Coo& out, int gx_m, int gy_m, int t_m, int gx_p,
                int gy_p, int t_p, const double* pts_m, const double* pts_p,
                double nx, double ny, double ell, const double* lam_m,
                const double* lam_p) {
  double Mmm[3][3] = {{0}}, Mmp[3][3] = {{0}}, Mpm[3][3] = {{0}},
         Mpp[3][3] = {{0}};
  for (int q = 0; q < c.nqf; ++q) {
    double lm = lam_m[q], lp = lam_p[q];
    double pen = c.sigma_in * 0.5 * (0.5 * lm + 0.5 * lp) / std::pow(ell, c.beta);
    double phim[3], phip[3];
    bary(t_m, pts_m[2 * q], pts_m[2 * q + 1], phim);
    bary(t_p, pts_p[2 * q], pts_p[2 * q + 1], phip);
    double fm[3], fp[3];
    for (int j = 0; j < 3; ++j) {
      fm[j] = 0.5 * lm *
              (kGradUnit[t_m][j][0] / c.hx * nx + kGradUnit[t_m][j][1] / c.hy * ny);
      fp[j] = 0.5 * lp *
              (kGradUnit[t_p][j][0] / c.hx * nx + kGradUnit[t_p][j][1] / c.hy * ny);
    }
    double w = c.wf[q] * ell;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j) {
        Mmm[i][j] += w * (pen * phim[i] * phim[j] - fm[j] * phim[i] - fm[i] * phim[j]);
        Mmp[i][j] += w * (-pen * phim[i] * phip[j] - fp[j] * phim[i] + fm[i] * phip[j]);
        Mpm[i][j] += w * (-pen * phip[i] * phim[j] + fm[j] * phip[i] - fp[i] * phim[j]);
        Mpp[i][j] += w * (pen * phip[i] * phip[j] + fp[j] * phip[i] + fp[i] * phip[j]);
      }
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j) {
      out.add(c.dof(gx_m, gy_m, t_m, i), c.dof(gx_m, gy_m, t_m, j), Mmm[i][j]);
      out.add(c.dof(gx_m, gy_m, t_m, i), c.dof(gx_p, gy_p, t_p, j), Mmp[i][j]);
      out.add(c.dof(gx_p, gy_p, t_p, i), c.dof(gx_m, gy_m, t_m, j), Mpm[i][j]);
      out.add(c.dof(gx_p, gy_p, t_p, i), c.dof(gx_p, gy_p, t_p, j), Mpp[i][j]);
    }
}

void boundary_face(const Ctx& c, Coo& out, int gx, int gy, int t,
                   const double* pts, double nx, double ny, double ell,
                   const double* lam) {
  double M[3][3] = {{0}};
  for (int q = 0; q < c.nqf; ++q) {
    double l = lam[q];
    double pen = c.sigma_bd * l / std::pow(ell, c.beta);
    double phi[3];
    bary(t, pts[2 * q], pts[2 * q + 1], phi);
    double fl[3];
    for (int j = 0; j < 3; ++j)
      fl[j] = l * (kGradUnit[t][j][0] / c.hx * nx + kGradUnit[t][j][1] / c.hy * ny);
    double w = c.wf[q] * ell;
    for (int i = 0; i < 3; ++i)
      for (int j = 0; j < 3; ++j)
        M[i][j] += w * (pen * phi[i] * phi[j] - fl[j] * phi[i] - fl[i] * phi[j]);
  }
  for (int i = 0; i < 3; ++i)
    for (int j = 0; j < 3; ++j)
      out.add(c.dof(gx, gy, t, i), c.dof(gx, gy, t, j), M[i][j]);
}

const double* arr(PyArrayObject* a) {
  return static_cast<const double*>(PyArray_DATA(a));
}

PyObject* assemble(PyObject*, PyObject* args) {
  int kx, ky, s;
  double hx, hy, sigma_in, sigma_bd, beta;
  PyArrayObject *qv, *wv, *qf, *wf, *lam_vol, *lam_D_m, *lam_D_p, *lam_V_m,
      *lam_V_p, *lam_H_m, *lam_H_p, *lam_bnd;
  if (!PyArg_ParseTuple(args, "iiidddddO!O!O!O!O!O!O!O!O!O!O!O!", &kx, &ky, &s,
                        &hx, &hy, &sigma_in, &sigma_bd, &beta,
                        &PyArray_Type, &qv, &PyArray_Type, &wv,
                        &PyArray_Type, &qf, &PyArray_Type, &wf,
                        &PyArray_Type, &lam_vol,
                        &PyArray_Type, &lam_D_m, &PyArray_Type, &lam_D_p,
                        &PyArray_Type, &lam_V_m, &PyArray_Type, &lam_V_p,
                        &PyArray_Type, &lam_H_m, &PyArray_Type, &lam_H_p,
                        &PyArray_Type, &lam_bnd))
    return nullptr;

  Ctx c;
  c.kx = kx; c.ky = ky; c.s = s; c.hx = hx; c.hy = hy;
  c.sigma_in = sigma_in; c.sigma_bd = sigma_bd; c.beta = beta;
  c.Sx = kx * s; c.Sy = ky * s;
  c.nqv = (int)PyArray_DIM(qv, 1);
  c.nqf = (int)PyArray_DIM(qf, 0);
  c.qv = arr(qv); c.wv = arr(wv); c.qf = arr(qf); c.wf = arr(wf);
  c.lam_vol = arr(lam_vol);
  c.lam_D_m = arr(lam_D_m); c.lam_D_p = arr(lam_D_p);
  c.lam_V_m = arr(lam_V_m); c.lam_V_p = arr(lam_V_p);
  c.lam_H_m = arr(lam_H_m); c.lam_H_p = arr(lam_H_p);
  c.lam_bnd = arr(lam_bnd);

  Coo out;
  out.rows.reserve((size_t)c.Sx * c.Sy * 200);
  volume(c, out);

  const double len_d = std::sqrt(hx * hx + hy * hy);
  const double nD[2] = {-hy / len_d, hx / len_d};
  std::vector<double> ptsD(2 * c.nqf), ptsVm(2 * c.nqf), ptsVp(2 * c.nqf),
      ptsHm(2 * c.nqf), ptsHp(2 * c.nqf);
  for (int q = 0; q < c.nqf; ++q) {
    double t = c.qf[q];
    ptsD[2 * q] = t;     ptsD[2 * q + 1] = t;
    ptsVm[2 * q] = 1.0;  ptsVm[2 * q + 1] = t;
    ptsVp[2 * q] = 0.0;  ptsVp[2 * q + 1] = t;
    ptsHm[2 * q] = t;    ptsHm[2 * q + 1] = 1.0;
    ptsHp[2 * q] = t;    ptsHp[2 * q + 1] = 0.0;
  }

  for (int gy = 0; gy < c.Sy; ++gy)
    for (int gx = 0; gx < c.Sx; ++gx) {
      int64_t cell = (int64_t)gy * c.Sx + gx;
      inner_face(c, out, gx, gy, 0, gx, gy, 1, ptsD.data(), ptsD.data(),
                 nD[0], nD[1], len_d, c.lam_D_m + cell * c.nqf,
                 c.lam_D_p + cell * c.nqf);
      if (gx < c.Sx - 1) {
        int64_t f = (int64_t)gy * (c.Sx - 1) + gx;
        inner_face(c, out, gx, gy, 0, gx + 1, gy, 1, ptsVm.data(), ptsVp.data(),
                   1.0, 0.0, hy, c.lam_V_m + f * c.nqf, c.lam_V_p + f * c.nqf);
      }
      if (gy < c.Sy - 1) {
        int64_t f = (int64_t)gy * c.Sx + gx;
        inner_face(c, out, gx, gy, 1, gx, gy + 1, 0, ptsHm.data(), ptsHp.data(),
                   0.0, 1.0, hx, c.lam_H_m + f * c.nqf, c.lam_H_p + f * c.nqf);
      }
    }

  // boundary rows of lam_bnd: [left(Sy), right(Sy), bottom(Sx), top(Sx)]
  for (int gy = 0; gy < c.Sy; ++gy) {
    boundary_face(c, out, 0, gy, 1, ptsVp.data(), -1.0, 0.0, hy,
                  c.lam_bnd + (int64_t)gy * c.nqf);
    boundary_face(c, out, c.Sx - 1, gy, 0, ptsVm.data(), 1.0, 0.0, hy,
                  c.lam_bnd + (int64_t)(c.Sy + gy) * c.nqf);
  }
  for (int gx = 0; gx < c.Sx; ++gx) {
    boundary_face(c, out, gx, 0, 0, ptsHp.data(), 0.0, -1.0, hx,
                  c.lam_bnd + (int64_t)(2 * c.Sy + gx) * c.nqf);
    boundary_face(c, out, gx, c.Sy - 1, 1, ptsHm.data(), 0.0, 1.0, hx,
                  c.lam_bnd + (int64_t)(2 * c.Sy + c.Sx + gx) * c.nqf);
  }

  npy_intp n = (npy_intp)out.vals.size();
  PyObject* rows = PyArray_SimpleNew(1, &n, NPY_INT64);
  PyObject* cols = PyArray_SimpleNew(1, &n, NPY_INT64);
  PyObject* vals = PyArray_SimpleNew(1, &n, NPY_FLOAT64);
  memcpy(PyArray_DATA((PyArrayObject*)rows), out.rows.data(), n * sizeof(int64_t));
  memcpy(PyArray_DATA((PyArrayObject*)cols), out.cols.data(), n * sizeof(int64_t));
  memcpy(PyArray_DATA((PyArrayObject*)vals), out.vals.data(), n * sizeof(double));
  return Py_BuildValue("(NNN)", rows, cols, vals);
}

// ---------------------------------------------------------------------------
// 3D hex Q1 assembler (trilinear SWIPDG, kappa = I) — the native counterpart
// of the batched 3D assembly (ops/assembly3d.py + ops/swipdg3d.py); same
// integrands: face integration measure = face AREA, penalty length = face
// DIAMETER (FaceTab.pen_scale in ops/spaces3d.py).
// dof(gx, gy, gz, i) = ii*N + ((cz*s + cy)*s + cx)*8 + i,
// ii = (sz*ky + sy)*kx + sx,  N = s^3 * 8, node i = (iz*2 + iy)*2 + ix.
// ---------------------------------------------------------------------------

inline void hexphi(double x, double y, double z, double phi[8]) {
  const double lx[2] = {1.0 - x, x}, ly[2] = {1.0 - y, y}, lz[2] = {1.0 - z, z};
  for (int iz = 0; iz < 2; ++iz)
    for (int iy = 0; iy < 2; ++iy)
      for (int ix = 0; ix < 2; ++ix)
        phi[(iz * 2 + iy) * 2 + ix] = lz[iz] * ly[iy] * lx[ix];
}

struct Ctx3 {
  int kx, ky, kz, s;
  double hx, hy, hz, sigma_in, sigma_bd, beta;
  int nqv, nqf;
  const double* qv;   // [nqv][3] unit-cell volume points
  const double* wv;   // [nqv] (sum 1)
  const double* uv;   // [nqf][2] unit face params
  const double* wf;   // [nqf] (sum 1)
  const double* lam_vol;  // [Sz][Sy][Sx][nqv]
  const double *lam_X_m, *lam_X_p;  // [Sz][Sy][Sx-1][nqf]
  const double *lam_Y_m, *lam_Y_p;  // [Sz][Sy-1][Sx][nqf]
  const double *lam_Z_m, *lam_Z_p;  // [Sz-1][Sy][Sx][nqf]
  const double* lam_bnd;  // [2*Sz*Sy + 2*Sz*Sx + 2*Sy*Sx][nqf]
  int Sx, Sy, Sz;

  void hexgrad(double x, double y, double z, double g[8][3]) const {
    const double lx[2] = {1.0 - x, x}, ly[2] = {1.0 - y, y},
                 lz[2] = {1.0 - z, z};
    const double d_[2] = {-1.0, 1.0};
    for (int iz = 0; iz < 2; ++iz)
      for (int iy = 0; iy < 2; ++iy)
        for (int ix = 0; ix < 2; ++ix) {
          int j = (iz * 2 + iy) * 2 + ix;
          g[j][0] = d_[ix] * ly[iy] * lz[iz] / hx;
          g[j][1] = lx[ix] * d_[iy] * lz[iz] / hy;
          g[j][2] = lx[ix] * ly[iy] * d_[iz] / hz;
        }
  }

  int64_t dof(int gx, int gy, int gz, int i) const {
    int sx = gx / s, sy = gy / s, sz = gz / s;
    int cx = gx % s, cy = gy % s, cz = gz % s;
    int64_t ii = ((int64_t)sz * ky + sy) * kx + sx;
    int64_t N = (int64_t)s * s * s * 8;
    return ii * N + (((int64_t)cz * s + cy) * s + cx) * 8 + i;
  }
};

void volume3(const Ctx3& c, Coo& out) {
  const double V = c.hx * c.hy * c.hz;
  for (int gz = 0; gz < c.Sz; ++gz)
    for (int gy = 0; gy < c.Sy; ++gy)
      for (int gx = 0; gx < c.Sx; ++gx) {
        double M[8][8] = {{0}};
        int64_t cell = ((int64_t)gz * c.Sy + gy) * c.Sx + gx;
        for (int q = 0; q < c.nqv; ++q) {
          double g[8][3];
          c.hexgrad(c.qv[3 * q], c.qv[3 * q + 1], c.qv[3 * q + 2], g);
          double w = c.wv[q] * V * c.lam_vol[cell * c.nqv + q];
          for (int i = 0; i < 8; ++i)
            for (int j = 0; j < 8; ++j)
              M[i][j] += w * (g[i][0] * g[j][0] + g[i][1] * g[j][1] +
                              g[i][2] * g[j][2]);
        }
        for (int i = 0; i < 8; ++i)
          for (int j = 0; j < 8; ++j)
            out.add(c.dof(gx, gy, gz, i), c.dof(gx, gy, gz, j), M[i][j]);
      }
}

// unit-cell coords of a face point: axis = fixed coordinate, c01 its value
inline void face_pt3(int axis, double c01, double u, double v, double x[3]) {
  if (axis == 0) { x[0] = c01; x[1] = u; x[2] = v; }
  else if (axis == 1) { x[0] = u; x[1] = c01; x[2] = v; }
  else { x[0] = u; x[1] = v; x[2] = c01; }
}

void inner_face3(const Ctx3& c, Coo& out, int axis, int gx_m, int gy_m,
                 int gz_m, int gx_p, int gy_p, int gz_p, double area,
                 double diam, const double* lam_m, const double* lam_p) {
  double Mmm[8][8] = {{0}}, Mmp[8][8] = {{0}}, Mpm[8][8] = {{0}},
         Mpp[8][8] = {{0}};
  double n[3] = {0, 0, 0};
  n[axis] = 1.0;
  for (int q = 0; q < c.nqf; ++q) {
    double lm = lam_m[q], lp = lam_p[q];
    double pen =
        c.sigma_in * 0.5 * (0.5 * lm + 0.5 * lp) / std::pow(diam, c.beta);
    double xm[3], xp[3];
    face_pt3(axis, 1.0, c.uv[2 * q], c.uv[2 * q + 1], xm);
    face_pt3(axis, 0.0, c.uv[2 * q], c.uv[2 * q + 1], xp);
    double phim[8], phip[8], gm[8][3], gp[8][3];
    hexphi(xm[0], xm[1], xm[2], phim);
    hexphi(xp[0], xp[1], xp[2], phip);
    c.hexgrad(xm[0], xm[1], xm[2], gm);
    c.hexgrad(xp[0], xp[1], xp[2], gp);
    double fm[8], fp[8];
    for (int j = 0; j < 8; ++j) {
      fm[j] = 0.5 * lm *
              (gm[j][0] * n[0] + gm[j][1] * n[1] + gm[j][2] * n[2]);
      fp[j] = 0.5 * lp *
              (gp[j][0] * n[0] + gp[j][1] * n[1] + gp[j][2] * n[2]);
    }
    double w = c.wf[q] * area;
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j) {
        Mmm[i][j] += w * (pen * phim[i] * phim[j] - fm[j] * phim[i] - fm[i] * phim[j]);
        Mmp[i][j] += w * (-pen * phim[i] * phip[j] - fp[j] * phim[i] + fm[i] * phip[j]);
        Mpm[i][j] += w * (-pen * phip[i] * phim[j] + fm[j] * phip[i] - fp[i] * phim[j]);
        Mpp[i][j] += w * (pen * phip[i] * phip[j] + fp[j] * phip[i] + fp[i] * phip[j]);
      }
  }
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j) {
      out.add(c.dof(gx_m, gy_m, gz_m, i), c.dof(gx_m, gy_m, gz_m, j), Mmm[i][j]);
      out.add(c.dof(gx_m, gy_m, gz_m, i), c.dof(gx_p, gy_p, gz_p, j), Mmp[i][j]);
      out.add(c.dof(gx_p, gy_p, gz_p, i), c.dof(gx_m, gy_m, gz_m, j), Mpm[i][j]);
      out.add(c.dof(gx_p, gy_p, gz_p, i), c.dof(gx_p, gy_p, gz_p, j), Mpp[i][j]);
    }
}

void boundary_face3(const Ctx3& c, Coo& out, int axis, double c01, double sgn,
                    int gx, int gy, int gz, double area, double diam,
                    const double* lam) {
  double M[8][8] = {{0}};
  double n[3] = {0, 0, 0};
  n[axis] = sgn;
  for (int q = 0; q < c.nqf; ++q) {
    double l = lam[q];
    double pen = c.sigma_bd * l / std::pow(diam, c.beta);
    double x[3];
    face_pt3(axis, c01, c.uv[2 * q], c.uv[2 * q + 1], x);
    double phi[8], g[8][3];
    hexphi(x[0], x[1], x[2], phi);
    c.hexgrad(x[0], x[1], x[2], g);
    double fl[8];
    for (int j = 0; j < 8; ++j)
      fl[j] = l * (g[j][0] * n[0] + g[j][1] * n[1] + g[j][2] * n[2]);
    double w = c.wf[q] * area;
    for (int i = 0; i < 8; ++i)
      for (int j = 0; j < 8; ++j)
        M[i][j] += w * (pen * phi[i] * phi[j] - fl[j] * phi[i] - fl[i] * phi[j]);
  }
  for (int i = 0; i < 8; ++i)
    for (int j = 0; j < 8; ++j)
      out.add(c.dof(gx, gy, gz, i), c.dof(gx, gy, gz, j), M[i][j]);
}

PyObject* assemble3d(PyObject*, PyObject* args) {
  int kx, ky, kz, s;
  double hx, hy, hz, sigma_in, sigma_bd, beta;
  PyArrayObject *qv, *wv, *uv, *wf, *lam_vol, *lam_X_m, *lam_X_p, *lam_Y_m,
      *lam_Y_p, *lam_Z_m, *lam_Z_p, *lam_bnd;
  if (!PyArg_ParseTuple(args, "iiiiddddddO!O!O!O!O!O!O!O!O!O!O!O!",
                        &kx, &ky, &kz, &s, &hx, &hy, &hz,
                        &sigma_in, &sigma_bd, &beta,
                        &PyArray_Type, &qv, &PyArray_Type, &wv,
                        &PyArray_Type, &uv, &PyArray_Type, &wf,
                        &PyArray_Type, &lam_vol,
                        &PyArray_Type, &lam_X_m, &PyArray_Type, &lam_X_p,
                        &PyArray_Type, &lam_Y_m, &PyArray_Type, &lam_Y_p,
                        &PyArray_Type, &lam_Z_m, &PyArray_Type, &lam_Z_p,
                        &PyArray_Type, &lam_bnd))
    return nullptr;

  Ctx3 c;
  c.kx = kx; c.ky = ky; c.kz = kz; c.s = s;
  c.hx = hx; c.hy = hy; c.hz = hz;
  c.sigma_in = sigma_in; c.sigma_bd = sigma_bd; c.beta = beta;
  c.Sx = kx * s; c.Sy = ky * s; c.Sz = kz * s;
  c.nqv = (int)PyArray_DIM(qv, 0);
  c.nqf = (int)PyArray_DIM(uv, 0);
  c.qv = arr(qv); c.wv = arr(wv); c.uv = arr(uv); c.wf = arr(wf);
  c.lam_vol = arr(lam_vol);
  c.lam_X_m = arr(lam_X_m); c.lam_X_p = arr(lam_X_p);
  c.lam_Y_m = arr(lam_Y_m); c.lam_Y_p = arr(lam_Y_p);
  c.lam_Z_m = arr(lam_Z_m); c.lam_Z_p = arr(lam_Z_p);
  c.lam_bnd = arr(lam_bnd);

  Coo out;
  out.rows.reserve((size_t)c.Sx * c.Sy * c.Sz * 500);
  volume3(c, out);

  const double aX = hy * hz, aY = hx * hz, aZ = hx * hy;
  const double dX = std::sqrt(hy * hy + hz * hz),
               dY = std::sqrt(hx * hx + hz * hz),
               dZ = std::sqrt(hx * hx + hy * hy);
  for (int gz = 0; gz < c.Sz; ++gz)
    for (int gy = 0; gy < c.Sy; ++gy)
      for (int gx = 0; gx < c.Sx; ++gx) {
        if (gx < c.Sx - 1) {
          int64_t f = ((int64_t)gz * c.Sy + gy) * (c.Sx - 1) + gx;
          inner_face3(c, out, 0, gx, gy, gz, gx + 1, gy, gz, aX, dX,
                      c.lam_X_m + f * c.nqf, c.lam_X_p + f * c.nqf);
        }
        if (gy < c.Sy - 1) {
          int64_t f = ((int64_t)gz * (c.Sy - 1) + gy) * c.Sx + gx;
          inner_face3(c, out, 1, gx, gy, gz, gx, gy + 1, gz, aY, dY,
                      c.lam_Y_m + f * c.nqf, c.lam_Y_p + f * c.nqf);
        }
        if (gz < c.Sz - 1) {
          int64_t f = ((int64_t)gz * c.Sy + gy) * c.Sx + gx;
          inner_face3(c, out, 2, gx, gy, gz, gx, gy, gz + 1, aZ, dZ,
                      c.lam_Z_m + f * c.nqf, c.lam_Z_p + f * c.nqf);
        }
      }

  // lam_bnd row blocks: left/right [Sz*Sy], bottom/top [Sz*Sx],
  // near/far [Sy*Sx] — (a, b) iteration order matching side_cells
  int64_t off = 0;
  for (int gz = 0; gz < c.Sz; ++gz)
    for (int gy = 0; gy < c.Sy; ++gy)
      boundary_face3(c, out, 0, 0.0, -1.0, 0, gy, gz, aX, dX,
                     c.lam_bnd + (off + (int64_t)gz * c.Sy + gy) * c.nqf);
  off += (int64_t)c.Sz * c.Sy;
  for (int gz = 0; gz < c.Sz; ++gz)
    for (int gy = 0; gy < c.Sy; ++gy)
      boundary_face3(c, out, 0, 1.0, 1.0, c.Sx - 1, gy, gz, aX, dX,
                     c.lam_bnd + (off + (int64_t)gz * c.Sy + gy) * c.nqf);
  off += (int64_t)c.Sz * c.Sy;
  for (int gz = 0; gz < c.Sz; ++gz)
    for (int gx = 0; gx < c.Sx; ++gx)
      boundary_face3(c, out, 1, 0.0, -1.0, gx, 0, gz, aY, dY,
                     c.lam_bnd + (off + (int64_t)gz * c.Sx + gx) * c.nqf);
  off += (int64_t)c.Sz * c.Sx;
  for (int gz = 0; gz < c.Sz; ++gz)
    for (int gx = 0; gx < c.Sx; ++gx)
      boundary_face3(c, out, 1, 1.0, 1.0, gx, c.Sy - 1, gz, aY, dY,
                     c.lam_bnd + (off + (int64_t)gz * c.Sx + gx) * c.nqf);
  off += (int64_t)c.Sz * c.Sx;
  for (int gy = 0; gy < c.Sy; ++gy)
    for (int gx = 0; gx < c.Sx; ++gx)
      boundary_face3(c, out, 2, 0.0, -1.0, gx, gy, 0, aZ, dZ,
                     c.lam_bnd + (off + (int64_t)gy * c.Sx + gx) * c.nqf);
  off += (int64_t)c.Sy * c.Sx;
  for (int gy = 0; gy < c.Sy; ++gy)
    for (int gx = 0; gx < c.Sx; ++gx)
      boundary_face3(c, out, 2, 1.0, 1.0, gx, gy, c.Sz - 1, aZ, dZ,
                     c.lam_bnd + (off + (int64_t)gy * c.Sx + gx) * c.nqf);

  npy_intp n = (npy_intp)out.vals.size();
  PyObject* rows = PyArray_SimpleNew(1, &n, NPY_INT64);
  PyObject* cols = PyArray_SimpleNew(1, &n, NPY_INT64);
  PyObject* vals = PyArray_SimpleNew(1, &n, NPY_FLOAT64);
  memcpy(PyArray_DATA((PyArrayObject*)rows), out.rows.data(), n * sizeof(int64_t));
  memcpy(PyArray_DATA((PyArrayObject*)cols), out.cols.data(), n * sizeof(int64_t));
  memcpy(PyArray_DATA((PyArrayObject*)vals), out.vals.data(), n * sizeof(double));
  return Py_BuildValue("(NNN)", rows, cols, vals);
}

PyMethodDef kMethods[] = {
    {"assemble_swipdg_p1", assemble, METH_VARARGS,
     "COO SWIPDG P1 assembly (kappa = I) on the structured triangulation."},
    {"assemble_swipdg_q1_3d", assemble3d, METH_VARARGS,
     "COO SWIPDG trilinear Q1 assembly (kappa = I) on the structured hex grid."},
    {nullptr, nullptr, 0, nullptr}};

struct PyModuleDef kModule = {PyModuleDef_HEAD_INIT, "_pylrbms_torch_native",
                              "native runtime kernels", -1, kMethods};

}  // namespace

PyMODINIT_FUNC PyInit__pylrbms_torch_native(void) {
  import_array();
  return PyModule_Create(&kModule);
}
